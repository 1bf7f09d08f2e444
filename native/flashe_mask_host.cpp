// Host build of the fused mask kernel's arithmetic (native/flashe_mask.h),
// loaded through ctypes by the CPU tests (tests/test_fused_mask.py): the
// same counter_words and block_lane code the CUDA kernel runs, applied
// group by group in the kernel's lane order.
#include "flashe_mask.h"

extern "C" void flashe_mask_apply_host(const uint32_t* q, uint32_t* out,
                                       const uint32_t* key_planes,
                                       const int32_t* scalars, int64_t count,
                                       int32_t int_bits) {
  const int merge = 128 / int_bits;
  const uint32_t mask =
      int_bits == 32 ? 0xFFFFFFFFu : (uint32_t(1) << int_bits) - 1u;
  const int64_t groups = ((count + merge - 1) / merge + 31) / 32;
  uint32_t a[128], b[128];
  for (int64_t g = 0; g < groups; ++g) {
    const int32_t first = scalars[3] + int32_t(32 * g);
    flashe_mask::counter_words(key_planes, scalars[0], scalars[1], first, a);
    flashe_mask::counter_words(key_planes, scalars[0], scalars[2], first, b);
    for (int j = 0; j < 32; ++j) {
      for (int j0 = 0; j0 < merge; ++j0) {
        const int64_t lane = (32 * g + j) * merge + j0;
        if (lane >= count) continue;
        const uint32_t va = flashe_mask::block_lane(
            a[j], a[32 + j], a[64 + j], a[96 + j], j0, int_bits);
        const uint32_t vb = flashe_mask::block_lane(
            b[j], b[32 + j], b[64 + j], b[96 + j], j0, int_bits);
        out[lane] = (q[lane] + va - vb) & mask;
      }
    }
  }
}
