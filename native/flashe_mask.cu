// Fused FLASHE mask apply for NVIDIA Hopper, called from JAX through the
// foreign function interface (flashe_tpu/ops/fused_mask.py builds it with
// nvcc -gencode arch=compute_90a,code=sm_90a and registers the handler).
//
//   out = (q + stream(add_idx) - stream(minus_idx)) mod 2^int_bits
//
// Each CUDA block covers 32 groups of 32 AES counter blocks.  Warp 0
// generates the add stream and warp 1 the minus stream, one group per
// thread, with the 128 bitsliced state planes in registers
// (native/flashe_mask.h).  Each thread writes its group's lanes into a
// padded row of shared memory (odd row stride: column writes hit 32
// different banks); after a barrier both warps combine the two streams
// with q in one coalesced pass.  Mask streams never reach device memory.
// The scalars (iteration, add and minus stream indices, first counter
// block) are read from a device buffer, so no call synchronizes the host.
#include <cuda_runtime.h>

#include "flashe_mask.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 64;  // two warps: add stream, minus stream
constexpr int kKeyWords = 15 * 128;

__global__ void __launch_bounds__(kThreads)
    mask_apply_kernel(const uint32_t* __restrict__ q,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ key_planes,
                      const int32_t* __restrict__ scalars, int64_t count,
                      int int_bits) {
  extern __shared__ uint32_t smem[];
  const int merge = 128 / int_bits;
  const int width = 32 * merge;  // lanes of one group
  const int row = width + 1;
  uint32_t* keys = smem;
  uint32_t* lanes = smem + kKeyWords;  // [stream][group][row]
  for (int i = threadIdx.x; i < kKeyWords; i += kThreads) {
    keys[i] = key_planes[i];
  }
  __syncthreads();

  const int stream = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t group = int64_t(blockIdx.x) * 32 + t;
  uint32_t w[128];
  flashe_mask::counter_words(keys, scalars[0], scalars[1 + stream],
                             scalars[3] + int32_t(32 * group), w);
  uint32_t* dst = lanes + (stream * 32 + t) * row;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    for (int j0 = 0; j0 < merge; ++j0) {
      dst[j * merge + j0] = flashe_mask::block_lane(
          w[j], w[32 + j], w[64 + j], w[96 + j], j0, int_bits);
    }
  }
  __syncthreads();

  const uint32_t mask =
      int_bits == 32 ? 0xFFFFFFFFu : (uint32_t(1) << int_bits) - 1u;
  const int64_t first = int64_t(blockIdx.x) * 32 * width;
  for (int i = threadIdx.x; i < 32 * width; i += kThreads) {
    const int64_t lane = first + i;
    if (lane >= count) break;
    const int g = i / width, k = i - g * width;
    out[lane] = (q[lane] + lanes[g * row + k] - lanes[(32 + g) * row + k])
                & mask;
  }
}

ffi::Error MaskApply(cudaStream_t stream, ffi::Buffer<ffi::U32> q,
                     ffi::Buffer<ffi::U32> key_planes,
                     ffi::Buffer<ffi::S32> scalars,
                     ffi::ResultBuffer<ffi::U32> out, int32_t int_bits) {
  if (int_bits < 16 || int_bits > 32) {
    return ffi::Error::InvalidArgument("int_bits must be in [16, 32]");
  }
  if (key_planes.element_count() != kKeyWords ||
      scalars.element_count() != 4) {
    return ffi::Error::InvalidArgument("bad key_planes or scalars shape");
  }
  const int64_t count = q.element_count();
  if (count == 0) return ffi::Error::Success();
  const int merge = 128 / int_bits;
  const int64_t aes_blocks = (count + merge - 1) / merge;
  const int64_t grid = (aes_blocks + 32 * 32 - 1) / (32 * 32);
  const size_t smem =
      (kKeyWords + 2 * 32 * (32 * merge + 1)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      mask_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err == cudaSuccess) {
    mask_apply_kernel<<<grid, kThreads, smem, stream>>>(
        q.typed_data(), out->typed_data(), key_planes.typed_data(),
        scalars.typed_data(), count, int_bits);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FlasheMaskApply, MaskApply,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("int_bits"));
