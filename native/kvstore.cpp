// Persistent partitioned KV storage node — this repository's analogue of
// eggroll's storage-service-cxx (the C++ LMDB node behind FATE's DTable;
// see SURVEY.md section 2.3).  Design: per-partition append-only log files
// with an in-memory hash index rebuilt on open (crash-safe: a torn tail
// record is truncated).  No LMDB dependency — the image has none, and the
// access pattern here (bulk put during upload, sequential collect during
// training) wants log-structured writes anyway.
//
// Record format (little-endian):
//   u32 keylen | u32 vallen (0xFFFFFFFF = tombstone) | key bytes | val bytes
//
// C ABI (ctypes-bound by flashe_tpu/data/kvstore.py, which also carries a
// pure-python fallback speaking the same file format):
//   kv_open(dir, nparts) -> handle     kv_close(h)
//   kv_put(h, part, k, klen, v, vlen)  kv_del(h, part, k, klen)
//   kv_get_len(h, part, k, klen)       kv_get(h, part, k, klen, buf)
//   kv_count(h, part)                  kv_flush(h)
//   kv_iter_open(h, part) -> it        kv_iter_close(it)
//   kv_iter_next_lens(it, &klen, &vlen)  kv_iter_fill(it, kbuf, vbuf)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;

struct Loc {
  uint64_t off;   // offset of the value bytes
  uint32_t len;
};

struct Partition {
  std::string path;
  FILE* f = nullptr;
  uint64_t end = 0;  // logical end of valid data
  std::unordered_map<std::string, Loc> index;
};

struct Store {
  std::string dir;
  std::vector<Partition> parts;
};

struct Iter {
  Store* store;
  int part;
  std::vector<std::string> keys;  // snapshot
  size_t pos = 0;
  // staged current record
  std::string val;
  bool staged = false;
};

bool load_partition(Partition& p) {
  p.f = std::fopen(p.path.c_str(), "a+b");
  if (!p.f) return false;
  std::fseek(p.f, 0, SEEK_END);
  const uint64_t fsize = (uint64_t)std::ftell(p.f);
  std::fseek(p.f, 0, SEEK_SET);
  uint64_t off = 0;
  std::string key;
  for (;;) {
    uint32_t lens[2];
    if (std::fread(lens, 4, 2, p.f) != 2) break;
    uint64_t vlen = lens[1] == kTombstone ? 0 : lens[1];
    key.resize(lens[0]);
    if (lens[0] && std::fread(&key[0], 1, lens[0], p.f) != lens[0]) break;
    uint64_t voff = off + 8 + lens[0];
    // torn-tail check against the real file size (fseek past EOF
    // "succeeds", so position alone can't detect a truncated value)
    if (voff + vlen > fsize) break;
    if (vlen && std::fseek(p.f, (long)vlen, SEEK_CUR) != 0) break;
    if (lens[1] == kTombstone) {
      p.index.erase(key);
    } else {
      p.index[key] = Loc{voff, lens[1]};
    }
    off = voff + vlen;
  }
  // truncate any torn tail so later appends start from a clean record
  p.end = off;
  std::fflush(p.f);
  if (truncate(p.path.c_str(), (off_t)off) != 0) { /* best-effort */ }
  std::fseek(p.f, 0, SEEK_END);
  return true;
}

bool append_record(Partition& p, const char* k, uint32_t klen,
                   const char* v, uint32_t vlen_field, uint32_t vlen) {
  std::fseek(p.f, 0, SEEK_END);
  uint32_t lens[2] = {klen, vlen_field};
  if (std::fwrite(lens, 4, 2, p.f) != 2) return false;
  if (klen && std::fwrite(k, 1, klen, p.f) != klen) return false;
  if (vlen && std::fwrite(v, 1, vlen, p.f) != vlen) return false;
  p.end += 8 + klen + vlen;
  return true;
}

}  // namespace

extern "C" {

void* kv_open(const char* dir, int nparts) {
  auto* s = new Store();
  s->dir = dir;
  ::mkdir(dir, 0777);  // ok if exists
  s->parts.resize(nparts);
  for (int i = 0; i < nparts; i++) {
    s->parts[i].path = s->dir + "/p" + std::to_string(i) + ".log";
    if (!load_partition(s->parts[i])) {
      delete s;
      return nullptr;
    }
  }
  return s;
}

void kv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return;
  for (auto& p : s->parts)
    if (p.f) std::fclose(p.f);
  delete s;
}

int kv_nparts(void* h) {
  return (int)static_cast<Store*>(h)->parts.size();
}

int kv_put(void* h, int part, const char* k, uint32_t klen, const char* v,
           uint32_t vlen) {
  auto& p = static_cast<Store*>(h)->parts[part];
  uint64_t voff = p.end + 8 + klen;
  if (!append_record(p, k, klen, v, vlen, vlen)) return -1;
  p.index[std::string(k, klen)] = Loc{voff, vlen};
  return 0;
}

int kv_del(void* h, int part, const char* k, uint32_t klen) {
  auto& p = static_cast<Store*>(h)->parts[part];
  std::string key(k, klen);
  if (p.index.find(key) == p.index.end()) return 1;
  if (!append_record(p, k, klen, nullptr, kTombstone, 0)) return -1;
  p.index.erase(key);
  return 0;
}

// -1 = missing, else value length
int64_t kv_get_len(void* h, int part, const char* k, uint32_t klen) {
  auto& p = static_cast<Store*>(h)->parts[part];
  auto it = p.index.find(std::string(k, klen));
  if (it == p.index.end()) return -1;
  return (int64_t)it->second.len;
}

int kv_get(void* h, int part, const char* k, uint32_t klen, char* out) {
  auto& p = static_cast<Store*>(h)->parts[part];
  auto it = p.index.find(std::string(k, klen));
  if (it == p.index.end()) return -1;
  std::fflush(p.f);
  if (std::fseek(p.f, (long)it->second.off, SEEK_SET) != 0) return -2;
  if (it->second.len &&
      std::fread(out, 1, it->second.len, p.f) != it->second.len)
    return -2;
  std::fseek(p.f, 0, SEEK_END);
  return 0;
}

int64_t kv_count(void* h, int part) {
  return (int64_t)static_cast<Store*>(h)->parts[part].index.size();
}

void kv_flush(void* h) {
  for (auto& p : static_cast<Store*>(h)->parts)
    if (p.f) std::fflush(p.f);
}

void* kv_iter_open(void* h, int part) {
  auto* s = static_cast<Store*>(h);
  auto* it = new Iter();
  it->store = s;
  it->part = part;
  it->keys.reserve(s->parts[part].index.size());
  for (auto& kv : s->parts[part].index) it->keys.push_back(kv.first);
  return it;
}

void kv_iter_close(void* it) { delete static_cast<Iter*>(it); }

// stage the next record; returns 0 and fills lens, or 1 at end
int kv_iter_next_lens(void* hit, uint32_t* klen, uint32_t* vlen) {
  auto* it = static_cast<Iter*>(hit);
  auto& p = it->store->parts[it->part];
  while (it->pos < it->keys.size()) {
    const std::string& key = it->keys[it->pos];
    auto f = p.index.find(key);
    if (f == p.index.end()) {  // deleted since snapshot
      it->pos++;
      continue;
    }
    it->val.resize(f->second.len);
    if (f->second.len) {
      std::fflush(p.f);
      std::fseek(p.f, (long)f->second.off, SEEK_SET);
      if (std::fread(&it->val[0], 1, f->second.len, p.f) != f->second.len)
        return -1;
      std::fseek(p.f, 0, SEEK_END);
    }
    *klen = (uint32_t)key.size();
    *vlen = f->second.len;
    it->staged = true;
    return 0;
  }
  return 1;
}

int kv_iter_fill(void* hit, char* kbuf, char* vbuf) {
  auto* it = static_cast<Iter*>(hit);
  if (!it->staged) return -1;
  const std::string& key = it->keys[it->pos];
  std::memcpy(kbuf, key.data(), key.size());
  if (!it->val.empty()) std::memcpy(vbuf, it->val.data(), it->val.size());
  it->pos++;
  it->staged = false;
  return 0;
}

}  // extern "C"
