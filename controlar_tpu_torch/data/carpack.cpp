// carpack: memory-mapped packed-record dataset reader.
//
// The reference framework reads training data as trees of millions of tiny
// .npy/.png files (ref dataset/t2i_control.py:104-121) — a metadata-bound
// pattern that cannot keep an accelerator host's input pipeline fed. carpack packs a
// dataset into one file with an offset index; this reader mmaps it and
// serves zero-copy field views through a C ABI consumed via ctypes.
//
// File layout (little endian):
//   magic "CARPACK1" | u64 n_records | u64 index_offset
//   records... each:
//     u32 n_fields
//     per field: u16 name_len | name | u8 dtype | u8 ndim | u32 dims[ndim]
//                | u64 payload_len | payload
//   index: u64 record_offsets[n_records]
//
// dtype codes: 0=u8 1=i32 2=i64 3=f32 4=f16 5=bf16 6=bool 7=raw-bytes

#include <cstdint>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_records = 0;
  const uint64_t* index = nullptr;
};

template <typename T>
T read_le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

}  // namespace

extern "C" {

struct FieldView {
  char name[64];
  uint8_t dtype;
  uint8_t ndim;
  uint32_t dims[8];
  const uint8_t* data;
  uint64_t len;
};

void* cp_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_WILLNEED);
  auto* p = new Pack();
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(mem);
  p->size = st.st_size;
  if (p->size < 24 || std::memcmp(p->base, "CARPACK1", 8) != 0) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  p->n_records = read_le<uint64_t>(p->base + 8);
  uint64_t index_off = read_le<uint64_t>(p->base + 16);
  if (index_off + p->n_records * 8 > p->size) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  p->index = reinterpret_cast<const uint64_t*>(p->base + index_off);
  return p;
}

long cp_count(void* h) {
  return h ? static_cast<long>(static_cast<Pack*>(h)->n_records) : -1;
}

// Fills up to max_fields views for record i; returns the field count or -1.
int cp_record(void* h, long i, FieldView* out, int max_fields) {
  if (!h) return -1;
  auto* p = static_cast<Pack*>(h);
  if (i < 0 || static_cast<uint64_t>(i) >= p->n_records) return -1;
  const uint8_t* cur = p->base + p->index[i];
  const uint8_t* end = p->base + p->size;
  if (cur + 4 > end) return -1;
  uint32_t n_fields = read_le<uint32_t>(cur);
  cur += 4;
  uint32_t emit = 0;
  for (uint32_t f = 0; f < n_fields; ++f) {
    if (cur + 2 > end) return -1;
    uint16_t name_len = read_le<uint16_t>(cur);
    cur += 2;
    if (cur + name_len + 2 > end || name_len >= 64) return -1;
    const char* name = reinterpret_cast<const char*>(cur);
    cur += name_len;
    uint8_t dtype = *cur++;
    uint8_t ndim = *cur++;
    if (ndim > 8 || cur + 4ull * ndim + 8 > end) return -1;
    uint32_t dims[8] = {0};
    for (int d = 0; d < ndim; ++d) {
      dims[d] = read_le<uint32_t>(cur);
      cur += 4;
    }
    uint64_t payload = read_le<uint64_t>(cur);
    cur += 8;
    if (cur + payload > end) return -1;
    if (static_cast<int>(emit) < max_fields) {
      FieldView& v = out[emit];
      std::memset(v.name, 0, sizeof(v.name));
      std::memcpy(v.name, name, name_len);
      v.dtype = dtype;
      v.ndim = ndim;
      std::memcpy(v.dims, dims, sizeof(dims));
      v.data = cur;
      v.len = payload;
      ++emit;
    }
    cur += payload;
  }
  return static_cast<int>(emit);
}

void cp_close(void* h) {
  if (!h) return;
  auto* p = static_cast<Pack*>(h);
  munmap(const_cast<uint8_t*>(p->base), p->size);
  ::close(p->fd);
  delete p;
}

}  // extern "C"
