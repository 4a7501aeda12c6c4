// Native TSV row reader: mmap'ed random access + multithreaded base64 decode.
//
// The reference's data plane is Python file handles seeking TSV rows and
// base64-decoding JPEG frames inside DataLoader worker processes
// (ref: utils/tsv_file.py:43-111, dataset.py:136-140, main_pretrain.py:53-74).
// This library replaces that hot path with zero-copy mmap reads and a C++
// thread pool, exposed through a minimal C ABI consumed via ctypes
// (empirical_mvm_torch/data/native_tsv.py, which builds it with the host's
// C++ compiler into build/ at first use). JPEG decode is not done here: the
// loader decodes the frames on the card (data/jpeg.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct TsvFile {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  std::vector<size_t> lineidx;
};

struct B64Table {
  int8_t v[256];
  constexpr B64Table() : v() {
    for (int i = 0; i < 256; ++i) v[i] = -1;
    for (int i = 'A'; i <= 'Z'; ++i) v[i] = static_cast<int8_t>(i - 'A');
    for (int i = 'a'; i <= 'z'; ++i) v[i] = static_cast<int8_t>(i - 'a' + 26);
    for (int i = '0'; i <= '9'; ++i) v[i] = static_cast<int8_t>(i - '0' + 52);
    v[static_cast<int>('+')] = 62;
    v[static_cast<int>('/')] = 63;
  }
};
constexpr B64Table kB64;

// decode base64 [src, src+len) into dst; returns decoded byte count (or -1).
// Fast path: 4 chars -> 3 bytes per iteration, table-driven, no branches in
// the common case; tolerates trailing '=' padding and embedded whitespace
// via a slow fallback.
long b64_decode(const char* src, size_t len, unsigned char* dst) {
  // strip trailing padding/newlines
  while (len && (src[len - 1] == '=' || src[len - 1] == '\n' ||
                 src[len - 1] == '\r'))
    --len;
  size_t i = 0;
  long out = 0;
  size_t fast_end = (len / 4) * 4;
  for (; i + 4 <= fast_end; i += 4) {
    int a = kB64.v[static_cast<unsigned char>(src[i])];
    int b = kB64.v[static_cast<unsigned char>(src[i + 1])];
    int c = kB64.v[static_cast<unsigned char>(src[i + 2])];
    int d = kB64.v[static_cast<unsigned char>(src[i + 3])];
    int bad = a | b | c | d;
    if (bad < 0) break;  // whitespace or invalid -> slow path below
    uint32_t word = (static_cast<uint32_t>(a) << 18) |
                    (static_cast<uint32_t>(b) << 12) |
                    (static_cast<uint32_t>(c) << 6) |
                    static_cast<uint32_t>(d);
    dst[out] = static_cast<unsigned char>(word >> 16);
    dst[out + 1] = static_cast<unsigned char>((word >> 8) & 0xFF);
    dst[out + 2] = static_cast<unsigned char>(word & 0xFF);
    out += 3;
  }
  // slow path for the remainder (or embedded whitespace)
  int acc = 0, bits = 0;
  for (; i < len; ++i) {
    unsigned char ch = static_cast<unsigned char>(src[i]);
    if (ch == '=' || ch == '\n' || ch == '\r') continue;
    int v = kB64.v[ch];
    if (v < 0) return -1;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      dst[out++] = static_cast<unsigned char>((acc >> bits) & 0xFF);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Opens tsv + lineidx; returns an opaque handle (nullptr on failure).
void* tsv_open(const char* tsv_path, const char* lineidx_path) {
  auto* f = new TsvFile();
  f->fd = open(tsv_path, O_RDONLY);
  if (f->fd < 0) { delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0) { close(f->fd); delete f; return nullptr; }
  f->size = static_cast<size_t>(st.st_size);
  f->data = static_cast<const char*>(
      mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0));
  if (f->data == MAP_FAILED) { close(f->fd); delete f; return nullptr; }
  madvise(const_cast<char*>(f->data), f->size, MADV_RANDOM);

  FILE* idx = fopen(lineidx_path, "r");
  if (!idx) {
    munmap(const_cast<char*>(f->data), f->size);
    close(f->fd);
    delete f;
    return nullptr;
  }
  char buf[64];
  while (fgets(buf, sizeof(buf), idx)) {
    if (buf[0] == '\0' || buf[0] == '\n') continue;
    f->lineidx.push_back(strtoull(buf, nullptr, 10));
  }
  fclose(idx);
  return f;
}

int64_t tsv_num_rows(void* handle) {
  return static_cast<int64_t>(static_cast<TsvFile*>(handle)->lineidx.size());
}

// Returns pointers to the raw row bytes (within the mmap) for row `idx`.
// *out_len receives the row length excluding the trailing newline.
const char* tsv_row_ptr(void* handle, int64_t idx, int64_t* out_len) {
  auto* f = static_cast<TsvFile*>(handle);
  if (idx < 0 || static_cast<size_t>(idx) >= f->lineidx.size()) return nullptr;
  size_t start = f->lineidx[idx];
  size_t end = (static_cast<size_t>(idx) + 1 < f->lineidx.size())
                   ? f->lineidx[idx + 1]
                   : f->size;
  while (end > start && (f->data[end - 1] == '\n' || f->data[end - 1] == '\r'))
    --end;
  *out_len = static_cast<int64_t>(end - start);
  return f->data + start;
}

// Decode base64 field `field_idx` (0-based, tab-separated) of row `idx` into
// caller buffer `dst` of capacity `dst_cap`. Returns decoded bytes, -1 on
// error, -2 if the buffer is too small (needed size is written to *needed).
int64_t tsv_decode_field(void* handle, int64_t idx, int32_t field_idx,
                         unsigned char* dst, int64_t dst_cap,
                         int64_t* needed) {
  int64_t row_len = 0;
  const char* row = tsv_row_ptr(handle, idx, &row_len);
  if (!row) return -1;
  const char* p = row;
  const char* end = row + row_len;
  for (int32_t i = 0; i < field_idx && p < end; ++i) {
    const char* tab = static_cast<const char*>(memchr(p, '\t', end - p));
    if (!tab) return -1;
    p = tab + 1;
  }
  const char* tab = static_cast<const char*>(memchr(p, '\t', end - p));
  const char* fend = tab ? tab : end;
  size_t flen = fend - p;
  int64_t max_out = static_cast<int64_t>(flen / 4 * 3 + 3);
  if (needed) *needed = max_out;
  if (max_out > dst_cap) return -2;
  return b64_decode(p, flen, dst);
}

// Batch-decode one base64 field per (row, field) pair with a thread pool.
// rows/fields: n entries; dst: n buffers each of dst_cap bytes (contiguous,
// dst + i*dst_cap); out_lens: n results (decoded size or <0 error).
void tsv_decode_batch(void* handle, const int64_t* rows,
                      const int32_t* fields, int64_t n, unsigned char* dst,
                      int64_t dst_cap, int64_t* out_lens, int32_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      out_lens[i] = tsv_decode_field(handle, rows[i], fields[i],
                                     dst + i * dst_cap, dst_cap, nullptr);
    }
  };
  int32_t nt = n_threads > 0 ? n_threads : 4;
  if (nt > n) nt = static_cast<int32_t>(n);
  // thread spawn/join costs ~100us; for small batches (or a single-core
  // host) decoding inline in the caller is strictly faster
  if (nt <= 1 || n <= 2) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();  // the calling thread participates instead of blocking in join
  for (auto& th : pool) th.join();
}

void tsv_close(void* handle) {
  auto* f = static_cast<TsvFile*>(handle);
  if (f->data && f->data != MAP_FAILED)
    munmap(const_cast<char*>(f->data), f->size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
