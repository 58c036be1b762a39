// Native recordio core of the PyTorch port: index scanning, batched reads,
// batched writes (the port's own copy of the JAX package's
// src/recordio/recordio_core.cc, built from here).
//
// The reference keeps its data-loader hot loop in C++ (dmlc-core recordio
// framing wrapped by src/io/iter_image_recordio_2.cc); this is that layer.
// The on-disk format is identical to mxnet_tpu_torch/recordio.py (and the
// reference): little-endian [magic:u32][flag_len:u32][payload][pad to 4B],
// magic 0xCED7230A, the low 29 bits of flag_len the payload length, the top
// 3 bits a continuation flag.
//
// Exposed as a small C ABI used through ctypes
// (mxnet_tpu_torch/io/native.py): ctypes releases the GIL for each call, so
// a prefetch thread's batched read overlaps decode and the step on the card.
//
// Build: g++ -O2 -std=c++14 -shared -fPIC, at first use, into
// build/torch_kernels/ (mxnet_tpu_torch/io/native.py _build()).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xCED7230A;
constexpr uint32_t kLenBits = 29;
constexpr uint32_t kLenMask = (1u << kLenBits) - 1u;

struct Scan {
  std::vector<uint64_t> payload_offsets;  // file offset of the payload bytes
  std::vector<uint32_t> payload_sizes;
};

// Scan the framing without reading payloads (fseek-based), so indexing a
// multi-GB .rec touches only the 8-byte headers.
bool ScanFile(const char* path, Scan* out, char* err, size_t errcap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(err, errcap, "cannot open %s", path);
    return false;
  }
  uint64_t pos = 0;
  unsigned char head[8];
  while (true) {
    size_t got = std::fread(head, 1, 8, f);
    if (got == 0) break;  // clean EOF
    if (got < 8) {
      std::snprintf(err, errcap, "truncated header at offset %llu",
                    (unsigned long long)pos);
      std::fclose(f);
      return false;
    }
    uint32_t magic, flag_len;
    std::memcpy(&magic, head, 4);
    std::memcpy(&flag_len, head + 4, 4);
    if (magic != kMagic) {
      std::snprintf(err, errcap, "bad magic 0x%08x at offset %llu", magic,
                    (unsigned long long)pos);
      std::fclose(f);
      return false;
    }
    uint32_t n = flag_len & kLenMask;
    if ((flag_len >> kLenBits) != 0) {
      // multi-part record (dmlc-core splits payloads containing the magic
      // word): parity with the Python reader, which refuses them too —
      // callers fall back rather than silently return fragments
      std::snprintf(err, errcap, "multi-part record at offset %llu",
                    (unsigned long long)pos);
      std::fclose(f);
      return false;
    }
    out->payload_offsets.push_back(pos + 8);
    out->payload_sizes.push_back(n);
    uint64_t advance = n + ((4 - (n % 4)) % 4);
    if (std::fseek(f, (long)advance, SEEK_CUR) != 0) {
      std::snprintf(err, errcap, "seek failed at offset %llu",
                    (unsigned long long)pos);
      std::fclose(f);
      return false;
    }
    pos += 8 + advance;
  }
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Scans `path` and fills caller-visible arrays. Returns record count, or -1
// on error (message in err). The returned buffers are malloc'd; release with
// mxtpu_rio_free.
long long mxtpu_rio_index(const char* path, uint64_t** offsets_out,
                          uint32_t** sizes_out, char* err, size_t errcap) {
  Scan scan;
  if (!ScanFile(path, &scan, err, errcap)) return -1;
  size_t n = scan.payload_offsets.size();
  *offsets_out = (uint64_t*)std::malloc(n * sizeof(uint64_t));
  *sizes_out = (uint32_t*)std::malloc(n * sizeof(uint32_t));
  if ((n && !*offsets_out) || (n && !*sizes_out)) {
    std::snprintf(err, errcap, "out of memory for %zu records", n);
    std::free(*offsets_out);
    std::free(*sizes_out);
    *offsets_out = nullptr;
    *sizes_out = nullptr;
    return -1;
  }
  if (n) {
    std::memcpy(*offsets_out, scan.payload_offsets.data(),
                n * sizeof(uint64_t));
    std::memcpy(*sizes_out, scan.payload_sizes.data(), n * sizeof(uint32_t));
  }
  return (long long)n;
}

void mxtpu_rio_free(void* p) { std::free(p); }

// Reads `count` payloads into one contiguous caller buffer.  `offsets` are
// PAYLOAD offsets and `sizes` payload lengths (from mxtpu_rio_index, or
// computed from a .idx sidecar by adding 8 to the record offset).
// `dest_offsets[i]` receives where record i starts inside dest.
// Returns total bytes written, or -1 on error.
long long mxtpu_rio_read_batch(const char* path, const uint64_t* offsets,
                               const uint32_t* sizes, size_t count,
                               unsigned char* dest, size_t dest_cap,
                               uint64_t* dest_offsets, char* err,
                               size_t errcap) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    std::snprintf(err, errcap, "cannot open %s", path);
    return -1;
  }
  // Coalesce requests that sit near each other in the file (the iterator's
  // sequential batches are back-to-back modulo 8-byte headers + padding)
  // into single large pread spans — the syscall count drops from O(records)
  // to O(runs).  Gap threshold: reading <=64KB of skipped bytes is cheaper
  // than an extra syscall.
  constexpr uint64_t kGapMax = 64 * 1024;
  std::vector<size_t> order(count);
  for (size_t i = 0; i < count; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return offsets[a] < offsets[b];
  });
  uint64_t written = 0;
  for (size_t i = 0; i < count; ++i) {
    dest_offsets[i] = written;
    written += sizes[i];
  }
  if (written > dest_cap) {
    std::snprintf(err, errcap, "dest buffer too small (%llu > %zu)",
                  (unsigned long long)written, dest_cap);
    ::close(fd);
    return -1;
  }
  // Records above this size go straight from pread into their dest slot —
  // the kernel's sequential readahead already batches the IO, and a scratch
  // bounce-buffer would only add a copy.  Small records are coalesced through
  // scratch so a batch of 2KB payloads costs O(runs) syscalls, not O(records).
  constexpr uint32_t kDirectThreshold = 16 * 1024;
  std::vector<unsigned char> scratch;
  size_t i = 0;
  while (i < count) {
    size_t rec0 = order[i];
    if (sizes[rec0] >= kDirectThreshold) {
      ssize_t got = ::pread(fd, dest + dest_offsets[rec0], sizes[rec0],
                            (off_t)offsets[rec0]);
      if (got < 0 || (uint32_t)got < sizes[rec0]) {
        std::snprintf(err, errcap, "short read at offset %llu",
                      (unsigned long long)offsets[rec0]);
        ::close(fd);
        return -1;
      }
      ++i;
      continue;
    }
    size_t j = i;
    uint64_t span_begin = offsets[rec0];
    uint64_t span_end = span_begin + sizes[rec0];
    while (j + 1 < count && sizes[order[j + 1]] < kDirectThreshold) {
      uint64_t nxt = offsets[order[j + 1]];
      uint64_t nxt_end = nxt + sizes[order[j + 1]];
      if (nxt > span_end + kGapMax) break;
      if (nxt_end > span_end) span_end = nxt_end;
      ++j;
    }
    uint64_t span_len = span_end - span_begin;
    if (scratch.size() < span_len) scratch.resize(span_len);
    ssize_t got = ::pread(fd, scratch.data(), span_len, (off_t)span_begin);
    if (got < 0 || (uint64_t)got < span_len) {
      std::snprintf(err, errcap, "short read: span at %llu len %llu",
                    (unsigned long long)span_begin,
                    (unsigned long long)span_len);
      ::close(fd);
      return -1;
    }
    for (size_t k = i; k <= j; ++k) {
      size_t rec = order[k];
      std::memcpy(dest + dest_offsets[rec],
                  scratch.data() + (offsets[rec] - span_begin), sizes[rec]);
    }
    i = j + 1;
  }
  ::close(fd);
  return (long long)written;
}

// Reads the 8-byte header at `record_offset` and returns the payload size,
// or -1 on framing error. Lets the .idx-sidecar path (record offsets, not
// payload offsets) use read_batch without a full file scan.
long long mxtpu_rio_payload_size(const char* path, uint64_t record_offset,
                                 char* err, size_t errcap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(err, errcap, "cannot open %s", path);
    return -1;
  }
  unsigned char head[8];
  if (std::fseek(f, (long)record_offset, SEEK_SET) != 0 ||
      std::fread(head, 1, 8, f) != 8) {
    std::snprintf(err, errcap, "cannot read header at %llu",
                  (unsigned long long)record_offset);
    std::fclose(f);
    return -1;
  }
  uint32_t magic, flag_len;
  std::memcpy(&magic, head, 4);
  std::memcpy(&flag_len, head + 4, 4);
  std::fclose(f);
  if (magic != kMagic) {
    std::snprintf(err, errcap, "bad magic at %llu",
                  (unsigned long long)record_offset);
    return -1;
  }
  if ((flag_len >> kLenBits) != 0) {
    std::snprintf(err, errcap, "multi-part record at %llu",
                  (unsigned long long)record_offset);
    return -1;
  }
  return (long long)(flag_len & kLenMask);
}

// Appends `count` records (framed) to `path`; bufs is one contiguous buffer,
// sizes[i] the i-th payload length.  Fills record_offsets[i] with the file
// offset each framed record starts at (for the .idx sidecar).  Returns 0, or
// -1 on error.
int mxtpu_rio_write_batch(const char* path, const unsigned char* bufs,
                          const uint32_t* sizes, size_t count,
                          uint64_t* record_offsets, char* err, size_t errcap) {
  FILE* f = std::fopen(path, "ab");
  if (!f) {
    std::snprintf(err, errcap, "cannot open %s for append", path);
    return -1;
  }
  // ftell after opening in append mode = current end of file
  std::fseek(f, 0, SEEK_END);
  uint64_t pos = (uint64_t)std::ftell(f);
  const unsigned char zeros[4] = {0, 0, 0, 0};
  uint64_t consumed = 0;
  for (size_t i = 0; i < count; ++i) {
    uint32_t n = sizes[i];
    if (n > kLenMask) {
      std::snprintf(err, errcap, "record %zu too large (%u bytes)", i, n);
      std::fclose(f);
      return -1;
    }
    uint32_t flag_len = n;  // continuation flag 0
    record_offsets[i] = pos;
    if (std::fwrite(&kMagic, 4, 1, f) != 1 ||
        std::fwrite(&flag_len, 4, 1, f) != 1 ||
        (n && std::fwrite(bufs + consumed, 1, n, f) != n)) {
      std::snprintf(err, errcap, "write failed at record %zu", i);
      std::fclose(f);
      return -1;
    }
    uint32_t pad = (4 - (n % 4)) % 4;
    if (pad && std::fwrite(zeros, 1, pad, f) != pad) {
      std::snprintf(err, errcap, "pad write failed at record %zu", i);
      std::fclose(f);
      return -1;
    }
    consumed += n;
    pos += 8 + n + pad;
  }
  std::fclose(f);
  return 0;
}

int mxtpu_rio_abi_version(void) { return 1; }

}  // extern "C"
