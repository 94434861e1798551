// COCO run-length-encoding codec, host-side native implementation.
//
// Implements the MS-COCO compressed RLE string format (the on-disk format used
// by every mask in the SOLA pipeline; reference relies on pycocotools' C codec,
// see the reference's track_generation/utils.py:1-61 and dataloader.py:353-369).
//
// Format summary (independent implementation from the published spec):
//   * The binary mask (H x W) is flattened in COLUMN-MAJOR (Fortran) order.
//   * Run lengths alternate starting with the number of leading zeros
//     (which may be 0 if the mask starts with a 1).
//   * Counts are serialized into a printable string: each count is split into
//     5-bit groups, LSB first; from the 3rd count on, the delta vs. the count
//     two positions back is stored instead. Each 5-bit group is OR'd with 0x20
//     if more groups follow and offset by 48 into printable ASCII.
//
// Exposed as a C ABI for ctypes. Batched entry points parallelize across
// frames with a simple thread pool (std::thread), keeping RLE work off the
// accelerator and overlapped with device compute.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

// Encode run-length counts into the COCO printable-string format.
std::string counts_to_string(const std::vector<long> &cnts) {
  std::string s;
  s.reserve(cnts.size() * 3);
  for (size_t i = 0; i < cnts.size(); ++i) {
    long x = cnts[i];
    if (i > 2) x -= cnts[i - 2];
    bool more = true;
    while (more) {
      char c = static_cast<char>(x & 0x1f);
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      s.push_back(c);
    }
  }
  return s;
}

// Decode the COCO printable-string format into run-length counts.
bool string_to_counts(const char *s, size_t n, std::vector<long> &cnts) {
  cnts.clear();
  size_t i = 0;
  while (i < n && s[i]) {
    long x = 0;
    int k = 0;
    bool more = true;
    char c = 0;
    while (more) {
      if (i >= n) return false;
      c = s[i] - 48;
      x |= static_cast<long>(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= (-1L) << (5 * k);
    }
    if (cnts.size() > 2) x += cnts[cnts.size() - 2];
    cnts.push_back(x);
  }
  return true;
}

// Run-length encode a column-major scan of a row-major uint8 mask.
void dense_to_counts(const uint8_t *mask, long h, long w,
                     std::vector<long> &cnts) {
  cnts.clear();
  uint8_t prev = 0;  // runs start with zeros
  long run = 0;
  for (long c = 0; c < w; ++c) {
    const uint8_t *col = mask + c;  // stride h rows of length w (row-major)
    for (long r = 0; r < h; ++r) {
      uint8_t v = col[r * w] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        cnts.push_back(run);
        run = 1;
        prev = v;
      }
    }
  }
  cnts.push_back(run);
}

// Expand run-length counts into a row-major uint8 mask (column-major runs).
bool counts_to_dense(const std::vector<long> &cnts, long h, long w,
                     uint8_t *mask) {
  long pos = 0;
  const long total = h * w;
  uint8_t v = 0;
  for (size_t i = 0; i < cnts.size(); ++i) {
    long run = cnts[i];
    if (run < 0 || pos + run > total) return false;
    if (v) {
      for (long j = pos; j < pos + run; ++j) {
        long r = j % h, c = j / h;
        mask[r * w + c] = 1;
      }
    }
    pos += run;
    v = 1 - v;
  }
  return pos == total;
}

}  // namespace

extern "C" {

// Encodes one row-major (h, w) uint8 mask. Writes up to `cap` chars into
// `out`. Returns the string length, or -(needed_length) if `cap` is too
// small, or -1 on error.
long sola_rle_encode(const uint8_t *mask, long h, long w, char *out,
                     long cap) {
  std::vector<long> cnts;
  dense_to_counts(mask, h, w, cnts);
  std::string s = counts_to_string(cnts);
  if (static_cast<long>(s.size()) > cap) return -static_cast<long>(s.size());
  std::memcpy(out, s.data(), s.size());
  return static_cast<long>(s.size());
}

// Decodes one COCO RLE string into a row-major (h, w) uint8 mask buffer,
// which must be zero-initialized by the caller. Returns 0 on success.
long sola_rle_decode(const char *s, long slen, long h, long w, uint8_t *out) {
  std::vector<long> cnts;
  if (!string_to_counts(s, static_cast<size_t>(slen), cnts)) return -1;
  std::memset(out, 0, static_cast<size_t>(h * w));
  return counts_to_dense(cnts, h, w, out) ? 0 : -2;
}

// Returns the foreground pixel count of an RLE string without densifying.
long sola_rle_area(const char *s, long slen) {
  std::vector<long> cnts;
  if (!string_to_counts(s, static_cast<size_t>(slen), cnts)) return -1;
  long area = 0;
  for (size_t i = 1; i < cnts.size(); i += 2) area += cnts[i];
  return area;
}

// Batched decode: `strs` is a concatenation of `n` RLE strings whose i-th
// entry spans [offsets[i], offsets[i+1]) (offsets has n+1 entries). Output is
// a zeroed row-major (n, h, w) uint8 buffer. A negative offsets[i] start
// sentinel is not supported; empty strings produce all-zero masks (the
// reference's None-frame convention, dataloader.py:363-367). Returns 0 on
// success, else the 1-based index of the first failing frame, negated.
long sola_rle_decode_batch(const char *strs, const long *offsets, long n,
                           long h, long w, uint8_t *out, long n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<long> status(static_cast<size_t>(n), 0);
  auto work = [&](long t0, long t1) {
    for (long i = t0; i < t1; ++i) {
      const char *s = strs + offsets[i];
      long slen = offsets[i + 1] - offsets[i];
      uint8_t *dst = out + i * h * w;
      std::memset(dst, 0, static_cast<size_t>(h * w));
      if (slen == 0) continue;  // absent frame -> zeros
      std::vector<long> cnts;
      if (!string_to_counts(s, static_cast<size_t>(slen), cnts) ||
          !counts_to_dense(cnts, h, w, dst)) {
        status[i] = -(i + 1);
      }
    }
  };
  long nt = std::min<long>(n_threads, std::max<long>(n, 1));
  std::vector<std::thread> threads;
  long chunk = (n + nt - 1) / nt;
  for (long t = 0; t < nt; ++t) {
    long a = t * chunk, b = std::min(n, (t + 1) * chunk);
    if (a >= b) break;
    threads.emplace_back(work, a, b);
  }
  for (auto &th : threads) th.join();
  for (long i = 0; i < n; ++i)
    if (status[i] != 0) return status[i];
  return 0;
}

// Batched encode: encodes `n` row-major (h, w) masks from a contiguous
// (n, h, w) buffer. Encoded strings are written back-to-back into `out`
// (capacity `cap`); `offsets` receives n+1 entries. Returns total length on
// success, -(needed) if cap too small.
long sola_rle_encode_batch(const uint8_t *masks, long n, long h, long w,
                           char *out, long cap, long *offsets,
                           long n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::string> enc(static_cast<size_t>(n));
  auto work = [&](long t0, long t1) {
    for (long i = t0; i < t1; ++i) {
      std::vector<long> cnts;
      dense_to_counts(masks + i * h * w, h, w, cnts);
      enc[i] = counts_to_string(cnts);
    }
  };
  long nt = std::min<long>(n_threads, std::max<long>(n, 1));
  std::vector<std::thread> threads;
  long chunk = (n + nt - 1) / nt;
  for (long t = 0; t < nt; ++t) {
    long a = t * chunk, b = std::min(n, (t + 1) * chunk);
    if (a >= b) break;
    threads.emplace_back(work, a, b);
  }
  for (auto &th : threads) th.join();
  long total = 0;
  for (long i = 0; i < n; ++i) total += static_cast<long>(enc[i].size());
  if (total > cap) return -total;
  long pos = 0;
  for (long i = 0; i < n; ++i) {
    offsets[i] = pos;
    std::memcpy(out + pos, enc[i].data(), enc[i].size());
    pos += static_cast<long>(enc[i].size());
  }
  offsets[n] = pos;
  return total;
}

}  // extern "C"
