// Native host multi-stream range codec for compression_tpu_torch (a copy
// of the JAX package's native/range_coder.cc; the two stay byte-identical
// in what they write).
//
// Implements the same carry-less range-coder recurrences as the Python
// specification in compression_tpu_torch/codec/reference.py (G.N.N.
// Martin 1979, 32-bit interval, 16-bit renormalization chunks,
// delayed-carry "state 1", short-number finalization; parity targets:
// reference cc/lib/range_coder.cc:37-307, cc/lib/range_coder.h:224-271)
// and the stream-batched op semantics of
// compression_tpu_torch/codec/stream.py (channel / indexed row
// addressing, Elias-gamma overflow escapes; reference
// cc/kernels/range_coder_kernels.cc:166-479).
//
// Role: the host path -- container assembly, decode-anywhere (the
// reference's TFLite kernels C11 serve this role for mobile), and the
// yardstick the CUDA kernels are timed against -- fanned out over a
// std::thread pool, one range of streams per thread (the reference uses
// TF's ThreadPool the same way).
//
// Tables arrive DENSE (cdf [num_rows, max_len] row-major + per-row
// length / precision / overflow), exactly the CdfTable layout produced by
// compression_tpu_torch.codec.tables.parse_ragged_cdf.
//
// Build:
//   g++ -O2 -shared -fPIC -std=c++17 -pthread range_coder.cc \
//       -o range_coder.so   (native.get_range_coder_lib does this into
//                          compression_tpu_torch/_build/)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kU32 = 0xFFFFFFFFull;

struct Encoder {
  uint64_t base = 0;          // uint32 range
  uint64_t size_minus1 = kU32;
  // Delayed-carry state: low 16 bits = deferred chunk value + 1,
  // high bits = count of deferred zero bytes.
  uint64_t delay = 0;

  uint8_t* out;
  int64_t cap;
  int64_t len = 0;
  bool overrun = false;

  void put(uint8_t b) {
    if (len >= cap) { overrun = true; return; }
    out[len++] = b;
  }
  void put_run(uint8_t b, uint64_t count) {
    for (uint64_t i = 0; i < count; ++i) put(b);
  }

  // Narrows the interval to [lower, upper) / 2**precision.
  void encode(uint32_t lower, uint32_t upper, int precision) {
    const uint64_t size = size_minus1 + 1;
    const uint64_t a = (size * lower) >> precision;
    const uint64_t b = ((size * upper) >> precision) - 1;

    const uint64_t new_base = (base + a) & kU32;
    const bool base_overflow = new_base < a;
    base = new_base;
    size_minus1 = (b - a) & kU32;

    if (base + size_minus1 > kU32) {
      // State 1: interval still straddles 2**32.
      if ((size_minus1 >> 16) == 0) {
        base = (base << 16) & kU32;
        size_minus1 = ((size_minus1 << 16) | 0xFFFF) & kU32;
        delay += 0x20000;  // two more deferred zero bytes
      }
      return;
    }

    if (delay != 0) {
      // Straddle resolved: flush the deferred chunk.
      if (base_overflow) {
        put((delay >> 8) & 0xFF);
        put(delay & 0xFF);
        put_run(0x00, delay >> 16);
      } else {
        const uint64_t d = delay - 1;
        put((d >> 8) & 0xFF);
        put(d & 0xFF);
        put_run(0xFF, d >> 16);
      }
      delay = 0;
    }

    if ((size_minus1 >> 16) == 0) {
      const uint64_t top = base >> 16;
      base = (base << 16) & kU32;
      size_minus1 = ((size_minus1 << 16) | 0xFFFF) & kU32;
      if (base + size_minus1 <= kU32) {
        put((top >> 8) & 0xFF);
        put(top & 0xFF);
      } else {
        delay = top + 1;  // enter state 1
      }
    }
  }

  void finalize() {
    if (delay != 0) {
      put((delay >> 8) & 0xFF);
      if (delay & 0xFF) put(delay & 0xFF);
    } else if (base != 0) {
      const uint64_t upper = (base + size_minus1) & kU32;
      const uint64_t mid24 = ((base - 1) >> 24) + 1;
      if (mid24 <= (upper >> 24)) {
        put(mid24 & 0xFF);
      } else {
        const uint64_t mid16 = ((base - 1) >> 16) + 1;
        put((mid16 >> 8) & 0xFF);
        if (mid16 & 0xFF) put(mid16 & 0xFF);
      }
    }
  }
};

struct Decoder {
  const uint8_t* src;
  int64_t src_len;
  int64_t pos = 0;
  uint64_t base = 0;
  uint64_t size_minus1 = kU32;
  uint64_t value = 0;
  bool corrupt = false;

  Decoder(const uint8_t* s, int64_t n) : src(s), src_len(n) {
    read16();
    read16();
  }

  void read16() {
    for (int i = 0; i < 2; ++i) {
      value = (value << 8) & kU32;
      if (pos < src_len) value |= src[pos++];
    }
  }

  // Returns the decoded symbol index given one CDF row.
  int decode(const int32_t* cdf, int n, int precision) {
    const uint64_t size = size_minus1 + 1;
    const uint64_t lower_bound = (((value - base) & kU32) + 1) << precision;

    // Smallest pv in [1, n-1] with size * cdf[pv] >= lower_bound.
    // Hybrid: a short linear prefix wins on the peaked (zipf-like) tables
    // learned priors produce; binary search bounds the flat-table worst
    // case.
    const auto below = [&](int i) {
      return size * static_cast<uint64_t>(cdf[i]) < lower_bound;
    };
    int pv = 1;
    const int prefix = n - 1 < 8 ? n - 1 : 8;
    while (pv < prefix && below(pv)) ++pv;
    if (pv == prefix && pv < n - 1 && below(pv)) {
      int lo = pv + 1, hi = n - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (below(mid)) lo = mid + 1; else hi = mid;
      }
      pv = lo;
    }

    const uint64_t a = (size * static_cast<uint64_t>(cdf[pv - 1])) >> precision;
    const uint64_t b =
        ((size * static_cast<uint64_t>(cdf[pv])) >> precision) - 1;
    base = (base + a) & kU32;
    size_minus1 = (b - a) & kU32;

    if ((size_minus1 >> 16) == 0) {
      base = (base << 16) & kU32;
      size_minus1 = ((size_minus1 << 16) | 0xFFFF) & kU32;
      read16();
    }
    return pv - 1;
  }

  bool finalize() {
    if (corrupt || pos != src_len) return false;
    const uint64_t upper = (base + size_minus1) & kU32;
    if (base == 0 || upper < base) return value == 0;
    const int shift = (((base - 1) >> 24) < (upper >> 24)) ? 24 : 16;
    const uint64_t mid = ((base - 1) >> shift) + 1;
    return ((mid << shift) & kU32) == value;
  }
};

const int32_t kBinaryUniform[3] = {0, 1, 2};

// Escape + Elias gamma embedding (reference range_coder_kernels.cc:290-322).
void overflow_encode(Encoder& enc, const int32_t* cdf, int n, int precision,
                     int64_t value) {
  const int64_t max_value = n - 2;
  const bool sign = value < 0;
  int64_t gamma = 0;
  if (sign) {
    gamma = -value;
    value = max_value;
  } else if (value >= max_value) {
    gamma = value - max_value + 1;
    value = max_value;
  }
  enc.encode(cdf[value], cdf[value + 1], precision);
  if (value != max_value) return;
  int nbits = 1;
  while (gamma >= (int64_t{1} << nbits)) {
    enc.encode(0, 1, 1);
    ++nbits;
  }
  for (int k = nbits - 1; k >= 0; --k) {
    const uint32_t bit = (gamma >> k) & 1;
    enc.encode(bit, bit + 1, 1);
  }
  enc.encode(sign ? 1 : 0, sign ? 2 : 1, 1);
}

int64_t overflow_decode(Decoder& dec, const int32_t* cdf, int n,
                        int precision) {
  const int64_t max_value = n - 2;
  int64_t value = dec.decode(cdf, n, precision);
  if (value != max_value) return value;
  int nbits = 0;
  while (dec.decode(kBinaryUniform, 3, 1) == 0) {
    // A corrupted stream can reach a fixed point where every binary decode
    // yields 0 forever (zero-filled tail keeps value-base at 0 through
    // renormalization); nbits >= 63 shifts would also be UB.  Real encoders
    // never exceed ~34 unary bits (int32 magnitudes), so cap and flag.
    if (++nbits > 62) {
      dec.corrupt = true;
      return 0;
    }
  }
  value = int64_t{1} << nbits;
  for (int k = nbits - 1; k >= 0; --k) {
    value |= static_cast<int64_t>(dec.decode(kBinaryUniform, 3, 1)) << k;
  }
  const int sign = dec.decode(kBinaryUniform, 3, 1);
  return sign ? -value : value + max_value - 1;
}

template <typename Fn>
void parallel_over_streams(int64_t num_streams, int num_threads, Fn fn) {
  if (num_threads <= 1 || num_streams <= 1) {
    fn(0, num_streams);
    return;
  }
  const int n = static_cast<int>(
      std::min<int64_t>(num_threads, num_streams));
  std::vector<std::thread> threads;
  threads.reserve(n);
  const int64_t per = (num_streams + n - 1) / n;
  for (int t = 0; t < n; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min<int64_t>(lo + per, num_streams);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 if any stream overran out_stride, -2 on a bad
// symbol (out of range for a bounded row).
int ctpu_encode_streams(const int32_t* values, const int32_t* indexes,
                        int64_t num_streams, int64_t num_elements,
                        const int32_t* cdf, const int32_t* length,
                        const int32_t* precision, const uint8_t* overflow,
                        int64_t num_rows, int64_t max_len, uint8_t* out_buf,
                        int64_t out_stride, int32_t* out_lengths,
                        int num_threads) {
  int status = 0;
  parallel_over_streams(num_streams, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      Encoder enc;
      enc.out = out_buf + s * out_stride;
      enc.cap = out_stride;
      std::memset(enc.out, 0, out_stride);
      const int32_t* vrow = values + s * num_elements;
      const int32_t* irow = indexes ? indexes + s * num_elements : nullptr;
      for (int64_t j = 0; j < num_elements; ++j) {
        const int64_t row = irow ? irow[j] : (j % num_rows);
        const int32_t* c = cdf + row * max_len;
        const int n = length[row];
        const int prec = precision[row];
        const int64_t v = vrow[j];
        if (overflow[row]) {
          overflow_encode(enc, c, n, prec, v);
        } else {
          if (v < 0 || v >= n - 1) { status = -2; return; }
          enc.encode(c[v], c[v + 1], prec);
        }
      }
      enc.finalize();
      if (enc.overrun) { status = -1; return; }
      out_lengths[s] = static_cast<int32_t>(enc.len);
    }
  });
  return status;
}

int ctpu_decode_streams(const uint8_t* buf, const int32_t* in_lengths,
                        int64_t in_stride, const int32_t* indexes,
                        int64_t num_streams, int64_t num_elements,
                        const int32_t* cdf, const int32_t* length,
                        const int32_t* precision, const uint8_t* overflow,
                        int64_t num_rows, int64_t max_len,
                        int32_t* out_values, uint8_t* out_sanity,
                        int num_threads) {
  parallel_over_streams(num_streams, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      Decoder dec(buf + s * in_stride, in_lengths[s]);
      const int32_t* irow = indexes ? indexes + s * num_elements : nullptr;
      int32_t* orow = out_values + s * num_elements;
      for (int64_t j = 0; j < num_elements; ++j) {
        const int64_t row = irow ? irow[j] : (j % num_rows);
        const int32_t* c = cdf + row * max_len;
        const int n = length[row];
        const int prec = precision[row];
        orow[j] = static_cast<int32_t>(
            overflow[row] ? overflow_decode(dec, c, n, prec)
                          : dec.decode(c, n, prec));
      }
      out_sanity[s] = dec.finalize() ? 1 : 0;
    }
  });
  return 0;
}

}  // extern "C"
