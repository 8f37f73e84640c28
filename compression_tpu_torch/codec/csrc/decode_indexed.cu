// Range decode, one thread per coder stream: four kernels over one copy of
// the RangeDecoder recurrence (three from one template, one with the
// bucketed symbol search).
//
//   ctpu_decode_indexed     (K2)  replaces compression_tpu/codec/pallas_coder.py:
//       decode_indexed_pallas(in_stream_gamma=False) -> _decode_indexed_call
//       (_make_decode_kernel_indexed with any_overflow=False).  Each element
//       s,t is decoded with CDF row indexes[s,t]; an escape comes back as
//       the marker len-2 with no Elias-gamma bits consumed (the values
//       travel in the native container's sidecar).
//   ctpu_decode_single_row  (K5') replaces pallas_coder.py:
//       decode_scan_pallas_v2 -> _decode_v2_call.  One shared CDF row, no
//       indexes, no overflow.
//   ctpu_decode_gamma       (K3') replaces pallas_coder.py:
//       decode_indexed_pallas(in_stream_gamma=True): the reference .tfci
//       format.  As K2, but the marker on an overflow row is followed by the
//       Elias-gamma magnitude and the sign (OverflowDecode), each bit decoded
//       with the binary uniform CDF at precision 1: zeros are counted while
//       n < 31 (what keeps a corrupt stream from looping), then n bits, then
//       the sign; the value is sign ? -g : g + (len-2) - 1 in int32.
//
//   ctpu_decode_single_row_bucketed (K8') replaces pallas_coder.py:
//       decode_scan_pallas (v1, kernel body _make_decode_kernel): one shared
//       CDF row, no overflow, symbol found by the two-level search of
//       pallas_coder.py:260-278 -- count the bucket-last values below the
//       threshold, then search the 17-entry window of that bucket
//       (jax_coder._bucketize_row: the last entry of the bucket before, then
//       the bucket's 16 entries).  "Below the threshold t = ceil(lower_bound
//       / size)" is tested as size * c < lower_bound with 64-bit products;
//       the TPU kernel's f32 quotient and +-2 fix-up is Mosaic's way around
//       its missing wide multiply and is not carried over.  The interval is
//       [largest window entry below, smallest one not below (at most 2^16)),
//       the symbol min(16 * full buckets + entries below in the window,
//       max_len - 1) - 1, and the sanity flag that of pallas_coder.py:301-313
//       (the same check as the other kernels').  It is the second,
//       independent single-row decoder that K5' is held against.
//
// The template's three compute the same function as the XLA scan the TPU kernels are
// held to, jax_coder.decode_core (jax_coder.py:779-914), also on corrupt
// input.  Bytes past the stream end read as zero (Read16BitValue); the
// sanity flag is RangeDecoder::Finalize's check and 2 * chunks_read >=
// byte_len (jax_coder.py:901-913).
//
// Symbol search, in the padded dense table (rows padded with their terminal
// value 2^precision), exactly as decode_core resolves it: count = #{k in
// [1, max_len) : size * cdf[k] < lower_bound}; the symbol is min(count,
// max_len - 2); the interval is [cdf[count], cdf[count + 1]) with 2^16
// standing in for the upper end when count runs off the row.  "size *
// cdf[k] < lower_bound" is the TPU kernels' "cdf[k] < ceil(lower_bound /
// size)" without the division: Hopper has 64-bit multiplies, so no f32
// quotient or hi/lo split is needed.  decode_core's single-row path counts
// in 16-entry buckets of the row padded with its terminal value, which
// gives the same count, symbol and interval.  A gamma bit is decode_core's
// _decode_binary: bit = size < lower_bound at precision 1, interval [bit,
// bit + 1) -- not the general search, which differs on corrupt streams.
//
// What bounds them on this card: like the encoder, a serial chain per
// stream (a binary search of ~log2(max_len) dependent 64-bit
// multiply-compares per symbol, then the interval update), so the time is N
// steps of latency and the card fills only with many thousands of streams;
// the classic .tfci container decodes a whole image on one thread.  Bytes
// moved (~2 B in, 8 B in/out per symbol) are far below the memory rate.
//
// What the design does about it: decoder state (base, size-1, value, read
// position) lives in registers, each thread reads its own stream's bytes,
// and the table and row metadata sit in shared memory (read through L1 from
// global when they do not fit), so the search probes never leave the SM.
// Small launches use 32-thread blocks to spread streams over more SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC decode_indexed.cu -o decode_indexed.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kU16 = 0xFFFFu;
constexpr int kMetaCols = 3;  // per row: escape marker len-2, precision, overflow

enum Mode { kIndexed = 0, kSingleRow = 1, kGamma = 2 };

struct Decoder {
  const uint8_t* src;
  int64_t avail;  // readable bytes: min(byte_len, buffer width)
  uint32_t base = 0;
  uint32_t sm1 = 0xFFFFFFFFu;
  uint32_t value;
  int64_t chunks_read = 2;

  // Big-endian 16-bit chunk k; bytes past the stream end read as zero.
  __device__ uint32_t chunk(int64_t k) const {
    const int64_t p = 2 * k;
    const uint32_t hi = p < avail ? src[p] : 0u;
    const uint32_t lo = p + 1 < avail ? src[p + 1] : 0u;
    return (hi << 8) | lo;
  }

  __device__ void start() { value = (chunk(0) << 16) | chunk(1); }

  // Narrows to [a, b] (already scaled) and renormalizes.
  __device__ void refine(uint32_t a, uint32_t b) {
    const uint32_t nb = base + a;
    const uint32_t ns = b - a;
    if ((ns >> 16) == 0) {
      base = nb << 16;
      sm1 = (ns << 16) | kU16;
      value = (value << 16) | chunk(chunks_read);
      ++chunks_read;
    } else {
      base = nb;
      sm1 = ns;
    }
  }

  // One symbol from row c (max_len entries, padded); returns min(count,
  // max_len - 2).
  __device__ int32_t symbol(const int32_t* c, int max_len, int prec) {
    const uint64_t size = static_cast<uint64_t>(sm1) + 1;
    const uint64_t lower_bound =
        (static_cast<uint64_t>(value - base) + 1) << prec;
    // First k in [1, max_len) with size * cdf[k] >= lower_bound.
    int lo = 1, hi = max_len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (size * static_cast<uint64_t>(c[mid]) < lower_bound) lo = mid + 1;
      else hi = mid;
    }
    const int count = lo - 1;
    const uint64_t c_lo = static_cast<uint32_t>(c[count]);
    const uint64_t c_hi =
        count + 1 < max_len ? static_cast<uint32_t>(c[count + 1]) : 65536u;
    refine(static_cast<uint32_t>((size * c_lo) >> prec),
           static_cast<uint32_t>((size * c_hi) >> prec) - 1u);
    return count < max_len - 2 ? count : max_len - 2;
  }

  // decode_core's _decode_binary: one bit at precision 1.
  __device__ uint32_t bit() {
    const uint64_t size = static_cast<uint64_t>(sm1) + 1;
    const uint64_t lower_bound =
        (static_cast<uint64_t>(value - base) + 1) << 1;
    const uint32_t b = size < lower_bound ? 1u : 0u;
    refine(static_cast<uint32_t>((size * b) >> 1),
           static_cast<uint32_t>((size * (b + 1)) >> 1) - 1u);
    return b;
  }

  // RangeDecoder::Finalize check plus "stream fully consumed".
  __device__ bool sane(int64_t src_len) const {
    const uint32_t upper = base + sm1;
    bool ok;
    if (base == 0 || upper < base) {
      ok = value == 0;
    } else {
      const int shift = ((base - 1) >> 24) < (upper >> 24) ? 24 : 16;
      const uint32_t mid = ((base - 1) >> shift) + 1;
      ok = (mid << shift) == value;
    }
    return ok && 2 * chunks_read >= src_len;
  }
};

template <int kMode>
__global__ void decode_kernel(
    const uint8_t* __restrict__ buf, int64_t buf_width,
    const int32_t* __restrict__ byte_lens,
    const int32_t* __restrict__ indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* __restrict__ cdf,
    const int32_t* __restrict__ meta, int num_rows, int max_len,
    bool use_shared, int32_t* __restrict__ symbols,
    uint8_t* __restrict__ sanity) {
  extern __shared__ int32_t smem[];
  const int32_t* tab = cdf;
  const int32_t* mt = meta;
  if (use_shared) {
    const int n_cdf = num_rows * max_len;
    for (int i = threadIdx.x; i < n_cdf; i += blockDim.x) smem[i] = cdf[i];
    for (int i = threadIdx.x; i < kMetaCols * num_rows; i += blockDim.x)
      smem[n_cdf + i] = meta[i];
    __syncthreads();
    tab = smem;
    mt = smem + n_cdf;
  }
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_streams) return;

  const int64_t src_len = byte_lens[s];
  Decoder dec;
  dec.src = buf + s * buf_width;
  dec.avail = src_len < buf_width ? src_len : buf_width;
  dec.start();

  const int32_t* irow =
      kMode == kSingleRow ? nullptr : indexes + s * num_elements;
  int32_t* orow = symbols + s * num_elements;
  for (int64_t j = 0; j < num_elements; ++j) {
    int row = 0;
    if (kMode != kSingleRow) {
      row = irow[j];
      row = row < 0 ? 0 : (row >= num_rows ? num_rows - 1 : row);
    }
    const int prec = mt[kMetaCols * row + 1];
    int32_t sym = dec.symbol(tab + static_cast<int64_t>(row) * max_len,
                             max_len, prec);
    if (kMode == kGamma) {
      const int32_t mv = mt[kMetaCols * row];
      if (mt[kMetaCols * row + 2] != 0 && sym == mv) {
        // OverflowDecode: unary count, n bits, sign.
        uint32_t n = 0;
        while (dec.bit() == 0u && ++n < 31u) {
        }
        uint32_t g = 1u << n;
        for (int k = static_cast<int>(n); k > 0; --k) g |= dec.bit() << (k - 1);
        const uint32_t sign = dec.bit();
        sym = static_cast<int32_t>(
            sign ? 0u - g : g + static_cast<uint32_t>(mv) - 1u);
      }
    }
    orow[j] = sym;
  }
  sanity[s] = dec.sane(src_len) ? 1 : 0;
}

// bucket_last: int32 [num_buckets]; win17: int32 [num_buckets, 17].
__global__ void decode_bucketed_kernel(
    const uint8_t* __restrict__ buf, int64_t buf_width,
    const int32_t* __restrict__ byte_lens, int64_t num_streams,
    int64_t num_elements, const int32_t* __restrict__ bucket_last,
    const int32_t* __restrict__ win17, int num_buckets, int max_pv, int prec,
    int32_t* __restrict__ symbols, uint8_t* __restrict__ sanity) {
  extern __shared__ int32_t smem[];
  int32_t* blast = smem;
  int32_t* win = smem + num_buckets;
  for (int i = threadIdx.x; i < num_buckets; i += blockDim.x)
    blast[i] = bucket_last[i];
  for (int i = threadIdx.x; i < 17 * num_buckets; i += blockDim.x)
    win[i] = win17[i];
  __syncthreads();
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_streams) return;

  const int64_t src_len = byte_lens[s];
  Decoder dec;
  dec.src = buf + s * buf_width;
  dec.avail = src_len < buf_width ? src_len : buf_width;
  dec.start();
  int32_t* orow = symbols + s * num_elements;
  for (int64_t j = 0; j < num_elements; ++j) {
    const uint64_t size = static_cast<uint64_t>(dec.sm1) + 1;
    const uint64_t lower_bound =
        (static_cast<uint64_t>(dec.value - dec.base) + 1) << prec;
    int nfull = 0;
    for (int b = 0; b < num_buckets; ++b)
      nfull += size * static_cast<uint64_t>(blast[b]) < lower_bound ? 1 : 0;
    const int bsel = nfull < num_buckets - 1 ? nfull : num_buckets - 1;
    const int32_t* w = win + 17 * bsel;
    int fine = 0;
    uint32_t c_lo = 0, c_hi = 1u << 17;
    for (int k = 0; k < 17; ++k) {
      const uint32_t c = static_cast<uint32_t>(w[k]);
      if (size * static_cast<uint64_t>(c) < lower_bound) {
        if (k > 0) ++fine;
        if (c > c_lo) c_lo = c;
      } else if (c < c_hi) {
        c_hi = c;
      }
    }
    if (c_hi > 65536u) c_hi = 65536u;
    int pv = 16 * nfull + fine;
    if (pv > max_pv) pv = max_pv;
    dec.refine(static_cast<uint32_t>((size * c_lo) >> prec),
               static_cast<uint32_t>((size * c_hi) >> prec) - 1u);
    orow[j] = pv - 1;
  }
  sanity[s] = dec.sane(src_len) ? 1 : 0;
}

template <int kMode>
int launch(const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
           const int32_t* indexes, int64_t num_streams, int64_t num_elements,
           const int32_t* cdf, const int32_t* meta, int num_rows, int max_len,
           int32_t* symbols, uint8_t* sanity, void* stream) {
  const size_t table_bytes =
      sizeof(int32_t) * (static_cast<size_t>(num_rows) * max_len +
                         static_cast<size_t>(kMetaCols) * num_rows);
  const bool use_shared = table_bytes <= 200 * 1024;
  const size_t smem = use_shared ? table_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = num_streams >= 128 * 132 ? 128 : 32;
  const int64_t blocks = (num_streams + threads - 1) / threads;
  if (blocks > 0) {
    decode_kernel<kMode><<<static_cast<unsigned>(blocks), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        buf, buf_width, byte_lens, indexes, num_streams, num_elements, cdf,
        meta, num_rows, max_len, use_shared, symbols, sanity);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctpu_decode_indexed(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    const int32_t* indexes, int64_t num_streams, int64_t num_elements,
    const int32_t* cdf, const int32_t* meta, int num_rows, int max_len,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  return launch<kIndexed>(buf, buf_width, byte_lens, indexes, num_streams,
                          num_elements, cdf, meta, num_rows, max_len,
                          symbols, sanity, stream);
}

// cdf / meta hold the one row: int32 [1, max_len] and [1, 3].
extern "C" int ctpu_decode_single_row(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    int64_t num_streams, int64_t num_elements, const int32_t* cdf,
    const int32_t* meta, int max_len, int32_t* symbols, uint8_t* sanity,
    void* stream) {
  return launch<kSingleRow>(buf, buf_width, byte_lens, nullptr, num_streams,
                            num_elements, cdf, meta, 1, max_len, symbols,
                            sanity, stream);
}

extern "C" int ctpu_decode_gamma(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    const int32_t* indexes, int64_t num_streams, int64_t num_elements,
    const int32_t* cdf, const int32_t* meta, int num_rows, int max_len,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  return launch<kGamma>(buf, buf_width, byte_lens, indexes, num_streams,
                        num_elements, cdf, meta, num_rows, max_len, symbols,
                        sanity, stream);
}

extern "C" int ctpu_decode_single_row_bucketed(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    int64_t num_streams, int64_t num_elements, const int32_t* bucket_last,
    const int32_t* win17, int num_buckets, int max_pv, int prec,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  const size_t smem = sizeof(int32_t) * 18 * static_cast<size_t>(num_buckets);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_bucketed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = num_streams >= 128 * 132 ? 128 : 32;
  const int64_t blocks = (num_streams + threads - 1) / threads;
  if (blocks > 0) {
    decode_bucketed_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        buf, buf_width, byte_lens, num_streams, num_elements, bucket_last,
        win17, num_buckets, max_pv, prec, symbols, sanity);
  }
  return static_cast<int>(cudaGetLastError());
}
