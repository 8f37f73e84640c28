// Indexed range decode in sidecar mode, one thread per coder stream.
//
// Replaces the TPU kernel compression_tpu/codec/pallas_coder.py:
// decode_indexed_pallas(in_stream_gamma=False) -> _decode_indexed_call
// (_make_decode_kernel_indexed with any_overflow=False).  It computes the
// same function as that kernel and as the XLA scan it is held to
// (jax_coder.decode_core with any_overflow=False): each element s,t is
// decoded with CDF row indexes[s,t]; an escape comes back as the marker
// len-2 with no Elias-gamma bits consumed (the values travel in the
// container's sidecar); bytes past the stream end read as zero
// (Read16BitValue); the sanity flag is RangeDecoder::Finalize's check and
// 2 * chunks_read >= byte_len (jax_coder.py:901-913).
//
// Symbol search, in the padded dense table (rows padded with their terminal
// value 2^precision), exactly as decode_core resolves it, also on corrupt
// input: count = #{k in [1, max_len) : size * cdf[k] < lower_bound}; the
// symbol is min(count, max_len - 2); the interval is [cdf[count],
// cdf[count + 1]) with 2^16 standing in for the upper end when count runs
// off the row.  "size * cdf[k] < lower_bound" is the TPU kernel's
// "cdf[k] < ceil(lower_bound / size)" without the division: Hopper has
// 64-bit multiplies, so no f32 quotient or hi/lo split is needed.
//
// What bounds it on this card: like the encoder, a serial chain per stream
// (a binary search of ~log2(max_len) dependent 64-bit multiply-compares per
// symbol, then the interval update), so the time is N steps of latency and
// the card fills only with many thousands of streams.  Bytes moved (~2 B in,
// 8 B in/out per symbol) are far below the memory rate.
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

__global__ void decode_indexed_kernel(
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

  const uint8_t* src = buf + s * buf_width;
  const int64_t src_len = byte_lens[s];
  const int64_t avail = src_len < buf_width ? src_len : buf_width;
  // Big-endian 16-bit chunk k; bytes past the stream end read as zero.
  auto chunk = [&](int64_t k) -> uint32_t {
    const int64_t p = 2 * k;
    const uint32_t hi = p < avail ? src[p] : 0u;
    const uint32_t lo = p + 1 < avail ? src[p + 1] : 0u;
    return (hi << 8) | lo;
  };

  uint32_t base = 0;
  uint32_t sm1 = 0xFFFFFFFFu;
  uint32_t value = (chunk(0) << 16) | chunk(1);
  int64_t chunks_read = 2;

  const int32_t* irow = indexes + s * num_elements;
  int32_t* orow = symbols + s * num_elements;
  for (int64_t j = 0; j < num_elements; ++j) {
    int row = irow[j];
    row = row < 0 ? 0 : (row >= num_rows ? num_rows - 1 : row);
    const int prec = mt[kMetaCols * row + 1];
    const int32_t* c = tab + static_cast<int64_t>(row) * max_len;
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
    orow[j] = count < max_len - 2 ? count : max_len - 2;

    const uint32_t a = static_cast<uint32_t>((size * c_lo) >> prec);
    const uint32_t b = static_cast<uint32_t>((size * c_hi) >> prec) - 1u;
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

  // RangeDecoder::Finalize check plus "stream fully consumed".
  const uint32_t upper = base + sm1;
  bool ok;
  if (base == 0 || upper < base) {
    ok = value == 0;
  } else {
    const int shift = ((base - 1) >> 24) < (upper >> 24) ? 24 : 16;
    const uint32_t mid = ((base - 1) >> shift) + 1;
    ok = (mid << shift) == value;
  }
  sanity[s] = (ok && 2 * chunks_read >= src_len) ? 1 : 0;
}

}  // namespace

extern "C" int ctpu_decode_indexed(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
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
        decode_indexed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = num_streams >= 128 * 132 ? 128 : 32;
  const int64_t blocks = (num_streams + threads - 1) / threads;
  if (blocks > 0) {
    decode_indexed_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        buf, buf_width, byte_lens, indexes, num_streams, num_elements, cdf,
        meta, num_rows, max_len, use_shared, symbols, sanity);
  }
  return static_cast<int>(cudaGetLastError());
}
