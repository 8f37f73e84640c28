// Range encode, one thread per coder stream: four kernels over one copy of
// the RangeEncoder recurrence (three from one template, one that reads
// precomputed intervals).
//
//   ctpu_encode_indexed     (K1)  replaces compression_tpu/codec/pallas_coder.py:
//       encode_indexed_device -> _encode_indexed_call (with the fused
//       _kernel_chunk_postpass and jax_coder._finalize_chunks).  Every
//       element s,t is coded with CDF row indexes[s,t]; out-of-range values
//       map to the escape marker len-2 on overflow rows and are clipped on
//       bounded rows (pallas_coder.py:1688-1694): the sidecar format.
//   ctpu_encode_single_row  (K4') replaces pallas_coder.py:
//       encode_single_row_device -> _encode_v3_call.  One shared CDF row, no
//       indexes; symbols are clipped to [0, len-2] (pallas_coder.py:1576).
//   ctpu_encode_gamma       (K6') replaces pallas_coder.py:encode_scan_pallas
//       (the scan over jax_coder.micro_ops_from_symbols' micro-ops, resolved
//       to bytes by jax_coder._encode_postpass): the reference .tfci format.
//       As K1, but an escape (a value past the range of an overflow row) is
//       followed in the stream by its Elias-gamma magnitude and sign, each
//       bit coded at precision 1 in the order of micro_ops_from_symbols
//       (jax_coder.py:552-575): floor(log2 g) zeros, the bits of g from the
//       top one down, then the sign; g = -v for v < 0 and v - (len-2) + 1
//       above the range, in uint32.  The TPU expands every symbol into
//       micro-ops first because a TPU lane cannot run a loop of its own
//       length; a thread can, so the kernel reads symbols and indexes
//       directly and needs no micro-op arrays.
//   ctpu_encode_scan        (K6, micro-op mode) is pallas_coder.py:
//       encode_scan_pallas as the JAX package calls it: it reads the
//       precomputed micro-ops (lower, upper, precision as uint32, mask as
//       bytes, each [T, S] with the stream axis fastest) that
//       jax_coder.micro_ops_from_symbols produced and runs the recurrence
//       over the steps whose mask is set.  Thread s reads element t * S + s
//       at step t, so a warp's reads are consecutive.  Where the TPU kernel
//       returns per-step records and the final state for a post-pass
//       (jax_coder._encode_postpass), this one writes the stream's bytes and
//       length itself, like the other three.
//
// Output is the byte stream of the reference RangeEncoder
// (compression_tpu/native/range_coder.cc, copied below, not included) with
// the tail past lengths[s] zeroed: the JAX package's padded arrays.
//
// What bounds them on this card: the recurrence is a serial chain per
// stream (two 64-bit multiplies, a handful of compares and a table read per
// coded interval), so a launch takes about N times the latency of one step
// and the card is busy only when there are many thousands of streams.  The
// classic .tfci container codes a whole image as one stream, so K6' then
// runs on one thread.  The bytes they move (8 B in and ~2 B out per symbol)
// are far below the memory rate.
//
// What the design does about it: state (base, size-1, delayed carry) lives
// in registers; the CDF table and the per-row metadata are staged once per
// block in shared memory (when they fit, else read through L1 from global),
// so the only global traffic in the loop is the symbol/index read and the
// byte write of the thread's own output row.  Because each thread owns its
// output row, the delayed-carry runs are written in place, and the TPU
// kernels' record buffer and reserve/resolve/compact post-pass disappear.
// Small launches use 32-thread blocks to spread streams over more SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC encode_indexed.cu -o encode_indexed.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kU32 = 0xFFFFFFFFull;
constexpr int kMetaCols = 3;  // per row: escape marker len-2, precision, overflow

enum Mode { kIndexed = 0, kSingleRow = 1, kGamma = 2 };

struct Encoder {
  uint64_t base = 0;
  uint64_t size_minus1 = kU32;
  // Delayed carry: low 16 bits = deferred chunk value + 1, high bits =
  // count of deferred fill bytes.
  uint64_t delay = 0;
  uint8_t* out;
  int64_t cap;
  int64_t len = 0;

  __device__ void put(uint8_t b) {
    if (len < cap) out[len] = b;
    ++len;
  }
  __device__ void put_run(uint8_t b, uint64_t count) {
    for (uint64_t i = 0; i < count; ++i) put(b);
  }

  // RangeEncoder::Encode: narrows the interval to [lower, upper) / 2^precision.
  __device__ void encode(uint32_t lower, uint32_t upper, int precision) {
    const uint64_t size = size_minus1 + 1;
    const uint64_t a = (size * lower) >> precision;
    const uint64_t b = ((size * upper) >> precision) - 1;
    const uint64_t new_base = (base + a) & kU32;
    const bool base_overflow = new_base < a;
    base = new_base;
    size_minus1 = (b - a) & kU32;

    if (base + size_minus1 > kU32) {
      // The interval still straddles 2^32: defer two more bytes.
      if ((size_minus1 >> 16) == 0) {
        base = (base << 16) & kU32;
        size_minus1 = ((size_minus1 << 16) | 0xFFFF) & kU32;
        delay += 0x20000;
      }
      return;
    }
    if (delay != 0) {
      // Straddle resolved: flush the deferred chunk and its fill run.
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
        delay = top + 1;
      }
    }
  }

  // One bit with the binary uniform CDF {0, 1, 2} at precision 1.
  __device__ void encode_bit(uint32_t bit) { encode(bit, bit + 1, 1); }

  // RangeEncoder::Finalize.
  __device__ void finalize() {
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

template <int kMode>
__global__ void encode_kernel(
    const int32_t* __restrict__ symbols, const int32_t* __restrict__ indexes,
    int64_t num_streams, int64_t num_elements,
    const int32_t* __restrict__ cdf, const int32_t* __restrict__ meta,
    int num_rows, int max_len, bool use_shared,
    uint8_t* __restrict__ out, int64_t out_size,
    int32_t* __restrict__ lengths) {
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

  Encoder enc;
  enc.out = out + s * out_size;
  enc.cap = out_size;
  const int32_t* vrow = symbols + s * num_elements;
  const int32_t* irow =
      kMode == kSingleRow ? nullptr : indexes + s * num_elements;
  for (int64_t j = 0; j < num_elements; ++j) {
    int row = 0;
    if (kMode != kSingleRow) {
      row = irow[j];
      row = row < 0 ? 0 : (row >= num_rows ? num_rows - 1 : row);
    }
    const int32_t maxs = mt[kMetaCols * row];
    const int prec = mt[kMetaCols * row + 1];
    const bool ovf = kMode != kSingleRow && mt[kMetaCols * row + 2] != 0;
    const int32_t v = vrow[j];
    // Escape map: marker on overflow rows, clip on bounded rows.
    const int32_t vq = v < 0 ? (ovf ? maxs : 0) : (v < maxs ? v : maxs);
    const int32_t* c = tab + static_cast<int64_t>(row) * max_len + vq;
    enc.encode(static_cast<uint32_t>(c[0]), static_cast<uint32_t>(c[1]), prec);
    if (kMode == kGamma && ovf && (v < 0 || v >= maxs)) {
      // OverflowEncode: Elias-gamma magnitude, then the sign.
      const uint32_t g = v < 0 ? 0u - static_cast<uint32_t>(v)
                               : static_cast<uint32_t>(v) -
                                     static_cast<uint32_t>(maxs) + 1u;
      const int nbits = 31 - __clz(g);  // g >= 1
      for (int k = 0; k < nbits; ++k) enc.encode_bit(0);
      for (int k = nbits; k >= 0; --k) enc.encode_bit((g >> k) & 1u);
      enc.encode_bit(v < 0 ? 1u : 0u);
    }
  }
  enc.finalize();
  // The wrappers size out_size for the most a stream can emit (two bytes
  // per coded interval plus two), so enc.len never exceeds the row.
  for (int64_t p = enc.len; p < out_size; ++p) enc.out[p] = 0;
  lengths[s] = static_cast<int32_t>(enc.len);
}

__global__ void encode_scan_kernel(
    const uint32_t* __restrict__ lower, const uint32_t* __restrict__ upper,
    const uint32_t* __restrict__ prec, const uint8_t* __restrict__ mask,
    int64_t num_steps, int64_t num_streams, uint8_t* __restrict__ out,
    int64_t out_size, int32_t* __restrict__ lengths) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_streams) return;
  Encoder enc;
  enc.out = out + s * out_size;
  enc.cap = out_size;
  for (int64_t t = 0; t < num_steps; ++t) {
    const int64_t p = t * num_streams + s;
    if (mask[p]) enc.encode(lower[p], upper[p], static_cast<int>(prec[p]));
  }
  enc.finalize();
  for (int64_t p = enc.len; p < out_size; ++p) enc.out[p] = 0;
  lengths[s] = static_cast<int32_t>(enc.len);
}

template <int kMode>
int launch(const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
           int64_t num_elements, const int32_t* cdf, const int32_t* meta,
           int num_rows, int max_len, uint8_t* out, int64_t out_size,
           int32_t* lengths, void* stream) {
  const size_t table_bytes =
      sizeof(int32_t) * (static_cast<size_t>(num_rows) * max_len +
                         static_cast<size_t>(kMetaCols) * num_rows);
  const bool use_shared = table_bytes <= 200 * 1024;
  const size_t smem = use_shared ? table_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        encode_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = num_streams >= 128 * 132 ? 128 : 32;
  const int64_t blocks = (num_streams + threads - 1) / threads;
  if (blocks > 0) {
    encode_kernel<kMode><<<static_cast<unsigned>(blocks), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        symbols, indexes, num_streams, num_elements, cdf, meta, num_rows,
        max_len, use_shared, out, out_size, lengths);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctpu_encode_indexed(
    const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* cdf, const int32_t* meta,
    int num_rows, int max_len, uint8_t* out, int64_t out_size,
    int32_t* lengths, void* stream) {
  return launch<kIndexed>(symbols, indexes, num_streams, num_elements, cdf,
                          meta, num_rows, max_len, out, out_size, lengths,
                          stream);
}

// cdf / meta hold the one row: int32 [1, max_len] and [1, 3].
extern "C" int ctpu_encode_single_row(
    const int32_t* symbols, int64_t num_streams, int64_t num_elements,
    const int32_t* cdf, const int32_t* meta, int max_len, uint8_t* out,
    int64_t out_size, int32_t* lengths, void* stream) {
  return launch<kSingleRow>(symbols, nullptr, num_streams, num_elements, cdf,
                            meta, 1, max_len, out, out_size, lengths, stream);
}

extern "C" int ctpu_encode_gamma(
    const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* cdf, const int32_t* meta,
    int num_rows, int max_len, uint8_t* out, int64_t out_size,
    int32_t* lengths, void* stream) {
  return launch<kGamma>(symbols, indexes, num_streams, num_elements, cdf,
                        meta, num_rows, max_len, out, out_size, lengths,
                        stream);
}

// lower, upper, prec: uint32 [num_steps, num_streams]; mask: uint8 of the
// same shape (nonzero = the step codes).
extern "C" int ctpu_encode_scan(
    const uint32_t* lower, const uint32_t* upper, const uint32_t* prec,
    const uint8_t* mask, int64_t num_steps, int64_t num_streams, uint8_t* out,
    int64_t out_size, int32_t* lengths, void* stream) {
  const int threads = num_streams >= 128 * 132 ? 128 : 32;
  const int64_t blocks = (num_streams + threads - 1) / threads;
  if (blocks > 0) {
    encode_scan_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        lower, upper, prec, mask, num_steps, num_streams, out, out_size,
        lengths);
  }
  return static_cast<int>(cudaGetLastError());
}
