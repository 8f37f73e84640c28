// CDF pair lookup, one thread per element (K7').
//
//   ctpu_pair_lookup  replaces compression_tpu/codec/pallas_coder.py:
//       pair_lookup_pallas (kernel body _make_pair_lookup_kernel), the
//       encoder prep of jax_coder.micro_ops_from_symbols: for every flat
//       table index i it returns (flat[i], flat[i + 1]), the interval of the
//       symbol that index stands for.
//
// The TPU kernel takes the table as overlapping 17-wide windows and selects
// each lane's window with a loop over all buckets, because a TPU lane cannot
// gather; a CUDA thread can, so this kernel takes the flat table itself and
// indexes it.  The contract is the pair; the window form is not carried over.
//
// Indices are clamped to [0, table_size - 2], so a bad index reads a wrong
// pair and never memory outside the table (the wrapper's plain version
// clamps the same way, and the CPU path rejects such indices).
//
// What bounds it on this card: memory.  Each element reads 4 bytes and
// writes 8; the table (a few hundred KB at most) stays in L1/L2 after its
// first read.  The byte bound is 12 B per element over the card's memory
// rate.
//
// What the design does about it: idx is read and both outputs are written
// with consecutive threads on consecutive elements (coalesced), in a
// grid-stride loop over a grid of a few blocks per SM.  The table is read
// from global memory through the caches; staging it in shared memory was
// measured slower (PERF.md) and is not done.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC pair_lookup.cu -o pair_lookup.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pair_lookup_kernel(
    const int32_t* __restrict__ flat, int64_t table_size,
    const int32_t* __restrict__ idx, int64_t num_elements,
    int32_t* __restrict__ c_lo, int32_t* __restrict__ c_hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t last = table_size - 2;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < num_elements; e += stride) {
    int64_t i = idx[e];
    i = i < 0 ? 0 : (i > last ? last : i);
    c_lo[e] = flat[i];
    c_hi[e] = flat[i + 1];
  }
}

}  // namespace

// flat: int32 [table_size] (table_size >= 2); idx, c_lo, c_hi: int32
// [num_elements].
extern "C" int ctpu_pair_lookup(
    const int32_t* flat, int64_t table_size, const int32_t* idx,
    int64_t num_elements, int32_t* c_lo, int32_t* c_hi, void* stream) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (num_elements + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks > 0) {
    pair_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        flat, table_size, idx, num_elements, c_lo, c_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
