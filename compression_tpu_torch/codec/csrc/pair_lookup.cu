// CDF pair lookup, four consecutive elements per thread (K7').
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
// What bounds it on this card: memory at large sizes (each element reads 4
// bytes and writes 8; the table, a few hundred KB at most, stays in L1/L2
// after its first read; the byte bound is 12 B per element over the card's
// memory rate), and at the size compress_device gives it (one stream of a
// 512x512 image's latent, 2.4 MB moved) the launch itself: the device's work
// is a few microseconds, less than the host needs to enqueue it.
//
// What the design does about it: a thread reads four indices with one
// 16-byte load, has its eight table reads in flight together and writes each
// output with one 16-byte store; consecutive threads take consecutive
// groups (coalesced), in a grid-stride loop over a grid of a few blocks per
// SM.  Elements past the last whole group, or all of them when a pointer is
// not 16-byte aligned (indices that are a view into a larger tensor), go
// one a thread.  The entry point asks the runtime
// nothing: the grid's cap comes from the wrapper, which reads the SM count
// once when the library is loaded.  The table is read from global memory
// through the caches; staging it in shared memory was measured slower
// (PERF.md) and is not done.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC pair_lookup.cu -o pair_lookup.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ inline int64_t clamp_index(int32_t i, int64_t last) {
  return i < 0 ? 0 : (i > last ? last : static_cast<int64_t>(i));
}

// Elements [0, 4 * num_groups) go four a thread, the rest one a thread.
__global__ void pair_lookup_kernel(
    const int32_t* __restrict__ flat, int64_t table_size,
    const int32_t* __restrict__ idx, int64_t num_elements, int64_t num_groups,
    int32_t* __restrict__ c_lo, int32_t* __restrict__ c_hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t last = table_size - 2;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* lo4 = reinterpret_cast<int4*>(c_lo);
  int4* hi4 = reinterpret_cast<int4*>(c_hi);
  for (int64_t g = first; g < num_groups; g += stride) {
    const int4 i = idx4[g];
    const int64_t a = clamp_index(i.x, last), b = clamp_index(i.y, last);
    const int64_t c = clamp_index(i.z, last), d = clamp_index(i.w, last);
    const int4 lo = make_int4(flat[a], flat[b], flat[c], flat[d]);
    const int4 hi = make_int4(flat[a + 1], flat[b + 1], flat[c + 1],
                              flat[d + 1]);
    lo4[g] = lo;
    hi4[g] = hi;
  }
  for (int64_t e = 4 * num_groups + first; e < num_elements; e += stride) {
    const int64_t i = clamp_index(idx[e], last);
    c_lo[e] = flat[i];
    c_hi[e] = flat[i + 1];
  }
}

}  // namespace

// flat: int32 [table_size] (table_size >= 2); idx, c_lo, c_hi: int32
// [num_elements]; max_blocks: the grid's cap (a few blocks per SM).
extern "C" int ctpu_pair_lookup(
    const int32_t* flat, int64_t table_size, const int32_t* idx,
    int64_t num_elements, int32_t* c_lo, int32_t* c_hi, int max_blocks,
    void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(c_lo) |
        reinterpret_cast<uintptr_t>(c_hi)) & 15) == 0;
  const int64_t num_groups = aligned ? num_elements / 4 : 0;
  const int64_t tail = num_elements - 4 * num_groups;
  const int64_t work = num_groups > tail ? num_groups : tail;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > 0) {
    pair_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        flat, table_size, idx, num_elements, num_groups, c_lo, c_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
