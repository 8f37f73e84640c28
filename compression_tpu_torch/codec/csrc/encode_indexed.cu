// Range encode: four functions over one copy of the RangeEncoder recurrence,
// each run one thread per coder stream, and three of them also one warp per
// stream for launches of few streams; K4''s thread kernel runs the warp
// kernels' 32-bit chain.
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
//       One thread per stream on the 32-bit chain below; see "K4'".
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
//       length; a thread can, so the kernels read symbols and indexes
//       directly and need no micro-op arrays.
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
//   ctpu_encode_indexed_warp, ctpu_encode_gamma_warp, ctpu_encode_scan_warp
//       the same functions as K1, K6' and the micro-op mode, one warp per
//       stream; see below.
//
// Output is the byte stream of the reference RangeEncoder
// (compression_tpu/native/range_coder.cc, copied below, not included) with
// the tail past lengths[s] zeroed: the JAX package's padded arrays.
//
// What bounds them on this card: the recurrence is a serial chain per
// stream (two 64-bit multiplies, a handful of compares and a table read per
// coded interval), so a launch takes about N times the latency of one step
// and the card is busy only when there are many thousands of streams.  The
// classic .tfci container codes a whole image as one stream.  The bytes
// they move (8 B in and ~2 B out per symbol) are far below the memory rate.
//
// Thread per stream (many streams): state (base, size-1, delayed carry)
// lives in registers; the CDF table and the per-row metadata are staged once
// per block in shared memory (when they fit, else read through L1 from
// global), so the only global traffic in the loop is the symbol/index read
// and the byte write of the thread's own output row.  Because each thread
// owns its output row, the delayed-carry runs are written in place, and the
// TPU kernels' record buffer and reserve/resolve/compact post-pass
// disappear; the thread zeroes its row's tail with 16-byte stores.  Small
// launches use 32-thread blocks to spread streams over more SMs.
//
// K4', the single-row encode of the coder's micro-bench (32768 streams of
// 512 symbols), is a thread per stream, and what costs there is issue: a
// step's chain is six operations, but a step is some sixty instructions and
// two warps share a scheduler.  So the kernel sheds instructions and takes
// loads off the chain:
//   - The step is the warp kernels' (scan_step, below), on one thread: the
//     32-bit chain on operands packed at precision 16, the delayed carry by
//     selects.  A block packs the row's operands once into shared memory;
//     a symbol's operands are then one load, issued for a window of 16
//     symbols before its first step, and the symbols come as 16-byte loads
//     one window ahead.
//   - Every interval of a row must be valid for the chain (0 <= lower <
//     upper <= 2^precision).  A row with a symbol of probability zero (an
//     empty interval) is not, and a block that sees one in the row takes
//     the reference recurrence, encode_stream, for its streams.
//   - Output bytes gather in a 64-byte ring a thread in shared memory and
//     leave it a 16-byte block at a time (a row's first and last block, and
//     the blocks of a row at an odd address, byte by byte); the tail is
//     zeroed by 16-byte stores.
//   - Measured on an H100 (PERF.md): 0.100 ms at 32768 x 512 against 0.253
//     for the reference recurrence one byte a store; ahead of it at every
//     stream count from 1 to 65536.
//
// Warp per stream (few streams: a classic container's one stream of a
// whole latent, ~200k coded steps, or the native container's 256-512
// streams, would leave a thread per stream on a lane or a few warps of the
// card, at ~360 clocks a step).  The 32 lanes cannot split the serial
// chain, so they carry it together and take everything else off it.  One
// warp alone on its scheduler issues in program order: what decides its
// time is the chain's dependent latencies, every instruction that waits on
// a load or shuffle in front of the chain, every taken branch, and the
// plain instruction count.
//   - Every lane carries the state (base, size - 1, the deferred chunk and
//     its fill count) in registers; every branch is uniform.
//   - The chain of a step is 32-bit: size * c is one wide multiply-add,
//     (size - 1) * c + c < 2^48, and the interval's ends are its bits 16-47
//     (one funnel shift), because the operands are pre-scaled to precision
//     16: c << (16 - precision) over 2^16 is c over 2^precision exactly.
//     The carry out of 2^32 is that of a 32-bit add.  Exact on every coded
//     step whose interval is valid (0 <= lower < upper <= 2^precision, as
//     every CDF and Elias-gamma step is); ctpu_encode_scan takes any input.
//   - Operands come a window of 32 steps at a time and are packed a window
//     ahead (lower' | (upper' - 1) << 16 after the scaling); a step's
//     packed operands reach every lane by one shuffle, issued a step ahead.
//     The micro-op scan loads step 32 w + l of the four arrays into lane l
//     two windows ahead; a ballot of the mask and a search over its
//     population counts hand lane i the i-th coded step, so masked steps
//     cost the chain nothing.  The symbol encoders load symbol 32 w + l and
//     its index four windows ahead (coalesced: a stream's symbols are
//     contiguous), the row's metadata three windows ahead and the CDF pair
//     two ahead, so none of the three dependent loads of a symbol waits in
//     front of the chain; the table sits in shared memory where it fits
//     (bls2017's 128 x 129), else its reads go through L1 (bmshj2018's 64 x
//     1481).  A window without an escape is exactly the scan's full window;
//     one with escapes (a ballot of the lanes' flags) or the stream's last,
//     partial window takes a path of its own, which codes symbol by symbol
//     and expands an escape in place into its 2 nbits + 2 precision-1
//     steps.
//   - A step is predicated throughout: the delayed-carry state (the
//     interval straddled 2^32 before the step) goes on or resolves by
//     selects, and only a resolved group with a fill run leaves the step's
//     code, for a function of its own.  Half a window of steps is one
//     straight run of code.  (Moving the whole delayed-carry state out of
//     the step was slower: the compiler then brackets every step's call
//     site with a convergence barrier, BSSY/BSYNC.)
//   - Output goes through the lanes: before Finalize every emission is one
//     16-bit chunk (a renormalization's top, a resolved deferred chunk, or a
//     fill pair), held chunk j sits in lane j % 32, and 32 chunks are
//     stored as 64 bytes at once (byte by byte where the row starts at an
//     odd address).  The window store and Finalize are functions of their
//     own too; the warp zeroes the row's tail with 16-byte stores.  K6''s
//     warp counts the coded steps of each window as it packs them (a
//     reduction over the lanes) and stops before a window that could take
//     the stream past its row, so a row too short for the stream (the
//     wrappers size rows for the whole stream) cuts it and is never
//     written past.
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

// Copies the table (cdf, then meta) into shared memory, 16 bytes a load
// where cdf starts 16-byte aligned; all of the block's threads take part.
__device__ void stage_table(const int32_t* __restrict__ cdf,
                            const int32_t* __restrict__ meta, int n_cdf,
                            int n_meta, int32_t* smem) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(cdf) & 15) == 0) {
    const int quads = n_cdf / 4;
    const int4* src = reinterpret_cast<const int4*>(cdf);
    int4* dst = reinterpret_cast<int4*>(smem);
    for (int i = threadIdx.x; i < quads; i += blockDim.x) dst[i] = src[i];
    head = 4 * quads;
  }
  for (int i = head + threadIdx.x; i < n_cdf; i += blockDim.x)
    smem[i] = cdf[i];
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x)
    smem[n_cdf + i] = meta[i];
  __syncthreads();
}

// One thread zeroes row[from, size): bytes up to a 16-byte boundary, 16-byte
// stores, bytes after the last boundary.
__device__ void zero_tail(uint8_t* row, int64_t from, int64_t size) {
  uint8_t* p = row + from;
  uint8_t* end = row + size;
  if (p >= end) return;
  uint8_t* mid = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~static_cast<uintptr_t>(15));
  if (mid > end) mid = end;
  for (; p < mid; ++p) *p = 0;
  uint4* v = reinterpret_cast<uint4*>(mid);
  const int64_t vecs = (end - mid) / 16;
  for (int64_t i = 0; i < vecs; ++i) v[i] = make_uint4(0, 0, 0, 0);
  for (p = mid + 16 * vecs; p < end; ++p) *p = 0;
}

// Stream s by the reference recurrence, one byte a store; tab / meta the
// table (staged or in global memory).
template <int kMode>
__device__ void encode_stream(int64_t s, const int32_t* __restrict__ symbols,
                              const int32_t* __restrict__ indexes,
                              int64_t num_elements, const int32_t* tab,
                              const int32_t* mt, int num_rows, int max_len,
                              uint8_t* __restrict__ out, int64_t out_size,
                              int32_t* __restrict__ lengths) {
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
  zero_tail(enc.out, enc.len, out_size);
  lengths[s] = static_cast<int32_t>(enc.len);
}

template <int kMode>
__global__ void encode_kernel(
    const int32_t* __restrict__ symbols, const int32_t* __restrict__ indexes,
    int64_t num_streams, int64_t num_elements,
    const int32_t* __restrict__ cdf, const int32_t* __restrict__ meta,
    int num_rows, int max_len, bool use_shared,
    uint8_t* __restrict__ out, int64_t out_size,
    int32_t* __restrict__ lengths) {
  extern __shared__ __align__(16) int32_t smem[];
  const int32_t* tab = cdf;
  const int32_t* mt = meta;
  if (use_shared) {
    stage_table(cdf, meta, num_rows * max_len, kMetaCols * num_rows, smem);
    tab = smem;
    mt = smem + num_rows * max_len;
  }
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= num_streams) return;
  encode_stream<kMode>(s, symbols, indexes, num_elements, tab, mt, num_rows,
                       max_len, out, out_size, lengths);
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
  zero_tail(enc.out, enc.len, out_size);
  lengths[s] = static_cast<int32_t>(enc.len);
}

// ---------------------------------------------------------------------------
// One warp per stream: the chain (K6 micro-op mode, K6', K1).
// ---------------------------------------------------------------------------
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kScanWarps = 4;  // streams (one warp each) per block

// The warp's output row.
struct ScanOut {
  uint8_t* row;
  int lane;
  bool even;  // the row starts at an even address: chunks as 16-bit stores
};

// The encoder state, the same in every lane, and the chunks held in lanes.
// Chunk j of those held sits in lane j % 32 of keep0 (j < 32) or keep1: a
// step holds at most two chunks besides a fill run, which drains the window
// as it goes, so the window drained every 16 steps never fills its 64 slots.
struct ScanState {
  uint32_t base;
  uint32_t sm1;   // size - 1
  uint32_t pend;  // 0, or the deferred chunk + 1 (the reference's delay & 0xFFFF)
  uint32_t fill;  // deferred fill chunks (the reference's delay >> 17); the
                  // length is an int32, so a stream has fewer than 2^30
  int k;          // chunks held
  uint32_t keep0, keep1;  // this lane's held chunks
  int64_t pos;    // bytes of the row stored so far (a multiple of 64)
};

// Lanes 0 .. n-1 store their chunks, high byte first, at dst + 2 * lane.
__device__ void store_chunks(uint8_t* dst, uint32_t chunk, int n,
                             const ScanOut& o) {
  if (o.lane >= n) return;
  if (o.even) {
    reinterpret_cast<uint16_t*>(dst)[o.lane] =
        static_cast<uint16_t>(__byte_perm(chunk, 0u, 0x0001));
  } else {
    dst[2 * o.lane] = static_cast<uint8_t>(chunk >> 8);
    dst[2 * o.lane + 1] = static_cast<uint8_t>(chunk);
  }
}

// A full window, 32 chunks, stored as 64 bytes: once per 32 emissions, so
// kept out of the steps' code.
__device__ __noinline__ ScanState store_window(ScanState e, ScanOut o) {
  store_chunks(o.row + e.pos, e.keep0, 32, o);
  e.pos += 64;
  e.k -= 32;
  e.keep0 = e.keep1;
  return e;
}

// Stores the first 32 held chunks where there are as many.
__device__ __forceinline__ void drain(ScanState& e, const ScanOut& o) {
  if (__builtin_expect(e.k >= 32, 0)) e = store_window(e, o);
}

// Holds ``chunk`` as the next chunk where ``on`` holds.
__device__ __forceinline__ void hold(ScanState& e, uint32_t chunk, bool on,
                                     int lane) {
  const int d = e.k - lane;
  e.keep0 = (on && d == 0) ? chunk : e.keep0;
  e.keep1 = (on && d == 32) ? chunk : e.keep1;
  e.k += on ? 1 : 0;
}

// The deferred fill run, e.fill chunks of ``v``, through the same window.
__device__ __noinline__ ScanState fill_run(ScanState e, uint32_t v,
                                           ScanOut o) {
  if (e.k >= 32) e = store_window(e, o);
  while (e.fill != 0) {
    const int n = min(static_cast<int>(min(e.fill, 32u)), 32 - e.k);
    e.keep0 = (o.lane >= e.k && o.lane < e.k + n) ? v : e.keep0;
    e.k += n;
    e.fill -= n;
    if (e.k == 32) e = store_window(e, o);
  }
  return e;
}

// RangeEncoder::Encode on one coded step, ``op`` its packed operands:
// lower' | (upper' - 1) << 16, both scaled to precision 16.  Predicated
// throughout: the delayed-carry state (the interval straddled 2^32 before
// the step) is taken by selects, and only a resolved group with a fill run
// leaves the step's code.
__device__ __forceinline__ void scan_step(ScanState& e, uint32_t op,
                                          const ScanOut& o) {
  const uint32_t lo = op & 0xFFFFu;
  const uint32_t hi = (op >> 16) + 1u;
  const uint32_t a =
      static_cast<uint32_t>((static_cast<uint64_t>(e.sm1) * lo + lo) >> 16);
  const uint32_t b =
      static_cast<uint32_t>((static_cast<uint64_t>(e.sm1) * hi + hi) >> 16);
  const uint32_t nb = e.base + a;
  const uint32_t ns = b - 1u - a;
  const bool renorm = ns < 0x10000u;
  const uint32_t sb = renorm ? nb << 16 : nb;
  const uint32_t ss = renorm ? (ns << 16) | 0xFFFFu : ns;
  // In the delayed-carry state: still straddling, or resolved, which
  // flushes the deferred chunk (+1 where base carried out of 2^32) and its
  // fill run (0x00 up, 0xFF down).
  const bool in_delay = e.pend != 0;
  const bool straddle = in_delay && (nb + ns < nb);
  const bool resolved = in_delay && !straddle;
  const bool up = nb < a;
  hold(e, up ? e.pend : e.pend - 1u, resolved, o.lane);
  if (__builtin_expect(resolved && e.fill != 0, 0))
    e = fill_run(e, up ? 0u : 0xFFFFu, o);
  // A renormalization outside a straddle emits its top chunk, or defers it
  // where the shifted interval straddles 2^32; one inside a straddle
  // defers two more fill bytes.
  const uint32_t top = nb >> 16;
  const bool amb = renorm && !straddle && (sb + ss < sb);
  hold(e, top, renorm && !straddle && !amb, o.lane);
  e.fill += (straddle && renorm) ? 1u : 0u;
  e.pend = straddle ? e.pend : (amb ? top + 1u : 0u);
  e.base = sb;
  e.sm1 = ss;
}

// The output row of the warp of stream s.
__device__ __forceinline__ ScanOut scan_out(uint8_t* out, int64_t s,
                                            int64_t out_size, int lane) {
  ScanOut o;
  o.row = out + s * out_size;
  o.lane = lane;
  o.even = (reinterpret_cast<uintptr_t>(o.row) & 1) == 0;
  return o;
}

// RangeEncoder::Finalize, the held chunks, the tail's zeros and the length.
__device__ __noinline__ void scan_finish(ScanState e, ScanOut o,
                                         int64_t out_size, int32_t* length) {
  if (e.k >= 32) e = store_window(e, o);
  store_chunks(o.row + e.pos, e.keep0, e.k, o);
  int64_t len = e.pos + 2 * e.k;
  uint32_t b0 = 0, b1 = 0;
  int nbytes = 0;
  if (e.pend != 0) {
    b0 = (e.pend >> 8) & 0xFFu;
    b1 = e.pend & 0xFFu;
    nbytes = b1 ? 2 : 1;
  } else if (e.base != 0) {
    const uint32_t upper = e.base + e.sm1;
    const uint32_t mid24 = ((e.base - 1u) >> 24) + 1u;
    if (mid24 <= (upper >> 24)) {
      b0 = mid24 & 0xFFu;
      nbytes = 1;
    } else {
      const uint32_t mid16 = ((e.base - 1u) >> 16) + 1u;
      b0 = (mid16 >> 8) & 0xFFu;
      b1 = mid16 & 0xFFu;
      nbytes = b1 ? 2 : 1;
    }
  }
  if (o.lane == 0) {
    if (nbytes > 0) o.row[len] = static_cast<uint8_t>(b0);
    if (nbytes > 1) o.row[len + 1] = static_cast<uint8_t>(b1);
    *length = static_cast<int32_t>(len + nbytes);
  }
  len += nbytes;
  // Zeros from len to out_size: bytes up to a 16-byte boundary, 16-byte
  // stores, bytes after the last boundary.
  uint8_t* p = o.row + len;
  uint8_t* end = o.row + out_size;
  if (p >= end) return;
  uint8_t* mid = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~static_cast<uintptr_t>(15));
  if (mid > end) mid = end;
  if (o.lane < mid - p) p[o.lane] = 0;
  const int64_t vecs = (end - mid) / 16;
  uint4* v = reinterpret_cast<uint4*>(mid);
  for (int64_t i = o.lane; i < vecs; i += 32) v[i] = make_uint4(0, 0, 0, 0);
  uint8_t* rest = mid + 16 * vecs;
  if (o.lane < end - rest) rest[o.lane] = 0;
}

// A full window: the 32 steps whose packed operands lanes 0-31 hold in
// ``ops``, in two straight runs of 16, drained after each.  ``op_a`` is
// lane 0's, shuffled by the caller before it branched.
__device__ __forceinline__ void scan_window32(ScanState& e, uint32_t ops,
                                              uint32_t op_a,
                                              const ScanOut& o) {
  for (int h = 0; h < 32; h += 16) {
#pragma unroll
    for (int i = h; i < h + 16; i += 2) {
      // Two operand registers that swap roles: the shuffle of the next
      // step goes out before the chain of this one.
      const uint32_t op_b = __shfl_sync(kFullMask, ops, i + 1);
      scan_step(e, op_a, o);
      op_a = __shfl_sync(kFullMask, ops, i + 2);
      scan_step(e, op_b, o);
    }
    drain(e, o);
  }
}

// One window's worth of a stream's micro-ops, one step a lane, as loaded.
struct ScanLoads {
  uint32_t lower, upper, prec;
  uint8_t mask;
};

__global__ void __launch_bounds__(32 * kScanWarps)
encode_scan_warp_kernel(
    const uint32_t* __restrict__ lower, const uint32_t* __restrict__ upper,
    const uint32_t* __restrict__ prec, const uint8_t* __restrict__ mask,
    int64_t num_steps, int64_t num_streams, uint8_t* __restrict__ out,
    int64_t out_size, int32_t* __restrict__ lengths) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (s >= num_streams) return;
  const ScanOut o = scan_out(out, s, out_size, lane);
  ScanState e = {0u, 0xFFFFFFFFu, 0u, 0u, 0, 0u, 0u, 0};

  // Lane l's step of window w.
  auto load = [&](int64_t w, ScanLoads& r) {
    const int64_t t = 32 * w + lane;
    r = ScanLoads{0u, 1u, 16u, 0};
    if (t < num_steps) {
      const int64_t p = t * num_streams + s;
      r.lower = lower[p];
      r.upper = upper[p];
      r.prec = prec[p];
      r.mask = mask[p];
    }
  };
  // Packs a window's loads: ``bits`` the coded steps, lane i's ``ops`` the
  // operands of the window's i-th coded step.
  auto pack = [&](const ScanLoads& r, uint32_t& ops, uint32_t& bits) {
    bits = __ballot_sync(kFullMask, r.mask != 0);
    const uint32_t sh = 16u - r.prec;
    const uint32_t mine =
        ((r.lower << sh) & 0xFFFFu) | (((r.upper << sh) - 1u) << 16);
    // The position of the (lane + 1)-th set bit: the largest src with
    // exactly ``lane`` set bits below it.
    int src = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__popc(bits & ((1u << (src + step)) - 1u)) <= lane) src += step;
    ops = __shfl_sync(kFullMask, mine, src);
  };

  ScanLoads raw;
  uint32_t ops, bits;
  load(0, raw);
  pack(raw, ops, bits);
  load(1, raw);
  for (int64_t w = 0; 32 * w < num_steps; ++w) {
    uint32_t ops_next, bits_next;
    pack(raw, ops_next, bits_next);  // window w + 1, loaded a window ago
    load(w + 2, raw);
    const int n = __popc(bits);
    uint32_t op_a = __shfl_sync(kFullMask, ops, 0);
    if (n == 32) {
      scan_window32(e, ops, op_a, o);
    } else {
#pragma unroll 1
      for (int i = 0; i < n; i += 2) {
        const uint32_t op_b = __shfl_sync(kFullMask, ops, i + 1);
        scan_step(e, op_a, o);
        if (i + 1 < n) {
          op_a = __shfl_sync(kFullMask, ops, i + 2);
          scan_step(e, op_b, o);
        }
        drain(e, o);
      }
    }
    ops = ops_next;
    bits = bits_next;
  }
  scan_finish(e, o, out_size, lengths + s);
}

// The operands of a precision-1 step coding ``bit``: scan_op(bit, bit + 1, 1).
__device__ __forceinline__ uint32_t bit_op(uint32_t bit) {
  return bit ? 0xFFFF8000u : 0x7FFF0000u;
}

// OverflowEncode of an escape with Elias-gamma magnitude g >= 1 and sign
// ``neg``: 2 nbits + 2 steps at precision 1 (nbits zeros, the nbits + 1
// bits of g from the top one down, the sign), drained after every two.  At
// most 64 steps (g <= 2^31).
__device__ __noinline__ ScanState gamma_steps(ScanState e, uint32_t g,
                                              uint32_t neg, ScanOut o) {
  const int nbits = 31 - __clz(g);
  auto bit = [&](int k) -> uint32_t {
    return k < nbits ? 0u : (k <= 2 * nbits ? (g >> (2 * nbits - k)) & 1u
                                            : neg);
  };
#pragma unroll 1
  for (int k = 0; k <= 2 * nbits; k += 2) {
    scan_step(e, bit_op(bit(k)), o);
    scan_step(e, bit_op(bit(k + 1)), o);
    drain(e, o);
  }
  return e;
}

// A window that is not a full run of 32 plain steps: its first ``nsym``
// symbols one at a time (``op_a`` lane 0's operands, as scan_window32's),
// each escape (bit i of ``esc``) followed in place by its Elias-gamma steps
// (lane i's ``gs``, bit i of ``neg``); drained after every symbol, so at
// most 2 + 4 chunks come between two drains.
__device__ __noinline__ ScanState symbol_window(ScanState e, uint32_t ops,
                                                uint32_t op_a, uint32_t gs,
                                                uint32_t esc, uint32_t neg,
                                                int nsym, ScanOut o) {
#pragma unroll 1
  for (int i = 0; i < nsym; ++i) {
    const uint32_t op_b = __shfl_sync(kFullMask, ops, i + 1);
    const uint32_t g = __shfl_sync(kFullMask, gs, i);
    scan_step(e, op_a, o);
    if ((esc >> i) & 1u) e = gamma_steps(e, g, (neg >> i) & 1u, o);
    drain(e, o);
    op_a = op_b;
  }
  return e;
}

// A window of a stream's symbols on its way from the loads to packed
// operands, lane l holding symbol 32 w + l: the symbol and its index, then
// the row's metadata, then the CDF pair.
struct SymLoads {
  int32_t v, row, maxs, prec, ovf;
  uint32_t c0, c1;
};

// A window's packed operands (``op``, lane l's symbol's), its escapes'
// Elias-gamma magnitudes (``g``, lane l's), and the window's escapes and
// negative values as ballots.
struct SymOps {
  uint32_t op, g, esc, neg;
};

// K1 (kIndexed) and K6' (kGamma), one warp per stream: encode_kernel's
// function, on the chain above.  The table is staged by the block as in
// encode_kernel.
template <int kMode>
__global__ void __launch_bounds__(32 * kScanWarps)
encode_symbols_warp_kernel(
    const int32_t* __restrict__ symbols, const int32_t* __restrict__ indexes,
    int64_t num_streams, int64_t num_elements,
    const int32_t* __restrict__ cdf, const int32_t* __restrict__ meta,
    int num_rows, int max_len, bool use_shared,
    uint8_t* __restrict__ out, int64_t out_size,
    int32_t* __restrict__ lengths) {
  extern __shared__ __align__(16) int32_t smem[];
  const int32_t* tab = cdf;
  const int32_t* mt = meta;
  if (use_shared) {
    stage_table(cdf, meta, num_rows * max_len, kMetaCols * num_rows, smem);
    tab = smem;
    mt = smem + num_rows * max_len;
  }
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (s >= num_streams) return;
  const ScanOut o = scan_out(out, s, out_size, lane);
  ScanState e = {0u, 0xFFFFFFFFu, 0u, 0u, 0, 0u, 0u, 0};
  const int64_t n = num_elements;
  const int32_t* vrow = symbols + s * n;
  const int32_t* irow = indexes + s * n;

  // The stages, each a window ahead of the next.  Lanes past the stream's
  // end read row 0 and code nothing.
  auto load_symbols = [&](int64_t w, SymLoads& a) {
    const int64_t j = 32 * w + lane;
    a.v = 0;
    a.row = 0;
    if (j < n) {
      a.v = vrow[j];
      a.row = irow[j];
    }
  };
  auto load_meta = [&](SymLoads& a) {
    a.row = a.row < 0 ? 0 : (a.row >= num_rows ? num_rows - 1 : a.row);
    const int32_t* m = mt + kMetaCols * a.row;
    a.maxs = m[0];
    a.prec = m[1];
    a.ovf = m[2];
  };
  auto load_pair = [&](SymLoads& a) {
    // Escape map: marker on overflow rows, clip on bounded rows.
    const int32_t vq =
        a.v < 0 ? (a.ovf ? a.maxs : 0) : (a.v < a.maxs ? a.v : a.maxs);
    const int32_t* c = tab + static_cast<int64_t>(a.row) * max_len + vq;
    a.c0 = static_cast<uint32_t>(c[0]);
    a.c1 = static_cast<uint32_t>(c[1]);
  };
  auto pack = [&](int64_t w, const SymLoads& a, SymOps& q) {
    const uint32_t sh = 16u - static_cast<uint32_t>(a.prec);
    q.op = ((a.c0 << sh) & 0xFFFFu) | (((a.c1 << sh) - 1u) << 16);
    q.g = q.esc = q.neg = 0u;
    if (kMode == kGamma) {
      q.esc = __ballot_sync(kFullMask, lane < n - 32 * w && a.ovf &&
                                           (a.v < 0 || a.v >= a.maxs));
      q.neg = __ballot_sync(kFullMask, a.v < 0);
      q.g = a.v < 0 ? 0u - static_cast<uint32_t>(a.v)
                    : static_cast<uint32_t>(a.v) -
                          static_cast<uint32_t>(a.maxs) + 1u;
    }
  };

  // Window 0 packed, 1 with its pair, 2 with its metadata, 3 loaded.
  SymLoads a1, a2, a3;
  SymOps cur;
  load_symbols(0, a1);
  load_meta(a1);
  load_pair(a1);
  pack(0, a1, cur);
  load_symbols(1, a1);
  load_meta(a1);
  load_pair(a1);
  load_symbols(2, a2);
  load_meta(a2);
  load_symbols(3, a3);
  // A row of out_size bytes holds the bytes of (out_size - 2) / 2 coded
  // steps for certain (each emits at most two, Finalize two more).  The
  // wrappers give K1 and K6' a row for the stream's n symbols at least; so
  // K6' counts its escapes' Elias-gamma steps, window by window, and does
  // not code a window after which n plus those steps could pass that
  // point.  (The wrappers size rows for the whole stream.)
  int64_t extra = 0;
  bool cut = false;
  for (int64_t w = 0; 32 * w < n; ++w) {
    SymOps next;
    pack(w + 1, a1, next);  // each stage uses loads a window old
    a1 = a2;
    load_pair(a1);
    a2 = a3;
    load_meta(a2);
    load_symbols(w + 4, a3);
    const int64_t left = n - 32 * w;
    const uint32_t op_a = __shfl_sync(kFullMask, cur.op, 0);
    if (left >= 32 && cur.esc == 0u) {
      scan_window32(e, cur.op, op_a, o);
    } else {
      if (kMode == kGamma && cur.esc != 0u) {
        extra += __reduce_add_sync(
            kFullMask, (cur.esc >> lane) & 1u ? 2u * (31u - __clz(cur.g)) + 2u
                                              : 0u);
        if (2 * (n + extra) + 2 > out_size) {
          cut = true;
          break;
        }
      }
      e = symbol_window(e, cur.op, op_a, cur.g, cur.esc, cur.neg,
                        left < 32 ? static_cast<int>(left) : 32, o);
    }
    cur = next;
  }
  scan_finish(e, o, out_size, lengths + s);
  // A cut stream reports a length past its row, as the thread kernel's
  // does.
  if (cut && lane == 0) lengths[s] = static_cast<int32_t>(out_size + 1);
}

// ---------------------------------------------------------------------------
// K4', one thread per stream on the 32-bit chain.
// ---------------------------------------------------------------------------
// Streams (threads) a block.  Measured on an NVIDIA H100 80GB HBM3 (700 W)
// by tools/single_row_sweep.py --geometry, from a CUDA graph, at 32768 x 512
// on the zipf row at precision 12, 32 / 64 / 128 / 256 threads, ms: 0.1002
// / 0.1000 / 0.1004 / 0.1014 (and 0.0993 / 0.0991 / 0.1000 / 0.1023 in a
// second build of the source).
constexpr int kEncodeRowThreads = 64;
// Each thread's output bytes gather in a ring of its own in shared memory
// and leave it a 16-byte block at a time.
constexpr int kOutRing = 64;
// Symbols a window: loaded one window ahead, as four 16-byte loads.
constexpr int kRowWindow = 16;
// Symbols between two flushes of the ring: at most 4 bytes each, so that
// fewer than 16 + 4 * 8 bytes are ever held.
constexpr int kFlushEvery = 8;

// The packed operands of a valid interval, as scan_step takes them.
__device__ __forceinline__ uint32_t row_op(uint32_t lo, uint32_t hi,
                                           int prec) {
  const uint32_t sh = 16u - static_cast<uint32_t>(prec);
  return ((lo << sh) & 0xFFFFu) | (((hi << sh) - 1u) << 16);
}

// A thread's output row seen through its ring.  Positions count from
// ``blocks``, the row's start rounded down to 16 bytes; a row at an odd
// address is handled as if it began a byte earlier (its memory lies one
// byte past its positions), so that chunks land on even positions.
struct RowOut {
  uint8_t* ring;
  uint8_t* blocks;
  int head;  // the row's first position (0 ... 15)
  int end;   // one past its last
  bool odd;
};

// The encoder state (ScanState's, one thread): ``w`` the next position to
// write, ``fl`` the first not yet stored (a multiple of 16).
struct RowState {
  uint32_t base, sm1, pend, fill;
  int w, fl;
};

// The bytes [lo, hi) of the 16 at position p: a row's first and last block,
// and every block of a row at an odd address.
__device__ __noinline__ void store_part(const RowOut o, int p, uint4 v, int lo,
                                        int hi) {
  const uint32_t word[4] = {v.x, v.y, v.z, v.w};
  uint8_t* dst = o.blocks + p + (o.odd ? 1 : 0);
  for (int i = lo; i < hi; ++i)
    dst[i] = static_cast<uint8_t>(word[i >> 2] >> (8 * (i & 3)));
}

// Stores block p (its bytes as the ring holds them).
__device__ __forceinline__ void store_block(const RowOut& o, int p) {
  const uint4 v = *reinterpret_cast<const uint4*>(o.ring + (p & (kOutRing - 1)));
  if (__builtin_expect(!o.odd && p >= o.head && p + 16 <= o.end, 1)) {
    *reinterpret_cast<uint4*>(o.blocks + p) = v;
  } else {
    store_part(o, p, v, max(o.head - p, 0), min(o.end - p, 16));
  }
}

// Chunk ``sw`` (its two bytes already swapped into memory order) where
// ``on`` holds.
__device__ __forceinline__ void row_emit(RowState& e, const RowOut& o,
                                         uint32_t sw, bool on) {
  if (on) {
    *reinterpret_cast<uint16_t*>(o.ring + (e.w & (kOutRing - 1))) =
        static_cast<uint16_t>(sw);
    e.w += 2;
  }
}

// Stores the complete blocks of a period: at most two.
__device__ __forceinline__ void row_flush(RowState& e, const RowOut& o) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (e.fl + 16 <= e.w) {
      store_block(o, e.fl);
      e.fl += 16;
    }
  }
}

// The deferred fill run, e.fill chunks of ``v``, flushed as it goes.
__device__ __noinline__ RowState row_fill_run(RowState e, uint32_t v,
                                              RowOut o) {
  while (e.fill != 0) {
    row_emit(e, o, v, true);
    --e.fill;
    if (e.fl + 16 <= e.w) {
      store_block(o, e.fl);
      e.fl += 16;
    }
  }
  return e;
}

// scan_step on one thread: RangeEncoder::Encode of a valid interval, its
// packed operands ``op``, on the 32-bit chain; the delayed carry by selects.
__device__ __forceinline__ void row_step(RowState& e, uint32_t op,
                                         const RowOut& o) {
  const uint32_t lo = op & 0xFFFFu;
  const uint32_t hi = (op >> 16) + 1u;
  const uint32_t a =
      static_cast<uint32_t>((static_cast<uint64_t>(e.sm1) * lo + lo) >> 16);
  const uint32_t b =
      static_cast<uint32_t>((static_cast<uint64_t>(e.sm1) * hi + hi) >> 16);
  const uint32_t nb = e.base + a;
  const uint32_t ns = b - 1u - a;
  const bool renorm = ns < 0x10000u;
  const uint32_t sb = renorm ? nb << 16 : nb;
  const uint32_t ss = renorm ? (ns << 16) | 0xFFFFu : ns;
  const bool in_delay = e.pend != 0;
  const bool straddle = in_delay && (nb + ns < nb);
  const bool resolved = in_delay && !straddle;
  const bool up = nb < a;
  row_emit(e, o, __byte_perm(up ? e.pend : e.pend - 1u, 0u, 0x0001),
           resolved);
  if (__builtin_expect(resolved && e.fill != 0, 0))
    e = row_fill_run(e, up ? 0u : 0xFFFFu, o);
  const uint32_t top = nb >> 16;
  const bool amb = renorm && !straddle && (sb + ss < sb);
  row_emit(e, o, __byte_perm(nb, 0u, 0x0023), renorm && !straddle && !amb);
  e.fill += (straddle && renorm) ? 1u : 0u;
  e.pend = straddle ? e.pend : (amb ? top + 1u : 0u);
  e.base = sb;
  e.sm1 = ss;
}

// RangeEncoder::Finalize, the ring's last bytes, the zeros to the row's end
// and the length.
__device__ __noinline__ void row_finish(RowState e, RowOut o,
                                        int32_t* length) {
  while (e.fl + 16 <= e.w) {
    store_block(o, e.fl);
    e.fl += 16;
  }
  uint32_t b0 = 0, b1 = 0;
  int nbytes = 0;
  if (e.pend != 0) {
    b0 = (e.pend >> 8) & 0xFFu;
    b1 = e.pend & 0xFFu;
    nbytes = b1 ? 2 : 1;
  } else if (e.base != 0) {
    const uint32_t upper = e.base + e.sm1;
    const uint32_t mid24 = ((e.base - 1u) >> 24) + 1u;
    if (mid24 <= (upper >> 24)) {
      b0 = mid24 & 0xFFu;
      nbytes = 1;
    } else {
      const uint32_t mid16 = ((e.base - 1u) >> 16) + 1u;
      b0 = (mid16 >> 8) & 0xFFu;
      b1 = mid16 & 0xFFu;
      nbytes = b1 ? 2 : 1;
    }
  }
  *length = e.w - o.head + nbytes;
  // The finalize bytes and zeros up to the block's end, in the ring.
  const int stop = (e.w + 15) & ~15;
  for (int p = e.w; p < stop; ++p) {
    const int k = p - e.w;
    o.ring[p & (kOutRing - 1)] =
        static_cast<uint8_t>(k < nbytes ? (k == 0 ? b0 : b1) : 0u);
  }
  if (nbytes > 0 && e.w == stop) {
    // The data ends on a block's end: the finalize bytes open a new one.
    for (int k = 0; k < 16; ++k)
      o.ring[(stop + k) & (kOutRing - 1)] =
          static_cast<uint8_t>(k < nbytes ? (k == 0 ? b0 : b1) : 0u);
  }
  const int last = e.w + nbytes;  // one past the data
  for (; e.fl < last && e.fl < o.end; e.fl += 16) store_block(o, e.fl);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int p = e.fl; p < o.end; p += 16) {
    if (!o.odd && p + 16 <= o.end)
      *reinterpret_cast<uint4*>(o.blocks + p) = zero;
    else
      store_part(o, p, zero, 0, min(o.end - p, 16));
  }
}

__device__ __forceinline__ int32_t lane_of(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// K4': encode_stream<kSingleRow>'s function.  The packed operands of every
// symbol's interval are staged in shared memory after the rings (kShared)
// or made from the row in global memory; a row with an interval the
// 32-bit chain does not serve (empty, or past 2^prec: a symbol of
// probability zero) takes the reference recurrence for the whole block.
template <bool kShared>
__global__ void __launch_bounds__(kEncodeRowThreads)
encode_single_row_kernel(const int32_t* __restrict__ symbols,
                         int64_t num_streams, int64_t num_elements,
                         const int32_t* __restrict__ cdf,
                         const int32_t* __restrict__ meta, int max_len,
                         uint8_t* __restrict__ out, int64_t out_size,
                         int32_t* __restrict__ lengths) {
  extern __shared__ __align__(16) uint8_t row_smem[];
  uint32_t* pairs =
      reinterpret_cast<uint32_t*>(row_smem + kEncodeRowThreads * kOutRing);
  const int prec = meta[1];
  const int maxs = meta[0];
  bool bad = prec < 1 || prec > 16 || maxs < 0 || maxs > max_len - 2;
  if (!bad) {
    for (int v = threadIdx.x; v < max_len - 1; v += kEncodeRowThreads) {
      const int32_t lo = cdf[v], hi = cdf[v + 1];
      bad |= !(0 <= lo && lo < hi && hi <= (1 << prec));
      if (kShared)
        pairs[v] = row_op(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi),
                          prec);
    }
  }
  const bool gaps = __syncthreads_or(bad) != 0;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kEncodeRowThreads + threadIdx.x;
  if (s >= num_streams) return;
  if (gaps) {
    encode_stream<kSingleRow>(s, symbols, nullptr, num_elements, cdf, meta, 1,
                              max_len, out, out_size, lengths);
    return;
  }

  uint8_t* row = out + s * out_size;
  RowOut o;
  o.odd = (reinterpret_cast<uintptr_t>(row) & 1) != 0;
  const uintptr_t start = reinterpret_cast<uintptr_t>(row) - (o.odd ? 1 : 0);
  o.blocks = reinterpret_cast<uint8_t*>(start & ~static_cast<uintptr_t>(15));
  o.head = static_cast<int>(start & 15);
  o.end = o.head + static_cast<int>(out_size);
  o.ring = row_smem + threadIdx.x * kOutRing;
  RowState e = {0u, 0xFFFFFFFFu, 0u, 0u, o.head, 0};

  const int64_t n = num_elements;
  const int32_t* vrow = symbols + s * n;
  const bool vec = (reinterpret_cast<uintptr_t>(vrow) & 15) == 0;
  auto op_of = [&](int32_t x) -> uint32_t {
    const int v = min(max(x, 0), maxs);
    if (kShared) return pairs[v];
    return row_op(static_cast<uint32_t>(cdf[v]),
                  static_cast<uint32_t>(cdf[v + 1]), prec);
  };
  auto load = [&](int64_t j, int4 (&w)[4]) {
    if (vec && j + kRowWindow <= n) {
      const int4* p = reinterpret_cast<const int4*>(vrow + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = p[q];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t k = j + 4 * q;
        w[q] = make_int4(k < n ? vrow[k] : 0, k + 1 < n ? vrow[k + 1] : 0,
                         k + 2 < n ? vrow[k + 2] : 0,
                         k + 3 < n ? vrow[k + 3] : 0);
      }
    }
  };
  auto code = [&](const int4 (&w)[4]) {
    uint32_t ops[kRowWindow];
#pragma unroll
    for (int i = 0; i < kRowWindow; ++i) ops[i] = op_of(lane_of(w[i / 4], i % 4));
#pragma unroll
    for (int i = 0; i < kRowWindow; ++i) {
      row_step(e, ops[i], o);
      if (i % kFlushEvery == kFlushEvery - 1) row_flush(e, o);
    }
  };

  int4 wa[4], wb[4];
  load(0, wa);
  int64_t j = 0;
  for (; j + 2 * kRowWindow <= n; j += 2 * kRowWindow) {
    load(j + kRowWindow, wb);
    code(wa);
    load(j + 2 * kRowWindow, wa);
    code(wb);
  }
  for (; j < n; ++j) {
    row_step(e, op_of(vrow[j]), o);
    if (j % kFlushEvery == kFlushEvery - 1) row_flush(e, o);
  }
  row_finish(e, o, lengths + s);
}

template <int kMode, bool kWarp>
int launch(const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
           int64_t num_elements, const int32_t* cdf, const int32_t* meta,
           int num_rows, int max_len, uint8_t* out, int64_t out_size,
           int32_t* lengths, void* stream) {
  const size_t table_bytes =
      sizeof(int32_t) * (static_cast<size_t>(num_rows) * max_len +
                         static_cast<size_t>(kMetaCols) * num_rows);
  const bool use_shared = table_bytes <= 200 * 1024;
  const size_t smem = use_shared ? table_bytes : 0;
  decltype(&encode_kernel<kMode>) kernel;
  if constexpr (kWarp) {
    kernel = encode_symbols_warp_kernel<kMode>;
  } else {
    kernel = encode_kernel<kMode>;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // A warp per stream, kScanWarps streams a block; or a thread per stream,
  // in 32-thread blocks while that spreads the launch over more SMs.
  const int per_block =
      kWarp ? kScanWarps : (num_streams >= 128 * 132 ? 128 : 32);
  const int threads = kWarp ? 32 * kScanWarps : per_block;
  const int64_t blocks = (num_streams + per_block - 1) / per_block;
  if (blocks > 0) {
    kernel<<<static_cast<unsigned>(blocks), threads, smem,
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
  return launch<kIndexed, false>(symbols, indexes, num_streams, num_elements,
                                 cdf, meta, num_rows, max_len, out, out_size,
                                 lengths, stream);
}

// As ctpu_encode_indexed, one warp per stream; row precision 1 ... 16.
extern "C" int ctpu_encode_indexed_warp(
    const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* cdf, const int32_t* meta,
    int num_rows, int max_len, uint8_t* out, int64_t out_size,
    int32_t* lengths, void* stream) {
  return launch<kIndexed, true>(symbols, indexes, num_streams, num_elements,
                                cdf, meta, num_rows, max_len, out, out_size,
                                lengths, stream);
}


extern "C" int ctpu_encode_gamma(
    const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* cdf, const int32_t* meta,
    int num_rows, int max_len, uint8_t* out, int64_t out_size,
    int32_t* lengths, void* stream) {
  return launch<kGamma, false>(symbols, indexes, num_streams, num_elements,
                               cdf, meta, num_rows, max_len, out, out_size,
                               lengths, stream);
}

// As ctpu_encode_gamma, one warp per stream; row precision 1 ... 16.
extern "C" int ctpu_encode_gamma_warp(
    const int32_t* symbols, const int32_t* indexes, int64_t num_streams,
    int64_t num_elements, const int32_t* cdf, const int32_t* meta,
    int num_rows, int max_len, uint8_t* out, int64_t out_size,
    int32_t* lengths, void* stream) {
  return launch<kGamma, true>(symbols, indexes, num_streams, num_elements,
                              cdf, meta, num_rows, max_len, out, out_size,
                              lengths, stream);
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

// As ctpu_encode_scan, one warp per stream; every coded step's interval
// must be valid (0 <= lower < upper <= 2^prec, 1 <= prec <= 16).
extern "C" int ctpu_encode_scan_warp(
    const uint32_t* lower, const uint32_t* upper, const uint32_t* prec,
    const uint8_t* mask, int64_t num_steps, int64_t num_streams, uint8_t* out,
    int64_t out_size, int32_t* lengths, void* stream) {
  const int64_t blocks = (num_streams + kScanWarps - 1) / kScanWarps;
  if (blocks > 0) {
    encode_scan_warp_kernel<<<static_cast<unsigned>(blocks), 32 * kScanWarps,
                              0, static_cast<cudaStream_t>(stream)>>>(
        lower, upper, prec, mask, num_steps, num_streams, out, out_size,
        lengths);
  }
  return static_cast<int>(cudaGetLastError());
}

// cdf / meta hold the one row: int32 [1, max_len] and [1, 3].
extern "C" int ctpu_encode_single_row(
    const int32_t* symbols, int64_t num_streams, int64_t num_elements,
    const int32_t* cdf, const int32_t* meta, int max_len, uint8_t* out,
    int64_t out_size, int32_t* lengths, void* stream) {
  const size_t rings = static_cast<size_t>(kEncodeRowThreads) * kOutRing;
  const size_t pairs = 4 * static_cast<size_t>(max_len - 1);
  const bool shared = rings + pairs <= 227 * 1024;
  const size_t smem = rings + (shared ? pairs : 0);
  const int64_t blocks =
      (num_streams + kEncodeRowThreads - 1) / kEncodeRowThreads;
  if (max_len < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), kEncodeRowThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        symbols, num_streams, num_elements, cdf, meta, max_len, out,
        out_size, lengths);
    return static_cast<int>(cudaGetLastError());
  };
  return shared ? run(encode_single_row_kernel<true>)
                : run(encode_single_row_kernel<false>);
}
