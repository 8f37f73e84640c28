// Range decode: six kernels over the RangeDecoder recurrence.  Four run one
// thread per coder stream (K2 and K3' from one template, K5' over a slot
// table, K8' with the bucketed symbol search); two run one warp per stream
// (one template) and serve the indexed and the in-stream-gamma decode when
// a launch holds few streams.
//
//   ctpu_decode_indexed      (K2, thread per stream) and
//   ctpu_decode_indexed_warp (K2, warp per stream) replace
//       compression_tpu/codec/pallas_coder.py:
//       decode_indexed_pallas(in_stream_gamma=False) -> _decode_indexed_call
//       (_make_decode_kernel_indexed with any_overflow=False).  Each element
//       s,t is decoded with CDF row indexes[s,t]; an escape comes back as
//       the marker len-2 with no Elias-gamma bits consumed (the values
//       travel in the native container's sidecar).  Both kernels compute
//       the same function; the wrapper picks one from the number of streams
//       in the launch.
//   ctpu_decode_single_row  (K5') replaces pallas_coder.py:
//       decode_scan_pallas_v2 -> _decode_v2_call.  One shared CDF row, no
//       indexes, no overflow; the row comes as a slot table
//       (cuda_coder.single_row_slots, see below).
//   ctpu_decode_gamma       (K3', thread per stream) and
//   ctpu_decode_gamma_warp  (K3', warp per stream) replace pallas_coder.py:
//       decode_indexed_pallas(in_stream_gamma=True): the reference .tfci
//       format.  As K2, but the marker on an overflow row is followed by the
//       Elias-gamma magnitude and the sign (OverflowDecode), each bit decoded
//       with the binary uniform CDF at precision 1: zeros are counted while
//       n < 31 (what keeps a corrupt stream from looping), then n bits, then
//       the sign; the value is sign ? -g : g + (len-2) - 1 in int32.  Both
//       kernels compute the same function; the wrapper picks one from the
//       number of streams in the launch.
//
//   ctpu_decode_single_row_bucketed (K8') replaces pallas_coder.py:
//       decode_scan_pallas (v1, kernel body _make_decode_kernel): one shared
//       CDF row, no overflow, symbol found by the two-level search of
//       pallas_coder.py:246-278 -- the threshold t = ceil(lower_bound /
//       size), the count of bucket-last values below t, then the count of
//       entries below t in that bucket's 17-entry window
//       (jax_coder._bucketize_row: the last entry of the bucket before, then
//       the bucket's 16 entries).  The interval is [largest window entry
//       below, smallest one not below (at most 2^16)), the symbol min(16 *
//       full buckets + entries below in the window but its first, max_len -
//       1) - 1, and the sanity flag that of pallas_coder.py:301-313 (the
//       same check as the other kernels').  It is the second, independent
//       single-row decoder that K5' is held against: its search reads the
//       v1 kernel's buckets and windows, never K5''s slot table.
//
// The thread template's two, K5' and the warp kernels compute the same
// function as the XLA scan the TPU kernels are held to, jax_coder.decode_core
// (jax_coder.py:779-914), also on corrupt input.  Bytes past the stream end
// read as zero (Read16BitValue); the sanity flag is RangeDecoder::Finalize's
// check and 2 * chunks_read >= byte_len (jax_coder.py:901-913).
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
// What bounds them on this card: a serial chain per stream.  Every symbol's
// interval depends on the state the symbol before left, so a stream takes N
// steps of latency whatever else the card does, and bytes moved (~2 B in,
// 8 B in/out per symbol) are far below the memory rate.
//
// Thread per stream (many streams): the chain of one step is a binary search
// of ~log2(max_len) dependent 64-bit multiply-compares, each behind a table
// load, then the interval update; the card fills only with many thousands of
// streams.  Decoder state (base, size-1, value, read position) lives in
// registers, each thread reads its own stream's bytes, and the table and row
// metadata sit in shared memory (read through L1 from global when they do
// not fit), so the search probes never leave the SM.  Small launches use
// 32-thread blocks to spread streams over more SMs.
//
// K5', the single-row decode of the coder's micro-bench (32768 streams of
// 512 symbols, where a warp per stream loses to a thread per stream: K3''s
// sweep, 2.05 against 0.86 ms), keeps one thread per stream and takes
// everything but the recurrence off its chain:
//   - The search is one load.  The row is the only one, so its counts are
//     laid out once per table by threshold: count = #{k : size * cdf[k] <
//     lower_bound} = #{k : cdf[k] < t}, t = ceil(lower_bound / size), since
//     the entries are integers; slot t for t in [0, 2^prec + 1] holds it
//     (past 2^prec, a corrupt stream, t is capped: every entry is below).
//     t comes from an f32 quotient, within 0.03 of the exact one, set right
//     by two exact 64-bit products.  Up to precision 14 a slot holds the
//     symbol and both ends of its interval (8 bytes; 32 KB at precision
//     12), above it a 16-bit count, and the pair is a second load from the
//     row (128 KB of slots at 16).  The table is staged in shared memory
//     once a block.
//   - The stream's bytes come through a 64-byte ring a thread in shared
//     memory, four 16-byte segments loaded by cp.async (zero-filled past
//     the stream's end) from the row's 16-byte aligned start, one period of
//     8 symbols ahead of their use; a row at an odd address is read byte by
//     byte.  The next chunk is always in a register, loaded from the ring a
//     symbol ahead.  chunks_read, which the sanity flag takes, counts
//     chunks consumed, not loaded.
//   - Symbols leave 8 at a time as two 16-byte stores.
//   - Measured on an H100 (PERF.md): 0.084 ms at 32768 x 512 against
//     0.467 for the binary search's kernel, ahead of it at every stream
//     count from 1 to 65536; the chain's floor is 0.030 ms.
//
// K8' runs at the same 32768 x 512 as K5' and shares its frame: one thread
// per stream, 256 a block, the stream's bytes through K5''s cp.async ring
// (RowReader) with the next chunk a symbol ahead in a register, K5''s
// threshold (one f32 quotient set right by two exact products, capped at
// 2^prec + 1), symbols stored 8 at a time as two 16-byte stores.  After
// the threshold every test is c < t in 32 bits:
//   - The bucket count.  bucket_last is staged in shared memory once a
//     block, padded with a value no threshold exceeds.  Rows of at most
//     kLinearMaxBuckets buckets (the zipf row has 17) hold it in registers
//     and count it by an unrolled compare-and-add in four partial sums: no
//     load and no branch on the chain.  Longer rows binary-search it in
//     shared memory (log2 of the padded count of dependent loads).
//   - The window.  Each bucket's window is staged as a row of 20 int32: 0,
//     its 17 entries, 65536 twice.  The window is non-decreasing, so the
//     entries below t are a prefix of it: f of them are counted from five
//     16-byte loads, and the interval is (row[f], row[f + 1]), two loads,
//     with no max or min over the window.
// The bucketed search has more work a symbol than K5''s one load: 136
// instructions against 50 in the compiled kernels, and 37 register
// operations and two shared loads on the chain against 21 and one.
// Measured on an H100 (PERF.md): 0.168 ms at 32768 x 512 on the zipf row
// (0.536 for the kernel before, bucket tests as 64-bit products over
// bytes read from global memory); the chain's floor is 0.050 ms.
//
// Warp per stream (down to the one stream of a classic .tfci container, and
// the few hundred of a native container's launch): with one thread per
// stream a single lane of the card would run, so the 32 lanes of a warp
// shorten the chain of one step instead.  K2 and K3' are one template over
// the escape: K2's step returns the count, the marker included, where K3''s
// goes on to decode_escape.  One warp alone on
// its scheduler has nothing to hide a stall behind, and it runs its code in
// program order: what decides its time is the chain's length, every
// operation that waits for a load in front of the chain, every jump, and the
// plain number of operations (each takes the 16-lane pipe two cycles).
//   - All lanes carry the decoder state redundantly in registers; nothing is
//     broadcast, and every branch is uniform across the warp.  The state is
//     the offset value - base, size - 1 and base: the search and the update
//     need only the offset; value is put together for the final check.
//   - The search is one round of independent probes: the contract is a
//     count, so lane l tests entries 1 + l + 32 r and the count is the sum
//     of __popc(__ballot_sync(...)) over r.  Rows of up to 129 entries take
//     four multiply-shift-compares a lane and no dependent load; longer rows
//     take two levels, every 32nd entry first and then the 32 entries of the
//     bucket found: three ballots instead of eleven dependent loads.
//   - The table comes in a 16-bit layout (cuda_coder.warp_table) that fits
//     shared memory where the int32 one does not (bmshj2018's 64 x 1481
//     table: 379 KB as int32, 196 KB here): a record per row of 16 bytes of
//     metadata fetched by one load, the every-32nd entries (dense, so that
//     the lanes' loads do not collide on two banks) and the row padded to
//     the probes' reach.  65536, the terminal value of a precision-16 row,
//     does not fit 16 bits, and no entry needs it: see RowLoads.  A layout
//     too large for shared memory is read from global memory.
//   - A symbol's record offset is fetched from its lane two symbols ahead
//     and its loads are started one symbol ahead, into registers that are
//     not touched before its turn (two sets that swap roles, the loop
//     unrolled by two).  The next 16-bit chunk of the stream is always in a
//     register.  The stream's bytes come through a 1 KB ring per warp that
//     is filled with 16-byte loads a lane one 512-byte window ahead (bytes
//     at or past min(byte_len, width) are stored as zero; an edge window,
//     and every window of a stream that starts at an odd address, is read
//     byte by byte); a window of 32 symbols reserves its bytes once, so a
//     symbol's path has no refill branch.  Lane j % 32 keeps symbol j until
//     the warp stores 32 of them as 128 bytes.  Escapes are decoded by a
//     function of its own, outside the other symbols' path.
//   - A block holds a few warps, each with its own stream and ring, and
//     stages the table once for all of them with four 16-byte loads in
//     flight a thread.  K3' launches eight warps a block; K2, whose launches
//     hold a few hundred streams, four (kIndexedWarpsPerBlock): fewer warps
//     a block spread the streams over more SMs, one warp to a scheduler,
//     but each block stages the table again, and a block of bmshj2018's y
//     table (196 KB) fills an SM alone.
//   - Measured on an H100 (PERF.md): K3' 3.6-6x the thread kernel on one
//     long stream; K2 6-8x at the native containers' 32-512 streams
//     (0.058 against 0.408 ms at 256 x 512, 2.7x its chain's floor); both
//     ahead of the thread kernel up to 16384 streams, where its ~20x less
//     work a symbol begins to count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC decode_indexed.cu -o decode_indexed.so

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kU16 = 0xFFFFu;
constexpr int kMetaCols = 3;  // per row: escape marker len-2, precision, overflow

enum Mode { kIndexed = 0, kGamma = 2 };

// RangeDecoder::Finalize check plus "stream fully consumed".
__device__ inline bool stream_sane(uint32_t base, uint32_t sm1, uint32_t value,
                                   int64_t chunks_read, int64_t src_len) {
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

  __device__ bool sane(int64_t src_len) const {
    return stream_sane(base, sm1, value, chunks_read, src_len);
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

  const int32_t* irow = indexes + s * num_elements;
  int32_t* orow = symbols + s * num_elements;
  for (int64_t j = 0; j < num_elements; ++j) {
    int row = irow[j];
    row = row < 0 ? 0 : (row >= num_rows ? num_rows - 1 : row);
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

// ---------------------------------------------------------------------------
// K5', one thread per stream over a slot table.
// ---------------------------------------------------------------------------
// Streams (threads) a block.  Measured on an NVIDIA H100 80GB HBM3 (700 W)
// by tools/single_row_sweep.py --geometry, from a CUDA graph, at 32768 x 512
// on the zipf row at precision 12, 32 / 64 / 128 / 256 threads, ms: 0.1448 /
// 0.0864 / 0.0850 / 0.0834.  Every size puts at most eight warps on an SM,
// but each block stages the table (32 KB here), and 32-thread blocks of
// 34 KB each do not fit eight to an SM.
constexpr int kSingleRowThreads = 256;
// Each thread's stream bytes pass through a ring of its own in shared
// memory, four 16-byte segments.
constexpr int kSingleRowRing = 64;
// Symbols decoded between two looks at the ring, stored together.
constexpr int kSingleRowPeriod = 8;
// Up to this precision a slot holds the symbol and both ends of its
// interval (8 bytes); above it, the count alone (2 bytes).
constexpr int kWideMaxPrecision = 14;

// cuda_coder.single_row_slots' layout in int32 units, a multiple of four:
// 2^prec + 2 slots, as (symbol, c_lo | (c_hi - 1) << 16) up to
// kWideMaxPrecision, else as uint16 counts followed by the row and 65536.
inline int64_t slot_units(int prec, int max_len) {
  const int64_t slots = (int64_t{1} << prec) + 2;
  const int64_t units =
      prec <= kWideMaxPrecision ? 2 * slots : slots / 2 + max_len + 1;
  return (units + 3) / 4 * 4;
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem,
                                             int src_bytes) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One stream's bytes through its ring: segment m holds the bytes at
// [16 m, 16 m + 16) from ``seg0``, stream byte j at seg0 + shift + j.  An
// even row is read from its 16-byte aligned start by cp.async (zero-filled
// past the stream's end), an odd row byte by byte from the row itself
// (shift 0), so that a chunk never straddles two 16-bit units of the ring.
struct RowReader {
  const uint8_t* seg0;
  int64_t avail;  // readable bytes: min(byte_len, buffer width)
  int shift;
  bool odd;
  uint8_t* ring;
  int segs;       // segments started; the ring holds [segs - 4, segs)

  __device__ void fill() {
    uint8_t* dst = ring + ((16 * segs) & (kSingleRowRing - 1));
    const int64_t first = int64_t{16} * segs - shift;  // its first byte's j
    const int64_t left = avail - first;
    if (!odd) {
      const int n = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
      copy16_async(dst, n > 0 ? seg0 + 16 * static_cast<int64_t>(segs) : seg0,
                   n);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
      for (int i = 0; i < 16; ++i)
        if (i < left) w[i >> 2] |= static_cast<uint32_t>(seg0[first + i])
                                   << (8 * (i & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    ++segs;
  }

  // The chunk at byte ``pos`` of the ring (shift + 2 k for chunk k), as it
  // lies in memory: its high byte first.
  __device__ uint32_t raw(uint32_t pos) const {
    return *reinterpret_cast<const uint16_t*>(ring +
                                              (pos & (kSingleRowRing - 1)));
  }

  // Before a period of kSingleRowPeriod symbols, ``pos`` the next chunk's
  // ring byte: starts the next segment where the oldest is consumed (at
  // most 48 bytes ahead), then waits for all but that one.  Every period
  // consumes at most 2 kSingleRowPeriod bytes, so at each look 34 or more
  // bytes lie ahead and the 18 a period reads have landed.
  __device__ void top_up(uint32_t pos) {
    if (16 * segs - static_cast<int>(pos) <= 3 * kSingleRowRing / 4) fill();
    copy_async_commit();
    copy_async_wait<1>();
  }
};

// The decoder state: size - 1, the offset value - base of the reference
// decoder (what the search and the update need), value itself (for the
// sanity check at the end), and the ring byte of the next chunk with that
// chunk loaded ahead.
struct SlotDecoder {
  uint32_t sm1;
  uint32_t offset;
  uint32_t value;
  uint32_t pos;
  uint32_t next;
};

// t = ceil((offset + 1) 2^prec / size), capped at tmax = 2^prec + 1 (every
// entry of a row is below it), from an f32 quotient (within 0.03 of the
// exact one) set right by two exact products.  The quotient takes the
// reciprocal's approximation as it is (rcp.approx.ftz, 1 ulp): the size is
// at least 2^16, so __fdividef's test and scaling for a tiny divisor, two
// operations on the chain, are not needed (measured on an NVIDIA H100
// 80GB HBM3, 700 W, by tools/bucketed_decode_probe.py at 32768 x 512 on
// the zipf row: K5' 0.0835 -> 0.0790 ms, K8' 0.1695 -> 0.1674).  Shared by
// K5' and K8'.
__device__ __forceinline__ uint32_t threshold(const SlotDecoder& d, int prec,
                                              float scale, uint32_t tmax) {
  const float fo = __uint2float_rn(d.offset) + 1.0f;
  const float fs = __uint2float_rn(d.sm1) + 1.0f;
  float rcp;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(fs));
  const float q = fminf(fo * scale * rcp, scale + 2.0f);
  const uint32_t t0 = __float2uint_ru(q);
  const uint64_t lb = (static_cast<uint64_t>(d.offset) + 1) << prec;
  const bool up = static_cast<uint64_t>(d.sm1) * t0 + t0 < lb;
  const bool down =
      static_cast<uint64_t>(d.sm1) * (t0 - 1u) + (t0 - 1u) >= lb;
  return min(t0 + (up ? 1u : 0u) - (down ? 1u : 0u), tmax);
}

// Narrows the state to the interval [c_lo, c_hi) of the row (scaled by
// size / 2^prec), renormalizes with the chunk held in ``next`` and loads
// the next one from the ring.  Shared by K5' and K8'.
__device__ __forceinline__ void narrow(SlotDecoder& d, const RowReader& rd,
                                       uint32_t c_lo, uint32_t c_hi,
                                       int prec) {
  const uint32_t a = static_cast<uint32_t>(
      (static_cast<uint64_t>(d.sm1) * c_lo + c_lo) >> prec);
  const uint32_t b = static_cast<uint32_t>(
      (static_cast<uint64_t>(d.sm1) * c_hi + c_hi) >> prec) - 1u;
  const uint32_t ns = b - a;
  const bool renorm = (ns >> 16) == 0;
  const uint32_t left = d.offset - a;
  d.offset = renorm ? __byte_perm(left, d.next, 0x1045) : left;
  d.value = renorm ? __byte_perm(d.value, d.next, 0x1045) : d.value;
  d.sm1 = renorm ? (ns << 16) | kU16 : ns;
  d.pos += renorm ? 2u : 0u;
  d.next = rd.raw(d.pos);
}

// Opens the stream at ``src`` (``avail`` readable bytes) on the ring at
// ``ring``: fills the ring, waits for it, and reads the first two chunks
// into the state, the third into ``next``.
__device__ __forceinline__ SlotDecoder open_stream(RowReader& rd,
                                                   const uint8_t* src,
                                                   int64_t avail,
                                                   uint8_t* ring) {
  rd.avail = avail;
  rd.odd = (reinterpret_cast<uintptr_t>(src) & 1) != 0;
  rd.shift = rd.odd ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  rd.seg0 = src - rd.shift;
  rd.ring = ring;
  rd.segs = 0;
  for (int k = 0; k < kSingleRowRing / 16; ++k) rd.fill();
  copy_async_commit();
  copy_async_wait<0>();
  SlotDecoder d;
  d.sm1 = 0xFFFFFFFFu;
  d.pos = static_cast<uint32_t>(rd.shift);
  d.offset = __byte_perm(__byte_perm(0u, rd.raw(d.pos), 0x1045),
                         rd.raw(d.pos + 2), 0x1045);
  d.value = d.offset;
  d.pos += 4;
  d.next = rd.raw(d.pos);
  return d;
}

// Decodes a row's n symbols, one ``symbol(d, rd)`` each: kSingleRowPeriod
// of them between two looks at the ring, stored together (two 16-byte
// stores where the row allows).  Returns the stream's sanity flag.  Shared
// by K5' and K8'.
template <class Symbol>
__device__ __forceinline__ uint8_t decode_row(SlotDecoder& d, RowReader& rd,
                                              int32_t* orow, int64_t n,
                                              int64_t src_len, Symbol symbol) {
  const bool vec = (reinterpret_cast<uintptr_t>(orow) & 15) == 0;
  int64_t j = 0;
  for (; j + kSingleRowPeriod <= n; j += kSingleRowPeriod) {
    rd.top_up(d.pos);
    int32_t out[kSingleRowPeriod];
#pragma unroll
    for (int i = 0; i < kSingleRowPeriod; ++i) out[i] = symbol(d, rd);
    if (vec) {
      int4* o4 = reinterpret_cast<int4*>(orow + j);
#pragma unroll
      for (int i = 0; i < kSingleRowPeriod / 4; ++i)
        o4[i] = make_int4(out[4 * i], out[4 * i + 1], out[4 * i + 2],
                          out[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kSingleRowPeriod; ++i) orow[j + i] = out[i];
    }
  }
  rd.top_up(d.pos);
  for (; j < n; ++j) orow[j] = symbol(d, rd);
  const int64_t chunks = (d.pos - static_cast<uint32_t>(rd.shift)) / 2;
  return stream_sane(d.value - d.offset, d.sm1, d.value, chunks, src_len)
             ? 1
             : 0;
}

// slot table: tab (int32 units, see slot_units).  One symbol: the threshold
// t, then one slot load (kWide) or a count and the row (two dependent
// loads).
template <bool kWide>
__device__ __forceinline__ int32_t slot_symbol(SlotDecoder& d,
                                               const RowReader& rd,
                                               const int32_t* tab, int prec,
                                               int max_len, float scale,
                                               uint32_t tmax) {
  const uint32_t t = threshold(d, prec, scale, tmax);
  uint32_t c_lo, c_hi;
  int32_t sym;
  if (kWide) {
    const uint2 sl = reinterpret_cast<const uint2*>(tab)[t];
    sym = static_cast<int32_t>(sl.x);
    c_lo = sl.y & kU16;
    c_hi = (sl.y >> 16) + 1u;
  } else {
    const uint32_t stored = reinterpret_cast<const uint16_t*>(tab)[t];
    const uint32_t count =
        t == tmax ? static_cast<uint32_t>(max_len - 1) : stored;
    const int32_t* row = tab + (tmax + 1) / 2;
    c_lo = static_cast<uint32_t>(row[count]);
    c_hi = static_cast<uint32_t>(row[count + 1]);
    sym = static_cast<int32_t>(min(count, static_cast<uint32_t>(max_len - 2)));
  }
  narrow(d, rd, c_lo, c_hi, prec);
  return sym;
}

// slots: the slot table, 16-byte aligned, slot_quads 16-byte units; staged
// in shared memory after the rings (kShared) or read from global memory.
template <bool kWide, bool kShared>
__global__ void __launch_bounds__(kSingleRowThreads)
decode_single_row_kernel(const uint8_t* __restrict__ buf, int64_t buf_width,
                         const int32_t* __restrict__ byte_lens,
                         int64_t num_streams, int64_t num_elements,
                         const int4* __restrict__ slots, int64_t slot_quads,
                         int prec, int max_len, int32_t* __restrict__ symbols,
                         uint8_t* __restrict__ sanity) {
  extern __shared__ int4 row_smem[];
  const int32_t* tab = reinterpret_cast<const int32_t*>(slots);
  if (kShared) {
    int4* dst = row_smem + kSingleRowThreads * kSingleRowRing / 16;
    int64_t i = threadIdx.x;
    constexpr int step = kSingleRowThreads;
    for (; i + 3 * step < slot_quads; i += 4 * step) {
      const int4 a = slots[i], b = slots[i + step];
      const int4 c = slots[i + 2 * step], e = slots[i + 3 * step];
      dst[i] = a;
      dst[i + step] = b;
      dst[i + 2 * step] = c;
      dst[i + 3 * step] = e;
    }
    for (; i < slot_quads; i += step) dst[i] = slots[i];
    __syncthreads();
    tab = reinterpret_cast<const int32_t*>(dst);
  }
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kSingleRowThreads + threadIdx.x;
  if (s >= num_streams) return;

  const int64_t src_len = byte_lens[s];
  RowReader rd;
  SlotDecoder d = open_stream(
      rd, buf + s * buf_width, src_len < buf_width ? src_len : buf_width,
      reinterpret_cast<uint8_t*>(row_smem) + threadIdx.x * kSingleRowRing);

  const float scale = static_cast<float>(1u << prec);
  const uint32_t tmax = (1u << prec) + 1u;
  sanity[s] = decode_row(
      d, rd, symbols + s * num_elements, num_elements, src_len,
      [&](SlotDecoder& dd, const RowReader& r) {
        return slot_symbol<kWide>(dd, r, tab, prec, max_len, scale, tmax);
      });
}

// ---------------------------------------------------------------------------
// K8', one thread per stream over the v1 kernel's buckets and windows.
// ---------------------------------------------------------------------------
// Streams (threads) a block: K5''s geometry, whose sweep found 256 best at
// 32768 x 512.
constexpr int kBucketedThreads = 256;
// Rows of at most this many buckets count the bucket-last values below the
// threshold from registers, longer ones binary-search them in shared
// memory.  Measured on an NVIDIA H100 80GB HBM3 (700 W) by
// tools/bucketed_decode_probe.py --variants, from a CUDA graph, at 32768 x
// 512, registers / binary search, ms: the zipf row (17 buckets) 0.1684 /
// 0.2293, a row of 1021 entries at precision 16 (64 buckets) 0.2371 /
// 0.2663.  Each bucket costs two instructions a symbol, each search step
// a dependent shared load.
constexpr int kLinearMaxBuckets = 64;
// A window in shared memory: 0, the bucket's 17 entries, then 65536 twice
// (80 bytes, 16-byte aligned).
constexpr int kWindowStride = 20;
// Padding of the bucket-last values, above every threshold (at most 65537).
constexpr uint32_t kNeverBelow = 0x7FFFFFFFu;

// 1 where c < t, else 0, for c and t below 2^31: the borrow of c - t.
__device__ __forceinline__ uint32_t below(uint32_t c, uint32_t t) {
  return (c - t) >> 31;
}

// a + b where it is written: the compiler would otherwise fold the
// partial sums of a count into one chain of dependent adds (17 long for the
// window, measured in the SASS), which lies on the symbol's chain.
__device__ __forceinline__ uint32_t add_apart(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// One symbol of the bucketed search.  blast: the bucket-last values in
// registers (kQuads > 0, 4 kQuads of them) or in shared memory (kQuads ==
// 0, ``padded`` of them, a power of two above the bucket count); win: the
// windows in shared memory, kWindowStride int32 each.
template <int kQuads>
__device__ __forceinline__ int32_t bucketed_symbol(
    SlotDecoder& d, const RowReader& rd, const uint32_t* blast_reg,
    const uint32_t* blast, int padded, const int32_t* win, int num_buckets,
    int max_pv, int prec, float scale, uint32_t tmax) {
  const uint32_t t = threshold(d, prec, scale, tmax);
  int nfull;
  if constexpr (kQuads > 0) {
    uint32_t p0 = 0, p1 = 0, p2 = 0, p3 = 0;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      p0 += below(blast_reg[4 * q], t);
      p1 += below(blast_reg[4 * q + 1], t);
      p2 += below(blast_reg[4 * q + 2], t);
      p3 += below(blast_reg[4 * q + 3], t);
    }
    nfull = static_cast<int>(
        add_apart(add_apart(p0, p1), add_apart(p2, p3)));
  } else {
    nfull = 0;
#pragma unroll 1
    for (int step = padded >> 1; step > 0; step >>= 1)
      nfull += below(blast[nfull + step - 1], t) ? step : 0;
  }
  const int bsel = min(nfull, num_buckets - 1);
  const int32_t* row = win + kWindowStride * bsel;
  const int4* row4 = reinterpret_cast<const int4*>(row);
  const int4 w0 = row4[0], w1 = row4[1], w2 = row4[2], w3 = row4[3],
             w4 = row4[4];
  // Entries 1 ... 17 of the row are the window.
  const uint32_t f0 = below(w0.y, t) + below(w0.z, t) + below(w0.w, t) +
                      below(w4.x, t) + below(w4.y, t);
  const uint32_t f1 = below(w1.x, t) + below(w1.y, t) + below(w1.z, t) +
                      below(w1.w, t);
  const uint32_t f2 = below(w2.x, t) + below(w2.y, t) + below(w2.z, t) +
                      below(w2.w, t);
  const uint32_t f3 = below(w3.x, t) + below(w3.y, t) + below(w3.z, t) +
                      below(w3.w, t);
  const int f = static_cast<int>(add_apart(add_apart(f0, f1),
                                           add_apart(f2, f3)));
  const uint32_t c_lo = static_cast<uint32_t>(row[f]);
  const uint32_t c_hi = static_cast<uint32_t>(row[f + 1]);
  narrow(d, rd, c_lo, c_hi, prec);
  const int pv = min(16 * nfull + max(f - 1, 0), max_pv);
  return pv - 1;
}

// buckets: bucket_last int32 [num_buckets]; windows: int32 [num_buckets,
// 17] (cuda_coder.bucketize_row).  Shared memory: the rings, the windows
// (kWindowStride int32 each), then bucket_last padded to ``padded``.
template <int kQuads>
__global__ void __launch_bounds__(kBucketedThreads)
decode_bucketed_kernel(const uint8_t* __restrict__ buf, int64_t buf_width,
                       const int32_t* __restrict__ byte_lens,
                       int64_t num_streams, int64_t num_elements,
                       const int32_t* __restrict__ bucket_last,
                       const int32_t* __restrict__ win17, int num_buckets,
                       int padded, int max_pv, int prec,
                       int32_t* __restrict__ symbols,
                       uint8_t* __restrict__ sanity) {
  extern __shared__ int4 bucket_smem[];
  int32_t* win = reinterpret_cast<int32_t*>(
      bucket_smem + kBucketedThreads * kSingleRowRing / 16);
  uint32_t* blast =
      reinterpret_cast<uint32_t*>(win + kWindowStride * num_buckets);
  for (int i = threadIdx.x; i < kWindowStride * num_buckets;
       i += kBucketedThreads) {
    const int b = i / kWindowStride;
    const int k = i - b * kWindowStride;
    win[i] = k == 0 ? 0 : (k <= 17 ? win17[17 * b + k - 1] : 65536);
  }
  for (int i = threadIdx.x; i < padded; i += kBucketedThreads)
    blast[i] = i < num_buckets ? static_cast<uint32_t>(bucket_last[i])
                               : kNeverBelow;
  __syncthreads();
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kBucketedThreads + threadIdx.x;
  if (s >= num_streams) return;

  uint32_t blast_reg[kQuads > 0 ? 4 * kQuads : 1];
#pragma unroll
  for (int i = 0; i < (kQuads > 0 ? 4 * kQuads : 0); ++i)
    blast_reg[i] = blast[i];

  const int64_t src_len = byte_lens[s];
  RowReader rd;
  SlotDecoder d = open_stream(
      rd, buf + s * buf_width, src_len < buf_width ? src_len : buf_width,
      reinterpret_cast<uint8_t*>(bucket_smem) + threadIdx.x * kSingleRowRing);

  const float scale = static_cast<float>(1u << prec);
  const uint32_t tmax = (1u << prec) + 1u;
  sanity[s] = decode_row(
      d, rd, symbols + s * num_elements, num_elements, src_len,
      [&](SlotDecoder& dd, const RowReader& r) {
        return bucketed_symbol<kQuads>(dd, r, blast_reg, blast, padded, win,
                                       num_buckets, max_pv, prec, scale,
                                       tmax);
      });
}

// ---------------------------------------------------------------------------
// K2 and K3', one warp per stream.
// ---------------------------------------------------------------------------
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Warps a block, one stream each.  K2's launches hold a few hundred
// streams; measured on an NVIDIA H100 80GB HBM3 (700 W) by
// tools/indexed_warp_geometry.py, from a CUDA graph, at the native
// containers' launches, 2 / 4 / 8 warps a block, ms: bls2017's 256 x 512
// 0.0584 / 0.0584 / 0.0710, its 512 x 384 0.0449 / 0.0448 / 0.0542;
// bmshj2018's y 512 x 384 0.1296 / 0.0644 / 0.0734 (two blocks of its
// 196 KB table do not fit an SM, so 2 warps a block run in two waves),
// 512 x 576 0.1880 / 0.0936 / 0.1075, its z 32 x 384 0.0451 / 0.0450 /
// 0.0543.
constexpr int kIndexedWarpsPerBlock = 4;
constexpr int kGammaWarpsPerBlock = 8;
__host__ __device__ constexpr int warps_per_block(int mode) {
  return mode == kIndexed ? kIndexedWarpsPerBlock : kGammaWarpsPerBlock;
}
constexpr int kWindowBytes = 512;  // 32 lanes x 16 bytes
constexpr int kRingBytes = 2 * kWindowBytes;
constexpr int kDirectBuckets = 4;  // rows of <= 129 entries: one level
constexpr int kCoarseHeld = 2;     // coarse rounds loaded ahead into registers
constexpr int kMetaBytes = 16;

// Geometry of the 16-bit layout (cuda_coder.warp_table): one record per
// row, ``stride`` 16-bit units long (a multiple of 8, so that records start
// 16-byte aligned): 8 units of metadata (four int32, see RowLoads), then
// ``buckets`` every-32nd entries, then ``row_len`` entries.
struct WarpLayout {
  int num_rows;
  int buckets;  // max(4, ceil((max_len - 1) / 32))
  int row_len;  // 2 + 32 * buckets: the probes' reach and one entry more
  int stride;
  int64_t units;
};

inline WarpLayout warp_layout(int num_rows, int max_len) {
  WarpLayout g;
  g.num_rows = num_rows;
  g.buckets = (max_len - 1 + 31) / 32;
  if (g.buckets < kDirectBuckets) g.buckets = kDirectBuckets;
  g.row_len = 2 + 32 * g.buckets;
  g.stride = (8 + g.buckets + g.row_len + 7) / 8 * 8;
  g.units = static_cast<int64_t>(num_rows) * g.stride;
  return g;
}

// What the search of one symbol needs that does not depend on the decoder's
// state.  Its loads are started one symbol ahead and their results are not
// touched before that symbol's turn: a warp runs in program order, so an
// operation that waits for a load holds back every one behind it, the
// chain of the symbol at hand included.
//
// Entries are stored as min(value, 2^precision - 1), which changes only a
// row's terminal entries, and no terminal entry is ever below the threshold
// (the decoder keeps value - base < size): the count is capped at
// ``limit``, the index before the row's first terminal entry, which is
// exact, because a stored terminal tests below only where every entry
// before it does.  The entry at the count is then never a terminal one, and
// the one after it is read from the table or, at the cap, taken from
// ``top``.  With the terminal out of the way, (size * entry) >> precision
// fits 32 bits, and "size * entry < (offset + 1) << precision" becomes
// "(size * entry) >> precision <= offset".
struct RowLoads {
  const char* record;
  int4 meta;  // x: escape marker len-2, -1 on a row without overflow;
              // y: precision; z: top, the interval's end at the cap
              // (2^precision); w: limit
  uint32_t raw[kDirectBuckets];  // this lane's entries (one level) or its
                                 // coarse ones (two levels), as stored
};

// The decoder state, the same in every lane of the warp, and the stream's
// bytes behind a ring in shared memory.  The state is the range's base and
// size - 1 and the offset value - base of the reference decoder: the search
// and the update need only the offset, so value itself is put together at
// the end, for the sanity check.
struct WarpDecoder {
  const uint8_t* src;
  int64_t avail;  // readable bytes: min(byte_len, buffer width)
  int shift;      // ring positions count from src - shift: 16-byte aligned,
                  // or src itself (read byte by byte) where src is odd, so
                  // that a chunk never straddles two 16-bit units of the ring
  bool aligned;
  int lane;
  uint8_t* ring;       // kRingBytes of this warp
  int64_t filled = 0;  // the ring holds positions [filled - kRingBytes, filled)
  int room = 0;        // filled less the position of the next chunk (even)
  uint4 ahead;         // this lane's 16 bytes of the window at ``filled``
  uint32_t base = 0;
  uint32_t sm1 = 0xFFFFFFFFu;
  uint32_t offset = 0;  // value - base
  uint32_t next = 0;    // the next chunk as it lies in memory (its high byte
                        // first), loaded ahead of its use and untouched
                        // until then

  // This lane's 16 bytes of the window at position ``start``; bytes outside
  // [0, avail) of the stream are zero.
  __device__ uint4 window(int64_t start) const {
    const int64_t p = start + 16 * lane - shift;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (aligned && p >= 0 && p + 16 <= avail) {
      v = *reinterpret_cast<const uint4*>(src + p);
    } else if (p + 16 > 0 && p < avail) {
      // Rare (a stream's first and last window, or all of them where src
      // is odd): kept small, not fast.
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
      for (int i = 0; i < 16; ++i) {
        const int64_t q = p + i;
        if (q >= 0 && q < avail)
          w[i >> 2] |= static_cast<uint32_t>(src[q]) << (8 * (i & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return v;
  }

  // Publishes the window held in registers and starts the load of the next.
  __device__ void advance() {
    __syncwarp();
    reinterpret_cast<uint4*>(ring + (filled & (kRingBytes - 1)))[lane] = ahead;
    filled += kWindowBytes;
    room += kWindowBytes;
    ahead = window(filled);
    __syncwarp();
  }

  // Loads the next chunk.
  __device__ void load_next() {
    next = *reinterpret_cast<const uint16_t*>(
        ring + ((static_cast<uint32_t>(filled) - room) & (kRingBytes - 1)));
  }

  // x << 16 | chunk, the chunk's two bytes swapped into place.
  __device__ uint32_t shifted_in(uint32_t x) const {
    return __byte_perm(x, next, 0x1045);
  }

  __device__ void start() {
    const int at = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    aligned = (at & 1) == 0;
    shift = aligned ? at : 0;
    ahead = window(0);
    room = -shift;
    advance();
    for (int k = 0; k < 2; ++k) {
      load_next();
      offset = shifted_in(offset);
      room -= 2;
    }
    load_next();
  }

  // Makes sure that the ring holds the next ``bytes`` bytes (at most
  // kWindowBytes, so that a refill never overwrites bytes not yet read).
  __device__ void reserve(int bytes) {
    while (room < bytes) advance();
  }

  // Narrows to [a, b] (already scaled) and renormalizes, without a branch.
  // The caller has reserved the chunk after the one this may consume.
  __device__ void refine(uint32_t a, uint32_t b) {
    const uint32_t ns = b - a;
    const bool renorm = (ns >> 16) == 0;
    const uint32_t left = offset - a;
    offset = renorm ? shifted_in(left) : left;
    sm1 = renorm ? (ns << 16) | kU16 : ns;
    base = renorm ? (base + a) << 16 : base + a;
    room -= renorm ? 2 : 0;
    if (renorm) load_next();
  }

  __device__ int64_t chunks_read() const {
    return (filled - room - shift) >> 1;
  }

  // size * c as one 32 x 32 -> 64-bit multiply-add (size may be 2^32).
  __device__ uint64_t scaled(uint32_t c) const {
    return static_cast<uint64_t>(sm1) * c + c;
  }

  // size * c < (offset + 1) << prec, for c < 2^prec.
  __device__ bool below(uint32_t c, int prec) const {
    return static_cast<uint32_t>(scaled(c) >> prec) <= offset;
  }

  // decode_core's _decode_binary: one bit at precision 1.
  __device__ uint32_t bit() {
    reserve(4);
    const uint32_t b =
        scaled(1u) < ((static_cast<uint64_t>(offset) + 1) << 1) ? 1u : 0u;
    refine(static_cast<uint32_t>(scaled(b) >> 1),
           static_cast<uint32_t>(scaled(b + 1u) >> 1) - 1u);
    return b;
  }
};

// A symbol consumes at most one chunk, so a window of 32 symbols needs 64
// bytes and the chunk loaded ahead two more: reserved once a window, which
// keeps the refill's branch out of the chain of a symbol.
constexpr int kWindowReserve = 2 * 32 + 2;

struct Escaped {
  WarpDecoder dec;
  int32_t value;
};

// OverflowDecode after the marker ``marker``, every lane the same: zeros
// counted while n < 31 (phase 0), the n bits below the magnitude's top one
// (phase 1), the sign (phase 2).  Escapes are rare, and this is a function
// of its own, the decoder passed by value, to keep its code out of the path
// of the other symbols: a single warp has nothing to hide a jump over it
// behind.
__device__ __noinline__ Escaped decode_escape(WarpDecoder dec, int32_t marker) {
  uint32_t n = 0, gm = 1u, sign = 0u;
  int left = 0;
  for (int phase = 0; phase < 3;) {
    const uint32_t b = dec.bit();
    if (phase == 0) {
      if (b != 0u || ++n >= 31u) {
        gm = 1u << n;
        left = static_cast<int>(n);
        phase = left > 0 ? 1 : 2;
      }
    } else if (phase == 1) {
      gm |= b << (left - 1);
      if (--left == 0) phase = 2;
    } else {
      sign = b;
      phase = 3;
    }
  }
  dec.reserve(kWindowReserve);
  Escaped out;
  out.dec = dec;
  out.value = static_cast<int32_t>(
      sign ? 0u - gm : gm + static_cast<uint32_t>(marker) - 1u);
  return out;
}

// layout: the 16-bit table layout of geometry g, 16-byte aligned.  One
// stream a warp, warps_per_block(kMode) warps a block.  Dynamic shared
// memory: a ring a warp, then (kSharedTable) the layout.  kMode: kIndexed
// (K2, the escape marker comes back as the symbol) or kGamma (K3', the
// escape is decoded from the stream).  kDirect: rows of at most 129
// entries (g.buckets == kDirectBuckets), found in one level.
template <int kMode, bool kSharedTable, bool kDirect>
__global__ void __launch_bounds__(32 * warps_per_block(kMode), 1)
decode_symbols_warp_kernel(
    const uint8_t* __restrict__ buf, int64_t buf_width,
    const int32_t* __restrict__ byte_lens,
    const int32_t* __restrict__ indexes, int64_t num_streams,
    int64_t num_elements, const uint4* __restrict__ layout, WarpLayout g,
    int32_t* __restrict__ symbols, uint8_t* __restrict__ sanity) {
  extern __shared__ uint4 warp_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int warps = warps_per_block(kMode);
  const char* table = reinterpret_cast<const char*>(layout);
  if (kSharedTable) {
    // Four loads in flight a thread before their stores.
    uint4* dst = warp_smem + warps * (kRingBytes / 16);
    const int64_t n = g.units / 8, step = 32 * warps;
    int64_t i = threadIdx.x;
    for (; i + 3 * step < n; i += 4 * step) {
      const uint4 a = layout[i], b = layout[i + step];
      const uint4 c = layout[i + 2 * step], d = layout[i + 3 * step];
      dst[i] = a;
      dst[i + step] = b;
      dst[i + 2 * step] = c;
      dst[i + 3 * step] = d;
    }
    for (; i < n; i += step) dst[i] = layout[i];
    __syncthreads();
    table = reinterpret_cast<const char*>(dst);
  }
  const int64_t s = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (s >= num_streams) return;

  const int buckets = kDirect ? kDirectBuckets : g.buckets;
  const int last_row = g.num_rows - 1;
  const int record_bytes = 2 * g.stride;
  // Byte offsets in a record: this lane's first entry probe (entry 1 +
  // lane), its coarse probes, and entry 0.
  const int entries_at = kMetaBytes + 2 * buckets;
  const int probe_at = entries_at + 2 * (1 + lane);
  int coarse_at[kCoarseHeld];
#pragma unroll
  for (int r = 0; r < kCoarseHeld; ++r)
    coarse_at[r] = kMetaBytes + 2 * min(lane + 32 * r, buckets - 1);

  const int64_t src_len = byte_lens[s];
  WarpDecoder dec;
  dec.src = buf + s * buf_width;
  dec.avail = src_len < buf_width ? src_len : buf_width;
  dec.lane = lane;
  dec.ring = reinterpret_cast<uint8_t*>(warp_smem) + warp * kRingBytes;
  dec.start();

  const int32_t* irow = indexes + s * num_elements;
  int32_t* orow = symbols + s * num_elements;
  // The byte offset of the record of element j's row, 0 past the stream.
  auto record_of = [&](int64_t j) {
    const int row = j < num_elements ? irow[j] : 0;
    return min(max(row, 0), last_row) * record_bytes;
  };

  // Starts the loads of a symbol's row.
  auto start_loads = [&](int record, RowLoads& p) {
    p.record = table + record;
    p.meta = *reinterpret_cast<const int4*>(p.record);
    if (kDirect) {
#pragma unroll
      for (int r = 0; r < kDirectBuckets; ++r)
        p.raw[r] =
            *reinterpret_cast<const uint16_t*>(p.record + probe_at + 64 * r);
    } else {
#pragma unroll
      for (int r = 0; r < kCoarseHeld; ++r)
        p.raw[r] =
            *reinterpret_cast<const uint16_t*>(p.record + coarse_at[r]);
    }
  };
  auto entry_at = [&](const RowLoads& p, int k) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(p.record + entries_at + 2 * k);
  };

  // Symbol t of a window: fetches the record offset of symbol t + 2 from
  // lane t of ``ahead2`` into record_out, starts the loads of symbol t + 1
  // (record offset record_in, fetched a step ago) into nxt, and decodes
  // symbol t from cur.  The two RowLoads and the two offsets swap roles from
  // one step to the next, so that no register is copied (a copy would wait
  // for its load).  Returns what lane t keeps.
  auto step = [&](int t, int ahead2, const RowLoads& cur, RowLoads& nxt,
                  int record_in, int& record_out, int32_t keep) {
    record_out = __shfl_sync(kFullMask, ahead2, t);
    start_loads(record_in, nxt);
    const int prec = cur.meta.y;
    int count = 0;
    if (kDirect) {
#pragma unroll
      for (int r = 0; r < kDirectBuckets; ++r)
        count +=
            __popc(__ballot_sync(kFullMask, dec.below(cur.raw[r], prec)));
    } else {
      // Full buckets first: every 32nd entry.
      int full = 0;
#pragma unroll
      for (int r = 0; r < kCoarseHeld; ++r) {
        const bool in_row = lane + 32 * r < buckets;
        full += __popc(
            __ballot_sync(kFullMask, in_row & dec.below(cur.raw[r], prec)));
      }
      for (int r = kCoarseHeld; 32 * r < buckets; ++r) {
        const int j = lane + 32 * r;
        const bool in_row = j < buckets;
        const uint32_t c = *reinterpret_cast<const uint16_t*>(
            cur.record + kMetaBytes + 2 * min(j, buckets - 1));
        full += __popc(__ballot_sync(kFullMask, in_row & dec.below(c, prec)));
      }
      const int b = min(full, buckets - 1);
      count = 32 * b +
              __popc(__ballot_sync(
                  kFullMask,
                  dec.below(*reinterpret_cast<const uint16_t*>(
                                cur.record + probe_at + 64 * b),
                            prec)));
    }
    count = min(count, cur.meta.w);
    const uint32_t c_lo = entry_at(cur, count);
    const uint32_t c_up = entry_at(cur, count + 1);
    const uint32_t c_hi =
        count == cur.meta.w ? static_cast<uint32_t>(cur.meta.z) : c_up;
    dec.refine(static_cast<uint32_t>(dec.scaled(c_lo) >> prec),
               static_cast<uint32_t>(dec.scaled(c_hi) >> prec) - 1u);
    // K2: the count is the symbol, the escape marker len-2 included.  It
    // is capped at the row's limit, the thread kernel's at max_len - 2:
    // the same, since count <= limit <= max_len - 2 on every row that
    // reaches 2^precision before its padding (warp_table), which every
    // row of a tables.CdfTable does.
    int32_t sym = count;
    if (kMode == kGamma) {
      if (__builtin_expect(sym == cur.meta.x, 0)) {
        const Escaped e = decode_escape(dec, cur.meta.x);
        dec = e.dec;
        sym = e.value;
      }
    }
    return lane == t ? sym : keep;
  };

  // Record offsets come 32 at a time, one a lane, one window ahead: lane l
  // of ``ahead2`` holds that of symbol j0 + 2 + l, two symbols ahead of the
  // window it serves, so that a step's fetch never spans two registers.
  RowLoads even = {}, odd = {};
  start_loads(record_of(0), even);
  int record_odd = record_of(1);
  int record_even = 0;
  int ahead2_next = record_of(2 + lane);
  for (int64_t j0 = 0; j0 < num_elements; j0 += 32) {
    const int ahead2 = ahead2_next;
    ahead2_next = record_of(j0 + 34 + lane);
    dec.reserve(kWindowReserve);
    int32_t keep = 0;
    if (num_elements - j0 >= 32) {
#pragma unroll 1
      for (int t = 0; t < 32; t += 2) {
        keep = step(t, ahead2, even, odd, record_odd, record_even, keep);
        keep = step(t + 1, ahead2, odd, even, record_even, record_odd, keep);
      }
      // Lane t holds symbol j0 + t: 128 consecutive bytes a warp.
      orow[j0 + lane] = keep;
    } else {
      // The last, short window; an odd count ends the stream.
      const int in_window = static_cast<int>(num_elements - j0);
#pragma unroll 1
      for (int t = 0; t < in_window; t += 2) {
        keep = step(t, ahead2, even, odd, record_odd, record_even, keep);
        if (t + 1 < in_window)
          keep = step(t + 1, ahead2, odd, even, record_even, record_odd, keep);
      }
      if (lane < in_window) orow[j0 + lane] = keep;
    }
  }
  if (lane == 0)
    sanity[s] = stream_sane(dec.base, dec.sm1, dec.base + dec.offset,
                            dec.chunks_read(), src_len)
                    ? 1
                    : 0;
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

extern "C" int ctpu_decode_gamma(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    const int32_t* indexes, int64_t num_streams, int64_t num_elements,
    const int32_t* cdf, const int32_t* meta, int num_rows, int max_len,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  return launch<kGamma>(buf, buf_width, byte_lens, indexes, num_streams,
                        num_elements, cdf, meta, num_rows, max_len, symbols,
                        sanity, stream);
}

// layout: the table in the 16-bit layout of cuda_coder.warp_table (int16
// [layout_units], 16-byte aligned) for a table of num_rows x max_len.
template <int kMode>
int launch_warp(const uint8_t* buf, int64_t buf_width,
                const int32_t* byte_lens, const int32_t* indexes,
                int64_t num_streams, int64_t num_elements,
                const void* layout, int64_t layout_units, int num_rows,
                int max_len, int32_t* symbols, uint8_t* sanity,
                void* stream) {
  const WarpLayout g = warp_layout(num_rows, max_len);
  if (g.units != layout_units || (reinterpret_cast<uintptr_t>(layout) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int warps = warps_per_block(kMode);
  const size_t rings = static_cast<size_t>(warps) * kRingBytes;
  const size_t table_bytes = 2 * static_cast<size_t>(g.units);
  const bool use_shared = rings + table_bytes <= 227 * 1024;
  const size_t smem = rings + (use_shared ? table_bytes : 0);
  const int64_t blocks = (num_streams + warps - 1) / warps;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const uint4* lay = static_cast<const uint4*>(layout);
  const bool direct = g.buckets == kDirectBuckets;
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
             static_cast<cudaStream_t>(stream)>>>(
        buf, buf_width, byte_lens, indexes, num_streams, num_elements, lay, g,
        symbols, sanity);
    return static_cast<int>(cudaGetLastError());
  };
  if (use_shared)
    return direct ? run(decode_symbols_warp_kernel<kMode, true, true>)
                  : run(decode_symbols_warp_kernel<kMode, true, false>);
  return direct ? run(decode_symbols_warp_kernel<kMode, false, true>)
                : run(decode_symbols_warp_kernel<kMode, false, false>);
}

extern "C" int ctpu_decode_gamma_warp(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    const int32_t* indexes, int64_t num_streams, int64_t num_elements,
    const void* layout, int64_t layout_units, int num_rows, int max_len,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  return launch_warp<kGamma>(buf, buf_width, byte_lens, indexes, num_streams,
                             num_elements, layout, layout_units, num_rows,
                             max_len, symbols, sanity, stream);
}

extern "C" int ctpu_decode_indexed_warp(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    const int32_t* indexes, int64_t num_streams, int64_t num_elements,
    const void* layout, int64_t layout_units, int num_rows, int max_len,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  return launch_warp<kIndexed>(buf, buf_width, byte_lens, indexes,
                               num_streams, num_elements, layout,
                               layout_units, num_rows, max_len, symbols,
                               sanity, stream);
}

// K8''s kernel with the bucket count from registers at kQuads quads
// (kQuads in [1, kLinearMaxBuckets / 4]), or by binary search (0).
template <int kQuads = kLinearMaxBuckets / 4>
cudaError_t launch_bucketed(int quads, dim3 grid, size_t smem,
                            cudaStream_t stream, const uint8_t* buf,
                            int64_t buf_width, const int32_t* byte_lens,
                            int64_t num_streams, int64_t num_elements,
                            const int32_t* bucket_last, const int32_t* win17,
                            int num_buckets, int padded, int max_pv, int prec,
                            int32_t* symbols, uint8_t* sanity) {
  if constexpr (kQuads > 0) {
    if (quads != kQuads)
      return launch_bucketed<kQuads - 1>(
          quads, grid, smem, stream, buf, buf_width, byte_lens, num_streams,
          num_elements, bucket_last, win17, num_buckets, padded, max_pv, prec,
          symbols, sanity);
  }
  auto kernel = decode_bucketed_kernel<kQuads>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kBucketedThreads, smem, stream>>>(
      buf, buf_width, byte_lens, num_streams, num_elements, bucket_last,
      win17, num_buckets, padded, max_pv, prec, symbols, sanity);
  return cudaGetLastError();
}

// bucket_last int32 [num_buckets], win17 int32 [num_buckets, 17] of a row
// at precision prec (1 ... 16) whose entries are at most 2^prec; max_pv the
// row's padded length less one.
extern "C" int ctpu_decode_single_row_bucketed(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    int64_t num_streams, int64_t num_elements, const int32_t* bucket_last,
    const int32_t* win17, int num_buckets, int max_pv, int prec,
    int32_t* symbols, uint8_t* sanity, void* stream) {
  if (prec < 1 || prec > 16 || num_buckets < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // bucket_last padded to a power of two above the bucket count (the binary
  // search's reach) and to whole quads (the registers' loads).
  int padded = 1;
  while (padded <= num_buckets) padded <<= 1;
  const int quads = (num_buckets + 3) / 4;
  padded = max(padded, 4 * quads);
  const size_t smem =
      static_cast<size_t>(kBucketedThreads) * kSingleRowRing +
      sizeof(int32_t) * (static_cast<size_t>(kWindowStride) * num_buckets +
                         padded);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      (num_streams + kBucketedThreads - 1) / kBucketedThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_bucketed(
      num_buckets <= kLinearMaxBuckets ? quads : 0,
      dim3(static_cast<unsigned>(blocks)), smem,
      static_cast<cudaStream_t>(stream), buf, buf_width, byte_lens,
      num_streams, num_elements, bucket_last, win17, num_buckets, padded,
      max_pv, prec, symbols, sanity));
}

// slots: cuda_coder.single_row_slots(cdf, meta) of a one-row table of
// max_len entries at precision prec (1 ... 16), ``units`` int32, 16-byte
// aligned.
extern "C" int ctpu_decode_single_row(
    const uint8_t* buf, int64_t buf_width, const int32_t* byte_lens,
    int64_t num_streams, int64_t num_elements, const void* slots,
    int64_t units, int prec, int max_len, int32_t* symbols, uint8_t* sanity,
    void* stream) {
  if (prec < 1 || prec > 16 || max_len < 2 ||
      units != slot_units(prec, max_len) ||
      (reinterpret_cast<uintptr_t>(slots) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rings = static_cast<size_t>(kSingleRowThreads) * kSingleRowRing;
  const size_t table_bytes = 4 * static_cast<size_t>(units);
  const bool shared = rings + table_bytes <= 227 * 1024;
  const size_t smem = rings + (shared ? table_bytes : 0);
  const int64_t blocks =
      (num_streams + kSingleRowThreads - 1) / kSingleRowThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), kSingleRowThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        buf, buf_width, byte_lens, num_streams, num_elements,
        static_cast<const int4*>(slots), units / 4, prec, max_len, symbols,
        sanity);
    return static_cast<int>(cudaGetLastError());
  };
  // A wide table (at most 131 KB) always fits beside the rings.
  if (prec <= kWideMaxPrecision)
    return run(decode_single_row_kernel<true, true>);
  return shared ? run(decode_single_row_kernel<false, true>)
                : run(decode_single_row_kernel<false, false>);
}
