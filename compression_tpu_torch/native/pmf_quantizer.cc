// Native PMF -> quantized-CDF converter with exact reference tie-breaking.
//
// Semantics follow tensorflow/compression's PmfToQuantizedCdf kernel
// (reference cc/kernels/pmf_to_cdf_kernels.cc:159-208): round each
// probability to the nearest integer mass (floor 1), then repair the sum to
// exactly 2^precision one unit at a time, always adjusting the symbol with
// the smallest entropy penalty (when stealing) or the largest gain (when
// granting), re-inserting the adjusted symbol after all equal keys.
//
// The reference seeds its repair queue with an *unstable* std::sort, so
// the relative order of equal keys is whatever libstdc++'s introsort
// produces.  Sorting is comparator-driven, so running the same std::sort
// here (over an index permutation with identical comparison results)
// reproduces that order bit-for-bit — which makes the produced tables
// byte-identical to the reference even on all-equal-penalty ties.
//
// Built on demand by compression_tpu_torch.native (g++ -shared) into the
// package's git-ignored _build/ directory and loaded with ctypes.  There
// is no fallback: if it cannot be built, table construction raises.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

double penalty_of(int32_t value, double mass) {
  if (value <= 1) return std::numeric_limits<double>::infinity();
  return mass * (std::log2(static_cast<double>(value)) -
                 std::log2(static_cast<double>(value - 1)));
}

double gain_of(int32_t value, double mass) {
  if (value < 1) return -std::numeric_limits<double>::infinity();
  return mass * (std::log2(static_cast<double>(value + 1)) -
                 std::log2(static_cast<double>(value)));
}

}  // namespace

extern "C" {

// pmf: n non-negative floats.  cdf_out: n+1 int32 slots.
// Returns 0 on success, nonzero on invalid input.
int pmf_to_quantized_cdf(const float* pmf, long n, int precision,
                         int32_t* cdf_out) {
  if (n <= 0 || precision < 1 || precision > 16) return 1;
  const int32_t normalizer = static_cast<int32_t>(1) << precision;

  std::vector<int32_t> value(n);
  std::vector<double> mass(n);
  int64_t sum = 0;
  for (long i = 0; i < n; ++i) {
    const float p = pmf[i];
    if (!(p >= 0.0f) || !std::isfinite(p)) return 2;
    int32_t v = static_cast<int32_t>(
        std::rint(p * static_cast<float>(normalizer)));
    if (v < 1) v = 1;
    value[i] = v;
    mass[i] = static_cast<double>(p);
    sum += v;
  }

  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);

  if (sum > normalizer) {
    std::vector<double> key(n);
    for (long i = 0; i < n; ++i) key[i] = penalty_of(value[i], mass[i]);
    // Unstable sort: equal-key order must match the reference's std::sort.
    std::sort(order.begin(), order.end(),
              [&key](int a, int b) { return key[a] < key[b]; });
    while (sum-- > normalizer) {
      const int head = order[0];
      if (value[head] <= 1) return 3;  // cannot steal below mass 1
      --value[head];
      key[head] = penalty_of(value[head], mass[head]);
      // Move the head past every entry it no longer strictly beats.
      auto stop = std::find_if(
          order.begin() + 1, order.end(),
          [&key, head](int other) { return key[head] < key[other]; });
      std::rotate(order.begin(), order.begin() + 1, stop);
    }
  } else if (sum < normalizer) {
    std::vector<double> key(n);
    for (long i = 0; i < n; ++i) key[i] = gain_of(value[i], mass[i]);
    std::sort(order.begin(), order.end(),
              [&key](int a, int b) { return key[a] > key[b]; });
    while (sum++ < normalizer) {
      const int head = order[0];
      ++value[head];
      key[head] = gain_of(value[head], mass[head]);
      auto stop = std::find_if(
          order.begin() + 1, order.end(),
          [&key, head](int other) { return key[head] > key[other]; });
      std::rotate(order.begin(), order.begin() + 1, stop);
    }
  }

  cdf_out[0] = 0;
  int64_t acc = 0;
  for (long i = 0; i < n; ++i) {
    acc += value[i];
    cdf_out[i + 1] = static_cast<int32_t>(acc);
  }
  return 0;
}

}  // extern "C"
