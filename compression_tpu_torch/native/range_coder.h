/* compression_tpu_torch stand-alone range codec — C API (a copy of the
 * JAX package's native/range_coder.h).
 *
 * Decode-anywhere packaging (the role the reference's TFLite custom
 * kernels play for mobile, reference cc/tflite/range_coder_kernels.cc:
 * 545-588): this header + range_coder.cc build with ANY C++17 compiler,
 * no Python / TensorFlow / JAX / abseil dependency:
 *
 *     g++ -O2 -std=c++17 -pthread -c range_coder.cc
 *
 * and the two entry points below then encode/decode streams that are
 * bit-exact with the port's CUDA kernels and the reference C++ coder
 * (golden-pinned in tests/test_torch_host_coder.py).
 *
 * Table layout (the dense form produced by
 * compression_tpu_torch.codec.tables.parse_ragged_cdf):
 *   cdf       int32 [num_rows, max_len] row-major; row r holds
 *             length[r] monotone values, cdf[0] == 0,
 *             cdf[length[r]-1] == 1 << precision[r].
 *   length    int32 [num_rows]   valid entries per row.
 *   precision int32 [num_rows]   1..16.
 *   overflow  uint8 [num_rows]   1 => the row's last symbol
 *             (length[r]-2) is an escape marker followed by in-stream
 *             Elias-gamma magnitude + sign bits (reference
 *             cc/kernels/range_coder_kernels.cc:290-322).
 *
 * Stream addressing: element j of stream s uses CDF row indexes[s*N+j],
 * or j % num_rows when `indexes` is NULL (channel mode).  Streams are
 * independent; `num_threads` fans them out over a std::thread pool.
 */

#ifndef COMPRESSION_TPU_NATIVE_RANGE_CODER_H_
#define COMPRESSION_TPU_NATIVE_RANGE_CODER_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Encodes num_streams x num_elements int32 symbols.
 * out_buf:     uint8 [num_streams, out_stride] (zeroed by the call).
 * out_lengths: int32 [num_streams] bytes written per stream.
 * Returns 0 on success, -1 if any stream overran out_stride, -2 on a
 * bad symbol (out of range for a non-overflow row). */
int ctpu_encode_streams(const int32_t* values, const int32_t* indexes,
                        int64_t num_streams, int64_t num_elements,
                        const int32_t* cdf, const int32_t* length,
                        const int32_t* precision, const uint8_t* overflow,
                        int64_t num_rows, int64_t max_len, uint8_t* out_buf,
                        int64_t out_stride, int32_t* out_lengths,
                        int num_threads);

/* Decodes num_streams x num_elements symbols from padded byte buffers.
 * out_sanity[s] is the reference's weak decode check (1 = consistent;
 * reference cc/lib/range_coder.h:144-169).  Always returns 0. */
int ctpu_decode_streams(const uint8_t* buf, const int32_t* in_lengths,
                        int64_t in_stride, const int32_t* indexes,
                        int64_t num_streams, int64_t num_elements,
                        const int32_t* cdf, const int32_t* length,
                        const int32_t* precision, const uint8_t* overflow,
                        int64_t num_rows, int64_t max_len,
                        int32_t* out_values, uint8_t* out_sanity,
                        int num_threads);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* COMPRESSION_TPU_NATIVE_RANGE_CODER_H_ */
