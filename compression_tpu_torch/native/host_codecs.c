/* Host codecs: bit coder + run-length / gamma / Rice codes.
 *
 * C implementation of the byte-stream codes of the PowerLaw and Laplace
 * entropy models (a copy of compression_tpu/native/host_codecs.c).
 * Bit-exact with the plain Python bit coder in
 * compression_tpu_torch/ops/run_length.py, which mirrors the reference's
 * cc/lib/bit_coder.cc and cc/kernels/run_length*_kernels.cc semantics.
 *
 * Plain C ABI (no CPython dependency), loaded through ctypes.
 */

#include <stdint.h>
#include <string.h>

typedef struct {
  uint8_t* data;
  long cap;
  long nbytes;
  uint64_t buffer;
  int bits;
  int error;
} Writer;

static void w_bits(Writer* w, int count, uint64_t bits) {
  if (w->error) return;
  bits &= (count >= 64) ? ~0ULL : ((1ULL << count) - 1);
  w->buffer |= bits << w->bits;
  w->bits += count;
  while (w->bits >= 8) {
    if (w->nbytes >= w->cap) { w->error = 1; return; }
    w->data[w->nbytes++] = (uint8_t)(w->buffer & 0xFF);
    w->buffer >>= 8;
    w->bits -= 8;
  }
}

static int bit_width_u32(uint32_t v) {
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

static void w_gamma(Writer* w, int32_t value) {
  int bw = bit_width_u32((uint32_t)value);
  w_bits(w, bw - 1, 0);
  w_bits(w, 1, 1);
  w_bits(w, bw - 1, (uint32_t)value);
}

static void w_rice(Writer* w, int32_t value, int parameter) {
  uint32_t zeros = ((uint32_t)value) >> parameter;
  while (zeros > 32) { w_bits(w, 32, 0); zeros -= 32; }
  w_bits(w, (int)zeros, 0);
  w_bits(w, 1, 1);
  w_bits(w, parameter, (uint32_t)value);
}

static long w_finish(Writer* w) {
  if (w->error) return -1;
  if (w->bits) {
    if (w->nbytes >= w->cap) return -1;
    w->data[w->nbytes++] = (uint8_t)(w->buffer & 0xFF);
  }
  return w->nbytes;
}

typedef struct {
  const uint8_t* data;
  long nbytes;
  long pos;
  uint64_t buffer;
  int bits;
  int error;
} Reader;

static uint64_t r_bits(Reader* r, int count) {
  while (r->bits < count) {
    if (r->pos >= r->nbytes) { r->error = 1; return 0; }
    r->buffer |= ((uint64_t)r->data[r->pos++]) << r->bits;
    r->bits += 8;
  }
  uint64_t out = r->buffer & ((count >= 64) ? ~0ULL : ((1ULL << count) - 1));
  r->buffer >>= count;
  r->bits -= count;
  return out;
}

static int32_t r_gamma(Reader* r) {
  int bw = 1;
  while (!r->error && !r_bits(r, 1)) {
    if (++bw > 31) { r->error = 1; return 0; }
  }
  int32_t msb = 1 << (bw - 1);
  return msb | (int32_t)r_bits(r, bw - 1);
}

static int32_t r_rice(Reader* r, int parameter) {
  int32_t msbs = 0;
  while (!r->error && !r_bits(r, 1)) msbs++;
  return (msbs << parameter) | (int32_t)r_bits(r, parameter);
}

#define INT32_MINV (-2147483647 - 1)

/* ---- run-length gamma (reference run_length_gamma_kernels.cc) -------- */
long rlg_encode(const int32_t* data, long n, uint8_t* out, long cap) {
  Writer w = {out, cap, 0, 0, 0, 0};
  uint32_t zero_ct = 1;
  for (long i = 0; i < n; i++) {
    int32_t sample = data[i];
    if (sample == 0) {
      zero_ct += 1;
    } else {
      w_gamma(&w, (int32_t)zero_ct);
      w_bits(&w, 1, sample > 0);
      if (sample == INT32_MINV) sample += 1;
      w_gamma(&w, sample > 0 ? sample : -sample);
      zero_ct = 1;
    }
  }
  if (zero_ct > 1) w_gamma(&w, (int32_t)zero_ct);
  return w_finish(&w);
}

long rlg_decode(const uint8_t* code, long nbytes, int32_t* out, long n) {
  Reader r = {code, nbytes, 0, 0, 0, 0};
  memset(out, 0, (size_t)n * sizeof(int32_t));
  long i = 0;
  while (i < n) {
    int32_t run = r_gamma(&r) - 1;
    if (r.error) return -1;
    i += run;
    if (i >= n) {
      if (i != n) return -1;
      break;
    }
    int32_t sign = (int32_t)r_bits(&r, 1);
    int32_t mag = r_gamma(&r);
    if (r.error) return -1;
    out[i] = sign ? mag : -mag;
    i += 1;
  }
  return 0;
}

/* ---- general run-length (reference run_length_kernels.cc) ------------ */
static void write_run_length(Writer* w, int32_t run, int rlc) {
  if (rlc >= 0) w_rice(w, run, rlc);
  else w_gamma(w, run + 1);
}

static int32_t read_run_length(Reader* r, int rlc) {
  if (rlc >= 0) return r_rice(r, rlc);
  return r_gamma(r) - 1;
}

static void write_non_zero(Writer* w, int32_t sample, int mc) {
  int sign = sample > 0;
  w_bits(w, 1, sign);
  if (mc >= 0) {
    w_rice(w, sign ? sample - 1 : -(sample + 1), mc);
  } else {
    if (sample == INT32_MINV) w_gamma(w, -(INT32_MINV + 1));
    else w_gamma(w, sign ? sample : -sample);
  }
}

static int32_t read_non_zero(Reader* r, int mc) {
  int positive = (int)r_bits(r, 1);
  if (mc >= 0) {
    int32_t rice = r_rice(r, mc);
    return positive ? rice + 1 : -rice - 1;
  }
  int32_t gamma = r_gamma(r);
  return positive ? gamma : -gamma;
}

long rl_encode(const int32_t* data, long n, int rlc, int mc, int rlnz,
               uint8_t* out, long cap) {
  Writer w = {out, cap, 0, 0, 0, 0};
  long p = 0;
  int32_t run_length_offset = 0;
  while (p < n) {
    long q = p;
    while (q < n && data[q] == 0) q++;
    write_run_length(&w, (int32_t)(q - p) - run_length_offset, rlc);
    p = q;
    if (p >= n) break;
    if (rlnz) {
      q = p;
      while (q < n && data[q] != 0) q++;
      write_run_length(&w, (int32_t)(q - p) - 1, rlc);
      while (p < q) write_non_zero(&w, data[p++], mc);
      run_length_offset = 1;
    } else {
      write_non_zero(&w, data[p++], mc);
    }
  }
  return w_finish(&w);
}

long rl_decode(const uint8_t* code, long nbytes, int32_t* out, long n,
               int rlc, int mc, int rlnz) {
  Reader r = {code, nbytes, 0, 0, 0, 0};
  memset(out, 0, (size_t)n * sizeof(int32_t));
  long p = 0;
  int32_t run_length_offset = 0;
  while (p < n) {
    int32_t run = read_run_length(&r, rlc) + run_length_offset;
    if (r.error) return -1;
    p += run;
    if (p >= n) {
      if (p != n) return -1;
      break;
    }
    if (rlnz) {
      int32_t nz = read_run_length(&r, rlc) + 1;
      if (r.error || p + nz > n) return -1;
      for (int32_t k = 0; k < nz; k++) {
        out[p++] = read_non_zero(&r, mc);
        if (r.error) return -1;
      }
      run_length_offset = 1;
    } else {
      out[p++] = read_non_zero(&r, mc);
      if (r.error) return -1;
    }
  }
  return 0;
}
