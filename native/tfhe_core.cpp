// tfhe_core: native C++ oracle for the tfhe_jax TFHE framework.
//
// A second, independent bit-exact implementation of the scheme's integer
// primitives (the first oracle is the NumPy golden model; the JAX path is the
// product).  Exposed via a C ABI for ctypes.  Mirrors the reference Rust
// crate's semantics exactly:
//   - signed gadget decomposition carry chain     (src/decomposer.rs:42-80)
//   - recomposition                               (src/decomposer.rs:83-95)
//   - round_value                                 (src/decomposer.rs:27-40)
//   - schoolbook negacyclic multiplication        (src/utils.rs:221-236)
//   - monomial multiplication                     (src/utils.rs:183-207)
//   - modulus switching                           (src/utils.rs:13-33)
//   - LWE/GLWE encrypt-zero + external product helpers for cross-checks
//
// Build: make -C native   (produces libtfhe_core.so)

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

static inline uint32_t round_value_1(uint32_t v, int log_base, int levels,
                                     int log_q) {
  int ig = log_q - log_base * levels;
  if (ig == 0) return v;
  uint32_t ignored = v & ((1u << ig) - 1u);
  uint32_t msb = ignored >> (ig - 1);
  return ((v >> ig) + msb) << ig;
}

void round_value(const uint32_t* in, int64_t n, int log_base, int levels,
                 int log_q, uint32_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = round_value_1(in[i], log_base, levels, log_q);
}

// Exact carry chain incl. the digit-B anomaly; out is MSB-first, n x levels.
void decompose_u32(const uint32_t* in, int64_t n, int log_base, int levels,
                   int log_q, uint32_t* out) {
  int total = log_q / log_base;
  uint32_t base_mask = (1u << log_base) - 1u;
  uint32_t half = 1u << (log_base - 1);
  std::vector<uint32_t> digs(total);
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = round_value_1(in[i], log_base, levels, log_q);
    uint32_t carry = 0;
    for (int l = 0; l < total; l++) {
      uint32_t res = ((v >> (log_base * l)) & base_mask) + carry;
      uint32_t cm = res & half;
      res -= cm << 1;           // wrapping
      carry = cm >> (log_base - 1);
      digs[l] = res;
    }
    // big-endian, keep `levels` most significant
    for (int j = 0; j < levels; j++) out[i * levels + j] = digs[total - 1 - j];
  }
}

void recompose_u32(const uint32_t* digits, int64_t n, int log_base, int levels,
                   int log_q, uint32_t* out) {
  int ig = log_q - log_base * levels;
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = 0;
    for (int j = 0; j < levels; j++)
      v += digits[i * levels + j] << (log_base * (levels - 1 - j));
    out[i] = v << ig;
  }
}

// recompose(decompose(v)) == round_value(v) over [start, start+count);
// returns the number of failures (0 expected).  ~100M values/s.
uint64_t decomposer_selfcheck(uint64_t start, uint64_t count, int log_base,
                              int levels, int log_q) {
  int total = log_q / log_base;
  uint32_t base_mask = (1u << log_base) - 1u;
  uint32_t half = 1u << (log_base - 1);
  int ig = log_q - log_base * levels;
  uint64_t fails = 0;
  std::vector<uint32_t> digs(total);
  for (uint64_t x = start; x < start + count; x++) {
    uint32_t v = round_value_1((uint32_t)x, log_base, levels, log_q);
    uint32_t carry = 0;
    for (int l = 0; l < total; l++) {
      uint32_t res = ((v >> (log_base * l)) & base_mask) + carry;
      uint32_t cm = res & half;
      res -= cm << 1;
      carry = cm >> (log_base - 1);
      digs[l] = res;
    }
    uint32_t r = 0;
    for (int j = 0; j < levels; j++)
      r += digs[total - 1 - j] << (log_base * (levels - 1 - j));
    r <<= ig;
    if (r != v) fails++;
  }
  return fails;
}

// res = p0 * p1 in Z_{2^32}[X]/(X^N+1), schoolbook (src/utils.rs:221-236)
void negacyclic_mul(const uint32_t* p0, const uint32_t* p1, int n,
                    uint32_t* res) {
  for (int i = 0; i < n; i++) {
    uint32_t acc = 0;
    for (int j = 0; j <= i; j++) acc += p0[j] * p1[i - j];
    for (int j = i + 1; j < n; j++) acc -= p0[j] * p1[n - (j - i)];
    res[i] = acc;
  }
}

// res += p0 * p1 (for poly_dot_product accumulation)
void negacyclic_mul_acc(const uint32_t* p0, const uint32_t* p1, int n,
                        uint32_t* res) {
  for (int i = 0; i < n; i++) {
    uint32_t acc = 0;
    for (int j = 0; j <= i; j++) acc += p0[j] * p1[i - j];
    for (int j = i + 1; j < n; j++) acc -= p0[j] * p1[n - (j - i)];
    res[i] += acc;
  }
}

// p(X) * X^e with negacyclic wraparound (src/utils.rs:183-207)
void monomial_mul(const uint32_t* p, int n, int64_t e, uint32_t* out) {
  int64_t mi = ((e % (2 * n)) + 2 * n) % (2 * n);
  int flip = (int)(mi / n);
  int deg = (int)(mi % n);
  for (int i = 0; i < n; i++) {
    uint32_t v = p[i];
    if (flip) v = (uint32_t)(-(int64_t)v);
    int o = i + deg;
    if (o >= n) {
      out[o - n] = (uint32_t)(-(int64_t)v);
    } else {
      out[o] = v;
    }
  }
}

// round(2^log_to * v / 2^log_from) mod 2^log_to (src/utils.rs:13-33)
void switch_modulus(const uint32_t* in, int64_t n, int log_from, int log_to,
                    uint32_t* out) {
  uint32_t d = 1u << (log_from - log_to);
  uint32_t mask = (log_to >= 32) ? 0xFFFFFFFFu : ((1u << log_to) - 1u);
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = in[i];
    uint32_t r = (v / d) + ((v % d + (d >> 1)) / d);
    out[i] = r & mask;
  }
}

// External product: GGSW[(k+1)*l, k+1, N] x GLWE[k+1, N] -> GLWE[k+1, N]
// (src/ggsw.rs:132-161): decompose rows, poly-dot against each GGSW column.
void external_product(const uint32_t* ggsw, const uint32_t* glwe, int k, int n,
                      int log_base, int levels, int log_q, uint32_t* out) {
  int rows = (k + 1) * levels;
  std::vector<uint32_t> digits((size_t)(k + 1) * n * levels);
  decompose_u32(glwe, (int64_t)(k + 1) * n, log_base, levels, log_q,
                digits.data());
  // digits laid out [poly, coeff, level] -> reorder to rows [poly*levels+lev][coeff]
  std::vector<uint32_t> dec((size_t)rows * n);
  for (int p = 0; p <= k; p++)
    for (int c = 0; c < n; c++)
      for (int l = 0; l < levels; l++)
        dec[(size_t)(p * levels + l) * n + c] =
            digits[((size_t)p * n + c) * levels + l];
  for (int col = 0; col <= k; col++) {
    uint32_t* o = out + (size_t)col * n;
    std::memset(o, 0, sizeof(uint32_t) * n);
    for (int r = 0; r < rows; r++)
      negacyclic_mul_acc(dec.data() + (size_t)r * n,
                         ggsw + ((size_t)r * (k + 1) + col) * n, n, o);
  }
}

}  // extern "C"
