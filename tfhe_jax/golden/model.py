"""NumPy golden model: the single source of semantic truth.

This module reimplements the complete reference scheme (Rust crate at
/root/reference) in NumPy with *bit-exact* wrapping mod-2^32 semantics.  It is
deliberately slow and transparent: every operation mirrors the reference
algorithm (including its quirks, noted per function) so that the fast JAX
path can be tested for exact u32 equality against it under a
deterministic-randomness harness (mask ``a`` and noise ``e`` are explicit
arguments everywhere; no RNG lives in this module).

Reference citations use `src/<file>.rs:<lines>` of the reference crate.

Conventions (identical to the reference):
  * modulus q = 2^log_q (log_q = 32), all ciphertext arithmetic wraps.
  * LWE ciphertext layout: ``(a_0..a_{n-1}, b)``           (src/lwe.rs:110-115)
  * GLWE ciphertext layout: ``(k+1, N)`` rows a_0..a_{k-1}, b
                                                           (src/glwe.rs:185-188)
  * GGSW layout: ``((k+1)*levels, k+1, N)``                (src/ggsw.rs:37-41)
  * decomposition digits are MSB-first (big-endian)        (src/decomposer.rs:72)
"""

from __future__ import annotations

import numpy as np

from tfhe_jax.params import DecomposerParams, GlweParams, LweParams, TfheParams

MASK32 = 0xFFFFFFFF

u32 = np.uint32


def _u(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


# ---------------------------------------------------------------------------
# L1: math / torus utilities (src/utils.rs)
# ---------------------------------------------------------------------------


def integer_division(a: np.ndarray, divisor: int) -> np.ndarray:
    """Round-half-up division avoiding u32 overflow (src/utils.rs:13-18)."""
    a = _u(a)
    divisor = np.uint32(divisor)
    rational = a // divisor
    fractional = a % divisor
    return (rational + (fractional + (divisor >> np.uint32(1))) // divisor).astype(
        np.uint32
    )


def switch_modulus(values: np.ndarray, log_from: int, log_to: int) -> np.ndarray:
    """round(2^log_to * v / 2^log_from) mod 2^log_to (src/utils.rs:23-33)."""
    v = integer_division(values, 1 << (log_from - log_to))
    return (v % np.uint32(1 << log_to)).astype(np.uint32)


def f64_to_torus(v: np.ndarray) -> np.ndarray:
    """f64 -> torus Z_{2^32} (src/utils.rs:36-41).

    NOTE: the reference casts the (possibly negative) rounded fraction with
    Rust's saturating ``as u32``, mapping all negative noise samples to 0.  We
    use two's-complement wrapping instead (the mathematically intended torus
    embedding).  Bit-exact tests always inject noise as u32 directly, so this
    only affects standalone sampling, not cross-checks.
    """
    v = np.asarray(v, dtype=np.float64)
    frac = v - np.round(v)
    return (np.round(frac * float(2**32)).astype(np.int64)).astype(np.uint32)


def negacyclic_sign_toeplitz(p: np.ndarray) -> np.ndarray:
    """Sign-twisted Toeplitz matrix of p (src/utils.rs:113-153).

    T[i, j] = p[(i-j) mod N] * (+1 if j <= i else -1), so that
    (T @ q)[i] = (p * q mod X^N+1)[i].
    """
    p = _u(p)
    n = p.shape[-1]
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    t = p[..., (i - j) % n]
    neg = (j > i)
    return np.where(neg, (-t.astype(np.int64)).astype(np.uint32), t)


def poly_mul(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Negacyclic product via Toeplitz matvec (src/utils.rs:155-160)."""
    t = negacyclic_sign_toeplitz(p0)
    # uint32 matmul wraps mod 2^32 in NumPy, matching ndarray's release-mode dot.
    return t.astype(np.uint32) @ _u(p1)


def school_book_negacyclic_mul(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """O(N^2) schoolbook negacyclic product (src/utils.rs:221-236)."""
    p0 = _u(p0).astype(np.uint64)
    p1 = _u(p1).astype(np.uint64)
    n = p0.shape[0]
    res = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        acc = np.uint64(0)
        for j in range(i + 1):
            acc = (acc + p0[j] * p1[i - j]) & np.uint64(MASK32)
        for j in range(i + 1, n):
            acc = (acc - p0[j] * p1[n - (j - i)]) & np.uint64(MASK32)
        res[i] = acc & np.uint64(MASK32)
    return res.astype(np.uint32)


def poly_dot_product(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """sum_i poly_mul(p0[i], p1[i]) over matching rows (src/utils.rs:163-173)."""
    p0 = _u(p0)
    p1 = _u(p1)
    res = np.zeros(p0.shape[-1], dtype=np.uint32)
    for r0, r1 in zip(p0, p1):
        res = res + poly_mul(r0, r1)
    return res


def poly_mul_monomial(p0: np.ndarray, monomial_index: int) -> np.ndarray:
    """p0(X) * X^monomial_index with negacyclic wraparound (src/utils.rs:183-207)."""
    p0 = _u(p0)
    n = p0.shape[-1]
    # Rust does `monomial_index as usize % (2n)`, exact for power-of-two 2n.
    mi = int(monomial_index) % (2 * n)
    flip_sign = mi // n
    degree = mi % n
    if flip_sign:
        p0 = (-p0.astype(np.int64)).astype(np.uint32)
    out = np.roll(p0, degree)
    if degree:
        out[:degree] = (-out[:degree].astype(np.int64)).astype(np.uint32)
    return out


def poly_mul_monomial_custom_mod(
    p0: np.ndarray, monomial_index: int, log_modulus: int
) -> np.ndarray:
    """Monomial mul then reduce coefficients mod 2^log_modulus (src/utils.rs:209-219)."""
    res = poly_mul_monomial(p0, monomial_index)
    if log_modulus < 32:
        res = res % np.uint32(1 << log_modulus)
    return res


# ---------------------------------------------------------------------------
# L2: signed gadget decomposer (src/decomposer.rs)
# ---------------------------------------------------------------------------


def round_value(value: np.ndarray, p: DecomposerParams) -> np.ndarray:
    """Round off the ignored LSBs to nearest, half up (src/decomposer.rs:27-40)."""
    value = _u(value)
    ig = p.ignored_bits
    if ig == 0:
        return value
    ignored_mask = np.uint32((1 << ig) - 1)
    ignored_msb = (value & ignored_mask) >> np.uint32(ig - 1)
    return (((value >> np.uint32(ig)) + ignored_msb) << np.uint32(ig)).astype(
        np.uint32
    )


def decompose(value: np.ndarray, p: DecomposerParams) -> np.ndarray:
    """Signed decomposition, MSB-first, exact carry chain (src/decomposer.rs:42-80).

    Vectorized over any input shape; output has a trailing ``levels`` axis.
    Digits are returned as u32 in wrapping representation (negative digits wrap);
    values lie in {-B/2..B/2-1} union {B} -- the reference's carry rule emits an
    anomalous digit B when digit B-1 meets an incoming carry (res = B has
    ``res & B/2 == 0`` so no recentering fires).  We reproduce that exactly.
    """
    value = round_value(value, p)
    log_base = p.log_base
    base_mask = np.uint32((1 << log_base) - 1)
    base_by_2_mask = np.uint32(1 << (log_base - 1))
    carry = np.zeros_like(value)
    digits = []
    for l in range(p.log_q // p.log_base):
        res = ((value >> np.uint32(log_base * l)) & base_mask) + carry
        carry_mask = res & base_by_2_mask
        res = (res - (carry_mask << np.uint32(1))).astype(np.uint32)
        carry = carry_mask >> np.uint32(log_base - 1)
        digits.append(res)
    digits.reverse()  # big-endian (MSB-first)
    digits = digits[: p.levels]  # keep `levels` most-significant legs
    return np.stack(digits, axis=-1)


def recompose(legs: np.ndarray, p: DecomposerParams) -> np.ndarray:
    """Inverse of decompose up to rounding (src/decomposer.rs:83-95)."""
    legs = _u(legs)
    value = np.zeros(legs.shape[:-1], dtype=np.uint32)
    for index in range(p.levels):
        value = value + (
            legs[..., index] << np.uint32(p.log_base * (p.levels - 1 - index))
        ).astype(np.uint32)
    return (value << np.uint32(p.ignored_bits)).astype(np.uint32)


def digits_to_signed(digits_u32: np.ndarray, p: DecomposerParams) -> np.ndarray:
    """Map wrapping-u32 digits to small signed ints (range [-B/2, B]).

    Digit values occupy {-B/2..B/2-1, B}; (log_base+2) bits suffice to
    sign-extend unambiguously.
    """
    bits = p.log_base + 2
    m = np.uint32((1 << bits) - 1)
    top = np.uint32(1 << (bits - 1))
    v = (digits_u32 & m).astype(np.int64)
    v = v - 2 * (digits_u32 & top).astype(np.int64)
    return v.astype(np.int32)


# ---------------------------------------------------------------------------
# L3: LWE (src/lwe.rs)
# ---------------------------------------------------------------------------


def lwe_encode(m, params: LweParams | GlweParams | TfheParams) -> np.ndarray:
    """m << (log_q - log_p - padding_bits) (src/lwe.rs:83-88)."""
    shift = params.log_q - (params.log_p + params.padding_bits)
    m = _u(m)
    assert np.all(m < (1 << params.log_p))
    return (m << np.uint32(shift)).astype(np.uint32)


def lwe_decode(pt, params: LweParams | GlweParams | TfheParams) -> np.ndarray:
    """Rounding decode: round(pt / Delta) mod 2^(log_p+padding).

    DIVERGENCE from the reference (src/lwe.rs:102-108), which truncates with no
    rounding and only works because its noise sampler saturates negative noise
    to 0 (Rust ``as u32``).  With symmetric noise the standard rounding decode
    is required; ciphertext-level semantics are unchanged.
    """
    shift = params.log_q - (params.log_p + params.padding_bits)
    half = np.uint32(1 << (shift - 1))
    # mask mod 2^log_p (NOT log_p+padding): the test-vector negate-rotate trick
    # stores p-v in wrap-prone coefficients so that a negative blind-rotation
    # index yields -(p-v) == v (mod p) -- the padding-bit alias is legitimate
    # (the reference's commented-out mask, src/lwe.rs:105, is required)
    mask = np.uint32((1 << params.log_p) - 1)
    return (((_u(pt) + half) >> np.uint32(shift)) & mask).astype(np.uint32)


def encrypt_lwe(
    sk: np.ndarray, pt: np.ndarray, a: np.ndarray, e: np.ndarray
) -> np.ndarray:
    """LWE ciphertext (a, <a,s>+e+pt) with explicit mask/noise (src/lwe.rs:138-160)."""
    sk = _u(sk)
    a = _u(a)
    b = (_u(sk @ a) + _u(e) + _u(pt)).astype(np.uint32)
    return np.concatenate([a, np.atleast_1d(b)]).astype(np.uint32)


def decrypt_lwe(sk: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """b - <a,s> (src/lwe.rs:162-173)."""
    sk = _u(sk)
    ct = _u(ct)
    return (ct[-1] - _u(sk @ ct[:-1])).astype(np.uint32)


def lwe_add(c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
    return (_u(c0) + _u(c1)).astype(np.uint32)


def lwe_scalar_mul(c: np.ndarray, scalar: int) -> np.ndarray:
    return (_u(c) * np.uint32(scalar)).astype(np.uint32)


# ---------------------------------------------------------------------------
# L3: GLWE (src/glwe.rs)
# ---------------------------------------------------------------------------


def glwe_encode(message: np.ndarray, params: GlweParams) -> np.ndarray:
    """Per-coefficient encode, zero-padded to degree N (src/glwe.rs:140-152)."""
    message = _u(message)
    data = np.zeros(params.degree, dtype=np.uint32)
    shift = params.log_q - (params.log_p + params.padding_bits)
    assert np.all(message < (1 << params.log_p))
    data[: message.shape[0]] = message << np.uint32(shift)
    return data


def glwe_decode(pt: np.ndarray, params: GlweParams) -> np.ndarray:
    """Rounding decode per coefficient (see lwe_decode for the rationale)."""
    shift = params.log_q - (params.log_p + params.padding_bits)
    half = np.uint32(1 << (shift - 1))
    # mask mod 2^log_p (NOT log_p+padding): the test-vector negate-rotate trick
    # stores p-v in wrap-prone coefficients so that a negative blind-rotation
    # index yields -(p-v) == v (mod p) -- the padding-bit alias is legitimate
    # (the reference's commented-out mask, src/lwe.rs:105, is required)
    mask = np.uint32((1 << params.log_p) - 1)
    return (((_u(pt) + half) >> np.uint32(shift)) & mask).astype(np.uint32)


def encrypt_glwe_zero(sk: np.ndarray, a: np.ndarray, e: np.ndarray) -> np.ndarray:
    """GLWE(0): rows (a_0..a_{k-1}, sum a_i*s_i + e) (src/glwe.rs:190-209)."""
    a = _u(a)  # (k, N)
    b = poly_dot_product(a, _u(sk)) + _u(e)
    return np.concatenate([a, b[None, :]], axis=0).astype(np.uint32)


def encrypt_glwe(
    sk: np.ndarray, pt: np.ndarray, a: np.ndarray, e: np.ndarray
) -> np.ndarray:
    """GLWE(pt): zero encryption + pt on the b row (src/glwe.rs:211-230)."""
    ct = encrypt_glwe_zero(sk, a, e)
    ct[-1] = ct[-1] + _u(pt)
    return ct


def trivial_encrypt_glwe(pt: np.ndarray, params: GlweParams) -> np.ndarray:
    """Zero mask, b = pt (src/glwe.rs:232-243)."""
    data = np.zeros((params.glwe_dimension + 1, params.degree), dtype=np.uint32)
    data[-1] = _u(pt)
    return data


def decrypt_glwe(sk: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """b - sum a_i*s_i (src/glwe.rs:245-265)."""
    ct = _u(ct)
    a_s = poly_dot_product(ct[:-1], _u(sk))
    return (ct[-1] - a_s).astype(np.uint32)


def glwe_mul_monomial(ct: np.ndarray, index: int) -> np.ndarray:
    """Row-wise monomial multiplication (src/glwe.rs:20-34)."""
    return np.stack([poly_mul_monomial(row, index) for row in _u(ct)], axis=0)


def decompose_glwe(ct: np.ndarray, p: DecomposerParams) -> np.ndarray:
    """(k+1, N) -> ((k+1)*levels, N): per-poly, levels-major (src/glwe.rs:69-108).

    Row (i*levels + j) holds level-j digits of polynomial i (digits MSB-first).
    """
    ct = _u(ct)
    digs = decompose(ct, p)  # (k+1, N, levels)
    digs = np.moveaxis(digs, -1, 1)  # (k+1, levels, N)
    return digs.reshape(-1, ct.shape[-1])


# ---------------------------------------------------------------------------
# L3/L4: GGSW, external product, CMUX (src/ggsw.rs)
# ---------------------------------------------------------------------------


def encrypt_ggsw(
    sk: np.ndarray,
    message: int,
    tfhe: TfheParams,
    a: np.ndarray,
    e: np.ndarray,
) -> np.ndarray:
    """GGSW((k+1)*l, k+1, N) from explicit randomness (src/ggsw.rs:76-130).

    ``a``: ((k+1)*levels, k, N) masks, ``e``: ((k+1)*levels, N) noise.
    Row (i*levels + j) = GLWE(0) + m*B^(l_full-j-1) on the constant coeff of
    polynomial i.
    """
    dp = tfhe.pbs_decomposer
    k = tfhe.glwe_dimension
    levels = dp.levels
    rows = []
    for i in range(k + 1):
        for j in range(levels):
            r = i * levels + j
            row = encrypt_glwe_zero(sk, a[r], e[r])
            if message != 0:
                factor = (message << (dp.log_base * (dp.l_full - (j + 1)))) & MASK32
                row[i, 0] = row[i, 0] + np.uint32(factor)
            rows.append(row)
    return np.stack(rows, axis=0).astype(np.uint32)


def external_product(
    ggsw: np.ndarray, glwe: np.ndarray, tfhe: TfheParams
) -> np.ndarray:
    """GGSW(m2) * GLWE(m1) -> GLWE(m1*m2) (src/ggsw.rs:132-161)."""
    dp = tfhe.pbs_decomposer
    dec = decompose_glwe(_u(glwe), dp)  # ((k+1)l, N)
    k = tfhe.glwe_dimension
    out = []
    for col in range(k + 1):
        out.append(poly_dot_product(dec, _u(ggsw)[:, col, :]))
    return np.stack(out, axis=0).astype(np.uint32)


def cmux(
    ggsw: np.ndarray, c0: np.ndarray, c1: np.ndarray, tfhe: TfheParams
) -> np.ndarray:
    """b ? c1 : c0 = EP(b, c1-c0) + c0 (src/ggsw.rs:164-178), pure-functional."""
    diff = (_u(c1) - _u(c0)).astype(np.uint32)
    return (external_product(ggsw, diff, tfhe) + _u(c0)).astype(np.uint32)


# ---------------------------------------------------------------------------
# L4: key switching (src/key_switching.rs)
# ---------------------------------------------------------------------------


def generate_ksk(
    from_sk: np.ndarray,
    to_sk: np.ndarray,
    to_n: int,
    ks: DecomposerParams,
    a: np.ndarray,
    e: np.ndarray,
) -> np.ndarray:
    """KSK (from_n*levels, to_n+1); row s_idx*levels+j = LWE_to(s_idx * B^(l_full-j-1))
    (src/key_switching.rs:20-60).  ``a``: (from_n*levels, to_n), ``e``: (from_n*levels,).
    """
    from_n = from_sk.shape[0]
    rows = np.zeros((from_n * ks.levels, to_n + 1), dtype=np.uint32)
    for s_index in range(from_n):
        for j in range(ks.levels):
            factor = (int(from_sk[s_index]) << (ks.log_base * (ks.l_full - (j + 1)))) & MASK32
            r = s_index * ks.levels + j
            row = encrypt_lwe(to_sk, np.uint32(0), a[r], e[r])
            row[-1] = row[-1] + np.uint32(factor)
            rows[r] = row
    return rows


def key_switch_lwe(
    ct: np.ndarray, from_n: int, to_n: int, ks: DecomposerParams, ksk: np.ndarray
) -> np.ndarray:
    """Digit-decompose the mask, matvec against KSK rows (src/key_switching.rs:63-103)."""
    ct = _u(ct)
    digits = decompose(ct[:from_n], ks).reshape(-1)  # (from_n*levels,) MSB-first
    ksk = _u(ksk)
    # sum_ij a_ij * ksk_row_ij, wrapping
    summ = (digits[:, None] * ksk).sum(axis=0, dtype=np.uint32)
    out = (-summ.astype(np.int64)).astype(np.uint32)
    out[-1] = out[-1] + ct[from_n]
    return out


# ---------------------------------------------------------------------------
# L5: test vectors (src/test_vector.rs)
# ---------------------------------------------------------------------------


def construct_test_from_lut(tfhe: TfheParams, lut) -> np.ndarray:
    """LUT (len 2^log_p) -> test-vector polynomial, with half-block negate-rotate
    (src/test_vector.rs:38-67)."""
    p_mod = 1 << tfhe.log_p
    lut = list(lut)
    assert len(lut) == p_mod
    repetition = tfhe.degree // p_mod
    tv = np.repeat(np.asarray(lut, dtype=np.uint32), repetition)
    half = repetition // 2
    head = tv[:half].copy()
    nz = head != 0
    head[nz] = np.uint32(p_mod) - head[nz]
    tv[:half] = head
    return np.roll(tv, -half)


def construct_test_vector_boolean(tfhe: TfheParams, f) -> np.ndarray:
    """Gate LUT: input i -> f(bit1(i), bit0(i)) (src/test_vector.rs:5-20)."""
    return construct_test_from_lut(
        tfhe, [f((i >> 1) & 1, i & 1) for i in range(1 << tfhe.log_p)]
    )


def construct_identity_test_vector(tfhe: TfheParams) -> np.ndarray:
    """Identity LUT (src/test_vector.rs:23-35)."""
    return construct_test_from_lut(tfhe, list(range(1 << tfhe.log_p)))


# ---------------------------------------------------------------------------
# L5: bootstrapping (src/bootstrapping.rs)
# ---------------------------------------------------------------------------


def sample_extract(glwe_ct: np.ndarray, params: GlweParams, sample_index: int = 0):
    """GLWE coeff -> LWE of dimension k*N (src/bootstrapping.rs:122-156)."""
    ct = _u(glwe_ct)
    n = params.degree
    assert sample_index < n
    lwe_b = ct[-1, sample_index]
    parts = []
    for poly in ct[:-1]:
        fwd = poly[: sample_index + 1][::-1]
        wrap = (-poly[sample_index + 1 :][::-1].astype(np.int64)).astype(np.uint32)
        parts.extend([fwd, wrap])
    a = np.concatenate(parts)
    return np.concatenate([a, np.atleast_1d(lwe_b)]).astype(np.uint32)


def blind_rotate(
    lwe_ct: np.ndarray,
    bk_ggsw: np.ndarray,
    test_vector_poly: np.ndarray,
    tfhe: TfheParams,
) -> np.ndarray:
    """Modulus-switch + n-step CMUX loop; returns accumulator GLWE
    (src/bootstrapping.rs:58-105)."""
    glwe_params = tfhe.glwe_params()
    approx = switch_modulus(_u(lwe_ct), tfhe.log_q, tfhe.log_degree + 1)
    v_x = trivial_encrypt_glwe(
        glwe_encode(test_vector_poly, glwe_params), glwe_params
    )
    acc = glwe_mul_monomial(v_x, -int(approx[tfhe.lwe_dimension]))
    for i in range(tfhe.lwe_dimension):
        c1 = glwe_mul_monomial(acc, int(approx[i]))
        acc = cmux(bk_ggsw[i], acc, c1, tfhe)
    return acc


def blind_rotate_in_clear(
    lwe_ct: np.ndarray,
    lwe_sk: np.ndarray,
    test_vector_poly: np.ndarray,
    tfhe: TfheParams,
) -> np.ndarray:
    """Plaintext simulation of the blind rotation (src/bootstrapping.rs:232-287).

    Re-runs the rotation IN CLEAR with the secret key: tracks the accumulated
    monomial index -b_hat + sum(a_hat_i * s_i) mod 2N explicitly, then applies
    it as one monomial rotation of the encoded test vector.  The homomorphic
    accumulator must decrypt to exactly this polynomial plus bounded noise —
    a transparent oracle that pinpoints sign/index bugs in the rotation
    instead of surfacing them as opaque decode failures.
    """
    glwe_params = tfhe.glwe_params()
    approx = switch_modulus(_u(lwe_ct), tfhe.log_q, tfhe.log_degree + 1)
    two_n = 2 * glwe_params.degree
    index = -int(approx[tfhe.lwe_dimension]) % two_n
    for i in range(tfhe.lwe_dimension):
        if int(lwe_sk[i]) == 1:
            index = (index + int(approx[i])) % two_n
    v = glwe_encode(_u(test_vector_poly), glwe_params)
    return poly_mul_monomial(v, index)


def bootstrap(
    lwe_ct: np.ndarray,
    bk_ggsw: np.ndarray,
    ksk: np.ndarray,
    test_vector_poly: np.ndarray,
    tfhe: TfheParams,
) -> np.ndarray:
    """Full PBS: blind rotate -> sample extract -> key switch
    (src/bootstrapping.rs:58-120)."""
    acc = blind_rotate(lwe_ct, bk_ggsw, test_vector_poly, tfhe)
    extracted = sample_extract(acc, tfhe.glwe_params(), 0)
    return key_switch_lwe(
        extracted,
        tfhe.lwe_params_post_pbs().lwe_dimension,
        tfhe.lwe_dimension,
        tfhe.ks_decomposer,
        ksk,
    )


# ---------------------------------------------------------------------------
# Key generation with explicit randomness (for the harness)
# ---------------------------------------------------------------------------


def flatten_glwe_sk(glwe_sk: np.ndarray) -> np.ndarray:
    """GlweSecretKey (k, N) -> LweSecretKey (k*N) (src/lwe.rs:62-73)."""
    return _u(glwe_sk).reshape(-1)


def bootstrapping_key_gen(
    lwe_sk: np.ndarray,
    glwe_sk: np.ndarray,
    tfhe: TfheParams,
    bk_a: np.ndarray,
    bk_e: np.ndarray,
    ksk_a: np.ndarray,
    ksk_e: np.ndarray,
):
    """BK = n GGSW(s_i) + KSK(kN -> n) (src/bootstrapping.rs:23-56).

    bk_a: (n, (k+1)l, k, N), bk_e: (n, (k+1)l, N),
    ksk_a: (kN*l_ks, n), ksk_e: (kN*l_ks,).
    Returns (bk_ggsw (n, (k+1)l, k+1, N), ksk (kN*l_ks, n+1)).
    """
    n = tfhe.lwe_dimension
    bk = np.stack(
        [
            encrypt_ggsw(glwe_sk, int(lwe_sk[i]), tfhe, bk_a[i], bk_e[i])
            for i in range(n)
        ],
        axis=0,
    )
    ksk = generate_ksk(
        flatten_glwe_sk(glwe_sk), lwe_sk, n, tfhe.ks_decomposer, ksk_a, ksk_e
    )
    return bk, ksk


# ---------------------------------------------------------------------------
# L6: boolean gates (src/boolean.rs)
# ---------------------------------------------------------------------------

GATE_FNS = {
    "and": lambda l, r: l & r,
    "or": lambda l, r: l | r,
    "xor": lambda l, r: l ^ r,
    "nand": lambda l, r: 1 - (l & r),
    "nor": lambda l, r: 1 - (l | r),
    "xnor": lambda l, r: 1 - (l ^ r),
}


def gate(
    name: str,
    ct0: np.ndarray,
    ct1: np.ndarray,
    bk_ggsw: np.ndarray,
    ksk: np.ndarray,
    tfhe: TfheParams,
) -> np.ndarray:
    """2-input gate: ct_in = 2*ct1 + ct0, one PBS with the gate LUT
    (src/boolean.rs:9-53, generalized to the full suite)."""
    tv = construct_test_vector_boolean(tfhe, GATE_FNS[name])
    ct_in = lwe_add(lwe_scalar_mul(ct1, 2), ct0)
    return bootstrap(ct_in, bk_ggsw, ksk, tv, tfhe)
