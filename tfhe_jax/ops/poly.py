"""Negacyclic polynomial ops in Z_{2^32}[X]/(X^N+1) — the hot kernels.

The reference multiplies polynomials via an O(N^2) sign-twisted Toeplitz
matvec in u32 (src/utils.rs:113-160).  This build keeps the O(N^2)
*algorithm* (N=512 is small) but maps it onto exact int8 matrix products:

  * every TFHE product has one *small* operand — gadget-decomposed digits
    (|d| <= B), binary secret bits, or monomials — so the small side rides
    int8 natively;
  * the u32 side splits into 4 balanced signed 8-bit limbs (ops/torus.py),
    giving exact int8 x int8 -> int32 contractions, recombined with
    wrapping shifts.

Two equivalent formulations of the external-product contraction are provided
(selected at model level; both exact, benchmarked against each other):

  * ``ep_contract_conv``  — negacyclic convolution as one
    ``lax.conv_general_dilated`` (digits extended to [-d, d], keys stored
    kernel-reversed).  CPU only: XLA's GPU backend hands convolutions to
    cuDNN, which has no s8 x s8 -> s32 convolution;
  * ``ep_contract_matmul`` — explicit on-the-fly Toeplitz expansion of the key
    side followed by a single [B, R*N] @ [R*N, C*L*N] matmul.

Monomial multiplication (src/utils.rs:183-207) is a per-sample gather with a
negacyclic sign mask — data-dependent rotation amounts vectorize over the
batch, unlike the reference's scalar rotate.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tfhe_jax.ops.torus import combine_limb_accs, to_signed_limbs

NUM_LIMBS = 4


# ---------------------------------------------------------------------------
# monomial multiplication
# ---------------------------------------------------------------------------


def monomial_mul(poly, exp) -> jnp.ndarray:
    """poly(X) * X^exp with negacyclic wraparound (src/utils.rs:183-207).

    ``poly``: u32[..., N]; ``exp``: int32 broadcastable to poly.shape[:-1]
    (may be negative; reduced mod 2N).  Implemented as a log2(2N)-stage barrel
    shifter: each stage applies a STATIC negacyclic roll (concat/slice)
    selected by one bit of the per-sample exponent.  Negacyclic rotations
    compose (X^a * X^b = X^(a+b)), so the staged form is exact, and every
    stage is a fusible elementwise select instead of a data-dependent gather.
    """
    poly = jnp.asarray(poly, jnp.uint32)
    n = poly.shape[-1]
    assert n & (n - 1) == 0, "degree must be a power of two"
    e = jnp.mod(jnp.asarray(exp, jnp.int32), 2 * n)  # [...] in [0, 2N)
    out = poly
    coeff = jnp.arange(n)
    bits = (2 * n - 1).bit_length()  # log2(2N)
    for k in range(bits):
        s = 1 << k
        if s >= n:
            rolled = -out  # X^N == -1
        else:
            r = jnp.roll(out, s, axis=-1)
            rolled = jnp.where(coeff < s, -r, r)
        take_bit = ((e >> k) & 1)[..., None] == 1
        out = jnp.where(take_bit, rolled, out)
    return out


def monomial_mul_custom_mod(poly, exp, log_modulus: int) -> jnp.ndarray:
    """``monomial_mul`` with coefficients reduced mod 2^log_modulus
    (src/utils.rs:209-219: poly_mul_monomial_custom_mod).

    The reference uses this for index arithmetic on already-mod-switched
    values (the clear-simulation oracle, src/bootstrapping.rs:232-287); the
    JAX pipeline's mod-switch covers its one call site, so this exists for
    API parity and as a building block for custom-modulus experiments.
    """
    out = monomial_mul(poly, exp)
    if log_modulus < 32:
        out = out & jnp.uint32((1 << log_modulus) - 1)
    return out


# ---------------------------------------------------------------------------
# Toeplitz helpers
# ---------------------------------------------------------------------------


def sign_toeplitz_u32(p_u32) -> jnp.ndarray:
    """u32 poly [..., N] -> u32[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N].

    Negation happens in u32 (wrapping, exact) BEFORE any limb split: the
    balanced int8 limb -128 cannot be negated in int8.
    """
    p = jnp.asarray(p_u32, jnp.uint32)
    n = p.shape[-1]
    m = jnp.arange(n)[:, None]
    o = jnp.arange(n)[None, :]
    t = p[..., (o - m) % n]
    return jnp.where(m <= o, t, -t)


def sign_toeplitz_small(p_small) -> jnp.ndarray:
    """Small-int poly [..., N] -> int8[..., N(m), N(o)] with T[m,o] = +-p[(o-m)%N].

    (T^T is the reference's `teoplitz`, src/utils.rs:113-153; we lay it out
    contraction-major so ``a[..., m] @ T[m, o]`` is the negacyclic product.)
    """
    p = jnp.asarray(p_small, jnp.int8)
    n = p.shape[-1]
    m = jnp.arange(n)[:, None]
    o = jnp.arange(n)[None, :]
    t = p[..., (o - m) % n]
    return jnp.where(m <= o, t, (-t.astype(jnp.int8))).astype(jnp.int8)


def negacyclic_matvec_u32_small(a_u32, t_small) -> jnp.ndarray:
    """Exact wrapping contraction a[..., K] x T[K, N] -> u32[..., N].

    ``a`` full u32 (limb-split), ``T`` small signed int8 (e.g. stacked
    sign-Toeplitz blocks of binary secret polynomials).  Used for
    poly_dot_product against secret keys (src/utils.rs:163-173) in keygen and
    decryption.
    """
    limbs = jnp.moveaxis(to_signed_limbs(a_u32), -1, -2)  # [..., 4, K]
    acc = jnp.matmul(limbs, t_small.astype(jnp.int8), preferred_element_type=jnp.int32)
    return combine_limb_accs(jnp.moveaxis(acc, -2, -1))  # [..., N]


def poly_mul_u32(a, b) -> jnp.ndarray:
    """General exact u32 negacyclic product (API parity with src/utils.rs:155-160).

    Both operands full u32: 4x4 signed-limb products keeping i+j<4 (mod 2^32).
    Not on any hot path (TFHE products always have a small side); used for
    tests and completeness.
    """
    a = jnp.asarray(a, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    la = to_signed_limbs(a)  # [..., N, 4]
    # sign-twist in u32 first (negating the int8 limb -128 would wrap), then split
    tb = to_signed_limbs(sign_toeplitz_u32(b))  # [..., N, N, 4]
    res = jnp.zeros(a.shape, jnp.uint32)
    for j in range(NUM_LIMBS):
        t = tb[..., j]  # [..., N(m), N(o)] int8
        for i in range(NUM_LIMBS - j):
            acc = jnp.matmul(
                la[..., None, :, i].astype(jnp.int8),
                t,
                preferred_element_type=jnp.int32,
            )[..., 0, :]
            res = res + (acc.astype(jnp.uint32) << jnp.uint32(8 * (i + j)))
    return res


# ---------------------------------------------------------------------------
# external-product contraction kernels
# ---------------------------------------------------------------------------


def negacyclic_extend(d) -> jnp.ndarray:
    """[..., N] -> [..., 2N] = concat([-d, d]): negacyclic conv becomes VALID conv."""
    return jnp.concatenate([-d, d], axis=-1)


def bk_to_conv_kernel(bk_u32) -> jnp.ndarray:
    """GGSW u32[..., R, C, N] -> conv-ready int8[..., C*4, R, N] (kernel-reversed).

    Out-channel layout: column-major then limb (f = c*4 + limb).  Stored once at
    key generation; the per-step contraction then needs no key preprocessing.
    """
    limbs = to_signed_limbs(bk_u32)  # [..., R, C, N, L]
    return jnp.flip(bk_u32_limbs_to_ocin(limbs), axis=-1)


def bk_u32_limbs_to_ocin(limbs) -> jnp.ndarray:
    """[..., R, C, N, L] -> [..., C*L, R, N]"""
    x = jnp.moveaxis(limbs, -1, -3)  # [..., R, L, C, N]
    x = jnp.swapaxes(x, -4, -2)  # [..., C, L, R, N]
    shape = x.shape[:-4] + (x.shape[-4] * x.shape[-3],) + x.shape[-2:]
    return x.reshape(shape).astype(jnp.int8)


def ep_contract_conv(digits_i8, bk_kernel_i8) -> jnp.ndarray:
    """Negacyclic contraction via one int8 convolution.

    digits: int8[B, R, N] (decomposed GLWE rows), bk_kernel: int8[F=C*4, R, N]
    (from ``bk_to_conv_kernel``).  Returns int32[B, F, N] exact limb
    accumulators: out[b,f,o] = sum_{r,m} digits[b,r,m] * g[r,f,(o-m)%N] * sign.
    """
    lhs = negacyclic_extend(digits_i8)  # [B, R, 2N]
    n = digits_i8.shape[-1]
    out = lax.conv_general_dilated(
        lhs,
        bk_kernel_i8,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.int32,
    )  # [B, F, N+1]
    return out[..., 1 : n + 1]


def bk_to_matmul_w(bk_u32) -> jnp.ndarray:
    """GGSW u32[R, C, N] -> on-the-fly Toeplitz weights int8[R*N(m), C*4*N(o)].

    W[(r,m),(c,l,o)] = limb_l( +-g[r,c,(o-m)%N] ), with the negacyclic sign
    applied in u32 BEFORE the limb split (the int8 limb -128 cannot be
    negated post-split).  Column layout (c, limb, o) matches ``ep_combine``.
    """
    t = sign_toeplitz_u32(bk_u32)  # [R, C, N(m), N(o)] u32
    limbs = to_signed_limbs(t)  # [R, C, m, o, L]
    limbs = jnp.moveaxis(limbs, -1, -2)  # [R, C, m, L, o]
    limbs = jnp.swapaxes(limbs, 1, 2)  # [R, m, C, L, o]
    r, c, n = bk_u32.shape
    return limbs.reshape(r * n, c * NUM_LIMBS * n)


def ep_contract_matmul(digits_i8, bk_u32) -> jnp.ndarray:
    """Same contraction as ``ep_contract_conv`` via explicit Toeplitz matmul.

    ``bk_u32``: u32[R, C, N] canonical GGSW layout; the Toeplitz expansion is
    materialized per call (per blind-rotation step) and shared across the batch.
    """
    b = digits_i8.shape[0]
    r, n = digits_i8.shape[-2:]
    w = bk_to_matmul_w(bk_u32)  # [R*N, C*4*N]
    flat = digits_i8.reshape(b, r * n)
    acc = jnp.matmul(flat, w, preferred_element_type=jnp.int32)  # [B, C*4*N]
    return acc.reshape(b, -1, n)


def sign_toeplitz_u32_cols(p_u32, o_start, n_cols: int) -> jnp.ndarray:
    """Column slice of ``sign_toeplitz_u32``: T[m, oo] = +-p[(o-m)%N] for
    o = o_start+oo, oo in [0, n_cols).  ``o_start`` may be traced (it is the
    shard offset in the coefficient-sharded external product)."""
    p = jnp.asarray(p_u32, jnp.uint32)
    n = p.shape[-1]
    m = jnp.arange(n)[:, None]
    o = jnp.asarray(o_start, jnp.int32) + jnp.arange(n_cols, dtype=jnp.int32)[None, :]
    t = jnp.take(p, (o - m) % n, axis=-1)
    return jnp.where(m <= o, t, -t)


def bk_to_matmul_w_cols(bk_u32, o_start, n_cols: int) -> jnp.ndarray:
    """Column-sliced Toeplitz weights int8[R*N(m), C*4*n_cols(o)] — the local
    shard of ``bk_to_matmul_w`` for output coefficients [o_start, o_start+n_cols).
    Needs the FULL key rows (every output coefficient touches every input
    coefficient of g), so the key stays replicated and only compute shards."""
    t = sign_toeplitz_u32_cols(bk_u32, o_start, n_cols)  # [R, C, N(m), cols]
    limbs = to_signed_limbs(t)  # [R, C, m, cols, L]
    limbs = jnp.moveaxis(limbs, -1, -2)  # [R, C, m, L, cols]
    limbs = jnp.swapaxes(limbs, 1, 2)  # [R, m, C, L, cols]
    r, c, n = bk_u32.shape
    return limbs.reshape(r * n, c * NUM_LIMBS * n_cols)


def ep_contract_matmul_cols(digits_i8, bk_u32, o_start, n_cols: int) -> jnp.ndarray:
    """Coefficient shard of ``ep_contract_matmul``: int32[B, C*4, n_cols]
    limb accumulators for output coefficients [o_start, o_start+n_cols)."""
    b = digits_i8.shape[0]
    r, n = digits_i8.shape[-2:]
    w = bk_to_matmul_w_cols(bk_u32, o_start, n_cols)
    flat = digits_i8.reshape(b, r * n)
    acc = jnp.matmul(flat, w, preferred_element_type=jnp.int32)
    return acc.reshape(b, -1, n_cols)


def ep_combine(acc_i32, k_plus_1: int) -> jnp.ndarray:
    """int32[B, C*4, N] limb accumulators -> u32[B, C, N] wrapping GLWE delta."""
    b, f, n = acc_i32.shape
    accs = acc_i32.reshape(b, k_plus_1, NUM_LIMBS, n)
    accs = jnp.moveaxis(accs, -2, -1)  # [B, C, N, 4]
    return combine_limb_accs(accs)
