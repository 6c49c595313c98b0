"""GLWE (RLWE) over Z_{2^32}[X]/(X^N+1) (reference: src/glwe.rs) — batched.

Ciphertext: u32[..., k+1, N], rows a_0..a_{k-1}, b.  The secret key is kept in
two forms: raw bits u32[k, N] and a precomputed stacked sign-Toeplitz int8
matrix [k*N, N] that turns every a.s polynomial dot product
(src/utils.rs:163-173) into one exact int8 matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

from tfhe_jax.ops.decomposer import decompose_signed
from tfhe_jax.ops.poly import monomial_mul, negacyclic_matvec_u32_small, sign_toeplitz_small
from tfhe_jax.ops.torus import u32
from tfhe_jax.params import DecomposerParams


def sk_toeplitz(glwe_sk) -> jnp.ndarray:
    """u32[k, N] binary key -> int8[k*N, N] stacked sign-Toeplitz blocks."""
    t = sign_toeplitz_small(jnp.asarray(glwe_sk, jnp.int8))  # [k, N, N]
    k, n = glwe_sk.shape
    return t.reshape(k * n, n)


def encrypt_zero(sk_t, a, e) -> jnp.ndarray:
    """GLWE(0) = (a, sum a_i*s_i + e) (src/glwe.rs:190-209).

    a: u32[..., k, N]; e: u32[..., N]; sk_t from ``sk_toeplitz``.
    """
    a = u32(a)
    kn = a.shape[-2] * a.shape[-1]
    b = negacyclic_matvec_u32_small(a.reshape(a.shape[:-2] + (kn,)), sk_t) + u32(e)
    return jnp.concatenate([a, b[..., None, :]], axis=-2)


def encrypt(sk_t, pt, a, e) -> jnp.ndarray:
    """GLWE(pt): zero encryption + pt on the b row (src/glwe.rs:211-230)."""
    ct = encrypt_zero(sk_t, a, e)
    return ct.at[..., -1, :].add(u32(pt))


def trivial_encrypt(pt, glwe_dimension: int) -> jnp.ndarray:
    """(0,...,0, pt) (src/glwe.rs:232-243); pt: u32[..., N]."""
    pt = u32(pt)
    zeros = jnp.zeros(pt.shape[:-1] + (glwe_dimension, pt.shape[-1]), jnp.uint32)
    return jnp.concatenate([zeros, pt[..., None, :]], axis=-2)


def decrypt(sk_t, ct) -> jnp.ndarray:
    """b - sum a_i*s_i (src/glwe.rs:245-265)."""
    ct = u32(ct)
    a = ct[..., :-1, :]
    kn = a.shape[-2] * a.shape[-1]
    a_s = negacyclic_matvec_u32_small(a.reshape(a.shape[:-2] + (kn,)), sk_t)
    return ct[..., -1, :] - a_s


def mul_monomial(ct, exp) -> jnp.ndarray:
    """Row-wise X^exp multiplication (src/glwe.rs:16-34); exp broadcastable to
    ct.shape[:-2] (per-sample exponents)."""
    e = jnp.asarray(exp, jnp.int32)
    return monomial_mul(u32(ct), e[..., None])


def decompose(ct, dp: DecomposerParams) -> jnp.ndarray:
    """(.., k+1, N) -> int8(.., (k+1)*levels, N), row = poly*levels + level
    (MSB-first), matching src/glwe.rs:69-108's layout as one fused reshape."""
    digs = decompose_signed(u32(ct), dp)  # [..., k+1, N, levels]
    digs = jnp.moveaxis(digs, -1, -2)  # [..., k+1, levels, N]
    shape = digs.shape[:-3] + (digs.shape[-3] * digs.shape[-2], digs.shape[-1])
    return digs.reshape(shape)
