"""Torus Z_{2^32} primitives as JAX ops.

All ciphertext arithmetic is wrapping mod q = 2^32 on ``jnp.uint32`` tensors
(the reference's "discretised torus" representation, notes/TFHE.md:24-28).
The helpers here are the exact-integer building blocks shared by every layer:
encode/decode, modulus switching (reference: src/utils.rs:13-33), and the
signed 8-bit limb split that lets u32 contractions run exactly as int8
matmuls with int32 accumulation.
"""

from __future__ import annotations

import jax.numpy as jnp

MASK32 = 0xFFFFFFFF
#: number of 8-bit limbs in a u32
NUM_LIMBS = 4
#: adds +128 at every limb position; balanced-limb split offset
_LIMB_BIAS = 0x80808080


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint32)


def encode(m, log_q: int, log_p: int, padding_bits: int) -> jnp.ndarray:
    """Cleartext -> plaintext: m << (log_q - log_p - padding) (src/lwe.rs:83-88)."""
    shift = log_q - (log_p + padding_bits)
    return (u32(m) << jnp.uint32(shift)).astype(jnp.uint32)


def decode(pt, log_q: int, log_p: int, padding_bits: int) -> jnp.ndarray:
    """Rounding decode: round(pt/Delta) mod 2^(log_p+padding).

    Divergence from src/lwe.rs:102-108 (truncation): see golden model notes —
    the reference decode only works with its one-sided noise quirk.
    """
    shift = log_q - (log_p + padding_bits)
    half = jnp.uint32(1 << (shift - 1))
    # mod 2^log_p: negative blind-rotation indices legitimately alias the
    # padding bit (test-vector negate-rotate trick, src/test_vector.rs:54-64)
    mask = jnp.uint32((1 << log_p) - 1)
    return (((u32(pt) + half) >> jnp.uint32(shift)) & mask).astype(jnp.uint32)


def switch_modulus(values, log_from: int, log_to: int) -> jnp.ndarray:
    """round(2^log_to * v / 2^log_from) mod 2^log_to, overflow-free round-half-up
    (src/utils.rs:13-33)."""
    v = u32(values)
    shift = log_from - log_to
    d_half = jnp.uint32(1 << (shift - 1))
    low_mask = jnp.uint32((1 << shift) - 1)
    rounded = (v >> jnp.uint32(shift)) + (((v & low_mask) + d_half) >> jnp.uint32(shift))
    return (rounded & jnp.uint32((1 << log_to) - 1)).astype(jnp.uint32)


def to_signed_limbs(x) -> jnp.ndarray:
    """u32[...] -> int8[..., 4] balanced limbs: x == sum(limb_i * 2^(8i)) mod 2^32.

    Balanced representation (limbs in [-128, 128)) keeps int8 products and
    their int32 accumulations small and exact.
    """
    t = u32(x) + jnp.uint32(_LIMB_BIAS)
    shifts = jnp.arange(NUM_LIMBS, dtype=jnp.uint32) * jnp.uint32(8)
    ulimbs = (t[..., None] >> shifts) & jnp.uint32(0xFF)
    return (ulimbs.astype(jnp.int32) - 128).astype(jnp.int8)


def combine_limb_accs(accs_i32) -> jnp.ndarray:
    """int32[..., 4] limb accumulators -> u32[...], wrapping: sum(acc_i << 8i)."""
    accs_u = accs_i32.astype(jnp.uint32)  # two's-complement wrap
    shifts = jnp.arange(NUM_LIMBS, dtype=jnp.uint32) * jnp.uint32(8)
    return (accs_u << shifts).sum(axis=-1, dtype=jnp.uint32)


def wrapping_matvec_u32_small(a_u32, w_small_i8) -> jnp.ndarray:
    """Exact wrapping u32 contraction  a[..., K] @ w[K, M] -> u32[..., M].

    ``a`` is full u32 (split into signed limbs); ``w`` holds small signed
    integers (secret bits / Toeplitz-of-binary entries, |w| <= 127).  Products
    accumulate exactly in int32 provided K * 128 * max|w| < 2^31.
    """
    limbs = to_signed_limbs(a_u32)  # [..., K, 4]
    limbs = jnp.moveaxis(limbs, -1, -2)  # [..., 4, K]
    acc = jnp.matmul(limbs, w_small_i8.astype(jnp.int8), preferred_element_type=jnp.int32)
    # [..., 4, M] -> combine limb axis
    return combine_limb_accs(jnp.moveaxis(acc, -2, -1))
