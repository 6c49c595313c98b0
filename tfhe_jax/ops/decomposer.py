"""Vectorized signed gadget decomposition (reference: src/decomposer.rs).

The reference decomposes one scalar at a time with an explicit carry loop
(src/decomposer.rs:42-80).  Here the same *exact* carry chain runs unrolled
over ``log_q/log_base`` positions as elementwise ops on whole ciphertext
tensors at once.  It deliberately does NOT use the closed-form balanced-digit
trick (value + 0x888...8): the reference's carry rule emits an anomalous
digit +B when digit B-1 meets an incoming carry (res = B escapes recentering
because ``res & B/2 == 0``), and the closed form diverges bit-wise from it
even though both recompose identically.  Bit-exactness to the reference
wins; the chain costs ~9 cheap vector ops per level.

Digits therefore lie in {-B/2 .. B/2-1} union {B} and always fit int8 for the
int8 contractions (params assert base <= 64).
"""

from __future__ import annotations

import jax.numpy as jnp

from tfhe_jax.params import DecomposerParams


def round_value(value, p: DecomposerParams) -> jnp.ndarray:
    """Round off ignored LSBs to nearest, half up (src/decomposer.rs:27-40)."""
    value = jnp.asarray(value, jnp.uint32)
    ig = p.ignored_bits
    if ig == 0:
        return value
    ignored_msb = (value & jnp.uint32((1 << ig) - 1)) >> jnp.uint32(ig - 1)
    return ((value >> jnp.uint32(ig)) + ignored_msb) << jnp.uint32(ig)


def decompose_u32(value, p: DecomposerParams) -> jnp.ndarray:
    """Exact carry-chain decomposition; u32[...] -> u32[..., levels], MSB-first
    (src/decomposer.rs:42-80)."""
    value = round_value(value, p)
    log_base = p.log_base
    base_mask = jnp.uint32((1 << log_base) - 1)
    half_mask = jnp.uint32(1 << (log_base - 1))
    carry = jnp.zeros_like(value)
    digits = []
    for l in range(p.l_full):
        res = ((value >> jnp.uint32(log_base * l)) & base_mask) + carry
        carry_mask = res & half_mask
        res = res - (carry_mask << jnp.uint32(1))
        carry = carry_mask >> jnp.uint32(log_base - 1)
        digits.append(res)
    digits.reverse()
    return jnp.stack(digits[: p.levels], axis=-1)


def digits_to_signed(digits_u32, p: DecomposerParams) -> jnp.ndarray:
    """Wrapping-u32 digits -> int8 in [-B/2, B] via (log_base+2)-bit sign-extend."""
    bits = p.log_base + 2
    m = jnp.uint32((1 << bits) - 1)
    top = jnp.uint32(1 << (bits - 1))
    v = (digits_u32 & m).astype(jnp.int32) - 2 * (digits_u32 & top).astype(jnp.int32)
    return v.astype(jnp.int8)


def decompose_signed(value, p: DecomposerParams) -> jnp.ndarray:
    """u32[...] -> int8[..., levels] signed digits, MSB-first."""
    return digits_to_signed(decompose_u32(value, p), p)


def recompose(digits_u32, p: DecomposerParams) -> jnp.ndarray:
    """sum(d_i * B^(levels-1-i)) << ignored_bits (src/decomposer.rs:83-95)."""
    d = jnp.asarray(digits_u32, jnp.uint32)
    shifts = jnp.uint32(p.log_base) * (
        jnp.uint32(p.levels - 1) - jnp.arange(p.levels, dtype=jnp.uint32)
    )
    value = (d << shifts).sum(axis=-1, dtype=jnp.uint32)
    return value << jnp.uint32(p.ignored_bits)
