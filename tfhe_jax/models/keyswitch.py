"""LWE key switching (reference: src/key_switching.rs) — one exact int8 matmul.

The reference's per-digit scaled_add loop (src/key_switching.rs:81-89) becomes
a single [B, from_n*levels] x [from_n*levels, (to_n+1)*4] int8 matmul over the
KSK's signed limb split, recombined with wrapping shifts.
"""

from __future__ import annotations

import jax.numpy as jnp

from tfhe_jax.models import lwe as mlwe
from tfhe_jax.ops.decomposer import decompose_signed
from tfhe_jax.ops.torus import combine_limb_accs, to_signed_limbs, u32, NUM_LIMBS
from tfhe_jax.params import DecomposerParams


def generate_ksk(from_sk, to_sk, ks: DecomposerParams, a, e) -> jnp.ndarray:
    """KSK u32[from_n*levels, to_n+1]; row s*levels+j = LWE_to(s_bit*B^(l_full-j-1))
    (src/key_switching.rs:20-60).  a: u32[from_n*levels, to_n], e: u32[from_n*levels]."""
    levels = ks.levels
    from_sk = u32(from_sk)
    shifts = jnp.uint32(ks.log_base) * (
        jnp.uint32(ks.l_full - 1) - jnp.arange(levels, dtype=jnp.uint32)
    )
    factors = (jnp.repeat(from_sk, levels) << jnp.tile(shifts, from_sk.shape[0]))
    return mlwe.encrypt(to_sk, factors, a, e)


def ksk_to_matmul(ksk_u32) -> jnp.ndarray:
    """u32[K, to_n+1] -> int8[K, (to_n+1)*4] signed limb layout for the matmul."""
    k_rows = ksk_u32.shape[0]
    return to_signed_limbs(u32(ksk_u32)).reshape(k_rows, -1)


def key_switch(ct, from_n: int, ks: DecomposerParams, ksk_mat_i8) -> jnp.ndarray:
    """out = (0,..,0,b) - sum a_ij * KSK_row (src/key_switching.rs:63-103).

    ct: u32[..., from_n+1]; ksk_mat_i8 from ``ksk_to_matmul``.  Digits are
    MSB-first (src/decomposer.rs:72), matching KSK row order.
    """
    ct = u32(ct)
    lead = ct.shape[:-1]
    digits = decompose_signed(ct[..., :from_n], ks)  # [..., from_n, levels]
    flat = digits.reshape(lead + (from_n * ks.levels,))
    acc = jnp.matmul(flat, ksk_mat_i8, preferred_element_type=jnp.int32)
    to_n1 = ksk_mat_i8.shape[1] // NUM_LIMBS
    summ = combine_limb_accs(acc.reshape(lead + (to_n1, NUM_LIMBS)))
    out = -summ
    return out.at[..., -1].add(ct[..., from_n])
