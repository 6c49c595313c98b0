"""LWE over Z_{2^32} (reference: src/lwe.rs) — batched u32 tensors.

Ciphertext: u32[..., n+1] = (a_0..a_{n-1}, b).  Every function takes a leading
batch of arbitrary shape; there is no single-ciphertext object (the
reference's per-ct structs become plain arrays).
"""

from __future__ import annotations

import jax.numpy as jnp

from tfhe_jax.ops.torus import u32, wrapping_matvec_u32_small


def _sk_col(sk) -> jnp.ndarray:
    """Binary secret u32[n] -> int8[n, 1] for the exact limb matvec."""
    return jnp.asarray(sk, jnp.int8)[:, None]


def encrypt(sk, pt, a, e) -> jnp.ndarray:
    """(a, <a,s> + e + pt), wrapping (src/lwe.rs:138-160); fully batched."""
    b = wrapping_matvec_u32_small(u32(a), _sk_col(sk))[..., 0] + u32(e) + u32(pt)
    return jnp.concatenate([u32(a), b[..., None]], axis=-1)


def decrypt(sk, ct) -> jnp.ndarray:
    """b - <a,s> (src/lwe.rs:162-173)."""
    ct = u32(ct)
    a_s = wrapping_matvec_u32_small(ct[..., :-1], _sk_col(sk))[..., 0]
    return ct[..., -1] - a_s


def add(c0, c1) -> jnp.ndarray:
    """ct + ct (src/lwe.rs:9-15); uniformly wrapping."""
    return u32(c0) + u32(c1)


def scalar_mul(ct, scalar) -> jnp.ndarray:
    """ct * k (src/lwe.rs:17-23)."""
    return u32(ct) * jnp.uint32(scalar)
