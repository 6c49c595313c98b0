"""GGSW ciphertexts, external product and CMUX (reference: src/ggsw.rs).

GGSW layout: u32[..., R=(k+1)*levels, k+1, N]; row (i*levels + j) is a GLWE(0)
plus m * B^(l_full-j-1) on the constant coefficient of polynomial i
(src/ggsw.rs:43-103).

The external product (src/ggsw.rs:132-161) is the framework's hot kernel:
decompose the GLWE into R signed-digit rows, then contract against the GGSW's
k+1 polynomial columns in one exact int8 contraction (conv or Toeplitz-matmul
formulation; ops/poly.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tfhe_jax.models import glwe as mglwe
from tfhe_jax.ops.poly import (
    bk_to_conv_kernel,
    ep_combine,
    ep_contract_conv,
    ep_contract_matmul,
)
from tfhe_jax.ops.torus import u32
from tfhe_jax.params import TfheParams


def gadget_matrix(params: TfheParams) -> np.ndarray:
    """u32[R, k+1, N] with G[i*l+j, i, 0] = B^(l_full-j-1) (src/ggsw.rs:90-103)."""
    dp = params.pbs_decomposer
    k = params.glwe_dimension
    gm = np.zeros(((k + 1) * dp.levels, k + 1, params.degree), dtype=np.uint32)
    for i in range(k + 1):
        for j in range(dp.levels):
            gm[i * dp.levels + j, i, 0] = np.uint32(
                (1 << (dp.log_base * (dp.l_full - (j + 1)))) & 0xFFFFFFFF
            )
    return gm


def encrypt(sk_t, message_bits, params: TfheParams, a, e) -> jnp.ndarray:
    """Batch-encrypt GGSW(m) for a vector of bit messages (src/ggsw.rs:76-130).

    message_bits: u32[...]; a: u32[..., R, k, N]; e: u32[..., R, N].
    Returns u32[..., R, k+1, N].  Used bulk for the bootstrapping key (one
    GGSW per LWE secret bit, src/bootstrapping.rs:32-38).
    """
    zero = mglwe.encrypt_zero(sk_t, a, e)  # [..., R, k+1, N]
    gm = jnp.asarray(gadget_matrix(params))
    m = u32(message_bits)[..., None, None, None]
    return zero + m * gm


def external_product(ggsw_u32, glwe_ct, params: TfheParams, impl: str = "conv"):
    """GGSW(m2) x GLWE(m1) -> GLWE(m1*m2) (src/ggsw.rs:132-161), batched over
    the GLWE's leading dims; the GGSW is shared (u32[R, k+1, N])."""
    dp = params.pbs_decomposer
    ct = u32(glwe_ct)
    lead = ct.shape[:-2]
    digits = mglwe.decompose(ct, dp)
    flat = digits.reshape((-1,) + digits.shape[-2:])  # [B, R, N]
    if impl == "conv":
        acc = ep_contract_conv(flat, bk_to_conv_kernel(u32(ggsw_u32)))
    elif impl == "matmul":
        acc = ep_contract_matmul(flat, u32(ggsw_u32))
    else:
        raise ValueError(impl)
    out = ep_combine(acc, params.glwe_dimension + 1)  # [B, k+1, N]
    return out.reshape(lead + out.shape[-2:])


def cmux(ggsw_u32, c0, c1, params: TfheParams, impl: str = "conv"):
    """b ? c1 : c0 = EP(b, c1-c0) + c0 (src/ggsw.rs:164-178), pure-functional
    (the reference mutates c1 in place; we don't)."""
    diff = u32(c1) - u32(c0)
    return external_product(ggsw_u32, diff, params, impl=impl) + u32(c0)
