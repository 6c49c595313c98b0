"""Client/server keys and key generation.

The reference keeps keys as in-memory structs and regenerates them ad hoc
(src/bootstrapping.rs:18-56, src/utils.rs:238-243).  Here keys are JAX pytrees
with contraction-ready layouts baked at generation time:

  * ``ServerKey.bk_u32``  — canonical GGSW tensor u32[n, R, k+1, N]
    (serializable, golden-comparable);
  * ``ServerKey.bk_conv`` — conv-ready int8 limb kernel [n, (k+1)*4, R, N]
    (the NTT-domain-resident-key analog: contraction-ready, built once);
  * ``ServerKey.ksk_mat`` — KSK as int8 limbs [kN*l_ks, (n+1)*4] for the
    key-switch matmul.

Key generation is split into a deterministic core (explicit mask/noise
arrays, bit-exactly comparable to the golden model) and a sampling wrapper.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from tfhe_jax.models import ggsw as mggsw
from tfhe_jax.models import glwe as mglwe
from tfhe_jax.models import keyswitch as mks
from tfhe_jax.ops import sampling
from tfhe_jax.ops.poly import bk_to_conv_kernel
from tfhe_jax.params import TfheParams


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ClientKey:
    """Secret keys (src/lwe.rs:50-60, src/glwe.rs:172-182)."""

    lwe_sk: jax.Array  # u32[n] binary
    glwe_sk: jax.Array  # u32[k, N] binary
    params: TfheParams = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ServerKey:
    """Bootstrapping key + key-switching key (src/bootstrapping.rs:18-21)."""

    bk_u32: jax.Array  # u32[n, R, k+1, N] (canonical GGSW row order)
    bk_conv: jax.Array  # int8[n, (k+1)*4, R, N] (conv backend layout)
    ksk_u32: jax.Array  # u32[kN*l_ks, n+1]
    ksk_mat: jax.Array  # int8[kN*l_ks, (n+1)*4]
    params: TfheParams = dataclasses.field(metadata=dict(static=True))
    #: optional BMMP key (notes/BMMP Bootstrapping.md:15-25): per secret-bit
    #: pair i, the canonical rows of GGSW(s s'), GGSW(s(1-s')),
    #: GGSW((1-s)s') concatenated -> u32[n/2, 3R, k+1, N].  None unless
    #: keygen(..., bmmp=True).
    bk_bmmp: jax.Array | None = None
    #: optional NTT-domain-resident BK for the block-NTT backend
    #: (ops/ntt.py): int8[n, P, 2, N1, R*N2, C*L*N2].  Derived from
    #: ``bk_u32`` by ``with_ntt_key``; not serialized (rebuilt on demand).
    bk_ntt: jax.Array | None = None


def make_server_key(
    params: TfheParams, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a, ksk_e,
    bmmp_a=None, bmmp_e=None,
) -> ServerKey:
    """Deterministic keygen core (src/bootstrapping.rs:23-56).

    bk_a: u32[n, R, k, N]; bk_e: u32[n, R, N];
    ksk_a: u32[kN*l_ks, n]; ksk_e: u32[kN*l_ks].
    """
    sk_t = mglwe.sk_toeplitz(glwe_sk)
    bk_u32 = mggsw.encrypt(sk_t, lwe_sk, params, bk_a, bk_e)  # [n, R, k+1, N]
    bk_conv = bk_to_conv_kernel(bk_u32)
    glwe_flat = jnp.asarray(glwe_sk, jnp.uint32).reshape(-1)  # (src/lwe.rs:62-73)
    ksk_u32 = mks.generate_ksk(glwe_flat, lwe_sk, params.ks_decomposer, ksk_a, ksk_e)
    ksk_mat = mks.ksk_to_matmul(ksk_u32)
    bk_bmmp = None
    if bmmp_a is not None:
        # secret-bit pair products (notes/BMMP Bootstrapping.md:15-25)
        s0 = jnp.asarray(lwe_sk, jnp.uint32)[0::2]
        s1 = jnp.asarray(lwe_sk, jnp.uint32)[1::2]
        trip = jnp.stack([s0 * s1, s0 * (1 - s1), (1 - s0) * s1], axis=1)
        trip = trip.reshape(-1)  # [3n/2] bit messages
        bmmp_u32 = mggsw.encrypt(sk_t, trip, params, bmmp_a, bmmp_e)
        r, k1, deg = bmmp_u32.shape[1:]
        bk_bmmp = bmmp_u32.reshape(trip.shape[0] // 3, 3 * r, k1, deg)
    return ServerKey(
        bk_u32=bk_u32, bk_conv=bk_conv, ksk_u32=ksk_u32, ksk_mat=ksk_mat,
        params=params, bk_bmmp=bk_bmmp,
    )


def with_ntt_key(sk: ServerKey) -> ServerKey:
    """Attach the NTT-domain key operand for ``blind_rotate(impl='ntt')``.

    Built from ``bk_u32`` in per-step chunks (the full intermediate tensor
    at default_128 would transiently need ~4 GB; chunking keeps the peak at
    ~1/12th of that while the output itself is ~1.9 GB int8).  Refuses a key
    larger than the default device's free memory, when the device reports it
    (the streaming backend ``impl='ntts'`` needs no resident NTT key).
    """
    from tfhe_jax.ops.ntt import make_ep_ntt_key, plan_for_params

    plan = plan_for_params(sk.params)
    p = sk.params
    rows = (p.glwe_dimension + 1) * p.pbs_decomposer.levels
    per_step = (4 * plan.n1 * (rows * plan.n2)
                * ((p.glwe_dimension + 1) * plan.key_limbs * plan.n2))
    total = per_step * p.lwe_dimension
    stats = jax.devices()[0].memory_stats()
    if stats and total > stats["bytes_limit"] - stats["bytes_in_use"]:
        free = stats["bytes_limit"] - stats["bytes_in_use"]
        raise ValueError(
            f"resident NTT key would be {total/2**30:.1f} GiB, more than the "
            f"{free/2**30:.1f} GiB free on the device; use the streaming "
            "backend impl='ntts' instead")
    bk_ntt = jax.lax.map(
        lambda bk_i: make_ep_ntt_key(bk_i, plan), sk.bk_u32, batch_size=64
    )
    return dataclasses.replace(sk, bk_ntt=bk_ntt)


def keygen(params: TfheParams, key, bmmp: bool = False) -> tuple[ClientKey, ServerKey]:
    """Sample secret keys and derive the server key (src/utils.rs:238-243 +
    src/bootstrapping.rs:23-56).  ``bmmp=True`` additionally generates the
    1.5x-size BMMP key triples enabling the halved-depth rotation."""
    if isinstance(key, int):
        key = jax.random.key(key)
    k, n, N = params.glwe_dimension, params.lwe_dimension, params.degree
    dp, ks = params.pbs_decomposer, params.ks_decomposer
    rows = (k + 1) * dp.levels
    k_lwe, k_glwe, k_bka, k_bke, k_kska, k_kske, k_ba, k_be = jax.random.split(key, 8)
    lwe_sk = sampling.binary(k_lwe, (n,))
    glwe_sk = sampling.binary(k_glwe, (k, N))
    bk_a = sampling.uniform_u32(k_bka, (n, rows, k, N))
    bk_e = sampling.gaussian_torus(k_bke, params.glwe_std_dev, (n, rows, N))
    kn = k * N
    ksk_a = sampling.uniform_u32(k_kska, (kn * ks.levels, n))
    ksk_e = sampling.gaussian_torus(k_kske, params.lwe_std_dev, (kn * ks.levels,))
    bmmp_a = bmmp_e = None
    if bmmp:
        assert n % 2 == 0, "BMMP pairs secret bits; n must be even"
        bmmp_a = sampling.uniform_u32(k_ba, (3 * n // 2, rows, k, N))
        bmmp_e = sampling.gaussian_torus(
            k_be, params.glwe_std_dev, (3 * n // 2, rows, N)
        )
    ck = ClientKey(lwe_sk=lwe_sk, glwe_sk=glwe_sk, params=params)
    sk = make_server_key(
        params, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a, ksk_e, bmmp_a, bmmp_e
    )
    return ck, sk
