"""Programmable bootstrapping (reference: src/bootstrapping.rs) — scan-based.

Pipeline (src/bootstrapping.rs:58-120):
  1. modulus-switch the LWE ciphertext from q=2^32 to 2N;
  2. acc = trivial-GLWE(v(X)) * X^(-b_hat);
  3. n-step CMUX loop — a ``lax.scan`` over the bootstrapping key with the
     whole ciphertext batch advancing together (per-sample monomial exponents
     via the barrel shifter);
  4. sample-extract coefficient 0 -> LWE of dimension k*N;
  5. key-switch back to dimension n.

The scan step fuses CMUX as acc += EP(digits(rot - acc), BK_i): decompose
once, one exact int8 contraction, wrapping-u32 recombine.  Interchangeable
contraction backends (all bit-identical):

  * ``conv``   — one int8 ``conv_general_dilated`` per step.  CPU only: the
    GPU backend rejects s8 x s8 -> s32 convolutions (cuDNN takes s8 or f32
    output only).
  * ``matmul`` — explicit per-step Toeplitz expansion of the key, then one
    [B, R*N] @ [R*N, C*4*N] int8 GEMM.
  * ``ntt`` / ``ntts`` — block-NTT contraction (ops/ntt.py) with a resident
    NTT-domain key / a key transformed inside the scan.
  * ``bmmp`` — halved-depth rotation over the BMMP key triples, each step
    contracted with the backend ``auto`` picks for the batch.

Throughput comes from the batch axis; the loop itself is inherently serial
(SURVEY.md section 7.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tfhe_jax.models import glwe as mglwe
from tfhe_jax.models import keyswitch as mks
from tfhe_jax.ops.poly import (
    bk_to_conv_kernel,
    ep_combine,
    ep_contract_conv,
    ep_contract_matmul,
)
from tfhe_jax.ops.torus import switch_modulus, u32
from tfhe_jax.params import TfheParams


#: every backend string ``blind_rotate`` accepts (single source of truth for
#: the bench.py / cli.py flag surfaces)
VALID_IMPLS = ("auto", "conv", "matmul", "ntt", "ntts", "bmmp")

#: on the GPU, batches up to this size run ``ntts`` and larger ones
#: ``matmul``: the Toeplitz expansion costs a fixed ~57 MB of HBM traffic per
#: step that only a large batch amortizes (per-backend times in CHANGES.md)
GPU_NTTS_MAX_BATCH = 128


def resolve_impl(impl: str, batch: int) -> str:
    """'auto' -> the plain backend measured fastest for this platform and batch."""
    if impl != "auto":
        return impl
    if jax.default_backend() != "gpu":
        return "conv"
    return "ntts" if batch <= GPU_NTTS_MAX_BATCH else "matmul"


def sample_extract(glwe_ct, index=0) -> jnp.ndarray:
    """Extract coefficient ``index`` as an LWE of dimension k*N
    (src/bootstrapping.rs:122-156, general form).

    a'[i*N + j] = a_i[(index - j) mod N], negated where j > index (the
    negacyclic wraparound); b' = b[index].  ``index`` may be a Python int or
    a traced int32 scalar (broadcastable over the batch).
    """
    ct = u32(glwe_ct)
    n = ct.shape[-1]
    k = ct.shape[-2] - 1
    h = jnp.asarray(index, jnp.int32)  # scalar or [batch...]
    a = ct[..., :k, :]
    j = jnp.arange(n, dtype=jnp.int32)
    idx = ((h[..., None] - j) & (n - 1))[..., None, :]  # [..., 1, N]
    w = jnp.take_along_axis(a, jnp.broadcast_to(idx, a.shape), axis=-1)
    w = jnp.where((j > h[..., None])[..., None, :], -w, w)
    flat = w.reshape(ct.shape[:-2] + (k * n,))
    b = jnp.take_along_axis(
        ct[..., k, :], jnp.broadcast_to(h[..., None], ct.shape[:-2] + (1,)), axis=-1
    )
    return jnp.concatenate([flat, b], axis=-1)


def sample_extract0(glwe_ct) -> jnp.ndarray:
    """Coefficient-0 specialisation (the PBS hot path): at index 0 the
    gather collapses to a reverse + negate — a'[i*N+j] = a_i[(0-j) mod N]
    negated for j>0 is a_i[0] followed by the negated reversal of
    a_i[1:] — so no take_along_axis is needed."""
    ct = u32(glwe_ct)
    k = ct.shape[-2] - 1
    a = ct[..., :k, :]
    w = jnp.concatenate([a[..., :1], -jnp.flip(a[..., 1:], axis=-1)], axis=-1)
    flat = w.reshape(ct.shape[:-2] + (k * ct.shape[-1],))
    return jnp.concatenate([flat, ct[..., k, :1]], axis=-1)


def _init_acc(params: TfheParams, approx_ct, tv_encoded):
    """acc0 = trivial(v(X)) * X^(-b_hat), batched (src/bootstrapping.rs:79-86)."""
    k = params.glwe_dimension
    n_dim = params.lwe_dimension
    b_hat = approx_ct[..., n_dim].astype(jnp.int32)
    batch = approx_ct.shape[:-1]
    acc_b = jnp.broadcast_to(u32(tv_encoded), batch + tv_encoded.shape)
    acc0 = mglwe.trivial_encrypt(acc_b, k)
    acc0 = mglwe.mul_monomial(acc0, -b_hat)
    a_hat = jnp.moveaxis(approx_ct[..., :n_dim], -1, 0).astype(jnp.int32)  # [n, B]
    return acc0, a_hat


def ep_delta(params: TfheParams, digits, bk_u32, impl: str) -> jnp.ndarray:
    """External-product delta u32[B, k+1, N] of int8 digits [B, R', N] against
    one step's canonical key rows u32[R', k+1, N], through backend ``impl``
    (conv / matmul / ntts).  R' may be any row count (a row shard, or the
    BMMP triple's 3R rows); the contraction is exact mod 2^32 either way."""
    k1 = params.glwe_dimension + 1
    if impl == "ntts":
        from tfhe_jax.ops.ntt import ep_contract_ntt, make_ep_ntt_key, make_plan

        plan = make_plan(params.degree, rows=digits.shape[-2],
                         max_digit=1 << params.pbs_decomposer.log_base)
        return ep_contract_ntt(digits, make_ep_ntt_key(bk_u32, plan), plan, c_dim=k1)
    if impl == "conv":
        return ep_combine(ep_contract_conv(digits, bk_to_conv_kernel(bk_u32)), k1)
    return ep_combine(ep_contract_matmul(digits, bk_u32), k1)


def rotate_chunk(params, acc, bk_chunk, a_chunk, impl):
    """Run a contiguous chunk of CMUX steps: [B, k+1, N] acc in/out.

    ``bk_chunk`` is the key slice for these steps in the form ``impl`` reads:
    the conv kernel layout (``bk_conv``) for ``conv``, the NTT-domain key
    (``bk_ntt``) for ``ntt``, canonical u32 rows otherwise; a_chunk:
    int32[steps, B].  Exposed separately so the pipeline-parallel rotation
    (parallel/pipeline.py) can run per-stage chunks.
    """
    k1 = params.glwe_dimension + 1

    def step(acc, xs):
        bk_i, a_i = xs
        rot = mglwe.mul_monomial(acc, a_i)  # acc * X^{a_i}
        digits = mglwe.decompose(rot - acc, params.pbs_decomposer)  # [B, R, N]
        if impl == "conv":
            delta = ep_combine(ep_contract_conv(digits, bk_i), k1)
        elif impl == "ntt":
            from tfhe_jax.ops.ntt import ep_contract_ntt, plan_for_params

            delta = ep_contract_ntt(digits, bk_i, plan_for_params(params), c_dim=k1)
        else:
            delta = ep_delta(params, digits, bk_i, impl)
        return acc + delta, None

    acc, _ = lax.scan(step, acc, (bk_chunk, a_chunk))
    return acc


def _blind_rotate_bmmp(params, approx_ct, bk_bmmp, tv_encoded, contraction=None):
    """BMMP halved-depth rotation (notes/BMMP Bootstrapping.md:15-25):

        acc *= X^(a s + a' s')
             = acc + EP(G(ss'), (X^(a+a')-1)acc)
                   + EP(G(s(1-s')), (X^a-1)acc)
                   + EP(G((1-s)s'), (X^(a')-1)acc)

    n/2 scan steps; the three external products share one contraction
    (digit rows and key rows concatenated variant-major) through
    ``contraction`` (conv / matmul / ntts), by default the backend ``auto``
    picks for the batch.  Implemented but only *documented* in the reference
    (its loop is the standard per-bit one, src/bootstrapping.rs:90-105).
    """
    impl = contraction or resolve_impl("auto", approx_ct.shape[0])
    two_n = 2 * params.degree
    acc0, a_hat = _init_acc(params, approx_ct, tv_encoded)
    a0 = a_hat[0::2]  # [n/2, B]
    a1 = a_hat[1::2]
    asum = jnp.mod(a0 + a1, two_n)

    def step(acc, xs):
        bk_i, e0, e1, es = xs  # bk_i u32[3R, k+1, N]
        digits = jnp.concatenate([
            # order matches the key triple (ss', s(1-s'), (1-s)s')
            mglwe.decompose(mglwe.mul_monomial(acc, e) - acc, params.pbs_decomposer)
            for e in (es, e0, e1)
        ], axis=-2)  # [B, 3R, N]
        return acc + ep_delta(params, digits, bk_i, impl), None

    acc, _ = lax.scan(step, acc0, (bk_bmmp, a0, a1, asum))
    return acc


def blind_rotate(params: TfheParams, approx_ct, server_key, tv_encoded,
                 impl: str = "auto") -> jnp.ndarray:
    """n-step CMUX loop (src/bootstrapping.rs:79-105); batched.

    approx_ct: u32[B, n+1] already mod-switched to 2N; tv_encoded: u32[N]
    (the *encoded* test vector, src/bootstrapping.rs:82-86).
    """
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {VALID_IMPLS}")
    impl = resolve_impl(impl, approx_ct.shape[0])
    if impl == "bmmp":
        if server_key.bk_bmmp is None:
            raise ValueError("impl='bmmp' needs a key from keygen(..., bmmp=True)")
        return _blind_rotate_bmmp(params, approx_ct, server_key.bk_bmmp, tv_encoded)
    if impl == "ntt":
        if server_key.bk_ntt is None:
            raise ValueError("impl='ntt' needs keys.with_ntt_key(server_key)")
        bk = server_key.bk_ntt
    else:
        bk = server_key.bk_conv if impl == "conv" else server_key.bk_u32
    acc0, a_hat = _init_acc(params, approx_ct, tv_encoded)
    return rotate_chunk(params, acc0, bk, a_hat, impl)


def pbs(params: TfheParams, ct, server_key, tv_encoded, impl: str = "auto"):
    """Full programmable bootstrap (src/bootstrapping.rs:58-120); batched.

    ct: u32[B, n+1]; server_key: models.keys.ServerKey; tv_encoded: u32[N].
    """
    from tfhe_jax.utils.profiling import scope

    with scope("pbs.mod_switch"):
        approx = switch_modulus(u32(ct), params.log_q, params.log_degree + 1)
    with scope("pbs.blind_rotate"):
        acc = blind_rotate(params, approx, server_key, u32(tv_encoded), impl=impl)
    with scope("pbs.sample_extract"):
        extracted = sample_extract0(acc)
    from_n = params.glwe_dimension * params.degree
    with scope("pbs.key_switch"):
        return mks.key_switch(
            extracted, from_n, params.ks_decomposer, server_key.ksk_mat
        )
