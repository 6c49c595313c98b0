"""Pipeline-parallel blind rotation — the PP analog (SURVEY.md section 2.2).

The n-step CMUX rotation is inherently serial *per ciphertext*
(src/bootstrapping.rs:90-105), but it stages cleanly: stage s of S holds the
bootstrapping-key slice for steps [s*n/S, (s+1)*n/S) and microbatches of
ciphertexts flow through the stages, the GLWE accumulator hopping
stage -> stage+1 via ``lax.ppermute`` each tick.  With M microbatches
the pipe runs M+S-1 ticks of 1/S-depth rotation chunks, so utilization is
M/(M+S-1) -> 1 for deep queues, and each device stores only BK/S (~13 MB at
default_128 with S=6): the stage axis is the memory-relief / scale-out axis,
batch remains the throughput axis.

Built as one ``shard_map`` over a ("batch", "stage") mesh — DP over the
ciphertext batch inside every microbatch x PP over rotation steps.  XLA
lowers the hop to a point-to-point collective; there is no hand-written
transport.  Bit-exact vs. the single-device scan (asserted in
tests/test_parallel.py on the 8-virtual-device CPU mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.bootstrap import (
    _init_acc, resolve_impl, rotate_chunk, sample_extract0,
)
from tfhe_jax.models.keys import ServerKey
from tfhe_jax.models.keyswitch import key_switch
from tfhe_jax.ops.torus import switch_modulus, u32
from tfhe_jax.parallel.mesh import BATCH_AXIS, STAGE_AXIS
from tfhe_jax.params import TfheParams


def _pipelined_gate_local(params: TfheParams, impl: str, n_stages: int,
                          tv_encoded, ct0, ct1, bk_c, bk_m, ksk_mat):
    """Per-device body: ct0/ct1 u32[M, B_local, n+1] (stage-replicated),
    bk_c / bk_m = this stage's contiguous slices of the conv-layout key and
    of the row key (``bk_u32``, or ``bk_ntt`` for ``ntt``), ksk_mat
    replicated.  ``auto`` resolves on the local microbatch size."""
    impl = resolve_impl(impl, ct0.shape[1])
    bk_local = bk_c if impl == "conv" else bk_m
    chunk = params.lwe_dimension // n_stages
    s = lax.axis_index(STAGE_AXIS)
    m_microbatches = ct0.shape[0]

    ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
    approx = switch_modulus(u32(ct_in), params.log_q, params.log_degree + 1)
    # per-microbatch initial accumulators + rotation exponents
    acc0_all, a_hat_all = jax.vmap(
        lambda c: _init_acc(params, c, u32(tv_encoded))
    )(approx)  # [M, B, k+1, N], [M, n, B]
    a_local = lax.dynamic_slice_in_dim(a_hat_all, s * chunk, chunk, axis=1)

    acc = jnp.zeros(acc0_all.shape[1:], jnp.uint32)  # [B, k+1, N]
    out = jnp.zeros(acc0_all.shape, jnp.uint32)  # [M, B, k+1, N]

    def tick(t, carry):
        acc, out = carry
        mb = t - s  # microbatch resident in this stage at tick t
        valid = (mb >= 0) & (mb < m_microbatches)
        mb_c = jnp.clip(mb, 0, m_microbatches - 1)
        # stage 0 ingests a fresh microbatch; later stages continue the acc
        # handed over by the previous stage at the end of the last tick
        fresh = lax.dynamic_index_in_dim(acc0_all, mb_c, 0, keepdims=False)
        acc_cur = jnp.where(s == 0, fresh, acc)
        a_t = lax.dynamic_index_in_dim(a_local, mb_c, 0, keepdims=False)
        acc_new = rotate_chunk(params, acc_cur, bk_local, a_t, impl)
        # the final stage banks the finished rotation (masked: other stages
        # and out-of-range ticks keep the existing — zero — contents)
        write = valid & (s == n_stages - 1)
        prev = lax.dynamic_index_in_dim(out, mb_c, 0, keepdims=False)
        out = lax.dynamic_update_index_in_dim(
            out, jnp.where(write, acc_new, prev), mb_c, 0
        )
        # hop the accumulator to the next stage (last stage's output retires)
        acc_next = lax.ppermute(
            acc_new, STAGE_AXIS, [(i, i + 1) for i in range(n_stages - 1)]
        )
        return acc_next, out

    acc, out = lax.fori_loop(0, m_microbatches + n_stages - 1, tick, (acc, out))
    # results live on the last stage only; psum replicates them stage-wide
    # (all other stages contributed exact zeros)
    out = lax.psum(out, STAGE_AXIS)

    extracted = sample_extract0(out)  # [M, B, kN+1]
    from_n = params.glwe_dimension * params.degree
    return key_switch(extracted, from_n, params.ks_decomposer, ksk_mat)


def make_pipelined_gate(mesh: Mesh, params: TfheParams, gate: str,
                        impl: str = "auto") -> callable:
    """Build a jitted pipeline-parallel gate over a ("batch", "stage") mesh.

    Returns ``fn(ct0, ct1, server_key) -> ct_out`` where ct0/ct1 are
    u32[M, B, n+1] microbatch queues; output is u32[M, B, n+1].  BK is
    sharded by rotation-step range over ``stage``; ciphertexts shard over
    ``batch`` and flow through the stages via ppermute.  Every single-device
    contraction backend except ``bmmp`` works per stage (auto / conv /
    matmul / ntt / ntts).
    """
    n_stages = mesh.shape[STAGE_AXIS]
    assert params.lwe_dimension % n_stages == 0, (params.lwe_dimension, n_stages)
    if impl not in ("auto", "conv", "matmul", "ntt", "ntts"):
        raise ValueError(f"impl={impl!r} has no pipelined form")
    tv = jnp.asarray(mtv.gate_test_vector(params, gate))

    f = partial(_pipelined_gate_local, params, impl, n_stages, tv)
    ct_spec = P(None, BATCH_AXIS, None)
    sharded = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(ct_spec, ct_spec, P(STAGE_AXIS), P(STAGE_AXIS), P()),
        out_specs=ct_spec,
        check_vma=False,
    )

    @jax.jit
    def run(ct0, ct1, bk_conv, bk_rows, ksk_mat):
        return sharded(ct0, ct1, bk_conv, bk_rows, ksk_mat)

    def call(ct0, ct1, sk: ServerKey):
        if impl == "ntt":
            if sk.bk_ntt is None:
                raise ValueError("impl='ntt' needs keys.with_ntt_key(server_key)")
            bk_rows = sk.bk_ntt
        else:
            bk_rows = sk.bk_u32
        return run(ct0, ct1, sk.bk_conv, bk_rows, sk.ksk_mat)

    call.run_jit = run  # exposed for the HLO collective-traffic audit
    return call
