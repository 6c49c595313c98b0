"""Sharded PBS: batch-parallel + BK-row (model) parallel gate bootstrapping.

Mapping of TFHE onto the mesh (SURVEY.md section 2.2):

  * ciphertext batch  -> ``batch`` axis (pure data parallelism, no collectives);
  * BK rows R=(k+1)*levels and KSK rows K=kN*l_ks -> ``model`` axis.  Each
    shard contracts its local key rows against locally-computed digit slices,
    recombines its limb planes into a partial wrapping-u32 delta LOCALLY, and
    the deltas are ``psum``-reduced (integer addition is associative and the
    limb recombine is linear, so sharded execution is bit-identical to
    single-device execution — asserted in tests; combining before the
    collective moves 4x fewer bytes per step than psum'ing raw planes).

Everything is a single ``shard_map``-wrapped jittable function; XLA inserts
the collectives (psum) — there is no hand-written transport.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tfhe_jax.models import glwe as mglwe
from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.bootstrap import _init_acc, ep_delta, resolve_impl, sample_extract0
from tfhe_jax.models.keys import ServerKey
from tfhe_jax.ops.decomposer import decompose_signed
from tfhe_jax.ops.poly import (
    ep_combine,
    ep_contract_conv,
    ep_contract_matmul,
    ep_contract_matmul_cols,
)
from tfhe_jax.ops.torus import NUM_LIMBS, combine_limb_accs, switch_modulus, u32
from tfhe_jax.parallel.mesh import BATCH_AXIS, HOST_AXIS, MODEL_AXIS
from tfhe_jax.params import TfheParams


def _psum_delta(delta_u32, model_axis):
    """psum a partial u32 CMUX delta over ``model``.

    The wrapping-u32 limb recombine (``ep_combine*``) is LINEAR in the raw
    int32 limb planes, so combining locally BEFORE the collective is
    bit-identical to psum'ing the planes — and moves 4x fewer bytes per step
    (u32 [B, k+1, N] = B*6KB at default_128 vs int32 [B, (k+1)*4limbs, N]).
    Two's-complement int32 addition == wrapping u32 addition bit-for-bit; the
    bitcasts keep the collective on a signed dtype for backend portability.
    """
    if not model_axis:
        return delta_u32
    return lax.bitcast_convert_type(
        lax.psum(lax.bitcast_convert_type(delta_u32, jnp.int32), model_axis),
        jnp.uint32,
    )


def _blind_rotate_local(params: TfheParams, approx_ct, bk_c, bk_m, tv_encoded,
                        impl: str, model_axis: str | None, model_n: int = 1):
    """Local shard of the CMUX scan; BK arrives row-sharded, digits are sliced
    to the local rows and partial u32 deltas are psum'd per step.  ``auto``
    resolves on the local batch, as on one device."""
    k = params.glwe_dimension
    n_dim = params.lwe_dimension
    acc0, a_hat = _init_acc(params, approx_ct, u32(tv_encoded))
    impl = resolve_impl(impl, approx_ct.shape[0])

    local_r = bk_c.shape[-2] if impl == "conv" else bk_m.shape[-3]
    shard = lax.axis_index(model_axis) if model_axis else 0

    if impl == "ntt":
        # NTT-stage sharding (SURVEY.md section 2.2 row 3, the sharded-NTT
        # plan): each shard owns N1/model_n contiguous NTT bins — forward
        # NTT, merged matmul and partial INTT are all local; only the raw
        # int32 INTT limb planes cross the mesh (psum — linear in the bin
        # axis), then the modular combine + CRT lift run replicated.
        from tfhe_jax.ops.ntt import (
            ep_contract_ntt_partial, ep_finish_ntt, plan_for_params,
        )

        plan = plan_for_params(params)
        bins_local = plan.n1 // model_n if model_axis else plan.n1
        bin_start = shard * bins_local

        def step_n(acc, xs):
            _, bkm_i, a_i = xs  # bkm_i int8[P, 2, bins_local, RN2, CLN2]
            rot = mglwe.mul_monomial(acc, a_i)
            digits = mglwe.decompose(rot - acc, params.pbs_decomposer)
            planes = ep_contract_ntt_partial(
                digits, bkm_i, plan, k + 1, bin_start, bins_local
            )
            if model_axis:
                planes = lax.psum(planes, model_axis)
            return acc + ep_finish_ntt(planes, plan, k + 1), None

        xs = (jnp.zeros((n_dim, 0), jnp.int8), bk_m, a_hat)
        acc, _ = lax.scan(step_n, acc0, xs)
        return acc

    if impl == "coeffs":
        # SP analog (SURVEY.md section 2.2 row 3): shard the N OUTPUT
        # COEFFICIENTS of the contraction over ``model``.  The key stays
        # replicated (every output coefficient reads every coefficient of g);
        # each shard builds only its column slice of the sign-Toeplitz operand
        # and the partial deltas are reassembled with an exact all_gather over
        # the coefficient axis — the TFHE counterpart of sequence-parallel
        # activation gathers.  The wrapping limb recombine is PER-COEFFICIENT,
        # so each shard combines its own columns to u32 BEFORE the gather
        # (bit-identical, 4x less wire traffic than gathering the raw int32
        # limb planes; the HLO traffic audit in tests/test_parallel.py pins it).
        n_deg = params.degree
        chunk = n_deg // model_n if model_axis else n_deg

        def step_c(acc, xs):
            _, bkm_i, a_i = xs
            rot = mglwe.mul_monomial(acc, a_i)
            digits = mglwe.decompose(rot - acc, params.pbs_decomposer)
            if model_axis:
                raw_local = ep_contract_matmul_cols(
                    digits, bkm_i, shard * chunk, chunk
                )
                delta = lax.all_gather(
                    ep_combine(raw_local, k + 1), model_axis,
                    axis=-1, tiled=True,
                )
            else:
                delta = ep_combine(ep_contract_matmul(digits, bkm_i), k + 1)
            return acc + delta, None

        xs = (jnp.zeros((n_dim, 0), jnp.int8), bk_m, a_hat)
        acc, _ = lax.scan(step_c, acc0, xs)
        return acc

    def step(acc, xs):
        bkc_i, bkm_i, a_i = xs
        rot = mglwe.mul_monomial(acc, a_i)
        digits = mglwe.decompose(rot - acc, params.pbs_decomposer)  # [B, R, N]
        if model_axis:
            digits = lax.dynamic_slice_in_dim(digits, shard * local_r, local_r, axis=-2)
        if impl == "conv":
            delta = ep_combine(ep_contract_conv(digits, bkc_i), k + 1)
        else:  # matmul / ntts: exact mod 2^32 over the local rows
            delta = ep_delta(params, digits, bkm_i, impl)
        return acc + _psum_delta(delta, model_axis), None

    xs = (
        bk_c if impl == "conv" else jnp.zeros((n_dim, 0), jnp.int8),
        jnp.zeros((n_dim, 0), jnp.uint32) if impl == "conv" else bk_m,
        a_hat,
    )
    acc, _ = lax.scan(step, acc0, xs)
    return acc


def _key_switch_local(params: TfheParams, ct, ksk_mat_local, model_axis):
    """Key switch with KSK rows sharded over ``model``; psum over partial int32
    accumulators (src/key_switching.rs:63-103 semantics)."""
    ks = params.ks_decomposer
    from_n = params.glwe_dimension * params.degree
    lead = ct.shape[:-1]
    digits = decompose_signed(ct[..., :from_n], ks).reshape(lead + (from_n * ks.levels,))
    local_k = ksk_mat_local.shape[0]
    if model_axis:
        shard = lax.axis_index(model_axis)
        digits = lax.dynamic_slice_in_dim(digits, shard * local_k, local_k, axis=-1)
    acc = jnp.matmul(digits, ksk_mat_local, preferred_element_type=jnp.int32)
    to_n1 = ksk_mat_local.shape[1] // NUM_LIMBS
    summ = combine_limb_accs(acc.reshape(lead + (to_n1, NUM_LIMBS)))
    summ = _psum_delta(summ, model_axis)  # combine-first: 4x less traffic
    out = -summ
    return out.at[..., -1].add(ct[..., from_n])


def _gate_local(params, impl, model_axis, model_n, tv_encoded,
                ct0, ct1, bk_c, bk_m, ksk_mat):
    ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
    approx = switch_modulus(ct_in, params.log_q, params.log_degree + 1)
    acc = _blind_rotate_local(params, approx, bk_c, bk_m, tv_encoded, impl,
                              model_axis, model_n)
    extracted = sample_extract0(acc)
    return _key_switch_local(params, extracted, ksk_mat, model_axis)


def make_sharded_gate(
    mesh: Mesh,
    params: TfheParams,
    gate: str,
    impl: str = "auto",
    use_model_axis: bool | None = None,
) -> callable:
    """Build a jitted sharded gate: (ct0, ct1, server_key) -> ct_out.

    Ciphertexts shard over ``batch``; BK/KSK rows shard over ``model`` when the
    mesh has a model axis > 1 (u32 delta psum per scan step, bit-identical to
    unsharded execution).  ``impl`` is a row-contraction backend (``auto``,
    ``conv``, ``matmul``, ``ntts``) or one of the model-axis modes ``coeffs``
    (output coefficients sharded) and ``ntt`` (NTT bins sharded).

    ``use_model_axis`` accepts True/False (explicit), None (shard whenever the
    mesh has a model axis — maximal-parallelism default used by tests), or the
    string ``"policy"`` to consult ``mesh.plan_key_placement``: replicate keys
    when they fit the per-device memory budget (zero steady-state collectives),
    row-shard them over ``model`` otherwise.
    """
    if impl not in ("auto", "conv", "matmul", "ntts", "coeffs", "ntt"):
        raise ValueError(f"impl={impl!r} has no sharded form")
    model_n = mesh.shape[MODEL_AXIS]
    if use_model_axis == "policy":
        from tfhe_jax.parallel.mesh import plan_key_placement

        use_model_axis = plan_key_placement(params, mesh).shard_bk_rows
    if use_model_axis is None:
        use_model_axis = model_n > 1
    model_axis = MODEL_AXIS if use_model_axis else None
    # multi-host: ciphertext batches shard over (host, batch) together; key
    # specs below leave host unmentioned = replicated per host (the
    # plan_key_placement policy's default), so no collective crosses hosts in
    # the batch-parallel path
    ct_axes = (
        (HOST_AXIS, BATCH_AXIS) if HOST_AXIS in mesh.axis_names else BATCH_AXIS
    )
    tv = jnp.asarray(mtv.gate_test_vector(params, gate))

    rows = (params.glwe_dimension + 1) * params.pbs_decomposer.levels
    if use_model_axis:
        if impl == "coeffs":
            assert params.degree % model_n == 0, (params.degree, model_n)
        elif impl == "ntt":
            from tfhe_jax.ops.ntt import plan_for_params

            n1 = plan_for_params(params).n1
            assert n1 % model_n == 0, (n1, model_n)
        else:
            assert rows % model_n == 0, (rows, model_n)
        k_rows = params.glwe_dimension * params.degree * params.ks_decomposer.levels
        assert k_rows % model_n == 0, (k_rows, model_n)

    # the coefficient-sharded EP needs the FULL key rows on every shard (and
    # never touches the conv kernel)
    if impl == "coeffs":
        bk_c_spec = P()
        bk_m_spec = P()
    elif impl == "ntt":
        # bk_ntt [n, P, 2, bin, RN2, CLN2]: shard the NTT-bin axis
        bk_c_spec = P()
        bk_m_spec = (
            P(None, None, None, MODEL_AXIS, None, None) if use_model_axis else P()
        )
    else:
        bk_c_spec = P(None, None, MODEL_AXIS, None) if use_model_axis else P()
        bk_m_spec = P(None, MODEL_AXIS, None, None) if use_model_axis else P()
    ksk_spec = P(MODEL_AXIS, None) if use_model_axis else P()

    f = partial(_gate_local, params, impl, model_axis,
                model_n if use_model_axis else 1, tv)
    sharded = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(ct_axes), P(ct_axes), bk_c_spec, bk_m_spec, ksk_spec),
        out_specs=P(ct_axes),
        check_vma=False,
    )

    @jax.jit
    def run(ct0, ct1, bk_conv, bk_u32, ksk_mat):
        return sharded(ct0, ct1, bk_conv, bk_u32, ksk_mat)

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
