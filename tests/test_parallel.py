"""Multi-chip sharding tests on a virtual 8-device CPU mesh.

Shard-invariance is the contract: the sharded gate must produce bit-identical
ciphertexts to single-device execution (int32 partial-accumulator psum is
exact; SURVEY.md section 4 test plan, item d).
"""

import numpy as np
import jax
import pytest

import tfhe_jax as tfhe
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.parallel.mesh import make_mesh
from tfhe_jax.parallel.sharded import make_sharded_gate
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")


@pytest.fixture(scope="module")
def keys():
    return tfhe.keygen(TEST, jax.random.key(99))


@pytest.fixture(scope="module")
def cts(keys):
    ck, _ = keys
    rng = np.random.default_rng(3)
    lhs = rng.integers(0, 2, size=8).astype(np.uint32)
    rhs = rng.integers(0, 2, size=8).astype(np.uint32)
    return (
        lhs,
        rhs,
        tfhe.encrypt(ck, rhs, key=50),  # ct0
        tfhe.encrypt(ck, lhs, key=51),  # ct1
    )


@pytest.fixture(scope="module")
def reference_out(keys, cts):
    _, sk = keys
    _, _, ct0, ct1 = cts
    return np.asarray(tfhe.gates.gate(sk, "nand", ct0, ct1))


def test_requires_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_batch_model_sharded_bit_exact(keys, cts, reference_out, shape):
    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    mesh = make_mesh(batch=shape[0], model=shape[1])
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="conv")
    out = np.asarray(gate_fn(ct0, ct1, sk))
    assert np.array_equal(out, reference_out), shape
    got = np.asarray(tfhe.decrypt(ck, out))
    assert np.array_equal(got, 1 - (lhs & rhs))


def test_model_sharded_matmul_impl(keys, cts, reference_out):
    _, sk = keys
    _, _, ct0, ct1 = cts
    mesh = make_mesh(batch=4, model=2)
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="matmul")
    out = np.asarray(gate_fn(ct0, ct1, sk))
    assert np.array_equal(out, reference_out)


def test_model_axis_divisibility_guards():
    """Mesh/model-axis sizes that do not divide the BK row count R=18 (or the
    KSK row count) must be rejected at gate-construction time, not fail
    opaquely inside the scan."""
    # model=8 does not divide R=18 -> reject
    with pytest.raises(AssertionError):
        make_sharded_gate(make_mesh(batch=1, model=8), TEST, "nand")
    # model=4 does not divide R=18 either (18 % 4 != 0) -> reject
    with pytest.raises(AssertionError):
        make_sharded_gate(make_mesh(batch=2, model=4), TEST, "nand")


def test_model_axis_3way_not_dividing_coeffs():
    """The coefficient-sharded (SP analog) gate requires model | N."""
    bad = TEST.replace(log_degree=9)  # N=512; model=8 divides -> accepted
    make_sharded_gate(make_mesh(batch=1, model=8), bad, "nand", impl="coeffs")
    with pytest.raises(AssertionError):
        # N=64 with model=8 divides; shrink to N=4 < 8 -> rejected
        make_sharded_gate(
            make_mesh(batch=1, model=8), TEST.replace(log_degree=1), "nand",
            impl="coeffs",
        )


@pytest.mark.parametrize("model", [2, 4])
def test_coeff_sharded_bit_exact(keys, cts, reference_out, model):
    """SP-analog: output coefficients sharded over model, reassembled by
    all_gather — bit-identical to single-device execution."""
    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    mesh = make_mesh(batch=8 // model, model=model)
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="coeffs")
    out = np.asarray(gate_fn(ct0, ct1, sk))
    assert np.array_equal(out, reference_out)
    got = np.asarray(tfhe.decrypt(ck, out))
    assert np.array_equal(got, 1 - (lhs & rhs))


@pytest.mark.parametrize("shape,m_micro", [((2, 4), 3), ((4, 2), 2), ((1, 4), 5)])
def test_pipeline_parallel_bit_exact(keys, cts, shape, m_micro):
    """Pipeline-parallel rotation (ppermute stage hops) is bit-identical to
    the single-device scan, for several (batch, stage) splits and queue
    depths (including a deeper-than-stages queue and a 1-wide batch axis)."""
    from tfhe_jax.parallel.mesh import make_pipeline_mesh
    from tfhe_jax.parallel.pipeline import make_pipelined_gate

    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    batch_sz, stages = shape
    # queue of M microbatches: replicate the 8-ct batch with varied keys
    lhs_q = np.stack([np.roll(lhs, i) for i in range(m_micro)])
    rhs_q = np.stack([np.roll(rhs, i) for i in range(m_micro)])
    ct1_q = np.stack([np.asarray(tfhe.encrypt(ck, l, key=100 + i))
                      for i, l in enumerate(lhs_q)])
    ct0_q = np.stack([np.asarray(tfhe.encrypt(ck, r, key=200 + i))
                      for i, r in enumerate(rhs_q)])

    want = np.stack([
        np.asarray(tfhe.gates.gate(sk, "nand", ct0_q[i], ct1_q[i], impl="conv"))
        for i in range(m_micro)
    ])

    mesh = make_pipeline_mesh(batch=batch_sz, stage=stages,
                              devices=jax.devices()[: batch_sz * stages])
    gate_fn = make_pipelined_gate(mesh, TEST, "nand", impl="conv")
    out = np.asarray(gate_fn(ct0_q, ct1_q, sk))
    assert np.array_equal(out, want), shape
    got = np.asarray(tfhe.decrypt(ck, out.reshape(-1, out.shape[-1])))
    assert np.array_equal(got, (1 - (lhs_q & rhs_q)).reshape(-1))


@pytest.mark.parametrize("impl", ["ntts", "auto"])
def test_row_sharded_plain_backends_bit_exact(keys, cts, reference_out, impl):
    """BK-row TP through the streaming-NTT contraction (exact mod 2^32 on the
    local rows, u32 deltas psum'd) and through ``auto``: bit-identical to
    single-device execution."""
    _, sk = keys
    _, _, ct0, ct1 = cts
    mesh = make_mesh(batch=4, model=2)
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl=impl)
    out = np.asarray(gate_fn(ct0, ct1, sk))
    assert np.array_equal(out, reference_out)


@pytest.mark.parametrize("impl", ["bmmp", "pallas"])
def test_sharded_gate_refuses_unsharded_backends(impl):
    with pytest.raises(ValueError, match="no sharded form"):
        make_sharded_gate(make_mesh(batch=8, model=1), TEST, "nand", impl=impl)


def test_host_mesh_bit_exact(keys, cts, reference_out):
    """3-axis (host, batch, model) mesh — ciphertexts shard over
    (host, batch), keys replicated per host, BK rows sharded over model —
    is bit-identical to single-device execution."""
    from tfhe_jax.parallel.mesh import make_host_mesh

    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    mesh = make_host_mesh(host=2, batch=2, model=2)
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="conv")
    out = np.asarray(gate_fn(ct0, ct1, sk))
    assert np.array_equal(out, reference_out)
    got = np.asarray(tfhe.decrypt(ck, out))
    assert np.array_equal(got, 1 - (lhs & rhs))


def test_key_placement_policy():
    """BK placement: replicate under the memory budget, row-shard over model
    above it (SURVEY.md section 2.2 row 5)."""
    from tfhe_jax.parallel.mesh import make_host_mesh, plan_key_placement

    d128 = get_params("default_128")
    mesh = make_host_mesh(host=2, batch=2, model=2)
    pl = plan_key_placement(d128, mesh, hbm_bytes=1 << 30)  # 95 MB vs 256 MB
    assert not pl.shard_bk_rows
    tight = plan_key_placement(d128, mesh, hbm_bytes=128 << 20, budget_frac=0.25)
    assert tight.shard_bk_rows
    assert tight.per_device_key_bytes < pl.per_device_key_bytes


def test_pipeline_auto_bit_exact(keys, cts):
    """Pipeline stages with ``auto`` (resolved on the local microbatch) are
    bit-identical to the single-device conv path."""
    from tfhe_jax.parallel.mesh import make_pipeline_mesh
    from tfhe_jax.parallel.pipeline import make_pipelined_gate

    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    want = np.asarray(tfhe.gates.gate(sk, "nand", ct0, ct1, impl="conv"))
    mesh = make_pipeline_mesh(batch=4, stage=2)
    out = np.asarray(make_pipelined_gate(mesh, TEST, "nand")(
        np.asarray(ct0)[None], np.asarray(ct1)[None], sk))
    assert np.array_equal(out[0], want)


def test_pipeline_ntt_bit_exact(keys, cts):
    """Pipeline stages running the block-NTT contraction are bit-identical
    to the single-device conv path (bk_ntt sliced by stage)."""
    from tfhe_jax.models.keys import with_ntt_key
    from tfhe_jax.parallel.mesh import make_pipeline_mesh
    from tfhe_jax.parallel.pipeline import make_pipelined_gate

    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    sk_ntt = with_ntt_key(sk)
    ct0_q = np.asarray(ct0)[None]
    ct1_q = np.asarray(ct1)[None]
    want = np.asarray(tfhe.gates.gate(sk, "nand", ct0, ct1, impl="conv"))
    mesh = make_pipeline_mesh(batch=4, stage=2)
    gate_fn = make_pipelined_gate(mesh, TEST, "nand", impl="ntt")
    out = np.asarray(gate_fn(ct0_q, ct1_q, sk_ntt))
    assert np.array_equal(out[0], want)


class TestCollectiveTraffic:
    """Machine-check of the ARCHITECTURE wire-traffic table: the collective
    payloads of every sharded mode are read out of the COMPILED gate's HLO
    (post-SPMD) on the virtual mesh and asserted equal to the closed-form
    model in ``parallel/traffic.py``.  Catches any regression that silently
    moves raw int32 limb planes instead of combined u32 deltas (4x the wire
    bytes)."""

    def _abstract_args(self, p, batch, impl, m_micro=0):
        import jax.numpy as jnp

        k1 = p.glwe_dimension + 1
        rows = k1 * p.pbs_decomposer.levels
        n, n_deg = p.lwe_dimension, p.degree
        S = jax.ShapeDtypeStruct
        ct_shape = (m_micro, batch, n + 1) if m_micro else (batch, n + 1)
        ct = S(ct_shape, jnp.uint32)
        bk_conv = S((n, k1 * 4, rows, n_deg), jnp.int8)
        if impl == "ntt":
            from tfhe_jax.ops.ntt import PRIMES, plan_for_params

            plan = plan_for_params(p)
            bk_rows = S(
                (n, len(PRIMES), 2, plan.n1, rows * plan.n2,
                 k1 * plan.key_limbs * plan.n2),
                jnp.int8,
            )
        else:
            bk_rows = S((n, rows, k1, n_deg), jnp.uint32)
        ksk = S(
            (p.glwe_dimension * n_deg * p.ks_decomposer.levels, (n + 1) * 4),
            jnp.int8,
        )
        return ct, ct, bk_conv, bk_rows, ksk

    def _audit(self, gate_fn, p, batch, impl, m_micro=0):
        from tfhe_jax.parallel.traffic import gate_collectives

        args = self._abstract_args(p, batch, impl, m_micro)
        got = {}
        for c in gate_collectives(gate_fn.run_jit, *args):
            got.setdefault(c.kind, set()).add(c.bytes)
        return got

    @pytest.mark.parametrize(
        "impl,mode", [("matmul", "tp"), ("coeffs", "coeffs"), ("ntt", "ntt")]
    )
    def test_model_axis_payloads_match_model(self, impl, mode):
        from tfhe_jax.parallel.traffic import expected_collectives

        mesh = make_mesh(batch=4, model=2)
        gate_fn = make_sharded_gate(mesh, TEST, "nand", impl=impl,
                                    use_model_axis=True)
        got = self._audit(gate_fn, TEST, batch=8, impl=impl)
        want = expected_collectives(TEST, mode, batch_local=2)
        assert got == want, (got, want)

    def test_dp_has_no_steady_state_collectives(self):
        mesh = make_mesh(batch=8, model=1)
        gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="matmul")
        got = self._audit(gate_fn, TEST, batch=8, impl="matmul")
        assert got == {}, got

    def test_pipeline_payloads_match_model(self):
        from tfhe_jax.parallel.mesh import make_pipeline_mesh
        from tfhe_jax.parallel.pipeline import make_pipelined_gate
        from tfhe_jax.parallel.traffic import expected_collectives

        m_micro = 3
        mesh = make_pipeline_mesh(batch=4, stage=2)
        gate_fn = make_pipelined_gate(mesh, TEST, "nand", impl="matmul")
        got = self._audit(gate_fn, TEST, batch=8, impl="matmul",
                          m_micro=m_micro)
        want = expected_collectives(TEST, "pp", batch_local=2,
                                    m_microbatches=m_micro)
        assert got == want, (got, want)

    def test_section_9_1_table_values(self):
        """The per-sample/step wire-byte numbers in the ARCHITECTURE wire
        table at default_128 derive from the same payload model the HLO
        checks above pin to the code."""
        from tfhe_jax.parallel.traffic import wire_bytes_per_sample_step

        d128 = get_params("default_128")
        # TP: 2*(D-1)/D * (k+1)*N*4 -> 6144 at D=2, up to 12288
        assert wire_bytes_per_sample_step(d128, "tp", 2) == 6144.0
        assert abs(wire_bytes_per_sample_step(d128, "tp", 1024) - 12288) < 24
        # SP coeffs: half the TP bytes (gather, not ring all-reduce)
        assert wire_bytes_per_sample_step(d128, "coeffs", 2) == 3072.0
        # DP: zero steady-state
        assert wire_bytes_per_sample_step(d128, "dp", 8) == 0.0
        # PP: one 6 KB hop per stage boundary amortized over n=722 steps
        pp = wire_bytes_per_sample_step(d128, "pp", 4)
        assert abs(pp - 6144 * 3 / 722) < 0.01
        # NTT-bin: orders of magnitude above the rest
        assert wire_bytes_per_sample_step(d128, "ntt", 2) > 100_000


def test_ntt_bin_sharded_bit_exact(keys, cts, reference_out):
    """Sharded-NTT external product (NTT bins over the model axis, raw INTT
    limb planes psum'd per step) is bit-identical to single-device conv."""
    from tfhe_jax.models.keys import with_ntt_key

    ck, sk = keys
    lhs, rhs, ct0, ct1 = cts
    sk_ntt = with_ntt_key(sk)
    mesh = make_mesh(batch=4, model=2)
    gate_fn = make_sharded_gate(mesh, TEST, "nand", impl="ntt")
    out = np.asarray(gate_fn(ct0, ct1, sk_ntt))
    assert np.array_equal(out, reference_out)
    got = np.asarray(tfhe.decrypt(ck, out))
    assert np.array_equal(got, 1 - (lhs & rhs))
