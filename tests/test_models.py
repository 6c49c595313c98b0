"""Models layer vs golden: bit-exact u32 equality under shared randomness,
then end-to-end gate correctness through the public API."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tfhe_jax as tfhe
import tfhe_jax.golden.model as g
from tfhe_jax.models import bootstrap as mboot
from tfhe_jax.models import ggsw as mggsw
from tfhe_jax.models import glwe as mglwe
from tfhe_jax.models import keyswitch as mks
from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.keys import make_server_key
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def gaussian_u32(rng, std, shape):
    return g.f64_to_torus(rng.normal(0.0, std, size=shape))


@pytest.fixture(scope="module")
def shared():
    """Keys + keygen randomness shared between golden and JAX paths."""
    rng = np.random.default_rng(2024)
    p = TEST
    k, N, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kn = k * N
    d = dict(
        lwe_sk=rng.integers(0, 2, size=n, dtype=np.uint32),
        glwe_sk=rng.integers(0, 2, size=(k, N), dtype=np.uint32),
        bk_a=rnd_u32(rng, (n, rows, k, N)),
        bk_e=gaussian_u32(rng, p.glwe_std_dev, (n, rows, N)),
        ksk_a=rnd_u32(rng, (kn * p.ks_decomposer.levels, n)),
        ksk_e=gaussian_u32(rng, p.lwe_std_dev, (kn * p.ks_decomposer.levels,)),
    )
    bk_g, ksk_g = g.bootstrapping_key_gen(
        d["lwe_sk"], d["glwe_sk"], p, d["bk_a"], d["bk_e"], d["ksk_a"], d["ksk_e"]
    )
    server = make_server_key(
        p, d["lwe_sk"], d["glwe_sk"], d["bk_a"], d["bk_e"], d["ksk_a"], d["ksk_e"]
    )
    return d, bk_g, ksk_g, server, rng


class TestBitExactKeys:
    def test_bootstrapping_key(self, shared):
        d, bk_g, ksk_g, server, _ = shared
        assert np.array_equal(np.asarray(server.bk_u32), bk_g)

    def test_key_switching_key(self, shared):
        d, bk_g, ksk_g, server, _ = shared
        assert np.array_equal(np.asarray(server.ksk_u32), ksk_g)


class TestBitExactCiphertexts:
    def test_lwe_encrypt(self, shared):
        d, *_ = shared
        rng = np.random.default_rng(7)
        p = TEST
        a = rnd_u32(rng, (5, p.lwe_dimension))
        e = gaussian_u32(rng, p.lwe_std_dev, (5,))
        pt = g.lwe_encode(np.arange(5, dtype=np.uint32) % 4, p)
        ours = np.asarray(mlwe.encrypt(d["lwe_sk"], pt, a, e))
        for i in range(5):
            assert np.array_equal(ours[i], g.encrypt_lwe(d["lwe_sk"], pt[i], a[i], e[i]))
        # decrypt matches too
        dec = np.asarray(mlwe.decrypt(d["lwe_sk"], ours))
        for i in range(5):
            assert dec[i] == g.decrypt_lwe(d["lwe_sk"], ours[i])

    def test_glwe_encrypt_decrypt(self, shared):
        d, *_ = shared
        rng = np.random.default_rng(8)
        p = TEST
        gp = p.glwe_params()
        k, N = p.glwe_dimension, p.degree
        a = rnd_u32(rng, (k, N))
        e = gaussian_u32(rng, gp.std_dev, (N,))
        msg = rng.integers(0, 4, size=N, dtype=np.uint32)
        pt = g.glwe_encode(msg, gp)
        sk_t = mglwe.sk_toeplitz(d["glwe_sk"])
        ours = np.asarray(mglwe.encrypt(sk_t, pt, a, e))
        want = g.encrypt_glwe(d["glwe_sk"], pt, a, e)
        assert np.array_equal(ours, want)
        assert np.array_equal(
            np.asarray(mglwe.decrypt(sk_t, ours)), g.decrypt_glwe(d["glwe_sk"], want)
        )

    def test_glwe_monomial_and_decompose(self, shared):
        d, *_ = shared
        rng = np.random.default_rng(9)
        p = TEST
        ct = rnd_u32(rng, (p.glwe_dimension + 1, p.degree))
        for exp in (-700, -1, 0, 3, 511, 512, 1023):
            ours = np.asarray(mglwe.mul_monomial(ct, exp))
            want = g.glwe_mul_monomial(ct, exp)
            assert np.array_equal(ours, want), exp
        dec_ours = np.asarray(mglwe.decompose(ct, p.pbs_decomposer))
        dec_want = g.digits_to_signed(
            g.decompose_glwe(ct, p.pbs_decomposer), p.pbs_decomposer
        )
        assert np.array_equal(dec_ours, dec_want.astype(np.int8))


class TestBitExactOps:
    def test_external_product(self, shared):
        d, bk_g, _, server, _ = shared
        rng = np.random.default_rng(10)
        p = TEST
        ct = rnd_u32(rng, (p.glwe_dimension + 1, p.degree))
        want = g.external_product(bk_g[1], ct, p)
        for impl in ("conv", "matmul"):
            ours = np.asarray(
                mggsw.external_product(server.bk_u32[1], ct[None], p, impl=impl)
            )[0]
            assert np.array_equal(ours, want), impl

    def test_cmux(self, shared):
        d, bk_g, _, server, _ = shared
        rng = np.random.default_rng(11)
        p = TEST
        c0 = rnd_u32(rng, (p.glwe_dimension + 1, p.degree))
        c1 = rnd_u32(rng, (p.glwe_dimension + 1, p.degree))
        want = g.cmux(bk_g[2], c0, c1, p)
        ours = np.asarray(mggsw.cmux(server.bk_u32[2], c0[None], c1[None], p))[0]
        assert np.array_equal(ours, want)

    def test_key_switch(self, shared):
        d, _, ksk_g, server, _ = shared
        rng = np.random.default_rng(12)
        p = TEST
        kn = p.glwe_dimension * p.degree
        ct = rnd_u32(rng, (3, kn + 1))
        ours = np.asarray(
            mks.key_switch(ct, kn, p.ks_decomposer, server.ksk_mat)
        )
        for i in range(3):
            want = g.key_switch_lwe(ct[i], kn, p.lwe_dimension, p.ks_decomposer, ksk_g)
            assert np.array_equal(ours[i], want)

    def test_sample_extract(self, shared):
        rng = np.random.default_rng(13)
        p = TEST
        ct = rnd_u32(rng, (2, p.glwe_dimension + 1, p.degree))
        ours = np.asarray(mboot.sample_extract0(ct))
        for i in range(2):
            want = g.sample_extract(ct[i], p.glwe_params(), 0)
            assert np.array_equal(ours[i], want)


class TestBitExactBootstrap:
    @pytest.mark.parametrize("impl", ["conv", "matmul"])
    def test_full_pbs_bit_exact(self, shared, impl):
        """The keystone test: the entire PBS pipeline produces bit-identical
        ciphertexts to the golden model."""
        d, bk_g, ksk_g, server, _ = shared
        rng = np.random.default_rng(14)
        p = TEST
        tv_clear = g.construct_identity_test_vector(p)
        tv_enc = jnp.asarray(mtv.identity_test_vector(p))
        for m in range(4):
            a = rnd_u32(rng, (p.lwe_dimension,))
            e = gaussian_u32(rng, p.lwe_std_dev, ())
            ct = g.encrypt_lwe(d["lwe_sk"], g.lwe_encode(m, p), a, e)
            want = g.bootstrap(ct, bk_g, ksk_g, tv_clear, p)
            ours = np.asarray(
                mboot.pbs(p, ct[None], server, tv_enc, impl=impl)
            )[0]
            assert np.array_equal(ours, want), (impl, m)

    def test_full_pbs_bit_exact_ntt(self, shared):
        """Block-NTT backend (ops/ntt.py, impl='ntt') end-to-end: the whole
        PBS with the NTT-domain-resident key is bit-identical to golden."""
        from tfhe_jax.models.keys import with_ntt_key

        d, bk_g, ksk_g, server, _ = shared
        rng = np.random.default_rng(21)
        p = TEST
        server_ntt = with_ntt_key(server)
        tv_clear = g.construct_identity_test_vector(p)
        tv_enc = jnp.asarray(mtv.identity_test_vector(p))
        a = rnd_u32(rng, (2, p.lwe_dimension))
        e = gaussian_u32(rng, p.lwe_std_dev, (2,))
        cts = np.stack([
            g.encrypt_lwe(d["lwe_sk"], g.lwe_encode(m, p), a[m], e[m])
            for m in range(2)
        ])
        want = np.stack([g.bootstrap(cts[i], bk_g, ksk_g, tv_clear, p)
                         for i in range(2)])
        ours = np.asarray(mboot.pbs(p, cts, server_ntt, tv_enc, impl="ntt"))
        assert np.array_equal(ours, want)

    def test_full_pbs_bit_exact_ntt_streaming(self, shared):
        """Streaming NTT backend (impl='ntts'): per-step key transform inside
        the scan, no resident NTT key — bit-identical to golden.  This is the
        NTT mode for parameter sets whose resident NTT key would not fit the
        device (models/keys.py:with_ntt_key guard)."""
        d, bk_g, ksk_g, server, _ = shared
        rng = np.random.default_rng(27)
        p = TEST
        tv_clear = g.construct_identity_test_vector(p)
        tv_enc = jnp.asarray(mtv.identity_test_vector(p))
        a = rnd_u32(rng, (2, p.lwe_dimension))
        e = gaussian_u32(rng, p.lwe_std_dev, (2,))
        cts = np.stack([
            g.encrypt_lwe(d["lwe_sk"], g.lwe_encode(m, p), a[m], e[m])
            for m in range(2)
        ])
        want = np.stack([g.bootstrap(cts[i], bk_g, ksk_g, tv_clear, p)
                         for i in range(2)])
        ours = np.asarray(mboot.pbs(p, cts, server, tv_enc, impl="ntts"))
        assert np.array_equal(ours, want)


NANO = get_params("nano")


class TestBackendsBitExactNano:
    """Every plain backend bit-exact against ``conv`` at nano shapes (N=64,
    n=4) and odd/even batches; ``conv`` itself is golden-pinned at
    test_insecure above.  BMMP runs another rotation (other noise), so it is
    pinned to itself: bit-identical through every contraction, and decoding
    to the same messages as ``conv``."""

    @pytest.fixture(scope="class")
    def env(self):
        from tfhe_jax.models.keys import with_ntt_key

        p = NANO
        ck, sk = tfhe.keygen(p, jax.random.key(5), bmmp=True)
        sk = with_ntt_key(sk)
        rng = np.random.default_rng(77)
        msgs = rng.integers(0, 1 << p.log_p, size=8).astype(np.uint32)
        cts = tfhe.encrypt(ck, msgs, key=78)
        tv = jnp.asarray(mtv.identity_test_vector(p))
        ref = np.asarray(mboot.pbs(p, cts, sk, tv, impl="conv"))
        return p, ck, sk, cts, msgs, tv, ref

    @pytest.mark.parametrize("batch", [1, 3, 8])
    @pytest.mark.parametrize("impl", ["matmul", "ntt", "ntts"])
    def test_pbs_matches_conv(self, env, impl, batch):
        p, ck, sk, cts, msgs, tv, ref = env
        got = np.asarray(mboot.pbs(p, cts[:batch], sk, tv, impl=impl))
        assert np.array_equal(got, ref[:batch]), impl

    @pytest.mark.parametrize("batch", [1, 3, 8])
    def test_bmmp_contractions_agree(self, env, batch):
        from tfhe_jax.ops.torus import switch_modulus

        p, ck, sk, cts, msgs, tv, ref = env
        approx = switch_modulus(cts[:batch], p.log_q, p.log_degree + 1)
        accs = [np.asarray(mboot._blind_rotate_bmmp(p, approx, sk.bk_bmmp, tv, c))
                for c in ("conv", "matmul", "ntts")]
        assert all(np.array_equal(a, accs[0]) for a in accs[1:])
        # the default contraction is one of them, and the PBS decodes right
        out = mboot.pbs(p, cts[:batch], sk, tv, impl="bmmp")
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), msgs[:batch])
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)),
                              np.asarray(tfhe.decrypt(ck, ref[:batch])))


class TestImplChoice:
    """``resolve_impl``: the backend ``auto`` picks from platform and batch."""

    @pytest.mark.parametrize("platform,batch,want", [
        ("cpu", 1, "conv"),
        ("cpu", 4096, "conv"),
        ("gpu", 1, "ntts"),
        ("gpu", mboot.GPU_NTTS_MAX_BATCH, "ntts"),
        ("gpu", mboot.GPU_NTTS_MAX_BATCH + 1, "matmul"),
        ("gpu", 4096, "matmul"),
    ])
    def test_auto(self, monkeypatch, platform, batch, want):
        monkeypatch.setattr(mboot.jax, "default_backend", lambda: platform)
        assert mboot.resolve_impl("auto", batch) == want

    def test_explicit_impl_passes_through(self, monkeypatch):
        monkeypatch.setattr(mboot.jax, "default_backend", lambda: "gpu")
        for impl in mboot.VALID_IMPLS[1:]:
            assert mboot.resolve_impl(impl, 1) == impl

    def test_valid_impls_are_the_plain_backends(self):
        assert mboot.VALID_IMPLS == ("auto", "conv", "matmul", "ntt", "ntts", "bmmp")

    @pytest.mark.parametrize("impl", ["pallas", "fusedb", "fusedl", "nttf_interpret"])
    def test_removed_backend_is_refused(self, impl):
        p = NANO
        approx = jnp.zeros((2, p.lwe_dimension + 1), jnp.uint32)
        tv = jnp.zeros((p.degree,), jnp.uint32)
        with pytest.raises(ValueError, match="unknown impl"):
            mboot.blind_rotate(p, approx, None, tv, impl=impl)

    def test_missing_keys_are_refused(self):
        p = NANO
        _, sk = tfhe.keygen(p, jax.random.key(6))
        approx = jnp.zeros((2, p.lwe_dimension + 1), jnp.uint32)
        tv = jnp.zeros((p.degree,), jnp.uint32)
        for impl, what in (("bmmp", "bmmp=True"), ("ntt", "with_ntt_key")):
            with pytest.raises(ValueError, match=what):
                mboot.blind_rotate(p, approx, sk, tv, impl=impl)


class TestSampleExtractGeneral:
    def test_arbitrary_index_vs_golden(self, shared):
        rng = np.random.default_rng(17)
        p = TEST
        ct = rnd_u32(rng, (2, p.glwe_dimension + 1, p.degree))
        for idx in (0, 1, 17, p.degree // 2, p.degree - 1):
            ours = np.asarray(mboot.sample_extract(ct, idx))
            for i in range(2):
                want = g.sample_extract(ct[i], p.glwe_params(), idx)
                assert np.array_equal(ours[i], want), idx

    def test_batched_per_sample_indices(self, shared):
        rng = np.random.default_rng(18)
        p = TEST
        ct = rnd_u32(rng, (3, p.glwe_dimension + 1, p.degree))
        idxs = np.array([3, 500, 0], dtype=np.int32)
        ours = np.asarray(mboot.sample_extract(ct, idxs))
        for i in range(3):
            want = g.sample_extract(ct[i], p.glwe_params(), int(idxs[i]))
            assert np.array_equal(ours[i], want), i


class TestClearSimulationOracle:
    """Port of the reference's clear-simulation oracle
    (src/bootstrapping.rs:232-287): re-run the blind rotation in plaintext
    with the secret key (explicit mod-2N index tracking) and assert the
    homomorphic accumulator decrypts to exactly the predicted rotated test
    vector plus noise below Delta/2 — pinpointing sign/index bugs directly
    instead of as opaque decode failures."""

    @pytest.mark.parametrize("impl", ["conv", "matmul"])
    def test_blind_rotate_matches_clear_simulation(self, shared, impl):
        from tfhe_jax.ops.torus import switch_modulus as jsm, u32 as ju32

        d, bk_g, ksk_g, server, _ = shared
        rng = np.random.default_rng(19)
        p = TEST
        tv_clear = g.construct_identity_test_vector(p)
        tv_enc = jnp.asarray(mtv.identity_test_vector(p))
        for m in range(1 << p.log_p):
            a = rnd_u32(rng, (p.lwe_dimension,))
            e = gaussian_u32(rng, p.lwe_std_dev, ())
            ct = g.encrypt_lwe(d["lwe_sk"], g.lwe_encode(m, p), a, e)
            predicted = g.blind_rotate_in_clear(ct, d["lwe_sk"], tv_clear, p)
            approx = np.asarray(jsm(ju32(ct[None]), p.log_q, p.log_degree + 1))
            acc = np.asarray(
                mboot.blind_rotate(p, approx, server, tv_enc, impl=impl)
            )[0]
            phase = g.decrypt_glwe(d["glwe_sk"], acc)
            diff = (phase - predicted).astype(np.int64)
            diff = np.where(diff >= 1 << 31, diff - (1 << 32), diff)
            assert np.abs(diff).max() < p.delta // 2, (impl, m)
            # and the predicted coefficient 0 decodes to the identity LUT value
            ext = g.sample_extract(acc, p.glwe_params(), 0)
            got = int(g.lwe_decode(g.decrypt_lwe(flat_sk(d), ext), p))
            pred = int(g.lwe_decode(predicted[0], p))
            assert got == pred, (impl, m)


def flat_sk(d):
    return g.flatten_glwe_sk(d["glwe_sk"])


class TestEndToEnd:
    @pytest.fixture(scope="class")
    def jax_keys(self):
        return tfhe.keygen(TEST, jax.random.key(123))

    def test_encrypt_decrypt(self, jax_keys):
        ck, _ = jax_keys
        msgs = np.array([0, 1, 2, 3, 1, 0], dtype=np.uint32)
        cts = tfhe.encrypt(ck, msgs, key=5)
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, cts)), msgs)

    @pytest.mark.parametrize("gate", ["and", "or", "xor", "nand", "nor", "xnor"])
    def test_gate_truth_table(self, jax_keys, gate):
        ck, sk = jax_keys
        lhs = np.array([0, 0, 1, 1], dtype=np.uint32)
        rhs = np.array([0, 1, 0, 1], dtype=np.uint32)
        c1 = tfhe.encrypt(ck, lhs, key=20)
        c0 = tfhe.encrypt(ck, rhs, key=21)
        out = tfhe.gates.gate(sk, gate, c0, c1)
        got = np.asarray(tfhe.decrypt(ck, out))
        want = np.array([mtv.GATE_FNS[gate](int(l), int(r)) for l, r in zip(lhs, rhs)])
        assert np.array_equal(got, want), gate

    def test_not_gate(self, jax_keys):
        ck, sk = jax_keys
        bits = np.array([0, 1, 1, 0], dtype=np.uint32)
        out = tfhe.gates.not_(sk, tfhe.encrypt(ck, bits, key=30))
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), 1 - bits)

    def test_mux(self, jax_keys):
        ck, sk = jax_keys
        sel = np.array([0, 0, 1, 1], dtype=np.uint32)
        a = np.array([0, 1, 0, 1], dtype=np.uint32)
        b = np.array([1, 0, 1, 0], dtype=np.uint32)
        out = tfhe.gates.mux(
            sk,
            tfhe.encrypt(ck, sel, key=31),
            tfhe.encrypt(ck, a, key=32),
            tfhe.encrypt(ck, b, key=33),
        )
        want = np.where(sel == 1, a, b)
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), want)

    def test_identity_bootstrap(self, jax_keys):
        ck, sk = jax_keys
        msgs = np.array([0, 1, 2, 3], dtype=np.uint32)
        out = tfhe.bootstrap_identity(sk, tfhe.encrypt(ck, msgs, key=40))
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), msgs)


class TestNegativePhaseWrap:
    """Regression: a negative blind-rotation index must extract the pre-negated
    top coefficient of the test vector and decode correctly mod 2^log_p
    (the padding-bit alias; src/test_vector.rs:54-64 + src/lwe.rs:105).
    This failed for NAND(0,0) with negative input noise before the decode-mask
    fix -- statistically ~50% of (0,0) gate evaluations."""

    def test_forced_negative_phase(self, shared):
        d, bk_g, ksk_g, server, _ = shared
        p = TEST
        # trivial LWE of value 0 with explicitly negative phase: b = -epsilon
        eps = np.uint32(1 << 20)  # well within half a block
        ct = np.zeros((p.lwe_dimension + 1,), dtype=np.uint32)
        ct[-1] = np.uint32(0) - eps
        tv = jnp.asarray(mtv.gate_test_vector(p, "nand"))
        out = np.asarray(mboot.pbs(p, ct[None], server, tv))[0]
        from tfhe_jax.ops.torus import decode as t_decode

        got = int(t_decode(g.decrypt_lwe(d["lwe_sk"], out), p.log_q, p.log_p, p.padding_bits))
        assert got == 1  # NAND(0,0) = 1 even with negative phase

    def test_gate_00_both_noise_signs(self, shared):
        d, bk_g, ksk_g, server, _ = shared
        p = TEST
        tv = jnp.asarray(mtv.gate_test_vector(p, "nand"))
        for eps in (np.uint32(1 << 20), np.uint32(0) - np.uint32(1 << 20)):
            ct = np.zeros((p.lwe_dimension + 1,), dtype=np.uint32)
            ct[-1] = eps
            out = np.asarray(mboot.pbs(p, ct[None], server, tv))[0]
            from tfhe_jax.ops.torus import decode as t_decode

            got = int(
                t_decode(g.decrypt_lwe(d["lwe_sk"], out), p.log_q, p.log_p, p.padding_bits)
            )
            assert got == 1, eps


class TestThreeInputGates:
    """3-input gates via 4c2+2c1+c0 (notes/Boolean Gates.md:7-11) on the
    log_p=3 profile, plus the generic LUT bootstrap."""

    @pytest.fixture(scope="class")
    def keys3(self):
        return tfhe.keygen(get_params("test_insecure_3in"), jax.random.key(321))

    @pytest.mark.parametrize("gate", ["mux", "maj", "and3", "xor3"])
    def test_gate3_truth_table(self, keys3, gate):
        ck, sk = keys3
        f = mtv.GATE3_FNS[gate]
        bits = np.array([[ (i>>2)&1, (i>>1)&1, i&1 ] for i in range(8)], np.uint32)
        c2 = tfhe.encrypt(ck, bits[:, 0], key=60)
        c1 = tfhe.encrypt(ck, bits[:, 1], key=61)
        c0 = tfhe.encrypt(ck, bits[:, 2], key=62)
        out = tfhe.gates.gate3(sk, gate, c2, c1, c0)
        got = np.asarray(tfhe.decrypt(ck, out))
        want = np.array([f(int(r[0]), int(r[1]), int(r[2])) for r in bits])
        assert np.array_equal(got, want), gate

    def test_apply_lut_generic(self, keys3):
        ck, sk = keys3
        lut = [3, 1, 4, 1, 5, 2, 6, 5]  # arbitrary function Z_8 -> Z_8... values < 8
        msgs = np.arange(8, dtype=np.uint32)
        cts = tfhe.encrypt(ck, msgs, key=63)
        out = tfhe.gates.apply_lut(sk, cts, lut)
        got = np.asarray(tfhe.decrypt(ck, out))
        assert np.array_equal(got, np.array(lut))


class TestBmmp:
    """BMMP halved-depth bootstrapping (notes/BMMP Bootstrapping.md:15-25) —
    documented in the reference but implemented only here."""

    @pytest.fixture(scope="class")
    def bmmp_keys(self):
        return tfhe.keygen(TEST, jax.random.key(777), bmmp=True)

    def test_key_shape(self, bmmp_keys):
        _, sk = bmmp_keys
        p = TEST
        rows = (p.glwe_dimension + 1) * p.pbs_decomposer.levels
        assert sk.bk_bmmp.shape == (
            p.lwe_dimension // 2, 3 * rows, p.glwe_dimension + 1, p.degree
        )

    @pytest.mark.parametrize("gate", ["nand", "xor"])
    def test_gates_via_bmmp(self, bmmp_keys, gate):
        ck, sk = bmmp_keys
        lhs = np.array([0, 0, 1, 1], dtype=np.uint32)
        rhs = np.array([0, 1, 0, 1], dtype=np.uint32)
        c1 = tfhe.encrypt(ck, lhs, key=70)
        c0 = tfhe.encrypt(ck, rhs, key=71)
        out = tfhe.gates.gate(sk, gate, c0, c1, impl="bmmp")
        got = np.asarray(tfhe.decrypt(ck, out))
        want = np.array([mtv.GATE_FNS[gate](int(l), int(r)) for l, r in zip(lhs, rhs)])
        assert np.array_equal(got, want), gate

    def test_noise_margin(self, bmmp_keys):
        from tfhe_jax.utils import noise as unoise

        ck, sk = bmmp_keys
        msgs = np.array([0, 1, 2, 3], dtype=np.uint32)
        out = tfhe.bootstrap_identity(sk, tfhe.encrypt(ck, msgs, key=72),
                                      impl="bmmp")
        rep = unoise.measure(ck, out, msgs)
        assert rep.failures == 0
        assert rep.max_abs_over_delta < 0.5
