"""Self-consistency tests for the NumPy golden model.

These replace the reference's eyeball/`dbg!` tests with real assertions
(reference test inventory: SURVEY.md section 4).  The golden model must pass
its own semantic tests before it can serve as the oracle for the JAX path.
"""

import numpy as np
import pytest

import tfhe_jax.golden.model as g
from tfhe_jax.params import DecomposerParams, get_params

TEST = get_params("test_insecure")


def gaussian_u32(rng, std_dev, shape):
    return g.f64_to_torus(rng.normal(0.0, std_dev, size=shape))


def make_keys(rng, params):
    lwe_sk = rng.integers(0, 2, size=params.lwe_dimension, dtype=np.uint32)
    glwe_sk = rng.integers(
        0, 2, size=(params.glwe_dimension, params.degree), dtype=np.uint32
    )
    return lwe_sk, glwe_sk


def encrypt_lwe_rng(rng, sk, pt, params):
    a = rng.integers(0, 1 << 32, size=sk.shape[0], dtype=np.uint32)
    e = gaussian_u32(rng, params.lwe_std_dev, ())
    return g.encrypt_lwe(sk, np.uint32(pt), a, e)


def encrypt_glwe_rng(rng, sk, pt, params):
    gp = params.glwe_params()
    a = rng.integers(0, 1 << 32, size=(gp.glwe_dimension, gp.degree), dtype=np.uint32)
    e = gaussian_u32(rng, gp.std_dev, gp.degree)
    return g.encrypt_glwe(sk, pt, a, e)


def encrypt_ggsw_rng(rng, sk, message, params):
    dp = params.pbs_decomposer
    k = params.glwe_dimension
    rows = (k + 1) * dp.levels
    a = rng.integers(0, 1 << 32, size=(rows, k, params.degree), dtype=np.uint32)
    e = gaussian_u32(rng, params.glwe_std_dev, (rows, params.degree))
    return g.encrypt_ggsw(sk, message, params, a, e)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(42)
    return make_keys(rng, TEST)


@pytest.fixture(scope="module")
def bootstrap_keys(keys):
    """BK + KSK at test params with RNG-drawn randomness."""
    rng = np.random.default_rng(43)
    lwe_sk, glwe_sk = keys
    p = TEST
    k, N, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    bk_a = rng.integers(0, 1 << 32, size=(n, rows, k, N), dtype=np.uint32)
    bk_e = gaussian_u32(rng, p.glwe_std_dev, (n, rows, N))
    kn = k * N
    ksk_a = rng.integers(
        0, 1 << 32, size=(kn * p.ks_decomposer.levels, n), dtype=np.uint32
    )
    ksk_e = gaussian_u32(rng, p.lwe_std_dev, kn * p.ks_decomposer.levels)
    return g.bootstrapping_key_gen(lwe_sk, glwe_sk, p, bk_a, bk_e, ksk_a, ksk_e)


# ---------------------------------------------------------------------------
# decomposer
# ---------------------------------------------------------------------------


class TestDecomposer:
    P = DecomposerParams(log_base=4, levels=7, log_q=32)

    def test_recompose_roundtrip_range(self):
        # port of the exhaustive reference test (src/decomposer.rs:102-115),
        # vectorized, on a dense low range + random u32 sample
        v = np.arange(500_000, dtype=np.uint32)
        d = g.decompose(v, self.P)
        assert np.array_equal(g.recompose(d, self.P), g.round_value(v, self.P))

    def test_recompose_roundtrip_random(self, rng):
        v = rng.integers(0, 1 << 32, size=1_000_000, dtype=np.uint32)
        d = g.decompose(v, self.P)
        assert np.array_equal(g.recompose(d, self.P), g.round_value(v, self.P))

    def test_digit_range_includes_anomaly(self):
        # the carry chain can emit digit +B (16): e.g. 0xF8 gives (..,0,16,-8)
        d = g.decompose(np.uint32(0xF8), DecomposerParams(4, 8, 32))
        s = g.digits_to_signed(d, self.P)
        assert s[-1] == -8 and s[-2] == 16

    def test_signed_digits_bound(self, rng):
        v = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint32)
        s = g.digits_to_signed(g.decompose(v, self.P), self.P)
        assert s.min() >= -8 and s.max() <= 16

    def test_truncation_keeps_msb(self):
        p5 = DecomposerParams(log_base=4, levels=5, log_q=32)
        p8 = DecomposerParams(log_base=4, levels=8, log_q=32)
        v = np.uint32(0xDEADBEEF)
        assert np.array_equal(g.decompose(v, p5), g.decompose(v, p8)[:5])


# ---------------------------------------------------------------------------
# polynomial ops
# ---------------------------------------------------------------------------


class TestPoly:
    def test_toeplitz_matches_schoolbook(self, rng):
        for n in (4, 8, 16):
            p0 = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            p1 = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            assert np.array_equal(
                g.poly_mul(p0, p1), g.school_book_negacyclic_mul(p0, p1)
            )

    def test_monomial_matches_schoolbook(self, rng):
        n = 8
        p0 = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        for mi in range(0, 2 * n):
            mono = np.zeros(n, dtype=np.uint32)
            idx, wrap = mi % n, (mi % (2 * n)) // n
            mono[idx] = np.uint32(0xFFFFFFFF) if wrap else np.uint32(1)
            assert np.array_equal(
                g.poly_mul_monomial(p0, mi),
                g.school_book_negacyclic_mul(p0, mono),
            ), mi

    def test_monomial_negative_index(self, rng):
        n = 8
        p0 = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        # X^-j == X^(2n-j) in the order-2n group
        for j in range(1, 2 * n):
            assert np.array_equal(
                g.poly_mul_monomial(p0, -j), g.poly_mul_monomial(p0, 2 * n - j)
            )

    def test_switch_modulus(self):
        # round(2N * v / q): exact midpoints round up
        q, to = 32, 10  # 2^32 -> 2^10
        d = 1 << (q - to)
        vals = np.array([0, d - 1, d, d // 2, d // 2 - 1, 3 * d + d // 2], dtype=np.uint32)
        out = g.switch_modulus(vals, q, to)
        assert out.tolist() == [0, 1, 1, 1, 0, 4]


# ---------------------------------------------------------------------------
# LWE / GLWE roundtrips
# ---------------------------------------------------------------------------


class TestCiphertexts:
    def test_lwe_roundtrip(self, keys, rng):
        lwe_sk, _ = keys
        for m in range(1 << TEST.log_p):
            ct = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(m, TEST), TEST)
            assert g.lwe_decode(g.decrypt_lwe(lwe_sk, ct), TEST) == m

    def test_lwe_linear_ops(self, keys, rng):
        lwe_sk, _ = keys
        c1 = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(1, TEST), TEST)
        c0 = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(0, TEST), TEST)
        combo = g.lwe_add(g.lwe_scalar_mul(c1, 2), c0)  # 2*1 + 0 = 2
        assert g.lwe_decode(g.decrypt_lwe(lwe_sk, combo), TEST) == 2

    def test_glwe_roundtrip(self, keys, rng):
        _, glwe_sk = keys
        gp = TEST.glwe_params()
        msg = rng.integers(0, 1 << gp.log_p, size=gp.degree, dtype=np.uint32)
        ct = encrypt_glwe_rng(rng, glwe_sk, g.glwe_encode(msg, gp), TEST)
        back = g.glwe_decode(g.decrypt_glwe(glwe_sk, ct), gp)
        assert np.array_equal(back, msg)

    def test_trivial_glwe(self, keys):
        _, glwe_sk = keys
        gp = TEST.glwe_params()
        msg = np.arange(gp.degree, dtype=np.uint32) % (1 << gp.log_p)
        ct = g.trivial_encrypt_glwe(g.glwe_encode(msg, gp), gp)
        assert np.array_equal(g.glwe_decode(g.decrypt_glwe(glwe_sk, ct), gp), msg)


# ---------------------------------------------------------------------------
# GGSW / external product / CMUX
# ---------------------------------------------------------------------------


class TestGgsw:
    def test_external_product(self, keys, rng):
        _, glwe_sk = keys
        gp = TEST.glwe_params()
        m2 = 2
        ggsw = encrypt_ggsw_rng(rng, glwe_sk, m2, TEST)
        msg = np.ones(gp.degree, dtype=np.uint32)  # m1 = 1 everywhere
        glwe = encrypt_glwe_rng(rng, glwe_sk, g.glwe_encode(msg, gp), TEST)
        res = g.external_product(ggsw, glwe, TEST)
        back = g.glwe_decode(g.decrypt_glwe(glwe_sk, res), gp)
        assert np.array_equal(back, (msg * m2) % (1 << gp.log_p))

    @pytest.mark.parametrize("bit", [0, 1])
    def test_cmux(self, keys, rng, bit):
        _, glwe_sk = keys
        gp = TEST.glwe_params()
        ggsw = encrypt_ggsw_rng(rng, glwe_sk, bit, TEST)
        m0 = np.full(gp.degree, 3, dtype=np.uint32)
        m1 = np.full(gp.degree, 2, dtype=np.uint32)
        c0 = encrypt_glwe_rng(rng, glwe_sk, g.glwe_encode(m0, gp), TEST)
        c1 = encrypt_glwe_rng(rng, glwe_sk, g.glwe_encode(m1, gp), TEST)
        res = g.cmux(ggsw, c0, c1, TEST)
        back = g.glwe_decode(g.decrypt_glwe(glwe_sk, res), gp)
        assert np.array_equal(back, m1 if bit else m0)


# ---------------------------------------------------------------------------
# key switching
# ---------------------------------------------------------------------------


class TestKeySwitch:
    def test_key_switch(self, rng):
        p = TEST
        from_params = p.lwe_params_post_pbs()
        from_n, to_n = from_params.lwe_dimension, p.lwe_dimension
        from_sk = rng.integers(0, 2, size=from_n, dtype=np.uint32)
        to_sk = rng.integers(0, 2, size=to_n, dtype=np.uint32)
        ks = p.ks_decomposer
        a = rng.integers(0, 1 << 32, size=(from_n * ks.levels, to_n), dtype=np.uint32)
        e = gaussian_u32(rng, p.lwe_std_dev, from_n * ks.levels)
        ksk = g.generate_ksk(from_sk, to_sk, to_n, ks, a, e)
        for m in range(1 << p.log_p):
            ct = encrypt_lwe_rng(rng, from_sk, g.lwe_encode(m, p), p)
            switched = g.key_switch_lwe(ct, from_n, to_n, ks, ksk)
            assert g.lwe_decode(g.decrypt_lwe(to_sk, switched), p) == m


# ---------------------------------------------------------------------------
# sample extract / bootstrap / gates
# ---------------------------------------------------------------------------


class TestBootstrap:
    def test_sample_extract(self, keys, rng):
        _, glwe_sk = keys
        gp = TEST.glwe_params()
        msg = rng.integers(0, 1 << gp.log_p, size=gp.degree, dtype=np.uint32)
        ct = encrypt_glwe_rng(rng, glwe_sk, g.glwe_encode(msg, gp), TEST)
        flat_sk = g.flatten_glwe_sk(glwe_sk)
        for si in (0, 1, gp.degree - 1):
            lwe = g.sample_extract(ct, gp, si)
            assert g.lwe_decode(g.decrypt_lwe(flat_sk, lwe), TEST) == msg[si]

    def test_test_vector_layout(self):
        tv = g.construct_identity_test_vector(TEST)
        rep = TEST.degree // (1 << TEST.log_p)
        # after negate+rotate the first block is rep/2 zeros then rep/2 ... etc.
        assert tv.shape == (TEST.degree,)
        # identity LUT [0,1,2,3]: after the half-block negate+left-rotate the
        # first rep/2 entries come from the remainder of the 0-block
        assert np.all(tv[: rep // 2] == 0)
        # and the trailing rep/2 entries are the negated head of the 0-block
        assert np.all(tv[-(rep // 2) :] == 0)
        # interior blocks are the LUT values, each repeated `rep` times
        assert tv[rep] == 1 and tv[2 * rep] == 2 and tv[3 * rep] == 3

    def test_bootstrap_identity(self, keys, bootstrap_keys, rng):
        lwe_sk, _ = keys
        bk, ksk = bootstrap_keys
        tv = g.construct_identity_test_vector(TEST)
        for m in range(1 << TEST.log_p):
            ct = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(m, TEST), TEST)
            out = g.bootstrap(ct, bk, ksk, tv, TEST)
            assert g.lwe_decode(g.decrypt_lwe(lwe_sk, out), TEST) == m

    @pytest.mark.parametrize("gate", ["and", "or", "xor", "nand"])
    def test_boolean_gates(self, keys, bootstrap_keys, rng, gate):
        lwe_sk, _ = keys
        bk, ksk = bootstrap_keys
        f = g.GATE_FNS[gate]
        for lhs in (0, 1):
            for rhs in (0, 1):
                c1 = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(lhs, TEST), TEST)
                c0 = encrypt_lwe_rng(rng, lwe_sk, g.lwe_encode(rhs, TEST), TEST)
                out = g.gate(gate, c0, c1, bk, ksk, TEST)
                assert g.lwe_decode(g.decrypt_lwe(lwe_sk, out), TEST) == f(lhs, rhs), (
                    gate,
                    lhs,
                    rhs,
                )
