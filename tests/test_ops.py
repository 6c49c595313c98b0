"""JAX ops layer vs the NumPy golden oracle — exact u32 equality everywhere."""

import numpy as np
import jax.numpy as jnp
import pytest

import tfhe_jax.golden.model as g
from tfhe_jax.ops import decomposer as jdec
from tfhe_jax.ops import poly as jpoly
from tfhe_jax.ops import torus as jtorus
from tfhe_jax.params import DecomposerParams, get_params

TEST = get_params("test_insecure")
PBS_DP = TEST.pbs_decomposer
KS_DP = TEST.ks_decomposer


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


class TestTorus:
    def test_limb_roundtrip(self, rng):
        x = rnd_u32(rng, (1000,))
        limbs = np.asarray(jtorus.to_signed_limbs(x))
        assert limbs.dtype == np.int8
        back = np.asarray(
            jtorus.combine_limb_accs(jnp.asarray(limbs, jnp.int32))
        )
        assert np.array_equal(back, x)

    def test_switch_modulus_matches_golden(self, rng):
        v = rnd_u32(rng, (4096,))
        for log_to in (10, 16, 31):
            ours = np.asarray(jtorus.switch_modulus(v, 32, log_to))
            assert np.array_equal(ours, g.switch_modulus(v, 32, log_to)), log_to

    def test_encode_decode_matches_golden(self, rng):
        m = rng.integers(0, 1 << TEST.log_p, size=256, dtype=np.uint32)
        enc = np.asarray(jtorus.encode(m, TEST.log_q, TEST.log_p, TEST.padding_bits))
        assert np.array_equal(enc, g.lwe_encode(m, TEST))
        noisy = enc + rng.integers(-1000, 1000, size=256).astype(np.uint32)
        dec = np.asarray(
            jtorus.decode(noisy, TEST.log_q, TEST.log_p, TEST.padding_bits)
        )
        assert np.array_equal(dec, g.lwe_decode(noisy, TEST))

    def test_wrapping_matvec(self, rng):
        a = rnd_u32(rng, (7, 64))
        s = rng.integers(0, 2, size=(64, 16), dtype=np.int8)
        ours = np.asarray(jtorus.wrapping_matvec_u32_small(a, s))
        want = (a.astype(np.uint64) @ s.astype(np.uint64)) & 0xFFFFFFFF
        assert np.array_equal(ours, want.astype(np.uint32))


class TestDecomposer:
    @pytest.mark.parametrize("dp", [PBS_DP, KS_DP, DecomposerParams(4, 8, 32)])
    def test_matches_golden(self, rng, dp):
        v = rnd_u32(rng, (100_000,))
        # include carry-anomaly triggers and edge values
        v = np.concatenate(
            [v, np.array([0, 0xF8, 0xFF, 0xFFFFFFFF, 0x88888888, 0x7FFFFFFF], np.uint32)]
        )
        ours = np.asarray(jdec.decompose_u32(v, dp))
        assert np.array_equal(ours, g.decompose(v, dp))
        ours_s = np.asarray(jdec.decompose_signed(v, dp))
        assert np.array_equal(ours_s, g.digits_to_signed(g.decompose(v, dp), dp))

    def test_recompose_matches_golden(self, rng):
        dp = PBS_DP
        v = rnd_u32(rng, (10_000,))
        d = jdec.decompose_u32(v, dp)
        ours = np.asarray(jdec.recompose(d, dp))
        assert np.array_equal(ours, g.round_value(v, dp))


class TestPoly:
    def test_monomial_mul_matches_golden(self, rng):
        n = 64
        p = rnd_u32(rng, (n,))
        for e in [-2 * n + 1, -5, -1, 0, 1, 7, n - 1, n, n + 3, 2 * n - 1, 2 * n, 5 * n + 3]:
            ours = np.asarray(jpoly.monomial_mul(p, e))
            assert np.array_equal(ours, g.poly_mul_monomial(p, e)), e

    def test_monomial_mul_batched_exponents(self, rng):
        n = 32
        p = rnd_u32(rng, (5, 3, n))
        e = rng.integers(-2 * n, 2 * n, size=(5, 1)).astype(np.int32)
        ours = np.asarray(jpoly.monomial_mul(p, e))
        for b in range(5):
            for r in range(3):
                assert np.array_equal(ours[b, r], g.poly_mul_monomial(p[b, r], int(e[b, 0])))

    def test_monomial_mul_custom_mod_matches_golden(self, rng):
        n = 64
        for log_mod in [7, 11, 32]:
            p = rnd_u32(rng, (n,))
            for e in [-5, 0, 1, n, n + 3, 2 * n - 1]:
                ours = np.asarray(jpoly.monomial_mul_custom_mod(p, e, log_mod))
                assert np.array_equal(
                    ours, g.poly_mul_monomial_custom_mod(p, e, log_mod)
                ), (e, log_mod)

    @pytest.mark.parametrize("n", [8, 64, 512])
    def test_poly_mul_u32_matches_golden(self, rng, n):
        a = rnd_u32(rng, (n,))
        b = rnd_u32(rng, (n,))
        ours = np.asarray(jpoly.poly_mul_u32(a, b))
        assert np.array_equal(ours, g.poly_mul(a, b))

    def test_negacyclic_matvec_small(self, rng):
        # poly_dot_product(a_rows, s_rows) for binary s == stacked-Toeplitz matvec
        k, n = 2, 64
        a = rnd_u32(rng, (k, n))
        s = rng.integers(0, 2, size=(k, n), dtype=np.uint32)
        t = np.asarray(jpoly.sign_toeplitz_small(s.astype(np.int8)))  # [k, N, N]
        t_stack = t.reshape(k * n, n)
        ours = np.asarray(jpoly.negacyclic_matvec_u32_small(a.reshape(-1), t_stack))
        assert np.array_equal(ours, g.poly_dot_product(a, s))


class TestExternalProductContraction:
    """conv and matmul formulations vs the golden contraction, exact int32/u32."""

    def _setup(self, rng, batch=3, k=2, levels=6, n=64):
        r = (k + 1) * levels
        digits_s = rng.integers(-8, 17, size=(batch, r, n)).astype(np.int8)
        bk = rnd_u32(rng, (r, k + 1, n))
        # golden: per column c, poly_dot_product(digits_as_u32_rows, bk[:, c, :])
        digits_u32 = digits_s.astype(np.int64).astype(np.uint32)
        want = np.stack(
            [
                np.stack(
                    [g.poly_dot_product(digits_u32[b], bk[:, c, :]) for c in range(k + 1)]
                )
                for b in range(batch)
            ]
        )
        kernel = jpoly.bk_to_conv_kernel(bk)
        return digits_s, kernel, want, k

    def test_conv_formulation(self, rng):
        digits, kernel, want, k = self._setup(rng)
        acc = jpoly.ep_contract_conv(jnp.asarray(digits), kernel)
        ours = np.asarray(jpoly.ep_combine(acc, k + 1))
        assert np.array_equal(ours, want)

    def test_matmul_formulation(self, rng):
        batch, k, levels, n = 3, 2, 6, 64
        r = (k + 1) * levels
        digits = rng.integers(-8, 17, size=(batch, r, n)).astype(np.int8)
        bk = rnd_u32(rng, (r, k + 1, n))
        du = digits.astype(np.int64).astype(np.uint32)
        want = np.stack(
            [
                np.stack(
                    [g.poly_dot_product(du[b], bk[:, c, :]) for c in range(k + 1)]
                )
                for b in range(batch)
            ]
        )
        acc = jpoly.ep_contract_matmul(jnp.asarray(digits), jnp.asarray(bk))
        ours = np.asarray(jpoly.ep_combine(acc, k + 1))
        assert np.array_equal(ours, want)


class TestParamsValidation:
    """Construction-time rejection of params that would break int32-exact
    accumulation (the preconditions documented at ops/torus.py:76-87)."""

    def test_registry_sets_valid(self):
        from tfhe_jax.params import PARAMS, validate

        for p in PARAMS.values():
            validate(p)  # must not raise

    def test_rejects_ep_accumulation_overflow(self):
        # R*N*(base/2)*128 = 64*2^15*8*128 = 2^31: k=7, levels=8, N=2^15
        p = get_params("default_128")
        big = DecomposerParams(log_base=4, levels=8, log_q=32)
        with pytest.raises(ValueError, match="pbs contraction bound"):
            p.replace(glwe_dimension=7, log_degree=15, pbs_decomposer=big)

    def test_rejects_wide_digits(self):
        p = get_params("default_128")
        with pytest.raises(AssertionError):
            # DecomposerParams itself rejects base > 64 (int8 digit bound)
            DecomposerParams(log_base=8, levels=4, log_q=32)
        with pytest.raises(ValueError, match="log_q must be 32"):
            p.replace(log_q=16,
                      ks_decomposer=DecomposerParams(4, 2, 16),
                      pbs_decomposer=DecomposerParams(4, 3, 16))

    def test_rejects_ks_overflow(self):
        # kN*l_ks*base*128 = 4*2^15*8*16*128 = 2^31 (pbs bound still OK:
        # R*N*16*128 = 30*2^15*2048 = 2.01e9 < 2^31)
        p = get_params("default_128")
        with pytest.raises(ValueError, match="ks contraction bound"):
            p.replace(glwe_dimension=4, log_degree=15,
                      ks_decomposer=DecomposerParams(4, 8, 32))

    def test_rejects_bad_encoding(self):
        p = get_params("default_128")
        with pytest.raises(ValueError, match="log_p"):
            p.replace(log_p=31, padding_bits=1)
