"""Native C++ oracle vs NumPy golden model — cross-implementation equivalence
(the reference's strongest test style, SURVEY.md section 4 style 3)."""

import numpy as np
import pytest

import tfhe_jax.golden.model as g
from tfhe_jax import native
from tfhe_jax.params import DecomposerParams, get_params

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")

TEST = get_params("test_insecure")


class TestNativeOracle:
    def test_decompose_matches_golden(self, rng):
        dp = DecomposerParams(4, 6, 32)
        v = rng.integers(0, 1 << 32, size=50_000, dtype=np.uint32)
        v = np.concatenate([v, np.array([0, 0xF8, 0xFFFFFFFF], np.uint32)])
        ours = native.decompose(v, dp.log_base, dp.levels, dp.log_q)
        assert np.array_equal(ours, g.decompose(v, dp))

    def test_recompose_roundtrip(self, rng):
        dp = DecomposerParams(4, 5, 32)
        v = rng.integers(0, 1 << 32, size=10_000, dtype=np.uint32)
        d = native.decompose(v, dp.log_base, dp.levels, dp.log_q)
        r = native.recompose(d, dp.log_base, dp.levels, dp.log_q)
        assert np.array_equal(r, g.round_value(v, dp))

    def test_exhaustive_selfcheck_100M(self):
        # full parity with the reference's 0..100_000_000 sweep
        # (src/decomposer.rs:102-115), plus a high wrap-adjacent range
        assert native.decomposer_selfcheck(0, 100_000_000, 4, 7, 32) == 0
        assert native.decomposer_selfcheck((1 << 32) - (1 << 24), 1 << 24, 4, 7, 32) == 0

    def test_negacyclic_mul(self, rng):
        for n in (8, 64, 512):
            a = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            b = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            assert np.array_equal(native.negacyclic_mul(a, b), g.poly_mul(a, b))

    def test_monomial_mul(self, rng):
        n = 64
        p = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        for e in (-130, -1, 0, 5, 63, 64, 127, 128, 200):
            assert np.array_equal(native.monomial_mul(p, e), g.poly_mul_monomial(p, e)), e

    def test_switch_modulus(self, rng):
        v = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
        assert np.array_equal(
            native.switch_modulus(v, 32, 10), g.switch_modulus(v, 32, 10)
        )

    def test_external_product(self, rng):
        p = TEST
        k, n = p.glwe_dimension, p.degree
        dp = p.pbs_decomposer
        rows = (k + 1) * dp.levels
        ggsw = rng.integers(0, 1 << 32, size=(rows, k + 1, n), dtype=np.uint32)
        glwe = rng.integers(0, 1 << 32, size=(k + 1, n), dtype=np.uint32)
        ours = native.external_product(ggsw, glwe, k, n, dp.log_base, dp.levels, dp.log_q)
        want = g.external_product(ggsw, glwe, p)
        assert np.array_equal(ours, want)
