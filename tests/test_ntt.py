"""Block-NTT tier (ops/ntt.py) vs the exact Toeplitz backends and golden.

Exactness contract: every result is bit-identical u32 to the O(N^2) paths
(semantics src/utils.rs:155-160); the NTT is a pure speedup, not an
approximation.  Tests include adversarial operands that sit on the CRT-range
bound (all digits at the +B carry anomaly, all-ones keys).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import tfhe_jax.golden.model as g
from tfhe_jax.ops import ntt as jntt
from tfhe_jax.ops import poly as jpoly
from tfhe_jax.ops.poly import ep_combine, ep_contract_matmul
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")
D128 = get_params("default_128")


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


class TestTables:
    @pytest.mark.parametrize("n1", [8, 64, 256])
    def test_ntt_roundtrip_mod_p(self, rng, n1):
        """INTT(NTT(x)) == x (mod p) for both CRT primes."""
        tabs = jntt._tables(n1)
        for p, t in zip(jntt.PRIMES, tabs):
            x = rng.integers(0, p, size=(5, n1)).astype(np.int64)
            ahat = (x @ t["w_fwd"].astype(np.int64)) % p
            back = (ahat @ t["w_inv"].astype(np.int64)) % p
            assert np.array_equal(back, x), (p, n1)

    @pytest.mark.parametrize("n1", [8, 64])
    def test_ntt_is_negacyclic_homomorphism(self, rng, n1):
        """NTT(a (*) b) == NTT(a) * NTT(b) pointwise, negacyclic mod (Z^N1+1)."""
        for p, t in zip(jntt.PRIMES, jntt._tables(n1)):
            a = rng.integers(0, p, size=n1).astype(np.int64)
            b = rng.integers(0, p, size=n1).astype(np.int64)
            # schoolbook negacyclic conv mod p
            c = np.zeros(n1, np.int64)
            for i in range(n1):
                for j in range(n1):
                    k = i + j
                    s = 1 if k < n1 else -1
                    c[k % n1] = (c[k % n1] + s * a[i] * b[j]) % p
            w = t["w_fwd"].astype(np.int64)
            chat = (((a @ w) % p) * ((b @ w) % p)) % p
            want = (c @ w) % p
            assert np.array_equal(chat % p, want % p), p

    def test_zhat_is_eigenvalue_of_z(self, rng):
        """Multiplying by Z in Z[Z]/(Z^N1+1) == pointwise zhat in NTT domain."""
        n1 = 16
        for p, t in zip(jntt.PRIMES, jntt._tables(n1)):
            a = rng.integers(0, p, size=n1).astype(np.int64)
            az = np.concatenate([[-a[-1]], a[:-1]]) % p  # a * Z, wrap with -1
            w = t["w_fwd"].astype(np.int64)
            assert np.array_equal(
                (az @ w) % p, ((a @ w) * t["zhat"].astype(np.int64)) % p
            ), p


class TestPolyMul:
    @pytest.mark.parametrize("n", [64, 512, 1024])
    def test_poly_mul_ntt_matches_golden(self, rng, n):
        a = rnd_u32(rng, (3, n))
        b = rnd_u32(rng, (3, n))
        ours = np.asarray(jntt.poly_mul_ntt(a, b))
        for i in range(3):
            assert np.array_equal(ours[i], g.poly_mul(a[i], b[i])), (n, i)

    def test_poly_mul_ntt_adversarial(self):
        """All-ones operands maximise every intermediate magnitude."""
        n = 512
        a = np.full((1, n), 0xFFFFFFFF, np.uint32)
        b = np.full((1, n), 0xFFFFFFFF, np.uint32)
        ours = np.asarray(jntt.poly_mul_ntt(a, b))[0]
        assert np.array_equal(ours, g.poly_mul(a[0], b[0]))


def _ep_params(params):
    k1 = params.glwe_dimension + 1
    r = k1 * params.pbs_decomposer.levels
    return r, k1, params.degree


class TestEpContract:
    @pytest.mark.parametrize("params", [TEST, D128], ids=["test", "d128"])
    def test_matches_matmul_backend(self, rng, params):
        r, c, n = _ep_params(params)
        plan = jntt.make_plan(n, rows=r)
        batch = 4
        digits = rng.integers(-8, 17, size=(batch, r, n)).astype(np.int8)
        bk = rnd_u32(rng, (r, c, n))
        want = np.asarray(ep_combine(ep_contract_matmul(jnp.asarray(digits), bk), c))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        ours = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        assert np.array_equal(ours, want)

    def test_worst_case_digits_and_key(self, rng):
        """Digits pinned at the +B carry anomaly (16), key all-ones: the true
        integer convolution hits its documented CRT bound R*N*16*2^(kb-1)."""
        r, c, n = _ep_params(D128)
        plan = jntt.make_plan(n, rows=r)
        assert r * n * plan.max_digit * (1 << (plan.key_bits - 1)) < jntt.P_CRT // 2
        digits = np.full((1, r, n), 16, np.int8)
        bk = np.full((r, c, n), 0xFFFFFFFF, np.uint32)
        want = np.asarray(ep_combine(ep_contract_matmul(jnp.asarray(digits), bk), c))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        ours = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        assert np.array_equal(ours, want)

    def test_signed_worst_case(self, rng):
        """Alternating-sign extremes exercise the negative CRT bound."""
        r, c, n = _ep_params(D128)
        plan = jntt.make_plan(n, rows=r)
        digits = np.where(
            (np.arange(n) % 2 == 0), 16, -8
        ).astype(np.int8) * np.ones((1, r, 1), np.int8)
        bk = np.where((np.arange(n) % 2 == 0), 0x80000000, 0x7FFFFFFF).astype(
            np.uint32
        ) * np.ones((r, c, 1), np.uint32)
        want = np.asarray(ep_combine(ep_contract_matmul(jnp.asarray(digits), bk), c))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        ours = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        assert np.array_equal(ours, want)


class TestBinShardedPartials:
    def test_partials_sum_to_full(self, rng):
        """Bin-partial raw INTT limb planes summed across shards == the
        single-shot contraction (the psum invariant of the sharded-NTT EP)."""
        import jax.numpy as jnp

        r, c, n = _ep_params(TEST)
        plan = jntt.make_plan(n, rows=r)
        digits = rng.integers(-8, 17, size=(3, r, n)).astype(np.int8)
        bk = rnd_u32(rng, (r, c, n))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        want = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        for shards in (2, 4):
            bl = plan.n1 // shards
            planes = sum(
                jntt.ep_contract_ntt_partial(
                    jnp.asarray(digits), bk_ntt[:, :, s * bl : (s + 1) * bl],
                    plan, c, s * bl, bl,
                )
                for s in range(shards)
            )
            ours = np.asarray(jntt.ep_finish_ntt(planes, plan, c_dim=c))
            assert np.array_equal(ours, want), shards


class TestLargeDegree:
    """N >= 2048 — the block-NTT tier's target regime (large_2048/large_4096
    registry sets; NOTES_NTT.md crossover claim)."""

    @pytest.mark.parametrize("n", [2048, 4096])
    def test_poly_mul_ntt_matches_golden(self, rng, n):
        p0 = rnd_u32(rng, (n,))
        p1 = rnd_u32(rng, (n,))
        want = g.poly_mul(p0, p1)
        got = np.asarray(jntt.poly_mul_ntt(jnp.asarray(p0), jnp.asarray(p1)))
        assert np.array_equal(got, want)

    def test_ep_contract_large_2048(self, rng):
        params = get_params("large_2048")
        r, c, n = _ep_params(params)
        plan = jntt.plan_for_params(params)
        digits = rng.integers(-8, 17, size=(2, r, n)).astype(np.int8)
        bk = rnd_u32(rng, (r, c, n))
        want = np.asarray(ep_combine(ep_contract_matmul(jnp.asarray(digits), bk), c))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        ours = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        assert np.array_equal(ours, want)

    def test_ep_worst_case_bound_2048(self):
        params = get_params("large_2048")
        r, c, n = _ep_params(params)
        plan = jntt.plan_for_params(params)
        assert r * n * plan.max_digit * (1 << (plan.key_bits - 1)) < jntt.P_CRT // 2
        digits = np.full((1, r, n), 16, np.int8)
        bk = np.full((r, c, n), 0xFFFFFFFF, np.uint32)
        want = np.asarray(ep_combine(ep_contract_matmul(jnp.asarray(digits), bk), c))
        bk_ntt = jntt.make_ep_ntt_key(bk, plan)
        ours = np.asarray(
            jntt.ep_contract_ntt(jnp.asarray(digits), bk_ntt, plan, c_dim=c)
        )
        assert np.array_equal(ours, want)
