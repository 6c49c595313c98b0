"""Serialization roundtrips and noise metering."""

import numpy as np
import jax
import pytest

import tfhe_jax as tfhe
from tfhe_jax.utils import noise as unoise
from tfhe_jax.utils import serialization as ser
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")


@pytest.fixture(scope="module")
def keys():
    return tfhe.keygen(TEST, jax.random.key(5))


class TestSerialization:
    def test_params_json_roundtrip(self):
        s = ser.params_to_json(TEST)
        assert ser.params_from_json(s) == TEST

    def test_client_key_roundtrip(self, keys, tmp_path):
        ck, _ = keys
        p = tmp_path / "ck.npz"
        ser.save_client_key(p, ck)
        back = ser.load_client_key(p)
        assert np.array_equal(np.asarray(back.lwe_sk), np.asarray(ck.lwe_sk))
        assert np.array_equal(np.asarray(back.glwe_sk), np.asarray(ck.glwe_sk))
        assert back.params == TEST

    def test_server_key_roundtrip_rebuilds_layouts(self, keys, tmp_path):
        _, sk = keys
        p = tmp_path / "sk.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p)
        assert np.array_equal(np.asarray(back.bk_u32), np.asarray(sk.bk_u32))
        assert np.array_equal(np.asarray(back.bk_conv), np.asarray(sk.bk_conv))
        assert np.array_equal(np.asarray(back.ksk_mat), np.asarray(sk.ksk_mat))

    def test_loaded_server_key_still_computes(self, keys, tmp_path):
        ck, sk = keys
        p = tmp_path / "sk.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p)
        bits = np.array([0, 1, 1, 0], dtype=np.uint32)
        out = tfhe.gates.nand(back, tfhe.encrypt(ck, bits, key=1), tfhe.encrypt(ck, bits, key=2))
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), 1 - (bits & bits))

    def test_server_key_bmmp_roundtrip(self, tmp_path):
        """A saved BMMP server key must stay a BMMP key (regression: the
        first serializer silently dropped the BMMP key)."""
        ck, sk = tfhe.keygen(TEST, jax.random.key(6), bmmp=True)
        p = tmp_path / "sk_bmmp.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p)
        assert back.bk_bmmp is not None
        assert np.array_equal(np.asarray(back.bk_bmmp), np.asarray(sk.bk_bmmp))
        bits = np.array([0, 1], dtype=np.uint32)
        out = tfhe.gates.gate(back, "nand", tfhe.encrypt(ck, bits, key=3),
                              tfhe.encrypt(ck, bits, key=4), impl="bmmp")
        assert np.array_equal(np.asarray(tfhe.decrypt(ck, out)), 1 - (bits & bits))

    def test_ciphertext_roundtrip(self, keys, tmp_path):
        ck, _ = keys
        cts = tfhe.encrypt(ck, np.array([1, 2, 3], np.uint32), key=9)
        p = tmp_path / "ct.npz"
        ser.save_ciphertexts(p, cts, TEST)
        back, params = ser.load_ciphertexts(p)
        assert params == TEST
        assert np.array_equal(np.asarray(back), np.asarray(cts))


class TestNoise:
    def test_fresh_ciphertext_margin(self, keys):
        ck, _ = keys
        msgs = np.array([0, 1, 2, 3] * 8, dtype=np.uint32)
        cts = tfhe.encrypt(ck, msgs, key=11)
        rep = unoise.measure(ck, cts, msgs)
        assert rep.failures == 0
        assert rep.max_abs_over_delta < 0.01  # fresh noise is tiny at these params

    def test_post_pbs_margin(self, keys):
        ck, sk = keys
        msgs = np.array([0, 1, 1, 0, 1, 0, 0, 1], dtype=np.uint32)
        out = tfhe.bootstrap_identity(sk, tfhe.encrypt(ck, msgs, key=12))
        rep = unoise.measure(ck, out, msgs)
        assert rep.failures == 0
        assert rep.max_abs_over_delta < 0.5

    def test_detects_corruption(self, keys):
        ck, _ = keys
        msgs = np.array([1, 1], dtype=np.uint32)
        cts = np.asarray(tfhe.encrypt(ck, msgs, key=13)).copy()
        cts[0, -1] += np.uint32(TEST.delta)  # push past the decode threshold
        rep = unoise.measure(ck, cts, msgs)
        assert rep.failures == 1


class TestCompileCache:
    def test_env_var_wins_and_nothing_else_is_set(self, monkeypatch, tmp_path):
        from tfhe_jax.utils import compile_cache

        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(compile_cache.jax.config, "update",
                            lambda *a: calls.append(a))
        assert compile_cache.enable() == str(tmp_path)
        assert calls == []

    def test_unset_uses_fixed_ignored_dir_in_checkout(self, monkeypatch):
        import os

        from tfhe_jax.utils import compile_cache

        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(compile_cache.jax.config, "update",
                            lambda *a: calls.append(a))
        path = compile_cache.enable()
        assert calls == [("jax_compilation_cache_dir", path)]
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
