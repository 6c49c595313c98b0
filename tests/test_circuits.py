"""Depth-composed circuits (models/circuits.py): gates compose indefinitely
because every output is a fresh bootstrap (the reference's composition
pattern, src/boolean.rs:9-53, exercised to depth here; SURVEY section 4)."""

import numpy as np
import jax
import pytest

import tfhe_jax as tfhe
from tfhe_jax.models import boolean as mbool
from tfhe_jax.models import circuits as mcirc
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")
#: the 3-input-gate variants run at nano shapes — the maj/xor3 composition is
#: degree-independent and the log_p=3 encoding is already pinned at
#: test_insecure by tests/test_models.py::TestThreeInputGates
TEST3 = get_params("nano_3in")


@pytest.fixture(scope="module")
def keys():
    return tfhe.keygen(TEST, jax.random.key(17))


@pytest.fixture(scope="module")
def keys3():
    return tfhe.keygen(TEST3, jax.random.key(18))


def test_full_adder_truth_table(keys):
    """All 8 (a, b, cin) combinations in one batch: sum and carry exact."""
    ck, sk = keys
    a = np.array([i >> 2 & 1 for i in range(8)], np.uint32)
    b = np.array([i >> 1 & 1 for i in range(8)], np.uint32)
    c = np.array([i & 1 for i in range(8)], np.uint32)
    s, cout = mcirc.full_adder(
        sk, mbool.encrypt(ck, a, key=1), mbool.encrypt(ck, b, key=2),
        mbool.encrypt(ck, c, key=3), impl="conv")
    assert np.array_equal(np.asarray(mbool.decrypt(ck, s)), (a + b + c) & 1)
    assert np.array_equal(np.asarray(mbool.decrypt(ck, cout)), (a + b + c) >> 1)


def test_full_adder_truth_table_3in(keys3):
    """log_p=3 path: 2 bootstraps (xor3 + maj) per full adder."""
    ck, sk = keys3
    a = np.array([i >> 2 & 1 for i in range(8)], np.uint32)
    b = np.array([i >> 1 & 1 for i in range(8)], np.uint32)
    c = np.array([i & 1 for i in range(8)], np.uint32)
    s, cout = mcirc.full_adder(
        sk, mbool.encrypt(ck, a, key=1), mbool.encrypt(ck, b, key=2),
        mbool.encrypt(ck, c, key=3), impl="conv")
    assert np.array_equal(np.asarray(mbool.decrypt(ck, s)), (a + b + c) & 1)
    assert np.array_equal(np.asarray(mbool.decrypt(ck, cout)), (a + b + c) >> 1)


def test_ripple_carry_add_4bit(keys):
    """4-bit adder on a batch of random pairs, exact incl. carry-out; the
    trace hook's per-depth expected cleartexts all verify."""
    ck, sk = keys
    rng = np.random.default_rng(11)
    w, batch = 4, 4
    a = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    b = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    trace = []
    s, cout = mcirc.ripple_carry_add(
        sk, mcirc.encrypt_uint(ck, a, w, key=4),
        mcirc.encrypt_uint(ck, b, w, key=5), impl="conv", trace=trace)
    assert np.array_equal(
        np.asarray(mcirc.decrypt_uint(ck, s)), (a + b) & ((1 << w) - 1))
    assert np.array_equal(
        np.asarray(mbool.decrypt(ck, cout)), (a + b) >> w)
    # the per-depth trace decrypts to its own expected cleartexts
    assert {lbl for lbl, *_ in trace} == (
        {"halves.x", "halves.g", "sums"} | {f"carry[{i}]" for i in range(w)})
    for label, depth, cts, clear_fn in trace:
        got = np.asarray(mbool.decrypt(ck, cts))
        want = np.asarray(clear_fn(a, b, 0), np.uint32)
        assert np.array_equal(got, want), (label, depth)


def test_ripple_carry_add_4bit_3in(keys3):
    """3-input-gate adder (maj carries + one wide xor3): W+1 PBS calls."""
    ck, sk = keys3
    rng = np.random.default_rng(12)
    w, batch = 4, 4
    a = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    b = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    s, cout = mcirc.ripple_carry_add(
        sk, mcirc.encrypt_uint(ck, a, w, key=6),
        mcirc.encrypt_uint(ck, b, w, key=7), impl="conv")
    assert np.array_equal(
        np.asarray(mcirc.decrypt_uint(ck, s)), (a + b) & ((1 << w) - 1))
    assert np.array_equal(
        np.asarray(mbool.decrypt(ck, cout)), (a + b) >> w)


def test_encrypt_decrypt_uint_roundtrip(keys):
    ck, _ = keys
    vals = np.array([0, 1, 200, 255], np.uint32)
    bits = mcirc.encrypt_uint(ck, vals, 8, key=9)
    assert bits.shape[:2] == (8, 4)
    assert np.array_equal(np.asarray(mcirc.decrypt_uint(ck, bits)), vals)
