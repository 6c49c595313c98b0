"""Tests that need an NVIDIA GPU (``pytest -m gpu``).

They skip elsewhere and run on the card as the first phase of chip_smoke.py
(``TFHE_TEST_PLATFORM=cuda python -m pytest -m gpu -p no:xdist -o addopts= tests/``).
The HLO-route parser they rely on is checked on the CPU below.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tfhe_jax as tfhe
import tfhe_jax.golden.model as g
from tfhe_jax.models import bootstrap as mboot
from tfhe_jax.models import keyswitch as mks
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.keys import make_server_key, with_ntt_key
from tfhe_jax.ops.torus import switch_modulus
from tfhe_jax.params import get_params

TEST = get_params("test_insecure")


def dot_routes(hlo: str) -> list[tuple[str, str]]:
    """(instruction, route) for every dot / convolution in optimized HLO.

    route is ``kCustom/<backend kind>`` for a dot inside a custom fusion
    (Triton GEMM), ``kLoop`` / ``kInput`` / ``kOutput`` for one inside an
    ordinary fusion (the loop emitter), ``unfused`` otherwise.  GEMMs that
    XLA handed to cuBLAS are custom calls, not dots, and do not appear.
    """
    comps, cur = {}, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line)
    callers = {}
    for lines in comps.values():
        for ln in lines:
            for callee in re.findall(r"calls=%?([\w.\-]+)", ln):
                callers[callee] = ln
    routes = []
    for name, lines in comps.items():
        for ln in lines:
            m = re.search(r"(%?[\w.\-]+) = \S+ (?:dot|convolution)\(", ln)
            if not m:
                continue
            caller = callers.get(name, "")
            kind = re.search(r"kind=(k\w+)", caller)
            backend = re.search(r'"kind":"(\w+)"', caller)
            route = kind.group(1) if kind else "unfused"
            if backend:
                route += "/" + backend.group(1)
            routes.append((m.group(1), route))
    return routes


def is_gemm_route(route: str) -> bool:
    return route.startswith("kCustom/") and "gemm" in route


def test_dot_routes_parser():
    """CPU check of the parser on a hand-written optimized-HLO excerpt."""
    hlo = "\n".join([
        "%gemm_fusion_dot.1_computation (p0: s8[8,144], p1: s8[144,96]) -> s32[8,96] {",
        "  ROOT %dot.1 = s32[8,96]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}",
        "}",
        "%fused_reduce (p0: s32[1,96]) -> s32[96] {",
        "  %dot.2 = s32[1,96]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}",
        "}",
        "ENTRY %main (a: s8[8,144], b: s8[144,96]) -> s32[8,96] {",
        '  %f1 = s32[8,96]{1,0} fusion(%a, %b), kind=kCustom, calls=%gemm_fusion_dot.1_computation, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}',
        "  %f2 = s32[96]{0} fusion(%a), kind=kLoop, calls=%fused_reduce",
        "  %c = (s32[8,96]{1,0}, s8[0]{0}) custom-call(%a, %b), custom_call_target=\"__cublas$gemm\"",
        "}",
    ])
    assert dot_routes(hlo) == [("%dot.1", "kCustom/__triton_gemm"), ("%dot.2", "kLoop")]
    assert [is_gemm_route(r) for _, r in dot_routes(hlo)] == [True, False]


@pytest.fixture(scope="module")
def injected():
    """Keys and ciphertexts from NumPy-drawn masks and noise, shared by the
    golden model and the JAX path (jax.random may differ across platforms)."""
    rng = np.random.default_rng(2024)
    p = TEST
    k, n_deg, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kl = k * n_deg * p.ks_decomposer.levels

    def gauss(std, shape):
        return g.f64_to_torus(rng.normal(0.0, std, size=shape))

    lwe_sk = rng.integers(0, 2, size=n, dtype=np.uint32)
    glwe_sk = rng.integers(0, 2, size=(k, n_deg), dtype=np.uint32)
    keys = (lwe_sk, glwe_sk,
            rng.integers(0, 1 << 32, size=(n, rows, k, n_deg), dtype=np.uint32),
            gauss(p.glwe_std_dev, (n, rows, n_deg)),
            rng.integers(0, 1 << 32, size=(kl, n), dtype=np.uint32),
            gauss(p.lwe_std_dev, (kl,)))
    bmmp = (rng.integers(0, 1 << 32, size=(3 * n // 2, rows, k, n_deg),
                         dtype=np.uint32),
            gauss(p.glwe_std_dev, (3 * n // 2, rows, n_deg)))
    bk_g, ksk_g = g.bootstrapping_key_gen(*keys[:2], p, *keys[2:])
    msgs = np.arange(4, dtype=np.uint32)
    a = rng.integers(0, 1 << 32, size=(4, n), dtype=np.uint32)
    e = gauss(p.lwe_std_dev, (4,))
    cts = np.stack([g.encrypt_lwe(lwe_sk, g.lwe_encode(m, p), a[i], e[i])
                    for i, m in enumerate(msgs)])
    tv_clear = g.construct_identity_test_vector(p)
    want = np.stack([g.bootstrap(ct, bk_g, ksk_g, tv_clear, p) for ct in cts])
    return keys, bmmp, cts, msgs, want


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["matmul", "ntt", "ntts", "auto"])
def test_pbs_bit_exact_vs_golden_on_gpu(gpu, injected, impl):
    keys, bmmp, cts, _, want = injected
    sk = make_server_key(TEST, *keys)
    if impl == "ntt":
        sk = with_ntt_key(sk)
    tv = jnp.asarray(mtv.identity_test_vector(TEST))
    got = np.asarray(mboot.pbs(TEST, jnp.asarray(cts), sk, tv, impl=impl))
    assert np.array_equal(got, want), impl


@pytest.mark.gpu
def test_bmmp_on_gpu(gpu, injected):
    """BMMP (another rotation, hence other noise than golden): bit-identical
    through the matmul and ntts contractions, decoding to the messages."""
    keys, bmmp, cts, msgs, _ = injected
    sk = make_server_key(TEST, *keys, *bmmp)
    tv = jnp.asarray(mtv.identity_test_vector(TEST))
    approx = switch_modulus(jnp.asarray(cts), TEST.log_q, TEST.log_degree + 1)
    outs = []
    for c in ("matmul", "ntts"):
        acc = mboot._blind_rotate_bmmp(TEST, approx, sk.bk_bmmp, tv, c)
        outs.append(np.asarray(mks.key_switch(
            mboot.sample_extract0(acc), TEST.glwe_dimension * TEST.degree,
            TEST.ks_decomposer, sk.ksk_mat)))
    assert np.array_equal(outs[0], outs[1])
    got = [int(g.lwe_decode(g.decrypt_lwe(keys[0], ct), TEST)) for ct in outs[0]]
    assert got == msgs.tolist()


@pytest.mark.gpu
def test_conv_has_no_gpu_lowering(gpu, injected):
    """The s8 x s8 -> s32 convolution is refused by XLA's GPU backend
    (cuDNN integer convolutions output s8 or f32), which is why
    ``resolve_impl`` never picks ``conv`` on a GPU."""
    keys, _, cts, _, _ = injected
    sk = make_server_key(TEST, *keys)
    tv = jnp.asarray(mtv.identity_test_vector(TEST))
    with pytest.raises(Exception, match="integer convolutions"):
        jax.block_until_ready(
            mboot.pbs(TEST, jnp.asarray(cts), sk, tv, impl="conv"))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 4096])
def test_gate_int8_dots_lower_to_gemms(gpu, batch):
    """In the optimized HLO of the default_128 NAND gate every int8 dot is a
    GEMM: a cuBLAS custom call or a Triton GEMM fusion, never a dot left to
    the loop emitter."""
    p = get_params("default_128")
    _, sk = jax.eval_shape(partial(tfhe.keygen, p), jax.random.key(0))
    ct = jax.ShapeDtypeStruct((batch, p.lwe_dimension + 1), jnp.uint32)
    hlo = jax.jit(tfhe.gates.nand).lower(sk, ct, ct).compile().as_text()
    routes = dot_routes(hlo)
    assert not [r for r in routes if not is_gemm_route(r[1])], routes
    gemms = len(routes) + len(re.findall(r'custom_call_target="__cublas', hlo))
    assert gemms > 0
