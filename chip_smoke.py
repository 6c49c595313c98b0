"""Smoke run of the default_128 gate-bootstrap path on one NVIDIA GPU.

    python chip_smoke.py          # every phase below, on one card
    python chip_smoke.py --four   # only the data-parallel gate over four cards

Phases, each printing one result line with its wall time; any failure ends
the run with a non-zero exit code and no result line:

  gpu-tests  the ``gpu``-marked pytest tests, in a child process that runs
             and exits before this process opens the card
  device     JAX must find a GPU; the card's name and power limit
  keygen     jitted ``tfhe.keygen`` at default_128
  gates      NAND through ``tfhe.gates`` at B = 1, 8 and 4096: no gate
             errors, the noise margin, the median call time
  golden     bit-exact against the NumPy golden model (injected masks and
             noise), and every backend bit-exact against the others at B=8
  adder      the 8-bit ripple-carry adder of ``models/circuits.py``
  cli        keygen -> encrypt -> gate -> decrypt through ``tfhe_jax.cli.main``

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import tfhe_jax as tfhe
import tfhe_jax.golden.model as golden
from tfhe_jax.models import bootstrap as mboot
from tfhe_jax.models import circuits as mcirc
from tfhe_jax.models import keyswitch as mks
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.keys import ClientKey, make_server_key, with_ntt_key
from tfhe_jax.ops.torus import switch_modulus
from tfhe_jax.utils import compile_cache
from tfhe_jax.utils import noise as unoise
from tfhe_jax.utils.device import describe, nvidia_smi, require_gpu
from tfhe_jax.utils.profiling import median_call_s

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    """A phase produced a wrong or missing result."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name: str, fn, *args):
    """Run one phase; print its result line and wall time.  Exceptions
    propagate: a failed phase ends the run."""
    t0 = time.perf_counter()
    result, summary = fn(*args)
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {summary}")
    return result


def peak_bytes(device=None) -> str:
    stats = (device or jax.devices()[0]).memory_stats()
    return str(stats["peak_bytes_in_use"]) if stats else "not reported"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def gpu_tests_phase():
    """``pytest -m gpu`` in a child process; every selected test must pass
    and at least one must be selected."""
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "-p", "no:xdist",
           "-p", "no:cacheprovider", "-o", "addopts=", "-q", "-rs", "tests/"]
    env = dict(os.environ, TFHE_TEST_PLATFORM="cuda")
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    lines = r.stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|xfailed|xpassed)", tail)}
    ok = (r.returncode == 0 and counts.get("passed", 0) > 0
          and set(counts) == {"passed"})
    check(ok, f"gpu tests: rc={r.returncode}, {tail!r}\n{r.stdout[-6000:]}"
              f"\n{r.stderr[-3000:]}")
    return None, tail


def device_phase(card: str):
    devices = jax.devices()
    require_gpu(devices)
    d = devices[0]
    return devices, (f"platform={d.platform} kind={d.device_kind} "
                     f"count={len(devices)}; card: {card}")


def keygen_phase(params, seed: int = 0):
    ck, sk = jax.block_until_ready(
        jax.jit(partial(tfhe.keygen, params))(jax.random.key(seed)))
    return (ck, sk), (f"{params.name}: bk_u32 {sk.bk_u32.nbytes / 1e6:.1f} MB, "
                      f"peak_bytes_in_use {peak_bytes()}")


def gates_phase(params, ck, sk, batches, card: str, reps: int = 5):
    """NAND through ``tfhe.gates`` at each batch size: zero gate errors and
    no noise failures, with the median call time (informational)."""
    nand = jax.jit(tfhe.gates.nand)
    rng = np.random.default_rng(7)
    lines = []
    for b in batches:
        x = rng.integers(0, 2, size=b).astype(np.uint32)
        y = rng.integers(0, 2, size=b).astype(np.uint32)
        c0 = tfhe.encrypt(ck, x, key=2 * b)
        c1 = tfhe.encrypt(ck, y, key=2 * b + 1)
        t, out = median_call_s(nand, sk, c0, c1, reps=reps)
        want = 1 - (x & y)
        errs = int((np.asarray(tfhe.decrypt(ck, out)) != want).sum())
        rep = unoise.measure(ck, out, want)
        check(errs == 0 and rep.failures == 0,
              f"B={b}: {errs}/{b} gate errors, {rep}")
        lines.append(
            f"B={b} ({mboot.resolve_impl('auto', b)}): 0/{b} gate errors, "
            f"noise max|e|/Delta {rep.max_abs_over_delta:.4f}, median "
            f"{t * 1e3:.3f} ms over {reps} calls [{card}]")
    return None, "\n  " + "\n  ".join(lines)


def _bmmp_pbs(params, ct, sk, tv, contraction):
    """PBS through the BMMP rotation with its contraction named explicitly."""
    approx = switch_modulus(ct, params.log_q, params.log_degree + 1)
    acc = mboot._blind_rotate_bmmp(params, approx, sk.bk_bmmp, tv, contraction)
    return mks.key_switch(mboot.sample_extract0(acc),
                          params.glwe_dimension * params.degree,
                          params.ks_decomposer, sk.ksk_mat)


def golden_phase(params, samples: int = 1, batch: int = 8, seed: int = 2024):
    """(a) Every backend's PBS is bit-exact against the golden model on
    ``samples`` ciphertexts, with masks and noise drawn by NumPy and injected
    into both (``jax.random`` sampling may differ between platforms).
    (b) At ``batch`` fresh ciphertexts every backend agrees bit-for-bit with
    the others; BMMP (a different rotation, hence other noise) agrees with
    itself through every contraction and decodes to the same messages.
    One golden sample by default: at default_128 the NumPy model takes
    minutes per bootstrap, and all 722 rotation steps run either way."""
    p = params
    on_gpu = jax.default_backend() == "gpu"
    rng = np.random.default_rng(seed)
    k, n_deg, n = p.glwe_dimension, p.degree, p.lwe_dimension
    rows = (k + 1) * p.pbs_decomposer.levels
    kl = k * n_deg * p.ks_decomposer.levels

    def gauss(std, shape):
        return golden.f64_to_torus(rng.normal(0.0, std, size=shape))

    lwe_sk = rng.integers(0, 2, size=n, dtype=np.uint32)
    glwe_sk = rng.integers(0, 2, size=(k, n_deg), dtype=np.uint32)
    bk_a = rng.integers(0, 1 << 32, size=(n, rows, k, n_deg), dtype=np.uint32)
    bk_e = gauss(p.glwe_std_dev, (n, rows, n_deg))
    ksk_a = rng.integers(0, 1 << 32, size=(kl, n), dtype=np.uint32)
    ksk_e = gauss(p.lwe_std_dev, (kl,))
    bmmp_a = rng.integers(0, 1 << 32, size=(3 * n // 2, rows, k, n_deg),
                          dtype=np.uint32)
    bmmp_e = gauss(p.glwe_std_dev, (3 * n // 2, rows, n_deg))
    bk_g, ksk_g = golden.bootstrapping_key_gen(
        lwe_sk, glwe_sk, p, bk_a, bk_e, ksk_a, ksk_e)
    sk = jax.jit(make_server_key, static_argnums=0)(
        p, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a, ksk_e, bmmp_a, bmmp_e)
    sk = with_ntt_key(sk)
    ck = ClientKey(lwe_sk=jnp.asarray(lwe_sk), glwe_sk=jnp.asarray(glwe_sk),
                   params=p)
    tv_clear = golden.construct_identity_test_vector(p)
    tv = jnp.asarray(mtv.identity_test_vector(p))

    msgs = (np.arange(samples, dtype=np.uint32) + 1) % (1 << p.log_p)
    a = rng.integers(0, 1 << 32, size=(samples, n), dtype=np.uint32)
    e = gauss(p.lwe_std_dev, (samples,))
    cts = np.stack([golden.encrypt_lwe(lwe_sk, golden.lwe_encode(m, p), a[i], e[i])
                    for i, m in enumerate(msgs)])
    want = np.stack([golden.bootstrap(ct, bk_g, ksk_g, tv_clear, p) for ct in cts])

    # conv has no GPU lowering: cuDNN takes no s8 x s8 -> s32 convolution
    impls = [i for i in mboot.VALID_IMPLS
             if i not in ("auto", "bmmp") and not (on_gpu and i == "conv")]
    pbs = jax.jit(mboot.pbs, static_argnums=0, static_argnames="impl")
    for impl in impls:
        got = np.asarray(pbs(p, cts, sk, tv, impl=impl))
        check(np.array_equal(got, want), f"{impl}: PBS differs from golden")

    m8 = rng.integers(0, 1 << p.log_p, size=batch).astype(np.uint32)
    c8 = tfhe.encrypt(ck, m8, key=seed)
    outs = {impl: np.asarray(pbs(p, c8, sk, tv, impl=impl)) for impl in impls}
    for impl, out in outs.items():
        check(np.array_equal(out, outs[impls[0]]),
              f"B={batch}: {impl} differs from {impls[0]}")
    bmmp = jax.jit(_bmmp_pbs, static_argnums=(0, 4))
    contractions = [c for c in ("conv", "matmul", "ntts")
                    if not (on_gpu and c == "conv")]
    bm = {c: np.asarray(bmmp(p, c8, sk, tv, c)) for c in contractions}
    for c, out in bm.items():
        check(np.array_equal(out, bm[contractions[0]]),
              f"bmmp through {c} differs from bmmp through {contractions[0]}")
        check(np.array_equal(np.asarray(tfhe.decrypt(ck, out)), m8),
              f"bmmp through {c} decodes wrongly")
    check(np.array_equal(np.asarray(tfhe.decrypt(ck, outs[impls[0]])), m8),
          "PBS decodes wrongly")
    return None, (f"{p.name}: {samples} golden sample(s) bit-exact for "
                  f"{', '.join(impls)}; B={batch} bit-identical across them; "
                  f"bmmp bit-identical through {', '.join(contractions)}")


def adder_phase(params, ck, sk, width: int = 8, batch: int = 64):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << width, size=batch).astype(np.uint32)
    b = rng.integers(0, 1 << width, size=batch).astype(np.uint32)
    s_bits, cout = jax.jit(mcirc.ripple_carry_add)(
        sk, mcirc.encrypt_uint(ck, a, width, key=31),
        mcirc.encrypt_uint(ck, b, width, key=32))
    s = np.asarray(mcirc.decrypt_uint(ck, s_bits))
    c = np.asarray(tfhe.decrypt(ck, cout))
    wrong = int((s != (a + b) % (1 << width)).sum())
    wrong_carry = int((c != (a + b) >> width).sum())
    check(wrong == 0 and wrong_carry == 0,
          f"{wrong}/{batch} wrong sums, {wrong_carry}/{batch} wrong carries")
    return None, (f"{params.name}: {batch} {width}-bit additions, all sums "
                  "and carries correct")


def cli_phase(params_name: str):
    """keygen -> encrypt -> gate -> decrypt through ``tfhe_jax.cli.main`` in
    this process, in a scratch directory inside the checkout."""
    from tfhe_jax.cli import main as cli

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(list(argv))
        return buf.getvalue().strip()

    with tempfile.TemporaryDirectory(dir=REPO) as d:
        run("keygen", "--params", params_name, "--out", d)
        run("encrypt", "--client", f"{d}/client.npz", "--bits", "0101",
            "--out", f"{d}/a.npz")
        run("encrypt", "--client", f"{d}/client.npz", "--bits", "0011",
            "--out", f"{d}/b.npz", "--seed", "2")
        run("gate", "--server", f"{d}/server.npz", "--op", "nand",
            "--lhs", f"{d}/a.npz", "--rhs", f"{d}/b.npz", "--out", f"{d}/o.npz")
        got = run("decrypt", "--client", f"{d}/client.npz", "--in", f"{d}/o.npz")
    check(got == "1110", f"cli nand(0101, 0011) decrypted to {got!r}")
    return None, f"{params_name}: nand(0101, 0011) = {got}"


def four_phase(params, devices, batch: int, card: str, reps: int = 3):
    """Data-parallel NAND over a (batch=4, model=1) mesh and a
    (batch=2, model=2) mesh (per-step u32 psum over the model axis), each
    bit-identical to the single-device result of the same process."""
    from tfhe_jax.parallel.mesh import make_mesh
    from tfhe_jax.parallel.sharded import make_sharded_gate

    check(len(devices) >= 4, f"needs 4 devices, found {len(devices)}")
    ck, sk = jax.jit(partial(tfhe.keygen, params))(jax.random.key(0))
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2, size=batch).astype(np.uint32)
    y = rng.integers(0, 2, size=batch).astype(np.uint32)
    c0 = tfhe.encrypt(ck, x, key=1)
    c1 = tfhe.encrypt(ck, y, key=2)
    t1, ref = median_call_s(jax.jit(tfhe.gates.nand), sk, c0, c1, reps=reps)
    ref = np.asarray(ref)
    errs = int((np.asarray(tfhe.decrypt(ck, ref)) != 1 - (x & y)).sum())
    check(errs == 0, f"single device: {errs}/{batch} gate errors")
    lines = [f"1 device: median {t1 * 1e3:.1f} ms, 0/{batch} gate errors"]
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(batch=shape[0], model=shape[1], devices=devices[:4])
        gate = make_sharded_gate(mesh, params, "nand")
        t, out = median_call_s(gate, c0, c1, sk, reps=reps)
        check(np.array_equal(np.asarray(out), ref),
              f"mesh {dict(mesh.shape)} differs from one device")
        lines.append(f"mesh {dict(mesh.shape)}: bit-identical to 1 device, "
                     f"median {t * 1e3:.1f} ms")
    return None, (f"{params.name} NAND at B={batch} [{card}]\n  "
                  + "\n  ".join(lines))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel gate over four cards")
    args = ap.parse_args(argv)

    card = nvidia_smi()
    # one line per card; the time lines carry the distinct name/limit pairs
    card_tag = "; ".join(dict.fromkeys(card.splitlines()))
    if not args.four:
        run_phase("gpu-tests", gpu_tests_phase)
    compile_cache.enable()
    devices = run_phase("device", device_phase, card_tag)
    log(f"card: {card}")
    params = tfhe.get_params("default_128")
    if args.four:
        run_phase("four", four_phase, params, devices, 4096, card_tag)
    else:
        ck, sk = run_phase("keygen", keygen_phase, params)
        run_phase("gates", gates_phase, params, ck, sk, (1, 8, 4096), card_tag)
        run_phase("golden", golden_phase, params)
        run_phase("adder", adder_phase, params, ck, sk)
        run_phase("cli", cli_phase, params.name)
    print(json.dumps({"ok": True, "device": describe(devices)}))


if __name__ == "__main__":
    main()
