"""Benchmark: gate bootstraps/s on one NVIDIA GPU.

Workload: batched NAND gate bootstrapping at the default_128 parameter set
(n=722, k=2, N=512, l_pbs=6, l_ks=5 — the reference's non-test default,
src/lib.rs:101-123).  The reference publishes no numbers (SURVEY.md section
6).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "bootstraps/s", "device": {...},
   "card": "<nvidia-smi name, power.limit>", "breakdown": {per-stage timings,
   correctness, noise margin}}
Diagnostics go to stderr.  Correctness (--check) is ON by default: the
decrypted gate outputs and the noise margin of the same run ride along in the
breakdown, so the number always carries its own evidence.  Exits non-zero,
printing no result, when no GPU is present.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from tfhe_jax.models.bootstrap import VALID_IMPLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="default_128")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--impl", default="auto", choices=list(VALID_IMPLS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the same-run correctness/noise verification")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage breakdown timings")
    ap.add_argument("--trace", default="",
                    help="capture a jax profiler trace of one gate call to this dir")
    ap.add_argument("--latency", action="store_true",
                    help="also time single calls at B = 1 and 8")
    args = ap.parse_args()

    from tfhe_jax.utils.device import describe, nvidia_smi, require_gpu

    card = nvidia_smi()
    require_gpu(jax.devices())
    from tfhe_jax.utils import compile_cache

    compile_cache.enable()

    import tfhe_jax as tfhe
    from tfhe_jax.models import keyswitch as mks
    from tfhe_jax.models import lwe as mlwe
    from tfhe_jax.models import test_vector as mtv
    from tfhe_jax.models.bootstrap import (
        blind_rotate, pbs, resolve_impl, sample_extract0,
    )
    from tfhe_jax.models.keys import keygen, with_ntt_key
    from tfhe_jax.ops.torus import switch_modulus, u32
    from tfhe_jax.utils import noise as unoise
    from tfhe_jax.utils.profiling import median_call_s

    params = tfhe.get_params(args.params)
    device = describe(jax.devices())
    batch = args.batch
    impl = resolve_impl(args.impl, batch)
    log(f"device: {device}, card: {card}, params: {params.name}, "
        f"impl: {impl}, batch: {batch}")

    t0 = time.perf_counter()
    ck, sk = jax.jit(partial(keygen, params, bmmp=impl == "bmmp"))(
        jax.random.key(0))
    jax.block_until_ready(sk.bk_u32)
    keygen_s = time.perf_counter() - t0
    log(f"keygen (jitted, compile included): {keygen_s:.1f}s  "
        f"bk={sk.bk_u32.nbytes / 1e6:.1f}MB")
    if impl == "ntt":
        sk = jax.jit(with_ntt_key)(sk)
        jax.block_until_ready(sk.bk_ntt)

    tv = jnp.asarray(mtv.gate_test_vector(params, "nand"))

    def gate(ct0, ct1, server_key, impl=impl):
        ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
        return pbs(params, ct_in, server_key, tv, impl=impl)

    f = jax.jit(gate, static_argnames="impl")
    rng = np.random.default_rng(0)
    lhs = rng.integers(0, 2, size=batch).astype(np.uint32)
    rhs = rng.integers(0, 2, size=batch).astype(np.uint32)
    ct1 = jax.block_until_ready(tfhe.encrypt(ck, lhs, key=1))
    ct0 = jax.block_until_ready(tfhe.encrypt(ck, rhs, key=2))

    t0 = time.perf_counter()
    jax.block_until_ready(f(ct0, ct1, sk))
    log(f"first call (compile+run): {time.perf_counter() - t0:.1f}s")
    t_gate, out = median_call_s(f, ct0, ct1, sk, reps=args.reps)
    rate = batch / t_gate
    log(f"end-to-end: median {t_gate * 1e3:.2f}ms -> {rate:.1f} bootstraps/s")

    breakdown = {
        "impl": impl,
        "batch": batch,
        "keygen_s": round(keygen_s, 2),
        "gate_ms": round(t_gate * 1e3, 3),
        "per_rotation_step_us": round(t_gate * 1e6 / params.lwe_dimension, 2),
    }

    if not args.no_stages:
        # stage-by-stage timings (each jitted separately; sums slightly above
        # the fused end-to-end time because inter-stage values go to memory)
        lin = jax.jit(lambda c0, c1: switch_modulus(
            u32(mlwe.add(mlwe.scalar_mul(c1, 2), c0)),
            params.log_q, params.log_degree + 1))
        rot = jax.jit(lambda ap, k: blind_rotate(params, ap, k, tv, impl=impl))
        ext = jax.jit(sample_extract0)
        ks = jax.jit(lambda e, k: mks.key_switch(
            e, params.glwe_dimension * params.degree, params.ks_decomposer,
            k.ksk_mat))
        t_lin, approx = median_call_s(lin, ct0, ct1, reps=args.reps)
        t_rot, acc = median_call_s(rot, approx, sk, reps=args.reps)
        t_ext, extracted = median_call_s(ext, acc, reps=args.reps)
        t_ks, _ = median_call_s(ks, extracted, sk, reps=args.reps)
        breakdown["stages_ms"] = {
            "linear+modswitch": round(t_lin * 1e3, 3),
            "blind_rotate": round(t_rot * 1e3, 3),
            "sample_extract": round(t_ext * 1e3, 3),
            "key_switch": round(t_ks * 1e3, 3),
        }
        log(f"stages: {breakdown['stages_ms']}")

    if args.latency:
        # time to first result when only a few gates are ready, through the
        # backend the requested impl resolves to at that batch
        lat = {}
        for b in (1, 8):
            impl_b = resolve_impl(args.impl, b)
            t, _ = median_call_s(partial(f, impl=impl_b), ct0[:b], ct1[:b],
                                 sk, reps=args.reps)
            lat[f"{b} ({impl_b})"] = round(t * 1e3, 3)
            log(f"latency batch={b} ({impl_b}): median {t * 1e3:.3f}ms")
        breakdown["latency_ms"] = lat

    if args.trace:
        from tfhe_jax.utils.profiling import capture_trace

        with capture_trace(args.trace):
            jax.block_until_ready(f(ct0, ct1, sk))
        log(f"profiler trace written to {args.trace}")

    if not args.no_check:
        got = np.asarray(tfhe.decrypt(ck, out))
        want = 1 - (lhs & rhs)
        errs = int((got != want).sum())
        rep = unoise.measure(ck, out, want)
        breakdown["gate_errors"] = errs
        breakdown["noise_max_over_delta"] = round(rep.max_abs_over_delta, 4)
        breakdown["noise_mean_over_delta"] = round(rep.mean_abs_over_delta, 4)
        log(f"check: {errs}/{batch} gate errors; {rep}")

    print(json.dumps({
        "metric": f"gate bootstraps/s ({params.name} NAND, batched PBS)",
        "value": round(rate, 2),
        "unit": "bootstraps/s",
        "device": device,
        "card": card,
        "breakdown": breakdown,
    }))


if __name__ == "__main__":
    main()
