"""Depth demo on one NVIDIA GPU: W-bit ripple-carry adder at default_128.

Runs B parallel W-bit encrypted additions through the gate layer
(models/circuits.py: same-depth gates batched into wide PBS calls), asserts
every sum + carry-out exact, and noise-meters EVERY traced stage against its
expected cleartext — per-depth noise must stay flat, because each gate output
is a fresh bootstrap (the property that makes unbounded-depth circuits work;
src/boolean.rs:9-53 composition pattern).

Prints one JSON line (and writes it to --out when given).  Exits non-zero,
printing no result, when no GPU is present.

Usage: python scripts/bench_adder.py [--width 8] [--batch 256]
       [--impl auto] [--params default_128] [--out adder.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--params", default="default_128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from tfhe_jax.utils import compile_cache
    from tfhe_jax.utils.device import describe, nvidia_smi, require_gpu
    from tfhe_jax.utils.profiling import median_call_s

    card = nvidia_smi()
    require_gpu(jax.devices())
    compile_cache.enable()

    import tfhe_jax as tfhe
    from tfhe_jax.models import boolean as mbool
    from tfhe_jax.models import circuits as mcirc
    from tfhe_jax.utils import noise as unoise

    params = tfhe.get_params(args.params)
    w, batch, impl = args.width, args.batch, args.impl
    log(f"device: {describe(jax.devices())}, card: {card}, params: "
        f"{params.name}, impl: {impl}, width: {w}, batch: {batch}")

    t0 = time.perf_counter()
    ck, sk = jax.jit(lambda k: tfhe.keygen(params, k))(jax.random.key(0))
    jax.block_until_ready(sk.bk_u32)
    log(f"keygen: {time.perf_counter()-t0:.1f}s")

    rng = np.random.default_rng(0)
    a_int = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    b_int = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    a_bits = jax.block_until_ready(mcirc.encrypt_uint(ck, a_int, w, key=1))
    b_bits = jax.block_until_ready(mcirc.encrypt_uint(ck, b_int, w, key=2))

    # jit the full adder as one function of (bits, bits, server key)
    def add_fn(a, b, server):
        return mcirc.ripple_carry_add(server, a, b, impl=impl)

    f = jax.jit(add_fn)
    med, (s_bits, cout) = median_call_s(f, a_bits, b_bits, sk, reps=args.reps)

    boots_per_add = 5 * w if params.log_p == 2 else 2 * w
    adds_per_s = batch / med
    boots_per_s = adds_per_s * boots_per_add
    log(f"{w}-bit add x{batch}: median {med*1e3:.1f}ms -> "
        f"{adds_per_s:.1f} adds/s = {boots_per_s:.0f} bootstraps/s")

    # correctness
    got = np.asarray(mcirc.decrypt_uint(ck, s_bits))
    want = (a_int + b_int) & ((1 << w) - 1)
    errs = int((got != want).sum())
    cout_got = np.asarray(mbool.decrypt(ck, cout))
    carry_errs = int((cout_got != ((a_int + b_int) >> w)).sum())
    log(f"check: {errs}/{batch} wrong sums, {carry_errs}/{batch} wrong carries")

    # per-depth noise metering: re-run once with the trace hook (outside jit —
    # the traced intermediates must materialize) and decrypt every stage
    trace = []
    s2, _ = mcirc.ripple_carry_add(sk, a_bits, b_bits, impl=impl, trace=trace)
    jax.block_until_ready(s2)
    per_depth = {}
    for label, depth, cts, clear_fn in trace:
        wantc = np.asarray(clear_fn(a_int, b_int, 0), np.uint32)
        ctsn = np.asarray(cts)
        flat = ctsn.reshape(-1, ctsn.shape[-1])
        rep = unoise.measure(ck, flat, wantc.reshape(-1))
        per_depth[label] = dict(
            depth=depth, max_e_over_delta=round(rep.max_abs_over_delta, 4),
            mean_e_over_delta=round(rep.mean_abs_over_delta, 4),
            failures=rep.failures)
        log(f"  depth {depth:>2} {label:>10}: max|e|/D="
            f"{rep.max_abs_over_delta:.4f} mean={rep.mean_abs_over_delta:.4f}")
    max_by_depth = {}
    for v in per_depth.values():
        max_by_depth[v["depth"]] = max(
            max_by_depth.get(v["depth"], 0.0), v["max_e_over_delta"])
    flat_noise = max(max_by_depth.values()) < 0.5 and (
        max(max_by_depth.values()) < 2.5 * min(max_by_depth.values()))

    artifact = dict(
        metric=f"{w}-bit encrypted ripple-carry adds/s (batched, depth "
               f"{max(v['depth'] for v in per_depth.values())})",
        params=params.name, impl=impl, width=w, batch=batch,
        device=describe(jax.devices()), card=card,
        add_ms=round(med * 1e3, 3),
        adds_per_s=round(adds_per_s, 1),
        bootstraps_per_add=boots_per_add,
        bootstraps_per_s=round(boots_per_s, 1),
        wrong_sums=errs,
        wrong_carries=carry_errs,
        per_stage_noise=per_depth,
        max_noise_by_depth={str(k): round(v, 4)
                            for k, v in sorted(max_by_depth.items())},
        noise_flat_across_depth=bool(flat_noise),
        note="every gate output is a fresh bootstrap: |e|/Delta must not "
             "grow with circuit depth (it is the per-PBS output noise + one "
             "linear 2x+1 combination, independent of depth)",
    )
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        log(f"wrote {args.out}")
    print(json.dumps(artifact))


if __name__ == "__main__":
    main()
