"""Command-line interface: keygen / encrypt / gate / decrypt / demo.

The reference ships a hello-world binary (src/main.rs:1-3); this is the real
client/server workflow driver on top of the serialization layer:

    python -m tfhe_jax.cli keygen  --params default_128 --out keys/
    python -m tfhe_jax.cli encrypt --client keys/client.npz --bits 1011 --out a.npz
    python -m tfhe_jax.cli gate    --server keys/server.npz --op nand \
                                   --lhs a.npz --rhs b.npz --out out.npz
    python -m tfhe_jax.cli decrypt --client keys/client.npz --in out.npz
    python -m tfhe_jax.cli demo    --params test_insecure
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _jax():
    import jax

    return jax


def cmd_keygen(args):
    jax = _jax()
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    params = tfhe.get_params(args.params)
    t0 = time.time()
    ck, sk = jax.jit(lambda k: tfhe.keygen(params, k))(jax.random.key(args.seed))
    jax.block_until_ready(sk.bk_u32)
    os.makedirs(args.out, exist_ok=True)
    ser.save_client_key(os.path.join(args.out, "client.npz"), ck)
    ser.save_server_key(os.path.join(args.out, "server.npz"), sk)
    print(f"keygen({params.name}) in {time.time()-t0:.1f}s -> {args.out}/{{client,server}}.npz")


def cmd_encrypt(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    ck = ser.load_client_key(args.client)
    bits = np.array([int(c) for c in args.bits], dtype=np.uint32)
    assert np.all(bits < (1 << ck.params.log_p))
    cts = tfhe.encrypt(ck, bits, key=args.seed)
    ser.save_ciphertexts(args.out, cts, ck.params)
    print(f"encrypted {len(bits)} messages -> {args.out}")


def _load_server(args):
    from tfhe_jax.utils import serialization as ser

    sk = ser.load_server_key(args.server)
    if getattr(args, "impl", None) == "ntt":
        from tfhe_jax.models.keys import with_ntt_key

        sk = with_ntt_key(sk)
    return sk


def _load_cts(path, params):
    from tfhe_jax.utils import serialization as ser

    cts, p = ser.load_ciphertexts(path)
    assert p == params, f"parameter mismatch for {path}"
    return cts


def cmd_gate(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    sk = _load_server(args)
    lhs = _load_cts(args.lhs, sk.params)
    t0 = time.time()
    if args.op == "not":
        out = tfhe.gates.not_(sk, lhs)
        what = f"not on {lhs.shape[0]} ciphertexts"
    else:
        rhs = _load_cts(args.rhs, sk.params)
        if args.op == "mux":
            sel = _load_cts(args.sel, sk.params)
            out = tfhe.gates.mux(sk, sel, lhs, rhs, impl=args.impl)
        else:
            # index = 2*lhs + rhs
            out = tfhe.gates.gate(sk, args.op, rhs, lhs, impl=args.impl)
        what = f"{args.op} on {lhs.shape[0]} ciphertext pairs"
    np.asarray(out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"{what} in {time.time()-t0:.1f}s -> {args.out}")


def cmd_gate3(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    sk = _load_server(args)
    assert sk.params.log_p >= 3, "3-input gates need a log_p>=3 parameter set"
    c2 = _load_cts(args.in2, sk.params)
    c1 = _load_cts(args.in1, sk.params)
    c0 = _load_cts(args.in0, sk.params)
    t0 = time.time()
    out = tfhe.gates.gate3(sk, args.op, c2, c1, c0, impl=args.impl)
    np.asarray(out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"{args.op} on {c0.shape[0]} ciphertext triples in "
          f"{time.time()-t0:.1f}s -> {args.out}")


def cmd_lut(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    sk = _load_server(args)
    cts = _load_cts(args.infile, sk.params)
    lut = [int(c) for c in args.lut.split(",")]
    assert len(lut) == 1 << sk.params.log_p, (
        f"LUT needs 2^log_p = {1 << sk.params.log_p} entries, got {len(lut)}")
    t0 = time.time()
    out = tfhe.gates.apply_lut(sk, cts, lut, impl=args.impl)
    np.asarray(out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"lut on {cts.shape[0]} ciphertexts in {time.time()-t0:.1f}s -> {args.out}")


def cmd_add(args):
    """Encrypted W-bit ripple-carry addition (models/circuits.py): inputs are
    ciphertext files whose W ciphertexts are one integer's bits MSB-first (as
    produced by ``encrypt --bits``); output is the W sum bits MSB-first
    (modular: carry-out dropped unless --carry-out)."""
    import jax.numpy as jnp

    from tfhe_jax.models import circuits as mcirc
    from tfhe_jax.utils import serialization as ser

    sk = _load_server(args)
    lhs = _load_cts(args.lhs, sk.params)
    rhs = _load_cts(args.rhs, sk.params)
    assert lhs.shape == rhs.shape, "operand widths differ"
    w = lhs.shape[0]
    t0 = time.time()
    s, cout = mcirc.ripple_carry_add(
        sk, jnp.flip(lhs, 0)[:, None], jnp.flip(rhs, 0)[:, None],
        impl=args.impl)
    out = jnp.flip(s[:, 0], 0)
    if args.carry_out:
        out = jnp.concatenate([cout, out], axis=0)  # W+1 bits MSB-first
    np.asarray(out)
    ser.save_ciphertexts(args.out, out, sk.params)
    boots = 5 * w if sk.params.log_p == 2 else 2 * w
    print(f"{w}-bit add ({boots} bootstraps) in {time.time()-t0:.1f}s -> "
          f"{args.out}")


def cmd_noise(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import noise as unoise
    from tfhe_jax.utils import serialization as ser

    ck = ser.load_client_key(args.client)
    cts = _load_cts(args.infile, ck.params)
    if args.expect:
        want = np.array([int(c) for c in args.expect], dtype=np.uint32)
        assert want.shape[0] == cts.shape[0], "--expect length != batch"
    else:
        # measure against whatever the ciphertexts decode to (margin only)
        want = np.asarray(tfhe.decrypt(ck, cts))
    rep = unoise.measure(ck, cts, want)
    print(rep)


def cmd_decrypt(args):
    import tfhe_jax as tfhe
    from tfhe_jax.utils import serialization as ser

    ck = ser.load_client_key(args.client)
    cts, p = ser.load_ciphertexts(args.infile)
    assert p == ck.params
    bits = np.asarray(tfhe.decrypt(ck, cts))
    print("".join(str(int(b)) for b in bits))


def cmd_demo(args):
    jax = _jax()
    import tfhe_jax as tfhe

    params = tfhe.get_params(args.params)
    print(f"params: {params.name} (n={params.lwe_dimension}, k={params.glwe_dimension}, "
          f"N={params.degree})")
    t0 = time.time()
    ck, sk = jax.jit(lambda k: tfhe.keygen(params, k))(jax.random.key(0))
    jax.block_until_ready(sk.bk_u32)
    print(f"keygen: {time.time()-t0:.1f}s (bk {np.asarray(sk.bk_u32).nbytes/1e6:.1f} MB)")
    rng = np.random.default_rng(args.seed)
    a = rng.integers(0, 2, size=8).astype(np.uint32)
    b = rng.integers(0, 2, size=8).astype(np.uint32)
    ca = tfhe.encrypt(ck, a, key=1)
    cb = tfhe.encrypt(ck, b, key=2)
    for op, fn in [("and", None), ("xor", None), ("nand", None)]:
        t0 = time.time()
        out = tfhe.gates.gate(sk, op, cb, ca)
        got = np.asarray(tfhe.decrypt(ck, out))
        import tfhe_jax.models.test_vector as mtv

        want = np.array([mtv.GATE_FNS[op](int(x), int(y)) for x, y in zip(a, b)])
        ok = "OK" if np.array_equal(got, want) else "MISMATCH"
        print(f"{op:5s}({a.tolist()},{b.tolist()}) = {got.tolist()} [{ok}] "
              f"({time.time()-t0:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tfhe_jax")
    sub = ap.add_subparsers(dest="cmd", required=True)

    kg = sub.add_parser("keygen");  kg.set_defaults(fn=cmd_keygen)
    kg.add_argument("--params", default="default_128")
    kg.add_argument("--out", required=True)
    kg.add_argument("--seed", type=int, default=0)

    en = sub.add_parser("encrypt"); en.set_defaults(fn=cmd_encrypt)
    en.add_argument("--client", required=True)
    en.add_argument("--bits", required=True, help="e.g. 1011")
    en.add_argument("--out", required=True)
    en.add_argument("--seed", type=int, default=1)

    #: every library backend is reachable from the CLI (bench.py exposes the
    #: same list) — single source of truth in models/bootstrap.py
    from tfhe_jax.models.bootstrap import VALID_IMPLS

    impls = list(VALID_IMPLS)

    ga = sub.add_parser("gate");    ga.set_defaults(fn=cmd_gate)
    ga.add_argument("--server", required=True)
    ga.add_argument("--op", required=True,
                    choices=sorted(list(mtv_gate_names()) + ["not", "mux"]))
    ga.add_argument("--lhs", required=True)
    ga.add_argument("--rhs", help="required for binary gates (not for 'not')")
    ga.add_argument("--sel", help="selector ciphertexts (mux only)")
    ga.add_argument("--out", required=True)
    ga.add_argument("--impl", default="auto", choices=impls)

    g3 = sub.add_parser("gate3");   g3.set_defaults(fn=cmd_gate3)
    g3.add_argument("--server", required=True)
    g3.add_argument("--op", required=True, choices=sorted(mtv_gate3_names()))
    g3.add_argument("--in2", required=True, help="MSB input (e.g. mux selector)")
    g3.add_argument("--in1", required=True)
    g3.add_argument("--in0", required=True, help="LSB input")
    g3.add_argument("--out", required=True)
    g3.add_argument("--impl", default="auto", choices=impls)

    lu = sub.add_parser("lut");     lu.set_defaults(fn=cmd_lut)
    lu.add_argument("--server", required=True)
    lu.add_argument("--in", dest="infile", required=True)
    lu.add_argument("--lut", required=True,
                    help="comma-separated 2^log_p outputs, e.g. 0,1,1,0... ")
    lu.add_argument("--out", required=True)
    lu.add_argument("--impl", default="auto", choices=impls)

    ad = sub.add_parser("add");     ad.set_defaults(fn=cmd_add)
    ad.add_argument("--server", required=True)
    ad.add_argument("--lhs", required=True, help="W bit ciphertexts, MSB-first")
    ad.add_argument("--rhs", required=True)
    ad.add_argument("--out", required=True)
    ad.add_argument("--carry-out", action="store_true",
                    help="emit W+1 bits (keep the carry)")
    ad.add_argument("--impl", default="auto", choices=impls)

    no = sub.add_parser("noise");   no.set_defaults(fn=cmd_noise)
    no.add_argument("--client", required=True)
    no.add_argument("--in", dest="infile", required=True)
    no.add_argument("--expect", default="",
                    help="expected cleartext digits, e.g. 1011 (default: "
                    "measure against the decoded values)")

    de = sub.add_parser("decrypt"); de.set_defaults(fn=cmd_decrypt)
    de.add_argument("--client", required=True)
    de.add_argument("--in", dest="infile", required=True)

    dm = sub.add_parser("demo");    dm.set_defaults(fn=cmd_demo)
    dm.add_argument("--params", default="test_insecure")
    dm.add_argument("--seed", type=int, default=7)

    args = ap.parse_args(argv)
    from tfhe_jax.utils import compile_cache

    compile_cache.enable()
    if args.cmd == "gate":
        if args.op == "mux" and args.sel is None:
            ap.error("--sel required for mux")
        if args.op not in ("not",) and args.rhs is None:
            ap.error("--rhs required for binary gates")
    args.fn(args)


def mtv_gate_names():
    from tfhe_jax.models.test_vector import GATE_FNS

    return GATE_FNS.keys()


def mtv_gate3_names():
    from tfhe_jax.models.test_vector import GATE3_FNS

    return GATE3_FNS.keys()


if __name__ == "__main__":
    main()
