"""Composed boolean circuits: full adder + ripple-carry adder, batched.

The reference stops at single gates (src/boolean.rs:9-53); its composition
pattern — every gate output is a fresh bootstrap, so circuits of unbounded
depth stay correct — is exercised here end-to-end.  This is the one thing the
scheme exists for: each PBS *refreshes* noise, so per-depth noise must stay
flat (asserted by scripts/bench_adder.py's per-depth noise metering).

Batch-first shaping: gates at the SAME circuit depth share a LUT, so they
run as ONE batched PBS over [W*B] ciphertexts (the batch axis is the
throughput axis).  A W-bit ripple-carry add
of B pairs therefore costs

  * log_p == 2 (``default_128``): 3 wide calls (XOR halves, AND carries,
    final XOR sums) + 2 narrow calls per carry step  -> 2W + 3 PBS calls,
    5W bootstraps total (vs 5W separate calls naively);
  * log_p >= 3 (``default_128_3in``): one ``maj`` call per carry + one wide
    ``xor3`` for all sums -> W + 1 calls, 2W bootstraps total (the 3-input
    encoding 4a + 2b + c, notes/Boolean Gates.md:7-11).

Bit layout: little-endian u32[W, B, n+1] (bit i of sample j = ``bits[i, j]``).
"""

from __future__ import annotations

import jax.numpy as jnp

from tfhe_jax.models import boolean as mbool
from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models.keys import ClientKey, ServerKey
from tfhe_jax.ops.torus import encode as t_encode
from tfhe_jax.ops.torus import u32


def encrypt_uint(ck: ClientKey, values, width: int, key=0) -> jnp.ndarray:
    """Encrypt integers < 2^width as little-endian bit batches
    u32[width, B, n+1]."""
    vals = u32(values)
    bits = jnp.stack([(vals >> jnp.uint32(i)) & jnp.uint32(1)
                      for i in range(width)])
    return mbool.encrypt(ck, bits, key=key)


def decrypt_uint(ck: ClientKey, bits) -> jnp.ndarray:
    """Decrypt u32[W, B, n+1] bit batches back to integers u32[B]."""
    msgs = mbool.decrypt(ck, bits)  # [W, B]
    w = msgs.shape[0]
    weights = (jnp.uint32(1) << jnp.arange(w, dtype=jnp.uint32))[:, None]
    return (msgs * weights).sum(axis=0, dtype=jnp.uint32)


def trivial_bit(params, batch_shape, value: int) -> jnp.ndarray:
    """Noiseless trivial LWE of a known bit (mask 0, body = encode(value)) —
    the standard trivial ciphertext (cf. src/glwe.rs trivial encryption)."""
    body = t_encode(jnp.uint32(value), params.log_q, params.log_p,
                    params.padding_bits)
    ct = jnp.zeros(tuple(batch_shape) + (params.lwe_dimension + 1,),
                   jnp.uint32)
    return ct.at[..., -1].set(body)


def full_adder(sk: ServerKey, a, b, cin, impl: str = "auto"):
    """(sum, carry_out) of single bits a + b + cin.

    log_p >= 3 params: 2 bootstraps (``xor3``, ``maj``), depth 1.
    log_p == 2 params: 5 bootstraps (x = a^b; s = x^cin; g = ab; h = x&cin;
    cout = g|h), depth 3.
    """
    if sk.params.log_p >= 3:
        s = mbool.gate3(sk, "xor3", a, b, cin, impl=impl)
        cout = mbool.gate3(sk, "maj", a, b, cin, impl=impl)
        return s, cout
    x = mbool.gate(sk, "xor", a, b, impl=impl)
    g = mbool.gate(sk, "and", a, b, impl=impl)
    s = mbool.gate(sk, "xor", x, cin, impl=impl)
    h = mbool.gate(sk, "and", x, cin, impl=impl)
    cout = mbool.gate(sk, "or", g, h, impl=impl)
    return s, cout


def ripple_carry_add(sk: ServerKey, a_bits, b_bits, cin=None,
                     impl: str = "auto", trace: list | None = None):
    """W-bit ripple-carry addition of encrypted integers, batched.

    a_bits/b_bits: u32[W, B, n+1] little-endian bit batches; ``cin``
    defaults to a trivial 0.  Returns (sum_bits u32[W, B, n+1], carry_out
    u32[B, n+1]).  Same-depth gates are batched into single wide PBS calls
    (module docstring); the carry chain is the serial axis.

    ``trace`` (optional list) collects (label, depth, cts, clear_fn) tuples
    for per-depth noise metering: ``clear_fn(a_clear, b_clear, cin_clear)``
    returns the expected cleartexts for that stage's outputs.
    """
    w, batch = a_bits.shape[0], a_bits.shape[1]
    p = sk.params
    c = trivial_bit(p, (batch,), 0) if cin is None else cin

    def note(label, depth, cts, clear_fn):
        if trace is not None:
            trace.append((label, depth, cts, clear_fn))

    if p.log_p >= 3:
        # carry chain: c_{i+1} = maj(a_i, b_i, c_i), one PBS per bit
        carries = [c]
        for i in range(w):
            c = mbool.gate3(sk, "maj", a_bits[i], b_bits[i], c, impl=impl)
            note(f"carry[{i}]", i + 1, c,
                 lambda a, b, c0, i=i: _clear_carry(a, b, c0, i + 1))
            carries.append(c)
        # all W sums in one wide xor3 call at their respective depths
        cin_stack = jnp.stack(carries[:w])  # [W, B, n+1]
        flat = lambda x: x.reshape((w * batch,) + x.shape[2:])
        s = mbool.gate3(sk, "xor3", flat(a_bits), flat(b_bits),
                        flat(cin_stack), impl=impl)
        s = s.reshape((w, batch) + s.shape[1:])
        note("sums", w + 1, s,
             lambda a, b, c0: [_clear_sum(a, b, c0, i) for i in range(w)])
        return s, carries[w]

    # log_p == 2: wide XOR + AND over all bits at once, then the carry chain
    flat = lambda x: x.reshape((w * batch,) + x.shape[2:])
    unflat = lambda x: x.reshape((w, batch) + x.shape[1:])
    x = unflat(mbool.gate(sk, "xor", flat(a_bits), flat(b_bits), impl=impl))
    g = unflat(mbool.gate(sk, "and", flat(a_bits), flat(b_bits), impl=impl))
    note("halves.x", 1, x, lambda a, b, c0: [
        ((a >> i) ^ (b >> i)) & 1 for i in range(w)])
    note("halves.g", 1, g, lambda a, b, c0: [
        ((a >> i) & (b >> i)) & 1 for i in range(w)])
    carries = [c]
    for i in range(w):
        h = mbool.gate(sk, "and", x[i], c, impl=impl)
        c = mbool.gate(sk, "or", g[i], h, impl=impl)
        note(f"carry[{i}]", i + 2, c,
             lambda a, b, c0, i=i: _clear_carry(a, b, c0, i + 1))
        carries.append(c)
    cin_stack = jnp.stack(carries[:w])
    s = unflat(mbool.gate(sk, "xor", flat(x), flat(cin_stack), impl=impl))
    note("sums", w + 2, s,
         lambda a, b, c0: [_clear_sum(a, b, c0, i) for i in range(w)])
    return s, carries[w]


def _clear_carry(a, b, c0, i):
    """Clear carry INTO bit i of a + b + c0 (numpy/int arrays)."""
    mask = (1 << i) - 1
    return (((a & mask) + (b & mask) + c0) >> i) & 1


def _clear_sum(a, b, c0, i):
    return ((a + b + c0) >> i) & 1


def add_uint(sk: ServerKey, a_bits, b_bits, impl: str = "auto"):
    """W-bit modular addition (carry-out dropped), the CLI/demo entry."""
    s, _ = ripple_carry_add(sk, a_bits, b_bits, impl=impl)
    return s
