"""Boolean gate layer (reference: src/boolean.rs), full suite, batched.

Every 2-input gate is the same circuit (src/boolean.rs:18-27): one linear
combination ct_in = 2*ct1 + ct0 followed by one PBS with the gate's LUT.
NOT is noise-free linear (no PBS); MUX composes AND/OR gates.  All gates take
u32[B, n+1] ciphertext batches — throughput scales with B, and the whole gate
is one jittable function.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tfhe_jax.models import bootstrap as mboot
from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models import test_vector as mtv
from tfhe_jax.models.keys import ClientKey, ServerKey
from tfhe_jax.ops import sampling
from tfhe_jax.ops.torus import decode as t_decode
from tfhe_jax.ops.torus import encode as t_encode
from tfhe_jax.ops.torus import u32


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


def encrypt(ck: ClientKey, messages, key=0) -> jnp.ndarray:
    """Encrypt a batch of cleartexts (0..2^log_p) -> u32[B, n+1]."""
    p = ck.params
    if isinstance(key, int):
        key = jax.random.key(key)
    msgs = u32(messages)
    k_a, k_e = jax.random.split(key)
    a = sampling.uniform_u32(k_a, msgs.shape + (p.lwe_dimension,))
    e = sampling.gaussian_torus(k_e, p.lwe_std_dev, msgs.shape)
    pt = t_encode(msgs, p.log_q, p.log_p, p.padding_bits)
    return mlwe.encrypt(ck.lwe_sk, pt, a, e)


def decrypt(ck: ClientKey, cts) -> jnp.ndarray:
    """Decrypt a batch -> cleartexts u32[B]."""
    p = ck.params
    pt = mlwe.decrypt(ck.lwe_sk, cts)
    return t_decode(pt, p.log_q, p.log_p, p.padding_bits)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def _pbs_with_tv(sk: ServerKey, ct_in, tv_encoded, impl: str) -> jnp.ndarray:
    return mboot.pbs(sk.params, ct_in, sk, u32(tv_encoded), impl=impl)


def gate(sk: ServerKey, name: str, ct0, ct1, impl: str = "auto") -> jnp.ndarray:
    """Named 2-input gate: ct_in = 2*ct1 + ct0, one PBS (src/boolean.rs:9-53)."""
    tv = jnp.asarray(mtv.gate_test_vector(sk.params, name))
    ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
    return _pbs_with_tv(sk, ct_in, tv, impl)


def apply_lut(sk: ServerKey, ct, lut, impl: str = "auto") -> jnp.ndarray:
    """Generic programmable bootstrap: ct already encodes the LUT index
    (0..2^log_p); ``lut`` maps each index to an output cleartext."""
    tv = jnp.asarray(mtv.lut_test_vector(sk.params, tuple(int(x) for x in lut)))
    return _pbs_with_tv(sk, ct, tv, impl)


def gate3(sk: ServerKey, name: str, ct2, ct1, ct0, impl: str = "auto") -> jnp.ndarray:
    """Named 3-input gate: ct_in = 4*ct2 + 2*ct1 + ct0, one PBS
    (notes/Boolean Gates.md:7-11).  Requires a log_p>=3 parameter set.
    ``mux3(s, a, b) = gate3('mux', s, a, b)`` is a single-PBS multiplexer."""
    tv = jnp.asarray(mtv.gate3_test_vector(sk.params, name))
    ct_in = mlwe.add(
        mlwe.add(mlwe.scalar_mul(ct2, 4), mlwe.scalar_mul(ct1, 2)), ct0
    )
    return _pbs_with_tv(sk, ct_in, tv, impl)


def mux3(sk: ServerKey, sel, a, b, impl: str = "auto") -> jnp.ndarray:
    """Single-PBS MUX on log_p>=3 params (vs the 3-PBS 2-input composition)."""
    return gate3(sk, "mux", sel, a, b, impl=impl)


def bootstrap_identity(sk: ServerKey, ct, impl: str = "auto") -> jnp.ndarray:
    """Noise-refreshing identity bootstrap (src/bootstrapping.rs tests)."""
    tv = jnp.asarray(mtv.identity_test_vector(sk.params))
    return _pbs_with_tv(sk, ct, tv, impl)


def not_(sk_or_params, ct) -> jnp.ndarray:
    """NOT: linear, noise-free — trivial(1) - ct.  No PBS needed."""
    p = sk_or_params.params if hasattr(sk_or_params, "params") else sk_or_params
    one = t_encode(jnp.uint32(1), p.log_q, p.log_p, p.padding_bits)
    ct = u32(ct)
    trivial = jnp.zeros_like(ct).at[..., -1].set(one)
    return trivial - ct


def mux(sk: ServerKey, sel, a, b, impl: str = "auto") -> jnp.ndarray:
    """MUX(sel, a, b) = sel ? a : b = OR(AND(sel, a), AND(NOT sel, b)).

    Three PBS; the ANDNY gate folds the NOT into its LUT so no extra linear
    step is needed.
    """
    t = gate(sk, "and", a, sel, impl=impl)
    f = gate(sk, "andny", b, sel, impl=impl)
    return gate(sk, "or", f, t, impl=impl)


def _named(name):
    def f(sk: ServerKey, ct0, ct1, impl: str = "auto"):
        return gate(sk, name, ct0, ct1, impl=impl)

    f.__name__ = name
    f.__doc__ = f"{name.upper()} gate via gate bootstrapping."
    return f


and_ = _named("and")
or_ = _named("or")
xor = _named("xor")
nand = _named("nand")
nor = _named("nor")
xnor = _named("xnor")
andny = _named("andny")
andyn = _named("andyn")
