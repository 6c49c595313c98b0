"""tfhe_jax — TFHE as batched integer tensor programs in JAX / XLA.

A from-scratch reimplementation of the capabilities of the reference Rust
crate (Janmajayamall/tfhe-research): torus LWE/GLWE/GGSW encryption, signed
gadget decomposition, external products and CMUX, LWE key switching,
blind-rotation programmable bootstrapping with test-vector LUTs, and a boolean
gate layer — redesigned for accelerators: dense u32 tensors with leading batch
axes, exact int8-limb contractions, `lax.scan` blind rotation, and
`jax.sharding` batch/model parallelism.

Quick start::

    import jax, numpy as np, tfhe_jax as tfhe
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, jax.random.key(0))
    a = tfhe.encrypt(ck, np.array([1, 0, 1]), key=1)
    b = tfhe.encrypt(ck, np.array([1, 1, 0]), key=2)
    out = tfhe.gates.nand(sk, a, b)
    bits = tfhe.decrypt(ck, out)        # [0, 1, 1]
"""

from tfhe_jax.models import boolean as gates
from tfhe_jax.models.boolean import bootstrap_identity, decrypt, encrypt
from tfhe_jax.models.keys import ClientKey, ServerKey, keygen, make_server_key
from tfhe_jax.params import (
    DecomposerParams,
    GgswParams,
    GlweParams,
    LweParams,
    PARAMS,
    TfheParams,
    get_params,
)

__all__ = [
    "ClientKey",
    "DecomposerParams",
    "GgswParams",
    "GlweParams",
    "LweParams",
    "PARAMS",
    "ServerKey",
    "TfheParams",
    "bootstrap_identity",
    "decrypt",
    "encrypt",
    "gates",
    "get_params",
    "keygen",
    "make_server_key",
]

__version__ = "0.1.0"
