"""Key/ciphertext serialization (SURVEY.md section 5: absent in the reference,
required for client/server separation and multi-host key distribution).

Format: a single ``.npz`` with u32/int8 arrays plus the parameter set as a
JSON string.  Derived key layouts (conv kernel, limb matrices) are
recomputed on load rather than stored — the canonical u32 tensors are the
wire format.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from tfhe_jax.models.keys import ClientKey, ServerKey
from tfhe_jax.models.keyswitch import ksk_to_matmul
from tfhe_jax.ops.poly import bk_to_conv_kernel
from tfhe_jax.params import DecomposerParams, TfheParams


def params_to_json(p: TfheParams) -> str:
    return json.dumps(dataclasses.asdict(p))


def params_from_json(s: str) -> TfheParams:
    d = json.loads(s)
    d["ks_decomposer"] = DecomposerParams(**d["ks_decomposer"])
    d["pbs_decomposer"] = DecomposerParams(**d["pbs_decomposer"])
    return TfheParams(**d)


def save_client_key(path: str, ck: ClientKey) -> None:
    np.savez_compressed(
        path,
        lwe_sk=np.asarray(ck.lwe_sk),
        glwe_sk=np.asarray(ck.glwe_sk),
        params=np.array(params_to_json(ck.params)),
    )


def load_client_key(path: str) -> ClientKey:
    with np.load(path) as z:
        return ClientKey(
            lwe_sk=jnp.asarray(z["lwe_sk"]),
            glwe_sk=jnp.asarray(z["glwe_sk"]),
            params=params_from_json(str(z["params"])),
        )


def save_server_key(path: str, sk: ServerKey) -> None:
    """Canonical u32 tensors only; derived contraction layouts rebuilt on load.
    The optional BMMP key triples ride along when present."""
    arrays = dict(
        bk_u32=np.asarray(sk.bk_u32),
        ksk_u32=np.asarray(sk.ksk_u32),
        params=np.array(params_to_json(sk.params)),
    )
    if sk.bk_bmmp is not None:
        arrays["bk_bmmp"] = np.asarray(sk.bk_bmmp)
    np.savez_compressed(path, **arrays)


def load_server_key(path: str) -> ServerKey:
    """Rebuilds the derived contraction layouts (conv kernel, limb matrices) from the
    canonical tensors.  The optional NTT-domain operand is NOT stored (it is
    ~24x the canonical BK): call ``models.keys.with_ntt_key`` on the loaded
    key before using ``impl='ntt'``."""
    with np.load(path) as z:
        bk_u32 = jnp.asarray(z["bk_u32"])
        ksk_u32 = jnp.asarray(z["ksk_u32"])
        params = params_from_json(str(z["params"]))
        return ServerKey(
            bk_u32=bk_u32,
            bk_conv=bk_to_conv_kernel(bk_u32),
            ksk_u32=ksk_u32,
            ksk_mat=ksk_to_matmul(ksk_u32),
            params=params,
            bk_bmmp=jnp.asarray(z["bk_bmmp"]) if "bk_bmmp" in z else None,
        )


def save_ciphertexts(path: str, cts, params: TfheParams) -> None:
    np.savez_compressed(
        path, data=np.asarray(cts), params=np.array(params_to_json(params))
    )


def load_ciphertexts(path: str):
    with np.load(path) as z:
        return jnp.asarray(z["data"]), params_from_json(str(z["params"]))
