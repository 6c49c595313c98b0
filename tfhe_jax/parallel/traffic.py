"""Collective-traffic audit of the sharded gates.

The per-step collective payloads are read straight out of the COMPILED
sharded gate's HLO (``extract_collectives`` walks the post-SPMD module text
for all-reduce / all-gather / collective-permute result shapes) and asserted
against the closed-form model (``expected_collectives``) in
``tests/test_parallel.py``, so the wire-byte table in docs/ARCHITECTURE.md is
machine-checked.  ``wire_bytes_per_sample_step`` turns those payloads into
per-chip bytes: ring all-reduce moves 2*(D-1)/D x payload per chip,
all-gather receives (D-1)/D x the full result, and a ppermute hop moves its
payload once per stage boundary (amortized over the n rotation steps a
sample spends in the pipe).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from tfhe_jax.params import TfheParams

# result-shape of every cross-replica op in a compiled HLO module, e.g.
#   %psum.7 = u32[8,256]{1,0} all-reduce(%fusion), channel_id=1, ...
_COLLECTIVE_RE = re.compile(
    r"=\s+\(?([a-z]+[0-9]+)\[([0-9,]*)\]\S*\s+"
    r"(all-reduce|all-gather|collective-permute|all-to-all|reduce-scatter)\("
)
# every syntactic occurrence of a collective op name, INCLUDING forms the
# parser above does not model (async -start/-done pairs, tuple-result
# combined collectives).  extract_collectives cross-checks against this so
# a future XLA that asyncifies/combines collectives makes the audit FAIL
# LOUDLY instead of silently returning [] (which would false-pass the
# "DP has no collectives" assertion).
_COLLECTIVE_TOKEN_RE = re.compile(
    r"(all-reduce|all-gather|collective-permute|all-to-all|reduce-scatter)"
    r"(-start|-done)?\("
)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}


@dataclass(frozen=True)
class Collective:
    kind: str  # all-reduce | all-gather | collective-permute | all-to-all
    dtype: str
    shape: tuple
    bytes: int  # result payload bytes


def extract_collectives(compiled_hlo_text: str) -> list[Collective]:
    """All cross-replica ops (with result payload sizes) in a compiled HLO
    module, in textual order.  While-loop bodies appear once.

    Raises ValueError if the module contains collective ops in a form this
    parser does not model (async -start/-done pairs or tuple-result combined
    collectives) — better a loud failure than an audit that undercounts.
    """
    out = []
    for m in _COLLECTIVE_RE.finditer(compiled_hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        shape = tuple(int(d) for d in dims.split(",")) if dims else ()
        n = 1
        for d in shape:
            n *= d
        out.append(Collective(kind, dtype, shape, n * _DTYPE_BYTES[dtype]))
    tokens = [m for m in _COLLECTIVE_TOKEN_RE.finditer(compiled_hlo_text)
              if m.group(2) != "-done"]
    if len(tokens) != len(out):
        raise ValueError(
            f"HLO contains {len(tokens)} collective ops but only {len(out)} "
            "parsed as synchronous single-result forms — async or "
            "tuple-result collectives present; extend the traffic parser "
            "before trusting the audit")
    return out


def gate_collectives(run_jit, *abstract_args) -> list[Collective]:
    """Compile a sharded gate's underlying jit fn on abstract inputs and
    extract its collectives (no key material or execution needed)."""
    return extract_collectives(
        run_jit.lower(*abstract_args).compile().as_text()
    )


def expected_collectives(
    params: TfheParams, mode: str, batch_local: int,
    m_microbatches: int = 0,
) -> dict[str, set[int]]:
    """Closed-form per-mode collective payload model: result-payload byte
    sizes, keyed by collective kind.

    mode: 'tp' (BK rows + KSK rows sharded, per-step u32 delta psum),
    'coeffs' (SP analog: per-step u32 delta all_gather over the coefficient
    axis), 'ntt' (NTT bins sharded: per-step raw INTT limb-plane psum),
    'pp' (pipeline: per-tick accumulator ppermute hop + one final
    result-replication psum), 'dp' (none).
    """
    k1 = params.glwe_dimension + 1
    n_deg = params.degree
    delta = batch_local * k1 * n_deg * 4  # u32 [B_local, k+1, N]
    ks = batch_local * (params.lwe_dimension + 1) * 4  # u32 [B_local, n+1]
    if mode == "dp":
        return {}
    if mode == "tp":
        return {"all-reduce": {delta, ks}}
    if mode == "coeffs":
        return {"all-reduce": {ks}, "all-gather": {delta}}
    if mode == "ntt":
        from tfhe_jax.ops.ntt import PRIMES, plan_for_params

        plan = plan_for_params(params)
        cln2 = k1 * plan.key_limbs * plan.n2
        planes = len(PRIMES) * 3 * batch_local * cln2 * plan.n1 * 4
        return {"all-reduce": {planes, ks}}
    if mode == "pp":
        assert m_microbatches > 0, "pp mode needs m_microbatches"
        final = m_microbatches * delta  # one psum replicating the out queue
        return {"collective-permute": {delta}, "all-reduce": {final}}
    raise ValueError(mode)


def wire_bytes_per_sample_step(params: TfheParams, mode: str, d: int) -> float:
    """Per-chip wire bytes PER SAMPLE PER ROTATION STEP at model-axis (or
    stage-axis) size ``d`` — the quantity in the ARCHITECTURE wire table.
    Derived from the same payload model the HLO test asserts."""
    per = expected_collectives(params, mode, batch_local=1, m_microbatches=1)
    n_steps = params.lwe_dimension
    if mode == "dp":
        return 0.0
    if mode == "tp":
        payload = max(per["all-reduce"])  # the per-step delta psum
        return 2 * (d - 1) / d * payload
    if mode == "coeffs":
        payload = max(per["all-gather"])
        return (d - 1) / d * payload
    if mode == "ntt":
        payload = max(per["all-reduce"])
        return 2 * (d - 1) / d * payload
    if mode == "pp":
        # one [k+1, N] u32 hop per stage boundary per sample, amortized over
        # the n steps the sample spends in the pipe
        payload = max(per["collective-permute"])
        return payload * (d - 1) / n_steps
    raise ValueError(mode)
