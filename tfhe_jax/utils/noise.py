"""Noise budget metering — the domain's fault detector (SURVEY.md section 5).

The failure mode of TFHE is silent: noise overflow past Delta/2 flips decoded
bits.  The reference never measures noise; here the test/ops harness can
decrypt-and-measure the centered error of any ciphertext batch and report the
margin |e|/Delta (must stay well below 0.5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tfhe_jax.models import lwe as mlwe
from tfhe_jax.models.keys import ClientKey
from tfhe_jax.ops.torus import encode as t_encode


@dataclass(frozen=True)
class NoiseReport:
    max_abs_over_delta: float
    mean_abs_over_delta: float
    failures: int  # samples past the Delta/2 decode threshold
    count: int

    def __str__(self):
        return (
            f"noise margin: max |e|/Delta = {self.max_abs_over_delta:.4f}, "
            f"mean = {self.mean_abs_over_delta:.4f}, "
            f"failures = {self.failures}/{self.count}"
        )


def centered_error(ck: ClientKey, cts, messages) -> np.ndarray:
    """Signed error to the NEAREST valid encoding of each message.

    Valid encodings of m repeat every p*Delta = 2^(log_q - padding_bits)
    (negative blind-rotation indices legitimately alias the padding bit via
    the test-vector negate-rotate trick), so the distance is reduced mod
    p*Delta and centered.
    """
    p = ck.params
    period = 1 << (p.log_q - p.padding_bits)
    pt = np.asarray(mlwe.decrypt(ck.lwe_sk, cts), dtype=np.uint32)
    expected = np.asarray(
        t_encode(np.asarray(messages, np.uint32), p.log_q, p.log_p, p.padding_bits)
    )
    diff = (pt.astype(np.int64) - expected.astype(np.int64)) % period
    return np.where(diff >= period // 2, diff - period, diff)


def measure(ck: ClientKey, cts, messages) -> NoiseReport:
    """Noise margin of a ciphertext batch against its known messages."""
    e = centered_error(ck, cts, messages)
    delta = float(ck.params.delta)
    rel = np.abs(e) / delta
    return NoiseReport(
        max_abs_over_delta=float(rel.max()),
        mean_abs_over_delta=float(rel.mean()),
        failures=int((rel >= 0.5).sum()),
        count=int(rel.size),
    )
