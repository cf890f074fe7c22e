"""Integer quantile tables for random-delay distributions: the port's own
copy of the table builders of ``librabft_simulator_tpu/utils/quantile.py``
(numpy only; the tests hold both copies equal).

The reference simulator samples network delays from a LogNormal on the host
(bft-lib/src/simulator.rs:98-107).  Here distributions are compiled on the
host in float64 into a 1024-entry integer inverse-CDF table; on the device a
sample is ``table[u >> 22]``, one gather, bit-identical on every backend.
Pareto (long-tail) and uniform tables use the same machinery.
"""

from __future__ import annotations

import math

import numpy as np

TABLE_BITS = 10
TABLE_SIZE = 1 << TABLE_BITS  # 1024


def _quantile_points():
    # Midpoint rule keeps both tails finite.
    return (np.arange(TABLE_SIZE, dtype=np.float64) + 0.5) / TABLE_SIZE


def lognormal_table(mean: float, variance: float) -> np.ndarray:
    """Integer delays from LogNormal parameterized like RandomDelay::new
    (bft-lib/src/simulator.rs:99-107): given the mean and
    variance of the *delay* itself."""
    mu = math.log(mean / math.sqrt(1.0 + variance / (mean * mean)))
    sigma = math.sqrt(math.log(1.0 + variance / (mean * mean)))
    q = _quantile_points()
    # Inverse CDF of lognormal = exp(mu + sigma * probit(q))
    from statistics import NormalDist

    probit = np.array([NormalDist().inv_cdf(p) for p in q])
    vals = np.exp(mu + sigma * probit)
    return np.maximum(vals.astype(np.int64), 0).astype(np.int32)


def pareto_table(scale: float, alpha: float, cap: float = 1e6) -> np.ndarray:
    """Long-tail delays: Pareto(scale, alpha), capped (BASELINE config #3)."""
    q = _quantile_points()
    vals = scale / np.power(1.0 - q, 1.0 / alpha)
    vals = np.minimum(vals, cap)
    return np.maximum(vals.astype(np.int64), 0).astype(np.int32)


def uniform_table(low: float, high: float) -> np.ndarray:
    q = _quantile_points()
    vals = low + q * (high - low)
    return np.maximum(vals.astype(np.int64), 0).astype(np.int32)


def constant_table(value: int) -> np.ndarray:
    return np.full(TABLE_SIZE, int(value), dtype=np.int32)


def sample_from_table_np(table: np.ndarray, u32: int) -> int:
    """Host/oracle-side sampling; the JAX side is table[u >> 22] inline."""
    return int(table[(int(u32) & 0xFFFFFFFF) >> (32 - TABLE_BITS)])


def make_table(kind: str, **kw) -> np.ndarray:
    if kind == "lognormal":
        return lognormal_table(kw.get("mean", 10.0), kw.get("variance", 4.0))
    if kind == "pareto":
        return pareto_table(kw.get("scale", 5.0), kw.get("alpha", 1.5), kw.get("cap", 1e6))
    if kind == "uniform":
        return uniform_table(kw.get("low", 5.0), kw.get("high", 15.0))
    if kind == "constant":
        return constant_table(kw.get("value", 10))
    raise ValueError(f"unknown delay distribution: {kind}")
