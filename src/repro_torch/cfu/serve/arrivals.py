"""Seeded arrival-process generators (times in CFU clock cycles).

Every generator takes a rate in requests/second plus the clock frequency
and returns a sorted float array of arrival times in cycles — the
simulator's native unit — produced by a ``numpy`` Generator seeded by
the caller (same seed => identical arrivals, the determinism contract).

* ``poisson`` — memoryless arrivals: i.i.d. exponential gaps at the
  requested mean rate. The classic open-loop serving assumption.
* ``bursty`` — a two-state on/off modulated Poisson process (an MMPP-2):
  exponentially-distributed ON and OFF dwell times; arrivals only during
  ON, at a rate scaled so the LONG-RUN mean equals ``rate_qps``. This is
  the "camera wakes up and streams" edge pattern — the same mean load as
  ``poisson`` but concentrated, which is exactly what stresses a
  batching policy's tail latency.
* ``trace`` — replay recorded arrival timestamps (JSON: either a plain
  list of seconds, or ``{"arrivals_s": [...]}``), scaled to cycles.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

DEFAULT_FREQ_HZ = 300e6     # the paper's CFU clock (300 MHz)

# Bursty defaults: ~1/5 duty cycle, mean ON dwell of 50 ms.
BURSTY_ON_FRACTION = 0.2
BURSTY_ON_MEAN_S = 0.05


def poisson(rate_qps: float, n: int, freq_hz: float = DEFAULT_FREQ_HZ,
            seed: int = 0) -> np.ndarray:
    """``n`` Poisson arrivals at ``rate_qps`` (times in cycles)."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    gaps_s = rng.exponential(1.0 / rate_qps, size=n)
    return np.cumsum(gaps_s) * freq_hz


def bursty(rate_qps: float, n: int, freq_hz: float = DEFAULT_FREQ_HZ,
           seed: int = 0, on_fraction: float = BURSTY_ON_FRACTION,
           on_mean_s: float = BURSTY_ON_MEAN_S) -> np.ndarray:
    """``n`` on/off-modulated Poisson arrivals with long-run mean
    ``rate_qps``: ON dwells ~ Exp(mean ``on_mean_s``), OFF dwells sized
    so ON time is ``on_fraction`` of the line, and the ON-state rate is
    ``rate_qps / on_fraction`` (so bursts run 1/on_fraction hotter)."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    if not 0 < on_fraction <= 1:
        raise ValueError(f"on_fraction must be in (0, 1], {on_fraction}")
    rng = np.random.default_rng(seed)
    rate_on = rate_qps / on_fraction
    off_mean_s = on_mean_s * (1 - on_fraction) / on_fraction
    out = np.empty(n)
    t = 0.0
    got = 0
    while got < n:
        on_end = t + rng.exponential(on_mean_s)
        while got < n:
            t += rng.exponential(1.0 / rate_on)
            if t > on_end:
                t = on_end
                break
            out[got] = t
            got += 1
        if off_mean_s > 0:
            t += rng.exponential(off_mean_s)
    return out * freq_hz


def trace(path: str, n: Optional[int] = None,
          freq_hz: float = DEFAULT_FREQ_HZ,
          rate_qps: Optional[float] = None) -> np.ndarray:
    """Replay a recorded trace of arrival timestamps (seconds).

    Asking for more arrivals than the trace holds raises — it used to
    silently return the short trace, so a sweep comparing "400 requests
    at each rate" against a 100-request trace quietly compared different
    workloads. ``rate_qps`` rescales the timeline so the trace's mean
    arrival rate equals the requested rate (shape preserved, rate
    swept) — the explicit opt-in replacing the old silent mismatch where
    ``make_arrivals`` accepted ``rate_qps`` for traces and ignored it.
    """
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data["arrivals_s"]
    times = np.sort(np.asarray(data, dtype=float))
    if times.size == 0:
        raise ValueError(f"trace {path!r} holds no arrivals")
    if n is not None:
        if times.size < n:
            raise ValueError(
                f"trace {path!r} holds {times.size} arrivals but {n} were "
                "requested — a truncated replay would silently compare a "
                "different workload; pass n<=len or extend the trace")
        times = times[:n]
    if rate_qps is not None:
        if rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        if times.size < 2 or times[-1] <= times[0]:
            raise ValueError(
                "rate rescaling needs >= 2 distinct timestamps to "
                "measure the trace's own rate")
        measured = (times.size - 1) / (times[-1] - times[0])
        times = times * (measured / rate_qps)
    return times * freq_hz


ARRIVALS = ("poisson", "bursty", "trace")


def make_arrivals(kind: str, rate_qps: float, n: int,
                  freq_hz: float = DEFAULT_FREQ_HZ, seed: int = 0,
                  trace_path: Optional[str] = None,
                  bursty_kwargs: Optional[Dict] = None,
                  rescale_to_rate: bool = False) -> np.ndarray:
    """Dispatch on ``kind`` (one of :data:`ARRIVALS`).

    For traces, ``rate_qps`` only applies when ``rescale_to_rate=True``
    (the timeline is stretched so the trace's mean rate equals it);
    otherwise the trace replays at its recorded rate and ``rate_qps`` is
    deliberately unused rather than silently pretended.
    """
    if kind == "poisson":
        return poisson(rate_qps, n, freq_hz=freq_hz, seed=seed)
    if kind == "bursty":
        return bursty(rate_qps, n, freq_hz=freq_hz, seed=seed,
                      **(bursty_kwargs or {}))
    if kind == "trace":
        if not trace_path:
            raise ValueError("kind='trace' needs trace_path")
        return trace(trace_path, n=n, freq_hz=freq_hz,
                     rate_qps=rate_qps if rescale_to_rate else None)
    raise ValueError(f"unknown arrival kind {kind!r}; want {ARRIVALS}")
