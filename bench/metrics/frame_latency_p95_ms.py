"""95th percentile of the requests' times, host frames to int8 logits on
the host (ms)."""

from bench.stats import percentile


def read(v):
    return percentile(v.rec.latencies_s, 95) * 1e3
