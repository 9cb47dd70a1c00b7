"""90th percentile of the time to first token, prompt ids on the host to
the first token on the host (ms)."""

from bench.stats import percentile


def read(v):
    return percentile(v.rec.latencies_s, 90) * 1e3
