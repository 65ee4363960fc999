"""End-to-end: the nearest-rank 95th percentile of every window request's
issue-to-result time."""

from benchmark.lib.stats import p95


def read(run: dict):
    return 1e3 * p95(run["latencies_s"]) if run["latencies_s"] else None
