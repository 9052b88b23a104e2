"""The 95th percentile (nearest rank) over every login due in the window of
the time from its due time to its verdict; a login with no verdict counts
as infinitely late (then there is no finite value to report)."""

import math

from benchmark.yardstick.stats import percentile


def read(run):
    lat = run["record"].get("latency_ms")
    if not lat:
        return None
    p95 = percentile(lat, 95)
    return p95 if math.isfinite(p95) else None
