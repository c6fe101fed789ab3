"""``request_p50_ms.search``: the median of the traced requests' seconds,
from the call to the answers on the host (the benchmark's own span), in ms."""

import statistics


def read(trace, metric):
    if not trace.latencies_s:
        return None
    return statistics.median(trace.latencies_s) * 1e3
