"""``project_device_pct.ingest``: the device seconds of the program's spans
``pq.project`` (the OPQ projection's matrix product) over those of its
``pq.quantize_batch`` spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("pq.project",), "pq.quantize_batch")
