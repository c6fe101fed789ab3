"""``encode_device_pct.ingest``: the device seconds of the program's spans
``assign.encode`` (the encode kernel and its preparation) over those of its
``pq.quantize_batch`` spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("assign.encode",), "pq.quantize_batch")
