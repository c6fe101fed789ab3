"""``repair_device_pct.search``: the device seconds of the program's spans
``select.repair`` (``search._smallest_long`` after its first top-k: block
minima, gathers, scan, the key top-k, the final sort) over those of its
``search`` spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("select.repair",), "search")
