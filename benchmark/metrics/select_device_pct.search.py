"""``select_device_pct.search``: the device seconds of the program's spans
``search.select`` (each chunk's ``search._smallest``, the tie repair
included) and ``search.merge`` (the best-so-far merged with a chunk's) over
those of its ``search`` spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("search.select", "search.merge"), "search")
