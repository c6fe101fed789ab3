"""``select_device_pct.ivf``: the device seconds of the program's spans
``ivf.select`` (each chunk's ``search._smallest`` and its merge with the
best-so-far) over those of its ``ivf.search`` spans, in %.  Idle time
inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("ivf.select",), "ivf.search")
