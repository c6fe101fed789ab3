"""``probe_device_pct.ivf``: the device seconds of the program's spans
``ivf.probe`` (the cells' probe scores, each query's nearest cells and
their union) over those of its ``ivf.search`` spans, in %.  Idle time
inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("ivf.probe",), "ivf.search")
