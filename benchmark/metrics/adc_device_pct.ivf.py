"""``adc_device_pct.ivf``: the device seconds of the program's spans
``ivf.tables`` (a request's query tables) and ``ivf.adc`` (each chunk's
scores over the union of the probed cells: the ADC kernel and its table)
over those of its ``ivf.search`` spans, in %.  Idle time inside a span
counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("ivf.tables", "ivf.adc"), "ivf.search")
