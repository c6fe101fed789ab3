"""``adc_device_pct.search``: the device seconds of the program's spans
``search.tables`` (a request's query tables) and ``search.adc`` (each
chunk's scores: the ADC kernel and its table) over those of its ``search``
spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("search.tables", "search.adc"), "search")
