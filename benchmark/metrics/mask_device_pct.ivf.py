"""``mask_device_pct.ivf``: the device seconds of the program's spans
``ivf.mask`` (each chunk's distances assembled from the kernel's scores,
the norms and ``q.c``, and the cells a query did not probe masked) over
those of its ``ivf.search`` spans, in %.  Idle time inside a span counts."""

from benchmark import spans


def read(trace, metric):
    return spans.device_pct(trace, ("ivf.mask",), "ivf.search")
