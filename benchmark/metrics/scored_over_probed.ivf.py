"""``scored_over_probed.ivf``: over the program's ``ivf.search`` requests in
the window, the (query, slot) pairs scored (counter ``ivf.slots_scored``)
over the pairs of each query's own probed cells (``ivf.slots_probed``).  It
reads 1 where each query scores only its own cells; the ADC-table probe
scores every query against the union of its request's cells.  ``None``
where the program counts nothing."""

from benchmark import spans


def read(trace, metric):
    counts = [getattr(s, "counts", {}) for s in spans.in_window(trace) if s.name == "ivf.search"]
    probed = sum(c.get("ivf.slots_probed", 0) for c in counts)
    if probed <= 0:
        return None
    return sum(c.get("ivf.slots_scored", 0) for c in counts) / probed
