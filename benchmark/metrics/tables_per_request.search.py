"""``tables_per_request.search``: the program's ``adc.table`` spans (a
table built for the ADC kernel) in its ``search`` requests, over the number
of those requests.  One a request would do; the streamed search builds one
a chunk."""

from benchmark import spans


def read(trace, metric):
    found = spans.in_window(trace)
    requests = [s.request for s in found if s.name == "search"]
    if not requests:
        return None
    ids = set(requests)
    return sum(1 for s in found if s.name == "adc.table" and s.request in ids) / len(requests)
