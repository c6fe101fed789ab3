"""``launches_per_request.search``: device kernels in the traced window over
the requests it completed (copies and fills not counted)."""


def read(trace, metric):
    if not trace.kernels or not trace.steps:
        return None
    return len(trace.kernels) / trace.steps
