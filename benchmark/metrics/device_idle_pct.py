"""``device_idle_pct.<cell kind>``: the share of the traced window in which no
kernel, copy or fill ran on the card (the union of their intervals, overlaps
merged), in %.  One reader for every cell kind; the suffix only names the
end-to-end metric the share moves."""


def read(trace, metric):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
