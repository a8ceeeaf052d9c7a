"""The share of the traced window in which no operation ran on the card
(``torch.profiler``'s device intervals, merged)."""


def read(layer):
    trace = layer.get("trace")
    if trace is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
