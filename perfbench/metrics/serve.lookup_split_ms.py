"""The milliseconds a dispatch spends on the Figure-5 lookup-split
companion (the span ``serve.lookup_split``: the lookup-only cell's call and
its synchronize, which only fill ``LatencyStats``' lookup column), over the
traced stretch's dispatches."""
from perfbench.metrics import _spans


def read(layer):
    kept = _spans.window(layer)
    if kept is None:
        return None
    n = _spans.dispatches(kept)
    if not n:
        return None
    return sum(r.host_ms for r in kept
               if r.name == "serve.lookup_split") / n
