"""What the readers of the program's spans (``repro_torch.spans``) share:
the records of the traced stretch, those that opened and closed inside the
window of the run's ``Trace`` (the same ``perf_counter`` clock), so that a
record of another run in the same process is never read. A program
without spans, or a run without a trace, gives None."""


def window(layer):
    """The records inside the traced window, or None."""
    trace = layer.get("trace")
    if trace is None or not trace.window_s:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    lo = trace._t0 * 1e9
    hi = lo + trace.window_s * 1e9
    return [r for r in spans.records() if r.end_ns is not None
            and lo <= r.start_ns and r.end_ns <= hi]


def dispatches(kept) -> int:
    """The serving round's dispatches: ``serve.replay`` spans right under a
    ``serve.round`` (the lookup-split companion's replay is not one)."""
    return sum(1 for r in kept if r.name == "serve.replay"
               and r.parent is not None and r.parent.name == "serve.round")


def per_step(layer, names) -> float | None:
    """The milliseconds of the spans named in ``names`` (the device's on
    the card) over the traced ``train.step`` spans."""
    kept = window(layer)
    if kept is None:
        return None
    steps = sum(1 for r in kept if r.name == "train.step")
    if not steps:
        return None
    return sum(r.ms for r in kept if r.name in names) / steps
