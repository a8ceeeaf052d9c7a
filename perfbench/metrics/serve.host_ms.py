"""The host's milliseconds a dispatch spends in the serving round's front
end outside batch assembly (which ``serve.assembly_ms`` reads) and outside
the cell's call: the spans ``serve.take``, ``serve.pack``,
``serve.readback`` and ``serve.scatter``, over the traced stretch's
dispatches."""
from perfbench.metrics import _spans

PHASES = {"serve.take", "serve.pack", "serve.readback", "serve.scatter"}


def read(layer):
    kept = _spans.window(layer)
    if kept is None:
        return None
    n = _spans.dispatches(kept)
    if not n:
        return None
    return sum(r.host_ms for r in kept if r.name in PHASES) / n
