"""The in-place Adam pass over every leaf of the traced steps: the least
time its bytes allow over its device time."""
from perfbench.lib import bounds

KERNELS = ("adam_kernel",)


def read(layer):
    trace = layer.get("trace")
    t = trace.seconds(*KERNELS) if trace is not None else 0.0
    if not t:
        return None
    need = sum(bounds.adam_bytes(s["adam_elements"]) for s in layer["steps"])
    return 100.0 * bounds.bound_s(need) / t
