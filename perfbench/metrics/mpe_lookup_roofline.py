"""The packed lookup over the traced dispatches (each cell's and its
lookup-split companion's): the least time the bytes of each dispatch's
padded ids over their distinct rows at their widths allow, over the
kernels' device time."""
from perfbench.lib import bounds

KERNELS = ("mpe_lookup_kernel",)


def read(layer):
    trace = layer.get("trace")
    t = trace.seconds(*KERNELS) if trace is not None else 0.0
    if not t or not layer["dispatches"]:
        return None
    per_dispatch = trace.launches(*KERNELS) / layer["dispatches"]
    return 100.0 * bounds.bound_s(layer["lookup_bytes"] * per_dispatch) / t
