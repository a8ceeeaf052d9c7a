"""The Eq. 9 mixture's kernels (forward, backward and its reduction) over
the traced steps: the least time their bytes allow over their device
time."""
from perfbench.lib import bounds

KERNELS = ("mpe_qat_fwd_kernel", "mpe_qat_bwd_kernel", "mpe_qat_reduce_kernel")


def read(layer):
    trace = layer.get("trace")
    t = trace.seconds(*KERNELS) if trace is not None else 0.0
    if not t:
        return None
    need = sum(sum(bounds.qat_bytes(*q).values())
               for s in layer["steps"] for q in s["qat"])
    return 100.0 * bounds.bound_s(need) / t
