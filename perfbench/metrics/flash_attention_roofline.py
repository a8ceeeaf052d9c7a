"""The port's flash attention in training (the forward with its
statistics and the backward, staged route) over the traced steps: the
least time their bytes and float32 operations allow (heads 4 wide run
outside the tensor cores) over their device time."""
from perfbench.lib import bounds

KERNELS = ("(anonymous namespace)::flash_fwd_", "(anonymous namespace)::flash_bwd_")


def read(layer):
    trace = layer.get("trace")
    t = trace.seconds(*KERNELS) if trace is not None else 0.0
    if not t:
        return None
    need = 0.0
    for s in layer["steps"]:
        for bh, seq, hd in s["flash"]:
            for kind in ("fwd_stats", "bwd"):
                w = bounds.flash_work(bh, seq, hd, kind)
                need += bounds.bound_s(w["bytes"], w["flops"])
    return 100.0 * need / t
