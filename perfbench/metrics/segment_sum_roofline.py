"""The gathers' backward (the segment sums and the sort of their ids) over
the traced steps: the least time their bytes allow (touched rows written)
over their device time."""
from perfbench.lib import bounds

KERNELS = ("segment_chunk_kernel", "segment_combine_kernel", "RadixSort",
           "radix_sort")


def read(layer):
    trace = layer.get("trace")
    t = trace.seconds(*KERNELS) if trace is not None else 0.0
    if not t:
        return None
    need = sum(bounds.segment_bytes(*g)
               for s in layer["steps"] for g in s["segments"])
    return 100.0 * bounds.bound_s(need) / t
