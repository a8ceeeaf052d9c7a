"""The model's operations in the traced stretch (the driver's
``model_flops``: a search step's dense and attention products, forward
and backward, or the scored rows' forward products, from shapes) over the
traced wall time, as a share of the card's float32 peak (the
configurations run TF32 off)."""
from perfbench.lib import bounds


def read(layer):
    trace = layer.get("trace")
    if trace is None or not trace.window_s or not layer.get("model_flops"):
        return None
    return (100.0 * layer["model_flops"] / trace.window_s
            / bounds.F32_FLOPS_PER_S)
