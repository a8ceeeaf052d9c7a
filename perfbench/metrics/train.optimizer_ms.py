"""The device milliseconds a traced step spends after its gradients: the
global-norm clip's scale (``train.clip``) and the NaN guard with the
optimizer's in-place pass (``train.update``), timed by their CUDA event
pairs."""
from perfbench.metrics import _spans


def read(layer):
    return _spans.per_step(layer, {"train.clip", "train.update"})
