"""The device milliseconds a traced step spends in the loss's forward (the
span ``train.forward``, timed by its CUDA event pair)."""
from perfbench.metrics import _spans


def read(layer):
    return _spans.per_step(layer, {"train.forward"})
