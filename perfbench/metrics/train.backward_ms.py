"""The device milliseconds a traced step spends in the backward (the span
``train.backward``: ``torch.autograd.grad``, timed by its CUDA event
pair)."""
from perfbench.metrics import _spans


def read(layer):
    return _spans.per_step(layer, {"train.backward"})
