"""Device selection shared by the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when no device is named and no card is present —
    there is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def full_float32(device: torch.device):
    """On the card, keep float32 matrix products and convolutions in full
    float32 (no TF32), so that training and scores follow the float32
    reference."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def on_card(device: torch.device):
    """A context in which ``device`` is the current card: a no-op where it
    already is, which is the cheap case a kernel wrapper on a request's path
    takes (entering ``torch.cuda.device`` costs microseconds)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the address a kernel's C
    interface takes, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)
