"""What the program's sides of the models share: the port's parameter
trees from the benchmark's flat weights and back, the optimizer the
configuration states, and the program's own readings of its first steps.
"""
from __future__ import annotations

import torch

from repro_torch.core.mpe import MPEConfig
from repro_torch.train.optimizer import adam


def nest(flat: dict) -> dict:
    """The port's tree of a flat ``{"a.b.0.c": tensor}`` dict: a numeric
    part is a list index."""
    tree: dict = {}
    for name, value in flat.items():
        parts = name.split(".")
        node = tree
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if part.isdigit() else part
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
                node = node[key]
            else:
                node = node.setdefault(key, child)
        last = parts[-1]
        if isinstance(node, list):
            while len(node) <= int(last):
                node.append(None)
            node[int(last)] = value
        else:
            node[last] = value
    return tree


def named(tree, prefix: str = "") -> dict:
    """The flat ``{"a.b.0.c": tensor}`` dict of a port tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def mpe_config(cfg: dict) -> MPEConfig:
    return MPEConfig(bits=tuple(cfg["bits"]), group_size=cfg["group_size"],
                     tau=cfg["tau"], lam=cfg["lam"])


def optimizer(cfg: dict):
    o = cfg["optimizer"]
    return adam(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"])


ROWS = 1 << 20     # rows of a leaf a norm takes at a time


def norm64(x: torch.Tensor, minus: torch.Tensor | None = None):
    """The float64 norm of a leaf ``x`` (or of ``x - minus``), a block of
    rows at a time, so that no copy of a whole table is made; a 0-d
    tensor."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, x.shape[0], ROWS):
        part = x[lo:lo + ROWS]
        if minus is not None:
            part = part - minus[lo:lo + ROWS]
        total += part.double().square().sum()
    return total.sqrt()


def first_gradient_norms(trainer, b1: float) -> dict:
    """Each leaf's clipped gradient norm of the first step, as the
    optimizer got it: its first moment over (1 - b1), right after that
    step."""
    mu = named(trainer.carry["opt"]["mu"])
    return {k: norm64(v) / (1 - b1) for k, v in mu.items()}


def change_norms(trainer, start: dict) -> dict:
    """Each leaf's norm of change from ``start`` (flat, by name)."""
    now = named(trainer.params)
    return {k: norm64(now[k], start[k]) for k in now}
