"""GIN [arXiv:1810.00826]: 5 layers, d = 64, sum aggregator, learnable ε.

Message passing is a scatter-sum over an edge list:

    h'_i = MLP_l((1 + ε_l)·h_i + Σ_{j→i} h_j)

Both halves run on the segment-sum kernel (``kernels/segment_sum``): the
messages are ``gather(h, src)``, whose backward is the kernel, and their sum
is ``scatter_sum(msg, dst, n)``, whose forward is the kernel and whose
backward is a gather. Graph-level readout sum-pools the node states by graph
id the same way. The kernel sums in float64 and rounds once; the reference's
``jax.ops.segment_sum`` sums in float32, so the two agree to a tolerance,
not to the bit.

Three input regimes: dense node features (cora, ogbn-products), categorical
atom types through a compressor table (the molecule cell, MPE's case), and
sampled subgraphs from the neighbour sampler (minibatch_lg, with an edge
mask).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_sum.ops import gather, scatter_sum
from repro_torch.nn import init as initializers
from repro_torch.nn.linear import Dense


class GINConfig(NamedTuple):
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64                    # dense-feature width (ignored if categorical)
    n_classes: int = 2
    input_mode: str = "dense"         # dense | categorical
    atom_vocab: int = 128             # categorical mode
    readout: str = "node"             # node | graph
    compressor: str = "plain"
    comp_cfg: dict | None = None


def _gin_mlp_init(gen, d_in, d_out):
    return {"l1": Dense.init(gen, d_in, d_out,
                             kernel_init=initializers.he_normal),
            "l2": Dense.init(gen, d_out, d_out,
                             kernel_init=initializers.he_normal)}


def _gin_mlp_apply(p, x):
    return Dense.apply(p["l2"], torch.relu(Dense.apply(p["l1"], x)))


class GIN:
    @staticmethod
    def init(cfg: GINConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers); GIN has no state."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        d0 = cfg.d_in if cfg.input_mode == "dense" else cfg.d_hidden
        layers = []
        for i in range(cfg.n_layers):
            d_in = d0 if i == 0 else cfg.d_hidden
            layers.append({
                "eps": torch.zeros((), device=device),   # learnable ε, init 0
                "mlp": _gin_mlp_init(gen, d_in, cfg.d_hidden),
            })
        params = {"layers": layers,
                  "head": Dense.init(gen, cfg.d_hidden, cfg.n_classes)}
        buffers = {}
        if cfg.input_mode == "categorical":
            comp = get_compressor(cfg.compressor)
            if freqs is None:
                freqs = np.ones((cfg.atom_vocab,), np.float64)
            params["embedding"], buffers["embedding"] = comp.init(
                gen, cfg.atom_vocab, cfg.d_hidden, freqs, cfg.comp_cfg)
        return params, buffers

    @staticmethod
    def apply(params, buffers, graph, cfg: GINConfig, *, train: bool = False,
              step=None):
        """graph: {x | atom_ids, edge_src, edge_dst, edge_mask?, graph_ids?,
        n_graphs?} -> (logits, reg_loss)."""
        if cfg.input_mode == "categorical":
            comp = get_compressor(cfg.compressor)
            h = comp.lookup(params["embedding"], buffers["embedding"],
                            graph["atom_ids"], cfg.comp_cfg, train=train,
                            step=step)
            reg = comp.reg_loss(params["embedding"],
                                buffers.get("embedding", {}), cfg.comp_cfg)
        else:
            h = graph["x"]
            reg = torch.zeros(())
        src, dst = graph["edge_src"], graph["edge_dst"]
        n = h.shape[0]
        emask = graph.get("edge_mask")
        for layer in params["layers"]:
            msg = gather(h, src)                                  # (E, d)
            if emask is not None:
                msg = msg * emask[:, None].to(msg.dtype)
            agg = scatter_sum(msg, dst, n)                        # (n, d)
            h = _gin_mlp_apply(layer["mlp"], (1.0 + layer["eps"]) * h + agg)
        if cfg.readout == "graph":
            pooled = scatter_sum(h, graph["graph_ids"], int(graph["n_graphs"]))
            return Dense.apply(params["head"], pooled), reg
        return Dense.apply(params["head"], h), reg

    @staticmethod
    def loss_fn(params, buffers, graph, cfg: GINConfig, *, lam: float = 0.0,
                train: bool = True, step=None):
        """graph also carries {"labels", "label_mask"?} on nodes or graphs.
        Returns (loss, ce)."""
        logits, reg = GIN.apply(params, buffers, graph, cfg, train=train,
                                step=step)
        logp = torch.log_softmax(logits, dim=-1)
        # each row's label entry picked by a comparison with the class
        # index (the same value): its backward is elementwise, where a
        # gather's is a scatter-add
        classes = torch.arange(logp.shape[-1], device=logp.device)
        pick = graph["labels"].long()[:, None] == classes
        ce = -torch.where(pick, logp, torch.zeros((), device=logp.device)
                          ).sum(dim=-1)
        if "label_mask" in graph:
            m = graph["label_mask"].to(torch.float32)
            ce = torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
        else:
            ce = torch.mean(ce)
        return ce + lam * reg, ce
