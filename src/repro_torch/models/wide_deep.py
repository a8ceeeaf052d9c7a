"""Wide & Deep [arXiv:1606.07792] — the reference's config: 40 sparse
fields, d=32, MLP 1024-512-256, interaction = concat.

Wide part: per-feature scalar weights (a d=1 embedding) over the raw sparse
ids, gathered through ``gather`` on an (n, 1) view, so its gradient is a
width-1 segment sum. Deep part: the field embeddings concatenated into the
MLP. The d=32 table is compressed by the pluggable compressor (MPE's home
regime): ``mpe_search`` while training, the ``packed`` table when serving.

batch = {"ids": (B, F) int32 per-field local ids, "label": (B,)}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import field_offsets, total_vocab
from repro_torch.kernels.segment_sum.ops import gather
from repro_torch.nn.mlp import MLP


class WideDeepConfig(NamedTuple):
    fields: tuple
    d_embed: int = 32
    mlp_hidden: tuple = (1024, 512, 256)
    compressor: str = "plain"
    comp_cfg: dict | None = None
    use_batchnorm: bool = True


class WideDeep:
    @staticmethod
    def init(cfg: WideDeepConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers, state)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        n = total_vocab(cfg.fields)
        f = len(cfg.fields)
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            freqs = np.ones((n,), np.float64)
        emb_params, emb_buffers = comp.init(gen, n, cfg.d_embed, freqs,
                                            cfg.comp_cfg)
        params = {
            "embedding": emb_params,
            "wide": torch.zeros((n,), dtype=torch.float32, device=device),
            "wide_bias": torch.zeros((), dtype=torch.float32, device=device),
            "mlp": MLP.init(gen, f * cfg.d_embed, cfg.mlp_hidden, d_out=1,
                            use_batchnorm=cfg.use_batchnorm),
        }
        buffers = {"embedding": emb_buffers,
                   "offsets": torch.from_numpy(field_offsets(cfg.fields)).to(device)}
        state = {"mlp": MLP.init_state(cfg.mlp_hidden,
                                       use_batchnorm=cfg.use_batchnorm,
                                       device=device)}
        return params, buffers, state

    @staticmethod
    def apply(params, buffers, state, batch, cfg: WideDeepConfig, *,
              train: bool = False, step=None):
        """Returns (logits (B,), new_state, reg_loss)."""
        comp = get_compressor(cfg.compressor)
        gids = batch["ids"] + buffers["offsets"][None, :]
        emb = comp.lookup(params["embedding"], buffers["embedding"], gids,
                          cfg.comp_cfg, train=train, step=step)       # (B, F, d)
        b, f, d = emb.shape
        deep, new_mlp = MLP.apply(params["mlp"], state["mlp"],
                                  emb.reshape(b, f * d), train=train)
        wide = gather(params["wide"][:, None], gids.reshape(-1).long())
        logit = deep[:, 0] + wide.reshape(b, f).sum(dim=1) + params["wide_bias"]
        reg = comp.reg_loss(params["embedding"], buffers["embedding"],
                            cfg.comp_cfg)
        return logit, {"mlp": new_mlp}, reg

    @staticmethod
    def loss_fn(params, buffers, state, batch, cfg: WideDeepConfig, *,
                lam: float = 0.0, train: bool = True, step=None):
        """Mean binary cross-entropy on the logits (the stable form) plus
        ``lam`` times the compressor's regularizer. Returns
        (loss, (new_state, ce))."""
        logits, new_state, reg = WideDeep.apply(params, buffers, state, batch,
                                                cfg, train=train, step=step)
        y = batch["label"].to(torch.float32)
        ce = torch.mean(torch.clamp(logits, min=0) - logits * y
                        + torch.log1p(torch.exp(-torch.abs(logits))))
        return ce + lam * reg, (new_state, ce)
