"""The paper's four DLRM backbones: DNN, DCN, DeepFM, IPNN (§5.1.2).

All share: a global embedding table over all feature fields (compressed by a
registered compressor — MPE while training, the packed table when serving),
a 1024-512-256 MLP with BatchNorm (§5.1.5), and a sigmoid CTR head. They
differ only in the interaction branch.

batch = {"ids": (B, F) int32 per-field local ids, "label": (B,)}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import field_offsets, total_vocab
from repro_torch.models.interactions import (CrossNetwork, fm_second_order,
                                             inner_products)
from repro_torch.nn import init as initializers
from repro_torch.nn.mlp import MLP


class DLRMConfig(NamedTuple):
    fields: tuple                      # tuple[FieldSpec]
    d_embed: int = 16                  # paper §5.1.5
    mlp_hidden: tuple = (1024, 512, 256)
    backbone: str = "dnn"              # dnn | dcn | deepfm | ipnn
    n_cross_layers: int = 3
    compressor: str = "plain"
    comp_cfg: dict | None = None
    use_batchnorm: bool = True


class DLRM:
    @staticmethod
    def init(cfg: DLRMConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers, state)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        n = total_vocab(cfg.fields)
        f = len(cfg.fields)
        d_in = f * cfg.d_embed
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            freqs = np.ones((n,), np.float64)
        emb_params, emb_buffers = comp.init(gen, n, cfg.d_embed, freqs,
                                            cfg.comp_cfg)
        mlp_in = d_in + f * (f - 1) // 2 if cfg.backbone == "ipnn" else d_in
        params = {
            "embedding": emb_params,
            "mlp": MLP.init(gen, mlp_in, cfg.mlp_hidden, d_out=1,
                            use_batchnorm=cfg.use_batchnorm),
        }
        if cfg.backbone == "dcn":
            params["cross"] = CrossNetwork.init(gen, d_in, cfg.n_cross_layers)
            params["cross_head"] = initializers.normal(gen, (d_in,), std=0.01)
        if cfg.backbone == "deepfm":
            # first-order per-feature weights (the FM linear term)
            params["fm_linear"] = torch.zeros((n,), dtype=torch.float32,
                                              device=device)
            params["fm_bias"] = torch.zeros((), dtype=torch.float32,
                                            device=device)
        buffers = {
            "embedding": emb_buffers,
            "offsets": torch.from_numpy(field_offsets(cfg.fields)).to(device),
        }
        state = {"mlp": MLP.init_state(cfg.mlp_hidden,
                                       use_batchnorm=cfg.use_batchnorm,
                                       device=device)}
        return params, buffers, state

    @staticmethod
    def interact(params, state, emb, gids, cfg: DLRMConfig, *,
                 train: bool = False):
        """The post-lookup half of ``apply``: interaction branch + MLP head
        over gathered embeddings ``emb (B, F, d)``. ``gids`` are the
        globalized ids (only the DeepFM first-order term reads them).
        Returns (logits (B,), new_state)."""
        b, f, d = emb.shape
        flat = emb.reshape(b, f * d)
        if cfg.backbone == "ipnn":
            mlp_in = torch.cat([flat, inner_products(emb)], dim=-1)
        else:
            mlp_in = flat
        deep, new_mlp_state = MLP.apply(params["mlp"], state["mlp"], mlp_in,
                                        train=train)
        logit = deep[:, 0]
        if cfg.backbone == "dcn":
            cross = CrossNetwork.apply(params["cross"], flat)
            logit = logit + cross @ params["cross_head"]
        elif cfg.backbone == "deepfm":
            first = params["fm_linear"][gids.long()].sum(dim=1)
            logit = logit + first + fm_second_order(emb) + params["fm_bias"]
        return logit, {"mlp": new_mlp_state}

    @staticmethod
    def apply(params, buffers, state, batch, cfg: DLRMConfig, *,
              train: bool = False, step=None):
        """Returns (logits (B,), new_state, reg_loss)."""
        comp = get_compressor(cfg.compressor)
        gids = batch["ids"] + buffers["offsets"][None, :]
        emb = comp.lookup(params["embedding"], buffers["embedding"], gids,
                          cfg.comp_cfg, train=train, step=step)  # (B, F, d)
        logit, new_state = DLRM.interact(params, state, emb, gids, cfg,
                                         train=train)
        reg = comp.reg_loss(params["embedding"], buffers["embedding"],
                            cfg.comp_cfg)
        return logit, new_state, reg

    @staticmethod
    def loss_fn(params, buffers, state, batch, cfg: DLRMConfig, *,
                lam: float = 0.0, train: bool = True, step=None):
        """Mean binary cross-entropy on the logits (the stable form) plus
        ``lam`` times the compressor's regularizer. Returns
        (loss, (new_state, ce))."""
        logits, new_state, reg = DLRM.apply(params, buffers, state, batch, cfg,
                                            train=train, step=step)
        labels = batch["label"].to(torch.float32)
        ce = torch.mean(torch.clamp(logits, min=0) - logits * labels
                        + torch.log1p(torch.exp(-torch.abs(logits))))
        return ce + lam * reg, (new_state, ce)
