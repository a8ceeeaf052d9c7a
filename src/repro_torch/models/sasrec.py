"""SASRec [arXiv:1808.09781]: causal self-attention over a user's item
sequence, with one item table shared by the input and the output side.

Training is the paper's per-position binary cross-entropy against the next
item and one sampled negative; ``score_candidates`` scores a candidate set
(up to the whole corpus) against each sequence's last hidden state and
keeps the top k. The item table is any registered compressor: ``mpe_search``
while training, ``packed`` when serving. Dropout is omitted, as in the
reference.

batch = {"seq_ids", "pos_ids", "neg_ids": (B, S) int32 item ids,
         "mask": (B, S) valid positions}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.nn import init as initializers
from repro_torch.nn.attention import MHA
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import LayerNorm


class SASRecConfig(NamedTuple):
    item_vocab: int = 1_000_000
    d_embed: int = 50
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    dropout: float = 0.0   # not applied, as in the reference
    compressor: str = "plain"
    comp_cfg: dict | None = None


def _head_dim(d: int, n_heads: int) -> int:
    return max(d // n_heads, 4)


def _block_init(gen, d, n_heads):
    return {
        "ln1": LayerNorm.init(d, gen.device),
        "attn": MHA.init(gen, d, n_heads, head_dim=_head_dim(d, n_heads)),
        "ln2": LayerNorm.init(d, gen.device),
        "ff1": Dense.init(gen, d, d),
        "ff2": Dense.init(gen, d, d),
    }


def _block_apply(p, x, n_heads, d):
    h = LayerNorm.apply(p["ln1"], x)
    a, _ = MHA.apply(p["attn"], h, n_heads=n_heads, n_kv_heads=n_heads,
                     head_dim=_head_dim(d, n_heads), causal=True,
                     rope_theta=None)
    x = x + a
    h = LayerNorm.apply(p["ln2"], x)
    return x + Dense.apply(p["ff2"], torch.relu(Dense.apply(p["ff1"], h)))


class SASRec:
    @staticmethod
    def init(cfg: SASRecConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers, state); the state is empty."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            freqs = np.ones((cfg.item_vocab,), np.float64)
        emb_params, emb_buffers = comp.init(gen, cfg.item_vocab, cfg.d_embed,
                                            freqs, cfg.comp_cfg)
        params = {
            "embedding": emb_params,
            "pos": initializers.normal(gen, (cfg.seq_len, cfg.d_embed),
                                       std=0.02),
            "blocks": [_block_init(gen, cfg.d_embed, cfg.n_heads)
                       for _ in range(cfg.n_blocks)],
            "ln_f": LayerNorm.init(cfg.d_embed, device),
        }
        return params, {"embedding": emb_buffers}, {}

    @staticmethod
    def encode(params, buffers, seq_ids, cfg: SASRecConfig, *,
               train: bool = False, step=None):
        """seq_ids: (B, S) -> hidden states (B, S, d)."""
        comp = get_compressor(cfg.compressor)
        x = comp.lookup(params["embedding"], buffers["embedding"], seq_ids,
                        cfg.comp_cfg, train=train, step=step)
        x = x + params["pos"][None]
        for blk in params["blocks"]:
            x = _block_apply(blk, x, cfg.n_heads, cfg.d_embed)
        return LayerNorm.apply(params["ln_f"], x)

    @staticmethod
    def loss_fn(params, buffers, state, batch, cfg: SASRecConfig, *,
                lam: float = 0.0, train: bool = True, step=None):
        """Masked mean of ``log1p(exp(−pos)) + log1p(exp(neg))`` over the
        positions, as the reference writes it, plus ``lam`` times the
        compressor's regularizer. Returns (loss, (state, ce))."""
        comp = get_compressor(cfg.compressor)
        h = SASRec.encode(params, buffers, batch["seq_ids"], cfg,
                          train=train, step=step)               # (B, S, d)
        pos = comp.lookup(params["embedding"], buffers["embedding"],
                          batch["pos_ids"], cfg.comp_cfg, train=train, step=step)
        neg = comp.lookup(params["embedding"], buffers["embedding"],
                          batch["neg_ids"], cfg.comp_cfg, train=train, step=step)
        pos_logit = torch.sum(h * pos, dim=-1)
        neg_logit = torch.sum(h * neg, dim=-1)
        mask = batch["mask"].to(torch.float32)
        ce = torch.log1p(torch.exp(-pos_logit)) + torch.log1p(torch.exp(neg_logit))
        ce = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
        reg = comp.reg_loss(params["embedding"], buffers["embedding"],
                            cfg.comp_cfg)
        return ce + lam * reg, (state, ce)

    @staticmethod
    def score_candidates(params, buffers, seq_ids, cand_ids, cfg: SASRecConfig,
                         *, top_k: int = 100):
        """seq_ids: (B, S); cand_ids: (C,) -> (scores, indices), each
        (B, top_k), the best candidates of each sequence in falling order."""
        comp = get_compressor(cfg.compressor)
        h = SASRec.encode(params, buffers, seq_ids, cfg, train=False)[:, -1]
        cand = comp.lookup(params["embedding"], buffers["embedding"], cand_ids,
                           cfg.comp_cfg, train=False)            # (C, d)
        scores = h @ cand.T                                      # (B, C)
        return tuple(torch.topk(scores, top_k))
