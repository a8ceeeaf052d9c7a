"""BST, the Behavior Sequence Transformer [arXiv:1905.06874]: embed_dim=32,
seq_len=20, n_blocks=1, n_heads=8, MLP 1024-512-256.

The user's behaviour sequence plus the target item pass through a
transformer block (learned positions, post-LN as in the paper); the
flattened outputs are concatenated with the context fields' embeddings and
fed to the MLP CTR head. One global table covers the items and the context
fields, so one compressor holds everything: ``mpe_search`` while training,
``packed`` when serving. Attention is non-causal and runs through the flash
kernels; a head is ``max(d // n_heads, 4)`` wide, as in the reference, so
the attention can be wider than ``d``.

batch = {"seq_ids": (B, S) int32 item ids, "target_id": (B,),
         "ctx_ids": (B, F_ctx) per-field local ids, "label": (B,)}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import FieldSpec, field_offsets, total_vocab
from repro_torch.nn import init as initializers
from repro_torch.nn.attention import MHA
from repro_torch.nn.linear import Dense
from repro_torch.nn.mlp import MLP
from repro_torch.nn.norms import LayerNorm


class BSTConfig(NamedTuple):
    item_vocab: int
    ctx_fields: tuple = ()
    d_embed: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    transformer_ff: int = 128
    mlp_hidden: tuple = (1024, 512, 256)
    compressor: str = "plain"
    comp_cfg: dict | None = None
    use_batchnorm: bool = True


def _head_dim(d: int, n_heads: int) -> int:
    return max(d // n_heads, 4)


def _block_init(gen, d, n_heads, d_ff):
    return {
        "attn": MHA.init(gen, d, n_heads, head_dim=_head_dim(d, n_heads)),
        "ln1": LayerNorm.init(d, gen.device),
        "ff1": Dense.init(gen, d, d_ff),
        "ff2": Dense.init(gen, d_ff, d),
        "ln2": LayerNorm.init(d, gen.device),
    }


def _block_apply(p, x, n_heads, d):
    a, _ = MHA.apply(p["attn"], x, n_heads=n_heads, n_kv_heads=n_heads,
                     head_dim=_head_dim(d, n_heads), causal=False,
                     rope_theta=None)
    x = LayerNorm.apply(p["ln1"], x + a)                 # post-LN (BST paper)
    h = Dense.apply(p["ff2"], torch.relu(Dense.apply(p["ff1"], x)))
    return LayerNorm.apply(p["ln2"], x + h)


def fields(cfg: BSTConfig) -> tuple:
    """The table's fields: the items, then the context fields."""
    return (FieldSpec("item", cfg.item_vocab), *cfg.ctx_fields)


class BST:
    @staticmethod
    def init(cfg: BSTConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers, state)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        n = total_vocab(fields(cfg))
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            freqs = np.ones((n,), np.float64)
        emb_params, emb_buffers = comp.init(gen, n, cfg.d_embed, freqs,
                                            cfg.comp_cfg)
        f_ctx = len(cfg.ctx_fields)
        mlp_in = (cfg.seq_len + 1) * cfg.d_embed + f_ctx * cfg.d_embed
        params = {
            "embedding": emb_params,
            "pos": initializers.normal(gen, (cfg.seq_len + 1, cfg.d_embed),
                                       std=0.02),
            "blocks": [_block_init(gen, cfg.d_embed, cfg.n_heads,
                                   cfg.transformer_ff)
                       for _ in range(cfg.n_blocks)],
            "mlp": MLP.init(gen, mlp_in, cfg.mlp_hidden, d_out=1,
                            use_batchnorm=cfg.use_batchnorm),
        }
        offsets = torch.from_numpy(field_offsets(fields(cfg))).to(device)
        buffers = {"embedding": emb_buffers, "item_offset": offsets[0],
                   "ctx_offsets": offsets[1:]}
        state = {"mlp": MLP.init_state(cfg.mlp_hidden,
                                       use_batchnorm=cfg.use_batchnorm,
                                       device=device)}
        return params, buffers, state

    @staticmethod
    def apply(params, buffers, state, batch, cfg: BSTConfig, *,
              train: bool = False, step=None):
        """Returns (logits (B,), new_state, reg_loss): two lookups, one for
        the sequence plus the target and one for the context fields."""
        comp = get_compressor(cfg.compressor)
        seq = torch.cat([batch["seq_ids"], batch["target_id"][:, None]], dim=1)
        gids = seq + buffers["item_offset"]
        x = comp.lookup(params["embedding"], buffers["embedding"], gids,
                        cfg.comp_cfg, train=train, step=step)  # (B, S+1, d)
        x = x + params["pos"][None]
        for blk in params["blocks"]:
            x = _block_apply(blk, x, cfg.n_heads, cfg.d_embed)
        feats = [x.reshape(x.shape[0], -1)]
        if len(cfg.ctx_fields):
            cgids = batch["ctx_ids"] + buffers["ctx_offsets"][None, :]
            ctx = comp.lookup(params["embedding"], buffers["embedding"], cgids,
                              cfg.comp_cfg, train=train, step=step)
            feats.append(ctx.reshape(ctx.shape[0], -1))
        deep, new_mlp = MLP.apply(params["mlp"], state["mlp"],
                                  torch.cat(feats, dim=-1), train=train)
        reg = comp.reg_loss(params["embedding"], buffers["embedding"],
                            cfg.comp_cfg)
        return deep[:, 0], {"mlp": new_mlp}, reg

    @staticmethod
    def loss_fn(params, buffers, state, batch, cfg: BSTConfig, *,
                lam: float = 0.0, train: bool = True, step=None):
        """Mean binary cross-entropy on the logits (the stable form) plus
        ``lam`` times the compressor's regularizer. Returns
        (loss, (new_state, ce))."""
        logits, new_state, reg = BST.apply(params, buffers, state, batch, cfg,
                                           train=train, step=step)
        y = batch["label"].to(torch.float32)
        ce = torch.mean(torch.clamp(logits, min=0) - logits * y
                        + torch.log1p(torch.exp(-torch.abs(logits))))
        return ce + lam * reg, (new_state, ce)
