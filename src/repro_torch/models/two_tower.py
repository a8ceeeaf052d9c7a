"""Two-tower retrieval [Yi et al., RecSys'19]: a tower MLP 1024-512-256
whose last width is the dot space.

One global id-embedding table spans the user and the item fields (so MPE's
global frequency grouping applies across both); each tower concatenates its
fields' embeddings and maps them through its MLP (with BatchNorm) to an
L2-normalised vector. Training uses the in-batch sampled softmax with logQ
correction; ``retrieval_score`` scores one query against a candidate corpus
with one matrix-vector product.

The in-batch softmax is one autograd function over blocks of
``LOSS_BLOCK_ROWS`` rows (``in_batch_softmax``): at the full training batch
of 65,536 rows the (B, B) logits would be 17.2 GB in float32, and their
softmax and its gradient as much again each. The forward keeps only each
row's logsumexp and diagonal term; the backward recomputes each block's
softmax and accumulates the towers' gradients.

batch = {"user_ids": (B, Fu) per-field local ids, "item_ids": (B, Fi),
         "item_logq": (B,) log sampling probability of each item}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import field_offsets, total_vocab
from repro_torch.nn.mlp import MLP

# rows of the (B, B) logits one block of the in-batch softmax holds: 8,192
# rows against 65,536 items are 2.1 GB in float32
LOSS_BLOCK_ROWS = 8192


class TwoTowerConfig(NamedTuple):
    user_fields: tuple
    item_fields: tuple
    d_embed: int = 64                   # id-table dim (tower input granularity)
    tower_hidden: tuple = (1024, 512, 256)  # last = dot-space dim 256
    compressor: str = "plain"
    comp_cfg: dict | None = None
    temperature: float = 0.05
    use_batchnorm: bool = True


def _block_logits(u_blk, v, logq, temperature):
    """One block of rows of ``u @ v.T / t − logq`` (logQ along columns)."""
    z = torch.matmul(u_blk, v.T).div_(temperature)
    return z if logq is None else z.sub_(logq[None, :])


class _InBatchSoftmax(torch.autograd.Function):
    """mean_i(logsumexp_j z_ij − z_ii) over z = u @ v.T / t − logq[None],
    one block of rows at a time. ``logq`` is batch data: it takes no
    gradient."""

    @staticmethod
    def forward(ctx, u, v, logq, temperature):
        b = u.shape[0]
        lse = torch.empty((b,), dtype=u.dtype, device=u.device)
        diag = torch.empty_like(lse)
        for r0 in range(0, b, LOSS_BLOCK_ROWS):
            r1 = min(r0 + LOSS_BLOCK_ROWS, b)
            z = _block_logits(u[r0:r1], v, logq, temperature)
            rows = torch.arange(r1 - r0, device=u.device)
            lse[r0:r1] = torch.logsumexp(z, dim=1)
            diag[r0:r1] = z[rows, rows + r0]
            del z
        ctx.save_for_backward(u, v, logq, lse)
        ctx.temperature = temperature
        return (lse - diag).mean()

    @staticmethod
    def backward(ctx, g):
        u, v, logq, lse = ctx.saved_tensors
        t = ctx.temperature
        b = u.shape[0]
        du = torch.empty_like(u)
        dv = torch.zeros_like(v)
        scale = g / b                       # d mean / d ce_i
        for r0 in range(0, b, LOSS_BLOCK_ROWS):
            r1 = min(r0 + LOSS_BLOCK_ROWS, b)
            # dz = (softmax(z) − onehot) · g / B, written over z
            p = _block_logits(u[r0:r1], v, logq, t)
            p.sub_(lse[r0:r1, None]).exp_()
            rows = torch.arange(r1 - r0, device=u.device)
            p[rows, rows + r0] -= 1.0
            p.mul_(scale).div_(t)
            du[r0:r1] = p @ v
            dv.addmm_(p.T, u[r0:r1])
            del p
        return du, dv, None, None


def in_batch_softmax(u, v, logq, temperature: float) -> torch.Tensor:
    """The in-batch sampled softmax cross-entropy with logQ correction:
    mean_i −log_softmax(u @ v.T / t − logq[None, :])[i, i], by blocks of
    ``LOSS_BLOCK_ROWS`` rows; ``logq`` may be None."""
    return _InBatchSoftmax.apply(u, v, logq, temperature)


class TwoTower:
    @staticmethod
    def init(cfg: TwoTowerConfig, freqs=None, *, seed: int = 0, device=None):
        """Random weights from a generator seeded with ``seed``, made on
        ``device`` (the CUDA card unless the caller names another).
        Returns (params, buffers, state)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        fields = (*cfg.user_fields, *cfg.item_fields)
        n = total_vocab(fields)
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            freqs = np.ones((n,), np.float64)
        emb_params, emb_buffers = comp.init(gen, n, cfg.d_embed, freqs,
                                            cfg.comp_cfg)
        fu, fi = len(cfg.user_fields), len(cfg.item_fields)
        params = {
            "embedding": emb_params,
            "user_mlp": MLP.init(gen, fu * cfg.d_embed, cfg.tower_hidden,
                                 use_batchnorm=cfg.use_batchnorm),
            "item_mlp": MLP.init(gen, fi * cfg.d_embed, cfg.tower_hidden,
                                 use_batchnorm=cfg.use_batchnorm),
        }
        offsets = torch.from_numpy(field_offsets(fields)).to(device)
        buffers = {"embedding": emb_buffers, "user_offsets": offsets[:fu],
                   "item_offsets": offsets[fu:]}
        state = {name: MLP.init_state(cfg.tower_hidden,
                                      use_batchnorm=cfg.use_batchnorm,
                                      device=device)
                 for name in ("user_mlp", "item_mlp")}
        return params, buffers, state

    @staticmethod
    def _tower(which, params, buffers, state, ids, cfg, *, train, step):
        comp = get_compressor(cfg.compressor)
        gids = ids + buffers[f"{which}_offsets"][None, :]
        emb = comp.lookup(params["embedding"], buffers["embedding"], gids,
                          cfg.comp_cfg, train=train, step=step)
        out, new_state = MLP.apply(params[f"{which}_mlp"],
                                   state[f"{which}_mlp"],
                                   emb.reshape(emb.shape[0], -1), train=train)
        # L2-normalised dot space (standard for sampled-softmax retrieval)
        norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))
        return out / torch.clamp(norm, min=1e-6), new_state

    @staticmethod
    def user_tower(params, buffers, state, user_ids, cfg, *, train=False,
                   step=None):
        return TwoTower._tower("user", params, buffers, state, user_ids, cfg,
                               train=train, step=step)

    @staticmethod
    def item_tower(params, buffers, state, item_ids, cfg, *, train=False,
                   step=None):
        return TwoTower._tower("item", params, buffers, state, item_ids, cfg,
                               train=train, step=step)

    @staticmethod
    def loss_fn(params, buffers, state, batch, cfg: TwoTowerConfig, *,
                lam: float = 0.0, train: bool = True, step=None):
        """In-batch sampled softmax with logQ correction plus ``lam`` times
        the compressor's regularizer. Returns
        (loss, ({"user_mlp", "item_mlp"} new state, ce))."""
        u, su = TwoTower.user_tower(params, buffers, state, batch["user_ids"],
                                    cfg, train=train, step=step)
        v, si = TwoTower.item_tower(params, buffers, state, batch["item_ids"],
                                    cfg, train=train, step=step)
        ce = in_batch_softmax(u, v, batch.get("item_logq"), cfg.temperature)
        comp = get_compressor(cfg.compressor)
        reg = comp.reg_loss(params["embedding"], buffers["embedding"],
                            cfg.comp_cfg)
        return ce + lam * reg, ({"user_mlp": su, "item_mlp": si}, ce)

    @staticmethod
    def retrieval_score(params, buffers, state, user_ids, cand_item_ids, cfg,
                        *, top_k: int = 100, step=None):
        """user_ids (1, Fu); cand_item_ids (C, Fi) -> the top-k (scores,
        indices)."""
        u, _ = TwoTower.user_tower(params, buffers, state, user_ids, cfg)
        v, _ = TwoTower.item_tower(params, buffers, state, cand_item_ids, cfg)
        scores = (v @ u[0]) / cfg.temperature                 # (C,)
        return tuple(torch.topk(scores, top_k))
