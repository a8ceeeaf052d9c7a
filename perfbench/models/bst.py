"""The program's side of the BST configuration: the port's MPE search
``Trainer`` on ``BST.loss_fn``, built from the benchmark's weights; and the
work each kernel of a search step must do, for the rooflines.
"""
from __future__ import annotations

import torch

from perfbench.lib import bounds
from perfbench.models.common import mpe_config, nest, optimizer
from repro_torch.core.mpe import make_groups
from repro_torch.device import full_float32
from repro_torch.embeddings.table import FieldSpec, field_offsets
from repro_torch.models.bst import BST, BSTConfig, fields
from repro_torch.nn.mlp import MLP
from repro_torch.train.loop import Trainer


def port_config(cfg: dict) -> BSTConfig:
    pcfg = BSTConfig(
        item_vocab=cfg["item_vocab"],
        ctx_fields=tuple(FieldSpec(f"c{i}", v)
                         for i, v in enumerate(cfg["ctx_vocabs"])),
        d_embed=cfg["d_embed"], seq_len=cfg["seq_len"],
        n_blocks=cfg["n_blocks"], n_heads=cfg["n_heads"],
        transformer_ff=cfg["transformer_ff"],
        mlp_hidden=tuple(cfg["mlp_hidden"]), compressor="mpe_search",
        comp_cfg=mpe_config(cfg)._asdict())
    if max(pcfg.d_embed // pcfg.n_heads, 4) != cfg["head_dim"]:
        raise ValueError("the port's BST takes heads of max(d / heads, 4)")
    return pcfg


def trainer(ref, weights: dict, device) -> Trainer:
    cfg = ref.cfg
    full_float32(device)
    pcfg = port_config(cfg)
    gof, freq_sum = make_groups(ref.frequencies().cpu().numpy(),
                                cfg["group_size"], device)
    offsets = torch.from_numpy(field_offsets(fields(pcfg))).to(device)
    buffers = {"embedding": {"group_of_feature": gof, "freq_sum": freq_sum},
               "item_offset": offsets[0], "ctx_offsets": offsets[1:]}
    state = {"mlp": MLP.init_state(pcfg.mlp_hidden, device=device)}
    lam = cfg["lam"]

    def loss_fn(p, bu, st, batch, *, step=None):
        return BST.loss_fn(p, bu, st, batch, pcfg, lam=lam, train=True,
                           step=step)
    return Trainer(loss_fn, nest(weights), buffers, state, optimizer(cfg),
                   clip_norm=cfg["clip_norm"])


def step_work(ref, batch: dict, gof: torch.Tensor, n_elements: int) -> dict:
    """A search step's work: two lookups through the mixture (the items of
    the sequence and the target, the context fields), their four segment
    sums over the rows and groups they touch, the flash forward with its
    statistics and its backward over (batch x heads) sequences, Adam over
    ``n_elements``; the model's operations (projections, attention
    products, feed-forward and MLP, forward and backward)."""
    cfg = ref.cfg
    d, m, s = cfg["d_embed"], len(cfg["bits"]), cfg["seq_len"] + 1
    b = batch["label"].shape[0]
    items = torch.cat([batch["seq_ids"], batch["target_id"][:, None]],
                      dim=1).long().reshape(-1)
    ctx = (batch["ctx_ids"].long() + ref.ctx_offsets).reshape(-1)
    segments = []
    for gids in (items, ctx):
        segments += [(gids.numel(), d, int(torch.unique(gids).numel())),
                     (gids.numel(), m,
                      int(torch.unique(gof[gids]).numel()))]
    width = cfg["n_heads"] * cfg["head_dim"]
    ff = cfg["transformer_ff"]
    token = bounds.dense_flops(1, [d, width]) * 3 + bounds.dense_flops(
        1, [width, d]) + bounds.dense_flops(1, [d, ff, d])
    attn = 2 * 2 * s * s * width          # q k^T and p v, a sequence
    mlp_in = (s + len(cfg["ctx_vocabs"])) * d
    row = s * token + attn + bounds.dense_flops(1, [mlp_in,
                                                    *cfg["mlp_hidden"], 1])
    return {"qat": [(items.numel(), d, m), (ctx.numel(), d, m)],
            "segments": segments, "adam_elements": n_elements,
            "flash": [(b * cfg["n_heads"], s, cfg["head_dim"])],
            "flops": 3 * b * row}
