"""The program's side of the DLRM configurations: the port's MPE search
``Trainer`` and its packed-table serving ``Engine``, built from the
benchmark's weights; and the work each kernel of a search step must do, for
the rooflines.
"""
from __future__ import annotations

import torch

from perfbench.lib import bounds
from perfbench.models.common import mpe_config, nest, optimizer
from repro_torch.core.inference import build_packed_table
from repro_torch.core.mpe import make_groups
from repro_torch.device import full_float32
from repro_torch.embeddings.table import FieldSpec, field_offsets
from repro_torch.launch.serve import build_engine
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.nn.mlp import MLP
from repro_torch.train.loop import Trainer


def port_config(cfg: dict, compressor: str) -> DLRMConfig:
    fields = tuple(FieldSpec(f"f{i}", v)
                   for i, v in enumerate(cfg["field_vocabs"]))
    comp_cfg = (mpe_config(cfg)._asdict() if compressor == "mpe_search" else
                {"bits": tuple(cfg["bits"]), "d": cfg["d_embed"],
                 "n": sum(cfg["field_vocabs"])})
    return DLRMConfig(fields=fields, d_embed=cfg["d_embed"],
                      mlp_hidden=tuple(cfg["mlp_hidden"]),
                      backbone=cfg["backbone"], compressor=compressor,
                      comp_cfg=comp_cfg)


def trainer(ref, weights: dict, device) -> Trainer:
    """The search's ``Trainer`` over ``weights`` (which it trains in place):
    the groups from the benchmark's frequency prior by the program's own
    grouping, the loss the port's ``DLRM.loss_fn`` under ``mpe_search``."""
    cfg = ref.cfg
    full_float32(device)
    pcfg = port_config(cfg, "mpe_search")
    gof, freq_sum = make_groups(ref.frequencies().cpu().numpy(),
                                cfg["group_size"], device)
    buffers = {"embedding": {"group_of_feature": gof, "freq_sum": freq_sum},
               "offsets": torch.from_numpy(field_offsets(pcfg.fields))
               .to(device)}
    state = {"mlp": MLP.init_state(pcfg.mlp_hidden, device=device)}
    lam = cfg["lam"]

    def loss_fn(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, pcfg, lam=lam, train=True,
                            step=step)
    return Trainer(loss_fn, nest(weights), buffers, state, optimizer(cfg),
                   clip_norm=cfg["clip_norm"])


def engine(ref, served: tuple, params: dict, device):
    """The serving engine as ``launch/serve.py`` builds it, over the table
    the program packs from the benchmark's master weights and widths."""
    cfg = ref.cfg
    w, state, widx = served
    full_float32(device)
    table, meta = build_packed_table(w["embedding.emb"], widx,
                                     w["embedding.alpha"],
                                     w["embedding.beta"], mpe_config(cfg))
    tree = nest({k: v for k, v in w.items() if not k.startswith("embedding.")})
    tree["embedding"] = table
    pcfg = port_config(cfg, "packed")
    buffers = {"offsets": torch.from_numpy(field_offsets(pcfg.fields))
               .to(device), "embedding": {"meta": meta}}
    return build_engine(pcfg, tree, nest(state), buffers, device=device,
                        p99_rows=params["buckets"]["serve_p99"],
                        bulk_rows=params["buckets"]["serve_bulk"],
                        queue_capacity=params["queue_capacity"],
                        coalesce_window_ms=params["coalesce_window_ms"])


def score_flops(cfg: dict, rows: int) -> int:
    """Forward operations of scoring ``rows`` rows: the MLP's products."""
    d_in = len(cfg["field_vocabs"]) * cfg["d_embed"]
    return bounds.dense_flops(rows, [d_in, *cfg["mlp_hidden"], 1])


def step_work(ref, batch: dict, gof: torch.Tensor, n_elements: int) -> dict:
    """What a search step on ``batch`` asks of each kernel: the mixture
    over every looked-up row; the segment sums of the rows' and the
    group probabilities' gradients over the rows and groups it touches;
    Adam over ``n_elements`` parameters; the model's operations (the MLP,
    forward and backward)."""
    cfg = ref.cfg
    d, m = cfg["d_embed"], len(cfg["bits"])
    gids = (batch["ids"].long() + ref.offsets).reshape(-1)
    t = gids.numel()
    rows = int(torch.unique(gids).numel())
    groups = int(torch.unique(gof[gids]).numel())
    return {"qat": [(t, d, m)],
            "segments": [(t, d, rows), (t, m, groups)],
            "adam_elements": n_elements, "flash": [],
            "flops": 3 * score_flops(cfg, batch["ids"].shape[0])}
