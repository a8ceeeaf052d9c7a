"""End-to-end MPE pipeline: search → sample → retrain → packed export (§3.4).

Model-agnostic: the model stores its compressor state under
``params["embedding"]`` / ``buffers["embedding"]``, so phase transitions are
key swaps. The pipeline implements the paper's three retraining variants
(Table 4):

  - "none": quantize the searched embeddings at the sampled widths directly;
  - "lth":  Lottery-Ticket reset — *all* params back to their initial values;
  - "mpe":  the paper's scheme — embeddings reset to the search-phase init,
            step sizes α, offsets β and the interaction network W warm-started
            from the search phase.

The model is supplied as a builder: build(seed, compressor, comp_cfg) ->
{"params", "buffers", "state", "loss_fn", "eval_fn"} where loss_fn follows
the Trainer signature.

Every phase runs where ``build`` puts the model. The trainer updates the
tree it is handed in place, so the pipeline takes host snapshots, as the
reference does: of the initial parameters, which "mpe" and "lth" reset to,
and of the search phase's results. The retrain phase starts from device
copies of them; the search trainer and its optimizer state are freed before
it starts, and the retrain trainer's optimizer state before the export
(which holds several tables' worth of temporaries at once).

With ``ckpt_dir`` each phase checkpoints under ``<ckpt_dir>/search`` and
``<ckpt_dir>/retrain`` and restores from there first; ``prefetch`` makes and
stages the batches ahead of the steps (``Trainer.run(prefetch=...)``);
``mesh`` runs both trainers on a mesh of ranks (``Trainer(mesh=...)``),
every rank through the same pipeline to the same packed table.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.inference import build_packed_table, packed_storage_bytes
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.sampling import (MPERetrainEmbedding, average_bits,
                                       feature_bits, sample_group_bits,
                                       storage_ratio)
from repro_torch.train.loop import Trainer
from repro_torch.train.tree import tree_map


def _snapshot(tree):
    """A copy of ``tree`` in host memory that no trainer updates."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _on(tree, device):
    """A copy of ``tree`` on ``device`` (a host snapshot stays untouched)."""
    return tree_map(lambda x: x.to(device, copy=True), tree)


def run_mpe_pipeline(build: Callable, data_fn: Callable, *, seed: int,
                     mpe_cfg: MPEConfig, optimizer, search_steps: int,
                     retrain_steps: int, retrain_mode: str = "mpe",
                     eval_fn: Callable | None = None, log_fn=print,
                     ckpt_dir: str | None = None, prefetch=False,
                     mesh=None) -> dict:
    if retrain_mode not in ("none", "lth", "mpe"):
        raise ValueError(retrain_mode)
    comp_cfg = mpe_cfg._asdict()
    seconds = {}

    # ---------------- phase 1: precision search ----------------
    bundle = build(seed, "mpe_search", comp_cfg)
    device = bundle["params"]["embedding"]["emb"].device
    init_snapshot = _snapshot(bundle["params"])
    trainer = Trainer(bundle["loss_fn"], bundle.pop("params"),
                      bundle["buffers"], bundle["state"], optimizer, mesh=mesh,
                      ckpt_dir=None if ckpt_dir is None else f"{ckpt_dir}/search")
    trainer.restore()
    log_fn(f"[mpe] search phase: {search_steps} steps")
    t0 = time.perf_counter()
    trainer.run(data_fn, search_steps, log_fn=log_fn, prefetch=prefetch)
    seconds["search"] = time.perf_counter() - t0
    # host snapshots: the trainers update their trees in place, so later
    # phases must not alias this one's device tensors
    search_params = _snapshot(trainer.params)
    search_state = _snapshot(trainer.state)
    search_history = trainer.history
    del trainer  # the searched tree and its optimizer state: three tables

    # ---------------- phase 2: precision sampling (Eq. 11) ----------------
    group_bits = sample_group_bits(
        {"gamma": search_params["embedding"]["gamma"].to(device)}, mpe_cfg)
    gof = bundle["buffers"]["embedding"]["group_of_feature"]
    fbits = feature_bits(group_bits, gof)
    avg_b = average_bits(fbits, mpe_cfg)
    ratio = storage_ratio(fbits, mpe_cfg)
    log_fn(f"[mpe] sampled avg bits={avg_b:.3f} ratio={ratio:.4f}")

    # ---------------- phase 3: retraining ----------------
    if retrain_mode == "none":
        base, emb_host, steps = search_params, search_params, 0
    elif retrain_mode == "lth":
        base, emb_host, steps = init_snapshot, init_snapshot, retrain_steps
    else:  # "mpe": warm-start α, β and W (paper §3.4), the table from init
        base, emb_host, steps = search_params, init_snapshot, retrain_steps
    base = _on({k: v for k, v in base.items() if k != "embedding"}
               | {"embedding": {k: v for k, v in base["embedding"].items()
                                if k in ("alpha", "beta")}}, device)
    emb_src = emb_host["embedding"]["emb"].to(device, copy=True)
    searched_alpha = base["embedding"]["alpha"]
    searched_beta = base["embedding"]["beta"]

    emb_params, emb_buffers = MPERetrainEmbedding.init(
        emb_src, searched_alpha, searched_beta, fbits)
    retrain_params = {k: v for k, v in base.items() if k != "embedding"}
    retrain_params["embedding"] = emb_params
    retrain_buffers = {k: v for k, v in bundle["buffers"].items()
                       if k != "embedding"}
    retrain_buffers["embedding"] = emb_buffers

    rb = build(seed, "mpe_retrain", {**comp_cfg, "init_emb": emb_src,
                                     "alpha": searched_alpha,
                                     "beta": searched_beta, "bits_idx": fbits})
    # rebuilt only for the loss_fn closure; our params/state are swapped in
    trainer2 = Trainer(rb["loss_fn"], retrain_params, retrain_buffers,
                       _on(search_state, device), optimizer, mesh=mesh,
                       ckpt_dir=None if ckpt_dir is None else f"{ckpt_dir}/retrain")
    del rb
    t0 = time.perf_counter()
    if steps:
        trainer2.restore()
        log_fn(f"[mpe] retrain phase ({retrain_mode}): {steps} steps")
        trainer2.run(data_fn, steps, log_fn=log_fn, prefetch=prefetch)
    seconds["retrain"] = time.perf_counter() - t0
    final_params, final_state = trainer2.params, trainer2.state
    retrain_history = trainer2.history
    del trainer2  # its optimizer state: two tables the export does not read

    # ---------------- phase 4: packed export ----------------
    t0 = time.perf_counter()
    table, meta = build_packed_table(final_params["embedding"]["emb"], fbits,
                                     final_params["embedding"]["alpha"],
                                     final_params["embedding"]["beta"], mpe_cfg)
    packed_bytes = packed_storage_bytes(table)   # reads sizes only
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["export"] = time.perf_counter() - t0
    result = {
        "search_params": search_params,
        "final_params": final_params,
        "buffers": retrain_buffers,
        "state": final_state,
        "group_bits": group_bits.cpu().numpy(),
        "feature_bits_idx": fbits.cpu().numpy(),
        "avg_bits": avg_b,
        "storage_ratio": ratio,
        "packed_table": table,
        "packed_meta": meta,
        "packed_bytes": packed_bytes,
        "search_history": search_history,
        "retrain_history": retrain_history,
        "seconds": seconds,
    }
    if eval_fn is not None:
        t0 = time.perf_counter()
        result["eval"] = eval_fn(final_params, retrain_buffers, final_state)
        seconds["eval"] = time.perf_counter() - t0
        log_fn(f"[mpe] eval: {result['eval']}")
    return result
