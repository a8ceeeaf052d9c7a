"""Builder factories binding models and compressors for the MPE pipeline,
the training launcher and the tests.

A builder is ``build(seed, compressor, comp_cfg) -> bundle`` with
bundle = {"params", "buffers", "state", "loss_fn", "eval_fn", "cfg"};
loss_fn follows the Trainer signature (params, buffers, state, batch, *,
step). The model is made on the device given to the builder factory (the
card unless the caller names another).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.wide_deep import WideDeep, WideDeepConfig
from repro_torch.train.metrics import auc, logloss


def _ctr_eval(apply_fn, eval_batches, device):
    def eval_fn(params, buffers, state):
        scores, labels = [], []
        with torch.no_grad():
            for b in eval_batches:
                batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                         for k, v in b.items()}
                logits, _, _ = apply_fn(params, buffers, state, batch)
                scores.append(torch.sigmoid(logits).cpu().numpy())
                labels.append(np.asarray(b["label"]))
        s = torch.from_numpy(np.concatenate(scores))
        lab = torch.from_numpy(np.concatenate(labels))
        return {"auc": float(auc(lab, s)),
                "logloss": float(logloss(lab.to(torch.float32), s))}
    return eval_fn


def _builder(model, base, freqs, lam, eval_batches, device):
    device = resolve_device(device)

    def build(seed: int, compressor: str, comp_cfg):
        cfg = base._replace(compressor=compressor, comp_cfg=comp_cfg)
        params, buffers, state = model.init(cfg, freqs, seed=seed,
                                            device=device)

        def loss_fn(p, bu, st, batch, *, step=None):
            return model.loss_fn(p, bu, st, batch, cfg, lam=lam, train=True,
                                 step=step)

        def apply_eval(p, bu, st, batch):
            return model.apply(p, bu, st, batch, cfg, train=False)

        return {"params": params, "buffers": buffers, "state": state,
                "loss_fn": loss_fn, "cfg": cfg,
                "eval_fn": (None if eval_batches is None
                            else _ctr_eval(apply_eval, eval_batches, device))}
    return build


def dlrm_builder(base: DLRMConfig, freqs, *, lam: float = 0.0,
                 eval_batches=None, device=None):
    """Returns build(seed, compressor, comp_cfg)."""
    return _builder(DLRM, base, freqs, lam, eval_batches, device)


def wide_deep_builder(base: WideDeepConfig, freqs, *, lam: float = 0.0,
                      eval_batches=None, device=None):
    """Returns build(seed, compressor, comp_cfg)."""
    return _builder(WideDeep, base, freqs, lam, eval_batches, device)
