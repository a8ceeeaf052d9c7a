#!/usr/bin/env python3
"""Pair the MoE layer of two checkouts inside one process on one CUDA card,
on deepseek-moe-16b's serving path, so that a change to ``nn/moe.py`` is
timed against its parent on the same card in the same call.

    python3 scripts/moe_serve_ab.py --parent-src DIR [--rounds N] [--steps N] [--json OUT]

The model is ``chip_smoke.py``'s: deepseek-moe-16b at full width, its first
2 of 28 layers, the packed token table, weights from its seed. The other
checkout's ``DIR/repro_torch/nn/moe.py`` is loaded beside this one's and
its ``MoE.apply`` swapped in for a side's turn. Each round, the first side
alternating from round to round, each side takes one ``LM.prefill`` of a
4,096-token prompt into an int8 cache (host clock to a synchronize), then
``--steps`` greedy steps of ``Engine.decode`` on a freshly captured
``lm_decode_cell`` (host clock to the logits on the host). Both sides'
logits must be equal. Prints one JSON object: every time, each side's
medians, and how many rounds each side won.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.nn.moe import MoE  # noqa: E402
from repro_torch.serve.cells import lm_decode_cell  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

PROMPT = 4096


def load_parent_apply(src: Path):
    spec = importlib.util.spec_from_file_location(
        "parent_moe", src / "repro_torch" / "nn" / "moe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MoE.apply


def one_side(model, toks, steps: int) -> dict:
    """One prefill and ``steps`` graphed decode steps: times and logits."""
    cfg, params, buffers = model
    max_len = PROMPT + steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = LM.prefill(params, buffers, toks, cfg, max_len,
                                torch.int8)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    engine = Engine(device=toks.device)
    engine.register(lm_decode_cell(cfg, params, buffers, batch=1,
                                   max_len=max_len, arch=cs.MOE_ARCH))
    tok = logits.float().argmax(-1)[:, None].cpu().numpy().astype(np.int32)
    step_ms, seen = [], [logits.float().cpu()]
    for _ in range(steps):
        t0 = time.perf_counter()
        out, caches = engine.decode(tok, caches)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seen.append(torch.from_numpy(out))
        tok = out.argmax(-1)[:, None].astype(np.int32)
    del engine, caches
    return {"prefill_s": prefill_s, "step_ms": step_ms, "logits": seen}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.phase_build()
    model = cs.lm_model(cs.MOE_ARCH, dev, n_layers=cs.MOE_LAYERS)
    toks = torch.from_numpy(TokenStream(model[0].vocab, 1, PROMPT,
                                        seed=cs.SEED).batch_at(1)["tokens"]
                            ).to(dev)
    applies = {"parent": load_parent_apply(args.parent_src),
               "change": MoE.apply}
    one_side(model, toks, 2)                # builds and warms both sides
    runs = {side: [] for side in applies}
    for r in range(args.rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for side in order:
            MoE.apply = staticmethod(applies[side])
            runs[side].append(one_side(model, toks, args.steps))
        MoE.apply = staticmethod(applies["change"])
        a, b = runs["parent"][-1]["logits"], runs["change"][-1]["logits"]
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            print(f"round {r}: the two sides' logits differ", file=sys.stderr)
            return 1
    out = {"card": cs.phase_device(), "rounds": args.rounds,
           "steps": args.steps, "prompt": PROMPT}
    for side, rows in runs.items():
        out[side] = {
            "prefill_s": [row["prefill_s"] for row in rows],
            "decode_p50_ms": [float(np.median(row["step_ms"])) for row in rows],
        }
        out[side]["median_prefill_s"] = float(np.median(out[side]["prefill_s"]))
        out[side]["median_decode_p50_ms"] = float(
            np.median(out[side]["decode_p50_ms"]))
    for key in ("prefill_s", "decode_p50_ms"):
        out[f"change_won_{key}"] = sum(
            c < p for c, p in zip(out["change"][key], out["parent"][key]))
    text = json.dumps(out)
    if args.json:
        args.json.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
