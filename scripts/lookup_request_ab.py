#!/usr/bin/env python3
"""Pair the packed lookup of two checkouts inside one process on one CUDA
card, on DLRM's serving path, so that the host's drift between processes
(which moves a sub-millisecond request by more than the lookup's share of
it) falls on both sides alike.

    python3 scripts/lookup_request_ab.py --parent-src DIR [--first parent|change]
        [--rounds N] [--json OUT]

The full-width ``dlrm-criteo`` table is built once by this checkout
(``chip_smoke.py``'s seed). The other checkout's lookup wrapper and its CUDA
source (``DIR/repro_torch/kernels/mpe_lookup/ops.py`` and its
``csrc/mpe_lookup.cu``, built into ``DIR``'s own ``build/``) are loaded
beside this one's, and each side gets its own engine, whose cells capture
that side's wrapper in their CUDA graphs (a replay calls no wrapper); the
side named by ``--first`` builds its engine first, so that runs with each
order tell a side's difference from the build order's. Each
round serves, once through each side's engine in turn (the first side
alternating from round to round), 15 requests of 1, 300 and 512 rows and
one of 300,000 rows through ``Engine.score``, host clock to a synchronize,
and times the wrapper alone at ``serve_p99``'s 19,968 ids (CUDA events over
200 back-to-back calls, bound by the host). Both sides' scores
must be equal, and each side's launches are counted. Prints one JSON object:
the build order, every time, each side's medians and interquartile ranges,
and how many rounds each side won.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import compressors, inference  # noqa: E402
from repro_torch.kernels.mpe_lookup import ops as change_ops  # noqa: E402


def load_other(src: Path):
    """The other checkout's lookup wrapper, importing that checkout's build
    module, so that it builds and loads that checkout's CUDA source."""
    def load(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        # registered before it runs: a dataclass looks its module up there
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module
    build = load("other_kernels_build",
                 src / "repro_torch" / "kernels" / "build.py")
    saved = sys.modules["repro_torch.kernels.build"]
    sys.modules["repro_torch.kernels.build"] = build
    try:
        return load("other_mpe_lookup_ops",
                    src / "repro_torch" / "kernels" / "mpe_lookup" / "ops.py")
    finally:
        sys.modules["repro_torch.kernels.build"] = saved


def use(wrapper):
    """Route the serving path's lookups (the model's and the engine's
    lookup-only half) through ``wrapper``."""
    compressors.packed_lookup = wrapper
    inference.packed_lookup = wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True)
    ap.add_argument("--first", choices=("parent", "change"),
                    default="parent", help="the side whose engine is built "
                    "first")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--json", help="write the result here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sides = {"parent": load_other(args.parent_src.resolve()).packed_lookup,
             "change": change_ops.packed_lookup}

    cfg = cs.get_arch("dlrm-criteo").make_config(backbone="dnn")
    params, buffers, state, spec = cs.build_packed_dlrm(cfg, seed=cs.SEED,
                                                        device=dev)
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    small = [cs.SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
             for step, rows in enumerate(cs.REQUEST_ROWS * 5, start=10_000)]
    bulk = cs.SyntheticCTR(spec._replace(batch_size=cs.BULK_ROWS)).batch(
        10_015)["ids"]
    p99_ids = cs.request_gids(spec, buffers, cs.SERVE_ROWS["serve_p99"], 5_000,
                              dev).reshape(-1).contiguous()

    scores, engines = {}, {}
    build_order = sorted(sides, key=lambda name: name != args.first)
    for name in build_order:             # capture both, and hold them equal
        wrapper = sides[name]
        use(wrapper)
        before = wrapper.launches        # the captures' warm-up calls
        engines[name] = cs.build_engine(cfg, params, state, buffers,
                                        device=dev)
        cs.check(wrapper.launches > before, f"{name}: no lookup launched")
        scores[name] = [engines[name].score(ids, return_logits=True)
                        for ids in small[:3] + [bulk]]
    for a, b in zip(scores["parent"], scores["change"]):
        cs.check(np.array_equal(a, b), "the two sides' scores differ")

    times = {name: {"small_ms": [], "bulk_ms": [], "p99_call_ms": []}
             for name in sides}
    wins = {name: 0 for name in sides}
    for r in range(args.rounds):
        order = list(sides) if r % 2 == 0 else list(sides)[::-1]
        medians = {}
        for name in order:
            engine = engines[name]
            row = times[name]
            ms = [cs.time_requests(lambda x=ids: engine.score(x), 1)[0]
                  for ids in small]
            row["small_ms"] += ms
            row["bulk_ms"] += cs.time_requests(lambda: engine.score(bulk), 1)
            row["p99_call_ms"].append(cs.cuda_ms(
                lambda w=sides[name]: w(table, meta, p99_ids), 200))
            medians[name] = float(np.median(ms))
        wins[min(medians, key=medians.get)] += 1
        cs.log(f"round {r}: small-request medians {medians}")
    use(change_ops.packed_lookup)
    result = {"card": smi, "build_order": build_order, "rounds": args.rounds,
              "wins_small": wins,
              "median": {name: {k: float(np.median(v)) for k, v in row.items()}
                         for name, row in times.items()},
              "iqr": {name: {k: [float(q) for q in np.percentile(v, [25, 75])]
                             for k, v in row.items()}
                      for name, row in times.items()},
              "times": times}
    text = json.dumps(result)
    if args.json:
        Path(args.json).write_text(text + "\n")
    print(json.dumps({k: result[k] for k in (
        "card", "build_order", "rounds", "wins_small", "median", "iqr")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
