"""Dry run: one rank's step of every (arch × shape) cell on the production
mesh, on meta tensors, with its per-device FLOPs, bytes and collectives.

The port of the reference's ``repro.launch.dryrun``. The reference lowers
and compiles each cell SPMD on 512 forced host devices and analyses the
partitioned HLO. The port's eager SPMD has no partitioner, so the dry run
is **one rank's local step**: the cell's stand-ins (``launch.cells``,
meta tensors that hold no data) mapped to what that rank holds on the
production mesh (16×16, or 2×16×16 with ``--multi-pod``), run under the
dry mesh (``launch.mesh.production_dry_mesh``: the axis sizes and this
rank's coordinates; each collective returns an empty result of its shape
and records its bytes) and walked op by op (``analysis.op_walk``); every
kernel wrapper returns empties of its kernel's shapes on meta tensors and
charges its region the kernel's analytic cost. ``launch.trace_analysis``
turns the walk into the reference's keys. Nothing runs on a device: the
numbers are static counts, not times.

JSON per cell (the reference's keys): ``flops_per_device``,
``hbm_bytes_per_device``, ``collectives_per_device``, and ``memory`` with
``argument_bytes`` and ``output_bytes`` (exact: the rank's inputs and the
step's outputs) and ``temp_bytes``, the peak of the intermediates the walk
saw live — an estimate of the eager allocator, not of the caching
allocator's reserve.

Usage:
    python -m repro_torch.launch.dryrun --arch dlrm-criteo --shape serve_p99
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape decode_32k --overrides kv_int8=true --tag kv8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.op_walk import OpWalk
from repro_torch.configs.base import ALL_ARCHS
from repro_torch.dist.mesh import use_mesh
from repro_torch.launch.cells import build_cell, cell_shapes
from repro_torch.launch.mesh import production_dry_mesh
from repro_torch.launch.trace_analysis import analyze
from repro_torch.train.tree import leaves


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree)
               if torch.is_tensor(x))


def run_cell(arch_id: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True, save_dir: str | None = None,
             overrides: dict | None = None, tag: str = "") -> dict:
    """Walk one rank's step of the cell → the reference's result dict."""
    mesh = production_dry_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cell = build_cell(arch_id, shape, multi_pod, overrides)
    inputs = cell.localize(cell.input_specs) if cell.localize \
        else cell.input_specs
    arg_bytes = _bytes(inputs)
    with use_mesh(mesh), torch.no_grad(), OpWalk() as walk:
        out = cell.step_fn(*inputs)
    counts = analyze(walk)
    n_chips = mesh.size
    result = {
        "cell": cell.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "n_chips": int(n_chips),
        "walk_s": round(time.time() - t0, 1),
        "flops_per_device": counts["flops_per_device"],
        "hbm_bytes_per_device": counts["hbm_bytes_per_device"],
        "collectives_per_device": counts["collectives_per_device"],
        "kernel_flops_per_device": counts["region_flops"],
        "kernel_bytes_per_device": counts["region_bytes"],
        "kernels": sorted({it.name for it in walk.regions()}),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _bytes(out),
            "temp_bytes": walk.peak_bytes,
        },
        "meta": cell.meta,
    }
    if verbose:
        coll = counts["collectives_per_device"]
        print(f"[dryrun] {cell.name} mesh={result['mesh']} "
              f"walk={result['walk_s']}s "
              f"flops/dev={result['flops_per_device']:.3e} "
              f"hbm/dev={result['hbm_bytes_per_device']:.3e} "
              f"coll/dev={coll['total_bytes']:.3e}")
        print("  memory:", result["memory"])
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fname = f"{arch_id}_{shape}_{result['mesh']}".replace("/", "_")
        if tag:
            fname += f"_{tag}"
            result["variant"] = tag
            result["overrides"] = overrides
        with open(os.path.join(save_dir, f"dryrun_{fname}.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def parse_overrides(text: str | None) -> dict | None:
    if not text:
        return None
    out = {}
    for kv in text.split(","):
        k, v = kv.split("=", 1)
        out[k.strip()] = {"true": True, "false": False}.get(
            v.strip().lower(), v.strip())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write one JSON per cell to this directory")
    ap.add_argument("--overrides", default=None,
                    help="comma-separated k=v config overrides, e.g. "
                         "'kv_int8=true,moe.shard_dispatch=true'")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    if args.all:
        cells = [(a, s) for a in ALL_ARCHS() for s in cell_shapes(a)]
    else:
        if args.arch is None:
            ap.error("name --arch (and --shape), or --all")
        shapes = [args.shape] if args.shape else list(cell_shapes(args.arch))
        cells = [(args.arch, s) for s in shapes]

    failures = []
    for arch_id, shape in cells:
        try:
            run_cell(arch_id, shape, multi_pod=args.multi_pod,
                     save_dir=args.out, overrides=overrides, tag=args.tag)
        except Exception as e:  # noqa: BLE001 — report every failing cell
            failures.append((arch_id, shape, repr(e)))
            print(f"[dryrun] FAIL {arch_id}/{shape}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)}/{len(cells)} cells FAILED")
        return 1
    print(f"\nall {len(cells)} cells walked OK "
          f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
