#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernel of the serve path from the source in this
   checkout; print the ptxas report.
3. kernel vs plain: hold the ``mpe_lookup`` kernel against its plain PyTorch
   version on the card over b ∈ 1..8 × d ∈ {8, 16, 50, 64} (rtol 1e-6).
4. main path: the full-width ``dlrm-criteo`` config (dnn, 39 fields,
   34,223,104 features, d=16, MLP 1024-512-256, widths {0..6}) initialised
   from a seed on the card, sampled and exported to the packed table there,
   served by ``build_engine`` with the 512-row ``serve_p99`` and
   262,144-row ``serve_bulk`` cells. The kernel is held against its plain
   version on the full-width table at both cell shapes; then, with the
   launch counts set to 0, requests of 1, 300 and 512 rows and one bulk
   request of 300,000 rows are scored, each of which must launch the
   kernel. The scores must equal the same model run with the plain lookup
   (rtol 1e-4, atol 1e-4).
5. kernels: time each kernel and its plain version at both cell shapes with
   CUDA events, beside the least time the card needs to move the bytes that
   this run's ids need.
6. trace: a separate run under ``torch.profiler`` gives the kernel's device
   time per launch, and for a 300-row and the bulk request the device's
   busy time against the wall time, with the costliest device kernels.

The line before the last holds the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import SERVE_ROWS, get_arch  # noqa: E402
from repro_torch.core.compressors import Packed  # noqa: E402
from repro_torch.core.inference import build_packed_table  # noqa: E402
from repro_torch.core.mpe import MPEConfig  # noqa: E402
from repro_torch.core.packing import words_per_row  # noqa: E402
from repro_torch.data.synthetic import SyntheticCTR  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.mpe_lookup import ops as mpe_lookup_ops  # noqa: E402
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref  # noqa: E402
from repro_torch.launch.serve import (build_engine,  # noqa: E402
                                      build_packed_dlrm)
from repro_torch.models.dlrm import DLRM  # noqa: E402
from repro_torch.serve.stats import LatencyStats  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
LOOKUP_RTOL = 1e-6              # the reference's kernel contract
SCORE_TOL = 1e-4                # the reference's serve contract
REQUEST_ROWS = [1, 300, 512]
BULK_ROWS = 300_000
SEED = 0


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trace(fn, reps: int) -> dict:
    """``fn`` run ``reps`` times under the profiler: per-run wall time, the
    device's busy time (the union of kernel and copy intervals) and device
    time by kernel name, all in ms per run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy_us, by_name, reach = 0.0, {}, float("-inf")
    for start, end, name in spans:
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / reps,
            "idle_share": 1.0 - busy_us / 1e3 / reps / wall_ms,
            "top": [(name[:60], ms) for name, ms in top],
            "by_name": by_name}


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
            what: str) -> float:
    diff = (got - want).abs()
    n_diff = int((got != want).sum())
    max_abs = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.abs()).all())
    log(f"{what}: {n_diff} of {got.numel()} elements differ, "
        f"max |diff| {max_abs:.3e}")
    check(ok, f"{what}: outside rtol={rtol} atol={atol}")
    return max_abs


def lookup_bytes(table, meta, gids: torch.Tensor) -> dict:
    """Bytes the lookup must move for these ids: per id, the id read and its
    float32 row written; per distinct row, its ``width_idx`` entry and, where
    its width is not 0, its ``local_idx`` entry and packed words, each read
    once; α and β read once."""
    d, m = meta["d"], len(meta["bits"])
    wpr = torch.tensor([words_per_row(d, b) if b else 0 for b in meta["bits"]],
                       device=gids.device)
    rows = torch.unique(gids.long())
    row_words = wpr[table["width_idx"][rows].long()]
    kept = int((row_words > 0).sum())
    nbytes = (gids.numel() * (4 + 4 * d) + rows.numel() * 4 + kept * 4
              + 4 * int(row_words.sum()) + 4 * (m + d))
    return {"ids": gids.numel(), "rows": rows.numel(), "kept_rows": kept,
            "bytes": nbytes}


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    out = build("mpe_lookup")
    log(f"built mpe_lookup in {time.perf_counter() - t0:.1f} s"
        + ("" if out else " (cached library)"))
    for line in out.splitlines():
        if "ptxas" in line or "error" in line.lower():
            log(f"mpe_lookup: {line.strip()}")


def phase_kernel_grid(dev) -> float:
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for b in range(1, 9):
        for d in (8, 16, 50, 64):
            n = 1000
            cfg = MPEConfig(bits=(0, b))
            emb = torch.from_numpy(rng.normal(0, 3e-3, (n, d)).astype(np.float32))
            widx = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
            beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32))
            alpha = torch.tensor([1.0, 1e-3], dtype=torch.float32)
            table, meta = build_packed_table(emb.to(dev), widx.to(dev),
                                             alpha.to(dev), beta.to(dev), cfg)
            ids = torch.from_numpy(rng.integers(0, n, 4096).astype(np.int32)).to(dev)
            got = mpe_lookup_ops.packed_lookup(table, meta, ids)
            torch.cuda.synchronize()
            want = packed_lookup_ref(table, meta, ids)
            worst = max(worst, compare(got, want, LOOKUP_RTOL, 0.0,
                                       f"grid b={b} d={d}"))
    return worst


def request_gids(spec, buffers, rows: int, step: int, dev) -> torch.Tensor:
    ids = SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
    return torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]


def phase_main_path(dev):
    cfg = get_arch("dlrm-criteo").make_config(backbone="dnn")
    n = cfg.comp_cfg["n"]
    log(f"dlrm-criteo: {len(cfg.fields)} fields, {n} features, "
        f"d={cfg.d_embed}, MLP {cfg.mlp_hidden}, widths {cfg.comp_cfg['bits']}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    ratio = Packed.storage_ratio(table, buffers["embedding"], cfg.comp_cfg)
    sub_rows = {k: tuple(v.shape) for k, v in table["subtables"].items()}
    log(f"init + sample + export on the card: {time.perf_counter() - t0:.1f} s; "
        f"storage ratio {ratio:.6f}; subtables {sub_rows}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    engine = build_engine(cfg, params, state, buffers, device=dev)

    # the kernel against its plain version on the full-width table
    cell_gids = {shape: request_gids(spec, buffers, rows, 5_000, dev)
                 for shape, rows in SERVE_ROWS.items()}
    worst = 0.0
    for shape, gids in cell_gids.items():
        got = mpe_lookup_ops.packed_lookup(table, meta, gids)
        torch.cuda.synchronize()
        want = packed_lookup_ref(table, meta, gids.reshape(-1)).reshape(got.shape)
        worst = max(worst, compare(got, want, LOOKUP_RTOL, 0.0,
                                   f"full-width table, {shape} "
                                   f"({gids.numel()} ids)"))
        del got, want

    # warm both cells once, then drive the main path with the counts at 0
    engine.score(SyntheticCTR(spec._replace(batch_size=8)).batch(1)["ids"])
    engine.score(SyntheticCTR(spec._replace(batch_size=600)).batch(2)["ids"])
    engine.stats = LatencyStats()
    requests = [SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
                for step, rows in enumerate(REQUEST_ROWS * 5 + [BULK_ROWS],
                                            start=10_000)]
    torch.cuda.reset_peak_memory_stats()
    mpe_lookup_ops.packed_lookup.launches = 0
    outputs, request_ms = [], []
    for ids in requests:
        before = mpe_lookup_ops.packed_lookup.launches
        t0 = time.perf_counter()
        outputs.append(engine.score(ids, return_logits=True))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(mpe_lookup_ops.packed_lookup.launches > before,
              f"a {ids.shape[0]}-row request launched no mpe_lookup kernel")
    launches = {"mpe_lookup": mpe_lookup_ops.packed_lookup.launches}
    serve_peak = torch.cuda.max_memory_allocated()
    log(f"main path: {len(requests)} requests, kernel launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    # what came out: finite logits of the right shape, equal to the same
    # model run with the plain lookup on the card
    with torch.inference_mode():
        for ids, got in zip(requests, outputs):
            check(got.shape == (ids.shape[0],) and np.isfinite(got).all(),
                  f"bad scores for a {ids.shape[0]}-row request")
            x = torch.from_numpy(ids).to(dev)
            gids = x + buffers["offsets"][None, :]
            emb = packed_lookup_ref(table, meta, gids.reshape(-1)).reshape(
                *gids.shape, meta["d"])
            want = DLRM.interact(params, state, emb, gids, cfg).cpu()
            compare(torch.from_numpy(got), want, SCORE_TOL, SCORE_TOL,
                    f"scores of a {ids.shape[0]}-row request vs plain lookup")
    summary = engine.stats.summary()
    log("per-cell latency:\n" + engine.stats.format_table())
    p99_req = [ms for ids, ms in zip(requests, request_ms)
               if ids.shape[0] <= SERVE_ROWS["serve_p99"]]
    log(f"request p50 (<=512 rows) {np.percentile(p99_req, 50):.3f} ms; "
        f"bulk request ({BULK_ROWS} rows) {request_ms[-1]:.3f} ms; "
        f"serving peak memory {serve_peak / 1e9:.3f} GB")
    return {"table": table, "meta": meta, "cell_gids": cell_gids,
            "launches": launches, "max_abs_err": worst, "ratio": ratio,
            "cells": summary, "request_p50_ms": float(np.percentile(p99_req, 50)),
            "bulk_request_ms": request_ms[-1], "serve_peak_bytes": serve_peak,
            "engine": engine, "requests": {"300 rows": requests[1],
                                           f"{BULK_ROWS} rows": requests[-1]}}


def phase_kernel_times(main, grid_err: float) -> dict:
    table, meta = main["table"], main["meta"]
    shapes = {}
    for shape, gids in main["cell_gids"].items():
        flat = gids.reshape(-1).contiguous()
        iters = 200 if flat.numel() < 100_000 else 20
        ms = cuda_ms(lambda ids=flat: mpe_lookup_ops.packed_lookup(
            table, meta, ids), iters)
        plain_ms = cuda_ms(lambda ids=flat: packed_lookup_ref(table, meta, ids),
                           max(iters // 4, 3), warmup=1)
        traced = trace(lambda ids=flat: mpe_lookup_ops.packed_lookup(
            table, meta, ids), 10)
        device_ms = sum(v for k, v in traced["by_name"].items()
                        if "mpe_lookup_kernel" in k)
        moved = lookup_bytes(table, meta, flat)
        shapes[shape] = {**moved, "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms,
                         "bound_ms": moved["bytes"] / HBM_BYTES_PER_S * 1e3}
        log(f"mpe_lookup at {shape}: {ms:.4f} ms per call, {device_ms:.4f} ms "
            f"on the device (plain {plain_ms:.4f} ms, bound "
            f"{shapes[shape]['bound_ms']:.4f} ms for {moved['bytes']} bytes: "
            f"{moved['ids']} ids, {moved['rows']} distinct rows, "
            f"{moved['kept_rows']} of them not width 0)")
    bulk = shapes["serve_bulk"]
    return {"name": "mpe_lookup", "route": "cuda",
            "source": "src/repro_torch/csrc/mpe_lookup.cu",
            "replaces": "src/repro/kernels/mpe_lookup/kernel.py:63",
            "launches": main["launches"]["mpe_lookup"],
            "max_abs_err": max(grid_err, main["max_abs_err"]),
            "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
            "bound_ms": bulk["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shapes": shapes}


def phase_trace(main) -> dict:
    """Where a request's time goes: wall time against device busy time."""
    out = {}
    for what, ids in main["requests"].items():
        reps = 20 if len(ids) <= 512 else 1
        t = trace(lambda x=ids: main["engine"].score(x), reps)
        out[what] = {k: t[k] for k in ("wall_ms", "busy_ms", "idle_share", "top")}
        log(f"traced {what} request: wall {t['wall_ms']:.3f} ms, device busy "
            f"{t['busy_ms']:.3f} ms (idle share {t['idle_share']:.3f}); top "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in t["top"]))
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    grid_err = phase_kernel_grid(dev)
    main_path = phase_main_path(dev)
    kernel = phase_kernel_times(main_path, grid_err)
    traced = phase_trace(main_path)
    log(json.dumps({"storage_ratio": main_path["ratio"],
                    "request_p50_ms": main_path["request_p50_ms"],
                    "bulk_request_ms": main_path["bulk_request_ms"],
                    "serve_peak_bytes": main_path["serve_peak_bytes"],
                    "cells": main_path["cells"], "traced": traced}))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
