#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit. Float32
   matrix products and convolutions run in full float32 (TF32 off), as the
   reference trains and serves.
2. build: compile the CUDA kernels (``mpe_lookup``, ``mpe_qat``) from the
   sources in this checkout, one nvcc each, started together; print the
   ptxas reports.
3. kernel vs plain: hold the ``mpe_lookup`` kernel against its plain PyTorch
   version on the card over b ∈ 1..8 × d ∈ {8, 16, 50, 64} (rtol 1e-6), and
   the ``mpe_qat`` forward and backward against theirs over rows {1, 255,
   257, 4099} × d {8, 16, 50, 64} × widths (0..6) and (0, b), b ∈ 1..8 ×
   softmax and one-hot probabilities: ``out`` and ``drows`` bit-identical,
   ``dprobs``, ``dα``, ``dβ`` at rtol 1e-4 / atol 1e-6 (summed in another
   order); the backward run twice gives the same bits.
4. serve path: the full-width ``dlrm-criteo`` config (dnn, 39 fields,
   34,223,104 features, d=16, MLP 1024-512-256, widths {0..6}) initialised
   from a seed on the card, sampled and exported to the packed table there,
   served by ``build_engine`` with the 512-row ``serve_p99`` and
   262,144-row ``serve_bulk`` cells. The kernel is held against its plain
   version on the full-width table at both cell shapes; then, with the
   launch counts set to 0, requests of 1, 300 and 512 rows and one bulk
   request of 300,000 rows are scored, each of which must launch the
   kernel. The scores must equal the same model run with the plain lookup
   (rtol 1e-4, atol 1e-4).
5. kernels: time the lookup and its plain version at both cell shapes with
   CUDA events, beside the least time the card needs to move the bytes that
   this run's ids need.
6. trace: a separate run under ``torch.profiler`` gives the kernel's device
   time per launch, and for a 300-row and the bulk request the device's
   busy time against the wall time, with the costliest device kernels.
7. train path: ``repro_torch.launch.train`` at full width and the
   ``train_batch`` cell's 65,536 rows — 8 search steps, Eq. 11 sampling,
   8 retrain steps, the packed export, eval on ``eval_set(4)`` — with the
   launch counts set to 0; then the exported table is served by
   ``build_engine`` for a few requests. Every step must launch the
   ``mpe_qat`` forward and backward, every loss be finite and no step be
   skipped, every request launch ``mpe_lookup``, and the served scores equal
   the plain lookup's (rtol 1e-4, atol 1e-4).
8. one step's own inputs: a search step's gathered rows and probabilities
   (and a retrain step's one-hot ones) at the full shape, the kernels
   against the plain version and against autograd through the
   ``lsq_quantize`` composition (``out`` at rtol 1e-5 / atol 1e-7, ``drows``
   likewise against autograd's own order, reductions at rtol 1e-4 /
   atol 1e-6), and the backward twice.
9. ``mpe_qat`` times at ``train_batch`` with CUDA events, beside their plain
   versions and the byte bound; one traced search step (its batch made on
   the host included) for the device's idle share and costliest kernels.

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
from repro_torch.core import quantizer  # noqa: E402
from repro_torch.core.compressors import Packed  # noqa: E402
from repro_torch.core.inference import build_packed_table  # noqa: E402
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding  # noqa: E402
from repro_torch.core.packing import words_per_row  # noqa: E402
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.mpe_lookup import ops as mpe_lookup_ops  # noqa: E402
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref  # noqa: E402
from repro_torch.kernels.mpe_qat import ops as qat_ops  # noqa: E402
from repro_torch.kernels.mpe_qat.ref import (  # noqa: E402
    mixed_expectation_bwd_ref, mixed_expectation_fwd_ref)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import (build_engine,  # noqa: E402
                                      build_packed_dlrm)
from repro_torch.models.dlrm import DLRM  # noqa: E402
from repro_torch.serve.stats import LatencyStats  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.optimizer import adam  # noqa: E402
from repro_torch.zoo import dlrm_builder  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
LOOKUP_RTOL = 1e-6              # the reference's kernel contract
SCORE_TOL = 1e-4                # the reference's serve contract
FWD_TOL = dict(rtol=1e-5, atol=1e-7)   # the reference's Eq. 9 kernel contract
RED_TOL = dict(rtol=1e-4, atol=1e-6)   # its backward contract (sums)
REQUEST_ROWS = [1, 300, 512]
BULK_ROWS = 300_000
SEED = 0
TRAIN_BATCH = 65_536            # the reference's train_batch cell
SEARCH_STEPS = RETRAIN_STEPS = 8
LAM = 3e-5                      # the training launcher's default λ
QAT_SOURCE = "src/repro_torch/csrc/mpe_qat.cu"


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matrix products and convolutions: float32 throughout, "
        "as the reference")
    return smi.splitlines()[0]


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    names = ("mpe_lookup", "mpe_qat")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        outs = {name: f.result() for name, f in futures.items()}
    log(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    for name, out in outs.items():
        if not out:
            log(f"{name}: cached library")
        for line in out.splitlines():
            if "ptxas" in line or "error" in line.lower():
                log(f"{name}: {line.strip()}")


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
            want = DLRM.interact(params, state, emb, gids, cfg)[0].cpu()
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


def qat_inputs(gen, t, d, bits, dev, onehot=False):
    """Seeded inputs of the Eq. 9 mixture: rows (t, d), probs (t, m), α, β
    and an output cotangent g (t, d)."""
    m = len(bits)
    rows = 3e-3 * torch.randn((t, d), generator=gen, device=dev)
    if onehot:
        probs = torch.nn.functional.one_hot(
            torch.randint(0, m, (t,), generator=gen, device=dev), m).float()
    else:
        probs = torch.softmax(torch.randn((t, m), generator=gen, device=dev), -1)
    alpha = torch.tensor([quantizer.init_alpha(3e-3, b) for b in bits],
                         device=dev) * (0.7 + 0.6 * torch.rand(
                             m, generator=gen, device=dev))
    beta = 1e-4 * torch.randn((d,), generator=gen, device=dev)
    g = torch.randn((t, d), generator=gen, device=dev)
    return rows, probs, alpha, beta, g


def max_abs(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_qat(rows, probs, alpha, beta, g, bits, what) -> tuple:
    """The ``mpe_qat`` kernels against their plain versions on the same
    inputs: ``out`` and ``drows`` bit-identical (the same IEEE division,
    rounding and fused multiply-adds), the sums at ``RED_TOL``; the backward
    run twice must give the same bits. Returns the largest |difference| of
    the forward and of the backward."""
    out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
    grads = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    again = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    torch.cuda.synchronize()
    want_out = mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits)
    want = mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits)
    check(torch.equal(out, want_out), f"{what}: forward differs from the "
          f"plain version by {max_abs(out, want_out):.3e}")
    check(torch.equal(grads[0], want[0]), f"{what}: drows differs from the "
          f"plain version by {max_abs(grads[0], want[0]):.3e}")
    for name, x, w in zip(("dprobs", "dalpha", "dbeta"), grads[1:], want[1:]):
        check(bool(torch.isclose(x, w, **RED_TOL).all()),
              f"{what}: {name} outside rtol=1e-4 atol=1e-6 of the plain "
              f"version (max |diff| {max_abs(x, w):.3e})")
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{what}: two backward runs gave different bits")
    return (max_abs(out, want_out),
            max(max_abs(x, w) for x, w in zip(grads, want)))


def phase_qat_grid(dev) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = [(0, 1, 2, 3, 4, 5, 6)] + [(0, b) for b in range(1, 9)]
    fwd_err = bwd_err = 0.0
    cases = 0
    for onehot in (False, True):
        for bits in widths:
            for d in (8, 16, 50, 64):
                for t in (1, 255, 257, 4099):
                    f, b = check_qat(*qat_inputs(gen, t, d, bits, dev, onehot),
                                     bits, f"mpe_qat grid bits={bits} d={d} "
                                     f"rows={t} onehot={onehot}")
                    fwd_err, bwd_err = max(fwd_err, f), max(bwd_err, b)
                    cases += 1
    log(f"mpe_qat grid: {cases} cases, out and drows bit-identical to the "
        f"plain version, backward repeatable; max |diff| of the sums "
        f"{bwd_err:.3e}")
    return fwd_err, bwd_err


def reset_counts():
    for counter in (qat_ops.mixed_expectation_fwd, qat_ops.mixed_expectation_bwd,
                    mpe_lookup_ops.packed_lookup):
        counter.launches = 0


def phase_train_path(dev) -> dict:
    """The training entry point at full width, then the trained table served."""
    cfg = get_arch("dlrm-criteo").make_config(backbone="dnn")
    n_steps = SEARCH_STEPS + RETRAIN_STEPS
    argv = ["--arch", "dlrm-criteo", "--backbone", "dnn",
            "--batch", str(TRAIN_BATCH), "--steps", str(SEARCH_STEPS),
            "--retrain-steps", str(RETRAIN_STEPS), "--lam", str(LAM),
            "--seed", str(SEED)]
    log(f"train path: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = launch_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    live_after = torch.cuda.memory_allocated()
    steps = res["search_history"] + res["retrain_history"]
    fwd = qat_ops.mixed_expectation_fwd.launches
    bwd = qat_ops.mixed_expectation_bwd.launches
    check(len(steps) == n_steps, f"{len(steps)} steps ran, not {n_steps}")
    check(fwd == n_steps and bwd == n_steps,
          f"{n_steps} steps launched the mpe_qat forward {fwd} and the "
          f"backward {bwd} times: each step must launch each once")
    check(all(np.isfinite(h["loss"]) for h in steps), "a loss was not finite")
    check(not any(h["skipped"] for h in steps), "a step was skipped")

    # serve the exported table: the packed compressor over the trained MLP
    table, meta = res["packed_table"], res["packed_meta"]
    params = {**res["final_params"], "embedding": table}
    buffers = {"offsets": res["buffers"]["offsets"], "embedding": {"meta": meta}}
    engine = build_engine(cfg, params, res["state"], buffers, device=dev)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=SEED)
    served = 0
    with torch.inference_mode():
        for step, rows in enumerate((1, 300, 512, 3000), start=20_000):
            ids = SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
            before = mpe_lookup_ops.packed_lookup.launches
            got = engine.score(ids, return_logits=True)
            check(mpe_lookup_ops.packed_lookup.launches > before,
                  f"a {rows}-row request to the trained table launched no "
                  f"mpe_lookup kernel")
            check(got.shape == (rows,) and np.isfinite(got).all(),
                  f"bad scores for a {rows}-row request to the trained table")
            gids = torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]
            emb = packed_lookup_ref(table, meta, gids.reshape(-1)).reshape(
                *gids.shape, meta["d"])
            want = DLRM.interact(params, res["state"], emb, gids, cfg)[0].cpu()
            compare(torch.from_numpy(got), want, SCORE_TOL, SCORE_TOL,
                    f"trained table, {rows}-row request vs plain lookup")
            served += 1
    launches = {"mixed_expectation_fwd": fwd, "mixed_expectation_bwd": bwd,
                "mpe_lookup": mpe_lookup_ops.packed_lookup.launches}
    sec = res["seconds"]
    out = {"launches": launches, "steps": n_steps, "requests_served": served,
           "train_s": train_s, "phase_s": sec, "peak_bytes": train_peak,
           "live_bytes_before": live_before, "live_bytes_after": live_after,
           "search_step_ms": sec["search"] / SEARCH_STEPS * 1e3,
           "retrain_step_ms": sec["retrain"] / RETRAIN_STEPS * 1e3,
           "search_batch_ms": float(np.mean(
               [h["data_ms"] for h in res["search_history"]])),
           "retrain_batch_ms": float(np.mean(
               [h["data_ms"] for h in res["retrain_history"]])),
           "losses": [h["loss"] for h in steps],
           "storage_ratio": res["storage_ratio"], "avg_bits": res["avg_bits"],
           "eval": res["eval"]}
    log(f"train path: {n_steps} steps, launches {launches}; search "
        f"{out['search_step_ms']:.1f} ms/step, retrain "
        f"{out['retrain_step_ms']:.1f} ms/step (host clock to a synchronize; "
        f"making a batch on the host {out['search_batch_ms']:.1f} and "
        f"{out['retrain_batch_ms']:.1f} ms of them); "
        f"peak memory {train_peak / 1e9:.3f} GB ({live_before / 1e9:.3f} GB "
        f"live before, {live_after / 1e9:.3f} GB after); ratio "
        f"{res['storage_ratio']:.6f}, avg bits {res['avg_bits']:.3f}, eval "
        f"{res['eval']}; losses {[round(x, 5) for x in out['losses']]}")
    del engine, params
    return {**out, "res": res, "cfg": cfg}


def composition(rows, probs, alpha, beta, g, bits):
    """Eq. 9 and its gradients by autograd through ``lsq_quantize``."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (rows, probs, alpha, beta)]
    out = quantizer.mixed_expectation(*leaves, bits)
    out.backward(g)
    return out.detach(), [x.grad for x in leaves]


def qat_bytes(t, d, m) -> dict:
    """Bytes the Eq. 9 forward and backward must move: each input read
    once, each output written once."""
    fwd = 4 * (t * d + t * m + m + d + t * d)
    bwd = 4 * (t * d + t * m + m + d + t * d + t * d + t * m + m + d)
    return {"fwd": fwd, "bwd": bwd}


def phase_step_inputs(dev, train) -> dict:
    """A search step's and a retrain step's own inputs at the full shape:
    the kernels against the plain version and the composition, the kernel
    times, and one traced search step."""
    cfg, res = train["cfg"], train["res"]
    mpe = MPEConfig(lam=LAM)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                   batch_size=TRAIN_BATCH, seed=SEED)
    ds = SyntheticCTR(spec)
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=LAM, device=dev)
    bundle = build(SEED, "mpe_search", mpe._asdict())
    del bundle["params"]                      # the searched ones are used
    offsets = bundle["buffers"]["offsets"]
    gof = bundle["buffers"]["embedding"]["group_of_feature"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gids = (torch.from_numpy(ds.batch(0)["ids"]).to(dev)
            + offsets[None, :]).reshape(-1).long()
    sp, fp = res["search_params"]["embedding"], res["final_params"]["embedding"]
    bits = tuple(mpe.bits)
    widx = res["buffers"]["embedding"]["bits_idx"][gids].long()
    cases = {
        "search": (sp["emb"][gids],
                   MPESearchEmbedding.probabilities(sp, mpe)[gof[gids].long()],
                   sp["alpha"], sp["beta"]),
        "retrain": (fp["emb"][gids],
                    torch.nn.functional.one_hot(widx, len(bits)).float(),
                    fp["alpha"], fp["beta"]),
    }
    errs = {"fwd": 0.0, "bwd": 0.0}
    for what, (rows, probs, alpha, beta) in cases.items():
        rows, probs = rows.contiguous(), probs.contiguous()
        g = torch.randn(rows.shape, generator=gen, device=dev)
        f, b = check_qat(rows, probs, alpha, beta, g, bits,
                         f"{what} step inputs ({rows.shape[0]} rows)")
        errs["fwd"], errs["bwd"] = max(errs["fwd"], f), max(errs["bwd"], b)
        out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
        grads = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
        c_out, c_grads = composition(rows, probs, alpha, beta, g, bits)
        compare(out, c_out, FWD_TOL["rtol"], FWD_TOL["atol"],
                f"{what} step: forward kernel vs lsq_quantize composition")
        compare(grads[0], c_grads[0], FWD_TOL["rtol"], FWD_TOL["atol"],
                f"{what} step: drows kernel vs autograd of the composition")
        for name, x, w in zip(("dprobs", "dalpha", "dbeta"), grads[1:],
                              c_grads[1:]):
            compare(x, w, RED_TOL["rtol"], RED_TOL["atol"],
                    f"{what} step: {name} kernel vs autograd of the "
                    f"composition")
        del c_out, c_grads, out, grads
    rows, probs, alpha, beta = (x.contiguous() for x in cases["search"])
    g = torch.randn(rows.shape, generator=gen, device=dev)
    t, d = rows.shape
    moved = qat_bytes(t, d, len(bits))
    times = {
        "fwd": cuda_ms(lambda: qat_ops.mixed_expectation_fwd(
            rows, probs, alpha, beta, bits), 50),
        "fwd_plain": cuda_ms(lambda: mixed_expectation_fwd_ref(
            rows, probs, alpha, beta, bits), 10, warmup=1),
        "bwd": cuda_ms(lambda: qat_ops.mixed_expectation_bwd(
            rows, probs, alpha, beta, g, bits), 50),
        "bwd_plain": cuda_ms(lambda: mixed_expectation_bwd_ref(
            rows, probs, alpha, beta, g, bits), 10, warmup=1),
    }
    bound = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in moved.items()}
    for k in ("fwd", "bwd"):
        log(f"mpe_qat {k} at train_batch ({t} rows, d={d}, m={len(bits)}): "
            f"{times[k]:.4f} ms per call (plain {times[k + '_plain']:.4f} ms; "
            f"bound {bound[k]:.4f} ms for {moved[k]} bytes, "
            f"{bound[k] / times[k]:.1%} of it)")
    del cases, rows, probs, g

    # where the training path's peak memory comes from: the export of the
    # trained table, and one search step, each above what is live
    peaks = {}
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_packed_table(fp["emb"], res["buffers"]["embedding"]["bits_idx"],
                       fp["alpha"], fp["beta"], mpe)
    torch.cuda.synchronize()
    peaks["export"] = torch.cuda.max_memory_allocated() - live
    # one traced search step from the searched parameters, its batch made
    # on the host included, as the training loop runs it
    trainer = Trainer(bundle["loss_fn"], res["search_params"], bundle["buffers"],
                      bundle["state"], adam(1e-3))
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(ds.batch, 1, log_every=0)             # warm
    peaks["search_step"] = torch.cuda.max_memory_allocated() - live
    peaks["live_at_step"] = live
    log(f"peak memory above what was live: export {peaks['export'] / 1e9:.3f} "
        f"GB, one search step {peaks['search_step'] / 1e9:.3f} GB "
        f"(with {live / 1e9:.3f} GB live, Adam's state included)")
    traced = trace(lambda: trainer.run(ds.batch, trainer.step + 1,
                                       log_every=0), 1)
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["batch_make_ms"] = trainer.history[-1]["data_ms"]
    log(f"traced search step: wall {traced['wall_ms']:.1f} ms (making its "
        f"batch {step_view['batch_make_ms']:.1f} ms), device busy "
        f"{traced['busy_ms']:.1f} ms (idle share {traced['idle_share']:.3f}); "
        f"top " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in traced["top"]))
    by_name = traced["by_name"].items()
    step_view["mpe_qat_ms"] = {
        "fwd": sum(ms for n, ms in by_name if "mpe_qat_fwd_kernel" in n),
        "bwd": sum(ms for n, ms in by_name if "mpe_qat_bwd_kernel" in n
                   or "mpe_qat_reduce_kernel" in n)}
    return {"errs": errs, "times": times, "bytes": moved, "bound_ms": bound,
            "rows": t, "traced_step": step_view, "peaks": peaks}


def qat_records(grid_errs, train, step) -> list:
    rec = []
    for k, line in (("fwd", 104), ("bwd", 126)):
        name = f"mixed_expectation_{k}"
        rec.append({"name": name, "route": "cuda", "source": QAT_SOURCE,
                    "replaces": f"src/repro/kernels/mpe_qat/kernel.py:{line}",
                    "launches": train["launches"][name],
                    "max_abs_err": max(grid_errs[k == "bwd"], step["errs"][k]),
                    "ms": step["times"][k], "plain_ms": step["times"][k + "_plain"],
                    "bound_ms": step["bound_ms"][k], "bound_by": "bytes",
                    "library_ms": None, "bytes": step["bytes"][k],
                    "rows": step["rows"]})
    return rec


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    grid_err = phase_kernel_grid(dev)
    qat_grid_errs = phase_qat_grid(dev)
    reset_counts()
    main_path = phase_main_path(dev)
    kernel = phase_kernel_times(main_path, grid_err)
    traced = phase_trace(main_path)
    log(json.dumps({"storage_ratio": main_path["ratio"],
                    "request_p50_ms": main_path["request_p50_ms"],
                    "bulk_request_ms": main_path["bulk_request_ms"],
                    "serve_peak_bytes": main_path["serve_peak_bytes"],
                    "cells": main_path["cells"], "traced": traced}))
    del main_path
    train = phase_train_path(dev)
    step = phase_step_inputs(dev, train)
    log(json.dumps({"train": {k: v for k, v in train.items()
                              if k not in ("res", "cfg")},
                    "traced_step": step["traced_step"],
                    "peaks": step["peaks"]}))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel, *qat_records(qat_grid_errs, train,
                                                       step)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
