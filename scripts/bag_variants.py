#!/usr/bin/env python3
"""Take the embedding bag's forward kernel and the packed lookup's wrapper
apart on one CUDA card, to show where their time goes.

    python3 scripts/bag_variants.py [--source FILE] [--json out.json]

The bag: a variant is ``csrc/embedding_bag.cu`` (or ``--source``) with some
text replaced, a list of ``[old, new]`` pairs, each ``old`` found in the
source. Each variant is built by its own ``nvcc`` (all started together,
the flags of ``kernels/build.py``) into ``build/bag_variants/`` and called
through the C interface (``embedding_bag_fwd``), on the BST table's size
(17,039,360 x 32, random) with Zipf(1.1) bags of 20 and ragged bool masks
at 65,536 (``train_batch``) and 262,144 (``serve_bulk``) bags, as
``chip_smoke.py``'s bag path. Each time is the mean of 20 back-to-back
launches after 3, from CUDA events, in ms; ``base_traced`` is the base's
kernels as the profiler records them (-1 where it recorded none). Most variants compute wrong
results and are timed only:

- ``base``: the source as it is;
- ``float32_sums``: the sums in float32 (the cost of float64);
- ``window_4``, ``window_16``: 4 or 16 rows a lane loads before it adds;
- ``one_row``: every slot reads row 0 (no gather misses: what the id
  chain, the shuffles and the sums cost alone);
- ``no_rows``: the rows are not read (the weight stands in for the row);
- ``min_blocks_3``, ``min_blocks_5``: the launch bound asks ptxas for 3
  or 5 blocks an SM (the source asks 4: at most 64 registers);
  ``window_4_min_blocks_5``, ``float32_sums_min_blocks_5``: with the
  changes above;
- ``threads_128``: blocks of 128 threads;
- ``float2``: float2 loads at d = 32 (16 lanes a bag, 2 bags a warp), also
  with 6 or 8 blocks an SM asked; ``window_6``: 6 rows a lane;
- ``no_rows_no_ids``: neither rows nor ids and weights loaded (made from
  the slot's index): shuffles, sums and stores alone;
- ``rows_ldcg``: the rows loaded past the L1 (``__ldcg``);
- ``no_rows_float32_sums``: neither rows nor float64 (ids, weights,
  shuffles and stores alone).

The lookup's wrapper: host microseconds a call of ``packed_lookup`` at
DLRM's ``serve_p99`` shape (19,968 ids, d = 16, widths 0..6) and of its
steps alone (the descriptor cache's lookup, the output's allocation, the
current device, a device guard, the raw stream and a Stream object's, the
ctypes call with the kernel's launch), each the mean of 2,000 calls.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.inference import build_packed_table  # noqa: E402
from repro_torch.core.mpe import MPEConfig  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path  # noqa: E402
from repro_torch.kernels.mpe_lookup import ops as lookup_ops  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "embedding_bag.cu"
OUT = ROOT / "build" / "bag_variants"
VARIANTS = {
    "base": [],
    "float32_sums": [["double acc[V];", "float acc[V];"],
                     ["acc[x] += static_cast<double>(__fmul_rn(",
                      "acc[x] += (__fmul_rn("],
                     ["__device__ __forceinline__ void store_row(float* dst, const double* acc)",
                      "__device__ __forceinline__ void store_row(float* dst, const float* acc)"]],
    "window_4": [["constexpr int kWindow = 8;", "constexpr int kWindow = 4;"]],
    "window_16": [["constexpr int kWindow = 8;", "constexpr int kWindow = 16;"]],
    "one_row": [["load_row<V>(table + id * d + c0, row[t]);",
                 "load_row<V>(table + 0 * id + c0, row[t]);"]],
    "no_rows": [["load_row<V>(table + id * d + c0, row[t]);",
                 "for (int x = 0; x < V; ++x) row[t][x] = static_cast<float>(id & 7);"]],
    "min_blocks_3": [["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;"]],
    "min_blocks_5": [["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;"]],
    "window_4_min_blocks_5": [
        ["constexpr int kWindow = 8;", "constexpr int kWindow = 4;"],
        ["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;"]],
    "float32_sums_min_blocks_5": [
        ["double acc[V];", "float acc[V];"],
        ["acc[x] += static_cast<double>(__fmul_rn(", "acc[x] += (__fmul_rn("],
        ["__device__ __forceinline__ void store_row(float* dst, const double* acc)",
         "__device__ __forceinline__ void store_row(float* dst, const float* acc)"],
        ["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;"]],
    "threads_128": [["constexpr int kThreads = 256;", "constexpr int kThreads = 128;"]],
    "float2": [["if (d % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {",
                "if (false) {"]],
    "float2_min_blocks_6": [
        ["if (d % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {",
         "if (false) {"],
        ["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 6;"]],
    "float2_min_blocks_8": [
        ["if (d % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {",
         "if (false) {"],
        ["constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 8;"]],
    "window_6": [["constexpr int kWindow = 8;", "constexpr int kWindow = 6;"]],
    "no_rows_no_ids": [
        ["load_row<V>(table + id * d + c0, row[t]);",
         "for (int x = 0; x < V; ++x) row[t][x] = static_cast<float>(id & 7);"],
        ["          const IdT id = __ldg(bag_ids + s);",
         "          const IdT id = static_cast<IdT>((slot0 + s) * 40503 % n_rows);"],
        ["          my_w[u] = weight(__ldg(bag_mask + s));",
         "          my_w[u] = static_cast<float>((slot0 + s) & 1);"]],
    "rows_ldcg": [["      __ldg(reinterpret_cast<const typename Vec<V>::T*>(src));",
                   "      __ldcg(reinterpret_cast<const typename Vec<V>::T*>(src));"]],
    "no_rows_float32_sums": [
        ["load_row<V>(table + id * d + c0, row[t]);",
         "for (int x = 0; x < V; ++x) row[t][x] = static_cast<float>(id & 7);"],
        ["double acc[V];", "float acc[V];"],
        ["acc[x] += static_cast<double>(__fmul_rn(", "acc[x] += (__fmul_rn("],
        ["__device__ __forceinline__ void store_row(float* dst, const double* acc)",
         "__device__ __forceinline__ void store_row(float* dst, const float* acc)"]],
}
N_ROWS, D, L = 17_039_360, 32, 20
SHAPES = [("train_batch", 65_536), ("serve_bulk", 262_144)]
REPORTS: dict = {}


def registers(ptxas: str) -> dict:
    """{instantiation: "N registers, S B spilled"} from the ptxas report,
    for the d = 32 kernels with int32 ids and bool masks (float4: 8 lanes
    a bag; float2: 16)."""
    regs, spills, fn = {}, {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = line.split("Used")[1].split("registers")[0].strip()
        elif fn and "spill stores" in line:
            spills[fn] = line.split("bytes spill stores")[0].split()[-1]
    return {f[f.index("ILi"):][:20]: f"{r} registers, "
            f"{spills.get(f, '?')} B spilled"
            for f, r in regs.items()
            if "ILi8ELi4EihE" in f or "ILi16ELi2EihE" in f}


def build(source: Path, name: str, edits: list) -> ctypes.CDLL:
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    REPORTS[name] = registers(proc.stdout + proc.stderr)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so = ctypes.CDLL(str(lib))
    so.embedding_bag_fwd.argtypes = [p, ll, i, p, i, p, i, ll, i, p, p]
    return so


def zipf_ids(rng, n: int, shape) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(shape), side="right"),
                      n - 1).astype(np.int32)


def traced_ms(call, reps: int = 20) -> float:
    """The mean device time of ``reps`` launches as the profiler records
    each kernel (its start to its end)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "embedding_bag_kernel" in e.name]
    return round(sum(spans) / 1e3 / max(len(spans), 1), 4) if spans else -1.0


def time_bag(libs: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((N_ROWS, D), generator=gen, device="cuda")
    rng = np.random.default_rng(4)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for shape, bags in SHAPES:
        ids = torch.from_numpy(zipf_ids(rng, 16_777_216, (bags, L))).cuda()
        mask = torch.from_numpy(np.arange(L)[None, :] < rng.integers(
            1, L + 1, (bags, 1))).cuda()
        res = torch.empty((bags, D), device="cuda")
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                return lib.embedding_bag_fwd(
                    table.data_ptr(), N_ROWS, D, ids.data_ptr(), 0,
                    mask.data_ptr(), 0, bags, L, res.data_ptr(), stream)
            if any(call() for _ in range(3)):
                row[name] = "launch failed"
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            row[name] = round(start.elapsed_time(end) / 20, 4)
            if name == "base":
                row["base_traced"] = traced_ms(call)
        out[shape] = row
        print(shape, row, flush=True)
    return out


def host_us(fn, calls: int = 2000) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return round(us, 2)


def time_lookup_host() -> dict:
    rng = np.random.default_rng(0)
    n, d, bits = 2_000_000, 16, (0, 1, 2, 3, 4, 5, 6)
    emb = torch.randn((n, d), device="cuda") * 3e-3
    widx = torch.from_numpy(rng.integers(0, len(bits), n).astype(np.int32)).cuda()
    alpha = torch.full((len(bits),), 1e-3, device="cuda")
    beta = torch.zeros((d,), device="cuda")
    table, meta = build_packed_table(emb, widx, alpha, beta,
                                     MPEConfig(bits=bits))
    ids = torch.from_numpy(rng.integers(0, n, (512, 39)).astype(np.int32)).cuda()
    flat = ids.reshape(-1)
    dev = flat.device
    plan = lookup_ops.cached_plan(table, meta, dev)
    out = torch.empty((flat.numel(), d), device="cuda")
    kernel = lookup_ops._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    addr = plan.c_address

    def guard():
        with torch.cuda.device(dev):
            pass
    steps = {
        "packed_lookup": lambda: lookup_ops.packed_lookup(table, meta, ids),
        "cached_plan": lambda: lookup_ops.cached_plan(table, meta, dev),
        "torch.empty": lambda: torch.empty((flat.numel(), d), device=dev),
        "current_device": torch.cuda.current_device,
        "device guard": guard,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes call": lambda: kernel(addr, flat.data_ptr(), flat.numel(),
                                      out.data_ptr(), stream),
    }
    res = {name: host_us(fn) for name, fn in steps.items()}
    print("lookup wrapper host us a call:", res, flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--json", help="write the times here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {name: pool.submit(build, args.source, name, edits)
                   for name, edits in VARIANTS.items()}
        libs = {name: f.result() for name, f in futures.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    for name in libs:
        print(name, REPORTS.get(name, {}), flush=True)
    result = {"card": smi, "source": str(args.source), "registers": REPORTS,
              "bag_ms": time_bag(libs), "lookup_host_us": time_lookup_host()}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
