#!/usr/bin/env python3
"""Time variants of an ``mpe_qat`` CUDA source side by side on one CUDA
card, at the shapes the models' training steps give the kernels.

    python3 scripts/qat_variants.py [--source FILE] [--set new|tiles] [--json out.json]

A variant is the source with some text replaced: a list of ``[old, new]``
pairs, each ``old`` found in the source. Each variant is built by its own
``nvcc`` (all started together, the flags of ``kernels/build.py``) into
``build/qat_variants/`` and called through the C interface of
``csrc/mpe_qat.cu`` (``mpe_qat_fwd``, ``mpe_qat_bwd``). The sets take a
kernel apart to show where its time goes; most variants compute wrong
results and are timed only.

``--set new`` (the default) takes ``src/repro_torch/csrc/mpe_qat.cu``
apart, a warp's lanes over each row:

- ``base``: the source as it is;
- ``min_blocks_4``, ``min_blocks_6``, ``min_blocks_8``: a launch bound
  asking ptxas for room for 4, 6 or 8 blocks an SM (the source asks 5);
- ``threads_256``: blocks of 256 threads, room for 3 an SM;
- ``float32_sums``: the three sums in float32 (timing only: the cost of
  the float64 conversions and adds);
- ``ieee_division``: ``__fdiv_rn`` for the reciprocal and its correction;
- ``no_dprobs``: the backward without the dprobs sums, tree and store;
- ``loads_only``: rows, g and p loaded and the outputs stored, nothing
  computed;
- ``compute_only``: nothing loaded from rows and g (values made from the
  index), the compute and the stores as they are.

``--set tiles`` takes apart a source with the earlier layout (tiles of
``256 / d`` rows a block, the dprobs pass between two barriers), given by
``--source``, for instance an older checkout unpacked under ``build/``:
``base``, ``no_dprobs``, ``loads_only``, ``compute_only``.

Shapes (m = 7 widths {0..6}, softmax probabilities): SASRec's lookup
(3,276,800 rows x 50), BST's sequence and context lookups (1,376,256 and
262,144 x 32) and DLRM's ``train_batch`` (2,555,904 x 16). Each time is
the mean of 10 calls after 2, from CUDA events, in ms.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "mpe_qat.cu"
OUT = ROOT / "build" / "qat_variants"
SETS = {
    "new": {
        "base": [],
        "min_blocks_4": [["constexpr int kMinBlocks = 5;",
                          "constexpr int kMinBlocks = 4;"]],
        "min_blocks_6": [["constexpr int kMinBlocks = 5;",
                          "constexpr int kMinBlocks = 6;"]],
        "min_blocks_8": [["constexpr int kMinBlocks = 5;",
                          "constexpr int kMinBlocks = 8;"]],
        "threads_256": [["constexpr int kThreads = 128;",
                         "constexpr int kThreads = 256;"],
                        ["constexpr int kMinBlocks = 5;",
                         "constexpr int kMinBlocks = 3;"]],
        "float32_sums": [["double acc_alpha[MW];", "float acc_alpha[MW];"],
                         ["double dp[MW];", "float dp[MW];"],
                         ["double db = 0.0;", "float db = 0.0f;"],
                         ["static_cast<double>(", "("],
                         ["const double o = __shfl_down_sync",
                          "const float o = __shfl_down_sync"]],
        "ieee_division": [["return __fmaf_rn(__fmaf_rn(-q, a, t), r, q);",
                           "return __fdiv_rn(t, a);"]],
        "no_dprobs": [["      if (off >= pl.L) break;  // the same for the whole warp",
                       "      break;"],
                      ["      if (pl.k == 0) {", "      if (false) {"]],
        "loads_only": [["      const float gv = cur.g[x];\n",
                        "      drow[x] = cur.e[x] + cur.g[x] + cur.p[0];\n"
                        "      continue;\n"
                        "      const float gv = cur.g[x];\n"],
                       ["      float acc = 0.0f;\n",
                        "      o[x] = t + cur.p[0];\n      continue;\n"
                        "      float acc = 0.0f;\n"]],
        "compute_only": [["      load_vec<V>(rows + at, s.e + x);\n"
                          "      if constexpr (kGrad) load_vec<V>(g + at, s.g + x);",
                          "      for (int y = 0; y < V; ++y) {\n"
                          "        s.e[x + y] = 1e-5f * static_cast<float>((at + y) & 1023);\n"
                          "        if constexpr (kGrad) s.g[x + y] = s.e[x + y] - 5e-3f;\n"
                          "      }"]],
    },
    "tiles": {
        "base": [],
        "no_dprobs": [["    for (int x = tid; x < rows_per_tile * m; x += kThreads) {",
                       "    for (int x = tid; x < 0; x += kThreads) {"]],
        "loads_only": [["      if (b != 0 && live) {", "      if (false) {"],
                       ["    if (live) drows[at] = drow;",
                        "    if (live) drows[at] = drow + e + gv;"],
                       ["    if (b == 0) continue;  // a dropped width contributes the zero vector",
                        "    if (b >= 0) continue;"],
                       ["  out[t] = acc;", "  out[t] = acc + e;"]],
        "compute_only": [["    const float e = live ? rows[at] : 0.0f;\n"
                          "    const float gv = live ? g[at] : 0.0f;",
                          "    const float e = live ? 1e-5f * static_cast<float>(at & 1023) : 0.0f;\n"
                          "    const float gv = live ? e - 5e-3f : 0.0f;"],
                         ["  const float e = rows[t];",
                          "  const float e = 1e-5f * static_cast<float>(t & 1023);"]],
    },
}
SHAPES = [("sasrec lookup", 3_276_800, 50), ("bst items", 1_376_256, 32),
          ("bst context", 262_144, 32), ("dlrm train_batch", 2_555_904, 16)]
BITS = (0, 1, 2, 3, 4, 5, 6)


REPORTS: dict = {}


def registers(ptxas: str) -> dict:
    """{kernel instantiation: "N registers, S bytes spilled"} from the
    ``-Xptxas -v`` report, for the kernels of the models' shapes."""
    regs, spills, fn = {}, {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = line.split("Used")[1].split("registers")[0].strip()
        elif fn and "spill stores" in line:
            spills[fn] = line.split("bytes spill stores")[0].split()[-1]
    out = {f: f"{r} registers, {spills.get(f, '?')} B spilled"
           for f, r in regs.items()}
    wanted = ("ILi2ELi10ELi6E", "ILi4ELi4ELi6E")
    return {f[f.index("mpe_qat_"):f.index("_kernel") + 7] + k: v
            for f, v in out.items() for k in wanted if k in f}


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
    so.mpe_qat_fwd.argtypes = [p, p, p, p, p, i, ll, i, p, p]
    so.mpe_qat_bwd.argtypes = [p, p, p, p, p, p, i, ll, i, p, p, p, p, p]
    so.mpe_qat_bwd_partial_rows.argtypes = [ll, i]
    so.mpe_qat_bwd_partial_rows.restype = ll
    return so


def time_shape(libs: dict, t: int, d: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = len(BITS)
    rows = 3e-3 * torch.randn((t, d), generator=gen, device="cuda")
    probs = torch.softmax(torch.randn((t, m), generator=gen, device="cuda"), -1)
    alpha = torch.tensor([1.0] + [4.8e-3 / ((1 << (b - 1)) - 1 or 1) ** 0.5
                                  for b in BITS[1:]], device="cuda")
    beta = 1e-4 * torch.randn((d,), generator=gen, device="cuda")
    g = torch.randn((t, d), generator=gen, device="cuda")
    out, drows, dprobs = (torch.empty_like(rows), torch.empty_like(rows),
                          torch.empty_like(probs))
    sums = torch.empty((m + d,), device="cuda")
    bits = (ctypes.c_int * m)(*BITS)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (rows, probs, alpha, beta, g)]
    row = {}
    for name, lib in libs.items():
        parts = torch.empty((lib.mpe_qat_bwd_partial_rows(t, d), m + d),
                            dtype=torch.float64, device="cuda")
        calls = {
            "fwd": lambda: lib.mpe_qat_fwd(*ptr[:4], ctypes.addressof(bits), m,
                                           t, d, out.data_ptr(), stream),
            "bwd": lambda: lib.mpe_qat_bwd(
                *ptr, ctypes.addressof(bits), m, t, d, drows.data_ptr(),
                dprobs.data_ptr(), parts.data_ptr(), sums.data_ptr(), stream)}
        for kind, call in calls.items():
            if any(call() for _ in range(2)):
                row[f"{name} {kind}"] = "launch failed"
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            row[f"{name} {kind}"] = round(start.elapsed_time(end) / 10, 4)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--set", choices=sorted(SETS), default="new")
    ap.add_argument("--json", help="write the times here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    variants = SETS[args.set]
    OUT.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(len(variants)) as pool:
        futures = {name: pool.submit(build, args.source,
                                     f"{args.set}_{name}", edits)
                   for name, edits in variants.items()}
        libs = {name: f.result() for name, f in futures.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    for name in libs:
        print(name, REPORTS.get(f"{args.set}_{name}", {}), flush=True)
    out = {}
    for what, t, d in SHAPES:
        out[what] = time_shape(libs, t, d)
        print(what, out[what], flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "source": str(args.source), "set": args.set,
             "registers": REPORTS, "ms": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
