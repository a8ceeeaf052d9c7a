#!/usr/bin/env python3
"""Time variants of ``src/repro_torch/csrc/flash_attention.cu`` side by side
on one CUDA card, at the shapes the models' paths give the kernels.

    python3 scripts/flash_variants.py [--json out.json]

A variant is the source with some text replaced: a list of ``[old, new]``
pairs, each ``old`` found in the source (``VARIANTS``). Each variant is built by its own
``nvcc`` (all started together, the flags of ``kernels/build.py``) into
``build/flash_variants/`` and called through the same C interface as the
port's library. The default set takes the kernel apart to show where its
time goes; most of those variants compute wrong results and are timed only:

- ``base``: the source as it is;
- ``no_compute``: items staged and nothing computed (the copies alone);
- ``no_staging``: nothing staged, the compute on whatever shared memory
  holds (the compute alone);
- ``one_product``: one TF32 product where the tensor-core route takes three
  (the cost of split TF32 at hd > 4);
- ``ieee_division``: o divided by the IEEE division instead of the
  reciprocal and its correction step;
- ``rounded_low``: the low TF32 part rounded to nearest instead of cut.

Shapes: SASRec's (B, 50, 1, 50), causal, at ``train_batch`` (65,536) and
``serve_bulk`` (262,144), and BST's (B, 21, 8, 4), not causal, at a
step's 65,536 and the bulk apply's 262,144 rows. Each time is the mean of
10 calls after 2, from CUDA events, in ms.
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

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"
VARIANTS = {
    "base": [],
    "no_compute": [["    compute(smem + st * g.stage_floats, item);\n", ""]],
    "no_staging": [["stage_item<kNt>(", "if (0) stage_item<kNt>("],
                   ["mbar_wait(&bars[st]", "if (0) mbar_wait(&bars[st]"]],
    "one_product": [["mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n", ""]],
    "ieee_division": [["return fmaf(fmaf(-q, d.b, a), d.r, q);", "return a / d.b;"]],
    "rounded_low": [["lo = __float_as_uint(x - __uint_as_float(hi));",
                     "lo = to_tf32(x - __uint_as_float(hi));"]],
}
SHAPES = [("sasrec fwd train_batch", "fwd", (65536, 50, 1, 50), 1),
          ("sasrec fwd serve_bulk", "fwd", (262144, 50, 1, 50), 1),
          ("sasrec fwd_stats train_batch", "fwd_stats", (65536, 50, 1, 50), 1),
          ("sasrec bwd train_batch", "bwd", (65536, 50, 1, 50), 1),
          ("bst fwd bulk apply", "fwd", (262144, 21, 8, 4), 0),
          ("bst fwd_stats step", "fwd_stats", (65536, 21, 8, 4), 0),
          ("bst bwd step", "bwd", (65536, 21, 8, 4), 0)]


def build(name: str, edits: list) -> ctypes.CDLL:
    text = SOURCE.read_text()
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
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    so = ctypes.CDLL(str(lib))
    so.flash_attention_fwd.argtypes = [p, p, p, ll, i, i, i, f, i, p, p, p]
    so.flash_attention_bwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, f, i,
                                       p, p, p, p]
    return so


def time_shape(libs: dict, kind: str, shape: tuple, causal: int) -> dict:
    b, s, h, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse = torch.empty((b, h, s), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = hd ** -0.5
    ptr = [x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)]
    libs["base"].flash_attention_fwd(*ptr[:3], b, s, h, hd, scale, causal,
                                     ptr[3], ptr[5], stream)
    row = {}
    for name, lib in libs.items():
        def call():
            if kind == "bwd":
                return lib.flash_attention_bwd(*ptr[:5], ptr[5], b, s, h, hd,
                                               scale, causal, *ptr[6:], stream)
            return lib.flash_attention_fwd(
                *ptr[:3], b, s, h, hd, scale, causal, ptr[3],
                ptr[5] if kind == "fwd_stats" else None, stream)
        if any(call() for _ in range(2)):
            row[name] = "launch failed"
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call()
        end.record()
        end.synchronize()
        row[name] = round(start.elapsed_time(end) / 10, 4)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the times here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    variants = VARIANTS
    OUT.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(len(variants)) as pool:
        futures = {name: pool.submit(build, name, edits)
                   for name, edits in variants.items()}
        libs = {name: f.result() for name, f in futures.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    out = {}
    for what, kind, shape, causal in SHAPES:
        out[what] = time_shape(libs, kind, shape, causal)
        print(what, out[what], flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": smi, "ms": out},
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
