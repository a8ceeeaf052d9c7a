#!/usr/bin/env python3
"""Time variants of ``src/repro_torch/csrc/flash_attention.cu`` side by side
on one CUDA card, at the shapes the models' paths give the kernels.

    python3 scripts/flash_variants.py [--set staged|tiled] [--rounds N]
                                      [--json out.json]

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
10 calls after 2, from CUDA events, in ms; ``--rounds N`` times every
shape N times, the variants in turn forward and backward. Beside each time
is the largest |difference| of the variant's outputs from ``base``'s.

``--set tiled`` takes the tiled route (S > 64) instead, at the LM's
shapes (16 heads of 128, causal): the forward at internlm2's prefill of
4,096, the forward with statistics and the backward at ``train_4k`` (8 ×
4,096) and the backward at deepseek-moe's (2 × 4,096). Its variants:

- ``base``; ``unroll1`` and ``unroll2``, the score products' k-steps
  unrolled by one and two instead of four;
- ``one_product`` as above; ``no_split``, the three products kept but no
  operand split (hi and lo both the raw float32 bits, so the split's
  conversion and subtraction go); ``one_product_no_split``, both (with
  ``no_split``, the cost of two products);
- the forward's key tiles: ``keys32``, tiles of 32 keys; ``ring2``, K and
  V each in a ring of two 64-key buffers (169 KB of shared memory at hd
  128: one block an SM); ``ring2_keys32`` and ``ring3_keys32``, rings of
  two and three 32-key buffers (101 KB, two blocks an SM; 135 KB, one).
  These compute what ``base`` does (64-key rings bit for bit).
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
UNROLL = "#pragma unroll 4\n  for (int ks = 0; ks < ND; ++ks) {"
NO_SPLIT = [["hi = to_tf32(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));",
             "hi = lo = __float_as_uint(x);"]]
FWD_TILES = "constexpr int kFwdKeyRows = 64;\nconstexpr int kFwdStages = 1;"


def fwd_tiles(keys: int, stages: int) -> list:
    return [[FWD_TILES, f"constexpr int kFwdKeyRows = {keys};\n"
                        f"constexpr int kFwdStages = {stages};"]]


TILED_VARIANTS = {
    "base": [],
    "unroll1": [[UNROLL, UNROLL.replace("unroll 4", "unroll 1")]],
    "unroll2": [[UNROLL, UNROLL.replace("unroll 4", "unroll 2")]],
    "one_product": VARIANTS["one_product"],
    "no_split": NO_SPLIT,
    "one_product_no_split": VARIANTS["one_product"] + NO_SPLIT,
    "keys32": fwd_tiles(32, 1),
    "ring2": fwd_tiles(64, 2),
    "ring2_keys32": fwd_tiles(32, 2),
    "ring3_keys32": fwd_tiles(32, 3),
}
TILED_SHAPES = [("internlm2 fwd prefill 4,096", "fwd", (1, 4096, 16, 128), 1),
                ("internlm2 fwd_stats train_4k", "fwd_stats", (8, 4096, 16, 128), 1),
                ("internlm2 bwd train_4k", "bwd", (8, 4096, 16, 128), 1),
                ("deepseek-moe bwd train", "bwd", (2, 4096, 16, 128), 1)]
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
                                       p, p, p, p, p]
    return so


def time_shape(libs: dict, kind: str, shape: tuple, causal: int,
               order: list) -> dict:
    b, s, h, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse = torch.empty((b, h, s), device="cuda")
    # the tiled route's delta rows; the staged route takes none
    delta = torch.empty((b, h, s), device="cuda") if s > 64 else None
    stream = torch.cuda.current_stream().cuda_stream
    scale = hd ** -0.5
    ptr = [x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)]
    libs["base"].flash_attention_fwd(*ptr[:3], b, s, h, hd, scale, causal,
                                     ptr[3], ptr[5], stream)
    outs = {"bwd": (dq, dk, dv), "fwd_stats": (o, lse), "fwd": (o,)}[kind]

    def call(lib):
        if kind == "bwd":
            return lib.flash_attention_bwd(
                *ptr[:5], ptr[5], b, s, h, hd, scale, causal, *ptr[6:],
                None if delta is None else delta.data_ptr(), stream)
        return lib.flash_attention_fwd(
            *ptr[:3], b, s, h, hd, scale, causal, ptr[3],
            ptr[5] if kind == "fwd_stats" else None, stream)
    if call(libs["base"]):
        raise RuntimeError(f"base failed to launch at {shape}")
    want = [x.clone() for x in outs]
    row = {}
    for name in order:
        lib = libs[name]
        if any(call(lib) for _ in range(2)):
            row[name] = "launch failed"
            continue
        diff = max(float((x - w).abs().max()) for x, w in zip(outs, want))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call(lib)
        end.record()
        end.synchronize()
        row[name] = {"ms": round(start.elapsed_time(end) / 10, 4),
                     "max_abs_diff_vs_base": diff}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the times here too")
    ap.add_argument("--set", choices=("staged", "tiled"), default="staged")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    variants, shapes = ((TILED_VARIANTS, TILED_SHAPES) if args.set == "tiled"
                        else (VARIANTS, SHAPES))
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
    for r in range(args.rounds):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        for what, kind, shape, causal in shapes:
            row = time_shape(libs, kind, shape, causal, order)
            for name, got in row.items():
                out.setdefault(what, {}).setdefault(name, []).append(got)
            print(what, row, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": smi, "ms": out},
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
