#!/usr/bin/env python3
"""Time the port's ``segment_sum`` and ``decode_attention`` wrappers at the
paths' shapes on one CUDA card, taken apart into their pieces, and, with
``--parent-src``, beside another checkout's wrappers in the same process.

    python3 scripts/kernel_ab.py [--parent-src DIR] [--only segment_sum|decode_attention] [--json OUT]

``DIR`` is another checkout's ``src`` (``git archive HEAD src | tar -x -C
build/parent``): its ``kernels/build.py`` builds its own ``csrc`` into its
own ``build/kernels``, and its two ``ops.py`` are loaded beside this tree's.
Sides are timed in turns (parent, change, change, parent); each number is
the mean of a run of back-to-back calls between CUDA events.

``segment_sum``: at each shape the whole wrapper (the stable sort, the
zeroed gradient, the chunk kernel and the combine), the sort and the zeroed
gradient alone, and one traced call's device time by kernel
(``segment_chunk_kernel``, ``segment_combine_kernel``, the sort's radix
kernels, the fill); the two sides' outputs must be equal bit for bit. Ids
are made from a seed to the recorded shapes' skew (Zipf(1.1) ranks, the
hot segments named; ``ogb_products``' edges uniform over its nodes).

``decode_attention``: int8 caches (random codes, scales in [0.01, 0.05])
at decode_32k's full context (8 × 32,768, 16 query and 8 kv heads of 128,
bf16 queries), long_500k (1 × 524,288) and the slotted lane's short
contexts (lengths 16–160 in a 32,768 cache), and a bf16 cache at
decode_32k beside ``scaled_dot_product_attention`` with a boolean key mask
and ``enable_gqa`` (timed only); each pass's traced device time, and one
call captured in a CUDA graph and replayed (the decode cells' route); the
two sides' outputs must be equal.

Prints one JSON object (also to ``--json``), with the card's name and
power limit.
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
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.segment_sum import ops as seg_ops  # noqa: E402

SEED = 0


def load_parent(src: Path) -> dict:
    """The other checkout's two wrapper modules, bound to its own build."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    kernels = src / "repro_torch" / "kernels"
    build = load("parent_build", kernels / "build.py")
    saved = sys.modules["repro_torch.kernels.build"]
    sys.modules["repro_torch.kernels.build"] = build
    try:
        return {"segment_sum": load("parent_seg_ops",
                                    kernels / "segment_sum" / "ops.py"),
                "decode_attention": load("parent_da_ops", kernels
                                         / "decode_attention" / "ops.py")}
    finally:
        sys.modules["repro_torch.kernels.build"] = saved


def traced(fn, keys: dict, reps: int = 5) -> dict:
    """Device ms of a call of ``fn`` by kernel (``reps`` calls traced),
    summed over the names holding each of ``keys``' substrings."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            break
    out = {k: 0.0 for k in keys}
    for name, us in spans:
        for k, subs in keys.items():
            if any(s in name for s in subs):
                out[k] += us / 1e3 / reps
                break
    out["all"] = sum(us for _, us in spans) / 1e3 / reps
    return out


def zipf_ids(rng, t: int, n: int) -> np.ndarray:
    return ((rng.zipf(1.1, t) - 1) % n).astype(np.int64)


def seg_shapes(rng):
    """(name, t, w, n, ids) at the recorded shapes."""
    out = []
    ids = zipf_ids(rng, 2_555_904, 267_368)
    ids[rng.random(ids.size) < 688_847 / ids.size] = 4321
    out.append(("dlrm probabilities", 7, 267_368, ids))
    out.append(("dlrm rows", 16, 34_223_104,
                zipf_ids(rng, 2_555_904, 34_223_104)))
    ids = rng.integers(0, 65_536, 3_276_800)
    ids[rng.random(ids.size) < 0.52] = 777
    out.append(("sasrec probabilities, 1.7 M-row segment", 7, 65_536, ids))
    out.append(("sasrec rows", 50, 8_388_608,
                zipf_ids(rng, 3_276_800, 8_388_608)))
    out.append(("bst probabilities", 7, 133_120,
                rng.integers(0, 133_120, 262_144)))
    ids = rng.integers(0, 133_120, 1_376_256)
    ids[rng.random(ids.size) < 0.51] = 99
    out.append(("bst probabilities, 0.7 M-row segment", 7, 133_120, ids))
    ids = zipf_ids(rng, 262_144, 327_680)
    out.append(("two-tower probabilities", 7, 327_680, ids))
    out.append(("gin molecule", 64, 3_840, rng.integers(0, 3_840, 8_192)))
    out.append(("optfs gates", 1, 34_223_104,
                zipf_ids(rng, 2_555_904, 34_223_104)))
    ids = rng.integers(0, 2, 2_555_904)
    ids[rng.random(ids.size) < 0.1] = 0
    out.append(("qr remainder", 16, 2, ids))
    out.append(("two-tower rows", 64, 41_943_040,
                zipf_ids(rng, 262_144, 41_943_040)))
    out.append(("lm token table", 2048, 92_544, zipf_ids(rng, 32_768, 92_544)))
    # deepseek-moe train at 2 x 4,096 tokens: top-6 of 64 experts, 960
    # slots each; ~12,300 choices kept, the rest dropped onto each expert's
    # last slot; every unused slot's dispatch id 0
    e, cap, t, k = 64, 960, 8192, 6
    expert = rng.integers(0, e, t * k)
    keep = rng.random(t * k) < 0.25
    slot = np.where(keep, expert * cap + rng.integers(0, cap - 1, t * k),
                    expert * cap + cap - 1)
    out.append(("moe combine scatter", 2048, t,
                np.repeat(np.arange(t), k)))
    out.append(("moe combine gather backward", 2048, e * cap, slot))
    dispatch = np.zeros(e * cap, np.int64)
    used = rng.random(e * cap) < 0.2
    dispatch[used] = rng.integers(0, t, int(used.sum()))
    out.append(("moe dispatch backward", 2048, t, dispatch))
    out.append(("gin cora first scatter", 1433, 2708,
                rng.integers(0, 2708, 10_556)))
    out.append(("gin w 1433", 1433, 100_000,
                rng.integers(0, 100_000, 1_048_576)))
    out.append(("gin ogb_products", 100, 2_449_029,
                rng.integers(0, 2_449_029, 61_859_140)))
    return out


SEG_KEYS = {"chunk": ("segment_chunk",), "combine": ("segment_combine",),
            "sort": ("RadixSort", "radix_sort", "Sort"),
            "fill": ("fill", "FillFunctor", "memset", "Memset")}


def segment_sum_ab(sides: dict, dev) -> list:
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, w, n, ids_np in seg_shapes(rng):
        t = ids_np.size
        ids = torch.from_numpy(ids_np).to(dev)
        grad = torch.randn((t, w), generator=gen, device=dev)
        outs, row = {}, {"shape": name, "rows": t, "w": w, "n": n,
                         "hot_segment": int(torch.bincount(ids).max())}
        nbytes = t * w * 4 + t * ids.element_size() + n * w * 4
        row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        iters = 3 if t * w > 1e9 else 10
        order = ["parent", "change", "change", "parent"] if len(sides) > 1 \
            else ["change"]
        for side in order:
            mod = sides[side]
            ms = cs.cuda_ms(lambda: mod.segment_sum(grad, ids, n), iters)
            row.setdefault(f"{side}_ms", []).append(ms)
            if side not in outs:
                outs[side] = mod.segment_sum(grad, ids, n)
                row[f"{side}_split"] = traced(
                    lambda: mod.segment_sum(grad, ids, n), SEG_KEYS)
                if hasattr(mod, "scratch_bytes"):
                    row[f"{side}_scratch_bytes"] = mod.scratch_bytes(t, w)
        if "parent" in outs:
            row["equal"] = bool(torch.equal(outs["parent"], outs["change"]))
        del outs
        row["sort_ms"] = cs.cuda_ms(
            lambda: torch.sort(ids.to(torch.int32), stable=True), iters)
        row["zeros_ms"] = cs.cuda_ms(
            lambda: torch.zeros((n, w), device=dev), iters)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del grad, ids
        torch.cuda.empty_cache()
    return rows


DA_KEYS = {p: (f"{p}_kernel",) for p in ("scores", "sums", "values",
                                          "combine")}


def graph_ms(fn, iters: int) -> float:
    """``fn`` captured once in a CUDA graph and replayed back to back: its
    device time without the host's launches, as the decode cells run it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cs.cuda_ms(graph.replay, iters)


def decode_case(gen, b, t, lens, dtype, dev):
    hkv, hq, hd = 8, 16, 128
    q = torch.randn((b, 1, hq, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (b, t, hkv, hd), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (0.01 + 0.04 * torch.rand((b, 1, hkv, 1), generator=gen,
                                           device=dev) for _ in range(2))
    else:
        k, v = (torch.randn((b, t, hkv, hd), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, lens


def decode_attention_ab(sides: dict, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    cases = [("decode_32k full context", 8, 32768, [32767] * 8, torch.int8),
             ("long_500k", 1, 524288, [524287], torch.int8),
             ("slotted short contexts", 8, 32768,
              rng.integers(16, 161, 8).tolist(), torch.int8),
             ("decode_32k full context, bf16 cache", 8, 32768, [32767] * 8,
              torch.bfloat16)]
    rows = []
    for name, b, t, lens, dtype in cases:
        q, k, v, ks, vs, off = decode_case(gen, b, t, lens, dtype, dev)
        valid = off + 1
        keys = int(valid.sum())
        nbytes = (keys * 2 * 8 * 128 * k.element_size()
                  + 2 * q.numel() * 2 + (2 * b * 8 * 4 if ks is not None
                                         else 0))
        row = {"shape": name, "B": b, "T": t, "valid_keys": keys,
               "cache": str(dtype), "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        outs = {}
        order = ["parent", "change", "change", "parent"] if len(sides) > 1 \
            else ["change"]
        for side in order:
            mod = sides[side]

            def call():
                return mod.decode_attention(q, k, v, ks, vs, q_offset=off,
                                            kv_valid_len=valid)
            row.setdefault(f"{side}_ms", []).append(cs.cuda_ms(call, 20))
            if side not in outs:
                outs[side] = call()
                row[f"{side}_passes"] = traced(call, DA_KEYS)
                row[f"{side}_graph_ms"] = graph_ms(call, 20)
        if "parent" in outs:
            row["max_abs_diff"] = float((outs["parent"].float()
                                         - outs["change"].float()).abs().max())
        if dtype == torch.bfloat16:
            row["sdpa_ms"] = cs.sdpa_masked_ms(q, k, v, valid, 20)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, outs
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path)
    ap.add_argument("--only", choices=("segment_sum", "decode_attention"))
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    parent = load_parent(args.parent_src) if args.parent_src else {}
    out = {"card": smi, "parent_src": str(args.parent_src)}
    for kernel, fn, mod in (("segment_sum", segment_sum_ab, seg_ops),
                            ("decode_attention", decode_attention_ab, da_ops)):
        if args.only in (None, kernel):
            sides = {"change": mod}
            if kernel in parent:
                sides["parent"] = parent[kernel]
            out[kernel] = fn(sides, dev)
    text = json.dumps(out)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
