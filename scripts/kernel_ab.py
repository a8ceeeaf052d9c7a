#!/usr/bin/env python3
"""Time the port's ``segment_sum``, ``decode_attention``, ``kv_cache_write``,
``tiered_cold``, flash-attention and global-norm wrappers at the paths'
shapes on one CUDA card, taken apart into their pieces, and, with
``--parent-src``, beside another checkout's wrappers in the same process.

    python3 scripts/kernel_ab.py [--parent-src DIR] [--only KERNEL ...] [--json OUT]

``KERNEL`` is one of ``segment_sum``, ``decode_attention``,
``kv_cache_write``, ``tiered_cold``, ``flash`` and ``global_norm``;
``--only`` may be given more than once.

``DIR`` is another checkout's ``src`` (``git archive HEAD src | tar -x -C
build/parent``): its ``kernels/build.py`` builds its own ``csrc`` into its
own ``build/kernels``, and its ``ops.py`` are loaded beside this tree's
(a kernel it lacks is timed on this tree alone).
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

``kv_cache_write``: one layer's keys and values written into int8 caches
(random codes, scales in [0.01, 0.05], bf16 values) at internlm2's kv
heads (8 of 128): one token at decode_32k's full context (8 × 32,768),
at long_500k (1 × 524,288) and at the slotted lane's short contexts; one
token whose values grow every scale at both full contexts (the scales
restored before each call, the restore timed alone beside it); the
prefill of 32,768 positions into an empty cache of 32,776, and
deepseek-moe's 4,096 into 4,104 at 16 kv heads. A side whose wrapper
module has ``kv_cache_write_kv`` writes a layer in one call, another in
two (keys, then values). Eager, replayed in a CUDA graph (one call a
graph, and ten), and each call's kernels traced; both sides' caches and
scales equal to the plain version's bit for bit.

``tiered_cold``: staged buffers made from a seed to the shapes of DLRM's
tiered cells (d 16, widths {0..6}, 39 fields; rows at each width drawn so
that a row averages ~2.35 packed words, as the tiered runs' buffers do):
the bulk chunk (262,144 rows) at hot 0 (9,991,317 cold entries) and at
hot 0.1 (208,006), and the 512-row cell's fill at hot 0.1 (406) and 0
(19,514) in a buffer sized for every id cold; eager, replayed in a CUDA
graph (one call a graph, and ten) and traced; both sides' outputs equal
to the plain version's bit for bit.

``flash``: the three flash-attention wrappers on (B, S, H, hd), causal:
the forward at internlm2's prefill of 4,096 and 32,768 (16 heads of 128),
the forward with statistics and the backward at ``train_4k`` (8 × 4,096)
and at deepseek-moe's training shape (2 × 4,096, 16 heads of 128), all on
the tiled route; and all three at SASRec's (65,536, 50, 1, 50), causal,
and BST's (65,536, 21, 8, 4), not causal, on the staged route, where the
two sides' outputs must be equal bit for bit. Both sides' backwards take
the same o and lse (the change's forward); the change's call traced by
kernel (the tiled backward's dQ and dK/dV kernels apart). Each row holds both bounds
(split TF32 at the tensor pipe, and SIMT float32), SDPA's forward (and
forward plus backward beside the backward; timed only) and, where the
sides differ, their largest |difference|.

``global_norm``: ``chip_smoke.global_norm_rows`` (the smoke's phase 8a):
the clip's scale and norm over random leaves (N(0, 0.01)) of both search
cells' parameter shapes, against the plain chain (``ref.py``) in turns
and beside ``torch._foreach_norm`` (timed only), the same checks, and
here the kernel's traced device time too. Timed on this tree alone.

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
from repro_torch.cache.tiers import cold_buffer_words  # noqa: E402
from repro_torch.core.packing import words_per_row  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.global_norm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.kv_cache_write import ops as kvw_ops  # noqa: E402
from repro_torch.kernels.kv_cache_write.ref import (  # noqa: E402
    kv_cache_write_ref)
from repro_torch.kernels.segment_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.tiered_cold import ops as cold_ops  # noqa: E402
from repro_torch.kernels.tiered_cold.ref import cold_fill_ref  # noqa: E402

SEED = 0
KERNELS = ("segment_sum", "decode_attention", "kv_cache_write", "tiered_cold",
           "flash", "global_norm")
MODULES = {"flash": "flash_attention"}   # a kernel's directory, where not its name


def load_parent(src: Path) -> dict:
    """The other checkout's wrapper modules, bound to its own build."""
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
        paths = {name: kernels / MODULES.get(name, name) / "ops.py"
                 for name in KERNELS}
        return {name: load(f"parent_{name}_ops", path)
                for name, path in paths.items() if path.exists()}
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
                row[f"{side}_graph_ms"] = cs.graph_ms(call, 20)
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


def layer_write(mod, k_cache, k_scale, k, v_cache, v_scale, v, lens):
    """One layer's keys and values through ``mod``: one call where the
    module has the two-cache entry, else two."""
    if hasattr(mod, "kv_cache_write_kv"):
        mod.kv_cache_write_kv(k_cache, k_scale, k, v_cache, v_scale, v, lens)
    else:
        mod.kv_cache_write(k_cache, k_scale, k, lens)
        mod.kv_cache_write(v_cache, v_scale, v, lens)


def kv_shapes(rng):
    """(name, B, T, s, H, lens, louder): internlm2's 8 kv heads of 128
    unless named; ``louder`` values grow every scale."""
    full = lambda b, t: [t - 1] * b  # noqa: E731
    return [("decode_32k one token", 8, 32768, 1, 8, full(8, 32768), False),
            ("long_500k one token", 1, 524288, 1, 8, full(1, 524288), False),
            ("slotted short contexts", 8, 32768, 1, 8,
             rng.integers(16, 161, 8).tolist(), False),
            ("decode_32k one token, every scale grows", 8, 32768, 1, 8,
             full(8, 32768), True),
            ("long_500k one token, every scale grows", 1, 524288, 1, 8,
             full(1, 524288), True),
            ("prefill 32,768 into an empty cache", 1, 32776, 32768, 8, [0],
             False),
            ("deepseek-moe prefill 4,096 (16 kv heads)", 1, 4104, 4096, 16,
             [0], False)]


def kv_cache_write_ab(sides: dict, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    hd = 128
    rows = []
    for name, b, t, s, h, lens, grows in kv_shapes(rng):
        caches = [torch.randint(-127, 128, (b, t, h, hd), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2)]
        scales = [0.01 + 0.04 * torch.rand((b, 1, h, 1), generator=gen,
                                           device=dev) for _ in range(2)]
        amp = 40.0 if grows else 1e-3
        vals = [(amp * torch.randn((b, s, h, hd), generator=gen, device=dev))
                .to(torch.bfloat16) for _ in range(2)]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        nbytes = 2 * cs.kv_write_bytes(vals[0], ln, t, grows)
        row = {"shape": name, "B": b, "T": t, "s": s, "H": h, "hd": hd,
               "bytes": nbytes,
               "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        want = [c.clone() for c in caches], [x.clone() for x in scales]
        for i in range(2):
            kv_cache_write_ref(want[0][i], want[1][i], vals[i], ln)
        work = [c.clone() for c in caches], [x.clone() for x in scales]
        saved = [x.clone() for x in scales]

        def restore():
            for x, y in zip(work[1], saved):
                x.copy_(y)
        order = ["parent", "change", "change", "parent"] if len(sides) > 1 \
            else ["change"]
        seen = set()
        for side in order:
            mod = sides[side]

            def call():
                if grows:
                    restore()
                layer_write(mod, work[0][0], work[1][0], vals[0], work[0][1],
                            work[1][1], vals[1], ln)
            if side not in seen:
                seen.add(side)
                for i in range(2):
                    work[0][i].copy_(caches[i])
                    work[1][i].copy_(scales[i])
                n = mod.kv_cache_write.launches
                layer_write(mod, work[0][0], work[1][0], vals[0], work[0][1],
                            work[1][1], vals[1], ln)
                torch.cuda.synchronize()
                row[f"{side}_kernels_a_layer"] = mod.kv_cache_write.launches - n
                row[f"{side}_equal_plain"] = all(
                    torch.equal(work[0][i], want[0][i])
                    and torch.equal(work[1][i], want[1][i]) for i in range(2))
                row[f"{side}_graph_ms"] = cs.graph_ms(call, 20)
                row[f"{side}_graph_x10_ms"] = cs.graph_ms(
                    lambda: [call() for _ in range(10)], 10) / 10
                row[f"{side}_device_ms"] = traced(
                    call, {"kernels": ("kv_",)})["kernels"]
            row.setdefault(f"{side}_ms", []).append(cs.cuda_ms(call, 20))
        if grows:
            row["restore_ms"] = cs.cuda_ms(restore, 20)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del caches, scales, vals, want, work, saved
        torch.cuda.empty_cache()
    return rows


COLD_BITS = (0, 1, 2, 3, 4, 5, 6)
COLD_WIDTH_P = (0.05, 0.10, 0.15, 0.20, 0.25, 0.25)   # widths 1..6


def cold_case(rng, n_slots: int, k: int, d: int, words: int, dev):
    """A staged buffer of ``words`` int32 words (the layout of
    ``csrc/tiered_cold.cu``) holding ``k`` cold entries at distinct rows of
    an (n_slots, d) output: widths drawn by ``COLD_WIDTH_P``, rows
    ascending in each width's bucket, random packed words; the tail junk."""
    pos = np.sort(rng.choice(n_slots, k, replace=False))
    width = rng.choice(np.arange(1, len(COLD_BITS)), k, p=COLD_WIDTH_P)
    order = np.argsort(width, kind="stable")
    counts = [0] + [int((width == i).sum()) for i in range(1, len(COLD_BITS))]
    n_words = sum(c * words_per_row(d, b) for c, b in zip(counts, COLD_BITS)
                  if b)
    used = len(COLD_BITS) + k + n_words
    buf = rng.integers(-2**31, 2**31 - 1, max(words, used), dtype=np.int64)
    buf = buf.astype(np.int32)
    buf[:len(COLD_BITS)] = counts
    buf[len(COLD_BITS):len(COLD_BITS) + k] = pos[order]
    return torch.from_numpy(buf).to(dev), used


def tiered_cold_ab(sides: dict, dev) -> list:
    rng = np.random.default_rng(SEED)
    d = 16
    meta = {"bits": COLD_BITS, "d": d}
    bulk, p99 = 262_144 * 39, 512 * 39
    cases = [("tiered_bulk at hot 0", bulk, 9_991_317, False),
             ("tiered_bulk at hot 0.1", bulk, 208_006, False),
             ("tiered_p99 (512 rows) at hot 0.1", p99, 406, True),
             ("tiered_p99 (512 rows) at hot 0", p99, 19_514, True)]
    alpha = torch.from_numpy(rng.uniform(5e-4, 2e-3, len(COLD_BITS))
                             .astype(np.float32)).to(dev)
    beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32)).to(dev)
    rows = []
    for name, n_slots, k, cell in cases:
        words = cold_buffer_words(n_slots, meta) if cell else 0
        buf, used = cold_case(rng, n_slots, k, d, words, dev)
        out = torch.zeros((n_slots, d), device=dev)
        want = cold_fill_ref(out.clone(), buf, COLD_BITS, d, alpha, beta)
        nbytes = cs.cold_bytes(used, k, d)
        row = {"shape": name, "slots": n_slots, "cold_entries": k,
               "used_words": used, "buffer_words": buf.numel(),
               "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        order = ["parent", "change", "change", "parent"] if len(sides) > 1 \
            else ["change"]
        for side in order:
            mod = sides[side]

            def call():
                mod.cold_fill(out, buf, meta, alpha, beta)
            if f"{side}_equal_plain" not in row:
                out.zero_()
                call()
                torch.cuda.synchronize()
                row[f"{side}_equal_plain"] = bool(torch.equal(out, want))
                row[f"{side}_graph_ms"] = cs.graph_ms(call, 50)
                row[f"{side}_graph_x10_ms"] = cs.graph_ms(
                    lambda: [call() for _ in range(10)], 10) / 10
                row[f"{side}_device_ms"] = traced(
                    call, {"kernel": ("tiered_cold",)})["kernel"]
            row.setdefault(f"{side}_ms", []).append(
                cs.cuda_ms(call, 50 if cell else 20))
        row["plain_ms"] = cs.cuda_ms(
            lambda: cold_fill_ref(out, buf, COLD_BITS, d, alpha, beta), 3)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del buf, out, want
        torch.cuda.empty_cache()
    return rows


FLASH_SHAPES = (
    ("internlm2 prefill 4,096", (1, 4096, 16, 128), True, ("fwd",), 20),
    ("internlm2 prefill 32,768", (1, 32768, 16, 128), True, ("fwd",), 3),
    ("internlm2 train_4k", (8, 4096, 16, 128), True, ("fwd_stats", "bwd"), 5),
    ("deepseek-moe train", (2, 4096, 16, 128), True, ("fwd_stats", "bwd"), 10),
    ("sasrec train_batch (staged)", (65536, 50, 1, 50), True,
     ("fwd", "fwd_stats", "bwd"), 20),
    ("bst train step (staged)", (65536, 21, 8, 4), False,
     ("fwd", "fwd_stats", "bwd"), 20))


FLASH_KEYS = {"fwd_tiled": ("flash_fwd_tiled",), "bwd_dq": ("flash_bwd_dq",),
              "bwd_dkdv": ("flash_bwd_dkdv",), "staged": ("flash_fwd_kernel",
                                                          "flash_bwd_kernel")}


def flash_ab(sides: dict, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, shape, causal, kinds, iters in FLASH_SHAPES:
        b, s, h, hd = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        o, lse = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
        lib = cs.sdpa_ms(q, k, v, do, max(iters // 2, 2), causal)
        for kind in kinds:
            calls = {side: {
                "fwd": lambda m=mod: (m.flash_attention_fwd(q, k, v, causal),),
                "fwd_stats": lambda m=mod: m.flash_attention_fwd_stats(
                    q, k, v, causal),
                "bwd": lambda m=mod: m.flash_attention_bwd(q, k, v, o, lse, do,
                                                           causal)}[kind]
                for side, mod in sides.items()}
            row = {"shape": name, "kind": kind, "input_shape": list(shape),
                   "causal": causal,
                   "route": cs.flash_route(s),
                   **cs.flash_work(b * h, s, hd, kind, causal),
                   "sdpa_fwd_ms": lib["fwd"], "sdpa_fwd_bwd_ms": lib["fwd_bwd"]}
            outs = {}
            order = ["parent", "change", "change", "parent"] \
                if len(sides) > 1 else ["change"]
            for side in order:
                if side not in outs:
                    outs[side] = calls[side]()
                row.setdefault(f"{side}_ms", []).append(
                    cs.cuda_ms(calls[side], iters, warmup=1))
            row["change_traced"] = traced(calls["change"], FLASH_KEYS, reps=2)
            if "parent" in outs:
                row["equal"] = all(torch.equal(x, y) for x, y in
                                   zip(outs["parent"], outs["change"]))
                row["max_abs_diff"] = max(float((x - y).abs().max()) for x, y
                                          in zip(outs["parent"], outs["change"]))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del outs
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def global_norm_ab(sides: dict, dev) -> list:
    """``chip_smoke.global_norm_rows`` on this tree's wrapper, each call
    also traced by kernel."""
    def trace(fn):
        return traced(fn, {"global_norm_kernel": ("global_norm_kernel",)})
    rows = cs.global_norm_rows(dev, sides["change"].global_norm_clip, trace)
    out = []
    for name, row in rows.items():
        out.append({"leaf_set": name, **row})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path)
    ap.add_argument("--only", choices=KERNELS, action="append")
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
                            ("decode_attention", decode_attention_ab, da_ops),
                            ("kv_cache_write", kv_cache_write_ab, kvw_ops),
                            ("tiered_cold", tiered_cold_ab, cold_ops),
                            ("flash", flash_ab, flash_ops),
                            ("global_norm", global_norm_ab, norm_ops)):
        if args.only is None or kernel in args.only:
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
