"""Training traffic: the MPE search step, back to back, on a pool of batches
made on the device in set-up, for ``--seconds`` seconds.

Set-up builds the trainer once from the benchmark's weights and drives it
through its first ``check_steps`` steps on distinct batches, by the same
call and feed the window uses; the program's readings of them (each
step's loss, each leaf's first clipped gradient as Adam holds it, each
leaf's change after the last of them) are taken then. The window keeps
stepping the same trainer. Once it has closed (and, traced, after
``trace_steps`` more steps under the profiler), the peak is read, the
program's state freed, and the plain reference follows the same first
steps from the same weights and batches.

Parameters (the cell file's ``params``): ``batch`` rows a step, ``pool``
batches cycled, ``positive_rate`` of the labels, ``check_steps``,
``trace_steps``.

A cell's limits may name any number ``compare`` reads: the first step's
loss (``loss1_gap``), the median leaf's (``grad_median_gap``,
``change_median_gap``) and each leaf's by its name
(``grad_gap.embedding.emb``, ``change_gap.embedding.emb``).
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch
from torch.profiler import record_function

from perfbench.lib.trace import Trace
from perfbench.models.common import change_norms, first_gradient_norms, named
from perfbench.reference import common as C

# the faults a search cell can have (files of ``perfbench/faults``)
FAULTS = ("unchanged_state", "half_batch", "table_unchanged",
          "segment_sum_half")
# the parameters at a CPU test's size
TINY = {"batch": 256, "pool": 4, "trace_steps": 2}

# leaves whose first gradient in the reference is below this share of the
# median leaf's are rounding (a bias before BatchNorm): their change is
# not compared
STILL = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's |norm_program - norm_reference| over the larger of
    the reference's norm of that leaf and of the median kept leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def compare(prog: dict, ref: tuple) -> dict:
    """The numbers a search cell can be judged by: the gap of each step's
    loss (the worst, and the first step's), of the first gradient's norm
    and of the change's norm after the steps, by the worst leaf, by the
    median leaf and by each leaf (``grad_gap.<leaf>``,
    ``change_gap.<leaf>``)."""
    losses, first, change = ref
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses)]
    med = statistics.median(first.values())
    still = {k for k, v in first.items() if v < STILL * med}
    grad = leaf_gaps(prog["first"], first, set(first))
    moved = leaf_gaps(prog["change"], change, set(first) - still)
    out = {"loss_gap": max(loss), "loss1_gap": loss[0],
           "grad_gap": max(grad.values()),
           "grad_median_gap": statistics.median(grad.values()),
           "change_gap": max(moved.values()),
           "change_median_gap": statistics.median(moved.values())}
    out.update({f"grad_gap.{k}": v for k, v in grad.items()})
    out.update({f"change_gap.{k}": v for k, v in moved.items()})
    print(f"loss gaps by step {loss}; worst leaves: gradient "
          f"{max(grad, key=grad.get)}, change {max(moved, key=moved.get)}; "
          f"not compared in change (first gradient under {STILL} of the "
          f"median leaf's): {sorted(still)}; readings {out}", file=sys.stderr)
    return out


def control(run, seed: int) -> dict:
    """The control's readings: the plain reference in the program's place,
    its float32 products in TF32, held against the float32 reference on the
    cell's first steps at its own sizes, as a run holds the program."""
    p = run.params
    ref = run.reference.Model(run.cfg, run.device)
    batches = ref.batches(seed, p["check_steps"], p["batch"],
                          p["positive_rate"])
    f32 = ref.train(seed, batches)
    losses, first, change = ref.train(seed, batches, tf32=True)
    return compare({"losses": losses, "first": first, "change": change}, f32)


def run(run) -> dict:
    p, dev = run.params, run.device
    ref = run.reference.Model(run.cfg, dev)
    batches = ref.batches(run.seed, p["pool"], p["batch"], p["positive_rate"])
    trainer = run.model.trainer(ref, ref.weights(run.seed), dev)
    b1 = run.cfg["optimizer"]["b1"]

    # the first steps, by the window's call, on distinct batches
    losses, first = [], None
    for step in range(p["check_steps"]):
        out = trainer.train_step(batches[step], step)
        losses.append(out["loss"])
        if step == 0:
            first = first_gradient_norms(trainer, b1)
    start = ref.weights(run.seed)
    change = change_norms(trainer, start)
    del start
    prog = {"losses": [float(x) for x in losses],
            "first": {k: float(v) for k, v in first.items()},
            "change": {k: float(v) for k, v in change.items()}}
    opt_step0 = int(trainer.carry["opt"]["step"])

    run.window_starts()
    step, host_ms = p["check_steps"], []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - t0 >= run.seconds:
            break
        with record_function("bench.train_step"):
            trainer.train_step(batches[step % len(batches)], step)
        host_ms.append((time.perf_counter() - t) * 1e3)
        step += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    n = step - p["check_steps"]
    skipped = n - (int(trainer.carry["opt"]["step"]) - opt_step0)

    layer = {"host_ms": host_ms}
    if run.trace:
        trace = Trace()
        traced = []
        trace.start()
        for _ in range(p["trace_steps"]):
            with record_function("bench.train_step"):
                trainer.train_step(batches[step % len(batches)], step)
            traced.append(batches[step % len(batches)])
            step += 1
        trace.stop()
    peak = (torch.cuda.max_memory_reserved(dev) if dev.type == "cuda"
            else 0)
    if run.trace:
        gof, _ = C.make_groups(ref.frequencies(), run.cfg["group_size"])
        elements = sum(v.numel() for v in named(trainer.params).values())
        steps = [run.model.step_work(ref, b, gof, elements) for b in traced]
        layer.update(trace=trace, steps=steps,
                     model_flops=sum(s["flops"] for s in steps))
        del gof

    kept = batches[:p["check_steps"]]
    del trainer, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(prog, ref.train(run.seed, kept))
    return {"e2e": {"train_samples_per_s": n * p["batch"] / window_s},
            "attempted": n, "failed": skipped, "checks": checks,
            "peak_bytes": peak, "layer": layer}
