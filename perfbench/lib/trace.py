"""The device trace of a traced run: ``torch.profiler`` over a short steady
stretch of the run, reduced to what the per-layer readers and the
result's ``breakdown`` take: each kernel's device seconds by name, the
device's busy seconds (the union of its operations' intervals), the traced
window's length, and the device's idle gaps, each named by what the host
was doing then (the benchmark's outermost ``bench.*`` span and the
innermost host operation around the gap's middle).
"""
from __future__ import annotations

import time

import numpy as np
import torch

TOP = 10          # entries of each breakdown list
GAPS_LABELLED = 500


class Trace:
    """Start with ``start()``, end with ``stop()``; then read."""

    def __init__(self):
        self._prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: list = []      # (name, start_us, end_us)
        self.gaps: list = []         # (label, seconds)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once, in set-up: its first start
        initializes the device tracing, which takes a while."""
        with self._profile():
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu").add_(1)

    def start(self):
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        self._prof = None
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in events:
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type != cuda:
                host.append(span)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith("bench.")):
                # the benchmark's own spans also show on the device's
                # timeline: they are no device work
                dev.append(span)
        dev.sort(key=lambda x: x[1])
        self.kernels = dev
        merged = []
        for _, s, e in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.gaps = _label_gaps(merged, host)

    # -- readers --------------------------------------------------------------
    def seconds(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(e - s for name, s, e in self.kernels
                   if any(p in name for p in patterns)) / 1e6

    def launches(self, *patterns: str) -> int:
        return sum(1 for name, _, _ in self.kernels
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        by_label: dict[str, float] = {}
        for label, sec in self.gaps:
            by_label[label] = by_label.get(label, 0.0) + sec
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _label_gaps(merged: list, host: list) -> list:
    """The idle gaps between the device's busy intervals, the longest
    ``GAPS_LABELLED`` named by the host's activity at their middle."""
    if not host:
        return []
    starts = np.array([s for _, s, _ in host], np.float64)
    ends = np.array([e for _, _, e in host], np.float64)
    names = [n for n, _, _ in host]
    lo, hi = starts.min(), ends.max()
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = np.array([n.startswith("bench.") for n in names])
    out = []
    for s, e in gaps[:GAPS_LABELLED]:
        mid = 0.5 * (s + e)
        inside = (starts <= mid) & (ends >= mid)
        label = "host idle"
        if inside.any():
            idx = np.flatnonzero(inside)
            inner = idx[np.argmin(ends[idx] - starts[idx])]
            outer = [i for i in idx if spans[i]]
            label = names[inner]
            if outer:
                top = max(outer, key=lambda i: ends[i] - starts[i])
                if top != inner:
                    label = f"{names[top]} > {label}"
        out.append((label, (e - s) / 1e6))
    return out
