#!/usr/bin/env python3
"""Per-call time of the flash forward at SASRec's ``serve_p99`` shape (512
sequences, S = hd = 50, causal) on one CUDA card, as ``chip_smoke.py`` times
it: CUDA events over back-to-back calls of the public wrapper, which at this
size is bound by the host, so the host's own time per call is printed too.

    python3 scripts/flash_p99.py [--src DIR] [--calls N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (its
kernels are built there at first use), so that two checkouts can be compared
on one card by running the script in turns.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--src", default=os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
ap.add_argument("--calls", type=int, default=500)


def main() -> int:
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels.flash_attention import ops

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((512, 50, 50), generator=gen, device="cuda")
               for _ in range(3))
    for _ in range(3):
        ops.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.calls):
        ops.flash_attention_fwd(q, k, v, True)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    end.synchronize()
    print(f"{os.path.abspath(args.src)}: {start.elapsed_time(end) / args.calls:.4f} "
          f"ms a call (CUDA events), host {host_ms:.4f} ms a call, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
