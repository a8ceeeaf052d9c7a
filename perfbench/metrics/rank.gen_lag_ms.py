"""The 99th percentile of how late the open loop submitted a request after
its due time, on the benchmark's own clock: where it is large, the
generator, not the system, set part of the latency."""
import numpy as np


def read(layer):
    lag = layer["lag_ms"]
    return float(np.percentile(lag, 99)) if len(lag) else None
