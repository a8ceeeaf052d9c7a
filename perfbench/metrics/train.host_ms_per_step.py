"""The host's milliseconds a window step takes to return from
``Trainer.train_step`` (it enqueues the step's work and returns): where it
reaches the step's device time, the host paces training."""
import statistics


def read(layer):
    ms = layer["host_ms"]
    return statistics.fmean(ms) if ms else None
