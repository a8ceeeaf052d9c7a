"""Valid rows over padded rows of the window's dispatches, from the engine's
own counters (``LatencyStats.occupancy``): how much of each padded cell
carried requests."""


def read(layer):
    c = layer["counts"]
    return 100.0 * c["valid"] / c["padded"] if c["padded"] else None
