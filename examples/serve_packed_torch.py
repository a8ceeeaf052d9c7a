"""Serving scenario on the PyTorch port: batched request scoring from a
bit-packed table.

    PYTHONPATH=src python examples/serve_packed_torch.py [--device cpu]

Drives the serving engine (``repro_torch.serve.Engine``) through the
``repro_torch.launch.serve`` CLI: trains a quick MPE pipeline on the
reduced configuration's fields, registers the ``serve_p99`` and
``serve_bulk`` cell shapes (CUDA graphs on the card), then streams off-shape
request batches through the batcher and reports each cell's p50/p99 latency
in the Figure-5 lookup-vs-compute split. The twin of
``examples/serve_packed.py``.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    """The reference's fixed flags, then ``argv`` (the serve CLI's own
    flags, e.g. ``--device cpu``; a later flag overrides an earlier one)."""
    # 300-row requests ride the 512-row serve_p99 cell (pad-to-shape), and
    # the bulk job chunks onto the 4,096-row serve_bulk cell: the engine's
    # whole path
    flags = ["--reduced", "--requests", "20", "--batch", "300", "--bulk",
             "10000", "--bulk-rows", "4096", "--train-steps", "80"]
    return serve_main(flags + (sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
