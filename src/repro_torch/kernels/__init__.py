"""Hand-written CUDA kernels for Hopper, one package each.

Each package holds ``ref.py`` (the plain PyTorch version, which CPU tensors
take) and ``ops.py`` (the wrapper, which launches the kernel built from
``repro_torch/csrc/<name>.cu`` for CUDA tensors and counts its launches).
``COUNTERS`` names every wrapper whose ``launches`` counts its kernel's
launches; ``counts()`` reads them all. The reference's eight wrapper names
(``packed_lookup_kernel``, ``mixed_expectation_kernel``,
``embedding_bag_kernel``, ``flash_attention_kernel`` and their ``_sharded``
forms) are exported here too.
"""
from repro_torch.kernels.adam.ops import adam_step_
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag_fwd, embedding_bag_kernel, embedding_bag_kernel_sharded)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd, flash_attention_fwd, flash_attention_fwd_stats,
    flash_attention_kernel, flash_attention_kernel_sharded)
from repro_torch.kernels.kv_cache_write.ops import kv_cache_write
from repro_torch.kernels.mpe_lookup.ops import (packed_lookup,
                                                packed_lookup_kernel,
                                                packed_lookup_kernel_sharded)
from repro_torch.kernels.mpe_qat.ops import (
    mixed_expectation_bwd, mixed_expectation_fwd, mixed_expectation_kernel,
    mixed_expectation_kernel_sharded)
from repro_torch.kernels.segment_sum.ops import segment_sum
from repro_torch.kernels.tiered_cold.ops import cold_fill

COUNTERS = {"mpe_lookup": packed_lookup,
            "mixed_expectation_fwd": mixed_expectation_fwd,
            "mixed_expectation_bwd": mixed_expectation_bwd,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_fwd_stats": flash_attention_fwd_stats,
            "flash_attention_bwd": flash_attention_bwd,
            "embedding_bag_fwd": embedding_bag_fwd,
            "segment_sum": segment_sum,
            "adam_step_": adam_step_,
            "tiered_cold": cold_fill,
            "kv_cache_write": kv_cache_write,
            "decode_attention": decode_attention}


def counts() -> dict:
    """Every wrapper's launch count, by kernel name."""
    return {name: wrapper.launches for name, wrapper in COUNTERS.items()}


__all__ = ["COUNTERS", "counts",
           "packed_lookup_kernel", "mixed_expectation_kernel",
           "embedding_bag_kernel", "flash_attention_kernel",
           "packed_lookup_kernel_sharded", "mixed_expectation_kernel_sharded",
           "embedding_bag_kernel_sharded", "flash_attention_kernel_sharded"]
