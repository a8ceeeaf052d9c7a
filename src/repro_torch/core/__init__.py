"""MPE numerics, the packed serving table and the compressor registry.

  - quantizer: LSQ+ fake quant with the paper's STE gradients (Eqs. 2, 4-6)
  - MPESearchEmbedding / MPEConfig: search phase (Eqs. 8-10)
  - sample_group_bits / MPERetrainEmbedding: sampling (Eq. 11) + retraining
  - build_packed_table / packed_lookup: bit-packed inference tables (§4)
  - get_compressor / REGISTRY: every compressor of paper Table 3 by name
"""
from repro_torch.core.api import REGISTRY, get_compressor
from repro_torch.core.inference import (build_packed_table, packed_lookup,
                                        packed_specs, packed_storage_bytes)
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding, make_groups
from repro_torch.core.quantizer import int_bounds, lsq_quantize, mixed_expectation
from repro_torch.core.sampling import (MPERetrainEmbedding, average_bits,
                                       feature_bits, sample_group_bits)
import repro_torch.core.baselines  # noqa: F401  (registers)
import repro_torch.core.compressors  # noqa: F401  (registers)

__all__ = [
    "get_compressor", "REGISTRY", "MPEConfig", "MPESearchEmbedding",
    "make_groups", "lsq_quantize", "mixed_expectation", "int_bounds",
    "MPERetrainEmbedding", "feature_bits", "sample_group_bits", "average_bits",
    "build_packed_table", "packed_lookup", "packed_specs", "packed_storage_bytes",
]
