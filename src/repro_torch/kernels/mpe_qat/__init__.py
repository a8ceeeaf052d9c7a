"""The Eq. 9 mixture over candidate widths and its fused backward (paper
§3.3), the embedding lookup of every search and retrain step."""
from repro_torch.kernels.mpe_qat.ops import mixed_expectation_kernel
from repro_torch.kernels.mpe_qat.ref import mixed_expectation_ref

__all__ = ["mixed_expectation_kernel", "mixed_expectation_ref"]
