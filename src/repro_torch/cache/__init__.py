"""Tiered embedding cache + async prefetch.

Three layers, the reference's ``repro.cache``:

  ``tiers``    — ``TieredTableStore``: splits an MPE packed table by feature
                 frequency into a hot tier on the device and an inclusive
                 host mirror whose rows move as packed words on demand.
                 Bit-exact against ``core.inference.packed_lookup`` at every
                 hot fraction (the hot tier through the ``mpe_lookup``
                 kernel, the cold rows through the ``tiered_cold`` kernel);
                 per-tier hit/miss/byte counters; ``apply_moves`` and
                 ``writeback`` write the device tensors in place, so the
                 tiered cells' CUDA graphs see them without a recapture.
  ``policy``   — ``DecayAdmissionPolicy``: exponential-decay admission
                 scores over the live lookup stream, planning bounded
                 ``TierPlan`` promotion batches; ``StaticTierPolicy`` is the
                 no-op baseline.
  ``prefetch`` — ``PrefetchPipeline``: stages the next batches (and
                 optionally their cold-row fills) ahead of the step that
                 reads them.
"""
from repro_torch.cache.policy import (DecayAdmissionPolicy, StaticTierPolicy,
                                      TierPlan)
from repro_torch.cache.prefetch import PrefetchPipeline
from repro_torch.cache.tiers import (ColdPrefetch, ColdStaging,
                                     TieredTableStore, tiered_hot_lookup,
                                     tiered_hot_lookup_fn)

__all__ = [
    "TieredTableStore", "ColdPrefetch", "ColdStaging", "tiered_hot_lookup",
    "tiered_hot_lookup_fn", "PrefetchPipeline", "DecayAdmissionPolicy",
    "StaticTierPolicy", "TierPlan",
]
