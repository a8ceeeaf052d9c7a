"""Embedding-table field bookkeeping, the embedding bag and frequency
statistics."""
from repro_torch.embeddings.bag import embedding_bag, segment_mean
from repro_torch.embeddings.frequency import (count_frequencies,
                                              hot_feature_mask,
                                              zipf_frequencies)
from repro_torch.embeddings.table import (FieldSpec, field_offsets,
                                          globalize_ids, total_vocab)

__all__ = ["FieldSpec", "field_offsets", "globalize_ids", "total_vocab",
           "embedding_bag", "segment_mean", "zipf_frequencies",
           "count_frequencies", "hot_feature_mask"]
