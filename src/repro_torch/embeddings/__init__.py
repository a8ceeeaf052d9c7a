"""Embedding-table field bookkeeping and the embedding bag."""
from repro_torch.embeddings.bag import embedding_bag, segment_mean
from repro_torch.embeddings.table import FieldSpec, field_offsets, total_vocab

__all__ = ["FieldSpec", "field_offsets", "total_vocab", "embedding_bag",
           "segment_mean"]
