"""Embedding-table field bookkeeping."""
