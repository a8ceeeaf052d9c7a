"""Packed-table serving: request batcher, latency stats, engine."""
