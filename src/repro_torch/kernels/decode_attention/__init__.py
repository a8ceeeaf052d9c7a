"""The LM's decode attention: few query rows against a KV cache (int8 with
scales, bf16 or float32), grouped-query, with per-row lengths."""
