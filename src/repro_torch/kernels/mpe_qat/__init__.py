"""The Eq. 9 mixture over candidate widths and its fused backward (paper
§3.3), the embedding lookup of every search and retrain step."""
