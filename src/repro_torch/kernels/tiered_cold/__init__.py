"""The tiered cache's cold fill: unpack and dequantize staged cold rows
into the rows of the embedding buffer the hot-tier lookup left at zero."""
