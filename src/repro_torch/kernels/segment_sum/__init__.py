"""The backward of a row gather: the upstream gradient's rows summed by the
gather's index into a dense table gradient, in float64 and in a fixed
order."""
