"""The embedding bag: the masked sum of the gathered rows of every bag, with
its dense table gradient."""
