"""MPE numerics, the packed serving table and the compressor registry."""
