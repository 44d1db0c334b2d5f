"""Core library: formats, reordering, clustering and the gather/scatter
SpGEMM tier of the port."""
