"""Device ops: bit-packed k-mers, counting, joins, and the five CUDA kernels
of the contigging path (extract, sort, finalize, compact, join)."""
