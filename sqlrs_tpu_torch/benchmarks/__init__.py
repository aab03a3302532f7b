"""TPC-H data and query texts for sqlrs_tpu_torch: the generator and the 22
queries of the top-level benchmarks package, copied so that this package
and chip_smoke.py need nothing of the JAX package (numpy only)."""
