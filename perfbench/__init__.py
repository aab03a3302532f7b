"""The benchmark of sqlrs_tpu_torch: TPC-H on NVIDIA H100s (see PERF.md)."""
