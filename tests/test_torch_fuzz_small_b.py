"""Small fuzz seeds 20-39 (≤ 64 rows a table, 12 statements each) through the
JAX package, the port on the CPU and the port over 4 CPU shards: see
tests/torch_fuzz_harness.py and tests/test_torch_fuzz.py."""

import pytest

from sqlrs_tpu_torch.benchmarks import sql_fuzz
from tests.torch_fuzz_harness import check_case, mxu_interpret  # noqa: F401


@pytest.mark.parametrize("seed", range(20, 40))
def test_fuzz_small(seed):
    check_case(sql_fuzz.gen_case(seed, "small"))
