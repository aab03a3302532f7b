"""sqlrs_tpu_torch — the PyTorch port of sqlrs_tpu, a vectorized OLAP SQL
query engine, for NVIDIA Hopper GPUs.

The JAX package `sqlrs_tpu` beside it is the reference: this package keeps
its module tree and names, so `sqlrs_tpu_torch/ops/mxu_grouped.py` is the
counterpart of `sqlrs_tpu/ops/mxu_grouped.py`, and holds the same SQL to
the same results. It imports torch and never jax (nor sqlrs_tpu).

- Data plane: columnar batches of torch tensors + validity masks on one
  explicit device; strings are dictionary-encoded int32 codes.
- Operators: eager torch code; the TPU's Pallas kernels become hand-written
  CUDA kernels for sm_90a (sqlrs_tpu_torch/csrc/), built with nvcc at first
  use. On a CPU tensor each kernel's wrapper runs its plain PyTorch version.
- Frontend (parser/binder/planner/HEP optimizer) is the reference's host
  Python, copied.

    import sqlrs_tpu_torch
    db = sqlrs_tpu_torch.Database()          # device="cuda" by default
    db.run("create table t(a int, b int); insert into t values (1, 10)")
    rows = db.run_lines("select a, sum(b) from t group by a")

Operators not ported yet raise ExecutorError("... not yet ported to
sqlrs_tpu_torch").
"""

from sqlrs_tpu_torch.errors import (
    BinderError,
    CatalogError,
    ExecutorError,
    ParserError,
    SqlrsError,
    TypeError_,
)
from sqlrs_tpu_torch.session.database import Database

__version__ = "0.1.0"

__all__ = [
    "Database",
    "SqlrsError",
    "ParserError",
    "BinderError",
    "CatalogError",
    "ExecutorError",
    "TypeError_",
]
