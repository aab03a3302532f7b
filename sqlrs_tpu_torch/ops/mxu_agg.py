"""Dense-group aggregation: sum(v) and count(*) per group id in [0, G).

The port of sqlrs_tpu/ops/mxu_agg.py, the star rollup's fast variant for a
DENSE dim domain (surrogate keys): gid = key - key_min. The reference's
Pallas kernel computes it on the TPU's matrix unit as one-hot bf16 matmuls
(gid = hi·K_LO + lo, 8-bit value limbs, carry-split f32 accumulators). The
port keeps the contract, not that formulation: `dense_group_sums` returns
exact int64 sums and counts. On a CUDA tensor it launches the hand-written
kernel in csrc/mxu_agg.cu (shared-memory integer histograms over tiles of
the group domain); on a CPU tensor it runs `dense_group_sums_plain`, the
same function in plain PyTorch. Nothing falls back from one to the other.

Selection (`mxu_eligible`) keeps the reference's bounds, so the same queries
take the same variant. Its backend test reads SQLRS_TPU_MXU: "0" never,
"interpret" on any device (how the CPU tests exercise the selection with
the plain version), and "auto" (the default) only for data on a CUDA
device. `mxu_groupby_dense_xla` is not ported: no production path runs it.
"""

from __future__ import annotations

import ctypes
import os

import torch

K_LO = 256            # lanes of the reference's lo one-hot
MXU_MAX_GROUPS = 1 << 16
MXU_MAX_VAL_BITS = 24  # the reference's 3 exact bf16 limbs

_BLOCK = 1024          # CUDA threads per block
_TILE = 8192           # groups per block: 96 KB of shared counters


def _plan(n_groups: int, val_bits: int):
    """The reference's kernel plan: (gh one-hot rows, value limbs,
    channels). The port uses the limb count to bound val_bits."""
    gh = -(-n_groups // K_LO)
    gh = max(16, ((gh + 15) // 16) * 16)
    nlimbs = max(1, -(-val_bits // 8))
    return gh, nlimbs, 1 + nlimbs


def mxu_interpret_flag() -> bool:
    """SQLRS_TPU_MXU=interpret selects the dense-group variant whatever the
    device — how the CPU tests exercise the selection path."""
    return os.environ.get("SQLRS_TPU_MXU", "auto") == "interpret"


def mxu_eligible(n_groups: int, val_max, val_min, dense: bool, device) -> bool:
    """Selection guard shared by make_join_groupby and the fused route:
    dense dim domain, non-negative int values below 2^24, at most 2^16
    groups (the reference's bounds), and data on a CUDA device unless
    SQLRS_TPU_MXU says otherwise ("0" disables, "interpret" allows any
    device)."""
    if os.environ.get("SQLRS_TPU_MXU", "auto") == "0":
        return False
    if not mxu_interpret_flag() and torch.device(device).type != "cuda":
        return False
    return (
        dense
        and val_max is not None
        and 0 <= int(val_max) < (1 << MXU_MAX_VAL_BITS)
        and (val_min is None or int(val_min) >= 0)
        and 0 < n_groups <= MXU_MAX_GROUPS
    )


# --------------------------------------------------------------------------
# the kernel: wrapper, plain version, launch
# --------------------------------------------------------------------------


def _check_inputs(gid, vals, n_groups: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    if (
        vals.dtype != torch.int32
        or vals.shape != gid.shape
        or not vals.is_contiguous()
    ):
        raise ValueError("vals must be a contiguous int32 tensor shaped like gid")
    if vals.device != gid.device:
        raise ValueError("gid and vals must be on one device")
    if not 1 <= n_groups <= MXU_MAX_GROUPS:
        raise ValueError(f"n_groups {n_groups} outside [1, {MXU_MAX_GROUPS}]")
    if gid.shape[0] >= 1 << 31:
        raise ValueError("more than 2^31 - 1 rows")


def dense_group_sums(gid, vals, n_groups: int):
    """(sums int64 (G), counts int64 (G)): per group id in [0, G), the sum
    of vals and the number of rows; a gid outside [0, G) is a miss. Sums are
    exact int64 for any int32 values.

    A CUDA tensor goes to the kernel (csrc/mxu_agg.cu), a CPU tensor to
    dense_group_sums_plain; any other device raises."""
    _check_inputs(gid, vals, n_groups)
    if gid.device.type == "cuda":
        return _dense_group_sums_cuda(gid, vals, n_groups)
    if gid.device.type == "cpu":
        return dense_group_sums_plain(gid, vals, n_groups)
    raise ValueError(f"dense_group_sums has no version for {gid.device}")


dense_group_sums.launches = 0  # kernel launches, counted where they happen


def dense_group_sums_plain(gid, vals, n_groups: int):
    """dense_group_sums in plain PyTorch: int64 index_add_ over the
    in-range rows."""
    dev = gid.device
    inr = (gid >= 0) & (gid < n_groups)
    g = torch.where(inr, gid, 0).to(torch.int64)
    sums = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    sums.index_add_(0, g, torch.where(inr, vals, 0).to(torch.int64))
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    counts.index_add_(0, g, inr.to(torch.int64))
    return sums, counts


def _kernel_fn():
    from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

    fn = load_kernel_library("mxu_agg").sqlrs_dense_group_sums
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _dense_group_sums_cuda(gid, vals, n_groups: int):
    fn = _kernel_fn()
    dev = gid.device
    n = int(gid.shape[0])
    tile = min(n_groups, _TILE)
    n_tiles = -(-n_groups // tile)
    # about two resident blocks per SM in all, over the tiles
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid_x = max(1, min(-(-n // _BLOCK), -(-2 * sms // n_tiles)))
    sums = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            gid.data_ptr(), vals.data_ptr(), n, n_groups, tile,
            sums.data_ptr(), counts.data_ptr(), grid_x, _BLOCK, stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_group_sums kernel launch failed: cudaError {err}")
    dense_group_sums.launches += 1
    return sums, counts


# --------------------------------------------------------------------------
# the rollup
# --------------------------------------------------------------------------


def mxu_groupby_dense(keys, vals, n_groups: int, val_bits: int,
                      key_min=None, dim_keys=None, with_perm: bool = False):
    """sum(v), count(*) grouped by key for keys in [key_min, key_min +
    n_groups) (misses = any key outside that range); exact int64 results.
    Requires 0 <= v < 2^val_bits, val_bits <= 24. With with_perm=True the
    gid-ordered outputs are scattered to dim-row order (argsort(dim_keys)),
    join_groupby_direct's contract."""
    _, nlimbs, _ = _plan(n_groups, val_bits)
    if 8 * nlimbs > MXU_MAX_VAL_BITS:
        raise ValueError(f"val_bits {val_bits} > {MXU_MAX_VAL_BITS}")
    if key_min is not None:
        # rebase in int64 FIRST (an int32 cast of far-away keys could wrap
        # into [0, G) as a false hit), then mask to the miss value -1
        k64 = keys.to(torch.int64) - key_min
        inr = (k64 >= 0) & (k64 < n_groups)
        k32 = torch.where(inr, k64, -1).to(torch.int32)
    else:
        k32 = keys.to(torch.int32).contiguous()
    sums, counts = dense_group_sums(k32, vals.to(torch.int32).contiguous(), n_groups)
    if with_perm:
        from sqlrs_tpu_torch.ops.pipelines import _scatter

        dim_perm = torch.argsort(dim_keys)
        sums = _scatter(dim_perm, sums, n_groups)
        counts = _scatter(dim_perm, counts, n_groups)
    return sums, counts
