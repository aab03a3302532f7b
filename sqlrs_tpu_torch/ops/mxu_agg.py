"""Dense-group aggregation: sum(v) and count(*) per group id in [0, G).

The port of sqlrs_tpu/ops/mxu_agg.py, the star rollup's fast variant for a
DENSE dim domain (surrogate keys): gid = key - key_min. The reference's
Pallas kernel computes it on the TPU's matrix unit as one-hot bf16 matmuls
(gid = hi·K_LO + lo, 8-bit value limbs, carry-split f32 accumulators). The
port keeps the contract, not that formulation: `dense_group_sums` returns
exact int64 sums and counts. On a CUDA tensor it launches the hand-written
kernel in csrc/mxu_agg.cu (one pass over the columns as stored, with the
int64 rebase and the miss mask in registers, and the group domain
interleaved over the shared memory of a thread block cluster); on a CPU
tensor it runs `dense_group_sums_plain`, the
same function in plain PyTorch. Nothing falls back from one to the other.

Selection (`mxu_eligible`) keeps the reference's bounds, so the same queries
take the same variant. Its backend test reads SQLRS_TPU_MXU: "0" never,
"interpret" on any device (how the CPU tests exercise the selection with
the plain version), and "auto" (the default) only for data on a CUDA
device. `mxu_groupby_dense_xla` is the reference's formulation outside any
kernel, its measured comparison point: one-hot products of 8192-row blocks
with a float64 carry, in plain PyTorch (no production path runs it).
"""

from __future__ import annotations

import ctypes
import os

import torch

K_LO = 256            # lanes of the reference's lo one-hot
MXU_MAX_GROUPS = 1 << 16
MXU_MAX_VAL_BITS = 24  # the reference's 3 exact bf16 limbs

_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


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


def mxu_backend_ok(device) -> bool:
    """The backend test of both kernel paths (this one and the general
    GROUP BY's ops/mxu_grouped.py), where the reference asks for a TPU:
    SQLRS_TPU_MXU "0" never, "interpret" on any device, "auto" (the
    default) only for data on a CUDA device."""
    if os.environ.get("SQLRS_TPU_MXU", "auto") == "0":
        return False
    return mxu_interpret_flag() or torch.device(device).type == "cuda"


def mxu_eligible(n_groups: int, val_max, val_min, dense: bool, device) -> bool:
    """Selection guard shared by make_join_groupby and the fused route:
    dense dim domain, non-negative int values below 2^24, at most 2^16
    groups (the reference's bounds), and the backend mxu_backend_ok
    admits."""
    if not mxu_backend_ok(device):
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


_KEY_DTYPES = (torch.int32, torch.int64)


def _check_inputs(keys, vals, n_groups: int, key_min: int, valid, val_bits) -> None:
    if keys.dtype not in _KEY_DTYPES or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int32 or int64 tensor")
    if vals.dtype not in _KEY_DTYPES or vals.shape != keys.shape or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous int32 or int64 tensor shaped like keys")
    if valid is not None and (
        valid.dtype != torch.bool or valid.shape != keys.shape or not valid.is_contiguous()
    ):
        raise ValueError("valid must be a contiguous bool tensor shaped like keys")
    if vals.device != keys.device or (valid is not None and valid.device != keys.device):
        raise ValueError("keys, vals and valid must be on one device")
    if not 1 <= n_groups <= MXU_MAX_GROUPS:
        raise ValueError(f"n_groups {n_groups} outside [1, {MXU_MAX_GROUPS}]")
    if not _INT64_MIN <= key_min <= _INT64_MAX:
        raise ValueError(f"key_min {key_min} is not an int64")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("more than 2^31 - 1 rows")
    if val_bits is not None and not 1 <= val_bits <= 63:
        raise ValueError(f"val_bits {val_bits} outside [1, 63]")


def dense_group_sums(keys, vals, n_groups: int, key_min: int = 0, valid=None,
                     val_bits=None):
    """(sums int64 (G), counts int64 (G)) per group id g = key - key_min in
    [0, G): the sum of vals and the number of rows. A row is a miss when
    valid (a bool mask, or None for all rows) is false or its key lies
    outside [key_min, key_min + G); the rebase is taken in int64, before
    anything is narrowed. keys and vals are int32 or int64. Sums are exact
    int64 for any int32 values, and for int64 values while the int64 sum
    does not wrap. val_bits, when given, is the caller's word that
    0 <= v < 2^val_bits for every row: the kernel may then pack a count and
    a sum into one 64-bit cell (csrc/mxu_agg.cu). The result is the same.

    A CUDA tensor goes to the kernel (csrc/mxu_agg.cu), a CPU tensor to
    dense_group_sums_plain; any other device raises."""
    key_min = int(key_min)
    _check_inputs(keys, vals, n_groups, key_min, valid, val_bits)
    if keys.device.type == "cuda":
        return _dense_group_sums_cuda(keys, vals, n_groups, key_min, valid, val_bits)
    if keys.device.type == "cpu":
        return dense_group_sums_plain(keys, vals, n_groups, key_min, valid)
    raise ValueError(f"dense_group_sums has no version for {keys.device}")


dense_group_sums.launches = 0  # kernel launches, counted where they happen


def dense_group_sums_plain(keys, vals, n_groups: int, key_min: int = 0, valid=None,
                           val_bits=None):
    """dense_group_sums in plain PyTorch: the int64 rebase and miss mask,
    then int64 index_add_ over the rows that hit. val_bits changes nothing
    here."""
    dev = keys.device
    k64 = keys.to(torch.int64) - int(key_min)  # wraps as the kernel's does
    inr = (k64 >= 0) & (k64 < n_groups)
    if valid is not None:
        inr = inr & valid
    g = torch.where(inr, k64, 0)
    sums = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    sums.index_add_(0, g, torch.where(inr, vals.to(torch.int64), 0))
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    counts.index_add_(0, g, inr.to(torch.int64))
    return sums, counts


def _kernel_fn():
    from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

    fn = load_kernel_library("mxu_agg").sqlrs_dense_group_sums
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    return fn


def _dense_group_sums_cuda(keys, vals, n_groups: int, key_min: int, valid, val_bits):
    fn = _kernel_fn()
    dev = keys.device
    sums = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            keys.data_ptr(), keys.element_size(),
            None if valid is None else valid.data_ptr(), key_min,
            vals.data_ptr(), vals.element_size(), val_bits or 0,
            int(keys.shape[0]), n_groups,
            sums.data_ptr(), counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_group_sums kernel launch failed: cudaError {err}")
    dense_group_sums.launches += 1
    return sums, counts


# --------------------------------------------------------------------------
# the rollup
# --------------------------------------------------------------------------


def _as_kernel_ints(x):
    return x.contiguous() if x.dtype in _KEY_DTYPES else x.to(torch.int64)


def mxu_groupby_dense(keys, vals, n_groups: int, val_bits: int,
                      key_min=None, dim_keys=None, with_perm: bool = False,
                      valid=None):
    """sum(v), count(*) grouped by key for keys in [key_min, key_min +
    n_groups) (misses = any key outside that range, and any row whose
    `valid` is false); exact int64 results. Requires 0 <= v < 2^val_bits,
    val_bits <= 24. The columns go to dense_group_sums as they are stored
    (int32 or int64), which rebases in int64 before any narrowing. With
    with_perm=True the gid-ordered outputs are scattered to dim-row order
    (argsort(dim_keys)), join_groupby_direct's contract."""
    _, nlimbs, _ = _plan(n_groups, val_bits)
    if 8 * nlimbs > MXU_MAX_VAL_BITS:
        raise ValueError(f"val_bits {val_bits} > {MXU_MAX_VAL_BITS}")
    if key_min is None:
        # the reference casts the keys themselves to int32 here
        keys, key_min = keys.to(torch.int32), 0
    sums, counts = dense_group_sums(
        _as_kernel_ints(keys), _as_kernel_ints(vals), n_groups,
        key_min=int(key_min), valid=None if valid is None else valid.contiguous(),
        val_bits=val_bits,
    )
    if with_perm:
        from sqlrs_tpu_torch.ops.pipelines import _scatter

        dim_perm = torch.argsort(dim_keys, stable=True)
        sums = _scatter(dim_perm, sums, n_groups)
        counts = _scatter(dim_perm, counts, n_groups)
    return sums, counts


_XLA_BLOCKS_PER_STEP = 8  # blocks of mxu_groupby_dense_xla in one batched product


def mxu_groupby_dense_xla(keys, vals, n_groups: int, val_bits: int, block: int = 8192):
    """The reference's plain formulation of the dense-group sums (its
    `lax.scan` of one-hot dot_generals): per 8192-row block, the (gh, block)
    one-hot of gid // 256 times the (block, 256) one-hot of gid % 256
    weighted by the in-range mask (counts) and by each 8-bit value limb,
    accumulated in float32 per block and carried in float64.

    The reference multiplies bfloat16 operands into float32. Every operand
    here is 0, 1 or a limb <= 255, exact in bfloat16 and float32 alike,
    and a block's entry is at most 8192 x 255 < 2^24, so float32 products
    give the same bits; the carry adds integers below 2^53, so adding
    _XLA_BLOCKS_PER_STEP blocks' products together (one batched matmul) does
    not change the result either. Returns exact int64 (sums, counts).
    Keys outside [0, n_groups) are misses."""
    dev = keys.device
    n = keys.shape[0]
    gh = -(-n_groups // K_LO)
    nlimbs = max(1, -(-val_bits // 8))
    nch = 1 + nlimbs
    pad = (-n) % block
    k32 = keys.to(torch.int32)
    v32 = vals.to(torch.int32)
    if pad:
        k32 = torch.cat([k32, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        v32 = torch.cat([v32, torch.zeros(pad, dtype=torch.int32, device=dev)])
    k2 = k32.view(-1, block)
    v2 = v32.view(-1, block)
    hi_iota = torch.arange(gh, dtype=torch.int32, device=dev)[None, :, None]
    lo_iota = torch.arange(K_LO, dtype=torch.int32, device=dev)[None, None, :]
    carry = torch.zeros(gh, nch, K_LO, dtype=torch.float64, device=dev)
    step = _XLA_BLOCKS_PER_STEP
    for b0 in range(0, k2.shape[0], step):
        kb, vb = k2[b0:b0 + step], v2[b0:b0 + step]
        inr = (kb >= 0) & (kb < n_groups)
        gid = torch.where(inr, kb, 0)
        a_t = (hi_iota == (gid // K_LO)[:, None, :]).to(torch.float32)   # (B, gh, block)
        l_t = (lo_iota == (gid % K_LO)[:, :, None]).to(torch.float32)    # (B, block, K_LO)
        w0 = inr.to(torch.float32)
        weights = [w0] + [((vb >> (8 * j)) & 255).to(torch.float32) * w0
                          for j in range(nlimbs)]
        rhs = torch.cat([l_t * w[:, :, None] for w in weights], 2)      # (B, block, nch*K_LO)
        prod = torch.bmm(a_t, rhs)                                       # (B, gh, nch*K_LO)
        carry += prod.view(-1, gh, nch, K_LO).to(torch.float64).sum(0)
    chans = carry.permute(1, 0, 2).reshape(nch, gh * K_LO)[:, :n_groups]
    counts = chans[0].to(torch.int64)
    sums = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    for j in range(nlimbs):
        sums = sums + (chans[1 + j].to(torch.int64) << (8 * j))
    return sums, counts
