"""The two in-block steps of the star rollup's rank stage, as kernels.

The port of sqlrs_tpu/ops/pallas_kernels.py. For each query i, with a
128-wide row r = x2d[block_idx[i]] of a block-reshaped array:

  - row_rank_ge:    out[i] = #lanes of r that are >= queries[i]
                    (the `rows >= q` count of pipelines._sorted_ranks_left)
  - masked_row_sum: out[i] = sum of the first rem[i] lanes of r
                    (the `lane < rem` payload sum of pipelines._payload_sums)

Both are int32 in and int32 out; the sum wraps in int32, as the
reference's does. block_idx is clipped to [0, nb), as the rank stage clips
it. As in the reference, no production path calls them: the rank stage
runs its own gather formulation, and these are the comparison point for
it. On a CUDA tensor each wrapper launches its hand-written kernel in
csrc/pallas_kernels.cu (a warp a tile of 32 queries, 8 lanes a query, on
a persistent grid; the scalar-load form where the rows' base is not 16-B
aligned); on a CPU tensor it runs the plain PyTorch version, the gather
formulation of the rank stage. Nothing falls back from one to the other.
A negative rem sums nothing, one above 128 the whole row; rows need not be
sorted. The reference chunks its queries by `_MAX_Q`, a limit of the TPU's
scalar memory, which has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from sqlrs_tpu_torch.utils import programs

ROW = 128           # lanes per row, the rank stage's block


def _check_inputs(x2d, block_idx, scalar):
    """Raises on what the kernels do not take; returns the operands' device."""
    shape = x2d.shape
    if x2d.dtype != torch.int32 or len(shape) != 2 or shape[1] != ROW:
        raise ValueError(f"the blocks must be an int32 tensor (nb, {ROW})")
    if shape[0] < 1 or not x2d.is_contiguous():
        raise ValueError("the blocks must be contiguous and hold at least one row")
    n = block_idx.shape
    if (block_idx.dtype != torch.int32 or scalar.dtype != torch.int32 or len(n) != 1
            or len(scalar.shape) != 1 or not block_idx.is_contiguous()
            or not scalar.is_contiguous()):
        raise ValueError("block_idx and the per-query operand must be contiguous 1-D int32")
    if scalar.shape != n:
        raise ValueError("block_idx and the per-query operand differ in length")
    dev = x2d.device
    if block_idx.device != dev or scalar.device != dev:
        raise ValueError("all operands must be on one device")
    return dev


def _rows(x2d, block_idx):
    return x2d[torch.clamp(block_idx, 0, x2d.shape[0] - 1).to(torch.int64)]


def row_rank_ge_plain(sp2d, block_idx, queries):
    return (_rows(sp2d, block_idx) >= queries[:, None]).sum(1, dtype=torch.int32)


def masked_row_sum_plain(v2d, block_idx, rem):
    lane = torch.arange(ROW, dtype=torch.int32, device=v2d.device)
    under = lane[None, :] < rem[:, None]
    return torch.where(under, _rows(v2d, block_idx), 0).sum(1, dtype=torch.int32)


_OPS = {"sqlrs_row_rank_ge": 0, "sqlrs_masked_row_sum": 1}  # entry -> kernel number
_FNS: dict = {}     # entry name -> its ctypes function, resolved once
_GRIDS: dict = {}   # (device index, entry, vec) -> the kernel's persistent grid


def _fns() -> dict:
    """The library's entries with their argtypes set, at first use."""
    if not _FNS:
        from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

        c = ctypes
        lib = load_kernel_library("pallas_kernels")
        for entry in _OPS:
            fn = getattr(lib, entry)
            fn.restype = c.c_int
            fn.argtypes = [c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_longlong,
                           c.c_void_p, c.c_int, c.c_int, c.c_void_p]
            _FNS[entry] = fn
        grid = lib.sqlrs_rank_stage_grid
        grid.restype = c.c_int
        grid.argtypes = [c.c_int, c.c_int, c.POINTER(c.c_int)]
        _FNS["grid"] = grid
    return _FNS


def _grid(dev_index: int, entry: str, vec: int) -> int:
    """SMs x resident blocks of the kernel on the current device, asked once
    a device."""
    key = (dev_index, entry, vec)
    grid = _GRIDS.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        err = _fns()["grid"](_OPS[entry], vec, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{entry} occupancy query failed: cudaError {err}")
        grid = _GRIDS[key] = out.value
    return grid


def _launch(entry: str, dev, x2d, block_idx, scalar):
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(entry, dev, x2d, block_idx, scalar)
    nq = scalar.shape[0]
    out = torch.empty(nq, dtype=torch.int32, device=dev)
    ptr = x2d.data_ptr()
    vec = int(ptr % 16 == 0)  # else the scalar-load form of the same kernel
    # the current stream's handle, as torch's own generated kernels take it
    # (torch.cuda.current_stream builds a Stream object first)
    err = _fns()[entry](
        ptr, x2d.shape[0], block_idx.data_ptr(), scalar.data_ptr(), nq, out.data_ptr(), vec,
        _grid(dev.index, entry, vec), torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return out


def _dispatch(wrapper, entry, plain, x2d, block_idx, scalar):
    dev = _check_inputs(x2d, block_idx, scalar)
    if dev.type == "cuda":
        if scalar.shape[0] == 0:
            return torch.empty(0, dtype=torch.int32, device=dev)
        out = _launch(entry, dev, x2d, block_idx, scalar)
        wrapper.launches += 1
        return out
    if dev.type == "cpu":
        return plain(x2d, block_idx, scalar)
    raise ValueError(f"{wrapper.__name__} has no version for {dev}")


def row_rank_ge(sp2d, block_idx, queries):
    """out[i] = count of lanes in sp2d[block_idx[i]] that are >= queries[i].

    sp2d: (nb, 128) int32 (sorted, in the rank stage); block_idx, queries:
    (nq,) int32. A CUDA tensor goes to the kernel, a CPU tensor to
    row_rank_ge_plain; any other device raises."""
    return _dispatch(row_rank_ge, "sqlrs_row_rank_ge", row_rank_ge_plain,
                     sp2d, block_idx, queries)


def masked_row_sum(v2d, block_idx, rem):
    """out[i] = sum of the first rem[i] lanes of v2d[block_idx[i]], int32.

    The in-block half of a prefix sum at an arbitrary position; the caller
    adds the block-prefix table entry. A CUDA tensor goes to the kernel, a
    CPU tensor to masked_row_sum_plain; any other device raises."""
    return _dispatch(masked_row_sum, "sqlrs_masked_row_sum", masked_row_sum_plain,
                     v2d, block_idx, rem)


row_rank_ge.launches = 0       # kernel launches, counted where they happen
masked_row_sum.launches = 0
programs.register_kernel(row_rank_ge)  # replays of graphs that hold them count too
programs.register_kernel(masked_row_sum)
