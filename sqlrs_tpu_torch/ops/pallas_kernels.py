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
csrc/pallas_kernels.cu (one warp per query); on a CPU tensor it runs the
plain PyTorch version, the gather formulation of the rank stage. Nothing
falls back from one to the other. The reference chunks its queries by
`_MAX_Q`, a limit of the TPU's scalar memory, which has no counterpart
here.
"""

from __future__ import annotations

import ctypes

import torch

ROW = 128           # lanes per row, the rank stage's block
_BLOCK = 256        # CUDA threads per block: 8 queries


def _check_inputs(x2d, block_idx, scalar) -> None:
    if x2d.dtype != torch.int32 or x2d.dim() != 2 or x2d.shape[1] != ROW:
        raise ValueError(f"the blocks must be an int32 tensor (nb, {ROW})")
    if x2d.shape[0] < 1 or not x2d.is_contiguous():
        raise ValueError("the blocks must be contiguous and hold at least one row")
    for t in (block_idx, scalar):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("block_idx and the per-query operand must be contiguous 1-D int32")
    if block_idx.shape != scalar.shape:
        raise ValueError("block_idx and the per-query operand differ in length")
    if not (x2d.device == block_idx.device == scalar.device):
        raise ValueError("all operands must be on one device")


def _rows(x2d, block_idx):
    return x2d[torch.clamp(block_idx, 0, x2d.shape[0] - 1).to(torch.int64)]


def row_rank_ge_plain(sp2d, block_idx, queries):
    return (_rows(sp2d, block_idx) >= queries[:, None]).sum(1, dtype=torch.int32)


def masked_row_sum_plain(v2d, block_idx, rem):
    lane = torch.arange(ROW, dtype=torch.int32, device=v2d.device)
    under = lane[None, :] < rem[:, None]
    return torch.where(under, _rows(v2d, block_idx), 0).sum(1, dtype=torch.int32)


def _launch(entry: str, x2d, block_idx, scalar):
    from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

    fn = getattr(load_kernel_library("pallas_kernels"), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
    dev = x2d.device
    nq = int(scalar.shape[0])
    out = torch.empty(nq, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x2d.data_ptr(), int(x2d.shape[0]), block_idx.data_ptr(),
            scalar.data_ptr(), nq, out.data_ptr(), _BLOCK, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return out


def _dispatch(wrapper, entry, plain, x2d, block_idx, scalar):
    _check_inputs(x2d, block_idx, scalar)
    if x2d.device.type == "cuda":
        if scalar.shape[0] == 0:
            return torch.empty(0, dtype=torch.int32, device=x2d.device)
        out = _launch(entry, x2d, block_idx, scalar)
        wrapper.launches += 1
        return out
    if x2d.device.type == "cpu":
        return plain(x2d, block_idx, scalar)
    raise ValueError(f"{wrapper.__name__} has no version for {x2d.device}")


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
