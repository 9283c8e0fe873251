"""The benchmark's frozen arithmetic: the H100's published peaks, the value
net's operations, and the bounds of the two CUDA kernels on the main path.

Copies of the formulas the program carries (``ops/fused_value.py::bound``,
``experimental/nd_tail.py::bound`` and ``child_rows``, the peaks of
``utils/cost.py``), kept here so that a change to the program cannot move
the yardstick. B1's bound is counted over the rows a step has to value (the
legal afterstates), not over the padded rows the program hands the kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12  # float32 outside the tensor cores

N_CELLS = 52  # 48 point cells + bar x2 + off x2
N_REP = 4 * N_CELLS  # B1's per-cell representation lanes
N_SLOTS = 27  # submove slots of one die
N_CAND = 2 * (N_SLOTS + 1) * N_SLOTS  # B2's 1512 candidate cells a row


def value_flops(rows: float, inputs: int = 198, hidden: int = 128) -> float:
    """Operations of the value net's forward pass over ``rows`` feature rows:
    the two products' multiply-adds, the bias adds of the hidden layer."""
    return rows * (2.0 * inputs * hidden + 2.0 * hidden + hidden)


def learner_flops(rows: float, inputs: int = 198, hidden: int = 128) -> float:
    """Forward and backward over ``rows``: the forward, the two weight
    gradients' products and the hidden layer's gradient."""
    return value_flops(rows, inputs, hidden) + rows * (2.0 * inputs * hidden + 4.0 * hidden)


def fused_value_bound(rows: float, nnz_per_row: float, launches: int,
                      hidden: int = 128) -> Dict[str, float]:
    """B1's least time in ms for ``rows`` legal afterstates whose cells
    hold ``nnz_per_row`` nonzero lanes on average, in ``launches`` calls:
    bytes (board, flag and f32 value a row; the packed weights once a call)
    over HBM bandwidth, or the bf16 products the data needs (the nonzero
    lanes times the hidden width, plus the head) over the bf16 peak."""
    ops = 2.0 * nnz_per_row * hidden * rows + rows * 2.0 * hidden
    nbytes = rows * (N_CELLS + 1 + 4) + launches * (N_REP * hidden * 2 + hidden * 10 + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return dict(rows=rows, bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nd_tail_child_rows(valid: torch.Tensor, K: int) -> torch.Tensor:
    """Per row, the distinct child rows of the two passes' tables (27 each)
    that the first min(count, K) set cells use, and pass B's child 26 where
    the count is under K. Cell c lies in block c // 27 (pass-A pairs 0..26,
    singles 27, pass-B pairs 28..54, singles 55)."""
    c = torch.arange(N_CAND, device=valid.device)
    blk, loc = c // N_SLOTS, c % N_SLOTS
    cpass = (blk >= N_SLOTS + 1).long()
    bb = blk - (N_SLOTS + 1) * cpass
    child = N_SLOTS * cpass + torch.where(bb < N_SLOTS, bb, loc)
    onehot = torch.nn.functional.one_hot(child, 2 * N_SLOTS).float()
    sel = valid & (torch.cumsum(valid.int(), -1) <= K)
    used = (sel.float() @ onehot) > 0
    used[:, 2 * N_SLOTS - 1] |= valid.sum(-1) < K
    return used.sum(-1)


def nd_tail_bound(valid: torch.Tensor, K: int) -> Dict[str, float]:
    """B2's least time in ms on these rows (``valid`` bool [n, 1512]): bytes
    (the candidate bits, the child rows used, the root and three int32 in;
    K afterstates, keep and kpair bytes and two int32 out) over HBM
    bandwidth, or the operations (every candidate bit selected, each present
    candidate decoded and applied as 64 operations and compared with the
    earlier ones) over the CUDA-core rate."""
    n = valid.shape[0]
    m = valid.sum(-1).clamp_max(K).to(torch.int64)
    children = int(nd_tail_child_rows(valid, K).sum())
    nbytes = n * (N_CAND + N_CELLS + 3 * 4) + N_CELLS * children + n * (
        K * N_CELLS + 2 * K + 2 * 4)
    ops = n * N_CAND + int((64 * m + m * (m - 1) // 2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return dict(rows=n, bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
