"""The canonical doubles enumeration as one CUDA launch.

``engine.movegen2.enumerate_doubles`` on a CUDA tensor runs here: the root
slot table, the three level expansions, the forced shorts, the level
gating, the Q7 rank-capped compaction and the merge, for every game, in one
launch of ``csrc/dd_expand.cu`` (sm_90a; built with ``nvcc`` at first use
and launched inside the dispatcher op ``mlp_ppo_torch::dd_expand`` by
``ops/_cuda_build.py``). It replaces no TPU
kernel: JAX runs the enumeration as plain XLA. Its frontier stays in shared
memory; the outputs are the only device memory it writes.

Two implementations of one function, equal byte for byte in every output
tensor, invalid entries included:

* ``movegen2.enumerate_doubles_plain`` -- plain PyTorch, the CPU path and on
  the card the kernel's oracle;
* ``launch_kernel`` -- the CUDA kernel.

``plan`` says how a launch lays out its games (a warp or a block of 256
threads a game, games a block, shared memory), from the widths and the
game count alone; ``bound`` gives the kernel's least time by its bytes, and
``utils.cost`` counts a call by that formula. ``KERNEL.launches`` counts
the launches that ran, eager and replayed in graphs; the tracer records
its growth by update as ``dd_kernel_launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, sm_count
from mlp_ppo_2ply_multi_tpu_torch.utils.cost import HBM_BYTES_PER_S

N_CELLS = 52
LEVELS = 4
BLOCK_TEAM = 256  # threads of a game that has a block to itself (kBlockTeam)
WARP_WIDEST = 128  # a warp runs a game whose widest level and a_max are at most this
MAX_WARP_GAMES = 4  # games a block for warp teams (the kernel takes up to 8)
MAX_WIDTH = 2048  # kMaxWidth: a level's or a_max's largest width
SMEM_DEFAULT = 48 * 1024  # a block's shared memory without the opt-in
SMEM_MAX = 232448  # 227 KB, with it (kMaxSmem)
_TEAM_BYTES = 64  # kTeamBytes

_SRC = Path(__file__).resolve().parent / "csrc" / "dd_expand.cu"

Widths = Tuple[int, int, int, int, int]  # (w1, w2, w3, w4, a_max)


def _bind(lib: ctypes.CDLL) -> None:
    lib.dd_expand_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dd_expand_launch.restype = ctypes.c_int
    lib.dd_expand_game_bytes.argtypes = [ctypes.c_int] * 5
    lib.dd_expand_game_bytes.restype = ctypes.c_int
    fast = (16, 96, 224, 448, 448)
    if lib.dd_expand_game_bytes(*fast) != game_bytes(fast):
        raise RuntimeError("dd_expand.cu lays out a game's shared memory otherwise than "
                           "ops/dd_expand.py::game_bytes")


# ``plan`` is (w1, w2, w3, w4, a_max, team, games)
KERNEL = CudaKernel(
    _SRC, _bind,
    "(Tensor board, Tensor player, Tensor die, Tensor(a!) boards, Tensor(b!) valid, "
    "Tensor(c!) count, Tensor(d!) overflow, int[] plan) -> ()",
    lambda board, player, die, boards, valid, count, overflow, plan: (
        board.data_ptr(), board.stride(0), player.data_ptr(), player.stride(0),
        die.data_ptr(), die.stride(0), boards.data_ptr(), valid.data_ptr(), count.data_ptr(),
        overflow.data_ptr(), board.shape[0], *plan),
    counter="dd_kernel_launches")


def widths_of(cfg) -> Widths:
    """(w1, w2, w3, w4, a_max) of a ``MoveGenConfig``."""
    return (cfg.w1, cfg.w2, cfg.w3, cfg.w4, cfg.a_max)


def _check_widths(widths: Widths) -> None:
    if len(widths) != LEVELS + 1 or not all(1 <= int(w) <= MAX_WIDTH for w in widths):
        raise ValueError(f"the dd_expand kernel takes widths (w1, w2, w3, w4, a_max) in "
                         f"[1, {MAX_WIDTH}], got {tuple(widths)}")


def game_bytes(widths: Widths) -> int:
    """Shared memory of one game, in bytes (the kernel's ``layout``): the
    frontier's boards, a flag byte an entry, the child masks of levels 0-3,
    the scan buffer and the team's warp totals, each region rounded up to 16
    bytes."""
    _check_widths(widths)
    w1, w2, w3, w4, _ = widths
    up16 = lambda x: (x + 15) // 16 * 16
    entries = 1 + w1 + w2 + w3 + w4
    masked = 1 + w1 + w2 + w3
    return (up16(entries * N_CELLS) + up16(entries) + up16(4 * masked)
            + up16(4 * max(w1, w2, w3)) + _TEAM_BYTES)


def plan(n: int, widths: Widths, sms: int) -> Dict[str, object]:
    """How a launch lays out ``n`` games on a card of ``sms`` SMs: ``team``
    threads a game (a warp where no level nor a_max is wider than
    ``WARP_WIDEST``, else a block of 256), ``games`` a block (warp teams: as
    many as fit the default 48 KB, at most ``MAX_WARP_GAMES``, and no more
    than n / sms so that small batches spread over the SMs), the block's
    shared memory, whether it needs the opt-in above 48 KB, and the blocks."""
    per_game = game_bytes(widths)
    if max(widths) <= WARP_WIDEST:
        team = 32
        games = max(1, min(MAX_WARP_GAMES, SMEM_DEFAULT // per_game, n // max(sms, 1)))
    else:
        team, games = BLOCK_TEAM, 1
    smem = games * per_game
    if smem > SMEM_MAX:
        raise ValueError(f"the dd_expand kernel needs {smem} B of shared memory a block at "
                         f"widths {tuple(widths)}, over the card's {SMEM_MAX}")
    return dict(team=team, games=games, game_bytes=per_game, smem_bytes=smem,
                opt_in=smem > SMEM_DEFAULT, blocks=-(-n // games))


def bound(n: int, widths: Widths) -> Dict[str, object]:
    """Least time for the kernel on ``n`` games, bound by bytes (its
    integer work is far below them): each game's 52-byte board and its
    int64 player and die read, a_max x 52 board bytes, a_max valid bytes,
    the int32 count and the overflow byte written, over HBM bandwidth. A
    formula of the shapes alone: it reads no data."""
    a_max = widths[-1]
    nbytes = n * (N_CELLS + 2 * 8) + n * (a_max * (N_CELLS + 1) + 4 + 1)
    return dict(games=n, a_max=a_max, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


def _rows(x, n: int, dev: torch.device) -> torch.Tensor:
    """An int64 [n] view of a per-game integer (a stride-0 broadcast stays one)."""
    t = torch.as_tensor(x, device=dev)
    if t.dtype != torch.int64:
        t = t.to(torch.int64)
    return torch.broadcast_to(t, (n,))


def launch_kernel(board: torch.Tensor, player, die, widths: Widths
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream, inside the op
    ``mlp_ppo_torch::dd_expand``: board int8 [n, 52] on a card, player and
    die integers broadcast to [n] (die in 1..6). Returns (boards int8
    [n, a_max, 52], valid bool [n, a_max], count int32 [n], overflow bool
    [n]). Raises on operands it does not take; counts the launch
    (``CudaKernel.count_launch``)."""
    if not isinstance(board, torch.Tensor) or board.dtype != torch.int8 or board.dim() != 2 \
            or board.shape[1] != N_CELLS:
        raise ValueError(f"board must be int8 [n, {N_CELLS}], got "
                         f"{getattr(board, 'dtype', type(board))} {tuple(getattr(board, 'shape', ()))}")
    if not board.is_cuda:
        raise ValueError(f"the dd_expand kernel runs on cuda, board is on {board.device}")
    p = plan(board.shape[0], widths, sm_count(board.device))  # checks the widths
    dev = board.device
    n = board.shape[0]
    if board.stride(1) != 1:
        board = board.contiguous()
    player, die = _rows(player, n, dev), _rows(die, n, dev)
    a_max = widths[-1]
    boards = torch.empty((n, a_max, N_CELLS), dtype=torch.int8, device=dev)
    valid = torch.empty((n, a_max), dtype=torch.bool, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return boards, valid, count, overflow
    KERNEL.launch(board, player, die, boards, valid, count, overflow,
                  [*map(int, widths), p["team"], p["games"]])
    return boards, valid, count, overflow
