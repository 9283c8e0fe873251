"""The front of the non-doubles enumeration as one CUDA launch (D3).

``engine.movegen2.nd_front`` on a CUDA tensor runs here: both ordering
passes (the root's slot table for the first die, the 27 first-ply children,
their second-ply slot bits for the other die against the root's context),
``pair_valid``, ``any_pair``, ``single_valid``, the reverse-order skip of
pass B and the 1512 candidate bytes in reference insertion order, for every
game, in one launch of ``csrc/nd_front.cu`` (sm_90a; built with ``nvcc`` at
first use and launched inside the dispatcher op ``mlp_ppo_torch::nd_front``
by ``ops/_cuda_build.py``). It replaces no TPU kernel: JAX runs the front as
plain XLA. Its children and masks stay in shared memory; the outputs are the
only device memory it writes.

Two implementations of one function, equal byte for byte in every output
tensor, invalid children and cells included:

* ``movegen2.nd_front_plain`` -- plain PyTorch (``movegen2._nd_candidates``
  cut to what the tail reads), the CPU path and on the card the kernel's
  oracle;
* ``launch_kernel`` -- the CUDA kernel.

``plan`` says how a launch lays out its games (a warp a game, a power of two
of games a block) from the game count and the card's SMs; ``bound`` gives the
kernel's least time by its bytes, and ``utils.cost`` counts a call by that
formula. ``KERNEL.launches`` counts the launches that ran, eager and replayed
in graphs; the tracer records its growth by update as
``nd_front_kernel_launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from mlp_ppo_2ply_multi_tpu_torch.ops._cuda_build import CudaKernel, sm_count
from mlp_ppo_2ply_multi_tpu_torch.utils.cost import HBM_BYTES_PER_S

N_CELLS = 52
N_SLOTS = 27
N_CAND = 2 * (N_SLOTS + 1) * N_SLOTS  # 1512
MAX_GAMES = 8  # kMaxGames: games (warps) a block
_ROOT_BYTES = 64  # kRootBytes: a root board in shared memory, padded
_MASKS = 2 * (N_SLOTS + 1)  # kMasks: 32-bit candidate masks of a game

_SRC = Path(__file__).resolve().parent / "csrc" / "nd_front.cu"

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bind(lib: ctypes.CDLL) -> None:
    lib.nd_front_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nd_front_launch.restype = ctypes.c_int
    lib.nd_front_smem_bytes.argtypes = [ctypes.c_int]
    lib.nd_front_smem_bytes.restype = ctypes.c_int
    for games in range(1, MAX_GAMES + 1):
        if lib.nd_front_smem_bytes(games) != smem_bytes(games):
            raise RuntimeError("nd_front.cu lays out a block's shared memory otherwise than "
                               "ops/nd_front.py::smem_bytes")


KERNEL = CudaKernel(
    _SRC, _bind,
    "(Tensor board, Tensor player, Tensor dice, Tensor(a!) b1a, Tensor(b!) b1b, "
    "Tensor(c!) valid, Tensor(d!) d_hi, Tensor(e!) d_lo, int games) -> ()",
    lambda board, player, dice, b1a, b1b, valid, d_hi, d_lo, games: (
        board.data_ptr(), board.stride(0), player.data_ptr(), player.stride(0),
        dice.data_ptr(), dice.stride(0), dice.stride(1), b1a.data_ptr(), b1b.data_ptr(),
        valid.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(), board.shape[0], games),
    counter="nd_front_kernel_launches")


def smem_bytes(games: int) -> int:
    """Shared memory of a block of ``games`` games, in bytes (the kernel's
    ``layout``): pass A's children, pass B's children and the candidate
    bytes of every game, each region rounded up to 16 bytes, then a padded
    root board and the 56 candidate masks a game."""
    if not 1 <= games <= MAX_GAMES:
        raise ValueError(f"the nd_front kernel takes 1 to {MAX_GAMES} games a block, got {games}")
    up16 = lambda x: (x + 15) // 16 * 16
    children = N_SLOTS * N_CELLS
    return 2 * up16(games * children) + up16(games * N_CAND) + games * (_ROOT_BYTES + 4 * _MASKS)


def plan(n: int, sms: int) -> Dict[str, int]:
    """How a launch lays out ``n`` games on a card of ``sms`` SMs: a warp a
    game, ``games`` games a block (the largest power of two up to
    ``MAX_GAMES`` and up to n / sms, so that small batches spread over the
    SMs), the block's threads and shared memory, and the blocks."""
    per_sm = max(1, n // max(sms, 1))
    games = 1
    while 2 * games <= min(MAX_GAMES, per_sm):
        games *= 2
    return dict(games=games, threads=32 * games, smem_bytes=smem_bytes(games),
                blocks=-(-n // games))


def bound(n: int) -> Dict[str, object]:
    """Least time for the kernel on ``n`` games, bound by bytes (its integer
    work is far below them): each game's 52-byte board, its int64 player
    and two int64 dice read; two tables of 27 x 52 children, the 1512
    candidate bytes and the int64 d_hi and d_lo written; over HBM bandwidth.
    A formula of the shapes alone: it reads no data."""
    nbytes = n * (N_CELLS + 3 * 8) + n * (2 * N_SLOTS * N_CELLS + N_CAND + 2 * 8)
    return dict(games=n, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


def _ints(name: str, x, shape: Tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """An int64 view of a per-game integer operand broadcast to ``shape`` (a
    stride-0 broadcast stays one); raises on a float or bool operand, or
    one that does not broadcast."""
    t = torch.as_tensor(x, device=dev)
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise ValueError(f"{name} must be integers, got {t.dtype}")
    try:
        return torch.broadcast_to(t if t.dtype == torch.int64 else t.to(torch.int64), shape)
    except RuntimeError as e:
        raise ValueError(f"{name} {tuple(t.shape)} does not broadcast to {shape}") from e


def launch_kernel(board: torch.Tensor, player, dice) -> Outputs:
    """Launch the CUDA kernel on the current stream, inside the op
    ``mlp_ppo_torch::nd_front``: board int8 [n, 52] on a card, player
    integers broadcast to [n], dice integers broadcast to [n, 2]. Returns
    (b1a int8 [n, 27, 52], b1b int8 [n, 27, 52], valid bool [n, 1512],
    d_hi int64 [n], d_lo int64 [n]). Raises on operands it does not take
    by dtype, shape or device; counts the launch
    (``CudaKernel.count_launch``).

    Precondition, not checked (a check would read the card and stall the
    host): each die lies in 1..6 and each player is 0 or 1. The kernel reads
    a die outside 1..6 as the nearest face, so every access stays inside
    the game's board, and writes ``d_hi``/``d_lo`` as given: its other
    outputs then differ from the plain chain's, which does not take such
    dice. The env's rolls are 1..6 (tests/test_torch_nd_front.py and
    tests/test_torch_nd_front_gpu.py check what the rollout steps hand
    the front)."""
    if not isinstance(board, torch.Tensor) or board.dtype != torch.int8 or board.dim() != 2 \
            or board.shape[1] != N_CELLS:
        raise ValueError(f"board must be int8 [n, {N_CELLS}], got "
                         f"{getattr(board, 'dtype', type(board))} {tuple(getattr(board, 'shape', ()))}")
    if not board.is_cuda:
        raise ValueError(f"the nd_front kernel runs on cuda, board is on {board.device}")
    dev, n = board.device, board.shape[0]
    if board.stride(1) != 1:
        board = board.contiguous()
    player, dice = _ints("player", player, (n,), dev), _ints("dice", dice, (n, 2), dev)
    b1a = torch.empty((n, N_SLOTS, N_CELLS), dtype=torch.int8, device=dev)
    b1b = torch.empty((n, N_SLOTS, N_CELLS), dtype=torch.int8, device=dev)
    valid = torch.empty((n, N_CAND), dtype=torch.bool, device=dev)
    d_hi = torch.empty((n,), dtype=torch.int64, device=dev)
    d_lo = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return b1a, b1b, valid, d_hi, d_lo
    KERNEL.launch(board, player, dice, b1a, b1b, valid, d_hi, d_lo,
                  plan(n, sm_count(dev))["games"])
    return b1a, b1b, valid, d_hi, d_lo
