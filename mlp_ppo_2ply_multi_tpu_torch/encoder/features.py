"""Tesauro 198-feature board encoding as a batched tensor op.

Port of ``mlp_ppo_2ply_multi_tpu/encoder/features.py``; the layout is the
reference's live encoder (immutable_board.py:86-128):

    [  0: 96)  player-1 points 0..23 x (>=1, >=2, >=3, (n-3)/2 clamped >= 0)
    [ 96:192)  player-2 points, same 4-tuple per point
    [192]      bar[P1] / 2
    [193]      off[P1] / 15
    [194]      bar[P2] / 2
    [195]      off[P2] / 15
    [196:198)  side-to-move one-hot (P1, P2)
"""
from __future__ import annotations

import torch

from mlp_ppo_2ply_multi_tpu_torch.core.types import FEATURE_DIM
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board


def encode_board(
    board: Board, player: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Encode a board batch from ``player``'s side-to-move perspective.
    ``player`` broadcasts into the board batch shape S; returns [S + (198,)]."""
    cnt = board.data[..., :48].to(dtype)
    stack = torch.stack(
        [
            (cnt >= 1).to(dtype),
            (cnt >= 2).to(dtype),
            (cnt >= 3).to(dtype),
            torch.clamp(cnt - 3.0, min=0.0) * 0.5,
        ],
        -1,
    )
    point_feats = stack.reshape(*cnt.shape[:-1], 192)
    tail_d = board.data[..., 48:52].to(dtype)
    bs = tail_d.shape[:-1]
    p = torch.broadcast_to(torch.as_tensor(player, device=cnt.device), bs)
    tail = torch.stack(
        [
            tail_d[..., 0] / 2.0,  # bar p0
            tail_d[..., 2] / 15.0,  # off p0
            tail_d[..., 1] / 2.0,  # bar p1
            tail_d[..., 3] / 15.0,  # off p1
            (p == 0).to(dtype),
            (p == 1).to(dtype),
        ],
        -1,
    )
    out = torch.cat([point_feats, tail], -1)
    assert out.shape[-1] == FEATURE_DIM
    return out
