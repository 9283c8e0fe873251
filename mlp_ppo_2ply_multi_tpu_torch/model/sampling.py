"""The 1-ply actor's draw over afterstate values, shared by the rollout step
(``actor.rollout``) and the tiered pipeline (``experimental.tiered``).

``orient`` gives the value net's side-to-move flag for the candidates and
the sign that makes "higher is better" for the mover; ``sample`` is
softmax(V/T) sampling as ``argmax(logits + gumbel)`` with injected noise,
the draw ``jax.random.categorical`` makes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG = -1e9


def orient(player: torch.Tensor, td_mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(cand_flag, sgn) for movers ``player``. td_mode "side0" values every
    board from side 0: candidates are encoded with the opponent on roll and
    side 1 minimizes (sgn -1). Otherwise the mover's own flag and no sign."""
    if td_mode == "side0":
        return 1 - player, torch.where(player == 0, 1.0, -1.0).to(torch.float32)
    return player, None


def sample(values, valid, sgn, gumbel_noise, temperature) -> torch.Tensor:
    """argmax(where(valid, V / T, -1e9) + gumbel), V signed by ``sgn`` when
    it is given."""
    if sgn is not None:
        values = values * sgn[..., None]
    logits = torch.where(valid, values / temperature, _NEG)
    return torch.argmax(logits + gumbel_noise, -1)
