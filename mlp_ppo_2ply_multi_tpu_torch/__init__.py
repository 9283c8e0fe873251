"""PyTorch/CUDA port of the backgammon self-play framework.

This package mirrors the layout of ``mlp_ppo_2ply_multi_tpu`` (the JAX
reference, which stays as it is) module for module:

    core/     typed configuration and constants (copies of the reference's)
    engine/   int8 [..., 52] boards, slot tables, sortless move generation
    encoder/  Tesauro-198 features
    model/    the 198 -> h -> 1 sigmoid value net and .pth load/save
    ops/      the fused board -> value kernel (CUDA C++ for sm_90a) and its
              plain PyTorch version
    env/      the batched environment
    actor/    the 1-ply self-play rollout step (split-planes production path)

It imports torch and numpy only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise instead of running
on the CPU.
"""
