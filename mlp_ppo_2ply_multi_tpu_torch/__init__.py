"""PyTorch/CUDA port of the backgammon self-play framework.

This package mirrors the layout of ``mlp_ppo_2ply_multi_tpu`` (the JAX
reference, which stays as it is) module for module:

    core/     typed configuration and constants (copies of the reference's)
    engine/   int8 [..., 52] boards, slot tables, sortless move generation
    encoder/  Tesauro-198 features
    model/    the 198 -> h -> 1 sigmoid value net and .pth load/save
    ops/      the fused board -> value kernel (CUDA C++ for sm_90a) and its
              plain PyTorch version; the shared nvcc build helper
    experimental/  the fused non-doubles tail kernel (CUDA C++ for sm_90a)
              and its plain PyTorch version (the 2-ply reply path)
    env/      the batched environment
    twoply/   the 2-ply expectimax rerank
    actor/    the self-play rollout step: 1-ply split planes or merged moves,
              or 2-ply
    learner/  the TD(0) learner (optax's clip + Adam written out)
    io/       checkpoints of the whole training state, the metrics writer
    apps/     the training CLI (python -m mlp_ppo_2ply_multi_tpu_torch.apps.train)

It imports torch and numpy only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise instead of running
on the CPU.
"""
