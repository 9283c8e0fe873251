"""B2, on every cell's main path, and the rejected-but-kept experiments of the
JAX package, ported with it.

* ``nd_tail`` -- the whole non-doubles tail (select, afterstate takes,
  signature dedup, filters) as one kernel, B2. It is on every cell's main
  path: on the H100 it is the hand-written CUDA kernel ``csrc/nd_tail.cu``,
  which the port takes for every signature-dedup tail pass, the single pass
  and both tiers of the two-tier tail, whatever ``nd_tail_kernel`` says. It
  is filed here because the JAX package files its Pallas version here: on
  TPU v5e that version was bit-exact and ~6x slower than XLA (~12 ms vs
  ~2 ms at [4096, K=96]: the 16M scoped-VMEM limit forced 16-row tiles), so
  the JAX package keeps it default-off.

The rest are rejected-but-kept experiments: pipelines the JAX package
built, made exact, A/B benchmarked and found slower than the shipped path.
The JAX package keeps them default-off behind config flags with their
exactness tests; the port keeps the same flags and the same results. The
measured evidence below is TPU v5e history from the JAX package (PERF.md
rounds 3-4 there), not a statement about the H100:

* ``tiered`` — the two-plane movegen and actor pipeline (a narrow plane at
  tier widths and a full-fidelity wide plane on a compacted sub-batch; the
  merged [B, a_max, 52] move tensor is never built) and the two-tier
  doubles expansion (``dd_tier``). Exact up to surfaced overflow flags. On
  TPU v5e the 1-ply A/Bs lost: tiered ~8% slower than production, dd_tier
  (48, 112, 256) 211.6k vs 491.8k env-steps/s. Flags:
  ``MoveGenConfig.tiered``, ``.nd_tier``, ``.dd_tier`` (and ``train
  --tiered``).

The other, the value-first dedup of the 2-ply scorer's non-double replies
(``TwoPlyConfig.value_first_m``, default 0; TPU v5e: 9.1k vs 11.0k
env-steps/s), stays in ``twoply/expectimax.py`` behind its flag, as in JAX.
"""
