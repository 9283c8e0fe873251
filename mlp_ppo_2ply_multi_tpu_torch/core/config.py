"""Typed configuration for the framework.

Default hyperparameter values replicate the reference's flat constants module
(reference src/config/configuration.py:1-25) so that runs are
comparable; unlike the reference these are real dataclasses with per-run
overrides instead of star-imported module globals.

Reference quirk ledger (SURVEY.md §7.1):
  Q1  hidden size defaults to 128 (the value actually used everywhere in the
      reference), not the dead HIDDEN_SIZE=256 constant.
  Q2  ``per_episode_updates=True`` reproduces the reference's 200 sequential
      Adam steps per training batch (trainer.py:81-139); False enables the
      fused batched update (fast mode).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    input_size: int = 198  # reference policy_network.py:36
    hidden_size: int = 128  # Q1: reference default, policy_network.py:36
    # 'sigmoid' matches reference policy_network.py:67; 'relu' is the
    # commented-out alternative at :68.
    activation: str = "sigmoid"
    # Compute dtype for the value-net forward pass. float32 by default for
    # checkpoint-parity; bfloat16 for peak MXU throughput.
    dtype: str = "float32"
    # Use the fused board->value kernel (ops/fused_value.py) for the actor's
    # candidate evaluation: no [B, A, 198] feature tensor. bfloat16-class
    # numerics (see module docstring); the learner and f32 parity paths are
    # unaffected. The port's 1-ply split-planes actor requires it; its 2-ply
    # scorer requires it on a card (off, the scorer runs encode + forward,
    # on the CPU only: the f32 parity path).
    fused_actor_kernel: bool = False
    # Two-tier actor candidate evaluation (PERF.md round 2): > 0 compacts
    # each game's valid candidates (order-preserving) to this many slots for
    # the value forward + sampling; games with more legal moves than the tier
    # width are gathered into a batch/actor_tier_wide_div sub-batch evaluated
    # at full width. Exact: narrow games see their complete move set, wide
    # games go through the wide path (audited P(count > 96) = 2.4%: at
    # B=4096 the wide demand is mean~98, sigma~9.8, so a batch/16 = 256-slot
    # sub-batch sits ~16 sigma above the mean demand; an
    # overflow would fall back to the truncated narrow tier AND raise the
    # overflow flag). 0 = evaluate all presented slots directly.
    actor_tier_width: int = 0
    actor_tier_wide_div: int = 16
    # When set (inside shard_map over a mesh axis with this name), the hidden
    # layer is tensor-parallel: w1/b1 are column-sharded, w2 row-sharded, and
    # the head matmul's partial sums are reduced with psum over this axis.
    model_axis: Optional[str] = None
    # A deep net: the widths of its hidden layers, in order (empty: the
    # single hidden layer of ``hidden_size``, Tesauro's net). Its params are
    # w1, b1, ..., w{n+1}, b{n+1}; its hidden layers take ReLU, and its
    # output layer is the outcomes6 head: six logits over win normal/gammon/
    # backgammon, lose normal/gammon/backgammon, the value softmax(z) .
    # OUTCOME_VALUES (Tesauro's net has one linear output).
    hidden_sizes: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.activation not in ("sigmoid", "relu"):
            raise ValueError(f"activation must be sigmoid or relu, got {self.activation!r}")
        if self.deep and self.activation != "relu":
            raise ValueError("a deep net (hidden_sizes) takes ReLU")

    @property
    def deep(self) -> bool:
        """Whether this is a net of ``hidden_sizes`` (not Tesauro's)."""
        return bool(self.hidden_sizes)

    @classmethod
    def wildbg(cls, **kw) -> "ModelConfig":
        """wildbg's value net (github.com/carsten-wenderdel/wildbg, its
        training model's ``class Network``) on the 198 Tesauro features:
        198 -> 300 -> 250 -> 200 -> 6, ReLU, a softmax over the six
        outcomes, valued by ``OUTCOME_VALUES``."""
        return cls(hidden_sizes=(300, 250, 200), activation="relu", **kw)


# ModelConfig's fields of the deep net, which the JAX package's lacks
DEEP_NET_FIELDS = ("hidden_sizes",)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    # NOTE: the reference's 500-move action cap (backgammon_env.py:35,
    # max_legal_moves) lives in MoveGenConfig.a_max here — the presented-
    # action axis IS the cap in a fixed-shape program, and one knob beats two
    # that can disagree. The pure-python OracleEnv keeps a literal
    # max_legal_moves=500 because it mirrors the reference exactly.
    # Episode step cap (reference configuration.py:4 MAX_TIMESTEPS; note the
    # reference counts env.step calls including auto-passes, worker.py:101).
    max_timesteps: int = 300
    # Rewards, reference backgammon_env.py:20-26.
    reward_pass: float = 0.0
    reward_invalid: float = -1.0
    reward_win_normal: float = 1.0
    reward_win_gammon: float = 2.0
    reward_win_backgammon: float = 2.5
    reward_close_out: float = 0.30
    reward_five_prime: float = 0.20
    # One-time shaping rewards per player per game (backgammon_env.py:196-213).
    shaping_rewards: bool = True

    def outcome_values(self) -> Tuple[float, ...]:
        """The side-to-move-0 value of each of the six outcomes: win normal,
        gammon, backgammon, then the same lost."""
        w = (self.reward_win_normal, self.reward_win_gammon, self.reward_win_backgammon)
        return w + tuple(-x for x in w)


# what the outcomes6 head values its outcomes by: the default win rewards. The
# kernels take the params alone, so a Config with other win rewards is refused
# for a deep net (``Config.__post_init__``).
OUTCOME_VALUES = EnvConfig().outcome_values()


@dataclasses.dataclass(frozen=True)
class MoveGenConfig:
    """Width caps for the fixed-shape move enumerator.

    The reference enumerates moves with unbounded Python recursion
    (handle_move_types.py); a fixed-shape XLA program needs static caps.
    Caps are validated empirically by randomized audit
    (scripts/audit_widths.py); exceeding a cap drops the highest-rank
    (latest in reference enumeration order) candidates, which is exactly the
    truncation the reference's 500-move env cap applies at the end
    (backgammon_env.py:262-272). Every width-cap hit is surfaced at runtime:
    MoveSet.overflow -> the width_overflow_count training metric.
    """

    # Doubles level-wise frontier widths (unique boards after k submoves).
    w1: int = 16  # <= 15 origins with checkers is a hard bound
    w2: int = 128
    w3: int = 288
    w4: int = 512
    # Final presented-action cap — THE Q7 cap (reference max_legal_moves=500,
    # backgammon_env.py:35,:262-272). Default 512 = the next lane-tile
    # multiple above 500: the extra 12 slots only ever ADD presented moves
    # the reference would have truncated, and keep the action axis MXU/VPU
    # tile-aligned. Audit (scripts/audit_widths.py, 105k decisions): the
    # level-4 doubles frontier exceeds 500 (max 653) only in SYNTHETIC
    # max-race positions; randomized-play maxima sit far below 448. Since Q7
    # presents only the first 500 in enumeration order, any w4 >= 500 keeps
    # the presented set exact regardless of the true level-4 width.
    a_max: int = 512
    # Enumeration engine: "canonical" (sortless, fast; doubles in canonical
    # rather than reference-DFS order — identical move SETS) or "sorted"
    # (exact reference insertion order everywhere; slower: its dedup sorts
    # every candidate of every level).
    algo: str = "canonical"
    # Canonical engine: non-doubles candidates are compacted to this many
    # slots before the pairwise first-occurrence dedup; bounds the pre-dedup
    # candidate count (<= ~600 theoretical worst case, <100 typical).
    nd_dedup_k: int = 576
    # Canonical engine: when > 0, doubles enumeration runs on a compacted
    # sub-batch of batch/div games (only ~1/6 of games roll doubles with fair
    # dice). ONLY safe for iid dice — callers that evaluate a fixed roll for
    # every game (the 2-ply scorer) must use 0 (full batch). Default 3 keeps
    # overflow probability ~30 sigma below ever happening at batch >= 1024.
    dd_subbatch_div: int = 3
    # Canonical engine: when > 0, the whole non-doubles tail (candidate
    # select, afterstate takes, dedup, filters — movegen2._nd_tail) runs
    # two-tier: at width nd_tier for every game (exact when the pre-dedup
    # count fits), plus a full nd_dedup_k-width pass over a
    # batch/nd_wide_div sub-batch of the games whose pre-dedup count exceeds
    # the tier. Measured production count distribution: p50=14,
    # P(count>96)=2.4% (PERF.md round 2), so tier 96 / div 8 gives ~40 sigma
    # of sub-batch headroom at batch 4096; an overflow keeps the exact
    # tier-width prefix and is surfaced via MoveSet.overflow. 0 = single
    # full-width pass.
    nd_tier: int = 0
    nd_wide_div: int = 8
    # Plane-form actor pipeline (movegen2.SplitMoves): the actor consumes
    # the three natural enumeration planes directly and the padded merged
    # [B, W, 52] move tensor is never materialized. Sampling-bit-identical
    # to the merged path (tests/test_split_planes.py); requires nd_tier > 0,
    # dd_subbatch_div > 0 and the tiered fused actor. Rollout-only switch:
    # parity/eval consumers (play, trajectory parity, 2-ply) keep MoveSet.
    split_planes: bool = False
    # Canonical engine: first-occurrence dedup via canonical delta SIGNATURES
    # instead of the board-Gram matmul. A candidate's afterstate differs from
    # the root by (net mover cell-delta multiset, hit-cell multiset), both
    # computable from its <= 2 submove (start, end, hit) params; packed into
    # one int32, signature equality <=> board equality BY CONSTRUCTION (the
    # signature IS the delta in canonical form — leapfrogs, chains, bear-off
    # collapses and hit bookkeeping all fall out, no pattern enumeration).
    # Replaces pack_board + the [.., K, K] Gram (the top device-trace op,
    # ~1.8ms/step at B=4096) with an int compare. False = Gram path
    # (movegen2._dup_earlier_mask), kept for A/B and as a fallback.
    nd_sig_dedup: bool = True
    # In the JAX package: run the single-pass non-doubles tail as one fused
    # Pallas kernel. Kept so that configs read the same; the port ignores
    # it: its single-pass tail and both tiers of the two-tier tail always go
    # through experimental/nd_tail.nd_tail_fused with signature dedup (the
    # CUDA kernel on a card, the bit-identical plain version on the CPU).
    nd_tail_kernel: bool = False
    # Two-tier doubles expansion inside legal_moves' compacted sub-batch:
    # when non-empty, (t2, t3, t4) narrow level widths run for EVERY doubles
    # game (exact whenever no level overflows — every _expand reports
    # n_children > width BEFORE truncating), and games flagged by the narrow
    # run's MoveSet.overflow re-run at the full w2/w3/w4 on a
    # sub_batch/dd_wide_div sub-sub-batch. A wide game beyond that capacity
    # keeps the narrow result and stays overflow-flagged. () = single
    # full-width chain. Size from scripts/probe_dd_widths.py.
    dd_tier: Tuple[int, int, int] = ()
    dd_wide_div: int = 8
    # Tiered pipeline (experimental.tiered.legal_moves_tiered + actor fast path): the
    # legal-move set stays two-plane — narrow width-nd_tier plane for every
    # game, full-fidelity legal_moves on a batch/tiered_wide_div sub-batch
    # for the games the narrow enumeration flags — and the merged
    # [B, a_max, 52] move tensor never materializes. Requires nd_tier,
    # dd_tier and the fused actor kernel; 1-ply rollout only (the 2-ply
    # scorer and parity paths keep the merged MoveSet).
    tiered: bool = False
    tiered_wide_div: int = 8

    @classmethod
    def fast(cls) -> "MoveGenConfig":
        """Reduced widths for production throughput, sized above the maxima
        observed in randomized play (scripts/audit_widths.py, 1000 games +
        4000 synthetic adversarial positions = 105k decisions: randomized
        pre-dedup non-doubles max 214 < cap 288; doubles levels max
        [11, 60, 224, 653] of [16, 96, 224, 448] — only SYNTHETIC max-race
        positions exceed w3/w4). Positions beyond these widths lose their
        highest-rank candidates — the same truncation class as the
        reference's own 500-move cap (Q7) — and every such event is counted
        (MoveSet.overflow -> metrics width_overflow_count). a_max == w4: the
        level-4 doubles frontier (the widest source) has only w4 slots, so a
        larger presented-action axis can never fill and is pure padding.

        dd_subbatch_div=4: at the production batch (4096) the doubles count
        is Binomial(B, 1/6) — B/4 slots sit 14 sigma above the mean, and an
        overflow is no longer silent (MoveSet.overflow)."""
        return cls(
            w1=16, w2=96, w3=224, w4=448, a_max=448, nd_dedup_k=288,
            dd_subbatch_div=4, nd_tier=96, nd_wide_div=8, split_planes=True,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_games: int = 256  # parallel games per rollout (reference: 7 procs x 1 game)
    episodes_per_update: int = 200  # reference configuration.py:7 MIN_EPISODES_TO_TRAIN
    total_episodes: int = 10_000_000  # reference configuration.py:5
    gamma: float = 0.99  # reference configuration.py:15
    learning_rate: float = 1e-3  # reference configuration.py:17
    grad_clip: float = 1.0  # reference configuration.py:18
    # LR decay hooks (reference configuration.py:19-20; DEAD there — stored
    # in Trainer.__init__:36-37, never applied). Live here: lr_decay < 1.0
    # decays the Adam learning rate by that factor every lr_decay_steps
    # optimizer steps. Default 1.0 = off, matching the reference's EFFECTIVE
    # behavior (constant LR).
    lr_decay: float = 1.0
    lr_decay_steps: int = 100_000
    # Q2: True = reference-parity sequential per-episode Adam steps.
    per_episode_updates: bool = True
    # Q3 fix-behind-flag (measured in RESULTS.md):
    #   "reference" — the reference's positive bootstrap from the opponent's
    #     successor (trainer.py:111-116). Trains a "someone wins soon"
    #     progress signal; the reference's own 2.1M-episode checkpoint wins
    #     only ~48% vs RANDOM. Default, for learning-curve parity.
    #   "negamax" — target = r - gamma*V(next) (player-aware). Demands sign
    #     alternation that the 2-bit side flag cannot anchor in practice; a
    #     perspective-blind net resolves it with parity heuristics and
    #     learns to LOSE (~3% vs random measured). Kept as a documented
    #     negative result.
    #   "side0" — TD-Gammon semantics: V estimates side-0's outcome, rewards
    #     signed by mover, no bootstrap flip; the actor maximizes for side 0
    #     and minimizes for side 1.
    td_mode: str = "reference"
    # Temperature schedule (reference configuration.py:23-25 and
    # parameter_manager.py:93-111: linear in the update counter).
    initial_temperature: float = 1.5
    final_temperature: float = 0.5
    temperature_decay_updates: int = 4000
    # Rollout style: 'sync' freezes finished games until the whole batch's
    # episodes complete (episode semantics identical to the reference);
    # 'continuous' auto-resets finished games so every lockstep step does
    # useful work (fast mode; episodes become buffer segments).
    rollout_mode: str = "sync"
    seed: int = 0
    checkpoint_every_episodes: int = 50_000  # reference configuration.py:6
    checkpoint_dir: str = "checkpoints"
    metrics_dir: str = "runs"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The value net is tiny (198->128->1) so data
    parallelism over the game batch is the only profitable axis
    (SURVEY.md §2.2); tensor/pipeline/sequence/expert axes are structurally
    inapplicable to this model family but the axis names are reserved so the
    same code path compiles on richer meshes."""

    data: int = 1
    model: int = 1
    axis_names: Tuple[str, ...] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class TwoPlyConfig:
    """2-ply expectimax scorer (reference two_ply.py:44-150, Q13)."""

    enabled: bool = False
    alpha: float = 1.0  # weight on own afterstate value (two_ply.py:50)
    beta: float = 0.9  # weight on opponent expected response (two_ply.py:51)
    top_k_candidates: int = 4  # rerank the top-4 1-ply moves (two_ply.py:67-70)
    top_n_responses: int = 5  # mean of top-5 opponent values (two_ply.py:136-142)
    # reference subsamples [1,1],[2,2],[3,3] to 50 moves via random.sample
    # (two_ply.py:119-121); we keep the *first* 50 in enumeration order so the
    # scorer is deterministic (documented divergence).
    small_double_cap: int = 50
    # Afterstate cap for opponent-reply enumeration inside the scorer.
    reply_a_max: int = 128
    # Two-tier reply tail (MoveGenConfig.nd_tier applied to the scorer's
    # fixed-roll enumeration). Unlike iid play dice, the wide-game fraction
    # here is ROLL-CORRELATED — one scan iteration evaluates the same roll
    # for every (game, candidate), and a high roll widens all of them at
    # once — so the sub-batch divisor must cover the worst per-roll wide
    # fraction (probe: scripts/probe_reply_widths.py). 0 disables.
    reply_nd_tier: int = 0
    reply_wide_div: int = 2
    # Rolls evaluated per scan iteration (folded into the batch axis).
    # Measured on v5e at B=1024: chunk 3 is ~7% SLOWER than 1 (the per-roll
    # program already fills the chip at rerank batch >= ~4k rows); raise it
    # only for small-batch interactive use.
    roll_chunk: int = 1
    # Unroll the 21 per-roll reply evaluations into one flat program instead
    # of two lax.scans: a scan SERIALIZES iterations, while the unrolled
    # graph lets XLA overlap independent rolls' fusions and hoist
    # roll-invariant work. Identical numerics (same accumulation order).
    # Requires roll_chunk <= 1 and value_first_m == 0; those paths keep the
    # scan. Compiles ~21x more HLO for the scorer body.
    unroll_rolls: bool = True
    # Per-die doubles reply widths, dies 1..6 -> (w2, w3, w4, a_max); ()
    # keeps reply_movegen_cfg's uniform widths. Only read by the unrolled
    # scorer (each die is a static program there). Motivation: the one-hot
    # take at [rows, K, W] is the dominant movegen cost and scales K*W,
    # while per-die reply frontiers differ wildly (probe_reply_widths:
    # presented p99 at [1,1]=298-capped-at-50 ... [6,6]=115). Dies 1-3 carry
    # the reference's 50-reply cap (Q13), so a_max=64 covers the cap
    # exactly; any level-frontier overflow beyond these widths is surfaced
    # via the scorer's inexact flag — the same truncation class as
    # reply_a_max itself.
    dd_reply_widths: Tuple[Tuple[int, int, int, int], ...] = ()
    # Per-roll non-doubles reply dedup/present widths, one int per nd roll in
    # ROLLS order ((1,2),(1,3),(1,4),(1,5),(1,6),(2,3),(2,4),(2,5),(2,6),
    # (3,4),(3,5),(3,6),(4,5),(4,6),(5,6)); () keeps reply_a_max for all.
    # Only read by the unrolled scorer. Sizing: per-roll PRE-dedup counts
    # (probe_reply_widths, randomized play) run p99 91-122 depending on the
    # roll — low rolls enumerate wider — while presented maxima stay <= 81.
    # Truncation beyond a roll's width drops the latest-enumerated
    # candidates (the reference's own Q7 class) and surfaces via the scorer
    # inexact flag.
    nd_reply_widths: Tuple[int, ...] = ()
    # Value-first dedup for non-double replies (0 disables): the scorer only
    # needs the top-5 DISTINCT reply values, and duplicate boards carry
    # bit-equal values — so instead of the reference-order first-occurrence
    # dedup over all reply_a_max slots (an O(A^2) Gram + epilogue per roll),
    # take the top-M replies BY VALUE, dedup just those (O(M^2)), and keep
    # the max-submove filter exact via the closed-form has_pair
    # (movegen2.nd_has_pair_exact). Exact whenever >= top_n_responses of the
    # top-M survive dedup — i.e. unless > M - top_n_responses of the M
    # highest-valued replies are duplicates; games where that fails are
    # flagged (scorer inexact flag). Must be >= top_n_responses. Sizing: a
    # submove pair legal in both orders is enumerated by BOTH passes, so
    # typical duplicate multiplicity is 2 (occasionally 3+ via leapfrog
    # collisions); 16 covers multiplicity 3 for the top 5.
    # DEFAULT 0 (off): the TPU A/B (bench_r2_sweep twoply vs twoply_vf0,
    # v5e B=1024) measured value-first at 9.1k env-steps/s vs 11.0k plain —
    # the per-roll top-M select + one-hot regather costs more than the sig-
    # dedup it avoids. Kept as an option; exactness test stays green.
    value_first_m: int = 0

    @classmethod
    def tuned(cls) -> "TwoPlyConfig":
        """The production 2-ply scorer (single authority; bench.py and
        apps/evaluate --twoply-tuned both import this): unrolled rolls and
        per-die doubles reply widths — small doubles carry the reference's
        50-reply cap (Q13) so a 64-wide enumeration covers it; big doubles
        keep the 128 cap; level-width truncation surfaces via the scorer
        flag. nd replies at width 96 (default 128): measured on 4096 live
        (game, candidate) rows, 3.1% of E[opp] scores change at all, max
        |delta| 0.0017 on a [0.16, 1.11] score scale — far below the
        sampling temperature (+8% step rate). Quality guard: RESULTS.md
        "2-ply vs 1-ply" (tuned 58.0% vs exact 56.0% vs 1-ply greedy).
        Measured at B=1024 on v5e: 92.2 -> 73.8 ms/step vs the round-3 scan
        scorer (probe_twoply_phases / PERF.md round 4)."""
        return cls(
            enabled=True,
            dd_reply_widths=((64, 96, 64, 64),) * 3 + ((64, 128, 128, 128),) * 3,
            reply_a_max=96,
        )


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    movegen: MoveGenConfig = dataclasses.field(default_factory=MoveGenConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    twoply: TwoPlyConfig = dataclasses.field(default_factory=TwoPlyConfig)

    def __post_init__(self) -> None:
        if self.model.deep and self.env.outcome_values() != OUTCOME_VALUES:
            raise ValueError(
                f"the outcomes6 head values outcomes by {OUTCOME_VALUES}; env's win rewards "
                f"give {self.env.outcome_values()}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def production(cls) -> "Config":
        """Throughput configuration (the bench.py headline config): the
        audit-validated fast movegen widths (MoveGenConfig.fast, ~2x above
        observed maxima — same truncation class as the reference's own
        500-move cap, Q7) and a bfloat16 value-net forward with the fused
        board->value kernel (sampling tolerates bf16; checkpoint-parity eval
        stays f32)."""
        return cls(
            movegen=MoveGenConfig.fast(),
            model=ModelConfig(
                dtype="bfloat16", fused_actor_kernel=True, actor_tier_width=96
            ),
        )

    @classmethod
    def production_twoply(cls) -> "Config":
        """Production actor config + the tuned 2-ply scorer
        (TwoPlyConfig.tuned — see its docstring for the measured deltas and
        the quality guard)."""
        return cls.production().replace(twoply=TwoPlyConfig.tuned())
