"""The port's measurement tools and stage scopes on the CPU.

* Configs: ``scripts.bench_r2_sweep.variant_cfg`` of every JAX variant name
  (``prod_dd48x96x96`` and an ``@8192`` batch among them) and the benches'
  production configs equal JAX's ``scripts/bench_r2_sweep.py`` and root
  ``bench.py``, field by field. The variants JAX refuses under split planes
  (``tier0``, ``prod_notier``), the port refuses too.
* Scope names: the ``utils.profiling.scope`` names one reduced-width step
  enters equal the ``jax.named_scope`` names of the JAX step's lowered
  program, for the split 1-ply step, the merged one (``Config()``) and the
  tuned 2-ply step (lowered in a spawned interpreter: one JAX 2-ply
  lowering a process, tests/test_torch_twoply.py). Scopes, the profiler and
  the cost counter change no output.
* ``utils.cost``: a matmul's 2MKN flops, an f32 add's 12n bytes, the same
  count twice for one step, and each kernel counted once by its formula,
  whatever its route runs.
* ``utils.profiling``: stage tags and the attribution walk on a made-up
  trace.
* The tools: the bench's CPU smoke line, its state against ``rollout_loop``,
  ``bench_twoply`` at B = 8, ``bench_spmd`` at n = 1 on gloo, the sweep,
  the roofline's and trace_attr's CPU modes; without a card every tool
  raises.
"""
import dataclasses
import importlib.util
import json
import multiprocessing
import pathlib
import re
from types import SimpleNamespace

import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.actor import rollout
from mlp_ppo_2ply_multi_tpu_torch.core.config import Config, ModelConfig, MoveGenConfig
from mlp_ppo_2ply_multi_tpu_torch.core.tree import leaves
from mlp_ppo_2ply_multi_tpu_torch.env import vec_env
from mlp_ppo_2ply_multi_tpu_torch.experimental import nd_tail
from mlp_ppo_2ply_multi_tpu_torch.model import value_net
from mlp_ppo_2ply_multi_tpu_torch.engine import movegen2
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board
from mlp_ppo_2ply_multi_tpu_torch.ops import dd_expand, fused_value, mlp_value, nd_front, take_rows
from mlp_ppo_2ply_multi_tpu_torch.scripts import (
    bench,
    bench_r2_sweep,
    bench_spmd,
    bench_twoply,
    roofline,
    trace_attr,
)
from mlp_ppo_2ply_multi_tpu_torch.utils import cost, profiling
from tests.config_view import jax_asdict
from tests.test_torch_twoply import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_split_planes.py's reduced widths
SMALL = dict(w1=16, w2=32, w3=48, w4=64, a_max=64, nd_dedup_k=48, nd_tier=16, nd_wide_div=4,
             dd_subbatch_div=3)
# every jax.named_scope name of the JAX package
JAX_SCOPE = re.compile(r"nd_tail_t\d|nd_front|nd_tail|slotv|sel|take|dd_L\d|mg_merge|act_t\d"
                       r"|env_step|score|ndpass|nd\d\d|dd\d")
VARIANTS = ("prod", "tier0", "tiered", "prod_dd", "prod_dd48x96x96", "split", "prod_notier",
            "prod_gram", "twoply", "twoply_tuned", "twoply_scan", "twoply_vf0", "twoply_vf16",
            "twoply_tier")
B = 32


def small_config(name: str):
    """The three configurations of the scope test at the reduced widths."""
    if name == "merged":
        return Config(movegen=MoveGenConfig(**{k: SMALL[k] for k in
                                               ("w1", "w2", "w3", "w4", "a_max")}))
    cfg = Config.production() if name == "prod" else Config.production_twoply()
    cfg = cfg.replace(movegen=dataclasses.replace(cfg.movegen, **SMALL))
    if name == "prod":
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, actor_tier_width=16,
                                                    actor_tier_wide_div=4))
    return cfg


def _jax_config(name: str):
    """The JAX package's counterpart of ``small_config(name)``."""
    from mlp_ppo_2ply_multi_tpu.core import config as jc

    port = small_config(name)
    return jc.Config(
        model=jc.ModelConfig(**jax_asdict(port.model)),
        movegen=jc.MoveGenConfig(**dataclasses.asdict(port.movegen)),
        twoply=jc.TwoPlyConfig(**dataclasses.asdict(port.twoply)),
    )


def jax_scope_names(name: str):
    """The named_scope names in the lowered JAX rollout step of
    ``small_config(name)`` (its locations' name stacks)."""
    import jax
    import jax.numpy as jnp

    from mlp_ppo_2ply_multi_tpu.actor import rollout as jr
    from mlp_ppo_2ply_multi_tpu.env import vec_env as jv
    from mlp_ppo_2ply_multi_tpu.learner import td as jtd

    cfg = _jax_config(name)
    key = jax.random.PRNGKey(0)
    params = jtd.init_train_state(key, cfg).params
    state = jv.reset(key, B)
    step = jax.jit(lambda p, s, k: jr.rollout_step(p, s, k, jnp.float32(1.0), cfg, True)[0])
    text = step.lower(params, state, key).as_text(debug_info=True)
    return sorted({part for loc in re.findall(r'loc\("([^"]*)"', text)
                   for part in loc.split("/") if JAX_SCOPE.fullmatch(part)})


def spawned_jax_scope_names(name: str):
    """``jax_scope_names`` in a fresh (spawned) interpreter, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax_scope_names(name)


@pytest.fixture(scope="module", autouse=True)
def jax_twoply_job():
    """JAX's 2-ply step lowered in a spawned interpreter, started before the
    module's first test so that it compiles while the others run."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1, maxtasksperchild=1) as pool:
        yield pool.apply_async(spawned_jax_scope_names, ("twoply",))


def _setup(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return value_net.init_params(cfg.model, g, "cpu"), vec_env.reset(B, g, device="cpu")


def _step(params, state, cfg):
    gen = torch.Generator().manual_seed(1)
    return rollout.rollout_step(params, state, 1.0, cfg, True, gen=gen, device="cpu")


def _entered(cfg):
    """(the JAX scope names one step enters, its output)."""
    from torch.profiler import ProfilerActivity, profile

    params, state = _setup(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _step(params, state, cfg)
    names = {e.name for e in prof.events() if e.is_user_annotation}
    return sorted(n for n in names if JAX_SCOPE.fullmatch(n)), out


def _assert_same(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_bench_r2_sweep",
                                                  ROOT / "scripts" / "bench_r2_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_cfg_equals_jax(name):
    assert (jax_asdict(bench_r2_sweep.variant_cfg(name))
            == dataclasses.asdict(_jax_sweep().variant_cfg(name)))


def test_production_configs_and_batch_suffix_equal_jax():
    import bench as jax_bench  # the JAX package's headline, root bench.py

    assert (jax_asdict(bench.production_config())
            == dataclasses.asdict(jax_bench.production_config()))
    assert (jax_asdict(bench.production_twoply_config())
            == dataclasses.asdict(jax_bench.production_twoply_config()))
    cfg, b, s, warm = bench_r2_sweep.plan("prod@8192", 4096, 30, 1024, 8)
    assert (b, s, warm) == (8192, 30, 8) and cfg == bench_r2_sweep.variant_cfg("prod")
    cfg, b, s, warm = bench_r2_sweep.plan("twoply@4096", 4096, 30, 1024, 8)
    assert (b, s, warm) == (4096, 8, 3) and cfg.twoply.enabled
    assert bench_r2_sweep.plan("twoply_tuned", 4096, 30, 1024, 8)[1:] == (1024, 8, 3)
    with pytest.raises(SystemExit):
        bench_r2_sweep.variant_cfg("nope")


@pytest.mark.parametrize("name", ["tier0", "prod_notier"])
def test_variants_refused_under_split_planes_as_in_jax(name):
    """JAX's split-plane step asserts a tiered tail and a tiered actor, so
    these two variants of its sweep cannot run there; the port raises."""
    import jax

    from mlp_ppo_2ply_multi_tpu.actor import rollout as jr
    from mlp_ppo_2ply_multi_tpu.env import vec_env as jv
    from mlp_ppo_2ply_multi_tpu.learner import td as jtd

    jcfg = _jax_sweep().variant_cfg(name)
    key = jax.random.PRNGKey(0)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: jr.rollout_step(jtd.init_train_state(key, jcfg).params,
                                               jv.reset(key, 16), key, 1.0, jcfg, True))
    cfg = bench_r2_sweep.variant_cfg(name)
    params, state = _setup(cfg)
    with pytest.raises(ValueError):
        _step(params, state, cfg)


# ---------------------------------------------------------------------------
# stage scopes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["prod", "merged"])
def test_scope_names_equal_jax_1ply(name):
    got, _ = _entered(small_config(name))
    assert got == jax_scope_names(name)


def test_scope_names_equal_jax_twoply(jax_twoply_job):
    got, _ = _entered(small_config("twoply"))
    assert got == jax_twoply_job.get(timeout=600)


@pytest.mark.parametrize("name", ["prod", "twoply"])
def test_scopes_profiler_and_counter_change_no_output(name):
    cfg = small_config(name)
    params, state = _setup(cfg)
    plain = _step(params, state, cfg)
    _, profiled = _entered(cfg)
    _assert_same(plain, profiled)
    _assert_same(plain, cost.step_cost(_step, params, state, cfg).out)
    assert profiling.scopes() == ()


# ---------------------------------------------------------------------------
# counts and tags
# ---------------------------------------------------------------------------


def test_cost_of_a_matmul_and_an_add():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    c = cost.step_cost(torch.matmul, a, b)
    assert c.flops == 2 * 3 * 5 * 7 and c.elementwise_ops == 0
    assert c.bytes == 4 * (3 * 5 + 5 * 7 + 3 * 7)
    n = 1000
    c = cost.step_cost(torch.add, torch.ones(n), torch.ones(n))
    assert (c.flops, c.elementwise_ops, c.bytes) == (0, n, 3 * 4 * n)
    # a broadcast input counts its distinct elements; a view moves nothing
    c = cost.step_cost(lambda x, y: (x + y[None]).view(-1), torch.ones(4, n), torch.ones(n))
    assert c.bytes == 4 * (4 * n + n + 4 * n)
    # one_hot's CPU bounds check (min, max, .item()) is no device work
    c = cost.step_cost(torch.nn.functional.one_hot, torch.arange(n) % 5, 5)
    assert set(c.by_tag) == {"aten::zeros", "aten::scatter_"}
    assert c.bytes == 8 * 5 * n + (8 * 5 * n + 8 * n + 8 * 5 * n)  # zeros, scatter_
    with profiling.scope("nd_front"), profiling.scope("score"), profiling.scope("take"):
        assert profiling.scopes() == ("nd_front", "score", "take")
        c = cost.step_cost(torch.neg, torch.ones(n))
    assert list(c.by_tag) == ["nd_front/take"]


def test_step_count_is_the_same_twice():
    cfg = small_config("prod")
    params, state = _setup(cfg)
    a = cost.step_cost(_step, params, state, cfg)
    b = cost.step_cost(_step, params, state, cfg)
    assert a.by_tag == b.by_tag and a.bytes > 0 and a.elementwise_ops > 0 and a.flops > 0
    # both fused_value launches counted by formula, under no stage (JAX
    # calls them outside act_t1 / act_t2)
    assert a.by_tag["fused_value_kernel"]["ops"] == 2
    assert {"nd_front", "nd_tail_t1", "nd_tail_t2", "act_t1", "env_step"} <= set(a.by_tag)


def _kernel_calls():
    g = torch.Generator().manual_seed(3)
    params = value_net.init_params(ModelConfig(), g, "cpu")
    boards = torch.randint(-3, 4, (64, 52), generator=g, dtype=torch.int8)
    flag = torch.randint(0, 2, (64,), generator=g)
    valid = torch.rand((16, nd_tail.N_CAND), generator=g) < 0.05
    kids = lambda: torch.randint(-2, 3, (16, 27, 52), generator=g, dtype=torch.int8)
    nd_args = (valid, kids(), kids(), torch.randint(-2, 3, (16, 52), generator=g,
                                                    dtype=torch.int8),
               torch.zeros(16, dtype=torch.int64), torch.full((16,), 5), torch.full((16,), 2),
               48, 64)
    tb = torch.randint(-5, 5, (8, 20, 52), generator=g, dtype=torch.int8)
    idx = torch.randint(-2, 22, (8, 12), generator=g)
    dd_cfg = MoveGenConfig(w1=4, w2=8, w3=12, w4=16, a_max=10)
    dd_args = (Board(vec_env.reset(6, g, "cpu").board.data), torch.arange(6) % 2,
               torch.arange(6) % 6 + 1, dd_cfg)
    deep = value_net.init_params(ModelConfig.wildbg(), g, "cpu")
    mask = torch.rand(64, generator=g) < 0.5
    nd_front_args = (Board(vec_env.reset(6, g, "cpu").board.data), torch.arange(6) % 2,
                     torch.tensor([[6, 1], [5, 3], [2, 4], [1, 1], [3, 6], [4, 2]]))
    return {
        "fused_value_kernel": (
            fused_value, "fused_value_plain", lambda: fused_value.fused_value(boards, flag, params),
            {"flops": fused_value.bound(boards)["ops"], "bytes": fused_value.bound(boards)["bytes"]}),
        "nd_tail_kernel": (
            nd_tail, "nd_tail_plain", lambda: nd_tail.nd_tail_fused(*nd_args),
            {"elementwise_ops": nd_tail.bound(valid, 48)["ops"],
             "bytes": nd_tail.bound(valid, 48)["bytes"]}),
        "take_rows_kernel": (
            take_rows, "take_rows_plain", lambda: take_rows.take_rows(tb, idx),
            {"bytes": take_rows.bound(tb, idx)["bytes"]}),
        "dd_expand_kernel": (
            movegen2, "enumerate_doubles_plain", lambda: movegen2.enumerate_doubles(*dd_args),
            {"bytes": dd_expand.bound(6, dd_expand.widths_of(dd_cfg))["bytes"]}),
        # the deep net's D2 through fused_value, counted over its valid rows
        "mlp_value_kernel": (
            mlp_value, "mlp_value_plain",
            lambda: fused_value.fused_value(boards, flag, deep, mask),
            {"flops": mlp_value.bound(int(mask.sum()))["ops"],
             "bytes": mlp_value.bound(int(mask.sum()))["bytes"]}),
        "nd_front_kernel": (
            movegen2, "nd_front_plain", lambda: movegen2.nd_front(*nd_front_args),
            {"bytes": nd_front.bound(6)["bytes"]}),
    }


@pytest.mark.parametrize("kernel", ["fused_value_kernel", "nd_tail_kernel", "take_rows_kernel",
                                    "dd_expand_kernel", "mlp_value_kernel", "nd_front_kernel"])
def test_kernels_counted_once_by_formula_whatever_the_route(kernel, monkeypatch):
    mod, plain_name, call, want = _kernel_calls()[kernel]
    want = {**dict.fromkeys(cost.COUNTS, 0.0), **want, "ops": 1.0}
    got = cost.step_cost(call)
    assert got.by_tag == {kernel: want}
    plain = getattr(mod, plain_name)

    def other_route(*args):  # a route with more ops (the card's lays out operands)
        args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        return plain(*args)

    monkeypatch.setattr(mod, plain_name, other_route)
    again = cost.step_cost(call)
    assert again.by_tag == got.by_tag
    for x, y in zip(leaves(got.out), leaves(again.out)):
        assert torch.equal(x, y)


def test_stage_tags_and_attribution_walk():
    tag = profiling.stage_tag
    assert tag(["device_stage_times", "nd21", "score", "nd_front"], "k") == "nd21/nd_front"
    assert tag(["device_stage_times", "aten::add"], "void kern<1>") == "void kern<1>"
    assert tag(["dd_L3", "take", "aten::gather"], "k") == "dd_L3/take"
    ev = lambda name, parent, kernels=(): SimpleNamespace(
        name=name, cpu_parent=parent,
        kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])
    root = ev("device_stage_times", None, [("fused_value_kernel", 500.0)])
    front = ev("nd_front", root)
    add = ev("aten::add", front, [("add_kernel", 1500.0), ("add_kernel", 500.0)])
    outside = ev("aten::mul", root, [("mul_kernel", 250.0)])
    stages, total = profiling.attribute_kernels([root, front, add, outside])
    assert stages == {"nd_front": (2.0, 2), "fused_value_kernel": (0.5, 1),
                      "mul_kernel": (0.25, 1)}
    assert total == 2.75
    assert trace_attr.unscoped_ms(stages) == 0.75
    assert trace_attr.outer_stages(stages) == {"nd_front": 2.0, "unscoped": 0.75}
    assert profiling.device_stage_times(lambda: torch.ones(2)).stages == {}
    # a scope's device span covers its kernels: not a device event of its own
    from torch.autograd import DeviceType

    kern = SimpleNamespace(device_type=DeviceType.CUDA, is_user_annotation=False)
    span = SimpleNamespace(device_type=DeviceType.CUDA, is_user_annotation=True)
    host = SimpleNamespace(device_type=DeviceType.CPU, is_user_annotation=False)
    assert profiling.device_events([kern, span, host]) == [kern]


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_bench_cpu_smoke_line(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    (out,) = _lines(capsys)
    assert out["metric"] == "env_steps_per_sec_cpu_1ply" and out["value"] > 0
    assert out["device"] == "cpu" and out["batch"] == 32
    assert not {"mfu", "achieved_bw_frac", "vs_baseline"} & set(out)


def test_bench_run_leaves_rollout_loops_state():
    cfg = Config(movegen=bench.SMOKE_MOVEGEN)
    r = bench.run(8, 4, warmup=2, cfg=cfg, chunk=2, device="cpu")
    assert r.steps == 8
    params, state, temp, gen = bench.setup(cfg, 8, torch.device("cpu"))
    want, _ = rollout.rollout_loop(params, state, temp, cfg, r.steps, True, gen=gen,
                                   device="cpu")
    _assert_same(r.state, want)


def test_bench_twoply_small(capsys):
    assert bench_twoply.main(["8", "1", "--device", "cpu"]) == 0
    (out,) = _lines(capsys)
    assert out["metric"] == "env_steps_per_sec_cpu_2ply" and out["batch"] == 8
    assert out["value"] > 0


def test_bench_spmd_one_gloo_rank(capsys):
    assert bench_spmd.main(["--device", "cpu"]) == 0
    (out,) = _lines(capsys)
    assert out["devices"] == 1 and out["per_device_batch"] == 16
    assert out["env_steps_per_s"] > 0 and out["device"] == "cpu"


def test_sweep_names_a_variant_it_cannot_run(capsys):
    rc = bench_r2_sweep.main(["--device", "cpu", "--batch", "16", "--steps", "1",
                              "--variants", "prod,tier0"])
    prod, tier0 = _lines(capsys)
    assert rc == 1 and prod["env_steps_per_s"] > 0
    assert tier0["variant"] == "tier0" and "nd_tier" in tier0["error"]


def test_roofline_and_trace_attr_cpu_modes(capsys, tmp_path):
    assert roofline.main(["oneply", "--device", "cpu", "--out", str(tmp_path / "r.json")]) == 0
    (out,) = _lines(capsys)
    assert out["workload"] == "1ply_production" and out["steps_per_disp"] == 4
    assert out["flops_per_disp"] > 0 and out["hbm_bytes_per_disp"] > 0
    assert not {"ms_per_step", "env_steps_per_s", "achieved_tflops", "achieved_gbs",
                "mfu_vs_datasheet", "bw_frac_vs_datasheet"} & set(out)
    assert json.loads((tmp_path / "r.json").read_text())["oneply"] == out
    assert trace_attr.main(["prod", "16", "12", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "prod B=16 on the CPU" in text and "nd_tail_t1" in text
    assert not re.search(r"\d ?ms\b", text)


def test_every_tool_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((bench.main, []), (bench_twoply.main, ["8", "1"]),
                       (bench_r2_sweep.main, ["--variants", "prod"]),
                       (bench_spmd.main, []), (roofline.main, ["peaks"]),
                       (trace_attr.main, ["prod", "16"])):
        with pytest.raises(RuntimeError):
            main(argv)
