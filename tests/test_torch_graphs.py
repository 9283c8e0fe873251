"""The cache of captured CUDA graphs that the rollout and the arena share,
and the tree helpers their graphs copy buffers with. The cache's logic is
plain Python, checked here with stand-ins for the graphs."""
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core import graphs, tree
from mlp_ppo_2ply_multi_tpu_torch.engine.board import Board


@pytest.fixture(autouse=True)
def _empty_cache():
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


def test_cached_graph_captures_once_a_key():
    made = []
    make = lambda: made.append(object()) or made[-1]
    g1, new1 = graphs.cached_graph(("rollout", 1), make)
    g2, new2 = graphs.cached_graph(("rollout", 1), make)
    assert new1 and not new2 and g1 is g2 and len(made) == 1
    assert len(graphs.GRAPHS) == 1


def test_cached_graph_bounds_rollout_and_match_graphs_together():
    """One budget for both kinds: the least recently used graph goes,
    whichever module captured it."""
    keys = [("rollout", 0), ("match", 0), ("rollout", 1), ("match", 1)]
    for k in keys:
        graphs.cached_graph(k, object)
    graphs.cached_graph(keys[0], object)  # used again: now the most recent
    _, new = graphs.cached_graph(("match", 2), object)
    assert new and len(graphs.GRAPHS) == graphs.GRAPH_SETS
    assert keys[1] not in graphs.GRAPHS and keys[0] in graphs.GRAPHS
    assert next(reversed(graphs.GRAPHS)) == ("match", 2)


def test_a_failed_capture_keeps_nothing():
    def fail():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        graphs.cached_graph(("match", 0), fail)
    assert len(graphs.GRAPHS) == 0


def test_params_signature_follows_storage_shape_and_strides():
    p = {"w1": torch.zeros(4, 3), "b1": torch.zeros(3)}
    sig = graphs.params_signature(p)
    assert graphs.params_signature(dict(reversed(list(p.items())))) == sig
    p["w1"].add_(1.0)  # an in-place update: the same graph reads it
    assert graphs.params_signature(p) == sig
    assert graphs.params_signature({**p, "w1": p["w1"].clone()}) != sig
    t = torch.zeros(3, 4).t()  # same storage size and shape, other strides
    assert graphs.params_signature({**p, "w1": t}) != graphs.params_signature(
        {**p, "w1": t.contiguous()})


def test_tree_helpers_walk_nested_named_tuples():
    from mlp_ppo_2ply_multi_tpu_torch.eval.arena import _Match

    m = _Match(_state(), torch.tensor([-1, 0], dtype=torch.int32))
    assert [t.shape for t in tree.leaves(m)] == [t.shape for t in tree.leaves(m.state)] + [(2,)]
    z = tree.tmap(torch.zeros_like, m)
    assert type(z) is _Match and type(z.state.board) is Board
    assert all(not t.any() for t in tree.leaves(z))
    tree.copy_into(z, m)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(z), tree.leaves(m)))


def _state():
    from mlp_ppo_2ply_multi_tpu_torch.env import vec_env

    return vec_env.reset(2, torch.Generator().manual_seed(0), device="cpu")
