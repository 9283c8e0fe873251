"""The fused_value kernel's parameter operands, on the CPU: G packed in the
layout the kernel's wgmma descriptor reads (``pack_g`` / ``g_index_map``), the head
vector, and their cache keyed by the params tensors and their versions.

The CUDA kernel itself runs only on a card (tests/test_torch_kernel_gpu.py);
these tests hold what it is given to the layout it reads and to the plain
version's arithmetic. All comparisons are exact: packing only moves values.
"""
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_multi_tpu_torch.core.config import ModelConfig
from mlp_ppo_2ply_multi_tpu_torch.model import value_net as V
from mlp_ppo_2ply_multi_tpu_torch.ops import fused_value as fv


def _params(seed):
    return V.init_params(ModelConfig(), torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_g_reads_back_through_the_index_map(seed):
    g = fv.recombine_params(_params(seed))[0]
    packed = fv.pack_g(g)
    idx = fv.g_index_map()
    assert packed.dtype == torch.bfloat16 and packed.shape == (fv.N_REP * fv.HIDDEN,)
    # the map is a permutation of G's flat indices
    assert torch.equal(torch.sort(idx).values, torch.arange(fv.N_REP * fv.HIDDEN))
    back = torch.empty_like(g).reshape(-1)
    back[idx] = packed
    assert torch.equal(back.reshape(g.shape), g)


def test_index_map_is_the_wgmma_descriptor_layout():
    """Written from the wgmma shared-memory descriptor of a K-major B without
    swizzle, one element at a time: in k step s (4,096 bytes from the
    start), G[16s + kk, n] lies in the 8 x 8 core matrix (n // 8, kk // 8)
    at byte (n // 8) * SBO + (kk // 8) * LBO + (n % 8) * 16 + (kk % 8) * 2,
    with LBO = 128 (along K) and SBO = 256 (along N), kLBO and kSBO in
    csrc/fused_value.cu."""
    lbo, sbo = 128, 256
    src = fv._SRC.read_text()
    assert f"constexpr int kLBO = {lbo};" in src and f"constexpr int kSBO = {sbo};" in src
    g = torch.arange(fv.N_REP * fv.HIDDEN, dtype=torch.float32).reshape(fv.N_REP, fv.HIDDEN)
    packed = g.reshape(-1)[fv.g_index_map()]
    for s in range(fv.N_REP // 16):
        for kk in range(16):
            for n in range(fv.HIDDEN):
                byte = 4096 * s + (n // 8) * sbo + (kk // 8) * lbo + (n % 8) * 16 + (kk % 8) * 2
                assert packed[byte // 2] == g[16 * s + kk, n]


def test_pack_params_head_and_the_plain_arithmetic():
    """The head holds b1', b1' + tflip, w2 (its bf16 value) and b2; the plain
    arithmetic on the unpacked operands gives fused_value_plain exactly."""
    params = _params(3)
    g, b1p, tflip, w2r, b2 = fv.recombine_params(params)
    gpack, head = fv.pack_params(params)
    h = fv.HIDDEN
    assert head.dtype == torch.float32 and head.shape == (3 * h + 1,)
    assert torch.equal(head[:h], b1p[0]) and torch.equal(head[h:2 * h], (b1p + tflip)[0])
    assert torch.equal(head[2 * h:3 * h], w2r.float()[0]) and torch.equal(head[3 * h:], b2)

    rng = np.random.default_rng(0)
    boards = torch.from_numpy(rng.integers(-128, 128, (300, 52)).astype(np.int8))
    boards[:200] = torch.from_numpy(rng.integers(0, 16, (200, 52)).astype(np.int8))
    flag = torch.from_numpy(rng.integers(0, 2, 300))
    gu = torch.empty(fv.N_REP * h, dtype=torch.bfloat16)
    gu[fv.g_index_map()] = gpack
    r = torch.clamp(boards.float()[:, :, None] - torch.arange(4.0), min=0).reshape(-1, fv.N_REP)
    z = r @ gu.reshape(fv.N_REP, h).float()
    bias = torch.where((flag == 0)[:, None], head[:h], head[h:2 * h])
    hid = torch.sigmoid(z + bias).to(torch.bfloat16).float()
    out = (hid @ head[2 * h:3 * h, None])[:, 0] + head[3 * h:]
    assert torch.equal(out, fv.fused_value_plain(boards, flag, params))


def test_packed_params_cache_follows_identity_and_version():
    params = _params(4)
    a = fv.packed_params(params)
    b = fv.packed_params(params)
    assert a[0] is b[0] and a[1] is b[1]
    # an in-place update (a learner's step) repacks
    with torch.no_grad():
        params["w1"].add_(0.25)
    c = fv.packed_params(params)
    assert c[0] is not a[0]
    assert torch.equal(c[0], fv.pack_params(params)[0])
    assert not torch.equal(c[0], a[0])
    with torch.no_grad():
        params["b2"].add_(1.0)
    d = fv.packed_params(params)
    assert torch.equal(d[1][-1:], params["b2"]) and d[1] is not c[1]
    # another parameter dict with the same values is packed anew, equal
    other = {k: v.clone() for k, v in params.items()}
    e = fv.packed_params(other)
    assert e[0] is not d[0] and torch.equal(e[0], d[0]) and torch.equal(e[1], d[1])
    assert fv.packed_params(other)[0] is e[0]


def test_packed_params_cache_keeps_each_parameter_set():
    """Parameter sets used in turn (a learner's params and an actor
    snapshot) are each packed once; past PACKED_SETS sets the least
    recently used one goes."""
    sets = [_params(10 + i) for i in range(fv.PACKED_SETS + 1)]
    first = [fv.packed_params(p) for p in sets[:2]]
    for _ in range(3):
        for p, ops in zip(sets[:2], first):
            got = fv.packed_params(p)
            assert got[0] is ops[0] and got[1] is ops[1]
    for p in sets[2:]:
        fv.packed_params(p)
    # sets[0] was the least recently used: repacked, equal; sets[-1] still kept
    assert fv.packed_params(sets[0])[0] is not first[0][0]
    assert torch.equal(fv.packed_params(sets[0])[0], first[0][0])
    last = fv.packed_params(sets[-1])
    assert fv.packed_params(sets[-1])[0] is last[0]


@pytest.mark.parametrize("opt", ["sgd", "adam", "adam_foreach"])
def test_packed_params_repack_after_an_optimizer_step(opt):
    """The contract a learner keeps: params change through the tensors
    themselves, so an optimizer's step bumps their versions and the next
    call packs the new values."""
    params = _params(20)
    ts = [params[k].requires_grad_() for k in ("w1", "b1", "w2", "b2")]
    make = {
        "sgd": lambda: torch.optim.SGD(ts, lr=0.1),
        "adam": lambda: torch.optim.Adam(ts, lr=1e-2, foreach=False),
        "adam_foreach": lambda: torch.optim.Adam(ts, lr=1e-2, foreach=True),
    }[opt]()
    before = fv.packed_params(params)
    for t in ts:
        t.grad = torch.ones_like(t)
    make.step()
    after = fv.packed_params(params)
    want = fv.pack_params({k: v.detach() for k, v in params.items()})
    assert after[0] is not before[0] and not torch.equal(after[0], before[0])
    assert torch.equal(after[0], want[0]) and torch.equal(after[1], want[1])
