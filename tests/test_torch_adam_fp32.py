"""The fp32 Adam update over many leaves (K3, ``ops/fused_adam_fp32.py``) on
the CPU: ``Adam.fused_apply``, which takes the kernel's plain version here,
against ``Adam.update`` followed by adding the updates, bit for bit; the
chunk table read with the kernel's index arithmetic; the checks a CUDA
launch makes; the launch counter's name. The kernel itself is held to the
per-leaf update on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import json
import math
import os

import numpy as np
import pytest
import torch

import multimodn_tpu_torch as tmm
from multimodn_tpu_torch import decoders as tdec
from multimodn_tpu_torch import encoders as tenc
from multimodn_tpu_torch.core.tree import tree_leaves, tree_map
from multimodn_tpu_torch.ops import fused_adam_fp32 as k3
from multimodn_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
WIDTHS = (5, 9, 4)
# Per step: None (ungated), or the per-encoder gates; encoder 1 stays off
# after the first step, so its moments must not move.
STEPS = {"ungated": [None, None, None],
         "gated": [None, [1.0, 0.0, 1.0], [0.0, 0.0, 1.0]]}


def _params():
    return tmm.MultiModN(
        6, [tenc.MIMICMLPEncoder(6, w, (8,), dropout=0.0) for w in WIDTHS],
        [tdec.MLPDecoder(6, (8,), 2), tdec.LogisticDecoder(6)], 1.0, 0.5,
        seed=2, device="cpu").params


def _grads(params, rng):
    return tree_map(lambda p: torch.from_numpy(
        rng.normal(size=tuple(p.shape)).astype(np.float32)), params)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(torch.int16 if a.element_size() == 2
                                         else torch.int32).numpy(),
                                  b.view(torch.int16 if b.element_size() == 2
                                         else torch.int32).numpy())


@pytest.mark.parametrize("state_dtype", [None, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", sorted(STEPS))
def test_fused_apply_equals_update_and_add(mode, state_dtype):
    params = _params()
    p_f, p_u = tree_map(torch.clone, params), tree_map(torch.clone, params)
    fused = tmm.Adam(LR, state_dtype=state_dtype)
    proto = tmm.Adam(LR, state_dtype=state_dtype)
    s_f, s_u = fused.init(p_f), proto.init(p_u)
    moments = [id(t) for t in tree_leaves([s_f["m"], s_f["v"]])]
    rng = np.random.default_rng(4)
    frozen = None
    for gates in STEPS[mode]:
        g = _grads(params, rng)
        tg = None if gates is None else torch.tensor(gates)
        if gates is not None and frozen is None:
            frozen = [t.clone() for t in tree_leaves(
                [s_f["m"]["encoders"][1], s_f["v"]["encoders"][1],
                 p_f["encoders"][1]])]
        before = k3.FUSED_ADAM_FP32.launches
        s_f = fused.fused_apply(g, s_f, p_f, enc_gates=tg)
        assert k3.FUSED_ADAM_FP32.launches == before
        upd, s_u = proto.update(g, s_u, p_u, enc_gates=tg)
        tree_map(lambda p, u: p.add_(u), p_u, upd)
    assert k3.FUSED_ADAM_FP32._lib is None
    # The moments were written in place, in their storage type.
    assert [id(t) for t in tree_leaves([s_f["m"], s_f["v"]])] == moments
    want = torch.float32 if state_dtype is None else state_dtype
    assert {t.dtype for t in tree_leaves([s_f["m"], s_f["v"]])} == {want}
    for a, b in zip(tree_leaves([p_f, s_f["m"], s_f["v"]]),
                    tree_leaves([p_u, s_u["m"], s_u["v"]])):
        _same(a, b)
    assert s_f["t"].item() == s_u["t"].item() == 3.0
    assert [t.item() for t in s_f["t_enc"]] == \
        [t.item() for t in s_u["t_enc"]]
    if mode == "gated":
        assert [t.item() for t in s_f["t_enc"]] == [2.0, 1.0, 3.0]
        for a, b in zip(frozen, tree_leaves(
                [s_f["m"]["encoders"][1], s_f["v"]["encoders"][1],
                 p_f["encoders"][1]])):
            _same(a, b)


def test_fused_apply_takes_and_ignores_cross_rank():
    params = _params()
    p_a, p_b = tree_map(torch.clone, params), tree_map(torch.clone, params)
    opt = tmm.Adam(LR)
    s_a, s_b = opt.init(p_a), opt.init(p_b)
    g = _grads(params, np.random.default_rng(1))
    s_a = opt.fused_apply(g, s_a, p_a)
    s_b = opt.fused_apply(g, s_b, p_b, cross_rank=(None, None))
    for a, b in zip(tree_leaves([p_a, s_a]), tree_leaves([p_b, s_b])):
        _same(a, b)


def _cell_shapes(config):
    from benchmark.reference import chain
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{config}.json")) as f:
        return [tuple(s) for _p, s, _i in chain.leaves(json.load(f))]


def _featurewise_shapes(n_encoders=1901):
    """The featurewise MIMIC model's leaves: the initial state, 1901
    ``MLPFeatureEncoder(50, 32)`` and one ``MLPDecoder(50, (32, 32), 2)``,
    read from a two-encoder model of the same modules."""
    params = tmm.MultiModN(
        50, [tenc.MLPFeatureEncoder(50, 32) for _ in range(2)],
        [tdec.MLPDecoder(50, (32, 32), 2)], 1.0, 0.0, device="cpu").params

    def shapes(tree):
        return [tuple(t.shape) for t in tree_leaves(tree)]
    return (shapes(params["init_state"])
            + shapes(params["encoders"][0]) * n_encoders
            + shapes(params["decoders"]))


def _interpret(shapes):
    """How many times the kernel updates each element of each leaf, from
    the chunk table with the kernel's index arithmetic: a block finds its
    leaf by a binary search of the first chunks, its thread ``t`` takes the
    elements ``(k * THREADS + t) * VEC + e`` of the chunk that lie before
    the leaf's end. Returns per leaf an array of counts, and the launches."""
    k_, t_, e_ = np.meshgrid(np.arange(k3.RUNS), np.arange(k3.THREADS),
                             np.arange(k3.VEC), indexing="ij")
    offsets = ((k_ * k3.THREADS + t_) * k3.VEC + e_).reshape(-1)
    # Every thread's elements together are the chunk, once each.
    assert np.array_equal(np.sort(offsets), np.arange(k3.CHUNK))
    counts = [np.zeros(math.prod(s) + 1, np.int32) for s in shapes]
    groups = k3.chunk_table(tuple(shapes))
    for grp in groups:
        assert len(grp.leaves) <= k3.MAX_LEAVES
        n, first = grp.geom[:, 0], grp.geom[:, 1]
        block = np.arange(grp.blocks)
        local = np.searchsorted(first, block, side="right") - 1
        base = (block - first[local]).astype(np.int64) * k3.CHUNK
        length = np.minimum(k3.CHUNK, n[local] - base)
        assert np.all(length > 0)
        for li, i in enumerate(grp.leaves):
            assert n[li] == math.prod(shapes[i])
            mine = local == li
            # Each block's elements are [base, base + length): a difference
            # array summed gives the count of every element.
            np.add.at(counts[i], base[mine], 1)
            np.add.at(counts[i], base[mine] + length[mine], -1)
    return [np.cumsum(c, dtype=np.int32)[:-1] for c in counts], len(groups)


@pytest.mark.parametrize("which,n_leaves,launches", [
    ("mimic-cxr-resnet18", 133, 1), ("mimic-haim", 37, 1),
    ("featurewise", 7611, 15)])
def test_chunk_table_covers_every_element_once(which, n_leaves, launches):
    shapes = _featurewise_shapes() if which == "featurewise" else \
        _cell_shapes(which)
    assert len(shapes) == n_leaves
    counts, n_launches = _interpret(shapes)
    assert n_launches == launches == k3.launches_per_update(shapes)
    for c in counts:
        assert c.size == 0 or (c.min() == 1 and c.max() == 1)
    if which == "mimic-cxr-resnet18":
        # 11,260,898 parameters in 2,853 chunks of 4,096, one launch.
        (grp,) = k3.chunk_table(tuple(shapes))
        assert int(grp.geom[:, 0].sum()) == 11_260_898
        assert grp.blocks == 2853


def test_chunk_table_leaves_out_empty_leaves():
    shapes = ((3, 0), (5,), (), (0,), (4097,))
    (grp,) = k3.chunk_table(shapes)
    assert grp.leaves.tolist() == [1, 2, 4]
    assert grp.geom.tolist() == [[5, 0], [1, 1], [4097, 2]]
    assert grp.blocks == 4
    counts, _ = _interpret(list(shapes))
    assert all(c.size == 0 or (c.min() == c.max() == 1) for c in counts)
    assert k3.chunk_table(((0,),)) == ()


def _leaf(shape=(6, 5), state_dtype=torch.float32, gate=None):
    rng = np.random.default_rng(3)
    p, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in "pg")
    m, v = (torch.zeros(shape, dtype=state_dtype) for _ in "mv")
    c12 = torch.tensor([1 - B1, 1 - B2], dtype=torch.float32)
    return [p, g, m, v, c12, gate]


@pytest.mark.parametrize("at,dtype,match", [
    (0, torch.float64, "p must be torch.float32"),
    (1, torch.float16, "g must be torch.float32"),
    (2, torch.float16, "m must be"),
    (4, torch.float64, "c12 must be torch.float32")])
def test_launch_check_refuses_other_dtypes(at, dtype, match):
    leaf = _leaf()
    leaf[at] = leaf[at].to(dtype)
    with pytest.raises(TypeError, match=match):
        k3.check_leaves([tuple(leaf)])


def test_launch_check_refuses_bad_leaves():
    assert k3.check_leaves([tuple(_leaf())]) == 0
    assert k3.check_leaves([tuple(_leaf(state_dtype=torch.bfloat16))]) == 1
    leaf = _leaf()
    leaf[3] = leaf[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="v must be torch.float32"):
        k3.check_leaves([tuple(leaf)])
    leaf = _leaf()
    leaf[1] = leaf[1].t().contiguous().t()
    with pytest.raises(ValueError, match="g must be contiguous"):
        k3.check_leaves([tuple(leaf)])
    leaf = _leaf()
    leaf[2] = torch.zeros(30)
    with pytest.raises(ValueError, match="m has shape"):
        k3.check_leaves([tuple(leaf)])
    with pytest.raises(ValueError, match="gate has shape"):
        k3.check_leaves([tuple(_leaf(gate=torch.ones(1)))])
    # Passed once, the same parameter and moments are trusted; a new
    # gradient of another type is still refused.
    leaf = _leaf()
    k3.check_leaves([tuple(leaf)])
    leaf[1] = leaf[1].double()
    with pytest.raises(TypeError, match="g must be torch.float32"):
        k3.check_leaves([tuple(leaf)])


def test_counters_name_k3_launches():
    counters = profiling.counters()
    assert counters["k3.launches"] == k3.FUSED_ADAM_FP32.launches
    assert {"k1.launches", "k2.launches", "k3.launches",
            "kernels.built"} <= set(counters)
