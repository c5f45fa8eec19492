"""The port's 8-bit Adam leaf update against the JAX package on the CPU.

Inputs come from a seeded numpy generator and go through both packages'
functions. The plain version rounds each float32 operation on its own in
the JAX package's order, and both frameworks cast to float8_e4m3fn and int8
with round-to-nearest-even, so quantization of the same values is compared
bit for bit. XLA compiles a whole update into one fused loop: it contracts
multiply-adds into FMAs and may turn a division by a constant into a product
with its reciprocal, so there the two differ by about one float32 ulp in a
few percent of elements (``FLOAT_RTOL``, ``FLOAT_ATOL``), and a moment that
moved by one ulp can round to the neighbouring 8-bit code (``CODE_SHARE``).
The hand-written kernel is held to the plain version bit for bit on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multimodn_tpu.ops import fused_adam as ja
from multimodn_tpu_torch.ops import fused_adam as ta

LR, B1, B2, EPS = 0.003, 0.9, 0.999, 1e-8


def _np(x):
    """A JAX array or tensor as numpy bits: 8-bit codes as uint8, floats
    as they are."""
    if torch.is_tensor(x):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


FLOAT_RTOL = 1e-6    # a few float32 ulp (2^-23 ~ 1.2e-7)
FLOAT_ATOL = 1e-9    # ~4 ulp of an update of size lr = 3e-3
CODE_SHARE = 0.02    # at most 2% of codes on a neighbouring code


def _close(got, want):
    """Within XLA's fusion differences (module docstring)."""
    if got.element_size() != 1:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        return
    a = got.float().numpy()
    b = np.asarray(want).astype(np.float32)
    # One code step: 1 for int8; for e4m3 2^-3 of the value, or the
    # subnormal step 2^-9.
    step = 1.0 if got.dtype == torch.int8 else \
        2.0 ** -3 * np.maximum(np.abs(a), np.abs(b)) + 2.0 ** -9
    assert np.all(np.abs(a - b) <= step)
    assert np.mean(a != b) <= CODE_SHARE


def _codes_to_torch(q):
    a = np.asarray(q)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _mixed(shape, seed):
    """Rows mixing magnitudes 1e-4 apart, as concat-layer gradients do."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if len(shape) >= 1:
        x[..., ::2] *= 1e-4
    return x


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_quantize_rows_matches_jax(fmt):
    x = _mixed((40, 77), 0)
    x[3] = 0.0                  # zero row: scale 0, codes 0
    x[7, 5] = np.nan            # NaN row: scale NaN, finite codes 0
    x[9, 2] = np.inf
    qj, sj = ja.quantize_rows(jnp.asarray(x), fmt)
    qt, st = ta.quantize_rows(torch.from_numpy(x), fmt)
    assert qt.dtype == ta.code_dtype(fmt) and st.shape == (40, 1)
    _same(qt, qj)
    _same(st, sj)
    assert np.isnan(st[7, 0].item()) and st[3, 0].item() == 0.0
    assert np.all(_np(qt)[3] == 0)


@pytest.mark.parametrize("shape", [(), (33,), (3, 10, 7)])
def test_quantize_rows_shapes(shape):
    x = _mixed(shape, 1)
    qj, sj = ja.quantize_rows(jnp.asarray(x))
    qt, st = ta.quantize_rows(torch.from_numpy(np.array(x)))
    assert tuple(st.shape) == ta.scale_shape(shape) == ja.scale_shape(shape)
    _same(qt, qj)
    _same(st, sj)


def _moments(shape, fmt, seed, steps=2):
    """Moment codes after ``steps`` plain JAX updates from zero."""
    qdt = ja.code_dtype(fmt)
    mq, vq = jnp.zeros(shape, qdt), jnp.zeros(shape, qdt)
    ms = vs = jnp.zeros(ja.scale_shape(shape), jnp.float32)
    for t in range(1, steps + 1):
        g = jnp.asarray(_mixed(shape, seed + t))
        _, mq, ms, vq, vs = ja.moment_update(
            g, mq, ms, vq, vs, 1 - B1 ** t, 1 - B2 ** t, LR, B1, B2, EPS,
            fmt=fmt)
    return mq, ms, vq, vs


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
def test_moment_update_matches_jax(fmt, gate):
    shape = (24, 40)
    mq, ms, vq, vs = _moments(shape, fmt, 2)
    g = _mixed(shape, 9)
    c1, c2 = np.float32(1 - B1 ** 3), np.float32(1 - B2 ** 3)
    want = ja.moment_update(
        jnp.asarray(g), mq, ms, vq, vs, jnp.asarray(c1), jnp.asarray(c2), LR,
        B1, B2, EPS, fmt=fmt,
        gate=None if gate is None else jnp.asarray(gate, jnp.float32))
    got = ta.moment_update(
        torch.from_numpy(g), _codes_to_torch(mq), torch.from_numpy(
            np.array(ms)), _codes_to_torch(vq),
        torch.from_numpy(np.array(vs)), torch.tensor(c1), torch.tensor(c2),
        LR, B1, B2, EPS, fmt=fmt,
        gate=None if gate is None else torch.tensor(gate))
    for a, b in zip(got, want):
        _close(a, b)
    if gate == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), 0.0)


def _torch_leaf(p, g, mq, ms, vq, vs):
    return [torch.from_numpy(np.array(p)), torch.from_numpy(np.array(g)),
            _codes_to_torch(mq), torch.from_numpy(np.array(ms)),
            _codes_to_torch(vq), torch.from_numpy(np.array(vs))]


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("fmt", ["fp8", "int8"])
@pytest.mark.parametrize("shape", [(1074, 32), (32,), (1, 50), (),
                                   (3, 10, 7)])
def test_leaf_update_matches_jax(mode, fmt, shape):
    """The plain version against the JAX package's leaf update, run as
    ``tests/test_adam8bit.py`` runs it on the CPU: the Pallas kernel in
    interpret mode, and the XLA twin. Three steps from zero moments, each
    fed the previous step's JAX outputs."""
    rng = np.random.default_rng(len(shape))
    p = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    qdt = ja.code_dtype(fmt)
    mq, vq = jnp.zeros(shape, qdt), jnp.zeros(shape, qdt)
    ms = vs = jnp.zeros(ja.scale_shape(shape), jnp.float32)
    for t in (1, 2, 3):
        g = jnp.asarray(_mixed(shape, 10 * t))
        c12 = np.asarray([[1 - B1 ** t, 1 - B2 ** t]], np.float32)
        want = ja.leaf_update(p, g, mq, ms, vq, vs, jnp.asarray(c12), lr=LR,
                              b1=B1, b2=B2, eps=EPS, mode=mode, fmt=fmt)
        leaf = _torch_leaf(p, g, mq, ms, vq, vs)
        got = ta.leaf_update_ref(*leaf, torch.tensor(c12[0, 0]),
                                 torch.tensor(c12[0, 1]), LR, B1, B2, EPS,
                                 fmt=fmt)
        for a, b in zip(got, want):
            _close(a, b)
        p, mq, ms, vq, vs = want


def test_first_step_equals_fp32_adam():
    """Zero moments quantize losslessly, so step 1 is fp32 Adam's exactly:
    m_hat = g, v_hat = g^2."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    zeros_q = torch.zeros((40, 24), dtype=torch.float8_e4m3fn)
    zeros_s = torch.zeros((40, 1))
    p1, *_ = ta.leaf_update_ref(p, g, zeros_q, zeros_s, zeros_q, zeros_s,
                                torch.tensor(1 - B1, dtype=torch.float32),
                                torch.tensor(1 - B2, dtype=torch.float32),
                                0.01, B1, B2, EPS)
    m = (1 - B1) * g
    v = (1 - B2) * g * g
    want = p + -0.01 * (m / torch.tensor(np.float32(1 - B1))) / (
        torch.sqrt(v / torch.tensor(np.float32(1 - B2))) + EPS)
    torch.testing.assert_close(p1, want, rtol=0, atol=0)


def _cpu_leaf(shape=(6, 5), fmt="fp8"):
    rng = np.random.default_rng(3)
    return ([torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for _ in range(2)]
            + [torch.zeros(shape, dtype=ta.code_dtype(fmt)),
               torch.zeros(ta.scale_shape(shape)),
               torch.zeros(shape, dtype=ta.code_dtype(fmt)),
               torch.zeros(ta.scale_shape(shape))]
            + [torch.tensor([1 - B1, 1 - B2], dtype=torch.float32)])


@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
def test_wrapper_updates_in_place_on_cpu_without_launching(gate):
    """On CPU tensors the wrapper runs the plain version and writes its
    results into the given tensors; nothing is built or launched."""
    leaf = _cpu_leaf()
    gate_t = None if gate is None else torch.tensor(gate)
    want = ta.leaf_update_ref(*leaf[:6], leaf[6][0], leaf[6][1], LR, B1, B2,
                              EPS, gate=gate_t)
    before = ta.FUSED_ADAM.launches
    ptrs = [t.data_ptr() for t in leaf[:6]]
    ta.leaf_update(*leaf, lr=LR, b1=B1, b2=B2, eps=EPS, gate=gate_t)
    assert ta.FUSED_ADAM.launches == before and ta.FUSED_ADAM._lib is None
    assert [t.data_ptr() for t in leaf[:6]] == ptrs
    for got, w in zip([leaf[0]] + leaf[2:6], want):
        _same(got, w)
    if gate == 0.0:
        np.testing.assert_array_equal(_np(leaf[2]), 0)


def test_wrapper_rejects_bad_leaves():
    leaf = _cpu_leaf()
    with pytest.raises(TypeError, match="float32"):
        ta.leaf_update(leaf[0].double(), *leaf[1:], lr=LR, b1=B1, b2=B2,
                       eps=EPS)
    with pytest.raises(TypeError, match="mq must be"):
        ta.leaf_update(*leaf, lr=LR, b1=B1, b2=B2, eps=EPS, fmt="int8")
    with pytest.raises(ValueError, match="ms has shape"):
        ta.leaf_update(*leaf[:3], torch.zeros(6), *leaf[4:], lr=LR, b1=B1,
                       b2=B2, eps=EPS)
    with pytest.raises(ValueError, match="contiguous"):
        ta.leaf_update(leaf[0], leaf[1].t().contiguous().t(), *leaf[2:],
                       lr=LR, b1=B1, b2=B2, eps=EPS)
    with pytest.raises(ValueError, match="fmt"):
        ta.leaf_update(*leaf, lr=LR, b1=B1, b2=B2, eps=EPS, fmt="fp16")


def test_nan_gradient_poisons_its_row_only():
    """A NaN gradient element makes its row's scales NaN (the whole row
    then dequantizes to NaN), as in the JAX package; other rows stay
    finite."""
    leaf = _cpu_leaf((4, 6))
    leaf[1][2, 3] = float("nan")
    ta.leaf_update(*leaf, lr=LR, b1=B1, b2=B2, eps=EPS)
    ms = leaf[3].reshape(-1)
    assert torch.isnan(ms[2]) and torch.isfinite(ms[[0, 1, 3]]).all()
    assert torch.isnan(leaf[0][2, 3]) and torch.isfinite(leaf[0][0]).all()


# ---------------------------------------------------------------------------
# One update over many leaves
# ---------------------------------------------------------------------------

def _small_mimic_shapes():
    """The 37 leaf shapes of the MIMIC model's structure at small widths:
    4 first-concat encoders with two hidden layers, 2 MLP decoders, the
    trainable init state."""
    from multimodn_tpu_torch import MultiModN, decoders, encoders
    from multimodn_tpu_torch.core.tree import tree_leaves
    m = MultiModN(8, [encoders.MIMICMLPEncoder(8, w, (6, 6))
                      for w in (3, 11, 7, 5)],
                  [decoders.MLPDecoder(8, (6, 6), 2) for _ in range(2)],
                  1.0, 0.0, device="cpu")
    return [tuple(t.shape) for t in tree_leaves(m.params)]


def _leaves(shapes, fmt, seed, nan=None):
    """Leaves after one plain step, with per-group bias corrections and
    gates: ungated, gate 1 and gate 0 in turn."""
    rng = np.random.default_rng(seed)
    c12s = [torch.tensor([1 - B1 ** t, 1 - B2 ** t], dtype=torch.float32)
            for t in (2, 4, 3)]
    gates = [None, torch.tensor(1.0), torch.tensor(0.0)]
    leaves = []
    for i, shape in enumerate(shapes):
        p, g = (torch.from_numpy(_mixed(shape, int(rng.integers(1 << 30))))
                for _ in "pg")
        mq, ms, vq, vs = (t.clone() for t in _cpu_leaf(shape, fmt)[2:6])
        new = ta.leaf_update_ref(p, torch.from_numpy(_mixed(shape, i)), mq,
                                 ms, vq, vs, 1 - B1, 1 - B2, LR, B1, B2, EPS,
                                 fmt=fmt)
        p, mq, ms, vq, vs = new
        leaves.append((p, g.clone(), mq, ms, vq, vs, c12s[i % 3],
                       gates[i % 3]))
    if nan is not None:
        leaves[nan[0]][1].view(-1)[nan[1]] = float("nan")
    return leaves


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_multi_leaf_update_equals_leaf_update_leaf_by_leaf(fmt):
    shapes = _small_mimic_shapes()
    assert len(shapes) == 37
    leaves = _leaves(shapes, fmt, 5, nan=(19, 4))
    one_by_one = [tuple(t.clone() if torch.is_tensor(t) else t for t in leaf)
                  for leaf in leaves]
    for leaf in one_by_one:
        ta.leaf_update(*leaf[:7], lr=LR, b1=B1, b2=B2, eps=EPS,
                       gate=leaf[7], fmt=fmt)
    before = ta.FUSED_ADAM.launches
    ta.multi_leaf_update(leaves, lr=LR, b1=B1, b2=B2, eps=EPS, fmt=fmt)
    assert ta.FUSED_ADAM.launches == before and ta.FUSED_ADAM._lib is None
    for a, b in zip(leaves, one_by_one):
        for x, y in zip((a[0],) + a[2:6], (b[0],) + b[2:6]):
            np.testing.assert_array_equal(_np(x).view(np.uint8),
                                          _np(y).view(np.uint8))
    # The NaN gradient poisoned its row's scales; a gate-0 leaf kept p.
    assert torch.isnan(leaves[19][3].reshape(-1)[0])


def test_multi_leaf_update_ref_is_the_loop_of_leaf_update_ref():
    leaves = _leaves([(5, 6), (7,), ()], "fp8", 1)
    got = ta.multi_leaf_update_ref(leaves, lr=LR, b1=B1, b2=B2, eps=EPS)
    for leaf, new in zip(leaves, got):
        want = ta.leaf_update_ref(*leaf[:6], leaf[6][0], leaf[6][1], LR, B1,
                                  B2, EPS, gate=leaf[7])
        for a, b in zip(new, want):
            _same(a, b)


def _kernel_cover(group):
    """Which elements each pass of the kernel touches, read from the leaf
    table with the kernel's index arithmetic: counts per (leaf, row,
    column) for pass 1 (p and, for rows that fit a block, the codes) and
    pass 2 (the codes of split rows), and the rows whose scales each pass
    writes."""
    from collections import Counter
    geom = group.geom
    cover = [Counter(), Counter()]
    scales = [Counter(), Counter()]
    for pass_, blocks in ((0, group.blocks), (1, group.blocks2)):
        for blk in range(blocks):
            first = geom[:, 3 + pass_]
            l = int(np.nonzero(first <= blk)[0][-1])
            rows, cols, lanes = (int(v) for v in geom[l, :3])
            local = blk - int(first[l])
            t = np.arange(ta.THREADS)
            if lanes:
                assert pass_ == 0
                row = local * (ta.THREADS // lanes) + t // lanes
                j = ((np.arange(ta.FIT_GROUPS)[:, None] * lanes
                      + t % lanes) * ta.VEC)[..., None] + np.arange(ta.VEC)
                row = np.broadcast_to(row[None, :, None], j.shape)
                lane0 = np.broadcast_to((t % lanes == 0)[None, :, None],
                                        j.shape)
            else:
                chunks = -(-cols // ta.SPLIT_COLS)
                row = np.full((1, ta.THREADS, ta.VEC), local // chunks)
                j = (local % chunks * ta.SPLIT_COLS + t * ta.VEC)[
                    None, :, None] + np.arange(ta.VEC)
                lane0 = np.zeros(j.shape, bool)
                if local % chunks == 0 and pass_ == 1:
                    scales[1][(l, int(row[0, 0, 0]))] += 1
            ok = (row < rows) & (j < cols)
            cover[pass_].update(zip([l] * int(ok.sum()), row[ok].tolist(),
                                    j[ok].tolist()))
            for r in np.unique(row[ok & lane0]).tolist():
                scales[0][(l, r)] += 1
    return cover, scales


# Two blocks per SM of a 132-SM H100.
H100_BUSY_BLOCKS = 264


def test_leaf_table_covers_every_element_once():
    shapes = _small_mimic_shapes()[:30] + [(2, 9000), (4096, 33), (5, 1500),
                                           (65536,), (0, 4), (7, 3, 5)]
    (group,) = ta.leaf_table(tuple(shapes), H100_BUSY_BLOCKS)
    assert len(group.leaves) == len(shapes) - 1      # the empty leaf is out
    cover, scales = _kernel_cover(group)
    for li, i in enumerate(group.leaves):
        rows, cols = ta.rows_cols(shapes[i])
        split = cols > ta.FIT_COLS
        want = {(li, r, c) for r in range(rows) for c in range(cols)}
        assert set(cover[0]) >= want and all(
            cover[0][k] == 1 for k in want)
        assert all(cover[1][k] == (1 if split else 0) for k in want)
        assert all(scales[1 if split else 0][(li, r)] == 1
                   for r in range(rows))
    assert sum(cover[0].values()) == sum(
        math.prod(s) for s in shapes)
    # (65536,) and (2, 9000) are split: 64 and 2 x 9 blocks in each pass.
    assert group.blocks2 == 64 + 18 and group.split_rows == 1 + 2
    assert ta.launches_per_update(shapes) == 2


def test_leaf_table_groups_and_lanes():
    mimic = [(32,), (50, 32), (2,), (32, 2), (1074, 32), (32, 50), (1, 50)]
    (group,) = ta.leaf_table(tuple(mimic), H100_BUSY_BLOCKS)
    # Narrow rows share a warp, one run of 4 elements per lane: 32 columns
    # take 8 lanes, 50 take 16, 2 take 1; a 1074-row leaf of 32 columns
    # takes 1074 / 32 blocks.
    assert group.geom[:, 2].tolist() == [8, 8, 1, 1, 8, 16, 16]
    assert group.blocks == 1 + 2 + 1 + 1 + 34 + 2 + 1
    assert group.blocks2 == 0 and ta.launches_per_update(mimic) == 1
    # A large leaf holds 4 runs per lane: (4096, 1024) takes 64 lanes a row,
    # 4 rows a block, still 1024 blocks; on a card of 1024 or more busy
    # blocks it keeps one run per lane.
    busy = H100_BUSY_BLOCKS
    assert ta.row_lanes(4096, 1024, busy) == 64
    assert ta.row_lanes(4096, 1024, 1025) == 256
    assert ta.row_lanes(8, 1024, busy) == 256
    assert ta.row_lanes(1, 4096, busy) == 256
    assert ta.row_lanes(1, 4097, busy) == 0
    many = tuple([(3, 4)] * (ta.MAX_LEAVES + 1))
    assert [len(g.leaves) for g in ta.leaf_table(many, busy)] == \
        [ta.MAX_LEAVES, 1]
    assert ta.launches_per_update(many) == 2
