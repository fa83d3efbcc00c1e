"""The grouped ``factor_mean`` (B2) of the port on the CPU: its plain path
against the per-tensor plain version and the JAX package's Pallas kernel
(interpret mode), and its launch plan, which lives in Python.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it bitwise against ``factor_mean_plain`` there).

Tolerances: on the CPU the group takes ``factor_mean_plain`` per tensor, so
it must agree with it bitwise, accumulate mode as ``out.add_(mean)``
included. Against the Pallas kernel the plain version sums in the same
slot order, so the two agree to a few f32 ulps (rtol 1e-6, as
tests/test_torch_kernels.py).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.factor_mean import lora_factor_mean  # noqa: E402
from repro_torch.kernels import (factor_mean, factor_mean_group,  # noqa: E402
                                 factor_mean_plain)
from repro_torch.kernels.factor_mean import (MAX_GROUP,  # noqa: E402
                                             OUTPUTS_PER_BLOCK, _group_plan,
                                             _lane_contiguous)

# the module (the package's ``factor_mean`` is the wrapper function)
fm = importlib.import_module("repro_torch.kernels.factor_mean")


def _leaves(c, seed=0):
    """a and b stacks of two leaves (L = 2): (C, 2, m, r) and (C, 2, r, n)
    at odd sizes, and normalised weights with a zero lane."""
    rng = np.random.default_rng(seed)
    shapes = [(c, 2, 40, 4), (c, 2, 4, 24), (c, 2, 33, 3), (c, 2, 3, 17)]
    stacks = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    w = rng.random(c) + 0.1
    w[1] = 0.0
    return stacks, (w / w.sum()).astype(np.float32)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "acc"])
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
def test_group_equals_per_tensor_plain_bitwise(weighted, accumulate):
    stacks, w = _leaves(4)
    ts = [torch.from_numpy(s) for s in stacks]
    tw = torch.from_numpy(w) if weighted else None
    priors = [torch.from_numpy(np.random.default_rng(7 + i).standard_normal(
        s.shape[1:]).astype(np.float32)) for i, s in enumerate(ts)]
    out = [p.clone() for p in priors] if accumulate else None
    got = factor_mean_group(ts, tw, out=out, accumulate=accumulate)
    assert len(got) == len(ts)
    for g, s, p in zip(got, ts, priors):
        want = factor_mean_plain(s, tw)
        if accumulate:
            want = p + want
        assert torch.equal(_bits(g), _bits(want))
    if accumulate:  # in place
        assert all(g is o for g, o in zip(got, out))


def test_one_tensor_case_is_the_group():
    stacks, w = _leaves(3, seed=1)
    x, tw = torch.from_numpy(stacks[0]), torch.from_numpy(w)
    assert torch.equal(factor_mean(x, tw), factor_mean_group([x], tw)[0])
    assert torch.equal(factor_mean(x, None), factor_mean_plain(x, None))


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
def test_two_leaves_match_pallas(weighted):
    """a and b of two leaves through one group against the reference's
    ``lora_factor_mean`` on each, one layer at a time (interpret mode)."""
    stacks, w = _leaves(4, seed=2)
    got = factor_mean_group([torch.from_numpy(s) for s in stacks],
                            torch.from_numpy(w) if weighted else None)
    for s, g in zip(stacks, got):
        for layer in range(s.shape[1]):
            x = s[:, layer]
            ref = np.asarray(lora_factor_mean(
                jnp.asarray(x), jnp.asarray(w) if weighted else None,
                bm=min(256, x.shape[1]), bn=min(256, x.shape[2]),
                interpret=True))
            np.testing.assert_allclose(g[layer].numpy(), ref, rtol=1e-6,
                                       atol=1e-7)


def test_plan_first_blocks_are_the_prefix_of_block_counts():
    counts = [1, OUTPUTS_PER_BLOCK, OUTPUTS_PER_BLOCK + 1, 5000, 344_064]
    entries = [(4096 * (i + 1), 8192 * (i + 1), n, n) for i, n in
               enumerate(counts)]
    (plan,) = _group_plan(entries)
    first, blocks = [], 0
    for n in counts:
        first.append(blocks)
        blocks += -(-n // OUTPUTS_PER_BLOCK)
    assert [e[4] for e in plan] == first == [0, 1, 2, 4, 9]
    assert [e[:4] for e in plan] == entries


@pytest.mark.parametrize("case,vec", [
    ((1024, 2048, 64, 64), 1),     # aligned
    ((1028, 2048, 64, 64), 0),     # source off 16 bytes
    ((1024, 2052, 64, 64), 0),     # destination off 16 bytes
    ((1024, 2048, 66, 64), 0),     # count not a multiple of 4
    ((1024, 2048, 64, 70), 0),     # lane stride not a multiple of 4
], ids=["aligned", "src", "dst", "count", "stride"])
def test_plan_vector_flag_per_tensor(case, vec):
    """The 16-byte flag is each tensor's own: one unaligned tensor leaves
    the others of its group on 16-byte loads."""
    (plan,) = _group_plan([(4096, 8192, 1024, 1024), case,
                           (16384, 32768, 8, 8)])
    assert [e[5] for e in plan] == [1, vec, 1]


def test_plan_splits_a_group_past_the_table():
    entries = [(16 * i, 16 * i + 8, 100 + i, 128) for i in
               range(2 * MAX_GROUP + 3)]
    plan = _group_plan(entries)
    assert [len(p) for p in plan] == [MAX_GROUP, MAX_GROUP, 3]
    assert [e[:4] for p in plan for e in p] == entries
    for p in plan:  # each launch's prefix starts at 0
        assert [e[4] for e in p] == list(range(len(p)))


def test_plan_splits_a_group_past_the_grid(monkeypatch):
    monkeypatch.setattr(fm, "_MAX_GRID", 5)
    plan = _group_plan([(0, 0, 3 * OUTPUTS_PER_BLOCK, 0)] * 3)
    assert [[e[4] for e in p] for p in plan] == [[0], [0], [0]]
    with pytest.raises(ValueError):
        _group_plan([(0, 0, 6 * OUTPUTS_PER_BLOCK, 0)])


def test_lane_contiguity_allows_any_lane_stride():
    x = torch.zeros(6, 2, 5, 3)
    assert _lane_contiguous(x)
    assert _lane_contiguous(x[1:4])        # a view one lane in
    assert _lane_contiguous(x[::2])        # every other lane
    assert not _lane_contiguous(x.transpose(1, 2))
    assert not _lane_contiguous(x[:, :, :, :2])


def test_refusals():
    stacks, w = _leaves(4, seed=3)
    ts = [torch.from_numpy(s) for s in stacks]
    tw = torch.from_numpy(w)
    with pytest.raises(ValueError):
        factor_mean_group(ts, tw, accumulate=True)       # no out
    with pytest.raises(ValueError):
        factor_mean_group([ts[0], ts[1][:3]], tw)         # C differs
    with pytest.raises(ValueError):
        factor_mean_group(ts[:2], tw, out=[torch.zeros(2, 40, 4)])
    with pytest.raises(ValueError):
        factor_mean_group(ts[:1], tw, out=[torch.zeros(2, 40, 5)])
    with pytest.raises(TypeError):
        factor_mean_group([ts[0].double()], tw)
    with pytest.raises(ValueError):
        factor_mean_group([], tw)


def test_cpu_group_counts_no_launch():
    stacks, w = _leaves(4, seed=4)
    before = factor_mean.launches
    factor_mean_group([torch.from_numpy(s) for s in stacks],
                      torch.from_numpy(w))
    assert factor_mean.launches == before
