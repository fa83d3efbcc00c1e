"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; elsewhere they
skip. They import no JAX, so on a machine without it run them as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: ``factor_mean`` rounds every product and sum as separate PyTorch
ops do, in the same slot order, so it must agree bitwise. ``fedex_fold``
sums its rank-r products in another order than ``torch.matmul`` (and
contracts them into FMAs), so it is held to ``fold_error_bound``: twice
(C + r + 4) unit roundoffs of the magnitudes each element carries.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (factor_mean,  # noqa: E402
                                 factor_mean_group, factor_mean_plain,
                                 fedex_fold, fedex_fold_plain)
from repro_torch.kernels.fedex_residual import fold_error_bound  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, c, layers, m, n, r, *, zero_lanes=(), seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = (layers,) if layers else ()
    w0 = torch.randn(*lead, m, n, generator=g) * 0.02
    a = torch.randn(c, *lead, m, r, generator=g) * 0.02
    b = torch.randn(c, *lead, r, n, generator=g) * 0.01
    w = torch.rand(c, generator=g) + 0.1
    for z in zero_lanes:
        w[z] = 0.0
    w = w / w.sum()
    return [t.to(dev) for t in (w0, a, b, w)]


FOLD_CASES = [
    # (C, L, m, n, r, zero lanes)
    (4, 3, 256, 384, 4, ()),
    (4, 2, 100, 300, 4, ()),        # tile-indivisible m and n
    (1, 2, 64, 128, 4, ()),         # one client
    (8, 2, 96, 200, 4, (1, 4, 7)),  # zero-weight lanes
    (4, 2, 128, 256, 16, ()),
    (3, 0, 70, 130, 64, ()),        # 2-D w0, r needs > 48 KB shared memory
    (20, 2, 64, 200, 4, (3, 7, 11)),  # 17 live lanes of 20
]


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
@pytest.mark.parametrize("case", FOLD_CASES, ids=str)
def test_fedex_fold_matches_plain(cuda, case, weighted):
    c, layers, m, n, r, zero = case
    w0, a, b, w = _inputs(cuda, c, layers, m, n, r, zero_lanes=zero)
    wts = w if weighted else None
    got = fedex_fold(w0, a, b, 2.0, weights=wts)
    torch.cuda.synchronize()
    want = fedex_fold_plain(w0, a, b, 2.0, wts)
    bound = fold_error_bound(w0, a, b, 2.0, wts)
    assert bool(((got - want).abs() <= bound).all())


def test_fedex_fold_strided_and_in_place(cuda):
    """Layer-leading (L, C, m, r) storage read through strides, written into
    W0's own storage."""
    w0, a, b, w = _inputs(cuda, 4, 3, 96, 256, 4)
    a_lc = a.transpose(0, 1).contiguous().transpose(0, 1)  # strided view
    b_lc = b.transpose(0, 1).contiguous().transpose(0, 1)
    want = fedex_fold_plain(w0, a, b, 2.0, w)
    bound = fold_error_bound(w0, a, b, 2.0, w)
    buf = w0.clone()
    out = fedex_fold(buf, a_lc, b_lc, 2.0, weights=w, out=buf)
    torch.cuda.synchronize()
    assert out.data_ptr() == buf.data_ptr()
    assert bool(((buf - want).abs() <= bound).all())


def test_folds_take_two_stacked_layer_axes(cuda):
    """gemma3's local leaves, W0 (nper, ratio, m, n) with (C, nper, ratio,
    m, r) stacks: the fedex fold (in place) and the product fold launch once
    over the flattened layers, as over the (nper·ratio, m, n) view."""
    w0, a, b, w = _inputs(cuda, 4, 6, 96, 200, 4)
    w4, a4, b4 = (w0.view(2, 3, 96, 200), a.view(4, 2, 3, 96, 4),
                  b.view(4, 2, 3, 4, 200))
    want = fedex_fold_plain(w0, a, b, 2.0, w).view(2, 3, 96, 200)
    bound = fold_error_bound(w4, a4, b4, 2.0, w)
    buf = w4.clone()
    fedex_fold(buf, a4, b4, 2.0, weights=w, out=buf)
    flat = fedex_fold(w0, a, b, 2.0, weights=w)
    torch.cuda.synchronize()
    assert bool(((buf - want).abs() <= bound).all())
    assert torch.equal(buf, flat.view(2, 3, 96, 200))
    from repro_torch.kernels import product_fold
    got = product_fold(w4, a4, b4, w, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(got, product_fold(w0, a, b, w, 2.0).view_as(got))


def test_zero_weight_lane_is_never_read(cuda):
    w0, a, b, w = _inputs(cuda, 3, 2, 64, 128, 4, zero_lanes=(2,))
    clean = fedex_fold(w0, a, b, 2.0, weights=w)
    a[2] = float("nan")
    b[2] = float("inf")
    dirty = fedex_fold(w0, a, b, 2.0, weights=w)
    mean = factor_mean(a, w)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)
    assert bool(torch.isfinite(mean).all())


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
@pytest.mark.parametrize("shape", [(4, 3, 96, 4), (1, 2, 5, 7), (8, 28, 4, 1024)],
                         ids=str)
def test_factor_mean_bitwise(cuda, shape, weighted):
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(*shape, generator=g).to(cuda)
    w = torch.rand(shape[0], generator=g)
    if shape[0] > 2:
        w[1] = 0.0
    w = (w / w.sum()).to(cuda)
    wts = w if weighted else None
    got = factor_mean(x, wts)
    torch.cuda.synchronize()
    assert torch.equal(got, factor_mean_plain(x, wts))


def test_launch_counters_and_refusals(cuda):
    """factor_mean counts grouped launches: one for a stack, one for a
    group of stacks, one per table of 32 tensors past that."""
    w0, a, b, w = _inputs(cuda, 2, 2, 32, 128, 4)
    f0, m0 = fedex_fold.launches, factor_mean.launches
    fedex_fold(w0, a, b, 1.0, weights=w)
    factor_mean(a, w)
    assert (fedex_fold.launches, factor_mean.launches) == (f0 + 1, m0 + 1)
    factor_mean_group([a, b, a, b], w)
    assert factor_mean.launches == m0 + 2
    factor_mean_group([a, b] * 17, w)  # 34 tensors: two tables
    assert factor_mean.launches == m0 + 4
    with pytest.raises(ValueError):
        fedex_fold(w0.transpose(-1, -2), a, b.transpose(-1, -2), 1.0)
    with pytest.raises(TypeError):
        factor_mean(a.double(), None)
    with pytest.raises(ValueError):
        factor_mean_group([a, b], w, accumulate=True)
    assert (fedex_fold.launches, factor_mean.launches) == (f0 + 1, m0 + 4)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "acc"])
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
def test_factor_mean_group_bitwise(cuda, weighted, accumulate):
    """One grouped launch over a and b of three leaves, aligned and not (odd
    counts; a stack one lane into its storage with an odd lane stride, so
    16-byte loads are off for it alone), NaN in the zero-weight lanes:
    bitwise the plain version of the clean stacks, and with ``accumulate``
    bitwise acc + that."""
    g = torch.Generator(device="cpu").manual_seed(3)
    c = 5
    shapes = [(c, 3, 96, 4), (c, 3, 4, 256), (c, 2, 33, 3), (c, 2, 3, 17),
              (c + 1, 2, 7, 5), (c, 28, 3072, 4)]
    stacks = [torch.randn(*s, generator=g).to(cuda) for s in shapes]
    stacks[4] = stacks[4][1:]  # one lane in: base off 16 bytes
    w = torch.rand(c, generator=g) + 0.1
    w[1] = w[3] = 0.0
    w = (w / w.sum()).to(cuda)
    clean = [s.clone() for s in stacks]
    if weighted:
        for s in stacks:
            s[1] = float("nan")
            s[3] = float("inf")
    wts = w if weighted else None
    priors = [torch.randn(*s.shape[1:], generator=g).to(cuda) for s in stacks]
    out = [p.clone() for p in priors] if accumulate else None
    before = factor_mean.launches
    got = factor_mean_group(stacks, wts, out=out, accumulate=accumulate)
    torch.cuda.synchronize()
    assert factor_mean.launches == before + 1
    for x, o, p in zip(clean, got, priors):
        want = factor_mean_plain(x, wts)
        if accumulate:
            want = p + want
        assert torch.equal(_bits(o), _bits(want))


# --------------------------------------------------------------------------
# product_fold, perclient_fold, hetero_fold
#
# Tolerances: each kernel sums the same lanes in the same order as its plain
# version but contracts its rank-k dot products into FMAs in another order
# than torch.matmul, so it is held to its error bound (product_error_bound,
# perclient_error_bound, hetero_error_bound: 2·(C + r + 4) unit roundoffs of
# the magnitudes each element carries).
# --------------------------------------------------------------------------

from repro_torch.kernels import (hetero_error_bound, hetero_fold,  # noqa: E402
                                 hetero_fold_plain, perclient_error_bound,
                                 perclient_fold, perclient_fold_plain,
                                 product_error_bound, product_fold,
                                 product_fold_plain)

LANE_CASES = [
    # (C, L, m, n, r, zero-weight lanes)
    (4, 3, 256, 384, 4, ()),
    (3, 2, 1000, 777, 4, ()),        # tile-indivisible m and n
    (1, 2, 64, 128, 8, ()),          # one lane (the svd fold at r' = 8)
    (8, 2, 96, 200, 4, (0, 2, 5, 7, 3)),  # 3 live lanes of 8
    (4, 2, 128, 256, 16, ()),
    (3, 0, 70, 130, 64, ()),         # 2-D w0, > 48 KB shared memory
]


def _within(got, want, bound):
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("case", LANE_CASES, ids=str)
def test_product_fold_matches_plain(cuda, case):
    c, layers, m, n, r, zero = case
    w0, a, b, w = _inputs(cuda, c, layers, m, n, r, zero_lanes=zero)
    s = w.clone()
    s[0] = -s[0]  # signed
    got = product_fold(w0, a, b, s, 2.0)
    torch.cuda.synchronize()
    want = product_fold_plain(w0, a, b, s, 2.0)
    assert _within(got, want, product_error_bound(w0, a, b, s, 2.0))


def _lanes(w0, c, produced):
    return [w0 + 0.001 * i if i in produced else None for i in range(c)]


@pytest.mark.parametrize("case", LANE_CASES, ids=str)
def test_perclient_fold_matches_plain(cuda, case):
    c, layers, m, n, r, zero = case
    w0, a, b, w = _inputs(cuda, c, layers, m, n, r, zero_lanes=zero)
    produced = [i for i in range(c) if i not in zero] or [0]
    lanes = _lanes(w0, c, produced)
    got = perclient_fold(lanes, a, b, w, 2.0)
    torch.cuda.synchronize()
    want = perclient_fold_plain(lanes, a, b, w, 2.0)
    bound = perclient_error_bound(lanes, a, b, w, 2.0)
    for i in range(c):
        assert (got[i] is None) == (i not in produced)
        if got[i] is not None:
            assert _within(got[i], want[i], bound[i]), i


@pytest.mark.parametrize("case", LANE_CASES, ids=str)
def test_hetero_fold_matches_plain(cuda, case):
    c, layers, m, n, r, zero = case
    w0, a, b, w = _inputs(cuda, c, layers, m, n, r, zero_lanes=zero)
    g = torch.Generator(device="cpu").manual_seed(5)
    ranks = torch.randint(1, r + 1, (c,), generator=g, dtype=torch.int32)
    ranks[0] = -1
    if c > 2:
        ranks[1] = 0
    ranks = ranks.to(cuda)
    lead = (layers,) if layers else ()
    oa = torch.randn(*lead, m, r, generator=g).to(cuda) * 0.02
    ob = torch.randn(*lead, r, n, generator=g).to(cuda) * 0.01
    produced = list(range(c))
    lanes = _lanes(w0, c, produced)
    got = hetero_fold(lanes, a, b, w, ranks, oa, ob, 2.0)
    torch.cuda.synchronize()
    want = hetero_fold_plain(lanes, a, b, w, ranks, oa, ob, 2.0)
    bound = hetero_error_bound(lanes, a, b, w, ranks, oa, ob, 2.0)
    for i in produced:
        assert _within(got[i], want[i], bound[i]), i


def test_masked_lanes_and_columns_are_never_read(cuda):
    """NaN and Inf in zero-weight lanes, in rank-0 lanes and in rank columns
    past a lane's rank change no result, bit for bit."""
    c, r = 4, 8
    w0, a, b, w = _inputs(cuda, c, 2, 96, 200, r, zero_lanes=(1,))
    ranks = torch.tensor([3, 8, -1, 0], dtype=torch.int32, device=cuda)
    oa = torch.randn(2, 96, r, device=cuda) * 0.02
    ob = torch.randn(2, r, 200, device=cuda) * 0.01
    lanes = [w0, None, w0 + 1.0, w0 - 1.0]
    clean = (product_fold(w0, a, b, w, 2.0),
             perclient_fold(lanes, a, b, w, 2.0),
             hetero_fold(lanes, a, b, w, ranks, oa, ob, 2.0))
    a[1] = float("nan")             # lane 1 has weight 0
    b[1] = float("inf")
    dirty = [product_fold(w0, a, b, w, 2.0),
             perclient_fold(lanes, a, b, w, 2.0)]
    a[0, ..., 3:] = float("nan")    # lane 0 has rank 3
    b[0, :, 3:, :] = float("inf")
    a[3] = float("nan")             # lane 3 has rank 0
    b[3] = float("nan")
    dirty.append(hetero_fold(lanes, a, b, w, ranks, oa, ob, 2.0))
    torch.cuda.synchronize()
    assert torch.equal(dirty[0], clean[0])
    for got_lanes, want_lanes in zip(dirty[1:], clean[1:]):
        for got, want in zip(got_lanes, want_lanes):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)


def test_perclient_and_hetero_fold_in_place_into_lane_pointers(cuda):
    """Each delivered lane folds into its own, separately allocated W0; a
    lane not produced is left untouched; overlapping outputs are refused."""
    c = 3
    w0, a, b, w = _inputs(cuda, c, 2, 64, 256, 4, zero_lanes=(2,))
    bases = [w0.clone() + i for i in range(c)]
    keep = bases[2].clone()
    lanes = [bases[0], bases[1], None]
    want = perclient_fold_plain(lanes, a, b, w, 2.0)
    bound = perclient_error_bound(lanes, a, b, w, 2.0)
    out = perclient_fold(lanes, a, b, w, 2.0, out=lanes)
    torch.cuda.synchronize()
    assert out[0] is bases[0] and out[1] is bases[1] and out[2] is None
    for i in (0, 1):
        assert _within(bases[i], want[i], bound[i])
    assert torch.equal(bases[2], keep)
    ranks = torch.tensor([2, -1, 0], dtype=torch.int32, device=cuda)
    oa, ob = a[0].clone(), b[0].clone()
    lanes = [bases[0], bases[1], None]
    want = hetero_fold_plain(lanes, a, b, w, ranks, oa, ob, 2.0)
    bound = hetero_error_bound(lanes, a, b, w, ranks, oa, ob, 2.0)
    hetero_fold(lanes, a, b, w, ranks, oa, ob, 2.0, out=lanes)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert _within(bases[i], want[i], bound[i])
    shared = [bases[0], bases[0], None]
    with pytest.raises(ValueError, match="overlaps"):
        perclient_fold(shared, a, b, w, 2.0, out=shared)


def test_new_kernel_counters_count_launches_only(cuda):
    w0, a, b, w = _inputs(cuda, 2, 2, 32, 128, 4)
    ranks = torch.tensor([4, 2], dtype=torch.int32, device=cuda)
    before = (product_fold.launches, perclient_fold.launches,
              hetero_fold.launches)
    product_fold(w0, a, b, w, 1.0)
    perclient_fold([w0, w0], a, b, w, 1.0)
    hetero_fold([w0, None], a, b, w, ranks, a[0], b[0], 1.0)
    product_fold_plain(w0, a, b, w, 1.0)
    assert (product_fold.launches, perclient_fold.launches,
            hetero_fold.launches) == tuple(x + 1 for x in before)
    with pytest.raises(ValueError):
        hetero_fold([w0, None], a, b, w, ranks.long(), a[0], b[0], 1.0)


# --------------------------------------------------------------------------
# product_accum (the chunked closes' partial fold)
#
# Tolerance: product_accum_error_bound (the kernel sums the same lanes in
# the same order as its plain version, its rank-k dot products contracted
# into FMAs in another order than torch.matmul's).
# --------------------------------------------------------------------------

from repro_torch.kernels import (product_accum,  # noqa: E402
                                 product_accum_error_bound,
                                 product_accum_plain)

ACCUM_CASES = [
    # (C, L, m, n, r, zero-weight lanes)
    (4, 3, 256, 384, 4, ()),
    (4, 2, 1000, 777, 16, ()),       # tile-indivisible m and n, rank 16
    (4, 2, 96, 200, 4, (2, 3)),      # a trailing chunk: 2 rows of 4 written
    (1, 2, 64, 128, 4, ()),          # one lane
    (3, 0, 70, 130, 64, ()),         # 2-D acc, > 48 KB shared memory
]


@pytest.mark.parametrize("case", ACCUM_CASES, ids=str)
def test_product_accum_matches_plain_in_place(cuda, case):
    c, layers, m, n, r, zero = case
    acc, a, b, w = _inputs(cuda, c, layers, m, n, r, zero_lanes=zero)
    s = w * 100.0  # raw ingest weights
    a[list(zero)] = float("nan")     # unwritten rows: never read
    b[list(zero)] = float("nan")
    want = product_accum_plain(acc, a, b, s, 1.0)
    bound = product_accum_error_bound(acc, a, b, s, 1.0)
    buf = acc.clone()
    before = product_accum.launches
    out = product_accum(buf, a, b, s, 1.0)
    torch.cuda.synchronize()
    assert out is buf and product_accum.launches == before + 1
    assert bool(torch.isfinite(buf).all())
    assert _within(buf, want, bound)


def test_product_accum_refusals_launch_nothing(cuda):
    acc, a, b, w = _inputs(cuda, 2, 2, 32, 128, 4)
    before = product_accum.launches
    with pytest.raises(ValueError, match="contiguous"):
        product_accum(acc.transpose(-1, -2).contiguous().transpose(-1, -2),
                      a, b, w, 1.0)
    with pytest.raises(TypeError):
        product_accum(acc.double(), a, b, w, 1.0)
    sq = torch.zeros(2, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        product_accum(sq[0], sq, torch.zeros(2, 2, 16, 16, device=cuda),
                      torch.ones(2, device=cuda), 1.0)
    assert product_accum.launches == before


# product_accum has its own body (csrc/product_accum.cu) that rounds as the
# old one did, product_fold with acc as W0 and out: the two must agree
# bitwise, whatever the lanes, slabs and alignment.
ACCUM_BITWISE_CASES = [
    # (C, L, m, n, r, zero-weight lanes, a offset in lanes)
    (4, 3, 256, 384, 4, (), 0),
    (4, 2, 1000, 777, 4, (), 0),        # n % 4 != 0: the 4-byte copies
    (16, 2, 256, 384, 64, (), 0),       # 32 slabs of the K axis
    (4, 3, 255, 384, 3, (), 1),         # a's base off 16-byte alignment
    (4, 2, 384, 256, 4, (1, 3), 0),     # zero lanes in the middle slots
    (4, 2, 256, 384, 4, (0, 1, 2, 3), 0),  # no lane written
    (64, 1, 192, 256, 8, (), 0),        # the documented chunk of 64 at r 8
    (300, 1, 64, 256, 1, tuple(range(1, 300, 3)), 0),  # > 256 signs
]


@pytest.mark.parametrize("case", ACCUM_BITWISE_CASES, ids=str)
def test_product_accum_bitwise_equals_old_body(cuda, case):
    c, layers, m, n, r, zero, off = case
    acc, a, b, w = _inputs(cuda, c + off, layers, m, n, r)
    a, b, s = a[off:], b[:c], w[:c] * 100.0
    s[list(zero)] = 0.0
    a[list(zero)] = float("nan")     # unwritten rows: never read
    b[list(zero)] = float("nan")
    acc[..., 0, :3] = -0.0
    old = acc.clone()
    product_fold(old, a, b, s, 1.0, out=old)
    buf = acc.clone()
    before = product_accum.launches
    product_accum(buf, a, b, s, 1.0)
    torch.cuda.synchronize()
    assert product_accum.launches == before + 1
    assert torch.equal(buf.view(torch.int32), old.view(torch.int32))
    assert bool(torch.isfinite(buf).all())
    if len(zero) == c:  # acc + 0: only -0 turns into +0
        assert torch.equal(buf.view(torch.int32),
                           (acc + 0.0).view(torch.int32))
    else:
        assert _within(buf, product_accum_plain(acc, a, b, s, 1.0),
                       product_accum_error_bound(acc, a, b, s, 1.0))


# --------------------------------------------------------------------------
# lora_matmul (B3) and flash_swa (B8), the serving kernels
#
# Tolerances: lora_matmul sums K in another order than torch.matmul (blocked
# or split K, FMA-contracted), so it is held to lora_matmul_error_bound:
# 2·(K + r + 4) unit roundoffs of |x|@|w| + |s|·(|x|@|a|)@|b|. flash_swa is
# held to the reference's own f32 kernel tolerance (tests/test_kernels.py):
# rtol 2e-5, atol 4e-5, at unit-scale inputs.
# --------------------------------------------------------------------------

from repro_torch.kernels import (flash_swa, flash_swa_plain,  # noqa: E402
                                 lora_matmul, lora_matmul_error_bound,
                                 lora_matmul_plain, swa_attention,
                                 swa_attention_plain)

LORA_MM_CASES = [
    # (M, K, N, r)
    (256, 384, 512, 4),      # tiled, aligned
    (1000, 777, 333, 16),    # tiled, odd K and N (scalar loads)
    (300, 64, 130, 64),      # tiled, r 64: > 48 KB shared memory
    # the tiled body's edges: its first M, rows ragged against its 128-row
    # tile, K shorter than one 64-deep slice or ragged against it, odd N,
    # and r 0 (x@w alone), 1, 3 and 64 at the prefill width
    (17, 3072, 3072, 4),
    (4095, 3072, 1024, 4),
    (1000, 3072, 3072, 4),
    (300, 5, 130, 4),
    (256, 3076, 512, 4),
    (1000, 777, 512, 4),
    (512, 3072, 333, 4),
    (4096, 3072, 3072, 0),
    (4096, 3072, 3072, 1),
    (4096, 3072, 1024, 3),
    (4096, 3072, 3072, 64),
    (8, 3072, 1024, 4),      # split-K, the decode k/v_proj shape
    (7, 777, 333, 1),        # split-K, odd
    (7, 777, 333, 16),
    (16, 100, 50, 64),       # split-K at its largest M
    (1, 8, 8, 1),
]

# the split-K body (M <= 16): the four decode projections of
# paper-llama3.2-3b at batch 8, M 1, 7, 8, 9 and 16, odd K and N (scalar
# loads), r 0, 1, 16 and 64, K past one staging of x (> 1024 rows a chunk)
DECODE_CASES = [
    (8, 3072, 3072, 4), (8, 3072, 1024, 4), (8, 3072, 1024, 4),
    (8, 3072, 3072, 4),
    (1, 3072, 3072, 4), (7, 3072, 1024, 4), (9, 3072, 1024, 4),
    (16, 3072, 3072, 4),
    (8, 777, 333, 4), (9, 777, 333, 16), (16, 777, 333, 64),
    (8, 3072, 1024, 0), (8, 3072, 1024, 1), (8, 3072, 1024, 16),
    (8, 3072, 1024, 64), (16, 3072, 3072, 64),
    (8, 12000, 256, 4), (16, 9000, 200, 3), (3, 40, 7, 2),
    # xlstm-1.3b's sLSTM FFN at batch 8 (K or N 2730: W's scalar loads)
    (8, 2048, 2730, 4), (8, 2730, 2048, 4),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_lora_matmul_decode_body(cuda, case):
    """Within the error bound of the plain version, one launch, and two
    runs bitwise equal (the chunks fold in a fixed order)."""
    x, w, a, b = _lora_inputs(cuda, *case, seed=case[0] + case[2])
    before = lora_matmul.launches
    got = lora_matmul(x, w, a, b, 0.7)
    again = lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 2
    assert torch.equal(_bits(got), _bits(again))
    want = lora_matmul_plain(x, w, a, b, 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.7))


def test_lora_matmul_decode_misaligned_w(cuda):
    """W one element into its storage: the split-K body's 4-byte loads."""
    x, w, a, b = _lora_inputs(cuda, 8, 512, 1028, 4, seed=11)
    wv = w.flatten()[1:1 + 512 * 1024].view(512, 1024)
    assert wv.data_ptr() % 16 != 0
    got = lora_matmul(x, wv, a, b[:, :1024], 0.7)
    torch.cuda.synchronize()
    want = lora_matmul_plain(x, wv, a, b[:, :1024], 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, wv, a, b[:, :1024],
                                                      0.7))


def _lora_inputs(dev, m, k, n, r, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*s, generator=g).to(dev)
            for s in ((m, k), (k, n), (k, r), (r, n))]


@pytest.mark.parametrize("case", LORA_MM_CASES, ids=str)
def test_lora_matmul_matches_plain(cuda, case):
    x, w, a, b = _lora_inputs(cuda, *case)
    before = lora_matmul.launches
    got = lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    want = lora_matmul_plain(x, w, a, b, 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.7))


@pytest.mark.parametrize("m,k,n", [(1000, 777, 333), (4096, 3071, 1024)])
def test_lora_matmul_misaligned_x_view(cuda, m, k, n):
    """x one row into its storage with an odd K: not 16-byte aligned, so the
    tiled body takes its 4-byte copies."""
    base, w, a, b = _lora_inputs(cuda, m + 1, k, n, 4, seed=k)
    x = base[1:]
    assert x.data_ptr() % 16 != 0
    before = lora_matmul.launches
    got = lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    want = lora_matmul_plain(x, w, a, b, 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.7))


def test_lora_matmul_scale_zero_and_refusals(cuda):
    x, w, a, b = _lora_inputs(cuda, 64, 96, 80, 4)
    got = lora_matmul(x, w, a, b, 0.0)
    want = torch.matmul(x, w)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.0))
    before = lora_matmul.launches
    with pytest.raises(ValueError, match="rank"):
        lora_matmul(x, w, torch.ones(96, 65, device=cuda),
                    torch.ones(65, 80, device=cuda), 1.0)
    with pytest.raises(TypeError):
        lora_matmul(x.half(), w, a, b, 1.0)
    with pytest.raises(ValueError, match="grad"):
        lora_matmul(x, w.requires_grad_(True), a, b, 1.0)
    assert lora_matmul.launches == before


def _close_f32(got, want):
    return bool(((got - want).abs() <= 4e-5 + 2e-5 * want.abs()).all())


FLASH_CASES = [
    # (BH, S, d, causal, window[, Sk, q offset]): Sk defaults to S; a q
    # offset of 1 puts q one element into its storage (not 16-byte aligned)
    (4, 256, 64, True, 0),
    (4, 500, 128, True, 0),      # S not a multiple of the 64-row tiles
    (2, 333, 128, True, 64),
    (2, 333, 128, True, 200),
    (2, 500, 128, True, 1000),   # window larger than S
    (2, 256, 128, False, 0),
    (2, 100, 32, False, 30),
    (2, 70, 50, True, 0),        # d not a multiple of 4: scalar loads
    # the edges of the 128- and 64-row query tiles and the 64-key KV tiles
    (2, 1, 128, True, 0),
    (2, 63, 128, True, 0),
    (2, 65, 128, True, 0),
    (2, 127, 128, True, 0),
    (2, 129, 128, True, 0),
    (200, 129, 128, True, 0),    # enough heads for 128-row query tiles
    (200, 333, 128, True, 64),
    # Sq != Sk
    (2, 200, 128, True, 0, 333),
    (2, 333, 128, True, 0, 200),
    (2, 300, 64, False, 0, 129),
    (2, 200, 128, True, 64, 333),
    # windows that cut inside a tile at S 4096
    (2, 4096, 128, True, 1),
    (2, 4096, 128, True, 1024),
    # head dims 64 and 50 (scalar loads)
    (2, 333, 64, True, 0),
    (2, 333, 50, True, 64),
    # q not 16-byte aligned: scalar loads
    (2, 300, 128, True, 0, 300, 1),
    (2, 129, 64, False, 0, 129, 1),
    # rows whose first KV tile is wholly masked (window < the tile's reach)
    (2, 512, 128, True, 100),
    (200, 512, 128, True, 100),
    (2, 256, 64, False, 70),
    # head dims above 128 (padded to 256, one block an SM): gemma3's prefill
    # with its window of 1024 and without, d 200 (padded), scalar loads
    (2, 2048, 256, True, 1024),
    (2, 2048, 256, True, 0),
    (2, 333, 200, True, 64),
    (2, 129, 256, False, 0),
    (2, 300, 256, True, 0, 300, 1),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_swa_matches_plain(cuda, case):
    """Within the reference's f32 tolerance of the plain version, one
    launch a call, and two runs bitwise equal."""
    bh, s, d, causal, window, sk, offset = case + (case[1], 0)[len(case) - 5:]
    g = torch.Generator(device="cpu").manual_seed(s + d)
    base = torch.randn(bh * s * d + offset, generator=g).to(cuda)
    q = base[offset:].view(bh, s, d)
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    k, v = (torch.randn(bh, sk, d, generator=g).to(cuda) for _ in range(2))
    before = flash_swa.launches
    got = flash_swa(q, k, v, causal, window)
    again = flash_swa(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_swa.launches == before + 2
    assert torch.equal(_bits(got), _bits(again))
    assert _close_f32(got, flash_swa_plain(q, k, v, causal, window))


@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 512, 24, 8, 128),
                                         (2, 100, 6, 3, 64),
                                         (1, 4096, 24, 8, 128),
                                         (2, 2048, 16, 8, 256)])
def test_swa_attention_gqa_reads_kv_heads_in_place(cuda, b, s, h, kvh, d):
    g = torch.Generator(device="cpu").manual_seed(h)
    q = torch.randn(b, s, h, d, generator=g).to(cuda)
    k, v = (torch.randn(b, s, kvh, d, generator=g).to(cuda) for _ in range(2))
    got = swa_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert _close_f32(got, swa_attention_plain(q, k, v, True, 0))
    # the same as flash_swa over the repeated heads in (BH, S, D) layout
    rep = h // kvh
    flat = [t.transpose(1, 2).reshape(b * h, s, d).contiguous() for t in
            (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2))]
    ref = flash_swa_plain(*flat).reshape(b, h, s, d).transpose(1, 2)
    assert _close_f32(got, ref)


def test_serving_kernel_path_matches_plain_path(cuda, monkeypatch):
    """paper-tiny prefill + one decode step through the kernels (16 + 16
    lora_matmul and 4 flash_swa launches) against the same run with the
    plain versions patched in: prefill logits rtol / atol 1e-4; decode
    logits rtol 5e-3, atol 8e-3, since a K/V entry whose f32 value differs
    in the last bits can round to the bf16 cache the other way."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.data import make_batch_for
    from repro_torch.models import attention, build_model
    from repro_torch.models import common as model_common

    cfg = dataclasses.replace(get_config("paper-tiny"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(gen, cuda)
    lora = init_lora(gen, params, cfg, LoRAConfig())
    for leaf in lora["layers"]["attn"].values():
        leaf["b"].normal_(0.0, 0.02, generator=gen)
    batch = make_batch_for(cfg, 2, 40, seed=0, device=cuda)

    def run(adapter=lora):
        cache = model.init_cache(2, 64, device=cuda)
        with torch.inference_mode():
            pre, cache = model.prefill(params, batch, cache, lora=adapter,
                                       lora_scale=2.0)
            dec, _ = model.decode_step(params, batch["targets"][:, -1:],
                                       cache, 40, lora=adapter,
                                       lora_scale=2.0)
        torch.cuda.synchronize()
        return pre, dec

    kernels.reset_launch_counts()
    pre, dec = run()
    counts = kernels.launch_counts()
    assert (counts["lora_matmul"], counts["flash_swa"]) == (32, 4)
    # the adapter moves the logits past the comparisons' tolerances
    pre_none, dec_none = run(None)
    assert float((pre - pre_none).abs().max()) > 1e-4 + 1e-4 * float(
        pre_none.abs().max())
    assert float((dec - dec_none).abs().max()) > 8e-3 + 5e-3 * float(
        dec_none.abs().max())
    monkeypatch.setattr(model_common, "lora_dense", kernels.lora_dense_plain)
    monkeypatch.setattr(attention, "swa_attention",
                        kernels.swa_attention_plain)
    pre_p, dec_p = run()
    torch.testing.assert_close(pre, pre_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec, dec_p, rtol=5e-3, atol=8e-3)


def test_windowed_serving_kernel_path_matches_plain_path(cuda, monkeypatch):
    """gemma3-12b-smoke (1 local layer at window 64 + 1 global layer, head
    dim 64): a prompt of 128 (twice the window) and one decode step through
    the kernels (8 + 8 lora_matmul and 2 flash_swa launches, the local one
    windowed, its ring cache of 64 slots) against the plain versions, and
    the decode step against the training forward, on an f32 cache."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import attention, build_model
    from repro_torch.models import common as model_common

    cfg = dataclasses.replace(get_config("gemma3-12b-smoke"),
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(gen, cuda)
    lora = init_lora(gen, params, cfg, LoRAConfig())
    for part in lora["periods"].values():
        for leaf in part["attn"].values():
            leaf["b"].normal_(0.0, 0.02, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda,
                         generator=gen)

    def run():
        cache = model.init_cache(2, 160, torch.float32, device=cuda)
        assert cache["local"]["k"].shape[3] == 64
        with torch.inference_mode():
            pre, cache = model.prefill(params, {"tokens": toks[:, :128]},
                                       cache, lora=lora, lora_scale=2.0)
            dec, _ = model.decode_step(params, toks[:, 128:], cache, 128,
                                       lora=lora, lora_scale=2.0)
        torch.cuda.synchronize()
        return pre, dec

    kernels.reset_launch_counts()
    pre, dec = run()
    counts = kernels.launch_counts()
    assert (counts["lora_matmul"], counts["flash_swa"]) == (16, 2)
    with torch.inference_mode():
        full = model.apply(params, {"tokens": toks}, lora=lora,
                           lora_scale=2.0)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(model_common, "lora_dense", kernels.lora_dense_plain)
    monkeypatch.setattr(attention, "swa_attention",
                        kernels.swa_attention_plain)
    pre_p, dec_p = run()
    torch.testing.assert_close(pre, pre_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec, dec_p, rtol=1e-4, atol=1e-4)


def test_vlm_serving_kernel_path_matches_plain_path(cuda, monkeypatch):
    """internvl2-76b-smoke (16 vision tokens, 2 layers, f32): a prefill of
    the projected vision prefix and 8 text tokens, then 2 decode steps from
    the prefill's true length (24) through the kernels (8 lora_matmul and 2
    flash_swa launches a prefill, 8 lora_matmul a step; ``vision_proj``
    takes neither) against the same run with the plain versions patched
    in, and the decode steps against the training forward, on an f32
    cache: rtol / atol 1e-4."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.data import make_batch_for
    from repro_torch.models import attention, build_model
    from repro_torch.models import common as model_common

    cfg = dataclasses.replace(get_config("internvl2-76b-smoke"),
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(gen, cuda)
    lora = init_lora(gen, params, cfg, LoRAConfig())
    for leaf in lora["layers"]["attn"].values():
        leaf["b"].normal_(0.0, 0.02, generator=gen)
    batch = make_batch_for(cfg, 2, 26, seed=0, device=cuda)  # 10 text
    toks = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    prompt = {"tokens": toks[:, :8], "vision_embeds": batch["vision_embeds"]}

    def run():
        cache = model.init_cache(2, 32, torch.float32, device=cuda)
        with torch.inference_mode():
            pre, cache = model.prefill(params, prompt, cache, lora=lora,
                                       lora_scale=2.0)
            decs = []
            for i in range(2):
                dec, cache = model.decode_step(params, toks[:, 8 + i:9 + i],
                                               cache, 24 + i, lora=lora,
                                               lora_scale=2.0)
                decs.append(dec[:, -1])
        torch.cuda.synchronize()
        return pre, torch.stack(decs, 1)

    kernels.reset_launch_counts()
    pre, dec = run()
    counts = kernels.launch_counts()
    assert (counts["lora_matmul"], counts["flash_swa"]) == (24, 2)
    assert pre.shape == (2, 24, cfg.vocab_size)
    with torch.inference_mode():
        full = model.apply(params, {"tokens": toks[:, :10],
                                    "vision_embeds": batch["vision_embeds"]},
                           lora=lora, lora_scale=2.0)
    torch.testing.assert_close(dec, full[:, 24:26], rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(model_common, "lora_dense", kernels.lora_dense_plain)
    monkeypatch.setattr(attention, "swa_attention",
                        kernels.swa_attention_plain)
    pre_p, dec_p = run()
    torch.testing.assert_close(pre, pre_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec, dec_p, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# bf16 (serving's dtype): B3's two bodies and B8 at every DP, each against
# its bf16 plain version within its bound (``lora_matmul_error_bound`` and
# ``swa_error_bound`` with their bf16 terms), two runs bitwise equal; a
# mix of dtypes raises before any launch
# --------------------------------------------------------------------------

from repro_torch.kernels import swa_error_bound  # noqa: E402
from repro_torch.kernels.lora_matmul import _body  # noqa: E402

BF16_LORA_CASES = [
    # (M, K, N, r): the tiled body with 16-byte loads (K % 8, N % 8), its
    # x@a prepass at r ≤ 4 and at r 64; the split-K body with 8-byte
    # copies of W (N % 4) and of a (r % 4) at the decode widths
    (4096, 3072, 3072, 4), (4096, 3072, 1024, 64), (17, 3072, 3072, 16),
    (64, 3072, 3072, 4), (8, 3072, 3072, 4), (8, 3072, 1024, 64),
    (16, 3072, 3072, 16), (1, 3072, 1024, 4),
    # scalar paths: K or N not a multiple of 8 (tiled), N not a multiple
    # of 4 or r odd (split-K: W's or a's 2-byte loads), r 1
    (1000, 777, 333, 1), (100, 776, 332, 4), (8, 777, 333, 1),
    (9, 777, 333, 3), (16, 3072, 1026, 64), (7, 3072, 1024, 1),
    (4096, 3071, 1024, 4), (1000, 777, 333, 4),
    # the tensor-core body (M > 16, K and N multiples of 8, x and W
    # 16-byte aligned): M 17, 64, 4095 and 4096 at paper-llama3.2-3b's K
    # 3072 and N 1024 / 3072, at r 0 (no adapter), 1, 4 (x@a as m64n8k16)
    # and 64 (m64n64k16, four k16 steps of the adapter's product); K not
    # a multiple of the 64-deep slice, K 8 (one ragged slice), N 1000 (the
    # second 64-column box ragged), N 40 (no second box), r 12, 17 and 33
    # (x@a as m64n16k16, m64n32k16 and m64n64k16, a's columns zero-padded),
    # paper-gpt2's 768 and gemma3-12b's 3840 x 4096
    (17, 3072, 3072, 4), (64, 3072, 3072, 4), (4095, 3072, 1024, 4),
    (4096, 3072, 1024, 0), (4095, 3072, 3072, 1), (64, 3072, 1024, 64),
    (17, 3072, 1024, 0), (4096, 3072, 3072, 1), (64, 3072, 3072, 64),
    (4095, 3072, 1024, 64), (300, 776, 1000, 4), (129, 8, 1024, 4),
    (200, 3072, 40, 4), (1000, 3072, 1024, 17), (1000, 3072, 3072, 33),
    (4096, 768, 768, 4), (4096, 3840, 4096, 4), (300, 3072, 1024, 12),
    # xlstm-1.3b's sLSTM FFN (K or N 2730, not a multiple of 8: the tiled
    # and the SIMT split-K bodies) and its mLSTM q/k/v (4096 x 4096)
    (4096, 2048, 2730, 4), (4096, 2730, 2048, 4), (8, 2048, 2730, 4),
    (8, 2730, 2048, 4), (4096, 4096, 4096, 4), (8, 4096, 4096, 4),
]


def _bf16_inputs(dev, m, k, n, r, seed=0):
    return [t.to(torch.bfloat16) for t in _lora_inputs(dev, m, k, n, r, seed)]


@pytest.mark.parametrize("case", BF16_LORA_CASES, ids=str)
def test_lora_matmul_bf16_matches_plain(cuda, case):
    """Within the error bound of the plain version, two runs bitwise
    equal, both counted as bf16 launches and, where ``_body`` picks the
    tensor cores, as tensor-core launches (none elsewhere)."""
    x, w, a, b = _bf16_inputs(cuda, *case, seed=sum(case))
    m, k, n, _ = case
    tc = 2 * (_body(m, k, n, True, True) == "tensor-core")
    before = (lora_matmul.launches, lora_matmul.bf16_launches,
              lora_matmul.bf16_tc_launches)
    got = lora_matmul(x, w, a, b, 0.7)
    again = lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert (lora_matmul.launches, lora_matmul.bf16_launches,
            lora_matmul.bf16_tc_launches) == (
        before[0] + 2, before[1] + 2, before[2] + tc)
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(again))
    want = lora_matmul_plain(x, w, a, b, 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.7))


def test_lora_matmul_bf16_misaligned_views(cuda):
    """x one row into its storage (odd K: the tiled body's 2-byte loads)
    and W one element into its storage (the split-K body's)."""
    base, w, a, b = _bf16_inputs(cuda, 1001, 777, 333, 4, seed=3)
    x = base[1:]
    assert x.data_ptr() % 16 != 0
    got = lora_matmul(x, w, a, b, 0.7)
    x8, w8, a8, b8 = _bf16_inputs(cuda, 8, 512, 1028, 4, seed=4)
    wv = w8.flatten()[1:1 + 512 * 1024].view(512, 1024)
    assert wv.data_ptr() % 8 != 0
    got8 = lora_matmul(x8, wv, a8, b8[:, :1024], 0.7)
    torch.cuda.synchronize()
    assert _within(got, lora_matmul_plain(x, w, a, b, 0.7),
                   lora_matmul_error_bound(x, w, a, b, 0.7))
    assert _within(got8, lora_matmul_plain(x8, wv, a8, b8[:, :1024], 0.7),
                   lora_matmul_error_bound(x8, wv, a8, b8[:, :1024], 0.7))


def test_lora_matmul_bf16_misaligned_x_takes_simt(cuda):
    """x one row into its storage at K 3072 (6 KB rows: still 16-byte
    aligned) takes the tensor cores; 8 bf16 into a row (16 bytes) too; one
    element in (2 bytes) does not, nor does f32 at a served shape."""
    base, w, a, b = _bf16_inputs(cuda, 4097, 3072, 1024, 4, seed=5)
    flat = base.flatten()
    cases = [(base[1:], 1), (flat[8:8 + 4096 * 3072].view(4096, 3072), 1),
             (flat[1:1 + 4096 * 3072].view(4096, 3072), 0)]
    for x, tc in cases:
        before = lora_matmul.bf16_tc_launches
        got = lora_matmul(x, w, a, b, 0.7)
        torch.cuda.synchronize()
        assert lora_matmul.bf16_tc_launches == before + tc
        assert _within(got, lora_matmul_plain(x, w, a, b, 0.7),
                       lora_matmul_error_bound(x, w, a, b, 0.7))
    before = lora_matmul.bf16_tc_launches
    lora_matmul(*(t.float() for t in (base[1:], w, a, b)), 0.7)
    assert lora_matmul.bf16_tc_launches == before


# the tensor-core split-K body (bf16, M <= 16, what TMA can describe):
# every served decode projection (paper-llama3.2-3b and paper-gpt2 at
# batch 8, gemma3-12b at batch 2, each also at the serve launcher's batch
# 2), M 1, 7, 9 and 16, r 0, 1, 16 and 64 (x@a over one to eight mma
# column groups), odd r (a's rows end inside a 16-byte copy), K not a
# multiple of the chunk or of 64, K 8 (one ragged slice), N ragged to a
# 64- or 128-column block (1000, 136) or below one box (8), and x staged
# in several passes (chunks past 2048 / 1024 columns at M 8 / 16)
BF16_DECODE_CASES = [
    (8, 3072, 3072, 4), (8, 3072, 1024, 4), (2, 3072, 3072, 4),
    (2, 3072, 1024, 4), (8, 768, 768, 4), (2, 768, 768, 4),
    (2, 3840, 4096, 4), (2, 3840, 2048, 4), (2, 4096, 3840, 4),
    (8, 3840, 2048, 4),
    (1, 3072, 3072, 4), (7, 3072, 1024, 4), (9, 3072, 1024, 4),
    (16, 3072, 3072, 4),
    (8, 3072, 1024, 0), (8, 3072, 1024, 1), (9, 3072, 1024, 16),
    (16, 3072, 1024, 64), (8, 3072, 3072, 64),
    (8, 3000, 1000, 4), (16, 776, 1000, 3), (5, 1000, 136, 5),
    (3, 40, 8, 2), (8, 8, 64, 1),
    (8, 40000, 64, 4), (16, 20000, 200, 16),
]


@pytest.mark.parametrize("case", BF16_DECODE_CASES, ids=str)
def test_lora_matmul_bf16_decode_body(cuda, case):
    """Within the error bound of the plain version, two runs bitwise equal,
    both counted as launches of the tensor-core split-K body and of no
    other tensor-core body."""
    m, k, n, r = case
    assert _body(m, k, n, True, True) == "tensor-core split-K"
    x, w, a, b = _bf16_inputs(cuda, *case, seed=sum(case))
    before = (lora_matmul.launches, lora_matmul.bf16_tc_decode_launches,
              lora_matmul.bf16_tc_launches)
    got = lora_matmul(x, w, a, b, 0.7)
    again = lora_matmul(x, w, a, b, 0.7)
    torch.cuda.synchronize()
    assert (lora_matmul.launches, lora_matmul.bf16_tc_decode_launches,
            lora_matmul.bf16_tc_launches) == (
        before[0] + 2, before[1] + 2, before[2])
    assert torch.equal(_bits(got), _bits(again))
    want = lora_matmul_plain(x, w, a, b, 0.7)
    assert _within(got, want, lora_matmul_error_bound(x, w, a, b, 0.7))


def test_lora_matmul_bf16_decode_misaligned_x_takes_simt(cuda):
    """A decode x one row into its storage at K 3072 (still 16-byte
    aligned) takes the tensor-core split-K body; 8 bf16 into a row too; one
    element in does not, nor does f32 at the same shape."""
    base, w, a, b = _bf16_inputs(cuda, 9, 3072, 1024, 4, seed=6)
    flat = base.flatten()
    cases = [(base[1:], 1), (flat[8:8 + 8 * 3072].view(8, 3072), 1),
             (flat[1:1 + 8 * 3072].view(8, 3072), 0)]
    for x, tc in cases:
        before = lora_matmul.bf16_tc_decode_launches
        got = lora_matmul(x, w, a, b, 0.7)
        torch.cuda.synchronize()
        assert lora_matmul.bf16_tc_decode_launches == before + tc
        assert _within(got, lora_matmul_plain(x, w, a, b, 0.7),
                       lora_matmul_error_bound(x, w, a, b, 0.7))
    before = lora_matmul.bf16_tc_decode_launches
    lora_matmul(*(t.float() for t in (base[1:], w, a, b)), 0.7)
    assert lora_matmul.bf16_tc_decode_launches == before


from repro_torch.kernels.flash_swa import _body as _flash_body  # noqa: E402

BF16_FLASH_CASES = [
    # (B, S, H, KVH, d, causal, window): paper-gpt2 (d 64, MHA),
    # paper-llama3.2-3b (d 128, GQA 24/8), gemma3-12b (d 256, GQA 16/8,
    # window 1024 and none); ragged S, windows, non-causal, d 50 (scalar)
    (2, 512, 12, 12, 64, True, 0), (2, 512, 24, 8, 128, True, 0),
    (1, 2048, 16, 8, 256, True, 1024), (1, 2048, 16, 8, 256, True, 0),
    (2, 333, 8, 4, 128, True, 64), (2, 500, 8, 2, 128, True, 1000),
    (2, 256, 4, 4, 128, False, 0), (2, 129, 4, 2, 256, False, 70),
    (2, 300, 4, 4, 50, True, 0), (2, 65, 4, 4, 200, True, 0),
    # the tensor-core body's edges: S not a multiple of its 128 query rows
    # (one row past a tile, one short of it), windows smaller than its KV
    # tile (128 keys, 64 at DP 256), non-causal at DP 256 with and without
    # a window, a head dim below 64 and one that leaves a column box of
    # DP 256 unloaded (d 136: three boxes of four)
    (2, 129, 8, 4, 128, True, 0), (1, 383, 4, 2, 64, True, 0),
    (2, 300, 8, 8, 128, True, 100), (1, 700, 4, 2, 256, True, 50),
    (2, 256, 4, 4, 64, True, 1), (2, 333, 4, 2, 256, False, 0),
    (1, 500, 8, 4, 256, False, 300), (2, 200, 4, 4, 32, True, 0),
    (2, 260, 4, 2, 136, True, 0),
    # deepseek-v2-236b's MLA prefill: q and k of 192 (nope 128 + rope 64),
    # v zero-padded to 192, MHA
    (1, 512, 16, 16, 192, True, 0), (2, 300, 4, 4, 192, True, 0),
    # zamba2-7b's shared block: MHA at head dim 112 (DP 128, the second
    # column box part past d)
    (1, 512, 8, 8, 112, True, 0), (2, 300, 4, 4, 112, False, 0),
]


def _flash_tc(b, s, h, kvh, d):
    """Whether a contiguous bf16 (B, S, H, D) launch takes the tensor
    cores, by the wrapper's plan."""
    st = (s * h * d, h * d, d, s * kvh * d, kvh * d, d, s * kvh * d,
          kvh * d, d)
    return _flash_body(True, d, st, (b, s, h, b, s, kvh, b, s, kvh),
                       True) == "tensor-core"


@pytest.mark.parametrize("case", BF16_FLASH_CASES, ids=str)
def test_swa_attention_bf16_matches_plain(cuda, case):
    """Within the error bound of the plain version, two runs bitwise
    equal, counted as bf16 launches and, where ``_body`` picks the tensor
    cores (every case but d 50), as tensor-core launches."""
    b, s, h, kvh, d, causal, window = case
    g = torch.Generator(device="cpu").manual_seed(s + d + h)
    q = torch.randn(b, s, h, d, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(b, s, kvh, d, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    tc = 2 * _flash_tc(b, s, h, kvh, d)
    assert tc == 2 * (d % 8 == 0)
    before = (flash_swa.launches, flash_swa.bf16_launches,
              flash_swa.bf16_tc_launches)
    got = swa_attention(q, k, v, causal, window)
    again = swa_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert (flash_swa.launches, flash_swa.bf16_launches,
            flash_swa.bf16_tc_launches) == (
        before[0] + 2, before[1] + 2, before[2] + tc)
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got.float()), _bits(again.float()))
    want = swa_attention_plain(q, k, v, causal, window)
    assert _within(got.float(), want.float(),
                   swa_error_bound(q, k, v, causal, window))


@pytest.mark.parametrize("sq, sk, causal, window", [
    (300, 500, True, 0), (500, 300, True, 0), (200, 333, False, 64),
    (129, 700, True, 256)], ids=str)
def test_flash_swa_bf16_sk_not_sq(cuda, sq, sk, causal, window):
    """The (BH, S, D) layout with Sk ≠ Sq through the tensor cores: within
    the bound of the plain version, two runs bitwise equal."""
    g = torch.Generator(device="cpu").manual_seed(sq + sk)
    q = torch.randn(6, sq, 128, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(6, sk, 128, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    before = flash_swa.bf16_tc_launches
    got = flash_swa(q, k, v, causal, window)
    again = flash_swa(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_swa.bf16_tc_launches == before + 2
    assert torch.equal(_bits(got.float()), _bits(again.float()))
    bound = swa_error_bound(q[:, :, None], k[:, :, None], v[:, :, None],
                            causal, window)[:, :, 0]
    assert _within(got.float(),
                   flash_swa_plain(q, k, v, causal, window).float(), bound)


@pytest.mark.parametrize("sq", [64, 333, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_cross_attention_shapes(cuda, sq, dtype):
    """whisper's cross-attention: Sq decoder rows against Sk 1500 encoder
    keys, MHA 16/16, d 64, non-causal (1500 keys end in a masked tail
    tile): within the bound of the plain version, two runs bitwise equal;
    bf16 through the tensor cores, and bitwise the plain version on the
    exact-rounding probe at Sq ≠ Sk."""
    g = torch.Generator(device="cpu").manual_seed(sq)
    q = torch.randn(2, sq, 16, 64, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, 1500, 16, 64, generator=g).to(cuda, dtype)
            for _ in range(2))
    before = flash_swa.bf16_tc_launches
    got = swa_attention(q, k, v, False, 0)
    again = swa_attention(q, k, v, False, 0)
    torch.cuda.synchronize()
    low = dtype == torch.bfloat16
    assert flash_swa.bf16_tc_launches == before + 2 * low
    assert torch.equal(_bits(got.float()), _bits(again.float()))
    assert _within(got.float(), swa_attention_plain(q, k, v, False,
                                                    0).float(),
                   swa_error_bound(q, k, v, False, 0))
    if low:
        q, k, v, faults = probes.swa_probe(2, sq, 16, 16, 64, causal=False,
                                           sk=1500, device=cuda, seed=sq)
        got = swa_attention(q, k, v, False, 0)
        assert torch.equal(_bits(got.float()), _bits(
            swa_attention_plain(q, k, v, False, 0).float()))
        assert min(probes.differing(got, faults).values()) > 0


def test_flash_swa_bf16_misaligned_q(cuda):
    """q one element into its storage: the SIMT body's scalar loads (TMA
    cannot describe it); q 8 elements in (16 bytes): the tensor cores."""
    g = torch.Generator(device="cpu").manual_seed(1)
    base = torch.randn(2 * 300 * 128 + 8, generator=g).to(cuda,
                                                           torch.bfloat16)
    k, v = (torch.randn(2, 300, 128, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    for off, tc in ((1, 0), (8, 1)):
        q = base[off:off + 2 * 300 * 128].view(2, 300, 128)
        before = flash_swa.bf16_tc_launches
        got = flash_swa(q, k, v, True, 0)
        torch.cuda.synchronize()
        assert flash_swa.bf16_tc_launches == before + tc
        assert got.dtype == torch.bfloat16
        bound = swa_error_bound(q[:, :, None], k[:, :, None], v[:, :, None])
        assert _within(got.float(), flash_swa_plain(q, k, v).float(),
                       bound[:, :, 0])


from repro_torch.kernels import probes  # noqa: E402
from repro_torch.kernels.lora_matmul import (_sm_count,  # noqa: E402
                                             _split_plan,
                                             _tc_split_plan)

BF16_PROBE_LORA = [
    # (M, K, N, r): the split-K body at 1, 2, 4 and 8 K chunks of an H100
    # (132 SMs: K 200 → 2 chunks, 3072 × 3072 → 4, 3072 × 1024 and
    # paper-gpt2's 768 × 768 → 8), W's and a's 2-byte paths (N 333, r 3);
    # the tiled body's two prepasses (r ≤ 4, r 64) at prefill rows, and its
    # scalar path (odd K, N)
    (8, 3072, 3072, 4), (16, 3072, 1024, 64), (2, 768, 768, 4),
    (1, 200, 512, 1), (9, 777, 333, 3), (1, 64, 256, 4),
    (4096, 3072, 3072, 4), (64, 3072, 1024, 64), (17, 777, 333, 3),
    (1000, 3840, 2048, 16),
    # the tensor-core body: every served q/k/v/o shape's kind
    # (paper-llama3.2-3b's K 3072 at N 3072 / 1024, paper-gpt2's 768,
    # gemma3-12b's 3840 x 4096 / 2048 and 4096 x 3840) at M 4096 and 64, x@a
    # at every N of its product (r 1 and 4: 8; 12: 16; 17: 32; 64: 64),
    # ragged M, K and N, no second W box
    (4096, 3072, 1024, 4), (64, 3072, 3072, 4), (64, 3072, 1024, 4),
    (4096, 768, 768, 4), (64, 768, 768, 4), (4096, 3840, 4096, 4),
    (4096, 3840, 2048, 4), (4096, 4096, 3840, 4), (4095, 3072, 1024, 1),
    (17, 776, 1000, 64), (300, 3072, 40, 17), (1000, 3840, 2048, 64),
    (129, 3072, 1024, 12),
    # the tensor-core split-K body at every served decode shape's kind
    # (gemma3-12b's at batch 2, paper-llama3.2-3b's k/v at batch 8; the
    # first four above are its too) and with x staged in several passes
    (2, 3840, 4096, 4), (2, 3840, 2048, 4), (2, 4096, 3840, 4),
    (8, 3072, 1024, 4), (8, 40000, 64, 4), (16, 20000, 200, 16),
]


@pytest.mark.parametrize("case", BF16_PROBE_LORA, ids=str)
def test_lora_matmul_bf16_rounds_x_at_a_once(cuda, case):
    """The probe's exact inputs (``kernels/probes.py``): the kernel equals
    its plain version and the exact answer bit for bit, which rounding
    x@a per K chunk of the body's plan, or not at all, would not; two runs
    bitwise equal, counted as launches of the tensor-core body that
    ``_body`` picks (the K chunks of the split-K bodies from their own
    plans)."""
    m, k, n, r = case
    body = _body(m, k, n, True, True)
    plan = _tc_split_plan if body == "tensor-core split-K" else _split_plan
    chunk = plan(n, k, _sm_count(0))[1] if m <= 16 else 64
    x, w, a, b, scale, want, faults = probes.lora_probe(
        m, k, n, r, chunk=chunk, device=cuda, seed=m + k)
    tc = 2 * (body == "tensor-core"), 2 * (body == "tensor-core split-K")
    before = (lora_matmul.bf16_tc_launches,
              lora_matmul.bf16_tc_decode_launches)
    got = lora_matmul(x, w, a, b, scale)
    again = lora_matmul(x, w, a, b, scale)
    torch.cuda.synchronize()
    assert (lora_matmul.bf16_tc_launches,
            lora_matmul.bf16_tc_decode_launches) == (before[0] + tc[0],
                                                     before[1] + tc[1])
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(got, lora_matmul_plain(x, w, a, b, scale))
    assert torch.equal(got, want)
    assert min(probes.differing(got, faults).values()) > 0


BF16_PROBE_FLASH = [
    # (B, S, H, KVH, d, causal): DP 64 (paper-gpt2's MHA), 128 (Llama's GQA
    # 24/8), 256 (gemma3's GQA 16/8; deepseek's MLA at d 192, one column
    # box past d) at their prefill lengths, non-causal, and d 66 (the
    # scalar loads)
    (2, 512, 12, 12, 64, True), (2, 512, 24, 8, 128, True),
    (2, 512, 16, 16, 192, True), (2, 512, 8, 8, 112, True),
    (1, 2048, 16, 8, 256, True), (2, 300, 4, 2, 128, False),
    (2, 130, 4, 4, 66, True),
]


@pytest.mark.parametrize("case", BF16_PROBE_FLASH, ids=str)
def test_swa_attention_bf16_rounds_p_before_pv(cuda, case):
    """The probe's inputs: the kernel equals its plain version bit for bit,
    which leaving p unrounded, or l summing the rounded p, would not; the
    tensor cores take every case but d 66."""
    b, s, h, kvh, d, causal = case
    q, k, v, faults = probes.swa_probe(b, s, h, kvh, d, causal=causal,
                                       device=cuda, seed=s + d)
    before = flash_swa.bf16_tc_launches
    got = swa_attention(q, k, v, causal, 0)
    torch.cuda.synchronize()
    assert flash_swa.bf16_tc_launches == before + _flash_tc(b, s, h, kvh, d)
    assert torch.equal(_bits(got.float()),
                       _bits(swa_attention_plain(q, k, v, causal, 0).float()))
    assert min(probes.differing(got, faults).values()) > 0


def test_bf16_mixes_raise_and_launch_nothing(cuda):
    """A bf16 operand beside f32 ones (either way round) is a TypeError, on
    the card as on the CPU: never computed by the plain version."""
    x, w, a, b = _lora_inputs(cuda, 64, 96, 80, 4)
    q = torch.randn(1, 64, 4, 64, device=cuda)
    kv = torch.randn(1, 64, 2, 64, device=cuda)
    before = (lora_matmul.launches, flash_swa.launches)
    for i in range(4):
        args = [x, w, a, b]
        args[i] = args[i].bfloat16()
        with pytest.raises(TypeError):
            lora_matmul(*args, 1.0)
        with pytest.raises(TypeError):
            lora_matmul(*[t.bfloat16() if j != i else t
                          for j, t in enumerate((x, w, a, b))], 1.0)
    for i in range(3):
        args = [q, kv, kv]
        args[i] = args[i].bfloat16()
        with pytest.raises(TypeError):
            swa_attention(*args)
    assert (lora_matmul.launches, flash_swa.launches) == before
