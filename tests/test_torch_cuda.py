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

from repro_torch.kernels import (factor_mean, factor_mean_plain,  # noqa: E402
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
    w0, a, b, w = _inputs(cuda, 2, 2, 32, 128, 4)
    f0, m0 = fedex_fold.launches, factor_mean.launches
    fedex_fold(w0, a, b, 1.0, weights=w)
    factor_mean(a, w)
    assert (fedex_fold.launches, factor_mean.launches) == (f0 + 1, m0 + 1)
    with pytest.raises(ValueError):
        fedex_fold(w0.transpose(-1, -2), a, b.transpose(-1, -2), 1.0)
    with pytest.raises(TypeError):
        factor_mean(a.double(), None)
    assert (fedex_fold.launches, factor_mean.launches) == (f0 + 1, m0 + 1)
