"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode on the CPU), plus the wrappers' CPU behaviour.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there).

Tolerances: the plain ``factor_mean`` sums in the reference kernel's slot
order, so the two agree to a few f32 ulps (rtol 1e-6). The plain
``fedex_fold`` computes the rank-r products with ``torch.matmul`` where the
Pallas kernel uses ``jnp.dot``: both within ``fold_error_bound`` of the exact
value, so they must agree within that bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import factor_mean as jax_factor_mean  # noqa: E402
from repro.kernels import fedex_fold as jax_fedex_fold  # noqa: E402
from repro.kernels.factor_mean import lora_factor_mean  # noqa: E402
from repro.kernels.fedex_residual import fedex_residual_apply  # noqa: E402
from repro_torch.kernels import (factor_mean, factor_mean_plain,  # noqa: E402
                                 fedex_fold, fedex_fold_plain)
from repro_torch.kernels.fedex_residual import fold_error_bound  # noqa: E402


def _inputs(c, lead, m, n, r, *, zero_lanes=(), seed=0):
    rng = np.random.default_rng(seed)
    w0 = (rng.standard_normal((*lead, m, n)) * 0.02).astype(np.float32)
    a = (rng.standard_normal((c, *lead, m, r)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((c, *lead, r, n)) * 0.01).astype(np.float32)
    w = rng.random(c) + 0.1
    w[list(zero_lanes)] = 0.0
    w = (w / w.sum()).astype(np.float32)
    return w0, a, b, w


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


FOLD_CASES = {
    "aligned": (3, 256, 256, 4, ()),
    "tile-indivisible": (2, 300, 200, 4, ()),
    "one-client": (1, 64, 128, 4, ()),
    "zero-weight-lanes": (4, 128, 96, 4, (1, 3)),
    "rank-16": (3, 64, 80, 16, ()),
}


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_plain_matches_pallas(case, weighted):
    c, m, n, r, zero = FOLD_CASES[case]
    w0, a, b, w = _inputs(c, (), m, n, r, zero_lanes=zero)
    ref = np.asarray(fedex_residual_apply(
        jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(w) if weighted else None, scale=2.0,
        bm=min(256, m), bn=min(256, n), interpret=True))
    tw0, ta, tb, tw = _t(w0, a, b, w)
    wts = tw if weighted else None
    got = fedex_fold_plain(tw0, ta, tb, 2.0, wts)
    bound = fold_error_bound(tw0, ta, tb, 2.0, wts).numpy()
    assert got.shape == ref.shape
    assert np.all(np.abs(got.numpy() - ref) <= bound)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
def test_fold_wrapper_stacked_layers_matches_ops(weighted):
    """Client-leading (C, L, m, r) stacks through the wrapper (CPU → plain
    version) against the reference's vmapped ``ops.fedex_fold`` on its
    (L, C, m, r) kernel layout."""
    w0, a, b, w = _inputs(3, (2,), 72, 136, 4, zero_lanes=(1,))
    ref = np.asarray(jax_fedex_fold(
        jnp.asarray(w0), jnp.moveaxis(jnp.asarray(a), 0, -3),
        jnp.moveaxis(jnp.asarray(b), 0, -3), 2.0,
        weights=jnp.asarray(w) if weighted else None, interpret=True))
    tw0, ta, tb, tw = _t(w0, a, b, w)
    wts = tw if weighted else None
    got = fedex_fold(tw0, ta, tb, 2.0, weights=wts)
    bound = fold_error_bound(tw0, ta, tb, 2.0, wts).numpy()
    assert np.all(np.abs(got.numpy() - ref) <= bound)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
@pytest.mark.parametrize("shape", [(4, 96, 4), (3, 300, 7), (1, 16, 16)],
                         ids=str)
def test_factor_mean_plain_matches_pallas(shape, weighted):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.random(shape[0]).astype(np.float32) + 0.1
    w = (w / w.sum()).astype(np.float32)
    ref = np.asarray(lora_factor_mean(
        jnp.asarray(x), jnp.asarray(w) if weighted else None,
        bm=min(256, shape[1]), bn=min(256, shape[2]), interpret=True))
    tx, tw = _t(x, w)
    got = factor_mean_plain(tx, tw if weighted else None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "uniform"])
def test_factor_mean_wrapper_stacked_layers_matches_ops(weighted):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 40, 4)).astype(np.float32)
    w = np.array([0.5, 0.0, 0.3, 0.2], np.float32)
    ref = np.asarray(jax_factor_mean(
        jnp.asarray(x), jnp.asarray(w) if weighted else None, interpret=True))
    tx, tw = _t(x, w)
    got = factor_mean(tx, tw if weighted else None).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_zero_weight_lanes_are_exact_noops():
    """Dropping the zero-weight lanes from the stack changes nothing, bit
    for bit (0·x adds exactly 0 to every sum)."""
    w0, a, b, w = _inputs(4, (2,), 48, 64, 4, zero_lanes=(0, 2))
    tw0, ta, tb, tw = _t(w0, a, b, w)
    live = torch.tensor([1, 3])
    full = fedex_fold(tw0, ta, tb, 2.0, weights=tw)
    kept = fedex_fold(tw0, ta[live], tb[live], 2.0, weights=tw[live])
    assert torch.equal(full, kept)
    assert torch.equal(factor_mean(ta, tw), factor_mean(ta[live], tw[live]))


def test_cpu_wrappers_use_plain_versions_and_count_nothing():
    w0, a, b, w = _inputs(2, (2,), 16, 32, 4)
    tw0, ta, tb, tw = _t(w0, a, b, w)
    f0, m0 = fedex_fold.launches, factor_mean.launches
    buf = tw0.clone()
    out = fedex_fold(buf, ta, tb, 1.5, weights=tw, out=buf)
    assert out is buf
    assert torch.equal(buf, fedex_fold_plain(tw0, ta, tb, 1.5, tw))
    assert torch.equal(factor_mean(ta, tw), factor_mean_plain(ta, tw))
    assert (fedex_fold.launches, factor_mean.launches) == (f0, m0)


def test_wrappers_validate_inputs():
    w0, a, b, w = _inputs(2, (2,), 16, 32, 4)
    tw0, ta, tb, tw = _t(w0, a, b, w)
    with pytest.raises(TypeError):
        fedex_fold(tw0.double(), ta, tb, 1.0)
    with pytest.raises(ValueError):
        fedex_fold(tw0, ta[:, :, :8], tb, 1.0)  # m disagrees
    with pytest.raises(ValueError):
        fedex_fold(tw0, ta[0], tb[0], 1.0)  # no client axis
    with pytest.raises(ValueError):
        fedex_fold(tw0, ta, tb, 1.0, weights=tw[:1])
    with pytest.raises(TypeError):
        factor_mean(ta.half())
    with pytest.raises(ValueError):
        factor_mean(ta, torch.ones(3))
