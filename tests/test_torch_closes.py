"""The port's reinit, keep_local, fedex_svd and hetero closes against the JAX
package: the plain versions of ``product_fold``, ``perclient_fold`` and
``hetero_fold`` against the Pallas kernels in interpret mode, and each
engine close against the JAX ``RoundCloseEngine`` (backends ``jnp`` and
``pallas``-interpret) on identical numpy-made W0 leaves and client stacks.

Tolerances, with their reasons:
* the per-lane folds and the reinit / keep_local closes sum in other orders
  than the reference (``torch.matmul`` against ``jnp.dot`` / ``einsum``):
  held to ``product_error_bound`` / ``perclient_error_bound`` /
  ``hetero_error_bound``, 2·(C + r + 4) unit roundoffs of the magnitudes
  each element carries;
* the fedex_svd and hetero closes decompose two (C·r)² Grams with another
  LAPACK driver, and the Gram squaring keeps about half of the f32 digits:
  the folded update (new W0 − old W0) within 1e-4 of its Frobenius norm,
  and W0 within 1e-5 of the leaf's norm. Eigenvector signs may differ, so
  only sign-invariant quantities are compared: A′B′, each client's
  leading-rᵢ product a′ᵢb′ᵢ and the folded W0s, never A′ or B′;
* ā, b̄ within 2·C unit roundoffs of Σ|w||x|; the divergence rtol 1e-4.
Within the port, the uniform reinit and keep_local closes are the operator
composition bit for bit, and masked lanes and columns holding NaN change
nothing, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core.engine import RoundCloseEngine as JaxEngine  # noqa: E402
from repro.kernels import hetero_fold as jax_hetero_fold  # noqa: E402
from repro.kernels import perclient_fold as jax_perclient_fold  # noqa: E402
from repro.kernels import product_fold as jax_product_fold  # noqa: E402
from repro.kernels.fedex_residual import (hetero_fold_apply,  # noqa: E402
                                          perclient_fold_apply,
                                          product_fold_apply)
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.engine import RoundCloseEngine  # noqa: E402
from repro_torch.core.hetero import (hetero_fedex_aggregate,  # noqa: E402
                                     pad_adapters)
from repro_torch.kernels import (hetero_error_bound, hetero_fold,  # noqa: E402
                                 hetero_fold_plain, perclient_error_bound,
                                 perclient_fold, perclient_fold_plain,
                                 product_error_bound, product_fold,
                                 product_fold_plain)
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
L, D, KV, R = 2, 48, 16, 4
SCALE = 2.0
KEYS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _lane_inputs(c, lead, m, n, r, *, zero_lanes=(), seed=0):
    rng = np.random.default_rng(seed)
    w0 = (rng.standard_normal((c, *lead, m, n)) * 0.02).astype(np.float32)
    a = (rng.standard_normal((c, *lead, m, r)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((c, *lead, r, n)) * 0.01).astype(np.float32)
    w = rng.random(c) + 0.1
    w[list(zero_lanes)] = 0.0
    w = (w / w.sum()).astype(np.float32)
    oa = (rng.standard_normal((*lead, m, r)) * 0.02).astype(np.float32)
    ob = (rng.standard_normal((*lead, r, n)) * 0.01).astype(np.float32)
    return w0, a, b, w, oa, ob


def _within(got, want, bound):
    got, want = np.asarray(got), np.asarray(want)
    bound = bound.numpy() if isinstance(bound, torch.Tensor) else bound
    return bool(np.all(np.abs(got - want) <= bound))


# (C, m, n, r, zero-weight lanes)
LANE_CASES = {
    "uniform": (3, 64, 128, 4, ()),
    "odd-shape": (2, 100, 60, 4, ()),
    "partial": (4, 48, 96, 4, (1, 3)),
    "one-lane": (1, 40, 72, 8, ()),
    "rank-16": (3, 32, 64, 16, ()),
}


def _weights(w, kind):
    return np.full_like(w, 1.0 / len(w)) if kind == "uniform" else w


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_product_fold_plain_matches_pallas(case):
    c, m, n, r, zero = LANE_CASES[case]
    w0, a, b, w, _, _ = _lane_inputs(c, (), m, n, r, zero_lanes=zero)
    s = _weights(w, case)
    if c > 1:
        s = s.copy()
        s[0] = -s[0]  # signed
    ref = product_fold_apply(jnp.asarray(w0[0]), jnp.asarray(a),
                             jnp.asarray(b), jnp.asarray(s), scale=SCALE,
                             bm=min(256, m), bn=min(256, n), interpret=True)
    tw0, ta, tb, ts = _t(w0[0], a, b, s)
    got = product_fold_plain(tw0, ta, tb, ts, SCALE)
    assert _within(got, ref, product_error_bound(tw0, ta, tb, ts, SCALE))
    assert torch.equal(product_fold(tw0, ta, tb, ts, SCALE), got)


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_perclient_fold_plain_matches_pallas(case):
    c, m, n, r, zero = LANE_CASES[case]
    w0, a, b, w, _, _ = _lane_inputs(c, (), m, n, r, zero_lanes=zero)
    w = _weights(w, case)
    ref = np.asarray(perclient_fold_apply(
        jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
        scale=SCALE, bm=min(256, m), bn=min(256, n), interpret=True))
    tw0, ta, tb, tw = _t(w0, a, b, w)
    lanes = list(tw0)
    got = perclient_fold_plain(lanes, ta, tb, tw, SCALE)
    bound = perclient_error_bound(lanes, ta, tb, tw, SCALE)
    for i in range(c):
        assert _within(got[i], ref[i], bound[i]), i
    wrapped = perclient_fold(lanes, ta, tb, tw, SCALE)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got))


HETERO_RANKS = {
    "uniform": [-1, -1, -1],
    "odd-shape": [2, -1],
    "partial": [4, 0, 3, 1],
    "one-lane": [8],
    "rank-16": [16, 5, 0],
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_hetero_fold_plain_matches_pallas(case):
    c, m, n, r, zero = LANE_CASES[case]
    w0, a, b, w, oa, ob = _lane_inputs(c, (), m, n, r, zero_lanes=zero)
    w = _weights(w, case)
    ranks = np.array(HETERO_RANKS[case], np.int32)
    ref = np.asarray(hetero_fold_apply(
        jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
        jnp.asarray(ranks), jnp.asarray(oa), jnp.asarray(ob), scale=SCALE,
        bm=min(256, m), bn=min(256, n), interpret=True))
    tw0, ta, tb, tw, tr, toa, tob = _t(w0, a, b, w, ranks, oa, ob)
    lanes = list(tw0)
    got = hetero_fold_plain(lanes, ta, tb, tw, tr, toa, tob, SCALE)
    bound = hetero_error_bound(lanes, ta, tb, tw, tr, toa, tob, SCALE)
    for i in range(c):
        assert _within(got[i], ref[i], bound[i]), i


def test_stacked_layer_wrappers_match_ops():
    """Client-leading (C, L, …) stacks through the port's wrappers (CPU →
    plain versions) against the reference's vmapped ``ops`` wrappers."""
    w0, a, b, w, oa, ob = _lane_inputs(3, (2,), 40, 72, 4, zero_lanes=(1,))
    ranks = np.array([2, 4, -1], np.int32)
    tw0, ta, tb, tw, tr, toa, tob = _t(w0, a, b, w, ranks, oa, ob)
    ref = np.asarray(jax_product_fold(
        jnp.asarray(w0[0]), jnp.moveaxis(jnp.asarray(a), 0, -3),
        jnp.moveaxis(jnp.asarray(b), 0, -3), jnp.asarray(w), SCALE,
        interpret=True))
    assert _within(product_fold(tw0[0], ta, tb, tw, SCALE), ref,
                   product_error_bound(tw0[0], ta, tb, tw, SCALE))
    ref = np.asarray(jax_perclient_fold(
        jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
        SCALE, interpret=True))
    got = perclient_fold(list(tw0), ta, tb, tw, SCALE)
    bound = perclient_error_bound(list(tw0), ta, tb, tw, SCALE)
    assert all(_within(got[i], ref[i], bound[i]) for i in range(3))
    ref = np.asarray(jax_hetero_fold(
        jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
        jnp.asarray(ranks), jnp.asarray(oa), jnp.asarray(ob), SCALE,
        interpret=True))
    got = hetero_fold(list(tw0), ta, tb, tw, tr, toa, tob, SCALE)
    bound = hetero_error_bound(list(tw0), ta, tb, tw, tr, toa, tob, SCALE)
    assert all(_within(got[i], ref[i], bound[i]) for i in range(3))


def test_plain_versions_never_read_masked_lanes_or_columns():
    """NaN/Inf in a zero-weight lane, a rank-0 lane and the rank columns
    past a lane's rank leave every plain result unchanged, bit for bit —
    where the reference's 0·NaN would leak NaN."""
    w0, a, b, w, oa, ob = _lane_inputs(4, (2,), 24, 40, 8, zero_lanes=(1,))
    ranks = np.array([3, 8, -1, 0], np.int32)
    tw0, ta, tb, tw, tr, toa, tob = _t(w0, a, b, w, ranks, oa, ob)
    lanes = [tw0[0], None, tw0[2], tw0[3]]

    def run(x, y):
        return (product_fold(tw0[0], x, y, tw, SCALE),
                perclient_fold(lanes, x, y, tw, SCALE),
                hetero_fold(lanes, x, y, tw, tr, toa, tob, SCALE))

    clean = run(ta, tb)
    da, db = ta.clone(), tb.clone()
    da[1], db[1] = float("nan"), float("inf")
    dirty = run(da, db)
    assert torch.equal(dirty[0], clean[0])
    for i in (0, 2, 3):
        assert torch.equal(dirty[1][i], clean[1][i])
    da[0, ..., 3:] = float("nan")
    db[0, :, 3:, :] = float("inf")
    da[3], db[3] = float("nan"), float("nan")
    dirty_h = hetero_fold(lanes, da, db, tw, tr, toa, tob, SCALE)
    for i in (0, 2, 3):
        assert torch.equal(dirty_h[i], clean[2][i])
        assert bool(torch.isfinite(dirty_h[i]).all())


def test_lane_wrappers_refuse_overlapping_outputs():
    w0, a, b, w, _, _ = _lane_inputs(2, (), 16, 32, 4)
    tw0, ta, tb, tw = _t(w0, a, b, w)
    base = tw0[0].clone()
    with pytest.raises(ValueError, match="overlaps"):
        perclient_fold([base, base], ta, tb, tw, SCALE, out=[base, base])
    stack = tw0.clone()
    out = perclient_fold(list(stack), ta, tb, tw, SCALE, out=list(stack))
    want = perclient_fold_plain(list(tw0), ta, tb, tw, SCALE)
    assert all(torch.equal(stack[i], want[i]) for i in range(2))
    assert out[0].data_ptr() == stack[0].data_ptr()
    with pytest.raises(ValueError):
        hetero_fold(list(tw0), ta, tb, tw, torch.tensor([1, 2]), ta[0], tb[0],
                    SCALE)  # int64 ranks


# --------------------------------------------------------------------------
# engine closes against the JAX RoundCloseEngine
# --------------------------------------------------------------------------

def _problem(c, seed=0, ranks=None):
    """Params with adapted q/k/v/o kernels + a frozen norm, and c client
    adapter trees (client i at rank ranks[i], zero-padded to R), numpy."""
    rng = np.random.default_rng(seed)

    def n(*s, std=0.02):
        return (rng.standard_normal(s) * std).astype(np.float32)

    shapes = {"q_proj": (D, D), "k_proj": (D, KV), "v_proj": (D, KV),
              "o_proj": (D, D)}
    params = {"layers": {"attn": {k: {"kernel": n(L, *s)}
                                  for k, s in shapes.items()},
                         "attn_norm": {"scale": np.ones((L, D), np.float32)}}}
    clients = []
    for i in range(c):
        ri = R if ranks is None else ranks[i]
        tree = {}
        for k, s in shapes.items():
            a, b = n(L, s[0], R), n(L, R, s[1], std=0.01)
            a[..., ri:] = 0.0
            b[:, ri:, :] = 0.0
            tree[k] = {"a": a, "b": b}
        clients.append({"layers": {"attn": tree}})
    return params, clients


def _template(clients):
    return jagg.map_factors(lambda f: {"a": np.zeros_like(f["a"]),
                                       "b": np.zeros_like(f["b"])},
                            clients[0])


def _attn(tree, key, leaf="kernel"):
    return tree["layers"]["attn"][key][leaf]


def _jax_engine(method, params, clients, delivered, c_max, backend,
                **kw):
    eng = JaxEngine(params, _template(clients), c_max=c_max, scale=SCALE,
                    method=method, backend=backend, interpret=True, **kw)
    rid = eng.buffers.begin_round({i: i for i in range(len(clients))})
    for cid in delivered:
        eng.buffers.write(cid, clients[cid], round_id=rid)
    return eng, rid


def _port_engine(method, params, clients, delivered, c_max, backend, **kw):
    tc = [params_from_numpy(c, CPU) for c in clients]
    eng = RoundCloseEngine(params_from_numpy(params, CPU),
                           params_from_numpy(_template(clients), CPU),
                           c_max=c_max, scale=SCALE, method=method,
                           backend=backend, **kw)
    rid = eng.buffers.begin_round({i: i for i in range(len(clients))})
    for cid in delivered:
        eng.buffers.write(cid, tc[cid], round_id=rid)
    return eng, rid


def _norm_weights(weights, delivered, c_max):
    norm = agg.normalize_weights(weights, len(delivered))
    w = np.zeros(c_max, np.float32)
    w[delivered] = (np.full(len(delivered), 1 / len(delivered)) if norm is None
                    else norm)
    return w


def _stack(clients, key, factor):
    return np.stack([_attn(c, key, factor) for c in clients])


# the port's plain close against the reference's jnp close, its kernel
# close (the wrappers' plain versions on the CPU, folding in place) against
# the reference's Pallas close in interpret mode
BACKEND_PAIRS = [("plain", "jnp"), ("kernels", "pallas")]

ROUNDS = {
    # name: (C_max, delivered lanes, weights)
    "uniform-full": (4, [0, 1, 2, 3], None),
    "weighted-full": (4, [0, 1, 2, 3], [30.0, 10.0, 45.0, 15.0]),
    "partial-50%-weighted": (4, [1, 3], [25.0, 75.0]),
}


@pytest.mark.parametrize("port_backend,jax_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("round_", list(ROUNDS))
def test_reinit_close_matches_reference_engine(round_, port_backend,
                                               jax_backend):
    c_max, delivered, weights = ROUNDS[round_]
    params, clients = _problem(c_max, seed=1)
    jeng, jrid = _jax_engine("reinit", params, clients, delivered, c_max,
                             jax_backend)
    jglob, jparams, jdiv = jeng.close(params, delivered, weights,
                                      round_id=jrid, rng=jax.random.key(7))
    peng, prid = _port_engine("reinit", params, clients, delivered, c_max,
                              port_backend)
    tparams = params_from_numpy(params, CPU)
    gen = torch.Generator().manual_seed(7)
    pglob, pparams, pdiv = peng.close(tparams, delivered, weights,
                                      round_id=prid, rng=gen)
    np.testing.assert_allclose(float(pdiv), float(jdiv), rtol=1e-4)
    w = torch.from_numpy(_norm_weights(weights, delivered, c_max))
    for key in KEYS:
        a, b = _t(_stack(clients, key, "a"), _stack(clients, key, "b"))
        w0 = torch.from_numpy(_attn(params, key))
        assert _within(_attn(pparams, key),
                       _attn(jax.tree.map(np.asarray, jparams), key),
                       product_error_bound(w0, a, b, w, SCALE)), key
    # the fresh adapters: a ~ N(0, 0.02), b = 0, drawn from the generator
    fresh = agg.reinit_adapters(params_from_numpy(_template(clients), CPU),
                                torch.Generator().manual_seed(7))
    for k, x in flatten_with_paths(fresh).items():
        assert torch.equal(flatten_with_paths(pglob)[k], x)
    for k, x in jax_flatten(jglob).items():
        assert flatten_with_paths(pglob)[k].shape == x.shape


@pytest.mark.parametrize("port_backend,jax_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("round_", list(ROUNDS))
def test_keep_local_close_matches_reference_engine(round_, port_backend,
                                                   jax_backend):
    c_max, delivered, weights = ROUNDS[round_]
    params, clients = _problem(c_max, seed=2)
    # each client's own base: W0 + i·0.001
    bases = [jax.tree.map(lambda x, i=i: x + np.float32(0.001 * i), params)
             for i in range(c_max)]
    jeng, jrid = _jax_engine("keep_local", params, clients, delivered, c_max,
                             jax_backend)
    jout, jdiv = jeng.close_keep_local(bases, delivered, weights,
                                       round_id=jrid)
    peng, prid = _port_engine("keep_local", params, clients, delivered,
                              c_max, port_backend)
    tbases = [params_from_numpy(p, CPU) for p in bases]
    pout, pdiv = peng.close_keep_local(tbases, delivered, weights,
                                       round_id=prid)
    assert sorted(pout) == sorted(delivered) == sorted(jout)
    np.testing.assert_allclose(float(pdiv), float(jdiv), rtol=1e-4)
    w = torch.from_numpy(_norm_weights(weights, delivered, c_max))
    for key in KEYS:
        a, b = _t(_stack(clients, key, "a"), _stack(clients, key, "b"))
        lanes = [torch.from_numpy(_attn(bases[i], key)) if i in delivered
                 else None for i in range(c_max)]
        bound = perclient_error_bound(lanes, a, b, w, SCALE)
        for cid in delivered:
            assert _within(_attn(pout[cid], key), _attn(jax.tree.map(
                np.asarray, jout[cid]), key), bound[cid]), (key, cid)


@pytest.mark.parametrize("port_backend,jax_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("round_", list(ROUNDS))
def test_svd_close_matches_reference_engine(round_, port_backend,
                                            jax_backend):
    c_max, delivered, weights = ROUNDS[round_]
    params, clients = _problem(c_max, seed=3)
    svd_rank = 3
    jeng, jrid = _jax_engine("fedex_svd", params, clients, delivered, c_max,
                             jax_backend, svd_rank=svd_rank)
    jglob, jparams, jdiv = jeng.close(params, delivered, weights,
                                      round_id=jrid)
    peng, prid = _port_engine("fedex_svd", params, clients, delivered, c_max,
                              port_backend, svd_rank=svd_rank)
    pglob, pparams, pdiv = peng.close(params_from_numpy(params, CPU),
                                      delivered, weights, round_id=prid)
    np.testing.assert_allclose(float(pdiv), float(jdiv), rtol=1e-4)
    w = _norm_weights(weights, delivered, c_max)
    jp = jax.tree.map(np.asarray, jparams)
    for key in KEYS:
        old = _attn(params, key)
        got, want = _attn(pparams, key).numpy(), _attn(jp, key)
        fold = want - old
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(fold), key
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(old), key
        for factor in ("a", "b"):
            stack = _stack(clients, key, factor)
            bound = 2 * c_max * 2.0 ** -24 * np.einsum("c,c...->...", w,
                                                       np.abs(stack))
            assert _within(_attn(pglob, key, factor),
                           _attn(jax.tree.map(np.asarray, jglob), key,
                                 factor), bound)


def _dense_svd_fold(clients, key, w, svd_rank):
    """float64 oracle: the weighted residual's rank-r' SVD truncation."""
    a = _stack(clients, key, "a").astype(np.float64)
    b = _stack(clients, key, "b").astype(np.float64)
    abar = np.einsum("c,c...->...", w, a)
    bbar = np.einsum("c,c...->...", w, b)
    res = np.einsum("c,c...mr,c...rn->...mn", w, a, b) - abar @ bbar
    u, s, vt = np.linalg.svd(res, full_matrices=False)
    return (u[..., :svd_rank] * s[..., None, :svd_rank]) @ vt[..., :svd_rank, :]


def test_svd_close_matches_dense_truncation():
    """The factored Eckart–Young fold against a float64 dense SVD of the
    residual (1e-5 of the fold's norm: the Gram squaring's precision)."""
    c_max, delivered, weights = 4, [0, 1, 2, 3], [3.0, 1.0, 2.0, 2.0]
    params, clients = _problem(c_max, seed=4)
    for svd_rank in (2, 5):
        peng, prid = _port_engine("fedex_svd", params, clients, delivered,
                                  c_max, "plain", svd_rank=svd_rank)
        _, pparams, _ = peng.close(params_from_numpy(params, CPU), delivered,
                                   weights, round_id=prid)
        w = _norm_weights(weights, delivered, c_max).astype(np.float64)
        for key in KEYS:
            want = SCALE * _dense_svd_fold(clients, key, w, svd_rank)
            got = (_attn(pparams, key).numpy().astype(np.float64)
                   - _attn(params, key))
            assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(
                want) + 1e-9, (key, svd_rank)


HETERO_ROUNDS = {
    # name: (client ranks, delivered, weights)
    "uniform-ranks": ((4, 4, 4, 4), [0, 1, 2, 3], None),
    "ragged": ((4, 2, 1, 3), [0, 1, 2, 3], None),
    "ragged-weighted": ((4, 2, 1, 3), [0, 1, 2, 3], [1.0, 3.0, 2.0, 2.0]),
    "ragged-partial": ((2, 4, 1, 3), [1, 2], [2.0, 1.0]),
}


def _hetero_check(pout, ploras, pglob, ref_w0, ref_loras, ref_glob, params,
                  delivered):
    """Sign-invariant comparison of a hetero close with a reference."""
    for key in KEYS:
        pg, jg = _attn(pglob, key, "a"), _attn(ref_glob, key, "a")
        pprod = (pg @ _attn(pglob, key, "b")).numpy()
        jprod = np.asarray(jg) @ np.asarray(_attn(ref_glob, key, "b"))
        assert np.linalg.norm(pprod - jprod) <= 1e-4 * np.linalg.norm(jprod)
        for cid in delivered:
            pa, pb = _attn(ploras[cid], key, "a"), _attn(ploras[cid], key, "b")
            ja = np.asarray(_attn(ref_loras[cid], key, "a"))
            jb = np.asarray(_attn(ref_loras[cid], key, "b"))
            assert pa.shape == ja.shape and pb.shape == jb.shape
            jp = ja @ jb
            assert np.linalg.norm((pa @ pb).numpy() - jp) <= 1e-4 * max(
                np.linalg.norm(jp), 1e-12)
            old = _attn(params, key)
            got = _attn(pout[cid], key).numpy()
            want = np.asarray(ref_w0[cid][key])
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(
                want - old) + 1e-9, (key, cid)
            assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(old)


@pytest.mark.parametrize("port_backend", ["plain", "kernels"])
@pytest.mark.parametrize("round_", list(HETERO_ROUNDS))
def test_hetero_close_matches_oracle_and_reference_engine(round_,
                                                          port_backend):
    ranks, delivered, weights = HETERO_ROUNDS[round_]
    c_max = len(ranks)
    params, clients = _problem(c_max, seed=5, ranks=ranks)
    bases = [jax.tree.map(lambda x, i=i: x + np.float32(0.001 * i), params)
             for i in range(c_max)]
    peng, prid = _port_engine("hetero", params, clients, delivered, c_max,
                              port_backend, client_ranks=ranks)
    tbases = [params_from_numpy(p, CPU) for p in bases]
    pout, ploras, pglob, pdiv = peng.close_hetero(tbases, delivered, weights,
                                                  round_id=prid)
    # the JAX engine, jnp backend
    jeng, jrid = _jax_engine("hetero", params, clients, delivered, c_max,
                             "jnp", client_ranks=ranks)
    jout, jloras, jglob, jdiv = jeng.close_hetero(bases, delivered, weights,
                                                  round_id=jrid)
    np.testing.assert_allclose(float(pdiv), float(jdiv), rtol=1e-4)
    jw0 = {cid: {key: np.asarray(_attn(jout[cid], key)) for key in KEYS}
           for cid in delivered}
    _hetero_check(pout, ploras, pglob, jw0, jloras, jglob, params, delivered)
    # the eager oracle, with the engine's r_max and the delivered subset
    sub = [clients[c] for c in delivered]
    oracle_w = None if (weights is None and round_ != "ragged"
                        ) else (weights or [1.0] * len(delivered))
    new_loras, residuals = jhetero.hetero_fedex_aggregate(
        sub, [ranks[c] for c in delivered], weights=oracle_w, r_max=R)
    ow0 = {cid: {key: np.asarray(_attn(bases[cid], key)
                                 + SCALE * residuals[i]["layers"]["attn"][key])
                 for key in KEYS} for i, cid in enumerate(delivered)}
    oloras = dict(zip(delivered, new_loras))
    # the oracle's A′B′ at r_max is the first delivered client's when it is
    # at full rank; compare the products client by client instead
    _hetero_check(pout, ploras, pglob, ow0, oloras, jglob, params, delivered)
    # the port's own oracle agrees with the reference's
    tsub = [params_from_numpy(c, CPU) for c in sub]
    t_loras, t_res = hetero_fedex_aggregate(
        tsub, [ranks[c] for c in delivered], weights=oracle_w, r_max=R)
    for i in range(len(delivered)):
        for key in KEYS:
            want = np.asarray(residuals[i]["layers"]["attn"][key])
            got = t_res[i]["layers"]["attn"][key].numpy()
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_uniform_reinit_and_keep_local_are_the_operator_composition():
    """The uniform closes compose the port's own operators, bit for bit."""
    params, clients = _problem(3, seed=6)
    tc = [params_from_numpy(c, CPU) for c in clients]
    peng, prid = _port_engine("reinit", params, clients, [0, 1, 2], 3,
                              "kernels")
    glob, new, _ = peng.close(params_from_numpy(params, CPU), [0, 1, 2],
                              round_id=prid,
                              rng=torch.Generator().manual_seed(3))
    new_loras, residual = agg.assign_after_aggregation(
        "reinit", tc, torch.Generator().manual_seed(3))
    want = agg.apply_residual(params_from_numpy(params, CPU), residual, SCALE)
    for k, x in flatten_with_paths(want).items():
        assert torch.equal(flatten_with_paths(new)[k], x), k
    for k, x in flatten_with_paths(new_loras[0]).items():
        assert torch.equal(flatten_with_paths(glob)[k], x), k
    bases = [params_from_numpy(params, CPU) for _ in range(3)]
    peng, prid = _port_engine("keep_local", params, clients, [0, 1, 2], 3,
                              "kernels")
    out, _ = peng.close_keep_local(bases, [0, 1, 2], round_id=prid)
    residuals = agg.per_client_residuals(tc)
    for cid in range(3):
        want = agg.apply_residual(params_from_numpy(params, CPU),
                                  residuals[cid], SCALE)
        for k, x in flatten_with_paths(want).items():
            assert torch.equal(flatten_with_paths(out[cid])[k], x), (cid, k)
    lo, res0 = agg.assign_after_aggregation("keep_local", tc)
    assert lo[1] is tc[1]
    for k, x in flatten_with_paths(residuals[0]).items():
        assert torch.equal(flatten_with_paths(res0)[k], x)


def test_uniform_hetero_close_is_the_oracle_bitwise():
    """Every client at r_max, full participation, uniform weights: the
    close composes the port's eager oracle's op sequence, bit for bit."""
    ranks = (R, R, R)
    params, clients = _problem(3, seed=7, ranks=ranks)
    peng, prid = _port_engine("hetero", params, clients, [0, 1, 2], 3,
                              "kernels", client_ranks=ranks)
    bases = [params_from_numpy(params, CPU) for _ in range(3)]
    out, loras, _, _ = peng.close_hetero(bases, [0, 1, 2], round_id=prid)
    tc = [params_from_numpy(c, CPU) for c in clients]
    new_loras, residuals = hetero_fedex_aggregate(tc, ranks, r_max=R)
    for cid in range(3):
        want = agg.apply_residual(params_from_numpy(params, CPU),
                                  residuals[cid], SCALE)
        for k, x in flatten_with_paths(want).items():
            assert torch.equal(flatten_with_paths(out[cid])[k], x)
        for k, x in flatten_with_paths(new_loras[cid]).items():
            assert torch.equal(flatten_with_paths(loras[cid])[k], x)


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_hetero_close_ignores_nan_in_masked_lanes_and_columns(backend):
    """A non-delivered lane and the padded rank columns of delivered lanes
    hold NaN: the close (fold, factors, divergence) is unchanged, bit for
    bit, and finite."""
    ranks = (4, 2, 1, 3)
    params, clients = _problem(4, seed=8, ranks=ranks)
    delivered = [0, 1, 3]

    def run(poison):
        eng, rid = _port_engine("hetero", params, clients, delivered, 4,
                                backend, client_ranks=ranks)
        if poison:
            stacks = eng.buffers._open[rid]["stacks"]
            for path, x in stacks.items():
                x[2] = float("nan")  # lane 2 was not delivered
                for lane in delivered:
                    r = ranks[lane]
                    if path.endswith("/a"):
                        x[lane, ..., r:] = float("nan")
                    else:
                        x[lane, :, r:, :] = float("nan")
        bases = [params_from_numpy(params, CPU) for _ in range(4)]
        return eng.close_hetero(bases, delivered, [1.0, 2.0, 1.0],
                                round_id=rid)

    clean, dirty = run(False), run(True)
    assert float(dirty[3]) == float(clean[3])
    for cid in delivered:
        for got, want in ((dirty[0][cid], clean[0][cid]),
                          (dirty[1][cid], clean[1][cid])):
            for k, x in flatten_with_paths(want).items():
                y = flatten_with_paths(got)[k]
                assert torch.equal(y, x) and bool(torch.isfinite(y).all()), k


def test_round_buffers_rank_vector_and_hetero_padding():
    params, clients = _problem(3, seed=9)
    tl = params_from_numpy(clients[0], CPU)
    eng = RoundCloseEngine(params_from_numpy(params, CPU), tl, c_max=3,
                           scale=SCALE, method="hetero", client_ranks=(4, 2, 1))
    rid = eng.buffers.begin_round({0: 0, 1: 1, 2: 2})
    small = jagg.map_factors(lambda f: {"a": f["a"][..., :2],
                                        "b": f["b"][..., :2, :]}, clients[1])
    padded = pad_adapters(params_from_numpy(small, CPU), R)
    ref = jhetero.pad_adapters(jax.tree.map(jnp.asarray, small), R)
    for k, x in jax_flatten(ref).items():
        np.testing.assert_array_equal(flatten_with_paths(padded)[k].numpy(),
                                      np.asarray(x))
    assert eng.buffers.write(1, padded, round_id=rid, rank=2)
    assert eng.buffers.write(0, tl, round_id=rid)
    assert eng.buffers.write(2, padded, round_id=rid, rank=3)  # wrong rank
    with pytest.raises(ValueError):
        eng.buffers.write(0, tl, round_id=rid, rank=5)  # above r_max
    assert list(eng.buffers.ranks_in(rid)) == [-1, 2, 3]
    with pytest.raises(ValueError, match="registered rank"):
        eng.close_hetero([params_from_numpy(params, CPU)] * 3, [0, 1, 2],
                         round_id=rid)
    with pytest.raises(ValueError):
        eng.close(params_from_numpy(params, CPU), [0])
    with pytest.raises(ValueError):
        RoundCloseEngine(params_from_numpy(params, CPU), tl, c_max=2,
                         scale=SCALE, method="hetero", client_ranks=(4, 8))
