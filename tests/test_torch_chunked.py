"""The port's chunked streaming round closes (``RoundCloseEngine(chunk=k)``,
``FedConfig.close_chunk``) and their partial-fold kernel ``product_accum``
against the JAX package, on the CPU.

* ``product_accum_plain`` against the Pallas ``product_accum_apply`` in
  interpret mode, zero-weight rows holding NaN on the port's side (zeros on
  the reference's, which multiplies by the weight): within 1e-6 of the
  result's largest magnitude, and within ``product_accum_error_bound``
  (2·(C + r + 4) unit roundoffs of the magnitudes each element carries:
  ``torch.matmul`` and ``jnp.dot`` sum the rank-r products in other orders).
* The reference's chunked contracts (``tests/test_engine_chunked.py``), on
  the port: chunked == stacked bit for bit on dyadic data (integers / 4, so
  every sum and product is exact in f32 and only exact arithmetic is left)
  for fedex, reinit and keep_local; arrival-order determinism bit for bit on
  random data; the "auto" rule; the ingest/close weight cross-check;
  weighted chunked fedex against the eager ``fedex_aggregate`` oracle
  (1e-5); the ingest-weighted divergence against float64 (rtol 1e-4);
  chunked fedex_svd and hetero against the port's stacked closes, by the
  folded update (1e-4 of its Frobenius norm, 1e-5 of W0's) and the a′b′
  products (1e-4), never A′ or B′ alone (eigenvector signs).
* Each of the five methods against the JAX ``RoundCloseEngine(chunk=k,
  backend="pallas", interpret=True)`` on the same uplinks: fedex, reinit
  and keep_local W0 within the fold's error bound (``fold_error_bound``,
  ``product_error_bound``, ``perclient_error_bound`` of the normalised
  weights), ā and b̄ within 2·(C + 1) unit roundoffs of Σ|w||x|, fedex_svd
  and hetero as against the stacked close, the divergence rtol 1e-4.
* A paper-tiny chunked trainer against the JAX trainer with the same
  ``close_chunk``, at ``tests/test_torch_methods.py``'s tolerances, and the
  launcher's ``--close-chunk`` on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.engine import RoundCloseEngine as JaxEngine  # noqa: E402
from repro.kernels.fedex_residual import product_accum_apply  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.engine import RoundCloseEngine  # noqa: E402
from repro_torch.kernels import (fold_error_bound,  # noqa: E402
                                 launch_counts, perclient_error_bound,
                                 product_accum, product_accum_error_bound,
                                 product_accum_plain, product_error_bound)
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

from test_torch_methods import _run_and_compare, _trainers  # noqa: E402

CPU = torch.device("cpu")
U = 2.0 ** -24


# --------------------------------------------------------------------------
# B5: product_accum
# --------------------------------------------------------------------------

# (C, m, n, r, lanes with weight 0)
ACCUM_CASES = {
    "chunk-of-4": (4, 64, 128, 4, ()),
    "odd-shape": (4, 100, 60, 4, ()),
    "trailing-2-of-4": (4, 48, 96, 4, (2, 3)),
    "one-lane": (1, 40, 72, 8, ()),
    "rank-16": (3, 32, 64, 16, ()),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accum_inputs(c, lead, m, n, r, zero, seed=0):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((*lead, m, n)).astype(np.float32)
    a = (rng.standard_normal((c, *lead, m, r)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((c, *lead, r, n)) * 0.5).astype(np.float32)
    s = (40.0 + 25.0 * np.arange(c)).astype(np.float32)  # raw ingest weights
    s[list(zero)] = 0.0
    a[list(zero)] = 0.0
    b[list(zero)] = 0.0
    return acc, a, b, s


def _poisoned(x, zero):
    t = torch.from_numpy(x.copy())
    t[list(zero)] = float("nan")
    return t


@pytest.mark.parametrize("case", list(ACCUM_CASES))
def test_product_accum_plain_matches_pallas(case):
    c, m, n, r, zero = ACCUM_CASES[case]
    acc, a, b, s = _accum_inputs(c, (), m, n, r, zero)
    ref = np.asarray(product_accum_apply(
        jnp.asarray(acc), jnp.asarray(a), jnp.asarray(b), jnp.asarray(s),
        scale=1.0, bm=min(256, m), bn=min(256, n), interpret=True))
    ta, tb = _poisoned(a, zero), _poisoned(b, zero)
    tacc, ts = torch.from_numpy(acc), torch.from_numpy(s)
    got = product_accum_plain(tacc, ta, tb, ts, 1.0).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    bound = product_accum_error_bound(tacc, torch.from_numpy(a),
                                      torch.from_numpy(b), ts, 1.0).numpy()
    assert np.all(np.abs(got - ref) <= bound)


def test_product_accum_updates_in_place_and_checks_operands():
    acc, a, b, s = _accum_inputs(4, (2,), 24, 40, 4, (3,), seed=1)
    ta, tb, ts = _poisoned(a, (3,)), _poisoned(b, (3,)), torch.from_numpy(s)
    buf = torch.from_numpy(acc.copy())
    want = product_accum_plain(torch.from_numpy(acc), ta, tb, ts, 1.0)
    before = launch_counts()
    assert product_accum(buf, ta, tb, ts, 1.0) is buf
    assert torch.equal(buf, want)
    assert launch_counts() == before  # the CPU path launches nothing
    with pytest.raises(TypeError):
        product_accum(buf.double(), ta, tb, ts, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        product_accum(buf.transpose(-1, -2).contiguous().transpose(-1, -2),
                      ta, tb, ts, 1.0)
    sq = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="overlaps"):
        product_accum(sq[0], sq[:1, 0:8, :], torch.zeros(1, 8, 8),
                      torch.ones(1), 1.0)
    with pytest.raises(ValueError, match="overlaps"):
        product_accum(sq[1], torch.zeros(2, 8, 8), sq, torch.ones(2), 1.0)


# --------------------------------------------------------------------------
# the reference's chunked contracts, on the port
# --------------------------------------------------------------------------

M, N, R = 16, 12, 2
SCALE = 0.5  # dyadic
BACKENDS = ["plain", "kernels"]


def _dy(rng, sh):
    """Integers / 4: every f32 sum and product of these stays exact."""
    return rng.integers(-8, 9, size=sh).astype(np.float32) / 4.0


def _setting(seed, c, dyadic=True):
    rng = np.random.default_rng(seed)
    mk = ((lambda sh: _dy(rng, sh)) if dyadic else
          (lambda sh: rng.normal(size=sh).astype(np.float32)))
    params = {"q_proj": {"kernel": mk((M, N))}}
    lora_t = {"q_proj": {"a": mk((M, R)), "b": mk((R, N))}}
    loras = [{"q_proj": {"a": mk((M, R)), "b": mk((R, N))}}
             for _ in range(c)]
    return params, lora_t, loras


def _t(tree):
    return params_from_numpy(tree, CPU)


def _engine(params, lora_t, c, chunk, backend, **kw):
    return RoundCloseEngine(_t(params), _t(lora_t), c_max=c, scale=SCALE,
                            backend=backend, chunk=chunk, **kw)


def _stream(eng, loras, *, raw_w=None, delivered=None, order=None, rid=0):
    eng.buffers.begin_round({i: i for i in range(len(loras))}, round_id=rid)
    ids = list(range(len(loras))) if delivered is None else list(delivered)
    for cid in (order if order is not None else ids):
        eng.buffers.write(cid, _t(loras[cid]), round_id=rid,
                          weight=1.0 if raw_w is None else raw_w[cid])
    return ids


def _flat(tree):
    return {k: x.numpy() for k, x in flatten_with_paths(tree).items()}


def _assert_bitwise(x, y):
    fx, fy = _flat(x), _flat(y)
    assert list(fx) == list(fy)
    for k in fx:
        np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)


def _close_pair(method, c, chunk, backend, *, raw_w=None, delivered=None,
                seed=0, dyadic=True, svd_rank=0):
    """The same round through a chunked and a stacked engine: (global,
    params, divergence) of each; params are fresh copies for each close (the
    kernel backend folds in place)."""
    params, lora_t, loras = _setting(seed, c, dyadic)
    out = []
    for eng_chunk in (chunk, 0):
        eng = _engine(params, lora_t, c, eng_chunk, backend, method=method,
                      svd_rank=svd_rank)
        ids = _stream(eng, loras, raw_w=raw_w, delivered=delivered)
        assert eng.buffers.is_chunked(0) is (eng_chunk > 0)
        w = None if raw_w is None else [raw_w[i] for i in ids]
        rng = torch.Generator().manual_seed(7)
        g, p, div = eng.close(_t(params), ids, w, round_id=0, rng=rng)
        out.append((g, p, float(div)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("round_", ["uniform", "weighted", "partial"])
def test_chunked_fedex_is_stacked_bitwise_on_dyadic_data(round_, backend):
    raw_w = ([1.0, 1.0, 2.0, 4.0, 1.0, 1.0, 2.0, 4.0]  # sum 16: exact
             if round_ == "weighted" else None)
    delivered = [0, 2, 5, 7] if round_ == "partial" else None
    chunked, stacked = _close_pair("fedex", 8, 4, backend, raw_w=raw_w,
                                   delivered=delivered, seed=1)
    _assert_bitwise(chunked[1], stacked[1])
    _assert_bitwise(chunked[0], stacked[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_reinit_is_stacked_bitwise_on_dyadic_data(backend):
    chunked, stacked = _close_pair("reinit", 8, 4, backend, seed=3)
    _assert_bitwise(chunked[1], stacked[1])
    _assert_bitwise(chunked[0], stacked[0])  # the same fresh draws


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_keep_local_is_stacked_bitwise_on_dyadic_data(backend):
    c = 8
    params, lora_t, loras = _setting(4, c)
    bases = [_setting(40 + i, 1)[0] for i in range(c)]
    out = []
    for eng_chunk in (4, 0):
        eng = _engine(params, lora_t, c, eng_chunk, backend,
                      method="keep_local")
        ids = _stream(eng, loras)
        new, div = eng.close_keep_local([_t(p) for p in bases], ids,
                                        round_id=0)
        float(div)
        out.append(new)
    for i in range(c):
        _assert_bitwise(out[0][i], out[1][i])


@pytest.mark.parametrize("backend", BACKENDS)
def test_arrival_order_never_changes_a_chunked_close(backend):
    """Random (non-dyadic) data: a fold sequence that followed arrival
    order would change the bits."""
    c, chunk = 8, 3
    params, lora_t, loras = _setting(5, c, dyadic=False)
    results = []
    for order in (list(range(c)), list(range(c))[::-1],
                  [3, 7, 0, 5, 1, 6, 2, 4]):
        eng = _engine(params, lora_t, c, chunk, backend)
        _stream(eng, loras, order=order)
        g, p, div = eng.close(_t(params), list(range(c)), round_id=0)
        results.append((g, p, float(div)))
        # every candidate delivers, so all 3 chunks fill and fold eagerly
        assert eng.buffers.partial_folds == 3
    for g, p, div in results[1:]:
        _assert_bitwise(p, results[0][1])
        _assert_bitwise(g, results[0][0])
        assert div == results[0][2]


def test_auto_rule_small_rounds_take_the_stacked_path():
    c = 6
    params, lora_t, loras = _setting(8, c, dyadic=False)
    for chunk in (0, c, c + 3):
        eng = _engine(params, lora_t, c, chunk, "plain")
        _stream(eng, loras)
        assert eng.buffers.is_chunked(0) is False
        assert eng.buffers.take(0)["q_proj/a"].shape == (c, M, R)
    eng = _engine(params, lora_t, c, c - 1, "plain")
    _stream(eng, loras)
    assert eng.buffers.is_chunked(0) is True
    with pytest.raises(RuntimeError, match="take_chunked"):
        eng.buffers.take(0)


def test_ingest_close_weight_mismatch_raises():
    params, lora_t, loras = _setting(11, 6, dyadic=False)
    eng = _engine(params, lora_t, 6, 4, "plain")
    ids = _stream(eng, loras)  # raw ingest weight 1.0 each
    with pytest.raises(ValueError, match="weight"):
        eng.close(_t(params), ids, [1.0, 1.0, 1.0, 1.0, 1.0, 9.0],
                  round_id=0)


RAW_W = [40.0, 65.0, 90.0, 115.0, 140.0, 165.0]  # "examples"


@pytest.mark.parametrize("backend", BACKENDS)
def test_weighted_chunked_fedex_matches_eager_oracle(backend):
    params, lora_t, loras = _setting(9, 6, dyadic=False)
    eng = _engine(params, lora_t, 6, 4, backend)
    ids = _stream(eng, loras, raw_w=RAW_W)
    g, p, _ = eng.close(_t(params), ids, RAW_W, round_id=0)
    tl = [_t(x) for x in loras]
    g_l, res = agg.fedex_aggregate(tl, RAW_W)
    p_l = agg.apply_residual(_t(params), res, SCALE)
    for got, want in ((p, p_l), (g, g_l)):
        for k, x in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[k], x, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def _ingest_divergence(loras, raw_w):
    """float64 ‖Σŵ a b − ā b̄‖_F / √(mn) under the normalised raw weights."""
    w = np.asarray(raw_w, np.float64) / np.sum(raw_w)
    a = np.stack([x["q_proj"]["a"] for x in loras]).astype(np.float64)
    b = np.stack([x["q_proj"]["b"] for x in loras]).astype(np.float64)
    res = (np.einsum("c,cmr,crn->mn", w, a, b)
           - np.einsum("c,cmr->mr", w, a) @ np.einsum("c,crn->rn", w, b))
    return np.linalg.norm(res) / np.sqrt(M * N)


def test_chunked_divergence_is_ingest_weighted():
    """The stacked close's divergence is uniform over the delivered lanes;
    the chunked close's, as the reference's, weighs them by their ingest
    weights (the two agree when those are uniform)."""
    params, lora_t, loras = _setting(10, 6, dyadic=False)
    eng = _engine(params, lora_t, 6, 4, "kernels")
    ids = _stream(eng, loras, raw_w=RAW_W)
    _, _, div = eng.close(_t(params), ids, RAW_W, round_id=0)
    np.testing.assert_allclose(float(div), _ingest_divergence(loras, RAW_W),
                               rtol=1e-4)


def _fold_close(got_w0, want_w0, old_w0):
    """The folded update within 1e-4 of its norm and W0 within 1e-5 of its
    norm (the Gram squaring keeps about half of the f32 digits)."""
    fold = want_w0 - old_w0
    err = np.linalg.norm(got_w0 - want_w0)
    assert err <= 1e-4 * np.linalg.norm(fold) + 1e-9
    assert err <= 1e-5 * np.linalg.norm(old_w0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_svd_matches_stacked_close(backend):
    c = 8
    raw_w = [1.0, 2.0, 1.0, 4.0, 2.0, 2.0, 2.0, 2.0]
    chunked, stacked = _close_pair("fedex_svd", c, 3, backend, raw_w=raw_w,
                                   seed=12, dyadic=False, svd_rank=3)
    old = _setting(12, c, dyadic=False)[0]["q_proj"]["kernel"]
    _fold_close(_flat(chunked[1])["q_proj/kernel"],
                _flat(stacked[1])["q_proj/kernel"], old)
    for k, x in _flat(stacked[0]).items():  # ā, b̄
        np.testing.assert_allclose(_flat(chunked[0])[k], x, rtol=1e-5,
                                   atol=1e-6)
    loras = _setting(12, c, dyadic=False)[2]
    np.testing.assert_allclose(chunked[2], _ingest_divergence(loras, raw_w),
                               rtol=1e-4)


def _products(lora):
    f = flatten_with_paths(lora)
    return {k[:-2]: (x @ f[k[:-1] + "b"]).numpy() for k, x in f.items()
            if k.endswith("/a")}


def _assert_products_close(x, y):
    px, py = _products(x), _products(y)
    for k in py:
        assert np.linalg.norm(px[k] - py[k]) <= 1e-4 * max(
            np.linalg.norm(py[k]), 1e-12), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_hetero_matches_stacked_close(backend):
    ranks = (2, 1, 2, 2, 1, 2, 2, 1)
    c = len(ranks)
    params, lora_t, loras = _setting(13, c, dyadic=False)
    for lo, rk in zip(loras, ranks):  # rank-rᵢ uplinks padded to R
        lo["q_proj"]["a"][:, rk:] = 0.0
        lo["q_proj"]["b"][rk:, :] = 0.0
    bases = [{"q_proj": {"kernel": params["q_proj"]["kernel"]
                         + np.float32(0.01 * i)}} for i in range(c)]
    out = []
    for eng_chunk in (3, 0):
        eng = _engine(params, lora_t, c, eng_chunk, backend, method="hetero",
                      client_ranks=ranks)
        eng.buffers.begin_round({i: i for i in range(c)}, round_id=0)
        for i in range(c):
            eng.buffers.write(i, _t(loras[i]), round_id=0, rank=ranks[i])
        out.append(eng.close_hetero([_t(p) for p in bases], list(range(c)),
                                    round_id=0))
    (cp, cl, cg, cd), (sp, sl, sg, sd) = out
    _assert_products_close(cg, sg)
    for i in range(c):
        _assert_products_close(cl[i], sl[i])
        assert cl[i]["q_proj"]["a"].shape[-1] == ranks[i]
        _fold_close(_flat(cp[i])["q_proj/kernel"],
                    _flat(sp[i])["q_proj/kernel"],
                    bases[i]["q_proj"]["kernel"])
    np.testing.assert_allclose(float(cd), float(sd), rtol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_hetero_never_reads_padded_columns(backend):
    """NaN in the rank columns past each uplink's declared rank: the
    partial fold masks them by selection before it accumulates, so the
    close (bases, adapters, divergence) is unchanged, bit for bit."""
    ranks = (2, 1, 2, 1, 2)
    params, lora_t, loras = _setting(14, len(ranks), dyadic=False)

    def run(poison):
        eng = _engine(params, lora_t, len(ranks), 2, backend,
                      method="hetero", client_ranks=ranks)
        eng.buffers.begin_round({i: i for i in range(len(ranks))},
                                round_id=0)
        for i, rk in enumerate(ranks):
            up = _t(loras[i])
            up["q_proj"]["a"][:, rk:] = float("nan") if poison else 0.0
            up["q_proj"]["b"][rk:, :] = float("nan") if poison else 0.0
            eng.buffers.write(i, up, round_id=0, rank=rk)
        bases = [_t(params) for _ in ranks]
        return eng.close_hetero(bases, list(range(len(ranks))), round_id=0)

    clean, dirty = run(False), run(True)
    assert float(dirty[3]) == float(clean[3])
    for i in range(len(ranks)):
        for got, want in ((dirty[0][i], clean[0][i]),
                          (dirty[1][i], clean[1][i])):
            fg = _flat(got)
            for k, x in _flat(want).items():
                np.testing.assert_array_equal(fg[k], x, err_msg=k)
                assert np.isfinite(fg[k]).all()


# --------------------------------------------------------------------------
# each method against the JAX engine's chunked close
# --------------------------------------------------------------------------

L, D, KV, RK = 2, 48, 16, 4
KEYS = ("q_proj", "k_proj", "v_proj", "o_proj")
HETERO_RANKS = (4, 2, 1, 3, 4, 2)


def _problem(c, seed, ranks=None):
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
        ri = RK if ranks is None else ranks[i]
        tree = {}
        for k, s in shapes.items():
            a, b = n(L, s[0], RK), n(L, RK, s[1], std=0.01)
            a[..., ri:] = 0.0
            b[:, ri:, :] = 0.0
            tree[k] = {"a": a, "b": b}
        clients.append({"layers": {"attn": tree}})
    return params, clients


def _attn(tree, key, leaf="kernel"):
    return np.asarray(tree["layers"]["attn"][key][leaf])


@pytest.mark.parametrize("method", ["fedex", "reinit", "keep_local",
                                    "fedex_svd", "hetero"])
def test_chunked_close_matches_reference_engine(method):
    c, chunk = 6, 4
    ranks = HETERO_RANKS if method == "hetero" else None
    params, clients = _problem(c, seed=20, ranks=ranks)
    template = jagg.map_factors(lambda f: {"a": np.zeros_like(f["a"]),
                                           "b": np.zeros_like(f["b"])},
                                clients[0])
    bases = [jax.tree.map(lambda x, i=i: x + np.float32(0.001 * i), params)
             for i in range(c)]
    kw = {"svd_rank": 5} if method == "fedex_svd" else {}
    if ranks is not None:
        kw["client_ranks"] = ranks
    ids = list(range(c))
    jeng = JaxEngine(params, template, c_max=c, scale=2.0, method=method,
                     backend="pallas", interpret=True, chunk=chunk, **kw)
    peng = RoundCloseEngine(_t(params), _t(template), c_max=c, scale=2.0,
                            method=method, backend="kernels", chunk=chunk,
                            **kw)
    for eng, conv in ((jeng, lambda x: x), (peng, _t)):
        eng.buffers.begin_round({i: i for i in ids}, round_id=0)
        for i in ids:
            eng.buffers.write(i, conv(clients[i]), round_id=0,
                              weight=RAW_W[i],
                              rank=None if ranks is None else ranks[i])
        # chunk 1 holds the 2 candidates of slots 4 and 5: it too is
        # complete once they arrive, and folds before the close
        assert eng.buffers.is_chunked(0) and eng.buffers.partial_folds == 2
    if method in ("keep_local", "hetero"):
        fn = "close_" + method
        jout = getattr(jeng, fn)(bases, ids, RAW_W, round_id=0)
        pout = getattr(peng, fn)([_t(p) for p in bases], ids, RAW_W,
                                 round_id=0)
        jw0 = [jax.tree.map(np.asarray, jout[0][i]) for i in ids]
        pw0 = [to_numpy(pout[0][i]) for i in ids]
        old = bases
    else:
        jg, jp, jdiv = jeng.close(params, ids, RAW_W, round_id=0,
                                  rng=jax.random.key(7))
        pg, pp, pdiv = peng.close(_t(params), ids, RAW_W, round_id=0,
                                  rng=torch.Generator().manual_seed(7))
        jout, pout = (jg, jp, jdiv), (pg, pp, pdiv)
        jw0, pw0 = [jax.tree.map(np.asarray, jp)], [to_numpy(pp)]
        old = [params]
    np.testing.assert_allclose(float(pout[-1]), float(jout[-1]), rtol=1e-4)
    w = torch.tensor(RAW_W) / sum(RAW_W)
    for key in KEYS:
        a = torch.from_numpy(np.stack([_attn(x, key, "a") for x in clients]))
        b = torch.from_numpy(np.stack([_attn(x, key, "b") for x in clients]))
        for i in range(len(pw0)):
            got, want = _attn(pw0[i], key), _attn(jw0[i], key)
            w0 = torch.from_numpy(_attn(old[i], key))
            if method in ("fedex_svd", "hetero"):
                _fold_close(got, want, w0.numpy())
                continue
            if method == "fedex":
                bound = fold_error_bound(w0, a, b, 2.0, w)
            elif method == "reinit":
                bound = product_error_bound(w0, a, b, w, 2.0)
            else:
                lanes = [w0 if j == i else None for j in range(c)]
                bound = perclient_error_bound(lanes, a, b, w, 2.0)[i]
            assert np.all(np.abs(got - want) <= bound.numpy()), (key, i)
    if method in ("fedex", "fedex_svd"):
        for key in KEYS:
            for factor in ("a", "b"):
                stack = np.stack([_attn(x, key, factor) for x in clients])
                bound = 2 * (c + 1) * U * np.einsum("c,c...->...", w.numpy(),
                                                    np.abs(stack))
                got = _attn(pout[0], key, factor)
                assert np.all(np.abs(got - _attn(jout[0], key, factor))
                              <= bound), (key, factor)
    if method == "hetero":
        jl, pl = jout[1], pout[1]
        for i in ids:
            _assert_products_close(pl[i], params_from_numpy(
                jax.tree.map(np.asarray, jl[i]), CPU))


# --------------------------------------------------------------------------
# the trainer and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fed_kw", [
    {"weighting": "examples"},
    {"weighting": "examples", "assignment": "keep_local"},
], ids=["fedex", "keep_local"])
def test_chunked_trainer_matches_reference(fed_kw):
    """3 clients with close_chunk=2: chunk 0 folds once clients 0 and 1
    have arrived, chunk 1 (one candidate, 1 of 2 rows written) once client
    2 has; the kernel close on the CPU (the wrappers' plain versions,
    folding in place)."""
    jt, pt = _trainers(port_engine="kernels", close_chunk=2, **fed_kw)
    assert pt.engine.chunk == 2
    _run_and_compare(jt, pt, per_client="assignment" in fed_kw)
    assert pt.engine.buffers.partial_folds == 4  # 2 rounds × 2 chunks


def test_launcher_runs_the_chunked_close_on_cpu(capsys):
    port_train.main(["--device", "cpu", "--clients", "3", "--rounds", "2",
                     "--local-steps", "1", "--vocab", "32", "--data-vocab",
                     "16", "--close-chunk", "2", "--weighting", "examples"])
    out = capsys.readouterr().out
    assert "round=1 " in out and "close backend=plain" in out
    assert "nan" not in out.split("final:")[1]
