"""The port's round-close engine and aggregation operators against the JAX
reference's ``RoundCloseEngine`` (backends ``jnp`` and ``pallas``, the
latter in interpret mode), on identical numpy-made W0 leaves and client
factor stacks.

Tolerances: new W0 within ``fold_error_bound`` (twice (C + r + 4) unit
roundoffs of each element's magnitudes: the frameworks sum in other
orders); ā and b̄ within 2·C unit roundoffs of Σ_c |w_c| |x_c| (C-term
sums rounded in other places); the
divergence, computed from two (C·r)² Grams whose entries cancel, rtol 1e-4.
Within the port, zero-weight lanes and the uniform close's composition are
held bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.engine import RoundCloseEngine as JaxEngine  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.engine import (DeferredDivergence,  # noqa: E402
                                     RoundBuffers, RoundCloseEngine,
                                     make_close_fn)
from repro_torch.kernels.fedex_residual import fold_error_bound  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
L, D, KV, R = 2, 48, 16, 4
SCALE = 2.0


def _problem(c, seed=0):
    """Params with adapted q/k/v/o kernels + a frozen norm, and c client
    adapter trees, as numpy."""
    rng = np.random.default_rng(seed)

    def n(*s, std=0.02):
        return (rng.standard_normal(s) * std).astype(np.float32)

    shapes = {"q_proj": (D, D), "k_proj": (D, KV), "v_proj": (D, KV),
              "o_proj": (D, D)}
    params = {"layers": {"attn": {k: {"kernel": n(L, *s)}
                                  for k, s in shapes.items()},
                         "attn_norm": {"scale": np.ones((L, D), np.float32)}}}
    clients = [{"layers": {"attn": {k: {"a": n(L, s[0], R),
                                        "b": n(L, R, s[1], std=0.01)}
                                    for k, s in shapes.items()}}}
               for _ in range(c)]
    return params, clients


def _jax_close(params, clients, delivered, weights, c_max, backend):
    template = jagg.map_factors(lambda f: {"a": jnp.zeros_like(f["a"]),
                                           "b": jnp.zeros_like(f["b"])},
                                clients[0])
    eng = JaxEngine(params, template, c_max=c_max, scale=SCALE,
                    backend=backend, interpret=True)
    rid = eng.buffers.begin_round({i: i for i in range(len(clients))})
    for cid in delivered:
        eng.buffers.write(cid, clients[cid], round_id=rid)
    glob, new_params, div = eng.close(params, delivered, weights,
                                      round_id=rid)
    return (jax_flatten(jagg.map_factors(lambda f: f, new_params)),
            jax_flatten(glob), float(div))


def _port_close(params, clients, delivered, weights, c_max, backend):
    tp = params_from_numpy(params, CPU)
    tc = [params_from_numpy(c, CPU) for c in clients]
    eng = RoundCloseEngine(tp, tc[0], c_max=c_max, scale=SCALE,
                           backend=backend)
    rid = eng.buffers.begin_round({i: i for i in range(len(clients))})
    for cid in delivered:
        eng.buffers.write(cid, tc[cid], round_id=rid)
    glob, new_params, div = eng.close(tp, delivered, weights, round_id=rid)
    return (flatten_with_paths(to_numpy(new_params)),
            flatten_with_paths(to_numpy(glob)), div)


ROUNDS = {
    # name: (C_max, delivered lanes, weights)
    "uniform-full": (4, [0, 1, 2, 3], None),
    "weighted-full": (4, [0, 1, 2, 3], [30.0, 10.0, 45.0, 15.0]),
    "partial-50%-weighted": (4, [1, 3], [25.0, 75.0]),
    "partial-50%-uniform": (4, [0, 2], None),
}


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("port_backend", ["plain", "kernels"])
@pytest.mark.parametrize("round_", list(ROUNDS))
def test_close_matches_reference_engine(round_, port_backend, jax_backend):
    c_max, delivered, weights = ROUNDS[round_]
    params, clients = _problem(c_max)
    jw0, jglob, jdiv = _jax_close(params, clients, delivered, weights, c_max,
                                  jax_backend)
    pw0, pglob, pdiv = _port_close(params, clients, delivered, weights, c_max,
                                   port_backend)
    assert isinstance(pdiv, DeferredDivergence) and not pdiv.resolved
    np.testing.assert_allclose(float(pdiv), jdiv, rtol=1e-4)
    assert pdiv.resolved
    norm = agg.normalize_weights(weights, len(delivered))
    w = np.zeros(c_max, np.float32)
    w[delivered] = (np.full(len(delivered), 1 / len(delivered)) if norm is None
                    else norm)
    assert list(pglob) == list(jglob)
    for k in jglob:
        key, factor = k.split("/")[-2:]
        stack = np.stack([c["layers"]["attn"][key][factor] for c in clients])
        bound = 2 * c_max * 2.0 ** -24 * np.einsum("c,c...->...", w,
                                                   np.abs(stack))
        assert np.all(np.abs(pglob[k] - np.asarray(jglob[k])) <= bound), k
    for key in ("q_proj", "k_proj", "v_proj", "o_proj"):
        path = f"layers/attn/{key}/kernel"
        a = np.stack([c["layers"]["attn"][key]["a"] for c in clients])
        b = np.stack([c["layers"]["attn"][key]["b"] for c in clients])
        bound = fold_error_bound(torch.from_numpy(params["layers"]["attn"][key]
                                                  ["kernel"]),
                                 torch.from_numpy(a), torch.from_numpy(b),
                                 SCALE, torch.from_numpy(w)).numpy()
        assert np.all(np.abs(pw0[path] - np.asarray(jw0[path])) <= bound), key
    np.testing.assert_array_equal(pw0["layers/attn_norm/scale"],
                                  params["layers"]["attn_norm"]["scale"])


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_zero_weight_lanes_are_exact_noops(backend):
    """A C_max=4 round with two delivered lanes closes bit for bit like a
    C_max=2 round of the same two clients."""
    params, clients = _problem(4, seed=1)
    wide = _port_close(params, clients, [1, 3], [2.0, 3.0], 4, backend)
    narrow = _port_close(params, [clients[1], clients[3]], [0, 1], [2.0, 3.0],
                         2, backend)
    for got, want in zip(wide[:2], narrow[:2]):
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    # the divergence sums Gram entries of other sizes: f32 reordering only
    np.testing.assert_allclose(float(wide[2]), float(narrow[2]), rtol=1e-6)


def test_uniform_close_is_the_operator_composition_bitwise():
    params, clients = _problem(3, seed=2)
    pw0, pglob, _ = _port_close(params, clients, [0, 1, 2], None, 3, "kernels")
    tc = [params_from_numpy(c, CPU) for c in clients]
    g, res = agg.fedex_aggregate(tc)
    new = agg.apply_residual(params_from_numpy(params, CPU), res, SCALE)
    for k, x in flatten_with_paths(to_numpy(new)).items():
        np.testing.assert_array_equal(pw0[k], x)
    for k, x in flatten_with_paths(to_numpy(g)).items():
        np.testing.assert_array_equal(pglob[k], x)


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 2.0]], ids=["uniform",
                                                                  "weighted"])
def test_aggregation_operators_match(weights):
    params, clients = _problem(3, seed=3)
    jg, jres = jagg.fedex_aggregate(clients, weights)
    jnew = jagg.apply_residual(params, jres, SCALE)
    tc = [params_from_numpy(c, CPU) for c in clients]
    g, res = agg.fedex_aggregate(tc, weights)
    new = agg.apply_residual(params_from_numpy(params, CPU), res, SCALE)
    for ref, port in ((jg, g), (jres, res), (jnew, new),
                      (jagg.product_mean(clients, weights),
                       agg.product_mean(tc, weights))):
        rf, pf = jax_flatten(ref), flatten_with_paths(to_numpy(port))
        assert list(rf) == list(pf)
        for k in rf:
            np.testing.assert_allclose(pf[k], np.asarray(rf[k]), rtol=1e-5,
                                       atol=1e-9)
    assert agg.normalize_weights([2.0, 2.0], 2) is None
    assert agg.normalize_weights([1.0, 3.0], 2) == [0.25, 0.75]
    with pytest.raises(ValueError):
        agg.normalize_weights([1.0, -1.0], 2)


def test_round_buffers_ring():
    _, clients = _problem(3, seed=4)
    tc = [params_from_numpy(c, CPU) for c in clients]
    buf = RoundBuffers(tc[0], c_max=3, depth=2)
    r0 = buf.begin_round({0: 0, 1: 1, 2: 2}, round_id=0)
    r1 = buf.begin_round({2: 0}, round_id=1)
    with pytest.raises(RuntimeError):
        buf.begin_round({0: 0}, round_id=2)  # both sets in flight
    assert buf.write(1, tc[1], round_id=r0)
    assert not buf.write(1, tc[0], round_id=r0)  # duplicate lane dropped
    assert buf.write(2, tc[2], round_id=r1)
    assert buf.delivered_in(r0) == {1: 1} and buf.lanes(r1) == {2: 0}
    s0 = buf.take()  # FIFO: round 0
    path = "layers/attn/q_proj/a"
    assert torch.equal(s0[path][1], tc[1]["layers"]["attn"]["q_proj"]["a"])
    assert not s0[path][0].any() and not s0[path][2].any()
    r2 = buf.begin_round({0: 0}, round_id=2)
    s2 = buf.take(r2)
    assert not s2[path].any()  # fresh zeros, never a reused set
    assert buf.open_rounds == [1]
    r3 = buf.begin_round({0: 0}, round_id=3)
    bad = dict(flatten_with_paths(tc[0]))
    bad[path] = bad[path][:, :5]
    with pytest.raises(ValueError):
        buf.write_flat(0, bad, round_id=r3)


def test_unported_methods_raise():
    """Every engine method is ported; what is not an engine method (the
    eager fedit), fedex_svd without a truncation rank, and the reference's
    Pallas backend name are refused."""
    params, clients = _problem(2)
    tp = params_from_numpy(params, CPU)
    tl = params_from_numpy(clients[0], CPU)
    with pytest.raises(ValueError):
        make_close_fn([], scale=1.0, c_max=2, method="fedit")
    with pytest.raises(ValueError):
        make_close_fn([], scale=1.0, c_max=2, method="fedex_svd")
    with pytest.raises(ValueError):
        RoundCloseEngine(tp, tl, c_max=2, scale=1.0, backend="pallas")
