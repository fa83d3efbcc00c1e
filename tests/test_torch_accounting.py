"""The port's §6 / Table 6 accounting and §7 DP modules against the JAX
package's, on the same numpy-made inputs at small sizes:
``repro_torch.core.divergence``, ``.decompose``, ``.comm``, ``.privacy`` and
the two aggregation operators of the baselines (``ffa_aggregate``,
``fedex_svd_aggregate``).

Tolerances, with their reasons:
* the deviations, the factored residual and every aggregate: f32 sums in
  the same order as the reference, but matmuls blocked otherwise —
  rtol 1e-5 with an absolute floor of 1e-6 of the largest magnitude;
* truncations: LAPACK drivers differ, and singular vectors carry a free
  sign, so only U·diag(s)·Vt (and a′b′ products) are compared, rtol 1e-4
  of the matrix norm;
* the Table 6 counts are integers and must be equal;
* DP: the reference's noise carried across (``gaussian_noise_like`` given
  the same tree), the clip in f32 as the reference's: rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import decompose as jdecompose  # noqa: E402
from repro.core import divergence as jdivergence  # noqa: E402
from repro.core import privacy as jprivacy  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import LoRAConfig, get_config  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import comm, decompose, divergence, privacy  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread. The suite runs several workers
    on a few cores, where a multi-threaded torch op waits at every barrier
    for threads the scheduler has parked, which makes these small-shape
    tests many times slower; one thread gives the same results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _clients(seed, k, stacked, r=3, m=24, n=20, scale=0.3):
    """k adapter trees (numpy) of two matrices, stacked over 2 layers or
    2-D."""
    rng = np.random.default_rng(seed)
    lead = (2,) if stacked else ()

    def factor(mm, nn):
        return {"a": rng.normal(0, scale, lead + (mm, r)).astype(np.float32),
                "b": rng.normal(0, scale, lead + (r, nn)).astype(np.float32)}

    return [{"attn": {"q_proj": factor(m, n), "k_proj": factor(m, n // 2)}}
            for _ in range(k)]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _trees_close(port, ref, rtol=1e-5):
    pf, rf = flatten_with_paths(to_numpy(port)), flatten_with_paths(_np(ref))
    assert list(pf) == sorted(rf)
    for k in pf:
        _close(pf[k], rf[k], rtol)


# --------------------------------------------------------------------------
# divergence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_deviation_tree_matches_reference(stacked, k):
    clients = _clients(10 + k, k, stacked)
    port = divergence.deviation_tree([params_from_numpy(c, CPU)
                                      for c in clients])
    ref = jdivergence.deviation_tree([_jax(c) for c in clients])
    _trees_close(port, ref)
    for metric in ("scaled", "relative", "fro"):
        pf = divergence.flatten_deviations(port, metric)
        rf = jdivergence.flatten_deviations(ref, metric)
        assert list(pf) == list(rf)
        for key in pf:
            assert pf[key].shape == rf[key].shape
            _close(pf[key], rf[key])


@pytest.mark.parametrize("metric", ["scaled", "relative", "fro"])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_mean_deviation_matches_reference(stacked, metric):
    clients = _clients(20, 4, stacked)
    got = divergence.mean_deviation([params_from_numpy(c, CPU)
                                     for c in clients], metric)
    want = jdivergence.mean_deviation([_jax(c) for c in clients], metric)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("weights", [None, [5.0, 1.0, 2.0]],
                         ids=["uniform", "weighted"])
def test_deviation_is_against_the_uniform_fedit_mean(weights):
    """A weighted round's deviation is still taken against the uniform
    mean, as the reference's is: ‖mean(aᵢbᵢ) − ā b̄‖ with uniform means,
    which the uniform FedEx residual is exactly (in f64 here)."""
    clients = _clients(30, 3, stacked=False)
    got = divergence.flatten_deviations(divergence.deviation_tree(
        [params_from_numpy(c, CPU) for c in clients]), "fro")
    for key, fro in got.items():
        path = key.split("/")
        fs = [c[path[0]][path[1]] for c in clients]
        a = [f["a"].astype(np.float64) for f in fs]
        b = [f["b"].astype(np.float64) for f in fs]
        res = (sum(x @ y for x, y in zip(a, b)) / 3
               - (sum(a) / 3) @ (sum(b) / 3))
        _close(fro, np.linalg.norm(res), rtol=1e-4)
        if weights is not None:  # the weighted residual is another matrix
            w = np.asarray(weights) / sum(weights)
            wres = (sum(wi * x @ y for wi, x, y in zip(w, a, b))
                    - sum(wi * x for wi, x in zip(w, a))
                    @ sum(wi * y for wi, y in zip(w, b)))
            assert abs(np.linalg.norm(wres) - fro) > 1e-3 * fro


# --------------------------------------------------------------------------
# decompose
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 2.0, 0.5]],
                         ids=["uniform", "weighted"])
def test_residual_factors_match_reference_and_dense_residual(weights):
    clients = _clients(40, 4, stacked=False)
    fs = [c["attn"]["q_proj"] for c in clients]
    L, R = decompose.residual_factors([params_from_numpy(f, CPU) for f in fs],
                                      weights)
    jL, jR = jdecompose.residual_factors([_jax(f) for f in fs], weights)
    assert L.shape == (24, 5 * 3) and R.shape == (5 * 3, 20)
    _close(L, jL)
    _close(R, jR)
    dense = agg.fedex_residual([params_from_numpy(c, CPU) for c in clients],
                               weights=weights)["attn"]["q_proj"]
    _close(L @ R, dense, rtol=1e-4)


@pytest.mark.parametrize("rank", [1, 3, 8])
def test_truncated_svd_product_matches_reference(rank):
    clients = _clients(50, 3, stacked=False)
    fs = [c["attn"]["q_proj"] for c in clients]
    L, R = decompose.residual_factors([params_from_numpy(f, CPU) for f in fs])
    u, s, vt = decompose.truncated_svd_product(L, R, rank)
    assert u.shape == (24, rank) and s.shape == (rank,)
    assert vt.shape == (rank, 20)
    got = decompose.reconstruct(u, s, vt).numpy()
    jL, jR = jdecompose.residual_factors([_jax(f) for f in fs])
    want = np.asarray(jdecompose.reconstruct(
        *jdecompose.truncated_svd_product(jL, jR, rank)))
    norm = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= 1e-4 * norm
    # the Eckart–Young truncation of the dense residual (f64)
    uu, ss, vv = np.linalg.svd((L @ R).double().numpy())
    dense = (uu[:, :rank] * ss[:rank]) @ vv[:rank]
    assert np.linalg.norm(got - dense) <= 1e-4 * norm


@pytest.mark.parametrize("m,n,r,k", [(24, 20, 3, 4), (3072, 1024, 4, 2),
                                     (768, 2304, 8, 10)])
def test_residual_param_counts_match_reference(m, n, r, k):
    assert decompose.factored_residual_params(m, n, r, k) == \
        jdecompose.factored_residual_params(m, n, r, k)
    assert decompose.truncated_residual_params(m, n, r) == \
        jdecompose.truncated_residual_params(m, n, r)


# --------------------------------------------------------------------------
# comm (Table 6)
# --------------------------------------------------------------------------

ARCHS = ["paper-tiny", "paper-llama3.2-3b", "paper-gpt2"]
METHODS = ["full_ft", "fedit", "ffa", "fedex", "fedex_svd"]


def _cfgs(arch, include_mlp):
    return ((get_config(arch), LoRAConfig(include_mlp=include_mlp)),
            (jax_get_config(arch), JLoRAConfig(include_mlp=include_mlp)))


@pytest.mark.parametrize("include_mlp", [False, True], ids=["attn", "mlp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adapted_matrices_match_reference(arch, include_mlp):
    (cfg, lora), (jcfg, jlora) = _cfgs(arch, include_mlp)
    got = [(ms.name, ms.m, ms.n) for ms in comm.adapted_matrices(cfg, lora)]
    want = [(ms.name, ms.m, ms.n)
            for ms in jcomm.adapted_matrices(jcfg, jlora)]
    assert got == want and len(got) == cfg.num_layers * (7 if include_mlp
                                                          else 4)


@pytest.mark.parametrize("participants", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_round_comm_params_match_reference(arch, method, participants):
    (cfg, lora), (jcfg, jlora) = _cfgs(arch, False)
    mats = comm.adapted_matrices(cfg, lora)
    jmats = jcomm.adapted_matrices(jcfg, jlora)
    for svd_rank in (0, 2, 8):
        for fraction in (1.0, 0.5, 0.3):
            got = comm.round_comm_params(
                method, mats, lora.rank, 4, svd_rank=svd_rank,
                participation_fraction=fraction, participants=participants)
            want = jcomm.round_comm_params(
                method, jmats, jlora.rank, 4, svd_rank=svd_rank,
                participation_fraction=fraction, participants=participants)
            assert got == want
            assert all(type(v) is int for v in got.values())


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_comm_table_matches_reference(arch, fraction):
    (cfg, lora), (jcfg, jlora) = _cfgs(arch, False)
    for k, svd_rank in ((4, 0), (10, 2)):
        assert comm.comm_table(cfg, lora, k, 50, svd_rank, fraction) == \
            jcomm.comm_table(jcfg, jlora, k, 50, svd_rank, fraction)


@pytest.mark.parametrize("call", [
    lambda m: m.participating_clients(10, 0.0),
    lambda m: m.participating_clients(10, 1.5),
    lambda m: m.round_comm_params("fedex", [], 4, 4, participants=9),
    lambda m: m.round_comm_params("sgd", [], 4, 4),
], ids=["fraction-0", "fraction-1.5", "participants-9-of-4", "method"])
def test_comm_refuses_what_the_reference_refuses(call):
    with pytest.raises(ValueError) as port:
        call(comm)
    with pytest.raises(ValueError) as ref:
        call(jcomm)
    assert str(port.value) == str(ref.value)
    assert comm.participating_clients(10, 0.25, 4) == \
        jcomm.participating_clients(10, 0.25, 4) == 4


# --------------------------------------------------------------------------
# privacy
# --------------------------------------------------------------------------

def _reference_noise(key):
    def noise(gen, tree, std):
        jtree = _jax(to_numpy(tree))
        return params_from_numpy(_np(jprivacy.gaussian_noise_like(
            jax.random.key(key), jtree, std)), CPU)
    return noise


@pytest.mark.parametrize("clip", [0.05, 1.0, 1e9])
def test_clip_delta_matches_reference(clip):
    delta = _clients(60, 1, stacked=True)[0]
    got, norm = privacy.clip_delta(params_from_numpy(delta, CPU), clip)
    want, jnorm = jprivacy.clip_delta(_jax(delta), clip)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _trees_close(got, want, rtol=1e-6)
    assert float(privacy.l2_norm(got)) <= min(clip, float(norm)) * (1 + 1e-6)


@pytest.mark.parametrize("clip,sigma", [(1e9, 0.0), (0.5, 0.3), (2.0, 1.0)])
def test_privatize_upload_matches_reference(clip, sigma, monkeypatch):
    local, glob = _clients(70, 2, stacked=True)
    monkeypatch.setattr(privacy, "gaussian_noise_like", _reference_noise(7))
    got = privacy.privatize_upload(torch.Generator().manual_seed(7),
                                   params_from_numpy(local, CPU),
                                   params_from_numpy(glob, CPU), clip=clip,
                                   noise_multiplier=sigma)
    want = jprivacy.privatize_upload(jax.random.key(7), _jax(local),
                                     _jax(glob), clip=clip,
                                     noise_multiplier=sigma)
    _trees_close(got, want, rtol=1e-6)
    if sigma == 0.0:  # no noise, no clip: the upload is the local adapters
        _trees_close(got, local, rtol=1e-6)


def test_gaussian_noise_draws_from_the_generator():
    tree = params_from_numpy(_clients(80, 1, stacked=True)[0], CPU)
    one = privacy.gaussian_noise_like(torch.Generator().manual_seed(3), tree,
                                      0.5)
    two = privacy.gaussian_noise_like(torch.Generator().manual_seed(3), tree,
                                      0.5)
    other = privacy.gaussian_noise_like(torch.Generator().manual_seed(4),
                                        tree, 0.5)
    flat = flatten_with_paths(one)
    for k, x in flat.items():
        assert x.shape == flatten_with_paths(tree)[k].shape
        assert x.dtype == torch.float32
        assert torch.equal(x, flatten_with_paths(two)[k])
        assert not torch.equal(x, flatten_with_paths(other)[k])
    allv = torch.cat([x.ravel() for x in flat.values()])
    assert abs(float(allv.std()) - 0.5) < 0.05


def test_fedex_is_exact_on_noised_uploads():
    """The paper's §7 point: DP noise does not break exactness — the
    residual absorbs whatever the clients uploaded (the port's twin of the
    reference's ``TestPrivacy.test_fedex_exact_wrt_noised_adapters``)."""
    rng = np.random.default_rng(1)
    g = {"w": {"a": rng.normal(size=(12, 3)).astype(np.float32),
               "b": rng.normal(size=(3, 9)).astype(np.float32)}}
    gt = params_from_numpy(g, CPU)
    uploads = []
    for i in range(3):
        local = {"w": {k: v + 0.1 * rng.normal(size=v.shape).astype(
            np.float32) for k, v in g["w"].items()}}
        uploads.append(privacy.privatize_upload(
            torch.Generator().manual_seed(i), params_from_numpy(local, CPU),
            gt, clip=0.5, noise_multiplier=0.3))
    glob, res = agg.fedex_aggregate(uploads)
    ideal = agg.product_mean(uploads)["w"]
    got = glob["w"]["a"] @ glob["w"]["b"] + res["w"]
    np.testing.assert_allclose(got.numpy(), ideal.numpy(), rtol=2e-4,
                               atol=2e-4)
    # and FedIT is not exact on the same uploads
    assert float((glob["w"]["a"] @ glob["w"]["b"] - ideal).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# the baselines' aggregation operators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, [2.0, 1.0, 1.0]],
                         ids=["uniform", "weighted"])
def test_ffa_aggregate_matches_reference(weights):
    clients = _clients(90, 3, stacked=True)
    for c in clients[1:]:  # FFA: a is shared
        for key in c["attn"]:
            c["attn"][key]["a"] = clients[0]["attn"][key]["a"]
    got = agg.ffa_aggregate([params_from_numpy(c, CPU) for c in clients],
                            weights)
    want = jagg.ffa_aggregate([_jax(c) for c in clients], weights)
    _trees_close(got, want)


@pytest.mark.parametrize("svd_rank", [1, 2, 6, 9])
@pytest.mark.parametrize("weights", [None, [2.0, 1.0, 1.0]],
                         ids=["uniform", "weighted"])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_fedex_svd_aggregate_matches_reference(stacked, weights, svd_rank):
    clients = _clients(100, 3, stacked)
    glob, res = agg.fedex_svd_aggregate(
        [params_from_numpy(c, CPU) for c in clients], svd_rank, weights)
    jglob, jres = jagg.fedex_svd_aggregate([_jax(c) for c in clients],
                                           svd_rank, weights)
    _trees_close(glob, jglob)
    pf, rf = flatten_with_paths(to_numpy(res)), flatten_with_paths(_np(jres))
    for k in pf:
        assert np.linalg.norm(pf[k] - rf[k]) <= 1e-4 * np.linalg.norm(rf[k])
        if svd_rank < 9:  # really truncated: rank ≤ r'
            sv = np.linalg.svd(pf[k].reshape((-1,) + pf[k].shape[-2:]),
                               compute_uv=False)
            assert (sv[:, svd_rank:] <= 1e-4 * sv[:, :1]).all()


@pytest.mark.parametrize("svd_rank", [0, 10])
def test_fedex_svd_aggregate_refuses_ranks_outside_the_bound(svd_rank):
    clients = [params_from_numpy(c, CPU) for c in _clients(110, 3, False)]
    with pytest.raises(ValueError, match="svd_rank"):
        agg.fedex_svd_aggregate(clients, svd_rank)


def test_paper_configs_are_the_same_on_both_sides():
    for arch in ARCHS:
        port, ref = get_config(arch), jax_get_config(arch)
        for f in ("d_model", "num_heads", "num_kv_heads", "d_ff",
                  "num_layers", "resolved_head_dim"):
            assert getattr(port, f) == getattr(ref, f), (arch, f)
    for f in ("rank", "alpha", "include_mlp"):
        assert getattr(LoRAConfig(), f) == getattr(JLoRAConfig(), f), f
