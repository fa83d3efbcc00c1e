"""The port's eager close (``engine="off"``) against the JAX reference's,
round by round, at the README quickstart shape (paper-tiny, vocab 64, 3
clients, 3 local steps, 2 rounds): fedex (uniform, and weighted at 50%
participation), fedex_svd (r' = 2), reinit, keep_local and hetero (ranks 4,
2, 1); and the eager close against the port's own engine close.

Both trainers start from the reference's draws (carried across with
``repro_torch.bridge``): the initial params and adapters, every reinit
round's fresh adapters (``jax.random.key(seed + round)``, carried across by
seed) and, for hetero, each client's initial rank-rᵢ adapters.

Tolerances, per round, as ``tests/test_torch_federated.py`` states them:
eval and client losses rtol 1e-5, the §6 divergence rtol 1e-3; W0 (every
client's base for keep_local and hetero) and adapters by each leaf's
relative Frobenius error ≤ 1e-2 plus the AdamW separation bound. The SVD
closes leave eigenvector signs open, so fedex_svd and hetero compare a′b′
products, never the factors alone.

Eager against engine (one round from the same draws, so both close the
same uplinks, bit for bit): the fedex, reinit and keep_local W0s within the
folds' error bounds (``fold_error_bound``, ``product_error_bound``,
``perclient_error_bound``: 2·(C + r + 4) unit roundoffs of the magnitudes
each element carries); fedex_svd and hetero, whose engine truncates on
factored Grams (about half of the f32 digits), with the folded update
within 1e-4 of its Frobenius norm, as ``tests/test_torch_closes.py``
holds the engine to its eager oracle.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.kernels import (fold_error_bound,  # noqa: E402
                                 perclient_error_bound, product_error_bound)
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 3, 2, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)
PARTIAL = dict(weighting="examples", participation=0.5)
CASES = {
    "fedex": {},
    "fedex-examples-50%": PARTIAL,
    "fedex_svd": {"method": "fedex_svd", "svd_rank": 2},
    "reinit": {"assignment": "reinit", **PARTIAL},
    "keep_local": {"assignment": "keep_local", **PARTIAL},
    "hetero": {"method": "hetero", "client_ranks": (4, 2, 1)},
}


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


def _reference():
    return dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=VOCAB,
                               dtype="float32")


def _trainers(**fed_kw):
    """The reference's eager trainer and two of the port's from its draws:
    ``engine="off"`` and the default engine close."""
    fed = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS, **fed_kw)
    jl, je = jax_data(VOCAB, CLIENTS, seed=0)
    jt = JaxTrainer(model=jax_build_model(_reference()),
                    lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="off", **fed),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je, seed=0)
    assert jt.engine is None
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=VOCAB,
                              dtype="float32")
    client_loras = None
    if getattr(jt, "hetero", False):
        client_loras = [_np(x) for x in jt._client_lora]
    port = []
    for engine in ("off", "auto"):
        pl, pe = build_federated_data(VOCAB, CLIENTS, seed=0, device=CPU)
        port.append(FederatedTrainer(
            model=build_model(cfg), lora_cfg=LoRAConfig(),
            fed_cfg=FedConfig(engine=engine, **fed),
            train_cfg=TrainConfig(**TRAIN), client_loaders=pl,
            eval_batches=pe, seed=0, device=CPU,
            params=params_from_numpy(_np(jt.params), CPU),
            global_lora=params_from_numpy(_np(jt.global_lora), CPU),
            client_loras=client_loras and [params_from_numpy(x, CPU)
                                           for x in client_loras]))
    return jt, port[0], port[1]


def _assert_trees_close(ref, port):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert list(rf) == list(pf)
    max_sep = 2 * LR * STEPS * CLIENTS
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


def _products(lora):
    """key → a @ b per adapted matrix (invariant to eigenvector signs)."""
    flat = flatten_with_paths(lora)
    return {k[:-2]: x @ flat[k[:-1] + "b"] for k, x in flat.items()
            if k.endswith("/a")}


def _w0(params):
    return {k: x for k, x in flatten_with_paths(params).items()
            if k.endswith("/kernel") and "_proj" in k and "/attn/" in k}


def _compare_round(jt, pt, per_client, signs_free):
    if per_client:
        pairs = [(jt.client_params[c], pt.client_params[c],
                  jt._client_lora[c], pt._client_lora[c])
                 for c in range(CLIENTS)]
    else:
        pairs = [(jt.params, pt.params, jt.global_lora, pt.global_lora)]
    for jp, pp, jl, pl in pairs:
        _assert_trees_close(jp, pp)
        if signs_free:
            _assert_trees_close(_products(_np(jl)), _products(pl))
        else:
            _assert_trees_close(jl, pl)


def _eager_against_engine(name, eager, engine, old):
    """Round 0 of the eager close against the engine close of the same
    uplinks (each trainer ran the same client steps)."""
    out = eager.outcomes[-1]
    assert out.client_ids == engine.outcomes[-1].client_ids
    for d, e in zip(out.delivered, engine.outcomes[-1].delivered):
        for k, x in flatten_with_paths(d.lora).items():
            assert torch.equal(x, flatten_with_paths(e.lora)[k]), k
    k_d = len(out.delivered)
    w = torch.tensor(out.weights or [1.0 / k_d] * k_d)
    s = eager.scale
    if name in ("keep_local", "hetero"):
        bases = [(c, eager.client_params[c], engine.client_params[c])
                 for c in out.client_ids]
    else:
        bases = [(None, eager.params, engine.params)]
    for c, pe, pg in bases:
        we, wg = _w0(pe), _w0(pg)
        for key, w0_old in old.items():
            node = key[: -len("/kernel")]
            a = torch.stack([flatten_with_paths(d.lora)[node + "/a"]
                             for d in out.delivered])
            b = torch.stack([flatten_with_paths(d.lora)[node + "/b"]
                             for d in out.delivered])
            got, want = we[key], wg[key]
            if name in ("fedex", "fedex-examples-50%"):
                bound = fold_error_bound(w0_old, a, b, s, w)
            elif name == "reinit":
                bound = product_error_bound(w0_old, a, b, w, s)
            elif name == "keep_local":
                j = out.client_ids.index(c)
                bound = perclient_error_bound([w0_old] * k_d, a, b, w, s)[j]
            else:  # factored Gram truncations: half of the f32 digits
                upd = want - w0_old
                err = torch.linalg.norm((got - w0_old) - upd)
                assert err <= 1e-4 * torch.linalg.norm(upd), (key, c)
                continue
            assert bool(((got - want).abs() <= bound).all()), (key, c)


@pytest.mark.parametrize("name", list(CASES))
def test_eager_trainer_matches_reference_and_engine(name, monkeypatch):
    jt, pt, pe = _trainers(**CASES[name])
    assert pt.engine is None and pt.coordinator.sink is None
    assert pe.engine is not None
    if name == "reinit":
        template = jt.global_lora

        def reference_draw(_template, gen):
            fresh = jagg.reinit_adapters(template,
                                         jax.random.key(gen.initial_seed()))
            return params_from_numpy(_np(fresh), CPU)

        monkeypatch.setattr(agg, "reinit_adapters", reference_draw)
    per_client = name in ("keep_local", "hetero")
    old = {k: x.clone() for k, x in _w0(pt.params).items()}
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3)
        _compare_round(jt, pt, per_client,
                       signs_free=name in ("fedex_svd", "hetero"))
        if jt.outcomes:
            assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
            assert pt.outcomes[-1].weights == jt.outcomes[-1].weights
        if rnd == 0:
            pe.run(until=1)
            _eager_against_engine(name, pt, pe, old)
