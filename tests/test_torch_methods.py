"""The port's trainer on the reinit, keep_local, fedex_svd and hetero closes
against the JAX reference's, round by round, at the README quickstart shape
(paper-tiny, vocab 64, 3 clients, 3 local steps, 2 rounds); plus the
per-client bases' independence and the launcher's new flags.

Both trainers start from the reference's draws (carried across with
``repro_torch.bridge``): the initial params and adapters, every reinit
round's fresh adapters (keyed ``seed + round``) and, for hetero, each
client's initial rank-rᵢ adapters. The data are the same numpy-made
batches.

Tolerances, per round, as ``tests/test_torch_federated.py`` states them:
eval and client losses rtol 1e-5, the §6 divergence rtol 1e-3; W0 (every
client's base for keep_local and hetero) and adapters by each leaf's
relative Frobenius error ≤ 1e-2 plus the AdamW separation bound.
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
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 3, 2, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)
PARTIAL = dict(weighting="examples", participation=0.5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trainers(port_engine="auto", **fed_kw):
    """The reference's trainer and the port's, from the reference's draws."""
    fed = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS, **fed_kw)
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=VOCAB,
                               dtype="float32")
    jl, je = jax_data(VOCAB, CLIENTS, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", **fed),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je, seed=0)
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=VOCAB,
                              dtype="float32")
    pl, pe = build_federated_data(VOCAB, CLIENTS, seed=0, device=CPU)
    client_loras = None
    if getattr(jt, "hetero", False):
        client_loras = [params_from_numpy(_np(x), CPU)
                        for x in jt._client_lora]
    pt = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(engine=port_engine, **fed),
        train_cfg=TrainConfig(**TRAIN), client_loaders=pl, eval_batches=pe,
        seed=0, device=CPU, params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU),
        client_loras=client_loras)
    return jt, pt


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
    """key → a @ b per adapted matrix: invariant to the sign of each rank
    column / row pair, which an eigendecomposition leaves open."""
    return {k[:-2]: x @ flatten_with_paths(lora)[k[:-1] + "b"]
            for k, x in flatten_with_paths(lora).items() if k.endswith("/a")}


def _run_and_compare(jt, pt, per_client: bool, signs_free: bool = False):
    """``signs_free``: the adapters come from an eigendecomposition (hetero),
    so compare their products, not the factors."""
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3)
        if per_client:
            for c in range(CLIENTS):
                _assert_trees_close(jt.client_params[c], pt.client_params[c])
                if signs_free:
                    _assert_trees_close(
                        _products(_np(jt._client_lora[c])),
                        _products(pt._client_lora[c]))
                else:
                    _assert_trees_close(jt._client_lora[c],
                                        pt._client_lora[c])
        else:
            _assert_trees_close(jt.params, pt.params)
            _assert_trees_close(jt.global_lora, pt.global_lora)
        if jt.outcomes:
            assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
            assert pt.outcomes[-1].weights == jt.outcomes[-1].weights


def test_reinit_trainer_matches_reference(monkeypatch):
    """50% participation with example weights: every close runs the
    product fold; each round's fresh adapters are the reference's draws
    (``jax.random.key(seed + round)``), carried across by seed."""
    jt, pt = _trainers(assignment="reinit", **PARTIAL)
    template = jt.global_lora

    def reference_draw(_template, gen):
        fresh = jagg.reinit_adapters(template,
                                     jax.random.key(gen.initial_seed()))
        return params_from_numpy(_np(fresh), CPU)

    monkeypatch.setattr(agg, "reinit_adapters", reference_draw)
    _run_and_compare(jt, pt, per_client=False)
    assert all(not flatten_with_paths(pt.global_lora)[k].any()
               for k in flatten_with_paths(pt.global_lora) if k.endswith("b"))


def test_keep_local_trainer_matches_reference():
    """50% participation with example weights, the kernel close on the CPU
    (the wrappers' plain versions folding into each client's base in
    place)."""
    jt, pt = _trainers(port_engine="kernels", assignment="keep_local",
                       **PARTIAL)
    _run_and_compare(jt, pt, per_client=True)


def test_svd_trainer_matches_reference():
    jt, pt = _trainers(method="fedex_svd", svd_rank=2)
    assert pt.engine.method == "fedex_svd"
    _run_and_compare(jt, pt, per_client=False)


def test_hetero_trainer_matches_reference():
    """Ragged ranks (4, 2, 1): each client trains at its rank from the
    reference's initial draws; the kernel close on the CPU."""
    jt, pt = _trainers(port_engine="kernels", method="hetero",
                       client_ranks=(4, 2, 1))
    assert [x["layers"]["attn"]["q_proj"]["a"].shape[-1]
            for x in pt._client_lora] == [4, 2, 1]
    _run_and_compare(jt, pt, per_client=True, signs_free=True)
    assert [x["layers"]["attn"]["q_proj"]["a"].shape[-1]
            for x in pt._client_lora] == [4, 2, 1]


def _tiny_trainer(clients=2, **fed_kw):
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=32,
                              num_layers=1, dtype="float32")
    loaders, evals = build_federated_data(32, clients, seqs_per_task=8,
                                          device=CPU)
    return FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(num_clients=clients, rounds=1, local_steps=2,
                          **fed_kw),
        train_cfg=TrainConfig(learning_rate=LR, schedule="constant",
                              total_steps=2),
        client_loaders=loaders, eval_batches=evals, device=CPU)


@pytest.mark.parametrize("fed_kw", [
    {"assignment": "keep_local", "participation": 0.5},
    {"method": "hetero", "client_ranks": (4, 2, 1)},
], ids=["keep_local", "hetero"])
def test_client_bases_do_not_alias(fed_kw):
    """The in-place kernel close folds into each delivered client's own
    base: a client left out of the round and the trainer's params never
    move (2 of 3 clients deliver at 50% participation)."""
    pt = _tiny_trainer(clients=3, engine="kernels", **fed_kw)
    keys = [s.key for s in pt.engine.specs]

    def leaves(tree):
        return {k: flatten_with_paths(tree)[k + "/kernel"] for k in keys}

    ptrs = [{k: x.data_ptr() for k, x in leaves(p).items()}
            for p in pt.client_params + [pt.params]]
    for k in keys:
        assert len({p[k] for p in ptrs}) == len(ptrs), k
    before = [{k: x.clone() for k, x in leaves(p).items()}
              for p in pt.client_params + [pt.params]]
    pt.run(until=1)
    moved = [any(not torch.equal(leaves(p)[k], before[i][k]) for k in keys)
             for i, p in enumerate(pt.client_params + [pt.params])]
    delivered = pt.outcomes[-1].client_ids
    assert moved == [c in delivered for c in range(3)] + [False]
    if fed_kw.get("participation"):
        assert len(delivered) == 2


@pytest.mark.parametrize("args", [
    ["--assignment", "keep_local"],
    ["--assignment", "reinit", "--participation", "0.5",
     "--weighting", "examples"],
    ["--method", "fedex_svd", "--svd-rank", "2"],
    ["--method", "hetero", "--client-ranks", "4,2,1"],
], ids=["keep_local", "reinit", "fedex_svd", "hetero"])
def test_launcher_runs_each_close_on_cpu_and_needs_cuda_otherwise(args,
                                                                  capsys):
    base = ["--clients", "3", "--rounds", "2", "--local-steps", "1",
            "--vocab", "32", "--data-vocab", "16"]
    port_train.main(["--device", "cpu", *base, *args])
    out = capsys.readouterr().out
    assert "round=1 " in out and "close backend=plain" in out
    assert "nan" not in out.split("final:")[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_train.main([*base, *args])
