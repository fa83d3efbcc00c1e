"""The port's trainer on the paper's baselines (FedIT, FFA-LoRA, centralized)
and with DP-clipped and noised uploads, against the JAX reference's, round
by round, at the README quickstart shape (paper-tiny, vocab 64, 3 clients,
3 local steps, 2 rounds); plus FFA's frozen a and the launcher's new flags.

Both trainers start from the reference's draws (carried across with
``repro_torch.bridge``) and the same numpy-made data. The DP noise is the
reference's too: ``repro_torch.core.privacy.gaussian_noise_like`` is
replaced by the reference's draw from ``jax.random.key(seed)``, with
``seed`` the port generator's (both trainers seed a client's stream with
``hash((seed, round, client)) % 2**31``).

Tolerances, per round, as ``tests/test_torch_federated.py`` states them:
eval and client losses rtol 1e-5, the §6 divergence rtol 1e-3; W0 and the
global adapters by each leaf's relative Frobenius error ≤ 1e-2 plus the
AdamW separation bound (2·lr·steps·clients elementwise). FFA's divergence
is f32 rounding only (every client holds the same a, so mean(a·bᵢ) and
a·mean(bᵢ) differ by rounding, ≈ 1e-11 here): it is held to 1e-9 absolute
on both sides, below the reference's own bound of 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.core import privacy as jprivacy  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core import privacy  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 3, 2, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)
PARTIAL = dict(weighting="examples", participation=0.5)
DP = dict(dp_clip=1.0, dp_noise_multiplier=0.1)


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


def _trainers(**fed_kw):
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
    pt = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**TRAIN),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    return jt, pt


def _reference_noise(gen, tree, std):
    """The reference's noise for the port generator's seed."""
    jtree = jax.tree.map(jnp.asarray, to_numpy(tree))
    noise = jprivacy.gaussian_noise_like(jax.random.key(gen.initial_seed()),
                                         jtree, std)
    return params_from_numpy(_np(noise), CPU)


def _assert_trees_close(ref, port):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert list(rf) == list(pf)
    max_sep = 2 * LR * STEPS * CLIENTS
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


def _run_and_compare(jt, pt, div_atol=0.0):
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3,
                                   atol=div_atol)
        assert prec.lr == pytest.approx(jrec.lr)
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
        assert len(pt.outcomes) == len(jt.outcomes)
        if jt.outcomes:
            assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
            assert pt.outcomes[-1].weights == jt.outcomes[-1].weights


@pytest.mark.parametrize("fed_kw", [
    {"method": "fedit"},
    {"method": "fedit", **PARTIAL},
    {"method": "ffa"},
    {"method": "centralized"},
], ids=["fedit", "fedit-examples-50%", "ffa", "centralized"])
def test_baseline_trainer_matches_reference(fed_kw):
    jt, pt = _trainers(**fed_kw)
    assert pt.engine is None and pt.coordinator.sink is None
    w0 = {k: x.clone() for k, x in flatten_with_paths(pt.params).items()}
    ffa = fed_kw["method"] == "ffa"
    _run_and_compare(jt, pt, div_atol=1e-9 if ffa else 0.0)
    # no baseline folds anything into the frozen weights
    assert all(torch.equal(x, w0[k])
               for k, x in flatten_with_paths(pt.params).items())
    if fed_kw["method"] == "centralized":
        assert not pt.outcomes
        assert [h.divergence_scaled for h in pt.history] == [0.0] * ROUNDS
    if fed_kw.get("participation"):
        assert all(len(o.client_ids) == 2 for o in pt.outcomes[-1:])


@pytest.mark.parametrize("method", ["fedex", "fedit"])
def test_dp_trainer_matches_reference(method, monkeypatch):
    """Clip 1 and σ 0.1 on every upload, the reference's noise carried
    across; fedex closes through the engine, fedit eagerly."""
    jt, pt = _trainers(method=method, **DP)
    seeds = []

    def noise(gen, tree, std):
        seeds.append(gen.initial_seed())
        assert std == pytest.approx(0.1)
        return _reference_noise(gen, tree, std)

    monkeypatch.setattr(privacy, "gaussian_noise_like", noise)
    _run_and_compare(jt, pt)
    # one stream a client and round (the clients run in arrival order)
    assert sorted(seeds) == sorted(hash((0, r, c)) % 2 ** 31
                                   for r in range(ROUNDS)
                                   for c in range(CLIENTS))


def test_ffa_uploads_share_a_bitwise():
    """FFA-LoRA zeroes the a-gradients: weight decay alone moves a, the same
    on every client, so every delivered a is bitwise equal, while b trains."""
    _, pt = _trainers(method="ffa")
    start = flatten_with_paths(pt.global_lora)
    pt.run()
    ups = [flatten_with_paths(d.lora) for d in pt.outcomes[-1].delivered]
    assert len(ups) == CLIENTS
    for key in ups[0]:
        if key.endswith("/a"):
            assert all(torch.equal(u[key], ups[0][key]) for u in ups), key
            assert not torch.equal(ups[0][key], start[key]), key  # decay
        else:
            assert not torch.equal(ups[0][key], ups[1][key]), key
    assert all(h.divergence_scaled < 1e-6 for h in pt.history)


@pytest.mark.parametrize("args", [
    ["--method", "fedit", "--participation", "0.5", "--weighting",
     "examples"],
    ["--method", "ffa"],
    ["--method", "centralized"],
    ["--dp-clip", "1.0", "--dp-noise", "0.1"],
    ["--method", "fedit", "--dp-clip", "0.5", "--dp-noise", "0.01"],
], ids=["fedit", "ffa", "centralized", "fedex-dp", "fedit-dp"])
def test_launcher_runs_each_baseline_on_cpu(args, capsys):
    base = ["--clients", "3", "--rounds", "2", "--local-steps", "1",
            "--vocab", "32", "--data-vocab", "16"]
    port_train.main(["--device", "cpu", *base, *args])
    out = capsys.readouterr().out
    assert "round=1 " in out and "nan" not in out.split("final:")[1]
    engine = "--method" not in args
    assert f"close backend={'plain' if engine else 'eager'}" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_train.main([*base, *args])
