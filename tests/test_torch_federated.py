"""The port's federated trainer against the JAX reference's, round by round,
at the README quickstart shape (paper-tiny, vocab 64, 3 clients, 3 local
steps), uniform and with example weighting at 50% participation; plus the
port's guards (no JAX import, no silent CPU fallback, no silently ignored
config).

Both trainers start from the reference's draws (carried across with
``repro_torch.bridge``) and the same numpy-made data.

Tolerances, per round: eval loss rtol 1e-5 and the §6 divergence rtol 1e-3
(a difference of cancelling Gram sums). W0 and the global adapters: each
leaf's relative Frobenius error ≤ 1e-2, and no element further apart than
two AdamW trajectories can separate (lr per step and client, both ways).
The elementwise bound is this loose for a reason found while porting:
AdamW normalises every element's step, so an entry whose gradient nearly
cancels moves by up to lr on f32 noise of the other entries (traced to
~1e-3 on a few dozen of 2048 entries in the weighted run, with gradients
agreeing to 1e-9); the Frobenius bound holds the bulk.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.data import ClientLoader  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.device import resolve_device  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 3, 2, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fed(**fed_kw):
    return dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS, **fed_kw)


def _port_trainer(params=None, global_lora=None, **fed_kw):
    """The port's trainer on the CPU; without ``params`` / ``global_lora``
    it makes its own draws."""
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=VOCAB,
                              dtype="float32")
    pl, pe = build_federated_data(VOCAB, CLIENTS, seed=0, device=CPU)
    return FederatedTrainer(model=build_model(cfg), lora_cfg=LoRAConfig(),
                            fed_cfg=FedConfig(**_fed(**fed_kw)),
                            train_cfg=TrainConfig(**TRAIN), client_loaders=pl,
                            eval_batches=pe, seed=0, device=CPU,
                            params=params, global_lora=global_lora)


def _trainers(**fed_kw):
    """The reference's trainer and the port's, from the reference's draws."""
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=VOCAB,
                               dtype="float32")
    jl, je = jax_data(VOCAB, CLIENTS, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="pallas", **_fed(**fed_kw)),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je, seed=0)
    p0 = jax.tree.map(np.asarray, jt.params)
    l0 = jax.tree.map(np.asarray, jt.global_lora)
    pt = _port_trainer(params_from_numpy(p0, CPU),
                       params_from_numpy(l0, CPU), **fed_kw)
    return jt, pt


def _assert_trees_close(ref, port):
    rf = jax_flatten(jax.tree.map(np.asarray, ref))
    pf = flatten_with_paths(to_numpy(port))
    assert list(rf) == list(pf)
    max_sep = 2 * LR * STEPS * CLIENTS
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


@pytest.mark.parametrize("fed_kw", [
    {},
    {"weighting": "examples", "participation": 0.5},
], ids=["uniform", "examples-50%"])
def test_trainer_matches_reference_round_by_round(fed_kw):
    jt, pt = _trainers(**fed_kw)
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
        assert pt.outcomes[-1].weights == jt.outcomes[-1].weights
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3)
        assert prec.lr == pytest.approx(jrec.lr)
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
    # the partial rounds really sampled half the clients
    if fed_kw:
        assert all(len(o.client_ids) == 2 for o in pt.outcomes)


def test_nonfinite_uplink_is_quarantined():
    pt = _port_trainer()
    step = pt.local_step

    def poisoned(params, lora, opt_state, batch, lr):
        lora, opt_state, loss, gnorm = step(params, lora, opt_state, batch, lr)
        if pt._poison:
            lora["layers"]["attn"]["q_proj"]["a"][0, 0, 0] = float("nan")
        return lora, opt_state, loss, gnorm

    pt._poison = False
    pt.local_step = poisoned
    orig = pt._client_round

    def client_round(client, params, lora):
        pt._poison = client == 1
        return orig(client, params, lora)

    pt._client_round = client_round
    rec = pt.run(until=1)[0]
    out = pt.outcomes[0]
    assert out.quarantined == [(1, "nonfinite")] and out.client_ids == [0, 2]
    assert np.isfinite(rec.eval_loss) and np.isfinite(rec.divergence_scaled)
    assert all(bool(torch.isfinite(x).all())
               for x in flatten_with_paths(pt.global_lora).values())


def _tiny(fed_kw):
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=32,
                              num_layers=1, dtype="float32")
    loaders, _ = build_federated_data(32, 2, seqs_per_task=8, device=CPU)
    return FederatedTrainer(model=build_model(cfg), lora_cfg=LoRAConfig(),
                            fed_cfg=FedConfig(num_clients=2, **fed_kw),
                            train_cfg=TrainConfig(), client_loaders=loaders,
                            device=CPU)


# the coordinator's settings, each ignored by the reference under hetero and
# centralized (neither runs a round through its coordinator)
COORDINATED = [{"participation": 0.5}, {"min_quorum": 1},
               {"round_deadline": 1.0}, {"dropout_prob": 0.1},
               {"async_buffer": 2}, {"quantize_uplink": "int8"},
               {"uplink_max_norm": 1.0}]


@pytest.mark.parametrize("fed_kw,error", [
    ({"method": "centralized", "faults": "nan@0.5"}, ValueError),
    ({"method": "hetero", "engine": "off", "faults": "nan@0.5"}, ValueError),
    ({"method": "hetero", "dp_clip": 1.0}, ValueError),
    ({"method": "centralized", "dp_clip": 1.0}, ValueError),
    ({"dp_noise_multiplier": 0.1, "dp_clip": 0.0}, ValueError),
    *(({"method": m, **kw}, ValueError)
      for m in ("hetero", "centralized") for kw in COORDINATED),
    ({"client_ranks": (4, 2), "round_deadline": 1.0}, ValueError),
], ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items())
    if isinstance(x, dict) else x.__name__)
def test_unported_federation_features_raise(fed_kw, error):
    """A feature not ported yet raises ``NotImplementedError``; a setting
    the run would ignore (DP under a method whose uploads are never
    privatized, DP noise without a clip, a coordinator setting under hetero
    or centralized, a fault plan where no upload crosses the uplink path)
    raises ``ValueError`` naming it."""
    names = [k for k in fed_kw if k not in ("method", "client_ranks")]
    with pytest.raises(error, match="|".join(names)):
        _tiny(fed_kw)


@pytest.mark.parametrize("fed_kw", [
    {"round_deadline": 1.0}, {"dropout_prob": 0.1}, {"async_buffer": 2},
    {"quantize_uplink": "int8"}, {"uplink_max_norm": 1.0},
    {"faults": "crash@1(clients=1)"}, {"checkpoint_dir": "ckpt"},
], ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items()))
def test_ported_federation_features_run(fed_kw, tmp_path):
    """The coordinator's policies, FedBuff, the uplink transport, fault
    injection and round-state checkpoints, which earlier slices refused,
    train a round and ledger the uplinks that were delivered."""
    ckpt = str(tmp_path / "ckpt")
    if "checkpoint_dir" in fed_kw:
        fed_kw = {**fed_kw, "checkpoint_dir": ckpt}
    pt = _tiny(fed_kw)
    rec = pt.run(until=1)[0]
    assert os.path.exists(ckpt) == ("checkpoint_dir" in fed_kw)
    assert np.isfinite(rec.eval_loss) or not pt.eval_batches
    out = pt.outcomes[0]
    ups = pt.ledger.round_totals(0)["uplink_params"]
    assert ups == len(out.client_ids) * sum(
        x.numel() for x in flatten_with_paths(pt.global_lora).values())


@pytest.mark.parametrize("fed_kw", [
    {"engine": "off", "close_chunk": 2},
    {"engine": "off", "ring_depth": 3},
    {"method": "fedit", "close_chunk": 2},
    {"method": "ffa", "ring_depth": 1},
    {"method": "centralized", "close_chunk": 1},
    {"method": "hetero", "engine": "off", "close_chunk": 2},
], ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items()))
def test_settings_only_the_engine_uses_raise_without_one(fed_kw):
    key = "close_chunk" if "close_chunk" in fed_kw else "ring_depth"
    with pytest.raises(ValueError, match=key):
        _tiny(fed_kw)


@pytest.mark.parametrize("fed_kw", [
    {"method": "fedit"}, {"method": "ffa"}, {"method": "centralized"},
    {"engine": "off"}, {"dp_clip": 1.0, "dp_noise_multiplier": 0.1},
    {"method": "fedit", "dp_clip": 1.0},
    {"engine": "off", "assignment": "keep_local", "dp_clip": 0.5},
], ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items()))
def test_baselines_dp_and_the_eager_close_are_accepted(fed_kw):
    pt = _tiny(fed_kw)
    eager = fed_kw.get("engine") == "off" or "method" in fed_kw
    assert (pt.engine is None) == eager
    assert (pt.coordinator.sink is None) == eager


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_federated_data(32, 2, seqs_per_task=8)
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=32,
                              num_layers=1, dtype="float32")
    loaders, _ = build_federated_data(32, 2, seqs_per_task=8, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedTrainer(model=build_model(cfg), lora_cfg=LoRAConfig(),
                         fed_cfg=FedConfig(num_clients=2),
                         train_cfg=TrainConfig(), client_loaders=loaders)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(["--clients", "2", "--rounds", "1"])


def test_client_loader_needs_cuda_unless_asked():
    seqs = np.zeros((4, 9), np.int32)
    assert ClientLoader(seqs, 2, device="cpu").next_batch()[
        "tokens"].device == CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClientLoader(seqs, 2)


def test_launcher_runs_on_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "history.json"
    port_train.main(["--device", "cpu", "--clients", "4", "--rounds", "2",
                     "--local-steps", "1", "--vocab", "32",
                     "--data-vocab", "16", "--weighting", "examples",
                     "--participation", "0.5", "--out", str(out)])
    hist = json.loads(out.read_text())
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["eval_loss"]) for h in hist)
    assert "close backend=plain" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30  # every module was imported
    smoke = subprocess.run(
        [sys.executable, "-c",
         "import ast, sys; t = ast.parse(open(sys.argv[1]).read());"
         "names = [a.name for n in ast.walk(t) if isinstance(n, ast.Import)"
         " for a in n.names] + [n.module or '' for n in ast.walk(t)"
         " if isinstance(n, ast.ImportFrom)];"
         "bad = [n for n in names if n.split('.')[0] in ('jax', 'repro')];"
         "assert not bad, bad", str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=60)
    assert smoke.returncode == 0, smoke.stderr
