"""Mesh mode of the port (``repro_torch.launch.mesh_train``) against the JAX
reference's (``repro.launch.mesh_train``).

* the modules under the stacked round: the per-lane clip and the
  lane-stacked adapter branch of ``dense`` against the reference's clip
  and dense under ``vmap``, and the per-lane loss against the port's loss
  on each lane alone;
* the round function against the reference's ``make_mesh_round_fn`` on
  unsharded inputs, unmasked and with step budgets (1, 2, 2, 1), and each
  lane against the port's host ``make_local_step`` run on that lane alone;
* the closer against the reference's ``MeshRoundCloser`` on
  ``tests/test_mesh_round.py``'s synthetic setting: outputs, the deferred
  divergence, the ``weight_vector`` errors, the caller-order contract, and
  a NaN in an unsampled lane;
* the trainer against the reference's ``MeshFederatedTrainer``, round by
  round, in four configurations (50% participation with example weights,
  budgets (1, 2, 2, 1), fedex_svd r' 2, ``nan@1(clients=1)``), their round
  records, counters, span and event names equal (timings and the
  reference's ``compile_*`` left out), and ``obs="trace"`` bitwise
  ``obs="off"``;
* the launcher's ``--mode mesh``, its refusals, and ``--client-local-steps``
  in host mode.

Both sides start from the reference's draws (``repro_torch.bridge``) and the
same numpy-made data. The reference's trainer gets a mesh of Auto axes
through its ``mesh=`` argument: under jax 0.9 the mesh it builds itself
has Explicit axes, on which its round program raises ``ShardingTypeError``.

Tolerances (``tests/test_torch_federated.py``'s): losses and eval loss rtol
1e-5; the §6 divergence rtol 1e-3 and atol 1e-7 (round 0's is ≈ 5e-9 of f32
noise); W0 and the adapters, each leaf's relative Frobenius error ≤ 1e-2
and no element further apart than two AdamW trajectories can separate.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import ClientLoader as JLoader  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.launch import mesh_train as jmesh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.common import dense as jax_dense  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer, make_local_step  # noqa: E402
from repro_torch.data import ClientLoader  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import (MeshFederatedTrainer,  # noqa: E402
                                           MeshRoundCloser,
                                           check_mesh_supported,
                                           make_mesh_round_fn)
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import dense  # noqa: E402
from repro_torch.optim import clip_by_lane_norm, init_adamw  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
VOCAB, SEQ, CLIENTS, ROUNDS, STEPS, BATCH, LR = 16, 16, 4, 2, 2, 4, 1e-2
TRAIN = dict(learning_rate=LR, schedule="constant")
CONFIGS = {
    "examples-50%": dict(participation=0.5, weighting="examples"),
    "budgets": dict(client_local_steps=(1, 2, 2, 1)),
    "fedex_svd": dict(method="fedex_svd", svd_rank=2),
    "faults": dict(faults="nan@1(clients=1)"),
    # the plan's byzantine lane lands over the ceiling: both trainers screen
    # it as "norm" (the reference screens only under a plan)
    "faults+ceiling": dict(faults="scale@1(clients=2,factor=20,rounds=1)",
                           uplink_max_norm=0.5),
}
TIMINGS = {"close_dispatch_us", "close_block_us", "compile_miss"}


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


def _auto_mesh():
    return jax.make_mesh((1, 1), ("client", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@functools.lru_cache(maxsize=None)
def _models():
    """The reference's model (its init jitted) and the port's, and one
    reference draw of params and adapters as numpy."""
    cfg = jax_get_config("paper-tiny")
    jm = jax_build_model(dataclasses.replace(cfg, vocab_size=VOCAB,
                                             dtype="float32"))
    object.__setattr__(jm, "init", jax.jit(jm.init))  # frozen dataclass
    pm = build_model(dataclasses.replace(get_config("paper-tiny"),
                                         vocab_size=VOCAB, dtype="float32"))
    params = _np(jm.init(jax.random.key(0)))
    lora = _np(jax_init_lora(jax.random.key(1), params, jm.cfg,
                             JLoRAConfig()))
    return jm, pm, params, lora


@functools.lru_cache(maxsize=None)
def _jax_round_fn(masked):
    """One compiled reference round per masking, for the round-function
    tests and every reference trainer."""
    return jmesh.make_mesh_round_fn(_models()[0], 2.0, JTrainConfig(**TRAIN),
                                    masked=masked)


def _data():
    """Each client's sequences (``tests/test_mesh_round.py``'s) and one
    eval batch, as numpy."""
    ds = SyntheticLM(vocab=VOCAB, num_tasks=CLIENTS, seed=0)
    seqs = [ds.sample(task=t, num_sequences=12 + 4 * t, seq_len=SEQ, seed=t)
            for t in range(CLIENTS)]
    ev = _np(ds.to_batch(ds.sample(task=0, num_sequences=8, seq_len=SEQ,
                                   seed=100)))
    return seqs, ev


def _assert_leaves_close(ref, port, max_sep):
    rf, pf = jax_flatten(_np(ref)), jax_flatten(_np(port))
    assert list(rf) == list(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


# --------------------------------------------------------------------------
# the modules under the stacked round
# --------------------------------------------------------------------------

def test_lane_clip_matches_reference_under_vmap():
    rng = np.random.default_rng(0)
    grads = {"x": {"a": rng.normal(size=(4, 3, 5)).astype(np.float32)},
             "y": rng.normal(size=(4, 7)).astype(np.float32)}
    grads["y"][2] *= 1e-3  # a lane under the clip keeps its gradient
    want, wnorm = jax.vmap(lambda g: jax_clip(g, 1.0))(grads)
    got, gnorm = clip_by_lane_norm(params_from_numpy(grads, CPU), 1.0)
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(wnorm), rtol=1e-6)
    for k, x in jax_flatten(_np(want)).items():
        np.testing.assert_allclose(flatten_with_paths(got)[k].numpy(), x,
                                   rtol=1e-6, atol=1e-7)


def test_lane_stacked_dense_applies_each_lanes_factors():
    """(C·B, S, m) rows against (C, m, r) / (C, r, n) factors: lane c's rows
    through lane c's factors, as the reference's dense under vmap; the
    branch with no lane axis is bitwise as before."""
    rng = np.random.default_rng(1)
    c, b, s, m, r, n = 3, 2, 5, 8, 2, 6
    x = rng.normal(size=(c * b, s, m)).astype(np.float32)
    p = {"kernel": rng.normal(size=(m, n)).astype(np.float32),
         "bias": rng.normal(size=(n,)).astype(np.float32)}
    lo = {"a": rng.normal(size=(c, m, r)).astype(np.float32),
          "b": rng.normal(size=(c, r, n)).astype(np.float32)}
    want = jax.vmap(lambda xl, ll: jax_dense(xl, p, ll, 0.5))(
        x.reshape(c, b, s, m), lo)
    tx, tp, tl = (params_from_numpy(t, CPU) for t in (x, p, lo))
    got = dense(tx, tp, tl, 0.5)
    np.testing.assert_allclose(got.numpy().reshape(c, b, s, n),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    one = {"a": tl["a"][1], "b": tl["b"][1]}
    plain = tx[b:2 * b] @ tp["kernel"] + 0.5 * (tx[b:2 * b] @ one["a"]
                                               ) @ one["b"] + tp["bias"]
    assert torch.equal(dense(tx[b:2 * b], tp, one, 0.5), plain)


def test_lane_loss_is_each_lanes_mean_loss():
    """One forward over the folded lanes gives each lane's own mean loss:
    the port's ``loss`` on that lane's rows and factors alone (which
    tests/test_torch_model.py holds against the reference's)."""
    _, pm, params, lora = _models()
    rng = np.random.default_rng(2)
    stack = unflatten_from_paths({
        k: rng.normal(size=(CLIENTS,) + v.shape).astype(np.float32) * 0.05
        for k, v in jax_flatten(lora).items()})
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=(CLIENTS * 2,
                                                         SEQ + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams, tstack = (params_from_numpy(t, CPU) for t in (params, stack))
    got = pm.lane_loss(tparams, batch, lora=tstack, lora_scale=2.0)
    assert got.shape == (CLIENTS,)
    for c in range(CLIENTS):
        lane = jax.tree.map(lambda x: x[c], tstack)
        want, _ = pm.loss(tparams, {k: v[2 * c:2 * c + 2]
                                    for k, v in batch.items()},
                          lora=lane, lora_scale=2.0)
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-5)


# --------------------------------------------------------------------------
# the round function
# --------------------------------------------------------------------------

def _round_inputs():
    """Reference params, a lane stack whose lanes differ (b ≠ 0), the
    lanes' (C, steps, B, S) batches from the clients' loaders, and a
    schedule that moves every factor from step 0."""
    jm, pm, params, lora = _models()
    rng = np.random.default_rng(3)
    stack = jax.tree.map(
        lambda x: (x[None] + 0.01 * rng.normal(size=(CLIENTS,) + x.shape)
                   ).astype(np.float32), lora)
    seqs, _ = _data()
    loaders = [JLoader(s, batch_size=BATCH, seed=t)
               for t, s in enumerate(seqs)]
    lanes = [[_np(ld.next_batch()) for _ in range(STEPS)] for ld in loaders]
    batches = {k: np.stack([np.stack([b[k] for b in lane]) for lane in lanes])
               for k in lanes[0][0]}
    return jm, pm, params, stack, batches, [LR, LR / 2]


@pytest.fixture(scope="module")
def round_case():
    jm, pm, params, stack, batches, lrs = _round_inputs()
    out = {}
    for name, budgets in (("unmasked", None), ("budgets", (1, 2, 2, 1))):
        jfn = _jax_round_fn(budgets is not None)
        extra = () if budgets is None else (jnp.asarray(budgets),)
        want = _np(jfn(params, stack, batches, jnp.asarray(lrs), *extra))
        pfn = make_mesh_round_fn(pm, 2.0, TrainConfig(**TRAIN),
                                 masked=budgets is not None)
        extra = () if budgets is None else (budgets,)
        with torch.no_grad():
            tb = {k: torch.from_numpy(v.copy()) for k, v in batches.items()}
        got = pfn(params_from_numpy(params, CPU),
                  params_from_numpy(stack, CPU), tb, lrs, *extra)
        out[name] = (budgets, want, got)
    return pm, params, stack, batches, lrs, out


@pytest.mark.parametrize("name", ["unmasked", "budgets"])
def test_round_fn_matches_reference(round_case, name):
    *_, lrs, out = round_case
    budgets, (want_stack, want_losses), (stack, losses) = out[name]
    assert losses.shape == (CLIENTS, STEPS)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)
    _assert_leaves_close(want_stack, stack, 2 * sum(lrs))
    if budgets:
        # a frozen lane's reported loss repeats its last live loss
        for c, b in enumerate(budgets):
            if b == 1:
                assert losses[c, 1] == losses[c, 0]


@pytest.mark.parametrize("name", ["unmasked", "budgets"])
def test_each_lane_is_the_host_step_on_that_lane_alone(round_case, name):
    pm, params, stack, batches, lrs, out = round_case
    budgets, _, (got_stack, got_losses) = out[name]
    step = make_local_step(pm, 2.0, TrainConfig(**TRAIN))
    tparams = params_from_numpy(params, CPU)
    got = flatten_with_paths(got_stack)
    for c in range(CLIENTS):
        lora = params_from_numpy(jax.tree.map(lambda x: x[c], stack), CPU)
        opt, losses = init_adamw(lora), []
        for t in range(budgets[c] if budgets else STEPS):
            batch = {k: torch.from_numpy(v[c, t].copy())
                     for k, v in batches.items()}
            lora, opt, loss, _ = step(tparams, lora, opt, batch, lrs[t])
            losses.append(float(loss))
        np.testing.assert_allclose(got_losses[c, :len(losses)].numpy(),
                                   losses, rtol=1e-5)
        for k, x in flatten_with_paths(lora).items():
            d = (got[k][c] - x).numpy()
            assert np.linalg.norm(d) <= 1e-2 * np.linalg.norm(x) + 1e-7, k
            assert np.abs(d).max() <= 2 * sum(lrs), k


# --------------------------------------------------------------------------
# the closer (tests/test_mesh_round.py's synthetic setting)
# --------------------------------------------------------------------------

def _setting(c=4, m=24, n=20, r=3, layers=0, seed=0):
    rng = np.random.default_rng(seed)
    lead = (layers,) if layers else ()

    def mk(sh):
        return rng.normal(size=sh).astype(np.float32)

    params = {"blk": {"q_proj": {"kernel": mk(lead + (m, n))},
                      "o_proj": {"kernel": mk(lead + (m, n))}}}
    loras = [{"blk": {p: {"a": mk(lead + (m, r)), "b": mk(lead + (r, n))}
                      for p in ("q_proj", "o_proj")}} for _ in range(c)]
    flats = [jax_flatten(lo) for lo in loras]
    stacks = {p: np.stack([f[p] for f in flats]) for p in flats[0]}
    return params, loras, stacks


def _closers(params, loras, backend="auto", **kw):
    ref = jmesh.MeshRoundCloser(_auto_mesh(), params, loras[0],
                                c_max=len(loras), scale=2.0, **kw)
    port = MeshRoundCloser(params_from_numpy(params, CPU),
                           params_from_numpy(loras[0], CPU),
                           c_max=len(loras), scale=2.0, backend=backend, **kw)
    return ref, port


def _tstacks(stacks):
    return {p: torch.from_numpy(x.copy()) for p, x in stacks.items()}


@pytest.mark.parametrize("case", [
    dict(ids=[0, 2], weights=[0.3, 0.7]),
    dict(ids=[0, 1, 2, 3], weights=None),
    dict(ids=[0, 1], weights=[0.6, 0.4], c=3, layers=2),
    dict(ids=[1, 2, 3], weights=[5.0, 1.0, 2.0], method="fedex_svd",
         svd_rank=2),
    dict(ids=[0, 2], weights=[0.3, 0.7], backend="kernels"),
], ids=["partial-weighted", "full-uniform", "layers", "svd", "kernels-cpu"])
def test_closer_matches_reference(case):
    case = dict(case)
    ids, weights = case.pop("ids"), case.pop("weights")
    setting = {k: case.pop(k) for k in ("c", "layers") if k in case}
    params, loras, stacks = _setting(**setting)
    ref, port = _closers(params, loras, **case)
    jg, jp, jdiv = ref.close(params, stacks, ids, weights, round_id=0)
    pg, pp, pdiv = port.close(params_from_numpy(params, CPU),
                              _tstacks(stacks), ids, weights, round_id=0)
    assert not pdiv.resolved  # no host sync inside the close
    for want, got in ((jg, pg), (jp, pp)):
        for k, x in jax_flatten(_np(want)).items():
            np.testing.assert_allclose(flatten_with_paths(got)[k].numpy(), x,
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(pdiv.resolve(), jdiv.resolve(), rtol=1e-3,
                               atol=1e-7)
    assert pdiv.resolved and float(pdiv) == pdiv.resolve()


@pytest.mark.parametrize("ids,match", [([], "no participants"),
                                       ([5], "outside"),
                                       ([1, 1], "duplicate")])
def test_closer_rejects_bad_ids(ids, match):
    params, loras, stacks = _setting(c=3)
    ref, port = _closers(params, loras)
    for closer in (ref, port):
        with pytest.raises(ValueError, match=match):
            closer.weight_vector(ids)
    with pytest.raises(ValueError, match="mesh mode closes"):
        _closers(params, loras, method="keep_local")


def test_closer_weights_follow_the_callers_order():
    params, loras, stacks = _setting()
    ref, port = _closers(params, loras)
    for closer in (ref, port):
        w_unsorted, _ = closer.weight_vector([2, 0], [0.7, 0.3])
        w_sorted, _ = closer.weight_vector([0, 2], [0.3, 0.7])
        np.testing.assert_array_equal(w_unsorted, w_sorted)
        assert w_unsorted[2] == pytest.approx(0.7)
    np.testing.assert_array_equal(port.weight_vector([3, 1], [2.0, 1.0])[0],
                                  ref.weight_vector([3, 1], [2.0, 1.0])[0])
    a = port.close(params_from_numpy(params, CPU), _tstacks(stacks), [2, 0],
                   [0.7, 0.3])
    b = port.close(params_from_numpy(params, CPU), _tstacks(stacks), [0, 2],
                   [0.3, 0.7])
    for x, y in ((a[0], b[0]), (a[1], b[1])):
        fx, fy = flatten_with_paths(x), flatten_with_paths(y)
        assert all(torch.equal(fx[k], fy[k]) for k in fx)


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_nan_in_an_unsampled_lane_never_reaches_the_close(backend):
    params, loras, stacks = _setting()
    _, port = _closers(params, loras, backend=backend)
    clean = port.close(params_from_numpy(params, CPU), _tstacks(stacks),
                       [1, 3], [0.5, 0.5])
    poisoned = _tstacks(stacks)
    for x in poisoned.values():
        x[0] = float("nan")
        x[2, ..., 0] = float("inf")
    got = port.close(params_from_numpy(params, CPU), poisoned, [1, 3],
                     [0.5, 0.5])
    for x, y in ((clean[0], got[0]), (clean[1], got[1])):
        fx, fy = flatten_with_paths(x), flatten_with_paths(y)
        assert all(torch.equal(fx[k], fy[k]) for k in fx)
    assert got[2].resolve() == clean[2].resolve()


# --------------------------------------------------------------------------
# the trainer, end to end
# --------------------------------------------------------------------------

def _capture(trainer, sink, convert):
    """Wrap ``trainer.closer.close``: every close's global adapter and
    params go into ``sink`` as numpy."""
    close = trainer.closer.close

    def wrapped(*args, **kw):
        out = close(*args, **kw)
        sink.append((convert(out[0]), convert(out[1])))
        return out

    trainer.closer.close = wrapped


def _port_trainer(pm, name, start, obs="trace", seqs=None, ev=None, **kw):
    pl = [ClientLoader(s, batch_size=BATCH, seed=t, device=CPU)
          for t, s in enumerate(seqs)]
    return MeshFederatedTrainer(
        model=pm, lora_cfg=LoRAConfig(rank=4, alpha=8),
        fed_cfg=FedConfig(num_clients=CLIENTS, rounds=ROUNDS,
                          local_steps=STEPS, obs=obs,
                          **{**CONFIGS[name], **kw}),
        train_cfg=TrainConfig(**TRAIN), client_loaders=pl,
        eval_batches=[{k: torch.from_numpy(v.copy()) for k, v in ev.items()}],
        seed=0, device=CPU, params=params_from_numpy(start[0], CPU),
        global_lora=params_from_numpy(start[1], CPU))


@pytest.fixture(scope="module")
def runs():
    """name → (reference trainer, its per-close states, port trainer, its
    per-close states, start draws), both run under obs trace. The reference
    trainers share one compiled round (per masking), eval and close (per
    method). Pins torch to one thread itself (module scope)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jm, pm, *_ = _models()
    seqs, ev = _data()
    shared, out = {}, {}
    try:
        for name, kw in CONFIGS.items():
            jt = jmesh.MeshFederatedTrainer(
                model=jm, lora_cfg=JLoRAConfig(rank=4, alpha=8),
                fed_cfg=JFedConfig(num_clients=CLIENTS, rounds=ROUNDS,
                                   local_steps=STEPS, obs="trace", **kw),
                train_cfg=JTrainConfig(**TRAIN),
                client_loaders=[JLoader(s, batch_size=BATCH, seed=t)
                                for t, s in enumerate(seqs)],
                eval_batches=[ev], seed=0, mesh=_auto_mesh())
            jt.round_fn = _jax_round_fn("client_local_steps" in kw)
            keys = ("eval",), ("close", jt.closer.method)
            fns = (jt, "eval_fn"), (jt.closer, "_close")
            for key, (obj, attr) in zip(keys, fns):
                if key in shared:
                    setattr(obj, attr, shared[key])
                else:
                    shared[key] = getattr(obj, attr)
            start = (_np(jt.params), _np(jt.global_lora))
            jstates, pstates = [], []
            _capture(jt, jstates, _np)
            jt.run()
            pt = _port_trainer(pm, name, start, seqs=seqs, ev=ev)
            _capture(pt, pstates, to_numpy)
            pt.run()
            out[name] = (jt, jstates, pt, pstates, start)
    finally:
        torch.set_num_threads(n)
    return out


def _quarantined(jt):
    """The reference's (client, reason) pairs per round, from its events."""
    per = [[] for _ in range(ROUNDS)]
    for e in jt.recorder.tracer.events:
        if e["name"] == "uplink.quarantine":
            a = e["args"]
            per[a["round"]].append((a["client"], a["reason"]))
    return per


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trainer_matches_reference_round_by_round(runs, name):
    jt, jstates, pt, pstates, _ = runs[name]
    assert len(jt.history) == len(pt.history) == ROUNDS
    assert len(jstates) == len(pstates) == ROUNDS
    max_sep = 2 * LR * STEPS * CLIENTS
    for jr, pr, js, ps in zip(jt.history, pt.history, jstates, pstates):
        np.testing.assert_allclose(pr.client_losses, jr.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(pr.eval_loss, jr.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(pr.eval_acc, jr.eval_acc, rtol=1e-5)
        np.testing.assert_allclose(pr.divergence_scaled, jr.divergence_scaled,
                                   rtol=1e-3, atol=1e-7)
        assert pr.lr == pytest.approx(jr.lr)
        for want, got in zip(js, ps):
            _assert_leaves_close(want, got, max_sep)
    assert pt.quarantined == _quarantined(jt)
    if name == "faults":
        assert pt.quarantined == [[(1, "nonfinite")]] * ROUNDS
    if name == "faults+ceiling":
        assert pt.quarantined == [[], [(2, "norm")]]
    if name == "examples-50%":
        assert all(len(r.client_losses) == 2 for r in pt.history)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_round_records_and_counters_match_reference(runs, name):
    jt, _, pt, _, _ = runs[name]
    jrec, prec = jt.recorder, pt.recorder
    jrecs, precs = jrec.round_records(), prec.round_records()
    assert len(jrecs) == len(precs) == ROUNDS
    for jr, pr in zip(jrecs, precs):
        keys = set(jr) - TIMINGS
        assert set(pr) - TIMINGS == keys, sorted(keys ^ set(pr))
        for k in sorted(keys):
            if k in ("divergence", "eval_loss", "eval_acc"):
                np.testing.assert_allclose(pr[k], jr[k], rtol=1e-3 if
                                           k == "divergence" else 1e-5,
                                           atol=1e-7, err_msg=k)
            else:
                assert pr[k] == jr[k], (jr["round"], k, pr[k], jr[k])
        assert "close_dispatch_us" in pr and "close_block_us" in pr
    js, ps = jrec.metrics.snapshot(), prec.metrics.snapshot()
    assert ps["counters"] == {k: v for k, v in js["counters"].items()
                              if ".compile" not in k}
    assert ({k: h["count"] for k, h in ps["histograms"].items()}
            == {k: h["count"] for k, h in js["histograms"].items()})
    for attr in ("spans", "events"):
        assert ({s["name"] for s in getattr(prec.tracer, attr)}
                == {s["name"] for s in getattr(jrec.tracer, attr)
                    if ".compile" not in s["name"]})
    assert {"mesh.train_round", "round.close", "round.eval",
            "close.dispatch"} <= {s["name"] for s in prec.tracer.spans}
    closes = [s for s in prec.tracer.spans if s["name"] == "close.dispatch"]
    assert all(s["args"]["mesh"] for s in closes)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_is_bitwise_obs_off(runs, name):
    _, _, traced, _, start = runs[name]
    seqs, ev = _data()
    off = _port_trainer(traced.model, name, start, obs="off", seqs=seqs,
                        ev=ev)
    off.run()
    for a, b in ((traced.params, off.params),
                 (traced.global_lora, off.global_lora)):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert ([dataclasses.astuple(r) for r in traced.history]
            == [dataclasses.astuple(r) for r in off.history])
    assert off.recorder.round_records() == []


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--arch", "paper-tiny", "--clients", "4",
          "--rounds", "2", "--local-steps", "2", "--vocab", "32",
          "--seq-len", "16", "--batch-size", "4"]


def _history(path):
    return [(h["round"], h["client_losses"], h["eval_loss"],
             h["divergence_scaled"]) for h in json.loads(path.read_text())]


def _class_history(trainer_cls, **fed_kw):
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=32,
                              dtype="float32")
    loaders, evals = build_federated_data(32, 4, seq_len=16, batch_size=4,
                                          device=CPU)
    tr = trainer_cls(model=build_model(cfg), lora_cfg=LoRAConfig(),
                     fed_cfg=FedConfig(num_clients=4, rounds=2,
                                       local_steps=2, **fed_kw),
                     train_cfg=TrainConfig(learning_rate=5e-3,
                                           schedule="constant",
                                           total_steps=4),
                     client_loaders=loaders, eval_batches=evals, seed=0,
                     device=CPU)
    return [(h.round, h.client_losses, h.eval_loss, h.divergence_scaled)
            for h in tr.run()]


def test_launcher_mesh_mode_equals_the_class(tmp_path, capsys):
    out = tmp_path / "history.json"
    port_train.main(LAUNCH + ["--mode", "mesh", "--participation", "0.5",
                              "--weighting", "examples", "--out", str(out)])
    text = capsys.readouterr().out
    assert "final: method=fedex" in text and "mode=mesh" in text
    assert "close backend=plain" in text
    assert _history(out) == _class_history(
        MeshFederatedTrainer, participation=0.5, weighting="examples")


def test_launcher_mesh_prints_each_rounds_quarantine(tmp_path, capsys):
    port_train.main(LAUNCH + ["--mode", "mesh", "--faults",
                              "nan@1(clients=2,rounds=1)"])
    text = capsys.readouterr().out
    assert "round=1 quarantined (client, reason): [(2, 'nonfinite')]" in text
    assert "round=0 quarantined" not in text


@pytest.mark.parametrize("flags,named", [
    (["--method", "fedit"], "fedit"),
    (["--method", "ffa"], "ffa"),
    (["--method", "hetero"], "hetero"),
    (["--method", "centralized"], "centralized"),
    (["--assignment", "keep_local"], "assignment"),
    (["--stragglers", "0.1"], "straggler_prob"),
    (["--dropout-prob", "0.1"], "dropout_prob"),
    (["--deadline", "1.0"], "round_deadline"),
    (["--min-quorum", "2"], "min_quorum"),
    (["--async-buffer", "2"], "async_buffer"),
    (["--quantize-uplink", "int8"], "quantize_uplink"),
    (["--dp-clip", "1.0", "--dp-noise", "0.1"], "dp_clip"),
    (["--client-ranks", "4,2,1,3"], "client_ranks"),
    (["--engine", "plain"], "engine"),
    (["--ring-depth", "3"], "ring_depth"),
    (["--close-chunk", "2"], "close_chunk"),
    (["--no-uplink-validation"], "uplink_validation"),
    (["--uplink-retries", "3"], "uplink_retries"),
    (["--checkpoint-dir", "ck"], "checkpoint_dir"),
    (["--checkpoint-every", "2"], "checkpoint_every"),
    (["--checkpoint-dir", "ck", "--resume"], "resume"),
    (["--faults", "crash@1"], "crash"),
    (["--faults", "nan@1;truncate@1(clients=2)"], "truncate"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_launcher_mesh_refuses_what_it_cannot_honour(flags, named, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=named):
        port_train.main(LAUNCH + ["--mode", "mesh"] + flags)
    assert not (tmp_path / "ck").exists()


def test_value_faults_and_a_norm_ceiling_are_accepted():
    check_mesh_supported(FedConfig(num_clients=4, faults=(
        "nan@1(clients=1);inf@0.5;scale@1(clients=2,factor=10)"),
        uplink_max_norm=1.0, participation=0.5, weighting="examples"))


def test_a_norm_ceiling_without_a_fault_plan_is_refused(tmp_path):
    """The reference's mesh trainer screens lanes only under a fault plan,
    so a ceiling alone would close over a lane the port quarantines: the
    port refuses it, through the class and through the launcher."""
    with pytest.raises(ValueError, match="uplink_max_norm"):
        check_mesh_supported(FedConfig(num_clients=4, uplink_max_norm=1.0))
    _, pm, params, lora = _models()
    seqs, ev = _data()
    with pytest.raises(ValueError, match="uplink_max_norm"):
        _port_trainer(pm, "faults+ceiling", (params, lora), seqs=seqs,
                      ev=ev, faults="")
    with pytest.raises(ValueError, match="uplink_max_norm"):
        port_train.main(LAUNCH + ["--mode", "mesh", "--uplink-max-norm",
                                  "1", "--out", str(tmp_path / "h.json")])
    assert not (tmp_path / "h.json").exists()


def test_client_local_steps_flag_in_host_mode(tmp_path):
    out = tmp_path / "history.json"
    port_train.main(LAUNCH + ["--client-local-steps", "1,2,2,1", "--out",
                              str(out)])
    assert _history(out) == _class_history(
        FederatedTrainer, client_local_steps=(1, 2, 2, 1))
    assert _history(out) != _class_history(FederatedTrainer)
