"""The port's coordinator policies against the JAX reference's: the ring's
deadline eviction and drop contract, the synchronous coordinator's
dropout / deadline / quorum cut, FedBuff's asynchronous commits, and the
trainer under both, round by round.

Coordinators run side by side on the same registry and straggler model,
with a toy ``train_fn`` whose adapters come from numpy: outcomes (ids,
order, dropouts, deadline drops, staleness, weights, clock, ledger entries)
must be equal field by field, exactly, and the delivered adapters bitwise.
Under FedBuff the toy client returns its start (the launch snapshot) plus
its own delta, and the global moves after every commit, so a client trained
from the wrong version shows.

Trainers: paper-tiny, vocab 64, 4 clients, 3 local steps, the reference's
draws carried across with ``repro_torch.bridge``. Delivered, dropped-out,
deadline-dropped and quarantined ids, staleness, weights and ledger entries
must be equal exactly. Tolerances as ``tests/test_torch_federated.py``
states them for weighted rounds: eval and client losses rtol 1e-5, the §6
divergence rtol 1e-3; W0 and the global adapters by each leaf's relative
Frobenius error ≤ 1e-2 plus the AdamW separation bound (2·lr·steps·clients
elementwise). The port's ring allocates its lanes filled with NaN here
(``_nan_lanes``): a lane that was opened and never written (a deadline
cut, a quarantine) must never be read.
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
from repro.fedsrv import AsyncBufferCoordinator as JAsync  # noqa: E402
from repro.fedsrv import ClientInfo as JClientInfo  # noqa: E402
from repro.fedsrv import ClientRegistry as JRegistry  # noqa: E402
from repro.fedsrv import RoundCoordinator as JCoordinator  # noqa: E402
from repro.fedsrv import RoundPolicy as JPolicy  # noqa: E402
from repro.fedsrv import StragglerModel as JStragglers  # noqa: E402
from repro.fedsrv.transport import \
    TransientTransportError as JTransient  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.engine import RoundBuffers  # noqa: E402
from repro_torch.fedsrv import (AdapterCodec, AsyncBufferCoordinator,  # noqa
                                ClientInfo, ClientRegistry, RoundCoordinator,
                                RoundPolicy, SimClock, StaleUplinkError,
                                StragglerModel, TransientTransportError)
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 4, 3, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)
# seed 0's draws: one dropout and one deadline drop in every round
DEADLINE = dict(round_deadline=1.0, min_quorum=2, dropout_prob=0.25,
                straggler_prob=0.25, weighting="examples")
FEDBUFF = dict(async_buffer=2, staleness_alpha=0.5, weighting="examples")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _nan_lanes(monkeypatch):
    """The ring's fresh stacks (and chunks) hold NaN instead of zeros."""
    def alloc(self, lanes):
        return {p: torch.full((lanes,) + s, float("nan"),
                              device=self.device)
                for p, s in self._shapes.items()}

    monkeypatch.setattr(RoundBuffers, "_alloc", alloc)


# --------------------------------------------------------------------------
# the ring: depth, deadline eviction, stale / replayed / duplicate writes
# --------------------------------------------------------------------------

def _template(m=6, r=2, n=4):
    return {"blk": {"q_proj": {"a": torch.zeros(m, r),
                               "b": torch.zeros(r, n)}}}


def _lora(val, m=6, r=2, n=4):
    return {"blk": {"q_proj": {"a": torch.full((m, r), float(val)),
                               "b": torch.full((r, n), float(val))}}}


def _a0(stacks):
    return float(stacks["blk/q_proj/a"][0, 0, 0])


def test_ring_depth3_rotation_fifo():
    """Three rounds' writes interleave into distinct sets; take() pops the
    oldest first and hands each round its own deliveries."""
    bufs = RoundBuffers(_template(), c_max=2, depth=3)
    for rnd in range(3):
        bufs.begin_round({0: 0, 1: 1}, round_id=rnd)
    for rnd in (2, 0, 1):
        assert bufs.write(0, _lora(10 * rnd + 1), round_id=rnd)
        assert bufs.write(1, _lora(10 * rnd + 2), round_id=rnd)
    assert bufs.open_rounds == [0, 1, 2]
    for rnd in range(3):
        assert _a0(bufs.take()) == 10 * rnd + 1
    assert bufs.open_rounds == []


def test_ring_exhaustion_without_deadlines_raises():
    bufs = RoundBuffers(_template(), c_max=1, depth=3)
    for rnd in range(3):
        bufs.begin_round({0: 0}, round_id=rnd)
    with pytest.raises(RuntimeError, match="in flight"):
        bufs.begin_round({0: 0}, round_id=3)
    # even with `now`, rounds without a deadline are never evicted
    with pytest.raises(RuntimeError, match="in flight"):
        bufs.begin_round({0: 0}, round_id=3, now=1e9)
    deep = RoundBuffers(_template(), c_max=1, depth=5)
    for rnd in range(5):
        deep.begin_round({0: 0}, round_id=rnd)
    assert len(deep.open_rounds) == 5


def test_full_ring_evicts_expired_round():
    bufs = RoundBuffers(_template(), c_max=1, depth=2)
    bufs.begin_round({0: 0}, round_id="r0", deadline=5.0)
    bufs.begin_round({0: 0}, round_id="r1", deadline=50.0)
    bufs.write(0, _lora(1), round_id="r1")
    bufs.begin_round({0: 0}, round_id="r2", deadline=60.0, now=6.0)
    assert bufs.open_rounds == ["r1", "r2"] and bufs.evictions == 1
    assert _a0(bufs.take()) == 1.0
    # rounds whose deadline has not passed survive a full ring
    bufs.begin_round({0: 0}, round_id="r3", deadline=100.0)
    with pytest.raises(RuntimeError, match="in flight"):
        bufs.begin_round({0: 0}, round_id="r4", now=6.0)


def test_stale_replayed_and_duplicate_writes_are_dropped():
    """A write for an evicted round, for a closed round, or a second write
    of a lane returns False, writes nothing and is counted; an id the ring
    never saw still raises."""
    bufs = RoundBuffers(_template(), c_max=2, depth=2)
    bufs.begin_round({0: 0, 1: 1}, round_id="v0", deadline=1)
    bufs.begin_round({0: 0, 1: 1}, round_id="v1", deadline=3)
    bufs.begin_round({0: 0, 1: 1}, round_id="v2", deadline=4, now=2)
    assert "v0" not in bufs.open_rounds
    assert bufs.write(0, _lora(7), round_id="v0") is False
    assert bufs.write(0, _lora(8), round_id="v1") is True
    assert bufs.write(0, _lora(9), round_id="v1") is False  # duplicate
    stacks = bufs.take("v1")
    assert _a0(stacks) == 8.0
    assert bufs.write(1, _lora(5), round_id="v1") is False  # replayed
    assert (bufs.stale_drops, bufs.replay_drops,
            bufs.duplicate_drops) == (1, 1, 1)
    with pytest.raises(KeyError):
        bufs.write(0, _lora(9), round_id="never-opened")
    # an unrouted write goes to the oldest open round with a lane for it
    assert bufs.write(1, _lora(4)) is True
    assert bufs.delivered_in("v2") == {1: 1}
    # reopening a remembered id makes a fresh round
    bufs.begin_round({0: 0}, round_id="v1", now=0)
    assert bufs.write(0, _lora(6), round_id="v1") is True


def test_explicit_evict_and_bounded_memory():
    bufs = RoundBuffers(_template(), c_max=2, depth=2)
    bufs.begin_round({0: 0, 1: 1}, round_id="r0")
    bufs.write(1, _lora(3), round_id="r0")
    assert bufs.evict("r0") == {1: 1}
    with pytest.raises(RuntimeError, match="no open round"):
        bufs.take()
    for close in ("evict", "take"):
        one = RoundBuffers(_template(), c_max=1, depth=1)
        for i in range(80):
            one.begin_round({0: 0}, round_id=i)
            getattr(one, close)(i)
        assert len(one._evicted) + len(one._closed) == 64
        one.begin_round({0: 0}, round_id="open")
        assert one.write(0, _lora(1), round_id=79) is False  # remembered
        with pytest.raises(KeyError):
            one.write(0, _lora(1), round_id=1)               # forgotten


def test_decode_into_refuses_stale_and_unroutable_payloads():
    codec = AdapterCodec("int8")
    bufs = RoundBuffers(_template(), c_max=1, depth=1)
    bufs.begin_round({0: 0}, round_id=0, deadline=1.0)
    bufs.begin_round({0: 0}, round_id=1, now=2.0)  # evicts round 0
    late = codec.encode(_lora(1), round_id=0, client_id=0)
    with pytest.raises(StaleUplinkError) as e:
        codec.decode_into(late, bufs)
    assert e.value.reason == "stale"
    lost = codec.encode(_lora(1), round_id=9, client_id=0)
    with pytest.raises(StaleUplinkError) as e:
        codec.decode_into(lost, bufs)
    assert e.value.reason == "unroutable"


# --------------------------------------------------------------------------
# the coordinators, side by side with the reference's
# --------------------------------------------------------------------------

def _clients(ns):
    return ([JClientInfo(i, n) for i, n in enumerate(ns)],
            [ClientInfo(i, n) for i, n in enumerate(ns)])


def _numpy_loras(k, m=16, r=2, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return {i: {"q_proj": {"a": rng.normal(size=(m, r)).astype(np.float32),
                           "b": rng.normal(size=(r, n)).astype(np.float32)}}
            for i in range(k)}


def _pair(ns, policy=None, stragglers=None, *, async_kw=None, seed=0):
    """The reference's coordinator and the port's over the same registry,
    policy and straggler model."""
    jc, pc = _clients(ns)
    policy, stragglers = policy or {}, stragglers or {}
    jargs = (JRegistry(jc, seed=seed), JPolicy(**policy),
             JStragglers(**stragglers))
    pargs = (ClientRegistry(pc, seed=seed), RoundPolicy(**policy),
             StragglerModel(**stragglers))
    if async_kw is not None:
        return JAsync(*jargs, **async_kw), AsyncBufferCoordinator(
            *pargs, **async_kw)
    return JCoordinator(*jargs), RoundCoordinator(*pargs)


def _assert_same_outcome(jo, po):
    for f in ("round_id", "sampled", "dropped_out", "dropped_deadline",
              "weights", "opened_at", "closed_at", "comm", "quarantined",
              "degraded", "retries"):
        assert getattr(po, f) == getattr(jo, f), f
    assert ([(d.client.client_id, d.launched_at, d.arrived_at, d.staleness)
             for d in po.delivered]
            == [(d.client.client_id, d.launched_at, d.arrived_at, d.staleness)
                for d in jo.delivered])
    for dj, dp in zip(jo.delivered, po.delivered):
        want = jax_flatten(jax.tree.map(np.asarray, dj.lora))
        got = flatten_with_paths(to_numpy(dp.lora))
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _same_ledgers(jcoord, pcoord):
    return ([dataclasses.astuple(e) for e in pcoord.ledger.entries]
            == [dataclasses.astuple(e) for e in jcoord.ledger.entries])


def _run_sync(jcoord, pcoord, loras, rounds=1):
    outs = []
    jl = {i: jax.tree.map(jnp.asarray, t) for i, t in loras.items()}
    pl = {i: params_from_numpy(t, CPU) for i, t in loras.items()}
    for rnd in range(rounds):
        jo = jcoord.run_round(rnd, lambda c, g, r: jl[c.client_id], jl[0])
        po = pcoord.run_round(rnd, lambda c, g, r: pl[c.client_id], pl[0])
        _assert_same_outcome(jo, po)
        outs.append(po)
    assert _same_ledgers(jcoord, pcoord)
    return outs


@pytest.mark.parametrize("case", [
    "trivial", "deadline-quorum", "deadline-alone", "deadline-on-time",
    "dropout", "clock", "weighted-partial"])
def test_sync_coordinator_matches_reference(case):
    """Counterparts of tests/test_fedsrv.py::TestRoundCoordinator, each
    outcome held to the reference's field by field."""
    rng = np.random.default_rng(0)
    varied = [int(rng.integers(50, 500)) for _ in range(8)]
    ns, policy, strag, rounds, seed = {
        "trivial": (varied[:5], {}, {}, 1, 0),
        "deadline-quorum": ([100] * 4, {"deadline": 0.5, "min_quorum": 2},
                            {"jitter": 0.0}, 1, 0),
        "deadline-alone": ([100] * 3, {"deadline": 0.5}, {"jitter": 0.0},
                           1, 0),
        "deadline-on-time": ([100] * 4, {"deadline": 10.0, "min_quorum": 2},
                             {"jitter": 0.0}, 1, 0),
        "dropout": ([100] * 6, {}, {"dropout_prob": 0.5, "seed": 5}, 1, 0),
        "clock": (varied[:3], {}, {}, 3, 0),
        "weighted-partial": (varied, {"participation": 0.5,
                                      "weighting": "examples"},
                             {"straggler_prob": 0.25, "seed": 4}, 1, 3),
    }[case]
    jcoord, pcoord = _pair(ns, policy, strag, seed=seed)
    outs = _run_sync(jcoord, pcoord, _numpy_loras(len(ns), seed=seed + 2),
                     rounds)
    out = outs[0]
    if case == "trivial":
        assert out.client_ids == list(range(5)) and out.weights is None
    elif case == "deadline-quorum":
        assert len(out.delivered) == 2 and len(out.dropped_deadline) == 2
    elif case == "deadline-alone":
        assert len(out.delivered) == 1 and len(out.dropped_deadline) == 2
    elif case == "deadline-on-time":
        assert len(out.delivered) == 4
    elif case == "dropout":
        assert set(out.client_ids) | set(out.dropped_out) == set(range(6))
        assert 0 < len(out.dropped_out) < 6
    elif case == "clock":
        t = [o.closed_at for o in outs]
        assert t == sorted(t) and t[0] > 0
    else:  # the weighted identity over the delivered subset
        loras = [d.lora for d in out.delivered]
        g, res = agg.fedex_aggregate(loras, out.weights)
        ideal = agg.product_mean(loras, out.weights)
        got = g["q_proj"]["a"] @ g["q_proj"]["b"] + res["q_proj"]
        torch.testing.assert_close(got, ideal["q_proj"], rtol=1e-5,
                                   atol=1e-6)


def _run_async(jcoord, pcoord, loras, rounds):
    """Commits side by side; the toy client returns its start (the launch
    snapshot) plus its own delta, and the next global is each commit's
    weighted factor mean (made once in numpy and handed to both), so a
    client trained from the wrong version shows."""
    jd = {i: jax.tree.map(jnp.asarray, t) for i, t in loras.items()}
    pd = {i: params_from_numpy(t, CPU) for i, t in loras.items()}
    glob = loras[0]
    outs = []
    for rnd in range(rounds):
        jo = jcoord.run_round(
            rnd, lambda c, g, r: jax.tree.map(jnp.add, g, jd[c.client_id]),
            jax.tree.map(jnp.asarray, glob))
        po = pcoord.run_round(
            rnd, lambda c, g, r: {"q_proj": {
                f: g["q_proj"][f] + pd[c.client_id]["q_proj"][f]
                for f in ("a", "b")}}, params_from_numpy(glob, CPU))
        _assert_same_outcome(jo, po)
        outs.append(po)
        if po.delivered:
            assert abs(sum(po.weights) - 1.0) < 1e-12
            trees = [to_numpy(d.lora)["q_proj"] for d in po.delivered]
            glob = {"q_proj": {f: sum(np.float32(w) * t[f] for w, t in
                                      zip(po.weights, trees))
                               for f in ("a", "b")}}
    assert _same_ledgers(jcoord, pcoord)
    return outs


@pytest.mark.parametrize("case", ["staleness", "empty", "discount",
                                  "dropout-lag"])
def test_async_coordinator_matches_reference(case):
    """Counterparts of tests/test_fedsrv.py::TestAsyncBuffer: commits,
    staleness, the discounted and renormalised weights, the snapshot each
    client trains from, and the snapshots freed."""
    ns, strag, akw, rounds = {
        "staleness": ([100, 200, 300], {"jitter": 0.6, "seed": 1},
                      {"buffer_size": 1}, 4),
        "empty": ([100, 100], {"dropout_prob": 1.0}, {"buffer_size": 2}, 1),
        "discount": ([100, 100], {"jitter": 0.8, "seed": 3},
                     {"buffer_size": 1, "staleness_alpha": 1.0}, 3),
        "dropout-lag": ([50, 80, 120, 200, 90], {"jitter": 0.7,
                                                 "dropout_prob": 0.3,
                                                 "seed": 2},
                        {"buffer_size": 2, "max_version_lag": 2}, 5),
    }[case]
    policy = {} if case == "empty" else {"weighting": "examples"}
    jcoord, pcoord = _pair(ns, policy, strag, async_kw=akw)
    outs = _run_async(jcoord, pcoord, _numpy_loras(len(ns), seed=2), rounds)
    assert pcoord._version == jcoord._version
    assert sorted(pcoord._snapshots) == sorted(jcoord._snapshots)
    stale = [d.staleness for o in outs for d in o.delivered]
    if case == "empty":
        assert outs[0].delivered == [] and outs[0].weights is None
        assert sorted(outs[0].dropped_out) == [0, 1]
    elif case == "discount":
        assert all(o.weights == [1.0] for o in outs)
    else:
        assert max(stale) > 0
    if case == "dropout-lag":
        assert any(o.dropped_out for o in outs)
        for o in outs:  # weights are n·(1 + s)^(−α), renormalised
            raw = [d.client.num_examples * (1.0 + d.staleness) ** -0.5
                   for d in o.delivered]
            assert o.weights == [x / sum(raw) for x in raw]


def test_transient_uplink_errors_retry_then_quarantine():
    """The retry path, driven by a fake transient decode error: one
    failure costs one backoff on the clock; a client that keeps failing is
    quarantined once the retries run out. Both as the reference."""
    outs = []
    for flaky in ({1: 1}, {1: 5}):
        jcoord, pcoord = _pair([100] * 3, stragglers={"jitter": 0.0})
        for coord, err in ((jcoord, JTransient), (pcoord,
                                                  TransientTransportError)):
            left, decode = dict(flaky), coord.codec.decode

            def flaky_decode(payload, left=left, decode=decode, err=err):
                if left.get(payload.client_id, 0) > 0:
                    left[payload.client_id] -= 1
                    raise err("fake", round_id=payload.round_id,
                              client_id=payload.client_id)
                return decode(payload)

            coord.codec.decode = flaky_decode
        outs += _run_sync(jcoord, pcoord, _numpy_loras(3))
    assert outs[0].retries == 1 and outs[0].client_ids == [0, 1, 2]
    assert outs[1].quarantined == [(1, "retries_exhausted")]


def test_quarantined_uplink_leaves_its_lane_unread(_nan_lanes):
    """A non-finite uplink streamed into a ring is quarantined before the
    write: its lane keeps the ring's NaN fill, and the ledger moves the
    payload to ``quarantined`` and its downlink to ``dropped``."""
    loras = _numpy_loras(3)
    loras[1]["q_proj"]["a"][2, 0] = np.inf
    pl = {i: params_from_numpy(t, CPU) for i, t in loras.items()}
    jcoord, pcoord = _pair([100] * 3)
    bufs = RoundBuffers(pl[0], c_max=3, depth=2)
    pcoord.sink = bufs
    _run_sync(jcoord, pcoord, loras)
    assert bufs.delivered_in(0) == {0: 0, 2: 2}
    lane = bufs.take(0)["q_proj/a"][1]
    assert bool(torch.isnan(lane).all())
    dirs = [(e.client_id, e.direction) for e in pcoord.ledger.entries]
    assert (1, "quarantined") in dirs and (1, "dropped") in dirs


# --------------------------------------------------------------------------
# the trainer, round by round against the reference's
# --------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trainers(**fed_kw):
    fed = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS,
               **fed_kw)
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


def _assert_trees_close(ref, port):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert list(rf) == list(pf)
    max_sep = 2 * LR * STEPS * CLIENTS
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


def _run_and_compare(jt, pt):
    outs = []
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        jo, po = jt.outcomes[-1], pt.outcomes[-1]
        for f in ("client_ids", "dropped_out", "dropped_deadline",
                  "quarantined", "weights", "degraded"):
            assert getattr(po, f) == getattr(jo, f), f
        assert ([d.staleness for d in po.delivered]
                == [d.staleness for d in jo.delivered])
        assert ([dataclasses.astuple(e) for e in pt.ledger.entries]
                == [dataclasses.astuple(e) for e in jt.ledger.entries])
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3)
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
        outs.append(po)
    # every round but the last has its adapter payloads freed
    assert all(d.lora is None for o in pt.outcomes[:-1] for d in o.delivered)
    return outs


def test_trainer_deadline_and_dropout_match_reference(_nan_lanes):
    jt, pt = _trainers(**DEADLINE)
    outs = _run_and_compare(jt, pt)
    assert all(o.dropped_out and o.dropped_deadline for o in outs)
    assert all(np.isfinite(h.eval_loss) for h in pt.history)


@pytest.mark.parametrize("chunk", [0, 1], ids=["stacked", "chunked"])
def test_trainer_fedbuff_matches_reference(_nan_lanes, chunk):
    """FedBuff commits of 2 (chunk 1: each commit's two lanes stream in
    two chunks, folded at ingest with the raw discounted weights)."""
    jt, pt = _trainers(close_chunk=chunk, **FEDBUFF)
    outs = _run_and_compare(jt, pt)
    assert max(d.staleness for o in outs for d in o.delivered) >= 1
    assert pt.engine.buffers.partial_folds == (2 * ROUNDS if chunk else 0)
    for o in outs:
        raw = [d.client.num_examples * (1.0 + d.staleness) ** -0.5
               for d in o.delivered]
        assert o.weights == [x / sum(raw) for x in raw]
