"""The port's seeded fault injection against the JAX reference's
(``repro/fedsrv/faults.py``), and its crash-twin exactness inside the port.

Against the reference: the plan DSL parses to the same specs, prints the
same text and refuses the same junk; the injector's coins are equal over a
grid of (seed, round, client, spec); every fault kind corrupts a payload of
every codec to the same payload, bit for bit (NaN compared by position: the
frameworks' casts give NaNs different payloads; an int8 scale by value), with
the same ``injected`` log and the same decode verdict; and the client's own
tensors are never written. The coordinators run side by side on a toy
``train_fn`` under a plan: outcomes, retries and ledger entries equal
exactly. Trainers (paper-tiny, vocab 64, 4 clients, 3 local steps, 3 rounds,
the reference's draws carried across): the quarantined, dropped and
delivered ids and every ledger entry (direction, params, bytes, note) equal
exactly, round by round; W0 and the global adapters by each leaf's relative
Frobenius error ≤ 1e-2 plus the AdamW separation bound (2·lr·steps·clients
elementwise), as ``tests/test_torch_fedsrv.py`` states them.

Inside the port: a C = 8 round under nan + truncate + replay faults closes
bitwise equal to its crash twin (the same seed, the faulty clients crashed)
for fedex, fedex_svd, keep_local, hetero and the chunked fedex close, the
ring's fresh lanes filled with NaN (a lane opened and never written must
never be read); dropout never shifts a fault coin; all-quarantined sync and
async rounds degrade; the ring drops duplicates, replays and writes for an
evicted round; transient decode errors retry and run out.
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
from repro.fedsrv import ClientInfo as JClientInfo  # noqa: E402
from repro.fedsrv import ClientRegistry as JRegistry  # noqa: E402
from repro.fedsrv import FaultInjector as JInjector  # noqa: E402
from repro.fedsrv import FaultPlan as JPlan  # noqa: E402
from repro.fedsrv import RoundCoordinator as JCoordinator  # noqa: E402
from repro.fedsrv import StragglerModel as JStragglers  # noqa: E402
from repro.fedsrv.transport import AdapterCodec as JCodec  # noqa: E402
from repro.fedsrv.transport import TransportError as JError  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.engine import RoundBuffers  # noqa: E402
from repro_torch.fedsrv import (AdapterCodec, ClientInfo,  # noqa: E402
                                ClientRegistry, FaultInjector, FaultPlan,
                                RoundCoordinator, StragglerModel,
                                TransportError)
from repro_torch.fedsrv.faults import DETECTABLE_KINDS  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 4, 3, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)


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
# the plan DSL and the coins
# --------------------------------------------------------------------------

PLANS = [
    "nan@0.5(clients=1+3,rounds=0+2);scale@1(factor=100);replay@1(offset=2)",
    "nan@0.5(clients=1+3);truncate@1(rounds=2);crash@0.25",
    "decode_error@1(clients=0,count=3);duplicate@0.75;bitflip@0.1(rounds=4)",
    " inf@1 ; ; scale@0.5( factor=1e6 , clients=2 )",
]
BAD_PLANS = ["gremlin@1", "nan@1.5", "nan@-0.1", "nan@1(clients=1",
             "nan@1(foo=2)", "nan@1(clients)", "decode_error@1(count=0)",
             "replay@1(offset=0)", "nan@x", "nan@1(clients=a)"]


@pytest.mark.parametrize("text", PLANS)
def test_plan_parses_and_prints_as_the_reference(text):
    want, got = JPlan.parse(text, seed=5), FaultPlan.parse(text, seed=5)
    assert got.seed == want.seed == 5
    assert ([dataclasses.astuple(s) for s in got.specs]
            == [dataclasses.astuple(s) for s in want.specs])
    assert str(got) == str(want)
    assert FaultPlan.parse(str(got), seed=5) == got


@pytest.mark.parametrize("text", BAD_PLANS)
def test_bad_plans_rejected_as_the_reference(text):
    with pytest.raises(ValueError):
        JPlan.parse(text)
    with pytest.raises(ValueError):
        FaultPlan.parse(text)
    with pytest.raises(ValueError):  # at config time, not at round 40
        FedConfig(num_clients=2, rounds=1, faults=text)


@pytest.mark.parametrize("seed", [0, 7])
def test_draws_match_reference(seed):
    text = ("nan@0.5;truncate@0.3(clients=1+2);crash@0.7(rounds=1+3);"
            "scale@1(clients=0);duplicate@0")
    jinj = JInjector(JPlan.parse(text, seed=seed))
    pinj = FaultInjector(FaultPlan.parse(text, seed=seed))
    seen = set()
    for rnd in range(4):
        for c in range(6):
            want = [(i, str(s)) for i, s in jinj.draws(rnd, c)]
            assert [(i, str(s)) for i, s in pinj.draws(rnd, c)] == want
            seen.update(i for i, _ in want)
    assert seen == {0, 1, 2, 3}  # every live spec fired somewhere, @0 never


# --------------------------------------------------------------------------
# payload corruption, bit for bit
# --------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"layers": {
        "q_proj": {"a": (0.02 * rng.normal(size=(2, 24, 4))).astype(f32),
                   "b": rng.normal(size=(2, 4, 40)).astype(f32)},
        "v_proj": {"a": (0.02 * rng.normal(size=(2, 24, 4))).astype(f32),
                   "b": rng.normal(size=(2, 4, 12)).astype(f32)}}}


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _assert_same_values(got, want):
    """Bitwise, NaN compared by position."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(np.where(nan, 0, got)),
                                  _bits(np.where(nan, 0, want)))


def _same_scale(got, want):
    if want is None:
        return got is None
    got = float(got)
    return got == want or (np.isnan(got) and np.isnan(want))


KIND_ARGS = {"scale": "(factor=37.5)", "decode_error": "(count=2)",
             "replay": "(offset=2)"}
KINDS = ["nan", "inf", "bitflip", "truncate", "scale", "replay", "duplicate",
         "crash", "decode_error"]


def _verdict(codec, payload, err_cls):
    try:
        return None, codec.decode(payload)
    except err_cls as e:
        return e.reason, None


@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_corruption_matches_reference(kind, codec):
    """The same payload bit for bit, the same applied kinds and injected
    log, and the same decode verdict (decoded values bitwise when it
    passes), at several (seed, round, client) draws."""
    text = f"{kind}@1{KIND_ARGS.get(kind, '')}"
    for seed, rnd, cid in ((0, 0, 0), (3, 5, 2), (11, 2, 7)):
        tree = _tree(seed)
        jc, pc = JCodec(codec), AdapterCodec(codec)
        jp = jc.encode(tree, round_id=rnd, client_id=cid)
        pp = pc.encode(params_from_numpy(tree, CPU), round_id=rnd,
                       client_id=cid)
        jinj = JInjector(JPlan.parse(text, seed=seed))
        pinj = FaultInjector(FaultPlan.parse(text, seed=seed))
        jp, japplied = jinj.corrupt(jp)
        pp, papplied = pinj.corrupt(pp)
        assert [s.kind for s in papplied] == [s.kind for s in japplied] \
            == [kind]
        assert pinj.injected == jinj.injected
        assert (pp.round_id, pp.client_id) == (jp.round_id, jp.client_id)
        assert list(pp.tensors) == list(jp.tensors)
        for path, want in jp.tensors.items():
            got = pp.tensors[path]
            assert got.declared_shape == want.declared_shape, path
            _assert_same_values(got.data.numpy(), np.asarray(want.data))
            assert _same_scale(got.scale, want.scale), path
        jr, jout = _verdict(jc, jp, JError)
        pr, pout = _verdict(pc, pp, TransportError)
        assert pr == jr
        if jr is None:
            want = jax_flatten(jax.tree.map(np.asarray, jout))
            got = flatten_with_paths(to_numpy(pout))
            for k in want:
                _assert_same_values(got[k], want[k])
        elif kind in DETECTABLE_KINDS:
            assert pr == ("bytes" if kind == "truncate" else "nonfinite")


@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip", "truncate",
                                  "scale"])
def test_faults_never_write_the_clients_tensors(kind):
    """The ``none`` codec's payload holds the client's own float32 leaves:
    a fault writes into a copy, so the client's adapter stays as trained
    (under keep_local and hetero it is the client's next start)."""
    tree = params_from_numpy(_tree(1), CPU)
    before = {p: x.clone() for p, x in flatten_with_paths(tree).items()}
    payload = AdapterCodec("none").encode(tree, round_id=0, client_id=0)
    leaves = flatten_with_paths(tree)
    assert all(payload.tensors[p].data is leaves[p] for p in leaves)
    inj = FaultInjector(FaultPlan.parse(f"{kind}@1", seed=4))
    bad, _ = inj.corrupt(payload)
    for p, x in flatten_with_paths(tree).items():
        assert torch.equal(x, before[p]), p
        assert torch.equal(payload.tensors[p].data, before[p]), p
    assert any(bad.tensors[p].data.shape != before[p].shape
               or not torch.equal(bad.tensors[p].data, before[p])
               for p in before)


@pytest.mark.parametrize("kind", ["nan", "inf", "scale", "truncate"])
def test_corrupt_lane_matches_reference(kind):
    """Lane faults (no wire): only nan, inf and scale apply, on the same
    element; the inputs are never written."""
    text = f"{kind}@1(factor=3)" if kind == "scale" else f"{kind}@1"
    flat = jax_flatten(_tree(2))
    jout, japplied = JInjector(JPlan.parse(text, seed=9)).corrupt_lane(
        1, 3, dict(flat))
    leaves = {p: torch.from_numpy(x.copy()) for p, x in flat.items()}
    before = {p: x.clone() for p, x in leaves.items()}
    pout, papplied = FaultInjector(FaultPlan.parse(text, seed=9)
                                   ).corrupt_lane(1, 3, leaves)
    assert [s.kind for s in papplied] == [s.kind for s in japplied]
    assert bool(papplied) == (kind != "truncate")
    for p in flat:
        _assert_same_values(pout[p].numpy(), np.asarray(jout[p]))
        assert torch.equal(leaves[p], before[p])


# --------------------------------------------------------------------------
# the coordinator under a plan, side by side with the reference's
# --------------------------------------------------------------------------

def _numpy_loras(k, m=16, r=2, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return {i: {"q_proj": {"a": rng.normal(size=(m, r)).astype(np.float32),
                           "b": rng.normal(size=(r, n)).astype(np.float32)}}
            for i in range(k)}


@pytest.mark.parametrize("plan,retries", [
    ("nan@1(clients=1);crash@1(clients=2);replay@1(clients=3,rounds=1);"
     "decode_error@1(clients=0,count=2);duplicate@1(clients=4)", 2),
    ("decode_error@1(clients=0+3,count=3);nan@0.3;truncate@0.3", 2),
    ("decode_error@1(clients=1,count=2)", 1),
], ids=["mixed", "probabilistic", "exhausted"])
def test_coordinator_under_faults_matches_reference(plan, retries):
    """No ring: the coordinator itself drops replays. Outcomes (ids,
    quarantine reasons, retries, clock) and ledgers equal exactly."""
    ns = [100, 150, 200, 250, 300]
    jcoord = JCoordinator(JRegistry([JClientInfo(i, n)
                                     for i, n in enumerate(ns)]),
                          stragglers=JStragglers(jitter=0.3),
                          faults=JInjector(JPlan.parse(plan, seed=1)),
                          uplink_retries=retries)
    pcoord = RoundCoordinator(ClientRegistry([ClientInfo(i, n)
                                              for i, n in enumerate(ns)]),
                              stragglers=StragglerModel(jitter=0.3),
                              faults=FaultInjector(FaultPlan.parse(plan,
                                                                   seed=1)),
                              uplink_retries=retries)
    loras = _numpy_loras(len(ns))
    jl = {i: jax.tree.map(jnp.asarray, t) for i, t in loras.items()}
    pl = {i: params_from_numpy(t, CPU) for i, t in loras.items()}
    outs = []
    for rnd in range(3):
        jo = jcoord.run_round(rnd, lambda c, g, r: jl[c.client_id], jl[0])
        po = pcoord.run_round(rnd, lambda c, g, r: pl[c.client_id], pl[0])
        for f in ("client_ids", "quarantined", "retries", "degraded",
                  "opened_at", "closed_at", "comm", "weights"):
            assert getattr(po, f) == getattr(jo, f), (rnd, f)
        outs.append(po)
    assert ([dataclasses.astuple(e) for e in pcoord.ledger.entries]
            == [dataclasses.astuple(e) for e in jcoord.ledger.entries])
    assert pcoord.faults.injected == jcoord.faults.injected
    if plan.startswith("nan"):
        assert sorted(outs[1].quarantined) == [(1, "nonfinite"),
                                               (2, "crash"), (3, "replay")]
        assert outs[1].retries == 2 and 0 in outs[1].client_ids
    if retries == 1:
        assert all(o.quarantined == [(1, "retries_exhausted")]
                   for o in outs)


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


TRAINER_PLANS = {
    "sync": dict(faults="nan@1(clients=1,rounds=0+2);truncate@1(clients=2,"
                 "rounds=1);replay@1(clients=3,rounds=1+2);decode_error@1("
                 "clients=0,count=1);duplicate@1(clients=0,rounds=2)",
                 weighting="examples"),
    "probabilistic": dict(faults="nan@0.4;truncate@0.3;crash@0.2",
                          participation=0.5, weighting="examples"),
    "fedbuff": dict(faults="nan@1(clients=1);crash@1(clients=2,rounds=1)",
                    async_buffer=2, weighting="examples"),
}


@pytest.mark.parametrize("case", list(TRAINER_PLANS))
def test_trainer_faults_match_reference(case, _nan_lanes):
    jt, pt = _trainers(**TRAINER_PLANS[case])
    for rnd in range(ROUNDS):
        jt.run(until=rnd + 1)
        pt.run(until=rnd + 1)
        jo, po = jt.outcomes[-1], pt.outcomes[-1]
        for f in ("client_ids", "dropped_out", "quarantined", "weights",
                  "degraded", "retries"):
            assert getattr(po, f) == getattr(jo, f), (rnd, f)
        assert ([dataclasses.astuple(e) for e in pt.ledger.entries]
                == [dataclasses.astuple(e) for e in jt.ledger.entries])
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
    assert pt.fault_injector.injected == jt.fault_injector.injected
    assert any(o.quarantined for o in pt.outcomes)
    dirs = {e.direction for e in pt.ledger.entries}
    assert {"quarantined", "dropped"} <= dirs
    assert all(np.isfinite(h.eval_loss) for h in pt.history)


# --------------------------------------------------------------------------
# inside the port: crash twins, coins, degraded rounds, drops, retries
# --------------------------------------------------------------------------

PLAN = "nan@1(clients=2);truncate@1(clients=5);replay@1(clients=7)"
TWIN = "crash@1(clients=2+5+7)"
HET_RANKS = (4, 2, 1, 4, 2, 1, 4, 2)  # faulted clients 2, 5, 7 are ragged
_MODEL = {}


def _trainer(fed_cfg, clients=4):
    if "m" not in _MODEL:
        cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=16,
                                  dtype="float32")
        _MODEL["m"] = build_model(cfg)
    loaders, evals = build_federated_data(16, clients, seqs_per_task=24,
                                          seq_len=16, seed=0, device=CPU)
    return FederatedTrainer(
        model=_MODEL["m"], lora_cfg=LoRAConfig(rank=4, alpha=8),
        fed_cfg=fed_cfg,
        train_cfg=TrainConfig(learning_rate=1e-2, schedule="constant"),
        client_loaders=loaders, eval_batches=evals[:1], seed=0, device=CPU)


def _leaves(tr):
    trees = [tr.global_lora, tr.params]
    if tr.client_params is not None:
        trees += [*tr.client_params, *tr._client_lora]
    return [x for t in trees for x in flatten_with_paths(t).values()]


TWIN_CASES = {
    "fedex": dict(weighting="examples"),
    "fedex_svd": dict(method="fedex_svd", svd_rank=8, weighting="examples"),
    "keep_local": dict(assignment="keep_local", weighting="examples"),
    "hetero": dict(method="hetero", client_ranks=HET_RANKS),
    "fedex[chunked]": dict(weighting="examples", close_chunk=3),
}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_crash_twin_bitwise(case, _nan_lanes):
    """The acceptance bar: faulty clients contribute nothing, so the run
    equals, bit for bit, the same-seed run in which they crashed: W0, the
    global adapter, and every client's base and adapter."""
    def run(plan):
        tr = _trainer(FedConfig(num_clients=8, rounds=2, local_steps=1,
                                faults=plan, **TWIN_CASES[case]), clients=8)
        tr.run()
        return tr

    faulty, twin = run(PLAN), run(TWIN)
    for o in faulty.outcomes:
        assert ({c for c, _ in o.quarantined} == {2, 5, 7}
                and o.client_ids == [0, 1, 3, 4, 6])
    assert [o.client_ids for o in twin.outcomes] == [
        o.client_ids for o in faulty.outcomes]
    q = {e.client_id for e in faulty.ledger.entries
         if e.direction == "quarantined"}
    assert q == {2, 5}
    a, b = _leaves(faulty), _leaves(twin)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)
    assert all(bool(torch.isfinite(x).all()) for x in a)
    if case == "hetero":  # survivors keep their true ranks
        for c, r in enumerate(HET_RANKS):
            widths = {x.shape[-1] for k, x in flatten_with_paths(
                faulty._client_lora[c]).items() if k.endswith("/a")}
            assert widths == {r}


def test_dropout_does_not_shift_fault_coins():
    """Dropout changes who uplinks, never which surviving uplinks are
    faulted: the streams are disjoint."""
    def quarantined(dropout):
        tr = _trainer(FedConfig(num_clients=6, rounds=2, local_steps=1,
                                dropout_prob=dropout,
                                faults="nan@1(clients=1+4);truncate@0.5"),
                      clients=6)
        tr.run()
        return [({c for c, _ in o.quarantined}, set(o.dropped_out))
                for o in tr.outcomes]

    base, dropped = quarantined(0.0), quarantined(0.4)
    assert any(d for _, d in dropped)
    for (q0, _), (q1, d1) in zip(base, dropped):
        assert q1 == q0 - d1


def test_all_quarantined_rounds_degrade():
    """A sync round whose every uplink is quarantined carries the global
    forward (and evicts its ring set); a FedBuff commit holds its version.
    The next round recovers."""
    sync = _trainer(FedConfig(num_clients=3, rounds=2, local_steps=1,
                              faults="nan@1(rounds=0)"), clients=3)
    before = [x.clone() for x in _leaves(sync)]
    sync.run(until=1)
    out = sync.outcomes[0]
    assert out.degraded and not out.delivered
    assert {c for c, _ in out.quarantined} == {0, 1, 2}
    assert sync.engine.buffers.evictions == 1
    for x, y in zip(_leaves(sync), before):
        assert torch.equal(x, y)
    sync.run()
    assert sync.outcomes[1].delivered and not sync.outcomes[1].degraded
    assert all(bool(torch.isfinite(x).all()) for x in _leaves(sync))

    fedbuff = _trainer(FedConfig(num_clients=3, rounds=2, local_steps=1,
                                 async_buffer=2, faults="nan@1(rounds=0)"),
                       clients=3)
    fedbuff.run()
    assert fedbuff.outcomes[0].degraded and not fedbuff.outcomes[0].delivered
    assert not fedbuff.outcomes[1].degraded
    assert fedbuff.coordinator._version == 1


def test_ring_drops_duplicates_replays_and_evicted_writes():
    """A duplicate's copy is refused as a duplicate lane, a replay into a
    closed round as a replay, and one into an evicted (degraded) round as
    stale; each is ledgered ``dropped``, and the rounds close over the
    rest."""
    tr = _trainer(FedConfig(
        num_clients=3, rounds=4, local_steps=1,
        faults="duplicate@1(clients=0);nan@1(rounds=0);"
               "replay@1(clients=1,rounds=1+3)"), clients=3)
    tr.run()
    bufs = tr.engine.buffers
    assert tr.outcomes[0].degraded  # round 0 evicted
    assert tr.outcomes[1].quarantined == [(1, "stale")]   # into evicted 0
    assert tr.outcomes[3].quarantined == [(1, "stale")]   # into closed 2
    assert (bufs.stale_drops, bufs.replay_drops) == (1, 1)
    assert bufs.duplicate_drops == 3  # rounds 1–3 (round 0's copy: nan)
    notes = [(e.round_id, e.client_id, e.note) for e in tr.ledger.entries
             if e.direction == "dropped" and e.note.startswith(
                 ("fault", "drop"))]
    assert sorted(notes) == [(0, 1, "drop:stale"), (1, 0, "fault:duplicate"),
                             (2, 0, "fault:duplicate"), (2, 1, "drop:stale"),
                             (3, 0, "fault:duplicate")]
    assert [o.client_ids for o in tr.outcomes[1:]] == [[0, 2], [0, 1, 2],
                                                       [0, 2]]


@pytest.mark.parametrize("count,retries", [(1, 2), (2, 2), (5, 1)])
def test_transient_decode_errors_retry(count, retries):
    """Each transient failure costs one backoff on the clock
    (retry_backoff · 2^attempt); past the retries the uplink is
    quarantined."""
    def run(plan):
        tr = _trainer(FedConfig(num_clients=3, rounds=1, local_steps=1,
                                uplink_retries=retries, faults=plan),
                      clients=3)
        tr.run()
        return tr

    tr = run(f"decode_error@1(clients=0,count={count})")
    clean = run("crash@0(clients=0)")
    out = tr.outcomes[0]
    if count <= retries:
        assert out.retries == count and 0 in out.client_ids
        assert not out.quarantined
        assert tr.coordinator.clock.now() >= clean.coordinator.clock.now()
        for x, y in zip(_leaves(tr), _leaves(clean)):
            assert torch.equal(x, y)
    else:
        assert out.quarantined == [(0, "retries_exhausted")]
        assert out.client_ids == [1, 2]


def test_faults_refused_where_uploads_never_cross_the_uplink():
    for kw in (dict(method="centralized"),
               dict(method="hetero", engine="off")):
        with pytest.raises(ValueError, match="faults"):
            _trainer(FedConfig(num_clients=2, rounds=1, faults="nan@1",
                               **kw), clients=2)


def test_hetero_round_with_no_delivery_raises_as_the_reference():
    """A hetero round whose every uplink is quarantined has nothing to
    close; the reference's engine raises, and so does the port's."""
    tr = _trainer(FedConfig(num_clients=2, rounds=1, local_steps=1,
                            method="hetero", client_ranks=(4, 2),
                            faults="nan@1"), clients=2)
    with pytest.raises(ValueError, match="no deliveries"):
        tr.run()
