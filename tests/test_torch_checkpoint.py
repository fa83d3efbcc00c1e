"""The port's crash-safe round state: the checkpoint file format, the
components' state round trips, and kill-and-resume inside the port.

File format: a tree of tensors round-trips with its dtypes and the JSON
meta; bfloat16 leaves come back bfloat16, bit for bit; a save replaces the
previous file atomically, and a save that fails leaves it whole; the files
are the reference's format (``repro/checkpoint``), each package reading the
other's.

Components: a loader across an epoch reshuffle (its state equal to the
reference loader's after the same draws), the clock, the ledger, the ring's
drop memories and counters, and a ring snapshotted mid-round — stacked, and
chunked with chunk 0 already folded at ingest and chunk 1 half written
(fedex, and hetero with its rank vectors) — restored into a fresh engine
and finished: the close equals the uninterrupted one bit for bit, on the
plain backend and on the kernel backend's CPU path.

Trainers (paper-tiny, vocab 16, a cosine schedule so that a wrong step
counter shows at once): a run killed at a round boundary and resumed in a
fresh trainer equals the uninterrupted run bit for bit — history, W0, the
global adapter and every client's base and adapter — for sync, FedBuff with
uplinks in flight, a fault plan, a later kill, chunked, hetero, hetero
chunked, and DP with reinit (every draw keys off (seed, round[, client]), so
no generator state is saved). The snapshot's meta equals the reference's at
the same boundary: next round, step counter, clock, ledger and loaders.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.data import ClientLoader as JLoader  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    round_state_path, save_checkpoint)
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.engine import RoundBuffers, RoundCloseEngine  # noqa
from repro_torch.core.hetero import pad_adapters  # noqa: E402
from repro_torch.data import ClientLoader  # noqa: E402
from repro_torch.fedsrv import AdapterCodec, BytesLedger, SimClock  # noqa
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
ROUNDS = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the file format
# --------------------------------------------------------------------------

def _tree():
    return {"layers": {"attn": {"q_proj": {
                "kernel": torch.arange(12.0).reshape(3, 4)}}},
            "scale": torch.tensor([1.0, -2.5]),
            "step": torch.tensor(7, dtype=torch.int32),
            "ids": torch.tensor([3, -(1 << 20)]),
            "w": torch.tensor([[1.5, -2.25, 3.0e-30]], dtype=torch.bfloat16),
            "host": np.arange(4, dtype=np.float64)}


def test_roundtrip_keeps_dtypes_values_and_meta(tmp_path):
    p = str(tmp_path / "sub" / "ckpt.npz")
    meta = {"round": 3, "method": "fedex", "t": 0.1 + 0.2, "x": [1, None]}
    save_checkpoint(p, _tree(), meta=meta)
    loaded, got = load_checkpoint(p, CPU)
    assert got == meta
    want = flatten_with_paths(_tree())
    flat = flatten_with_paths(loaded)
    assert list(flat) == list(want)
    for k, x in want.items():
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        assert flat[k].dtype == x.dtype and flat[k].device == CPU, k
        assert torch.equal(flat[k], x), k


def test_bf16_kept_bit_for_bit(tmp_path):
    p = str(tmp_path / "c.npz")
    w = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    save_checkpoint(p, {"w": w})
    loaded, _ = load_checkpoint(p, CPU)
    assert loaded["w"].dtype == torch.bfloat16
    assert torch.equal(loaded["w"].view(torch.int16), w.view(torch.int16))


def test_save_replaces_atomically(tmp_path, monkeypatch):
    p = str(tmp_path / "round_state.npz")
    save_checkpoint(p, {"x": torch.zeros(3)}, meta={"n": 1})
    save_checkpoint(p, {"x": torch.ones(3)}, meta={"n": 2})
    tree, meta = load_checkpoint(p, CPU)
    assert meta == {"n": 2} and torch.equal(tree["x"], torch.ones(3))

    def crash(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError):
        save_checkpoint(p, {"x": torch.full((3,), 9.0)}, meta={"n": 3})
    tree, meta = load_checkpoint(p, CPU)
    assert meta == {"n": 2} and torch.equal(tree["x"], torch.ones(3))
    assert os.listdir(tmp_path) == ["round_state.npz"]  # no temp file left
    assert round_state_path(str(tmp_path)) == p


def test_files_interchange_with_the_reference(tmp_path):
    port = str(tmp_path / "port.npz")
    save_checkpoint(port, _tree(), meta={"round": 1})
    ref_tree, ref_meta = jax_load(port)
    assert ref_meta == {"round": 1}
    assert ref_tree["w"].dtype == jnp.bfloat16
    for k, x in flatten_with_paths(_tree()).items():
        x = x.float() if k == "w" else x
        got = np.asarray(flatten_with_paths(ref_tree)[k], np.asarray(x).dtype)
        np.testing.assert_array_equal(got, np.asarray(x))
    ref = str(tmp_path / "ref.npz")
    jax_save(ref, {"a": jnp.arange(6.0).reshape(2, 3),
                   "b": jnp.asarray([1.5, 2.5], jnp.bfloat16)},
             meta={"k": "v"})
    tree, meta = load_checkpoint(ref, CPU)
    assert meta == {"k": "v"} and tree["b"].dtype == torch.bfloat16
    assert torch.equal(tree["a"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(tree["b"].float(), torch.tensor([1.5, 2.5]))


# --------------------------------------------------------------------------
# component state round trips
# --------------------------------------------------------------------------

def test_loader_state_round_trips_and_matches_reference():
    seqs = np.random.default_rng(0).integers(0, 16, size=(40, 8))
    a, ref = ClientLoader(seqs, batch_size=8, seed=3, device=CPU), JLoader(
        seqs, batch_size=8, seed=3)
    for _ in range(7):  # crosses an epoch reshuffle
        a.next_batch()
        ref.next_batch()
    state = a.state_dict()
    assert state == ref.state_dict()
    want = [a.next_batch()["tokens"] for _ in range(6)]
    b = ClientLoader(seqs, batch_size=8, seed=999, device=CPU)  # other seed
    b.load_state(state)
    for w in want:
        assert torch.equal(b.next_batch()["tokens"], w)


def test_clock_state():
    c = SimClock()
    c.advance_to(3.5)
    c.advance(1.25)
    d = SimClock()
    d.load_state(c.state_dict())
    assert d.now() == c.now() == 4.75


def test_ledger_state():
    codec = AdapterCodec("int8")
    ledger = BytesLedger()
    tree = {"q_proj": {"a": torch.zeros(4, 2)}}
    ledger.record(codec.encode(tree, round_id=0, client_id=1))
    ledger.record(codec.encode(tree, round_id=0, client_id=2),
                  direction="quarantined", note="quarantine:nonfinite")
    ledger.record_analytic(0, "downlink", 8, client_id=2)
    restored = BytesLedger()
    restored.load_state(ledger.state_dict())
    assert restored.round_totals(0) == ledger.round_totals(0)
    assert ([dataclasses.astuple(e) for e in restored.entries]
            == [dataclasses.astuple(e) for e in ledger.entries])


def _lora(val, m=6, r=2, n=4):
    return {"blk": {"q_proj": {"a": torch.full((m, r), float(val)),
                               "b": torch.full((r, n), float(val))}}}


def test_ring_memories_and_counters_round_trip():
    """The evicted and closed id memories and the drop counters survive:
    a late write for an evicted round is still stale after a resume."""
    bufs = RoundBuffers(_lora(0), c_max=2, depth=2)
    bufs.begin_round({0: 0, 1: 1}, round_id=0)
    bufs.write(0, _lora(1), round_id=0)
    assert not bufs.write(0, _lora(2), round_id=0)  # duplicate
    bufs.take(0)
    bufs.begin_round({0: 0}, round_id=1)
    bufs.evict(1, reason="degraded")
    assert not bufs.write(1, _lora(3), round_id=0)  # replay
    meta, arrays = bufs.state_dict()
    assert not arrays and meta["open"] == []
    fresh = RoundBuffers(_lora(0), c_max=2, depth=2)
    fresh.load_state(meta, arrays)
    for f in ("evictions", "stale_drops", "replay_drops", "duplicate_drops",
              "_auto", "partial_folds"):
        assert getattr(fresh, f) == getattr(bufs, f), f
    assert dict(fresh._evicted) == {1: "degraded"}
    assert list(fresh._closed) == [0]
    assert not fresh.write(0, _lora(4), round_id=1)
    assert fresh.stale_drops == 1


def _engine_case(method, chunk, backend):
    c, rmax = 6, 4
    ranks = [2, 4, 1, 3, 4, 2] if method == "hetero" else None
    rng = np.random.default_rng(21)

    def mk(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    w0 = mk(2, 16, 12)
    lora_t = {"q_proj": {"a": mk(2, 16, rmax), "b": mk(2, rmax, 12)}}
    loras = [pad_adapters({"q_proj": {"a": mk(2, 16, r), "b": mk(2, r, 12)}},
                          rmax) for r in (ranks or [rmax] * c)]
    raw_w = [30.0, 50.0, 70.0, 90.0, 110.0, 130.0]

    def make():
        return RoundCloseEngine({"q_proj": {"kernel": w0}}, lora_t, c_max=c,
                                scale=0.5, method=method, backend=backend,
                                chunk=chunk, client_ranks=ranks)

    def write(eng, i):
        eng.buffers.write(i, loras[i], round_id=0, weight=raw_w[i],
                          rank=None if ranks is None else ranks[i])

    def close(eng):
        # the kernel closes fold in place: every base is a fresh copy
        def base():
            return {"q_proj": {"kernel": w0.clone()}}
        if method == "hetero":
            cps, cls, g, div = eng.close_hetero([base() for _ in range(c)],
                                                list(range(c)), raw_w)
            trees = [g, cps, cls]
        else:
            g, p, div = eng.close(base(), list(range(c)), raw_w)
            trees = [g, p]
        return [x for t in trees for x in flatten_with_paths(t).values()], \
            div.resolve()

    return c, make, write, close


@pytest.mark.parametrize("backend", ["plain", "kernels"])
@pytest.mark.parametrize("method,chunk", [("fedex", 2), ("hetero", 2),
                                          ("fedex", 0), ("hetero", 0)],
                         ids=["fedex-chunked", "hetero-chunked",
                              "fedex-stacked", "hetero-stacked"])
def test_ring_midround_snapshot(method, chunk, backend, tmp_path):
    """Snapshot a round after 3 of its 6 writes (chunked: chunk 0 already
    folded at ingest, chunk 1 half written), through a checkpoint file,
    into a fresh engine; finish both: the closes are bitwise equal."""
    c, make, write, close = _engine_case(method, chunk, backend)
    whole, crashed = make(), make()
    for eng in (whole, crashed):
        eng.buffers.begin_round({i: i for i in range(c)}, round_id=0)
    for i in range(c):
        write(whole, i)
        if i < 3:
            write(crashed, i)
    meta, arrays = crashed.buffers.state_dict()
    entry = meta["open"][0]
    assert entry["chunked"] == bool(chunk)
    assert "ring/0/_ranks" in arrays
    if chunk:
        assert entry["acc_keys"] and entry["next_chunk"] == 1
        assert crashed.buffers.partial_folds == 1
    path = str(tmp_path / "ring.npz")
    save_checkpoint(path, {"ring": arrays}, meta=meta)
    tree, meta = load_checkpoint(path, CPU)
    resumed = make()
    resumed.buffers.load_state(meta, flatten_with_paths(tree["ring"]))
    assert resumed.buffers.partial_folds == crashed.buffers.partial_folds
    for i in range(3, c):
        write(resumed, i)
    got, got_div = close(resumed)
    want, want_div = close(whole)
    assert got_div == want_div
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# kill and resume inside the port
# --------------------------------------------------------------------------

_MODEL = {}


def _make_trainer(fed_cfg, clients=3):
    if "m" not in _MODEL:
        cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=16,
                                  dtype="float32")
        _MODEL["m"] = build_model(cfg)
    loaders, evals = build_federated_data(16, clients, seqs_per_task=24,
                                          seq_len=16, seed=0, device=CPU)
    return FederatedTrainer(
        model=_MODEL["m"], lora_cfg=LoRAConfig(rank=4, alpha=8),
        fed_cfg=fed_cfg,
        # cosine: the lr of a round depends on the absolute step index
        train_cfg=TrainConfig(learning_rate=1e-2, schedule="cosine",
                              total_steps=ROUNDS * fed_cfg.local_steps),
        client_loaders=loaders, eval_batches=evals[:2], seed=0, device=CPU)


def _leaves(tr):
    trees = [tr.global_lora, tr.params]
    if tr.client_params is not None:
        trees += [*tr.client_params, *tr._client_lora]
    return [x for t in trees for x in flatten_with_paths(t).values()]


def _kill_and_resume(fed_cfg, tmp_path, kill_after=1, clients=3):
    full = _make_trainer(fed_cfg, clients)
    full.run()
    ck = dataclasses.replace(fed_cfg, checkpoint_dir=str(tmp_path))
    killed = _make_trainer(ck, clients)
    killed.run(until=kill_after)
    assert len(killed.history) == kill_after
    del killed
    resumed = _make_trainer(ck, clients)
    resumed.load_state(round_state_path(str(tmp_path)))
    resumed.run()
    assert len(full.history) == len(resumed.history) == ROUNDS
    assert resumed.history == full.history
    a, b = _leaves(full), _leaves(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
    assert ([dataclasses.astuple(e) for e in resumed.ledger.entries]
            == [dataclasses.astuple(e) for e in full.ledger.entries])
    assert (resumed.coordinator.clock.now()
            == full.coordinator.clock.now())
    return full, resumed


RESUME_CASES = {
    "sync": dict(num_clients=3, weighting="examples"),
    "fedbuff": dict(num_clients=4, async_buffer=2, latency_jitter=0.5,
                    weighting="examples"),
    "faulty": dict(num_clients=3, faults="nan@1(clients=1,rounds=1)"),
    "later-kill": dict(num_clients=3),
    "chunked": dict(num_clients=5, weighting="examples", close_chunk=2),
    "hetero": dict(num_clients=3, method="hetero", client_ranks=(2, 4, 3)),
    "hetero-chunked": dict(num_clients=5, method="hetero",
                           client_ranks=(2, 4, 1, 3, 4), close_chunk=2),
    "dp-reinit": dict(num_clients=3, assignment="reinit", dp_clip=1.0,
                      dp_noise_multiplier=0.1, participation=0.67,
                      weighting="examples"),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_and_resume_bitwise(case, tmp_path):
    kw = RESUME_CASES[case]
    cfg = FedConfig(rounds=ROUNDS, local_steps=2, **kw)
    full, resumed = _kill_and_resume(
        cfg, tmp_path, kill_after=2 if case == "later-kill" else 1,
        clients=kw["num_clients"])
    if case == "fedbuff":
        assert resumed.coordinator._version == full.coordinator._version
        assert any(d.staleness for o in full.outcomes for d in o.delivered)
    if case == "faulty":  # the resumed half replays the same quarantine
        assert (1, "nonfinite") in full.outcomes[1].quarantined
        assert (1, "nonfinite") in resumed.outcomes[0].quarantined
    if "chunked" in case:
        assert full.engine.buffers.partial_folds > 0
    if case.startswith("hetero"):  # each client at its own rank
        for i, r in enumerate(kw["client_ranks"]):
            widths = {x.shape[-1] for k, x in flatten_with_paths(
                resumed._client_lora[i]).items() if k.endswith("/a")}
            assert widths == {r}


def test_checkpoint_every_skips_rounds(tmp_path):
    cfg = FedConfig(num_clients=3, rounds=2, local_steps=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=2)
    tr = _make_trainer(cfg)
    tr.run(until=1)
    assert not os.path.exists(round_state_path(str(tmp_path)))
    tr.run()
    _, meta = load_checkpoint(round_state_path(str(tmp_path)), CPU)
    assert meta["next_round"] == 2


def test_snapshot_meta_matches_reference(tmp_path):
    """The same boundary snapshotted by both packages: next round, step
    counter, clock, ledger entries and loader states equal exactly."""
    vocab, clients = 64, 3
    fed = dict(num_clients=clients, rounds=ROUNDS, local_steps=2,
               weighting="examples", participation=0.67,
               faults="nan@1(clients=2,rounds=1)")
    train = dict(learning_rate=5e-3, schedule="constant",
                 total_steps=ROUNDS * 2)
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=vocab,
                               dtype="float32")
    jl, je = jax_data(vocab, clients, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", checkpoint_dir=str(
                        tmp_path / "ref"), **fed),
                    train_cfg=JTrainConfig(**train), client_loaders=jl,
                    eval_batches=je, seed=0)
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=vocab,
                              dtype="float32")
    pl, pe = build_federated_data(vocab, clients, seed=0, device=CPU)
    pt = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(checkpoint_dir=str(tmp_path / "port"), **fed),
        train_cfg=TrainConfig(**train), client_loaders=pl, eval_batches=pe,
        seed=0, device=CPU,
        params=params_from_numpy(jax.tree.map(np.asarray, jt.params), CPU),
        global_lora=params_from_numpy(jax.tree.map(np.asarray,
                                                   jt.global_lora), CPU))
    jt.run(until=2)
    pt.run(until=2)
    _, want = jax_load(round_state_path(str(tmp_path / "ref")))
    _, got = load_checkpoint(round_state_path(str(tmp_path / "port")), CPU)
    for key in ("next_round", "global_step", "clock", "ledger", "loaders"):
        assert got[key] == want[key], key
    assert any(e["direction"] == "quarantined" for e in got["ledger"])
    assert [r["round"] for r in got["history"]] == [0, 1]
