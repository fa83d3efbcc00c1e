"""The port's uplink transport against the JAX reference's
(``repro/fedsrv/transport.py``): the fp16 / int8 codec, the defended
decode's verdicts, the bytes ledger, and the trainer with quantized and
norm-limited uplinks, round by round.

Codec: from the same numpy-seeded float32 trees (normal leaves, an all-zero
leaf, leaves holding ±inf and NaN, values past fp16's range and below its
normal range) the int8 codes and scales, the fp16 bits and the decoded
float32 values must be equal bit for bit (NaN compared by position: the
frameworks' half → float conversions give NaNs different payloads), and
payload ``nbytes`` / ``num_params`` equal. Validation: the same ``reason``
(``bytes``, ``spec``, ``shape``, ``rank``, ``nonfinite``, ``norm``) or none.
Ledger: the same records give equal entries, totals, summary lines and
reconciliation against ``round_comm_params``.

Trainers: paper-tiny, vocab 64, 3 clients, 3 local steps, 2 rounds, the
reference's draws carried across with ``repro_torch.bridge``. Delivered and
quarantined ids, weights and ledger entries must be equal exactly.
Tolerances as ``tests/test_torch_federated.py`` states them for weighted
rounds: eval and client losses rtol 1e-5, the §6 divergence rtol 1e-3; W0
and the global adapters by each leaf's relative Frobenius error ≤ 1e-2 plus
the AdamW separation bound (2·lr·steps·clients elementwise). Under int8 an
element whose f32 training noise straddles a rounding boundary takes the
neighbouring code (one step, absmax/127, on either side); both bounds
hold that.
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
from repro.core import init_lora as jax_init_lora  # noqa: E402
from repro.core.comm import adapted_matrices as jax_mats  # noqa: E402
from repro.core.comm import round_comm_params as jax_comm  # noqa: E402
from repro.fedsrv import ClientInfo as JClientInfo  # noqa: E402
from repro.fedsrv import ClientRegistry as JRegistry  # noqa: E402
from repro.fedsrv import RoundCoordinator as JCoordinator  # noqa: E402
from repro.fedsrv import RoundPolicy as JPolicy  # noqa: E402
from repro.fedsrv.transport import AdapterCodec as JCodec  # noqa: E402
from repro.fedsrv.transport import BytesLedger as JLedger  # noqa: E402
from repro.fedsrv.transport import EncodedTensor as JEncoded  # noqa: E402
from repro.fedsrv.transport import TransportError as JError  # noqa: E402
from repro.fedsrv.transport import ValidationPolicy as JPolicyV  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.comm import adapted_matrices  # noqa: E402
from repro_torch.core.comm import round_comm_params  # noqa: E402
from repro_torch.fedsrv import (AdapterCodec, BytesLedger,  # noqa: E402
                                ClientInfo, ClientRegistry, EncodedTensor,
                                RoundCoordinator, RoundPolicy, TransportError,
                                ValidationPolicy)
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

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


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------

def _tree(case, seed=0):
    """A numpy adapter tree: leaves stacked over layers, as the model's."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tree = {"layers": {"q_proj": {
        "a": (0.02 * rng.normal(size=(2, 24, 4))).astype(f32),
        "b": rng.normal(size=(2, 4, 40)).astype(f32)}}}
    q = tree["layers"]["q_proj"]
    if case == "zeros":
        q["b"] = np.zeros_like(q["b"])
    elif case == "nonfinite":
        q["a"][0, 3, 1] = np.nan
        q["b"][1, 2, 7] = np.inf
        q["b"][0, 0, 0] = -np.inf
    elif case == "nan-only":
        q["b"][1, 1, 5] = np.nan
    elif case == "fp16-range":
        q["a"][0, :3, 0] = [7e4, -1e5, 65519.0]  # past fp16's max
        q["b"][0, 0, :4] = [1e-6, -3e-8, 6.1e-5, 1e-9]  # subnormal, underflow
    elif case == "halves":  # exact x.5 codes: round half to even
        q["b"][0, 0, :6] = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5], f32)
    return tree


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _assert_same_values(got, want):
    """Bitwise, NaN compared by position (its payload is conversion noise)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want) if want.dtype.kind == "f" else np.zeros(want.shape,
                                                                  bool)
    if want.dtype.kind == "f":
        assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(np.where(nan, 0, got)),
                                  _bits(np.where(nan, 0, want)))


@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
@pytest.mark.parametrize("case", ["normal", "zeros", "nonfinite", "nan-only",
                                  "fp16-range", "halves"])
def test_codes_and_decoded_values_match_reference(codec, case):
    tree = _tree(case)
    jp = JCodec(codec).encode(tree, round_id=3, client_id=1)
    pp = AdapterCodec(codec).encode(params_from_numpy(tree, CPU), round_id=3,
                                    client_id=1)
    assert (pp.nbytes, pp.num_params, pp.codec) == (jp.nbytes, jp.num_params,
                                                    jp.codec)
    assert list(pp.tensors) == list(jp.tensors)
    for path, je in jp.tensors.items():
        pe = pp.tensors[path]
        _assert_same_values(pe.data.numpy(), je.data)
        if codec == "int8":
            assert float(pe.scale) == je.scale  # the same float64
        else:
            assert pe.scale is None and je.scale is None
    jd = JCodec(codec)._decode_flat(jp)
    pd = AdapterCodec._decode_flat(pp)
    for path in jd:
        _assert_same_values(pd[path].numpy(), jd[path])


def test_int8_scale_is_cast_to_float32_before_dividing():
    """The reference divides by the scale as float32: on a leaf this large
    a float64 scale gives other codes somewhere (asserted, so the case can
    tell the two apart), and the port's codes are the reference's."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1 << 20,)).astype(np.float32)
    tree = {"l": {"a": x}}
    jp = JCodec("int8").encode(tree, round_id=0, client_id=0)
    pp = AdapterCodec("int8").encode(params_from_numpy(tree, CPU),
                                     round_id=0, client_id=0)
    scale = jp.tensors["l/a"].scale
    f64_codes = np.clip(np.rint(x.astype(np.float64) / scale), -127, 127)
    assert (f64_codes != jp.tensors["l/a"].data).any()
    np.testing.assert_array_equal(pp.tensors["l/a"].data.numpy(),
                                  jp.tensors["l/a"].data)


def test_none_payload_holds_the_client_tensors():
    tree = params_from_numpy(_tree("normal"), CPU)
    payload = AdapterCodec("none").encode(tree, round_id=0, client_id=0)
    flat = flatten_with_paths(tree)
    for path, enc in payload.tensors.items():
        assert enc.data is flat[path]
    decoded = flatten_with_paths(AdapterCodec("none").decode(payload))
    assert all(decoded[p].data_ptr() == flat[p].data_ptr() for p in flat)


def test_encode_syncs_never_and_decode_once(monkeypatch):
    """Encoding makes no host sync; the defended decode makes one per
    payload however many leaves it has (every leaf's f64 sum and absmax
    move to the host together)."""
    calls = []
    for name in ("cpu", "item", "tolist", "__bool__", "__float__", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    tree = _tree("normal")
    tree["layers"]["k_proj"] = {"a": tree["layers"]["q_proj"]["a"] * 2,
                                "b": tree["layers"]["q_proj"]["b"] * 3}
    tt = {k: {kk: {f: torch.from_numpy(x) for f, x in vv.items()}
              for kk, vv in v.items()} for k, v in tree.items()}
    codec = AdapterCodec("int8", validation=ValidationPolicy(max_norm=50.0))
    codec.register_spec(tt)
    payload = codec.encode(tt, round_id=0, client_id=0)
    assert calls == []
    codec.decode(payload)
    assert calls == ["cpu", "tolist"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _truncate(payload, path, enc_cls):
    enc = payload.tensors[path]
    short = enc_cls(enc.data.reshape(-1)[:-1], enc.scale,
                    shape=tuple(enc.data.shape))
    return dataclasses.replace(payload, tensors={**payload.tensors,
                                                 path: short})


VERDICTS = {  # case → (tree, ValidationPolicy fields, reason or None)
    "clean": ("normal", {}, None),
    "bytes": ("normal", {}, "bytes"),
    "spec": ("normal", {}, "spec"),
    "shape": ("normal", {}, "shape"),
    # int8 too: the inf leaf's scale is inf, so it decodes to NaN
    "nonfinite": ("nonfinite", {}, "nonfinite"),
    "norm": ("normal", {"max_norm": 1.5}, "norm"),
    # the norm check runs leaf by leaf before the finite verdict (int8's
    # NaN leaf decodes to NaN, whose absmax passes the check)
    "norm-first": ("nonfinite", {"max_norm": 1.5},
                   {"int8": "nonfinite"}),
    "disabled": ("nonfinite", {"enabled": False}, None),
    "no-finite-check": ("nonfinite", {"check_finite": False}, None),
    "ragged": ("normal", {}, None),
    "ragged-rank": ("normal", {}, "rank"),
    # only fp16 overflows (to ±inf)
    "fp16-range": ("fp16-range", {}, {"fp16": "nonfinite"}),
}


@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
@pytest.mark.parametrize("case", list(VERDICTS))
def test_validation_verdicts_match_reference(codec, case):
    """The same verdict, message and (round, client) on both sides."""
    kind, policy, want = VERDICTS[case]
    if isinstance(want, dict):
        want = want.get(codec, "norm" if case == "norm-first" else None)
    tree = spec_tree = _tree(kind)
    q = tree["layers"]["q_proj"]
    rank = None
    if case == "spec":
        spec_tree = {**tree, "extra": {"a": np.zeros((2, 2), np.float32)}}
    elif case == "shape":
        spec_tree = {"layers": {"q_proj": {"a": q["a"][:1], "b": q["b"]}}}
    elif case.startswith("ragged"):
        tree = {"layers": {"q_proj": {"a": q["a"][..., :2],
                                      "b": q["b"][:, :2]}}}
        rank = 2 if case == "ragged" else 5
    results = []
    for codec_cls, pol_cls, enc_cls, err_cls, make in (
            (JCodec, JPolicyV, JEncoded, JError, lambda t: t),
            (AdapterCodec, ValidationPolicy, EncodedTensor, TransportError,
             lambda t: params_from_numpy(t, CPU))):
        c = codec_cls(codec, validation=pol_cls(**policy))
        c.register_spec(make(spec_tree))
        payload = c.encode(make(tree), round_id=2, client_id=5, rank=rank)
        if case == "bytes":
            payload = _truncate(payload, "layers/q_proj/b", enc_cls)
        try:
            out = c.decode(payload)
        except err_cls as e:
            assert (e.round_id, e.client_id) == (2, 5)
            results.append((e.reason, str(e)))
            continue
        if codec_cls is AdapterCodec:
            out = to_numpy(out)
        results.append((None, {k: np.shape(x) for k, x in
                               jax_flatten(_np(out)).items()}))
    assert results[1] == results[0]
    assert results[0][0] == want


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

def _tiny_lora():
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=VOCAB,
                               dtype="float32")
    model = jax_build_model(jcfg)
    params = model.init(jax.random.key(0))
    return jcfg, jax.tree.map(np.asarray, jax_init_lora(
        jax.random.key(1), params, jcfg, JLoRAConfig(rank=4)))


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_ledger_matches_reference_and_reconciles(fraction):
    """Both coordinators over paper-tiny's adapter tree, then the same
    extra records: equal entries, totals and summary lines, and the
    measured uplink reconciles with ``round_comm_params`` (both)."""
    jcfg, lora = _tiny_lora()
    k = 4
    jcoord = JCoordinator(JRegistry([JClientInfo(i, 100 + i)
                                     for i in range(k)]),
                          JPolicy(participation=fraction))
    pcoord = RoundCoordinator(ClientRegistry([ClientInfo(i, 100 + i)
                                              for i in range(k)]),
                              RoundPolicy(participation=fraction))
    jl, pl = jax.tree.map(jnp.asarray, lora), params_from_numpy(lora, CPU)
    jcoord.run_round(0, lambda c, g, r: g, jl)
    pcoord.run_round(0, lambda c, g, r: g, pl)
    ledgers = []
    for ledger, codec in ((jcoord.ledger, JCodec("int8")),
                          (pcoord.ledger, AdapterCodec("int8"))):
        tree = lora if isinstance(codec, JCodec) else pl
        ledger.record(codec.encode(tree, round_id=1, client_id=2))
        ledger.record(codec.encode(tree, round_id=1, client_id=3),
                      note="quarantine:norm", direction="quarantined")
        ledger.record_analytic(1, "downlink", 1234, client_id=3)
        assert ledger.reclassify(1, 3, "downlink", "dropped", note="fed")
        assert not ledger.reclassify(1, 9, "downlink", "dropped")
        ledger.record_raw(1, "http_overhead", 512, client_id=2)
        ledgers.append(ledger)
    jled, pled = ledgers
    assert ([dataclasses.astuple(e) for e in pled.entries]
            == [dataclasses.astuple(e) for e in jled.entries])
    for r in (0, 1):
        assert pled.round_totals(r) == jled.round_totals(r)
    assert pled.totals() == jled.totals()
    assert pled.summary_lines() == jled.summary_lines()
    pmats = adapted_matrices(get_config("paper-tiny"), LoRAConfig(rank=4))
    analytic = jax_comm("fedex", jax_mats(jcfg, JLoRAConfig(rank=4)), 4, k,
                        participation_fraction=fraction)
    assert analytic == round_comm_params("fedex", pmats, 4, k,
                                         participation_fraction=fraction)
    rec = pled.reconcile(0, analytic)
    assert rec == jled.reconcile(0, analytic)
    assert rec["uplink"]["match"], rec


# --------------------------------------------------------------------------
# the trainer with quantized and norm-limited uplinks
# --------------------------------------------------------------------------

def _trainers(**fed_kw):
    fed = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS,
               **fed_kw)
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=VOCAB,
                               dtype="float32")
    jl, je = jax_data(VOCAB, CLIENTS, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(**{"engine": "jnp", **fed}),
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


def _inflate(jt, pt, client, factor):
    """Both trainers' ``client`` uploads its adapters times ``factor``."""
    jround, pround = jt._client_round, pt._client_round

    def jax_round(c, params, lora):
        out, losses = jround(c, params, lora)
        return (jax.tree.map(lambda x: x * factor, out) if c == client
                else out), losses

    def port_round(c, params, lora):
        out, losses = pround(c, params, lora)
        if c == client:
            out = unflatten_from_paths({p: x * factor for p, x in
                                        flatten_with_paths(out).items()})
        return out, losses

    jt._client_round, pt._client_round = jax_round, port_round


@pytest.mark.parametrize("fed_kw", [
    {"quantize_uplink": "int8", "weighting": "examples"},
    {"quantize_uplink": "fp16"},
    {"quantize_uplink": "int8", "engine": "off", "participation": 0.5,
     "weighting": "examples"},
    {"uplink_max_norm": 1.0, "weighting": "examples"},
    {"quantize_uplink": "int8", "uplink_max_norm": 1.0, "close_chunk": 1,
     "weighting": "examples"},
], ids=["int8", "fp16", "int8-eager-50%", "max-norm", "int8-max-norm-chunked"])
def test_trainer_uplinks_match_reference(fed_kw):
    jt, pt = _trainers(**fed_kw)
    limited = "uplink_max_norm" in fed_kw
    if limited:  # client 1 uploads adapters scaled past the limit
        _inflate(jt, pt, 1, 100.0)
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        jo, po = jt.outcomes[-1], pt.outcomes[-1]
        assert po.client_ids == jo.client_ids and po.weights == jo.weights
        assert po.quarantined == jo.quarantined
        if limited:
            assert po.quarantined == [(1, "norm")] and 1 not in po.client_ids
        assert ([dataclasses.astuple(e) for e in pt.ledger.entries]
                == [dataclasses.astuple(e) for e in jt.ledger.entries])
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3)
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
    codec = fed_kw.get("quantize_uplink", "none")
    ups = [e for e in pt.ledger.entries if e.direction == "uplink"]
    per_param = {"none": 4, "fp16": 2, "int8": 1}[codec]
    leaves = len(flatten_with_paths(pt.global_lora))
    assert all(e.nbytes == per_param * e.params
               + (4 * leaves if codec == "int8" else 0) for e in ups)
