"""The port's dry-run family against the JAX reference's: the assigned
shapes, the roofline yardstick, the abstract inputs and state, the step
builders, the counter (``repro_torch.launch.cost``) against the
reference's loop-aware HLO analyser, its loop-aware rule against a count
that runs every iteration, B3's and B8's meta branches and reported work,
the dry-run launcher in process, and the two helpers it uses.

Tolerances:
* shapes, skips, MODEL_FLOPS, input specs and abstract state leaves exact;
* the counter against ``repro.launch.hlo_analysis.analyze`` at paper-tiny,
  batch 2 × 128, rank-16 adapters: prefill and decode FLOPs within 2%,
  where the reference's prefill counts B8's one 128 × 128 tile a head
  whole (its kernel computes the tile's masked half too: bq = bk = 128)
  and the port's B8 formula counts the causal band's pairs, so the test
  adds the tile's masked pairs back; the train step within 3% of the
  reference's with its per-layer remat switched off
  (``jax.checkpoint`` an identity for that count), and the reference's
  remat at most one forward of the port's layer stack; 1 and 2
  microbatches count the same FLOPs in both;
* the loop-aware rule: FLOPs and bytes exact against every iteration run,
  peaks within 1%;
* ``make_train_step`` against the reference's at paper-tiny in f32 from
  the reference's draws: loss and gnorm rtol 1e-5, each LoRA leaf within
  relative Frobenius 1e-2 and the AdamW separation bound 2·lr.
"""

import csv
import dataclasses
import importlib
import inspect
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.dryrun as jdryrun  # noqa: E402
from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_analysis import analyze  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util import logging as jlogging  # noqa: E402
from repro.util.registry import Registry as JRegistry  # noqa: E402

from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (ASSIGNED, SHAPES, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, get_shape,
                                 list_configs)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import cost, dryrun, roofline, steps  # noqa: E402
from repro_torch.models.mlp import mlp_block  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.xlstm import mlstm_chunked  # noqa: E402
from repro_torch.optim import init_adamw  # noqa: E402
from repro_torch.util import cost as ucost  # noqa: E402
from repro_torch.util import logging as tlogging  # noqa: E402
from repro_torch.util.registry import Registry  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

# the modules (the package's attributes of these names are the wrappers)
lm = importlib.import_module("repro_torch.kernels.lora_matmul")
fs = importlib.import_module("repro_torch.kernels.flash_swa")
META = torch.device("meta")
LORA = dict(rank=16, alpha=32)  # the dry run's adapters
TINY_B, TINY_S = 2, 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on a few cores,
    where a multi-threaded op waits at every barrier for parked threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jflat(tree):
    """path → leaf of a JAX tree (dict keys and NamedTuple fields)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = leaf
    return out


# --------------------------------------------------------------------------
# shapes, skips, yardstick
# --------------------------------------------------------------------------

def test_shapes_and_get_shape_match_reference():
    assert ASSIGNED.keys() == J_ASSIGNED.keys()
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(J_SHAPES[name])
        assert s.is_decode == J_SHAPES[name].is_decode
        assert get_shape(name) == s
    with pytest.raises(KeyError) as got:
        get_shape("train_8k")
    with pytest.raises(KeyError) as want:
        jax_get_shape("train_8k")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", list(J_ASSIGNED))
def test_should_skip_matches_reference(arch):
    for name in SHAPES:
        assert dryrun.should_skip(get_config(arch), get_shape(name)) == \
            jdryrun.should_skip(jax_get_config(arch), jax_get_shape(name))


@pytest.mark.parametrize("arch", jax_list_configs())
def test_model_flops_match_reference(arch):
    assert list_configs() == jax_list_configs()
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
    for name in SHAPES:
        assert roofline.model_flops_per_step(cfg, get_shape(name)) == \
            jroofline.model_flops_per_step(jcfg, jax_get_shape(name))
    assert roofline.peak_flops("bfloat16") == 989e12
    assert roofline.peak_flops("float32") == 67e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("arch", list(J_ASSIGNED))
def test_input_specs_match_reference(arch):
    for name in SHAPES:
        got = steps.input_specs(get_config(arch), get_shape(name))
        want = jsteps.input_specs(jax_get_config(arch), jax_get_shape(name))
        assert list(got) == list(want)
        for k, x in got.items():
            assert x.device == META
            assert tuple(x.shape) == want[k].shape, (name, k)
            assert str(x.dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x22b",
                                  "zamba2-7b", "xlstm-1.3b",
                                  "whisper-medium", "internvl2-76b",
                                  "gemma3-12b", "deepseek-v2-236b"])
def test_abstract_state_matches_reference(arch):
    """Params, LoRA and AdamW mu / nu on the meta device, leaf for leaf by
    path, against the reference's ``jax.eval_shape`` leaves (one config of
    every family, gemma3's periods and deepseek's MLA besides)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model = build_model(cfg, moe_impl="dense")
    got = steps.abstract_state(model, cfg, LoRAConfig(**LORA))
    want = jsteps.abstract_state(jax_build_model(jcfg), jcfg,
                                 JLoRAConfig(**LORA))
    pairs = [(got[0], want[0]), (got[1], want[1]),
             (got[2].mu, want[2].mu), (got[2].nu, want[2].nu)]
    for g, w in pairs:
        gf, wf = flatten_with_paths(g), _jflat(w)
        assert list(gf) == list(wf)
        for k, x in gf.items():
            assert x.device == META
            assert tuple(x.shape) == wf[k].shape, k
            assert str(x.dtype).removeprefix("torch.") == str(wf[k].dtype), k
    assert got[2].step == 0


# --------------------------------------------------------------------------
# the counter against the reference's analyser
# --------------------------------------------------------------------------

def _ref_flops(kind, microbatches=1, remat=True):
    cfg = jax_get_config("paper-tiny")
    model = jax_build_model(cfg)
    lcfg = JLoRAConfig(**LORA)
    params, lora, opt = jsteps.abstract_state(model, cfg, lcfg)
    batch = jsteps.input_specs(cfg, JShapeConfig("t", TINY_S, TINY_B, kind))
    scalar = jax.ShapeDtypeStruct((), jnp.int32)
    if kind == "train":
        fn = jsteps.make_train_step(model, lcfg, JTrainConfig(total_steps=1000),
                                    num_microbatches=microbatches)
        args = (params, lora, opt, batch, scalar)
    elif kind == "prefill":
        fn = jsteps.make_prefill_step(model, lcfg)
        args = (params, lora, batch,
                jsteps.abstract_cache(model, TINY_B, TINY_S))
    else:
        fn = jsteps.make_decode_step(model, lcfg)
        args = (params, lora, batch["tokens"],
                jsteps.abstract_cache(model, TINY_B, TINY_S), scalar)
    checkpoint = jax.checkpoint
    if not remat:
        jax.checkpoint = lambda f, *a, **k: f
    try:
        return analyze(jax.jit(fn).lower(*args).compile().as_text()).flops
    finally:
        jax.checkpoint = checkpoint


def _port_costs(kind, microbatches=1, cfg=None, **kw):
    cfg = cfg or get_config("paper-tiny")
    return dryrun.count_step(cfg, ShapeConfig("t", TINY_S, TINY_B, kind),
                             lora_cfg=LoRAConfig(**LORA),
                             microbatches=microbatches, **kw)


def test_prefill_and_decode_flops_match_reference():
    cfg = get_config("paper-tiny")
    hd = cfg.resolved_head_dim
    # the reference's B8 computes its one 128 × 128 tile a head whole
    band = ucost.attention_pairs(TINY_S, TINY_S, True, 0)
    tile = (4 * TINY_B * cfg.num_heads * hd * cfg.num_layers
            * (TINY_S * TINY_S - band))
    got = _port_costs("prefill").flops
    assert got + tile == pytest.approx(_ref_flops("prefill"), rel=0.02)
    assert _port_costs("decode").flops == pytest.approx(_ref_flops("decode"),
                                                        rel=0.02)


def test_train_flops_match_reference():
    cfg = get_config("paper-tiny")
    got = _port_costs("train").flops
    assert _port_costs("train", microbatches=2).flops == got
    want = _ref_flops("train")
    assert _ref_flops("train", microbatches=2) == want
    assert got == pytest.approx(_ref_flops("train", remat=False), rel=0.03)
    # the reference's remat recomputes at most one forward of the layer
    # stack (XLA drops the products whose outputs the backward never reads)
    stack = _port_costs("prefill").flops - 2 * TINY_B * TINY_S \
        * cfg.d_model * cfg.vocab_size
    assert got < want <= got + stack * 1.001


# --------------------------------------------------------------------------
# the loop-aware rule
# --------------------------------------------------------------------------

def _both(fn, *args):
    return (cost.count(fn, *args), cost.count(fn, *args, shortcut=False))


def _assert_same(short, full):
    assert short.flops == full.flops
    assert short.bytes_accessed == full.bytes_accessed
    assert short.peak_bytes == pytest.approx(full.peak_bytes, rel=0.01)


@pytest.mark.parametrize("arch,seq,over,microbatches", [
    ("xlstm-1.3b-smoke", 24, {}, 1),    # the sLSTM time loop
    ("zamba2-7b-smoke", 1280, {}, 1),   # the SSD chunk loop (5 chunks)
    ("paper-tiny", 32, {"num_layers": 6}, 4),  # the layer, microbatch loops
    ("xlstm-1.3b-smoke", 8, {"num_layers": 10}, 1),  # periods around sLSTM
    # zamba2's periods (the shared block and its unsliced adapter each one)
    ("zamba2-7b-smoke", 16, {"num_layers": 6}, 1),
    ("gemma3-12b-smoke", 16, {"num_layers": 10}, 1),  # 5 local/global periods
    ("mixtral-8x22b-smoke", 16, {"num_layers": 5}, 1),  # MoE layers (dense)
    # deepseek's dense_layers and layers stacks
    ("deepseek-v2-236b-smoke", 16, {"num_layers": 10, "first_k_dense": 5}, 1),
    # whisper's encoder and decoder loops
    ("whisper-medium-smoke", 16, {"num_layers": 5, "enc_layers": 5}, 1),
])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_loop_rule_is_exact(arch, seq, over, microbatches, kind,
                            monkeypatch):
    """The shortened count against every iteration run, at the step level
    (loops nested in the shortened layer and microbatch loops too), at
    every model loop that is a ``Loop``."""
    cfg = dataclasses.replace(get_config(arch), **over)
    shape = ShapeConfig("t", seq, 4, kind)
    shortened, init = [], ucost.Loop.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        shortened.append(self.short)

    monkeypatch.setattr(ucost.Loop, "__init__", spy)
    counts = []
    for short in (True, False):
        monkeypatch.setattr(dryrun, "count", lambda *a, _short=short, **k:
                            cost.count(*a, shortcut=_short, **k))
        counts.append(dryrun.count_step(cfg, shape,
                                        microbatches=microbatches))
        assert any(shortened) == short  # the case shortens a loop
        shortened.clear()
    _assert_same(*counts)


@pytest.mark.parametrize("grad", [True, False])
def test_mlstm_chunk_loop_rule_is_exact(grad):
    """The mLSTM chunk loop (6 chunks of 16), with and without autograd
    and a final state, at the function level: its smoke config's 256-row
    chunks would need S ≥ 1280."""
    b, s, h, d = 2, 96, 2, 8
    q, k, v = (torch.empty(b, s, h, d, device=META, requires_grad=grad)
               for _ in range(3))
    i_pre, lf = (torch.empty(b, s, h, device=META) for _ in range(2))

    def run(q, k, v, i_pre, lf):
        hs, state = mlstm_chunked(q, k, v, i_pre, lf, chunk=16,
                                  final_state=not grad)
        if grad:
            return torch.autograd.grad(hs.sum(), (q, k, v))
        return hs, state

    with torch.set_grad_enabled(grad):
        _assert_same(*_both(run, q, k, v, i_pre, lf))


# --------------------------------------------------------------------------
# B3 and B8 on the meta device and under the counter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 8, 17, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_meta_and_work(m, dtype):
    k, n, r = 96, 160, 8
    x, w, a, b = (torch.empty(shp, dtype=dtype, device=META)
                  for shp in ((m, k), (k, n), (k, r), (r, n)))
    before = lm.lora_matmul.launches
    y = lm.lora_matmul(x, w, a, b, 2.0)
    assert y.device == META and y.shape == (m, n) and y.dtype == torch.float32
    assert lm.lora_matmul.launches == before
    c = cost.count(lm.lora_matmul, x, w, a, b, 2.0)
    want = ucost.lora_matmul_work(m, k, n, r, x.element_size())
    assert (c.flops, c.bytes_accessed) == want
    # the CUDA path's allocations: y, and above 16 rows the work buffer
    work = 0
    if m > lm.SKINNY_ROWS:
        body = lm._body(m, k, n, dtype == torch.bfloat16, True)
        work = 4 * lm._work_floats(m, n, r, 0, k if body == "tensor-core"
                                   else 0)
    assert c.peak_bytes == c.argument_bytes + 4 * m * n + work
    # on the CPU the plain path's ops are replaced by the same formula
    xc, wc, ac, bc = (torch.randn(t.shape).to(dtype) for t in (x, w, a, b))
    c = cost.count(lm.lora_matmul, xc, wc, ac, bc, 2.0)
    assert (c.flops, c.bytes_accessed) == want


@pytest.mark.parametrize("causal,window,sk", [(True, 0, 0), (True, 24, 0),
                                              (False, 0, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_meta_and_work(causal, window, sk, dtype):
    b, s, h, kvh, d = 2, 100, 4, 2, 64
    sk = sk or s
    q = torch.empty(b, s, h, d, dtype=dtype, device=META)
    kv = torch.empty(b, sk, kvh, d, dtype=dtype, device=META)
    out = fs.swa_attention(q, kv, kv, causal, window)
    assert out.device == META and out.shape == q.shape and out.dtype == dtype
    pairs = ucost.attention_pairs(s, sk, causal, window)
    mask = fs._mask(s, sk, causal, window, "cpu")
    assert pairs == int(mask.sum())
    want = ucost.attention_work(b, s, sk, h, kvh, d, causal, window,
                               q.element_size())
    assert want[0] == 4 * b * h * d * pairs
    c = cost.count(fs.swa_attention, q, kv, kv, causal, window)
    assert (c.flops, c.bytes_accessed) == want
    # the CUDA path allocates the output only: no S × S scores
    assert c.peak_bytes == c.argument_bytes + q.numel() * q.element_size()
    qf, kvf = q.reshape(b * h, s, d), torch.empty(b * h, sk, d, dtype=dtype,
                                                  device=META)
    assert fs.flash_swa(qf, kvf, kvf, causal, window).shape == qf.shape
    c = cost.count(fs.flash_swa, qf, kvf, kvf, causal, window)
    assert (c.flops, c.bytes_accessed) == ucost.attention_work(
        b * h, s, sk, 1, 1, d, causal, window, q.element_size())
    # CPU: the plain version runs, the formula counts
    qc, kc = torch.randn(q.shape).to(dtype), torch.randn(kv.shape).to(dtype)
    c = cost.count(fs.swa_attention, qc, kc, kc, causal, window)
    assert (c.flops, c.bytes_accessed) == want


def test_counter_is_per_thread():
    """A counter counts its own thread's kernel calls only (the HTTP
    service runs steps on other threads)."""
    g = torch.Generator().manual_seed(0)
    x, w, a, b = (torch.randn(shp, generator=g)
                  for shp in ((8, 16), (16, 24), (16, 4), (4, 24)))
    seen = []

    def other():
        seen.append((ucost.LOCAL.mode, lm.lora_matmul(x, w, a, b, 2.0)))

    with cost.CostMode() as mode:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert ucost.LOCAL.mode is mode
    assert ucost.LOCAL.mode is None
    assert seen[0][0] is None and (mode.flops, mode.bytes) == (0, 0)
    torch.testing.assert_close(seen[0][1],
                               lm.lora_matmul_plain(x, w, a, b, 2.0),
                               rtol=0, atol=0)


def test_counter_counts_matmuls_and_bytes():
    """A plain op: FLOPs by flop_counter's formula, bytes operands plus
    outputs, views free; peak the live storages."""
    x = torch.empty(64, 32, device=META)
    w = torch.empty(32, 16, device=META)
    c = cost.count(lambda x, w: (x @ w).t().contiguous(), x, w)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16) \
        + 2 * 4 * 64 * 16
    assert c.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert c.output_bytes == 4 * 64 * 16
    assert c.peak_bytes == c.argument_bytes + 2 * 4 * 64 * 16
    cfg = get_config("paper-tiny")
    p = {"up_proj": {"kernel": torch.empty(128, 256, device=META)},
         "gate_proj": {"kernel": torch.empty(128, 256, device=META)},
         "down_proj": {"kernel": torch.empty(256, 128, device=META)}}
    with torch.inference_mode():  # composite ops decompose under the counter
        c = cost.count(lambda p, x: mlp_block(cfg, p, x), p,
                       torch.empty(4, 128, device=META))
    assert c.flops == 3 * 2 * 4 * 128 * 256


# --------------------------------------------------------------------------
# make_train_step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    jcfg = dataclasses.replace(jax_get_config("paper-tiny"), dtype="float32")
    cfg = dataclasses.replace(get_config("paper-tiny"), dtype="float32")
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jl, l = JLoRAConfig(rank=4, alpha=8.0), LoRAConfig(rank=4, alpha=8.0)
    jparams = jmodel.init(jax.random.key(0))
    from repro.core.lora import init_lora as jinit_lora
    from repro.optim import init_adamw as jinit_adamw
    jlora = jinit_lora(jax.random.key(1), jparams, jcfg, jl)
    rng = np.random.default_rng(0)
    b, s = 4, 32
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    tc = dict(total_steps=100, warmup_ratio=0.02, learning_rate=3e-3)
    step = 5
    want = jax.jit(jsteps.make_train_step(jmodel, jl, JTrainConfig(**tc),
                                          microbatches))(
        jparams, jlora, jinit_adamw(jlora),
        {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
         "loss_mask": jnp.asarray(mask)}, jnp.int32(step))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    lora = params_from_numpy(jax.tree.map(np.asarray, jlora), "cpu")
    got = steps.make_train_step(model, l, TrainConfig(**tc), microbatches)(
        params, lora, init_adamw(lora),
        {"tokens": torch.from_numpy(tokens),
         "targets": torch.from_numpy(targets),
         "loss_mask": torch.from_numpy(mask)}, step)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)
    lr = TrainConfig(**tc).learning_rate
    for tree_got, tree_want in ((got[0], want[0]), (got[1].mu, want[1].mu),
                                (got[1].nu, want[1].nu)):
        gf = flatten_with_paths(to_numpy(tree_got))
        wf = _jflat(jax.tree.map(np.asarray, tree_want))
        assert list(gf) == list(wf)
        for k, w in wf.items():
            diff = gf[k] - w
            assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(w) + 1e-7, k
        if tree_got is got[0]:
            for k, w in wf.items():
                assert np.abs(gf[k] - w).max() <= 2 * lr, k
    assert got[1].step == 1


# --------------------------------------------------------------------------
# the dry run in process
# --------------------------------------------------------------------------

def _reference_record_keys():
    """The keys the reference's ``run_one`` writes into an ok record and
    into its ``memory`` / ``roofline`` dicts, read off its source."""
    src = inspect.getsource(jdryrun.run_one)
    top = set(re.findall(r'rec\["(\w+)"\]', src)) | {
        "arch", "shape", "mesh", "moe_impl"}
    memory = set(re.findall(r'"(\w+_bytes)": getattr', src))
    block = src[src.index('rec["roofline"] = {'):]
    roof = set(re.findall(r'^\s+"(\w+)":', block[:block.index("}")],
                          re.M))
    return top, memory, roof


def test_dry_run_in_process(capsys):
    """At paper-tiny, one shape of each kind: the reference's record keys
    (less the XLA compile's: lower / compile seconds, XLA's own FLOP count
    and generated code; plus ``count_s`` and ``fits``), its skip reason,
    and exit code 0."""
    top, memory, roof = _reference_record_keys()
    xla_only = {"lower_s", "compile_s", "xla_cost_flops", "cost_error",
                "error", "traceback", "reason"}
    for shape in ("prefill_32k", "decode_32k", "long_500k", "train_4k"):
        recs = dryrun.main(["--arch", "paper-tiny", "--shape", shape])
        assert len(recs) == 1
        rec = recs[0]
        want_skip = jdryrun.should_skip(jax_get_config("paper-tiny"),
                                        jax_get_shape(shape))
        if want_skip:
            assert rec["status"] == "skipped" and rec["reason"] == want_skip
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert set(rec) == (top - xla_only) | {"count_s", "fits"}
        assert set(rec["memory"]) == memory - {"generated_code_bytes"}
        assert set(rec["roofline"]) == roof
        assert rec["mesh"] == "1xH100" and rec["roofline"]["collective_s"] == 0
        assert rec["memory"]["temp_bytes"] >= 0
    assert "dry-run summary: 0 ok, 1 skipped, 0 failed / 1 total" in \
        capsys.readouterr().out


# --------------------------------------------------------------------------
# the helpers
# --------------------------------------------------------------------------

def test_registry_matches_reference():
    mine, ref = Registry("configs"), JRegistry("configs")
    for reg in (mine, ref):
        @reg.register("tiny")
        def tiny():
            return {"d_model": 8}
        reg.register("b")(object())
    assert mine.get("tiny")()["d_model"] == ref.get("tiny")()["d_model"] == 8
    assert list(mine) == list(ref) and mine.names() == ref.names()
    assert ("tiny" in mine) and ("tiny" in ref)
    for call in (lambda r: r.get("nope"),
                 lambda r: r.register("tiny")(object())):
        with pytest.raises(KeyError) as got:
            call(mine)
        with pytest.raises(KeyError) as want:
            call(ref)
        assert str(got.value) == str(want.value)


def test_metric_logger_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_LOGLEVEL", "WARNING")
    rows = {}
    for name, mod in (("port", tlogging), ("ref", jlogging)):
        log = mod.MetricLogger(str(tmp_path / f"{name}.csv"),
                               logger_name=f"dryrun-test-{name}")
        assert log.logger.level == 30  # REPRO_LOGLEVEL
        log.log(0, {"loss": 1.5})
        log.log(1, {"loss": 1.25, "eval_acc": 0.5})  # a new key: rewrite
        log.log(2, {"loss": 1.0})
        log.close()
        with open(tmp_path / f"{name}.csv") as f:
            rows[name] = [{k: v for k, v in r.items() if k != "wall_s"}
                          for r in csv.DictReader(f)]
        assert [h["step"] for h in log.history] == [0, 1, 2]
    assert rows["port"] == rows["ref"]
    assert rows["port"][0]["eval_acc"] == "" and len(rows["port"]) == 3
