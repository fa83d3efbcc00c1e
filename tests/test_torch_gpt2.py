"""The port's ``paper-gpt2`` branch of the dense model — LayerNorm, the
tanh-GELU MLP without a gate, q/k/v and MLP biases, learned positions, no
RoPE — against the JAX reference at ``paper-gpt2-smoke`` (2 layers, d 256,
4 heads of 64, ``max_position_embeddings`` 4096; vocab 512, or 64 for the
trainers), and ``qwen2.5-3b-smoke`` (q/k/v biases under RMSNorm, no MLP
bias). Both frameworks run the same numpy-made inputs from the reference's
draws (carried across with ``repro_torch.bridge``), after every bias, every
LayerNorm scale and bias and ``pos_embed``'s first rows are drawn away from
their init from a seeded numpy generator: the reference initialises biases
and norm biases to zero, and with zeros a missing bias term or a swapped
norm would pass.

Tolerances (f32 on the CPU, two frameworks that sum in other orders):
* ``apply_norm("layernorm")`` and ``activation("gelu")``: f32 within 1e-6
  relative (atol 1e-6 of the output's scale); bf16 norms within one bf16
  step (2⁻⁷ relative), bf16 GELU within one step of its input's magnitude
  (torch rounds GELU's f32 value once, XLA each op, and 1 + tanh cancels
  in the negative tail). Torch's default erf GELU is ≈ 4.7e-4 off, so the
  f32 bound catches it.
* the training forward, as ``tests/test_torch_model.py``: logits and loss
  rtol 1e-5 of their scale; LoRA gradients within 1e-5 of each leaf's
  largest entry; K local steps' adapters within atol 1e-5.
* the trainers, round by round, as ``tests/test_torch_federated.py``: eval
  and client losses rtol 1e-5, the §6 divergence rtol 1e-3, W0 and the
  global adapters by relative Frobenius error ≤ 1e-2 and the AdamW
  separation bound. Every leaf that is not adapted (biases, norms,
  ``pos_embed``, the tied embedding) is bitwise what it was before each
  close.
* serving, as ``tests/test_torch_serve.py``: prefill logits rtol / atol
  1e-4, decode logits rtol 5e-3, atol 8e-3 (the bf16 cache); greedy tokens
  agree wherever the reference's top-2 margin exceeds 2 × atol.
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
from repro.core.federated import make_local_step as jax_local_step  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.data import make_batch_for as jax_make_batch_for  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.federated import make_local_step  # noqa: E402
from repro_torch.core.lora import init_lora  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
SCALE = 2.0  # α / r = 8 / 4
LR, STEPS, CLIENTS, ROUNDS, VOCAB = 5e-3, 3, 3, 2, 64
TRAIN = dict(learning_rate=LR, schedule="constant", total_steps=ROUNDS * STEPS)
PROMPT, DECODE, MAX_LEN = 16, 8, 32
P_TOL = dict(rtol=1e-4, atol=1e-4)
D_TOL = dict(rtol=5e-3, atol=8e-3)
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several workers on a few cores,
    where a multi-threaded op waits at every barrier for parked threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(name="paper-gpt2-smoke", **kw):
    return dataclasses.replace(jax_get_config(name), dtype="float32", **kw)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


def _frozen(path: str) -> bool:
    """A leaf no adapter touches and that the bridge must carry exactly:
    biases, norm scales and biases, learned positions."""
    return (path.endswith("/bias") or "norm/" in path
            or path.startswith("pos_embed/"))


def _perturb(params, seed=11):
    """Draw every bias, every norm scale and bias, and ``pos_embed``'s first
    64 rows away from their init (numpy, seeded); other leaves as they
    are."""
    rng = np.random.default_rng(seed)
    flat = jax_flatten(_np(params))
    for path, x in flat.items():
        if path.startswith("pos_embed/"):
            x = x.copy()
            x[:64] = 0.1 * rng.standard_normal(x[:64].shape)
        elif path.endswith("/scale"):
            x = 1.0 + 0.2 * rng.standard_normal(x.shape)
        elif _frozen(path):
            x = 0.1 * rng.standard_normal(x.shape)
        flat[path] = np.asarray(x, np.float32)
    return unflatten_from_paths(flat)


def _state(jcfg, include_mlp=False, seed=0):
    """Perturbed reference params, an adapter with non-zero b, as numpy."""
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.key(seed))
    jl = jax_init_lora(jax.random.key(seed + 1), jp, jcfg,
                       JLoRAConfig(include_mlp=include_mlp))
    rng = np.random.default_rng(seed)
    jl = jax.tree.map(lambda x: np.asarray(x) + (0.02 * rng.standard_normal(
        x.shape)).astype(np.float32), jl)
    return _perturb(jp), jl


# --------------------------------------------------------------------------
# trees and primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("include_mlp", [False, True], ids=["qkvo", "mlp"])
def test_param_and_adapter_trees_line_up(include_mlp):
    jcfg = _jcfg()
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.key(0))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg,
                       JLoRAConfig(include_mlp=include_mlp))
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(0)
    pp = build_model(cfg).init(gen, CPU)
    pl = init_lora(gen, pp, cfg, LoRAConfig(include_mlp=include_mlp))
    for ref, port in ((jp, pp), (jl, pl)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert list(rf) == list(pf)
        assert all(tuple(rf[k].shape) == tuple(pf[k].shape) for k in rf)
    params = flatten_with_paths(pp)
    for path in ("pos_embed/embedding", "layers/attn/q_proj/bias",
                 "layers/attn/k_proj/bias", "layers/attn/v_proj/bias",
                 "layers/mlp/up_proj/bias", "layers/mlp/down_proj/bias",
                 "layers/attn_norm/bias", "layers/mlp_norm/bias",
                 "final_norm/bias"):
        assert path in params, path
    assert params["pos_embed/embedding"].shape == (4096, 256)
    assert "layers/attn/o_proj/bias" not in params
    assert not any("gate_proj" in k for k in params)
    adapted = {k.rsplit("/", 2)[-2] for k in flatten_with_paths(pl)}
    mlp = {"up_proj", "down_proj"} if include_mlp else set()
    assert adapted == {"q_proj", "k_proj", "v_proj", "o_proj"} | mlp
    for k, x in params.items():  # the port's own draws: zero biases
        if k.endswith("/bias"):
            assert not x.any(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_is_the_references(kind, dtype):
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((64, 256)) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    tp = {"scale": torch.from_numpy(scale).to(tdt),
          "bias": torch.from_numpy(bias).to(tdt)}
    want = np.asarray(jax_common.apply_norm(kind, jp, jnp.asarray(x, jdt))
                      .astype(jnp.float32))
    got = common.apply_norm(kind, tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= BF16_STEP * np.abs(want)).all()
    if kind == "layernorm" and dtype == "float32":
        # torch.var's default (unbiased) variance would be another norm
        xf = torch.from_numpy(x)
        unbiased = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
            xf.var(-1, keepdim=True) + 1e-6)
        off = unbiased * torch.from_numpy(scale) + torch.from_numpy(bias)
        assert np.abs(off.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_references_tanh_form(dtype):
    x = np.linspace(-6.0, 6.0, 10_001).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_common.activation("gelu", jnp.asarray(x, jdt))
                      .astype(jnp.float32))
    got = common.activation("gelu", torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        atol = 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
        erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(erf - want).max() > 1e-5  # the wrong form is caught
    else:
        # XLA rounds tanh to bf16 before 1 + tanh, which cancels in the
        # negative tail (gelu(−3.06) is 0 there, −3.0e-3 in torch): one bf16
        # step of the input's magnitude
        xb = torch.from_numpy(x).to(tdt).float().numpy()
        assert (np.abs(got - want) <= BF16_STEP * np.abs(xb)).all()
    with pytest.raises(ValueError, match="unknown activation"):
        common.activation("relu", torch.from_numpy(x))


# --------------------------------------------------------------------------
# training forward, gradients, local steps
# --------------------------------------------------------------------------

def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


@pytest.mark.parametrize("name,include_mlp", [
    ("paper-gpt2-smoke", False), ("paper-gpt2-smoke", True),
    ("qwen2.5-3b-smoke", False)], ids=["gpt2", "gpt2-mlp", "qwen2.5"])
def test_logits_loss_and_lora_grads(name, include_mlp):
    jcfg = _jcfg(name)
    p, l = _state(jcfg, include_mlp)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 33))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jlogits, _ = jax.jit(lambda lo: jm.apply(p, jb, lora=lo,
                                             lora_scale=SCALE))(l)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda lo: jm.loss(p, jb, lora=lo, lora_scale=SCALE),
        has_aux=True))(l)

    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    logits = pm.apply(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE)
    loss, _ = pm.loss(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))

    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k, g in jax_flatten(jgrads).items():
        g = np.asarray(g)
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(g).max(), k


def test_k_local_steps_match():
    """Three local steps of a fresh round (b = 0, fresh AdamW state)."""
    jcfg = _jcfg(vocab_size=VOCAB)
    jm = jax_build_model(jcfg)
    jp = _perturb(jax.jit(jm.init)(jax.random.key(0)))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    jstep = jax_local_step(jm, SCALE, JTrainConfig(learning_rate=LR))
    pstep = make_local_step(build_model(_port_cfg(jcfg)), SCALE,
                            TrainConfig(learning_rate=LR))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(_np(jl), CPU)
    from repro.optim import init_adamw as jax_init_adamw
    from repro_torch.optim import init_adamw
    jst, tst = jax_init_adamw(jl), init_adamw(tl)
    rng = np.random.default_rng(5)
    for _ in range(3):
        jb, tb = _batches(rng.integers(0, VOCAB, size=(8, 65)))
        jl, jst, jloss, jgn = jstep(jp, jl, jst, jb, jnp.float32(LR))
        tl, tst, tloss, tgn = pstep(tp, tl, tst, tb, LR)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-4)
    ref = jax_flatten(_np(jl))
    for k, x in flatten_with_paths(to_numpy(tl)).items():
        np.testing.assert_allclose(x, ref[k], rtol=0, atol=1e-5)


def test_prefill_longer_than_the_position_table_raises():
    cfg = _port_cfg(_jcfg(max_position_embeddings=16))
    pm = build_model(cfg)
    params = pm.init(torch.Generator().manual_seed(0), CPU)
    toks = torch.zeros(1, 17, dtype=torch.int64)
    with pytest.raises(ValueError, match="max_position_embeddings=16"):
        pm.apply(params, {"tokens": toks})
    with torch.inference_mode(), pytest.raises(
            ValueError, match="max_position_embeddings"):
        pm.prefill(params, {"tokens": toks}, pm.init_cache(1, 32, device=CPU))
    assert pm.apply(params, {"tokens": toks[:, :16]}).shape == (1, 16, 512)


# --------------------------------------------------------------------------
# the trainers, round by round
# --------------------------------------------------------------------------

def _trainers(**fed_kw):
    """The reference's trainer (Pallas engine, interpret mode on the CPU)
    and the port's, both from the reference's draws with the frozen leaves
    perturbed."""
    fed = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS, **fed_kw)
    jcfg = _jcfg(vocab_size=VOCAB)
    jl, je = jax_data(VOCAB, CLIENTS, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="pallas", **fed),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je, seed=0)
    p0 = _perturb(jt.params)
    jt.params = jax.tree.map(jnp.asarray, p0)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seed=0, device=CPU)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**TRAIN),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(p0, CPU),
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


def _untouched(params):
    """Clones of every leaf that no close may move: all but the adapted
    kernels (the tied embedding included)."""
    adapted = ("q_proj/kernel", "k_proj/kernel", "v_proj/kernel",
               "o_proj/kernel")
    return {k: v.clone() for k, v in flatten_with_paths(params).items()
            if not k.endswith(adapted)}


@pytest.mark.parametrize("fed_kw", [
    {},
    {"weighting": "examples", "participation": 0.5},
    {"method": "fedit"},
    {"method": "ffa"},
], ids=["fedex", "fedex-examples-50%", "fedit", "ffa"])
def test_trainer_matches_reference_round_by_round(fed_kw):
    jt, pt = _trainers(**fed_kw)
    frozen = _untouched(pt.params)
    assert any(k.endswith("/bias") for k in frozen)
    assert "embed/embedding" in frozen and "pos_embed/embedding" in frozen
    for rnd in range(ROUNDS):
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
        assert pt.outcomes[-1].weights == jt.outcomes[-1].weights
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3,
                                   atol=1e-9)
        _assert_trees_close(jt.params, pt.params)
        _assert_trees_close(jt.global_lora, pt.global_lora)
        now = flatten_with_paths(pt.params)
        for k, x in frozen.items():
            assert torch.equal(now[k], x), k
    if fed_kw.get("participation"):
        assert all(len(o.client_ids) == 2 for o in pt.outcomes)


def test_keep_local_bases_copy_the_frozen_leaves():
    """keep_local's per-client bases: each client's folded W0 moves, every
    other leaf stays bitwise what it was."""
    cfg = _port_cfg(_jcfg(vocab_size=VOCAB))
    pl, pe = build_federated_data(VOCAB, CLIENTS, seed=0, device=CPU)
    params = params_from_numpy(
        _perturb(jax.jit(jax_build_model(_jcfg(vocab_size=VOCAB)).init)(
            jax.random.key(0))), CPU)
    lora = init_lora(torch.Generator().manual_seed(1), params, cfg,
                     LoRAConfig())
    pt = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(num_clients=CLIENTS, rounds=1, local_steps=STEPS,
                          assignment="keep_local"),
        train_cfg=TrainConfig(**TRAIN), client_loaders=pl, eval_batches=pe,
        seed=0, device=CPU, params=params, global_lora=lora)
    frozen = _untouched(pt.params)
    pt.run()
    for base in pt.client_params:
        flat = flatten_with_paths(base)
        for k, x in frozen.items():
            assert torch.equal(flat[k], x), k
        assert not torch.equal(flat["layers/attn/q_proj/kernel"],
                               pt.params["layers"]["attn"]["q_proj"]["kernel"])


def test_train_launcher_runs_gpt2_on_the_cpu(capsys):
    port_train.main(["--device", "cpu", "--arch", "paper-gpt2-smoke",
                     "--vocab", "64", "--clients", "2", "--rounds", "1",
                     "--local-steps", "2", "--batch-size", "2", "--seq-len",
                     "16", "--weighting", "examples", "--include-mlp"])
    out = capsys.readouterr().out
    assert "final: method=fedex" in out and "close backend=plain" in out


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_prefill_and_decode_match_the_reference():
    """Prefill t[:16], then 8 teacher-forced decode steps, in both
    frameworks from the same perturbed params and adapter (q/k/v/o and the
    MLP adapted: serving runs every adapted projection through
    ``lora_dense``, bias after it)."""
    jcfg = _jcfg()
    p, l = _state(jcfg, include_mlp=True)
    lcfg = JLoRAConfig(include_mlp=True)
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             size=(2, PROMPT + DECODE))
    jpre = jax.jit(jax_prefill_step(jm, lcfg))
    jdec = jax.jit(jax_decode_step(jm, lcfg))
    jlog, jc = jpre(p, l, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                    jm.init_cache(2, MAX_LEN))

    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    pcfg = LoRAConfig(include_mlp=True)
    pre, dec = make_prefill_step(pm, pcfg), make_decode_step(pm, pcfg)
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, device=CPU)
        tlog, cache = pre(tp, tl, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **P_TOL)
        for i in range(DECODE):
            pos = PROMPT + i
            tok = toks[:, pos:pos + 1]
            jnext, jl_i, jc = jdec(p, l, jnp.asarray(tok, jnp.int32), jc,
                                   jnp.asarray(pos, jnp.int32))
            tnext, tl_i, cache = dec(tp, tl, torch.as_tensor(tok), cache, pos)
            jl_i = np.asarray(jl_i)
            np.testing.assert_allclose(tl_i.numpy(), jl_i, **D_TOL)
            top2 = np.sort(jl_i[:, -1], axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * D_TOL["atol"]
            np.testing.assert_array_equal(tnext.numpy()[sure],
                                          np.asarray(jnext)[sure])


def test_decode_past_the_position_table_clamps_as_the_reference():
    """``max_position_embeddings`` 16, a cache of 32: decode steps at
    positions 8–23 add row min(position, 15) of the table, while the cache
    slot and the mask take the position itself."""
    jcfg = _jcfg(max_position_embeddings=16)
    p, l = _state(jcfg)
    jm = jax_build_model(jcfg)
    jp = JLoRAConfig()
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             size=(2, 24))
    jlog, jc = jax.jit(jax_prefill_step(jm, jp))(
        p, l, {"tokens": jnp.asarray(toks[:, :8])}, jm.init_cache(2, 32))
    jdec = jax.jit(jax_decode_step(jm, jp))
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    with torch.inference_mode():
        cache = pm.init_cache(2, 32, device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8])},
                                 cache, lora=tl, lora_scale=SCALE)
        np.testing.assert_allclose(tlog[:, -1].numpy(),
                                   np.asarray(jlog)[:, -1], **P_TOL)
        for pos in range(8, 24):
            tok = toks[:, pos:pos + 1]
            _, jl_i, jc = jdec(p, l, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32))
            tl_i, cache = pm.decode_step(tp, torch.as_tensor(tok), cache, pos,
                                         lora=tl, lora_scale=SCALE)
            np.testing.assert_allclose(tl_i.numpy(), np.asarray(jl_i),
                                       **D_TOL)
        np.testing.assert_array_equal(cache["layers"]["pos"][0, :24],
                                      list(range(24)))


@pytest.mark.parametrize("arch", ["paper-gpt2-smoke", "qwen2.5-3b-smoke"])
def test_serve_end_to_end_matches_the_reference_greedy_loop(arch):
    """``serve(device="cpu")`` on the bridged params and non-zero adapter
    generates the reference's greedy tokens (compared up to the first step
    whose reference top-2 margin is within 2 × atol)."""
    jcfg = _jcfg(arch)
    p, l = _state(jcfg)
    res = serve_mod.serve(arch, batch_size=2, prompt_len=PROMPT,
                          steps=DECODE, max_len=MAX_LEN, seed=0, device="cpu",
                          params=params_from_numpy(p, CPU),
                          lora=params_from_numpy(l, CPU),
                          dtype=torch.float32)
    assert res.tokens.shape == (2, DECODE + 1)
    lcfg = JLoRAConfig()
    jm = jax_build_model(jcfg)
    batch = jax_make_batch_for(jcfg, 2, PROMPT, seed=0)
    logits, cache = jax.jit(jax_prefill_step(jm, lcfg))(
        p, l, batch, jm.init_cache(2, MAX_LEN))
    dec = jax.jit(jax_decode_step(jm, lcfg))
    live, compared = np.ones(2, bool), 0
    for i in range(DECODE + 1):
        last = np.asarray(logits)[:, -1]
        top2 = np.sort(last, axis=-1)[:, -2:]
        live &= top2[:, 1] - top2[:, 0] > 2 * D_TOL["atol"]
        tok = np.argmax(last, axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(res.tokens[live, i], tok[live, 0])
        compared += int(live.sum())
        if i < DECODE:
            _, logits, cache = dec(p, l, jnp.asarray(tok), cache,
                                   jnp.asarray(PROMPT + i, jnp.int32))
    assert compared > 0


def test_serve_launcher_runs_gpt2_on_the_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--arch", "paper-gpt2-smoke",
                    "--batch-size", "1", "--prompt-len", "8", "--steps", "2",
                    "--max-len", "16"])
    assert "generated token ids" in capsys.readouterr().out
