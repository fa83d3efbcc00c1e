"""The port's configs, data, model, LoRA and optimizer against the JAX
reference, from the same numpy-made inputs and the reference's own draws
(carried across with ``repro_torch.bridge``).

Tolerances (f32 on the CPU, two frameworks that sum in other orders):
logits and loss rtol 1e-5 of their scale; LoRA gradients within 1e-5 of
each leaf's largest entry; parameters after K local steps within
atol 1e-5 (2e-3 of one AdamW step at lr 5e-3) — AdamW normalises each
element's step, so near-zero gradient entries pass f32 noise through at up
to lr scale, and a tighter bound would hold the noise, not the port.
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
from repro.core.federated import make_local_step as jax_local_step  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.core.lora import merge_lora as jax_merge_lora  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import flash_attention as jax_flash  # noqa: E402
from repro.optim import adamw_update as jax_adamw  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim import init_adamw as jax_init_adamw  # noqa: E402
from repro.optim import lr_at as jax_lr_at  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core.federated import make_local_step  # noqa: E402
from repro_torch.core.lora import init_lora, merge_lora  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.optim import (adamw_update, clip_by_global_norm,  # noqa: E402
                               init_adamw, lr_at)
from repro_torch.util.tree import (count_params,  # noqa: E402
                                   flatten_with_paths, unflatten_from_paths)

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny(vocab=64):
    return dataclasses.replace(jax_get_config("paper-tiny"), vocab_size=vocab,
                               dtype="float32")


def _gqa2(vocab=64):
    """2 layers, 8 query heads over 2 KV heads, Llama-3.2's RoPE θ."""
    return dataclasses.replace(_tiny(vocab), name="gqa-2l", num_layers=2,
                               num_heads=8, num_kv_heads=2, head_dim=32,
                               d_ff=192, rope_theta=500_000.0)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


# --------------------------------------------------------------------------
# configs, trees, data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["paper-tiny", "paper-gpt2",
                                  "paper-gpt2-smoke", "paper-llama3.2-3b",
                                  "paper-llama3.2-3b-smoke", "qwen2.5-3b",
                                  "qwen2.5-3b-smoke"])
def test_configs_are_the_references(name):
    assert (dataclasses.asdict(get_config(name))
            == dataclasses.asdict(jax_get_config(name)))


def test_config_dataclass_defaults_match():
    for port, ref in ((LoRAConfig(), JLoRAConfig()),
                      (TrainConfig(), JTrainConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    port, ref = dataclasses.asdict(FedConfig()), dataclasses.asdict(JFedConfig())
    assert port.pop("engine") == ref.pop("engine") == "auto"
    assert port == ref


def test_unsupported_branch_raises():
    # windowed attention, experts, MLA, the recurrent blocks, whisper's
    # encoder-decoder and internvl2's vision-language stack run in the
    # port; a family the reference does not have is refused by its name
    vlm = _port_cfg(jax_get_config("internvl2-76b"))
    build_model(vlm)
    with pytest.raises(NotImplementedError, match="bogus"):
        build_model(dataclasses.replace(vlm, family="bogus"))


def test_param_paths_line_up_with_the_reference():
    jcfg = _tiny()
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.key(0))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    gen = torch.Generator().manual_seed(0)
    cfg = _port_cfg(jcfg)
    pp = build_model(cfg).init(gen, CPU)
    pl = init_lora(gen, pp, cfg, LoRAConfig())
    for ref, port in ((jp, pp), (jl, pl)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert list(rf) == list(pf)
        assert all(tuple(rf[k].shape) == tuple(pf[k].shape) for k in rf)
        assert count_params(port) == sum(int(np.prod(x.shape))
                                         for x in rf.values())
    flat = flatten_with_paths(pl)
    assert unflatten_from_paths(flat).keys() == pl.keys()


def test_batches_are_bitwise_the_references():
    jl, je = jax_data(64, 3, seed=3, batch_size=4)
    pl, pe = build_federated_data(64, 3, seed=3, batch_size=4, device=CPU)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(a.sequences, b.sequences)
        for _ in range(40):  # wraps the shuffled order more than once
            x, y = a.next_batch(), b.next_batch()
            for k in ("tokens", "targets", "loss_mask"):
                np.testing.assert_array_equal(np.asarray(x[k]), y[k].numpy())
    for x, y in zip(je, pe):
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), y[k].numpy())


# --------------------------------------------------------------------------
# forward / gradients
# --------------------------------------------------------------------------

def _state(jcfg, seed=0):
    """Reference params + a LoRA tree with non-zero b (so every gradient is
    live) + a batch, as numpy."""
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.key(seed))
    jl = jax_init_lora(jax.random.key(seed + 1), jp, jcfg, JLoRAConfig())
    rng = np.random.default_rng(seed)
    jl = jax.tree.map(lambda x: np.asarray(x) + (0.01 * rng.standard_normal(
        x.shape)).astype(np.float32), jl)
    toks = rng.integers(0, jcfg.vocab_size, size=(4, 33))
    return _np(jp), jl, toks


def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


@pytest.mark.parametrize("make_cfg", [_tiny, _gqa2], ids=["paper-tiny", "gqa-2l"])
def test_logits_loss_and_lora_grads(make_cfg):
    jcfg = make_cfg()
    p, l, toks = _state(jcfg)
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jlogits, _ = jax.jit(lambda lo: jm.apply(p, jb, lora=lo,
                                             lora_scale=2.0))(l)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda lo: jm.loss(p, jb, lora=lo, lora_scale=2.0), has_aux=True))(l)

    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    logits = pm.apply(tp, tb, lora=unflatten_from_paths(flat), lora_scale=2.0)
    loss, _ = pm.loss(tp, tb, lora=unflatten_from_paths(flat), lora_scale=2.0)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))

    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k, g in jax_flatten(jgrads).items():
        g = np.asarray(g)
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(g).max(), k


@pytest.mark.parametrize("window", [0, 12])
def test_flash_attention_blocks_fwd_bwd(window):
    """Several KV blocks with a padded tail, GQA 6/2, against the
    reference's custom VJP."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    dout = rng.standard_normal((2, 40, 6, 16)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(jax_flash(q, k, v, True, window, 0, 16) * dout)

    jout = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                     window, 0, 16)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, True, window, 0, 16)
    tg = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# local steps, optimizer, LoRA
# --------------------------------------------------------------------------

def test_k_local_steps_match():
    """Three local steps of a fresh round (b = 0, fresh AdamW state)."""
    jcfg = _tiny()
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    tc = JTrainConfig(learning_rate=5e-3)
    jstep = jax_local_step(jm, 2.0, tc)
    pstep = make_local_step(build_model(_port_cfg(jcfg)), 2.0,
                            TrainConfig(learning_rate=5e-3))
    tp, tl = params_from_numpy(_np(jp), CPU), params_from_numpy(_np(jl), CPU)
    jst, tst = jax_init_adamw(jl), init_adamw(tl)
    rng = np.random.default_rng(5)
    for _ in range(3):
        jb, tb = _batches(rng.integers(0, 64, size=(8, 65)))
        jl, jst, jloss, jgn = jstep(jp, jl, jst, jb, jnp.float32(5e-3))
        tl, tst, tloss, tgn = pstep(tp, tl, tst, tb, 5e-3)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-4)
    ref = jax_flatten(_np(jl))
    for k, x in flatten_with_paths(to_numpy(tl)).items():
        np.testing.assert_allclose(x, ref[k], rtol=0, atol=1e-5)


def test_adamw_clip_and_schedule_match():
    rng = np.random.default_rng(6)
    tree = {"x": {"a": rng.standard_normal((3, 5)).astype(np.float32),
                  "b": rng.standard_normal((5, 2)).astype(np.float32)}}
    grads = jax.tree.map(lambda x: x * 3.0, tree)
    jg, jn = jax_clip(grads, 1.0)
    tg, tn = clip_by_global_norm(params_from_numpy(grads, CPU), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jst, tst = jax_init_adamw(tree), init_adamw(params_from_numpy(tree, CPU))
    jp, tp = tree, params_from_numpy(tree, CPU)
    for _ in range(3):
        jp, jst = jax_adamw(jg, jst, jp, learning_rate=jnp.float32(1e-2))
        tp, tst = adamw_update(tg, tst, tp, learning_rate=1e-2)
    ref = jax_flatten(_np(jp))
    for k, x in flatten_with_paths(to_numpy(tp)).items():
        np.testing.assert_allclose(x, ref[k], rtol=1e-6, atol=1e-7)
    for kind in ("cosine", "linear", "constant"):
        for step in (0, 1, 7, 50, 99):
            kw = dict(base_lr=3e-3, total_steps=100, warmup_ratio=0.05,
                      kind=kind)
            np.testing.assert_allclose(lr_at(step, **kw),
                                       float(jax_lr_at(step, **kw)), rtol=1e-6)


def test_init_lora_structure_and_merge():
    jcfg = _tiny()
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    lcfg = LoRAConfig(include_mlp=True)
    jl = _np(jax_init_lora(jax.random.key(1), jp, jcfg,
                           JLoRAConfig(include_mlp=True)))
    gen = torch.Generator().manual_seed(0)
    tl = init_lora(gen, params_from_numpy(jp, CPU), _port_cfg(jcfg), lcfg)
    rf, pf = jax_flatten(jl), flatten_with_paths(tl)
    assert list(rf) == list(pf)
    assert all(not x.any() for k, x in pf.items() if k.endswith("/b"))
    assert 0.015 < float(pf["layers/attn/q_proj/a"].std()) < 0.025
    rng = np.random.default_rng(7)
    jl = jax.tree.map(lambda x: x + 0.01 * rng.standard_normal(x.shape)
                      .astype(np.float32), jl)
    ref = jax_flatten(_np(jax_merge_lora(jp, jl, 2.0)))
    got = flatten_with_paths(to_numpy(merge_lora(
        params_from_numpy(jp, CPU), params_from_numpy(jl, CPU), 2.0)))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)
