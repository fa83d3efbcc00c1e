"""The vlm family in the port (``internvl2-76b``: the dense decoder behind
a prefix of stubbed ViT patch embeddings, projected by ``vision_proj``, a
d × d dense without an adapter) against the JAX reference, in f32 unless a
test says otherwise, at ``internvl2-76b-smoke`` (2 layers, d 256, 4 heads
of 64, MLP 512, vocab 512, 16 vision tokens, an untied head).

* the registry and ``reduced()``; the parameter, adapter and cache trees
  path for path; the bridge carrying ``vision_proj`` and the untied
  ``lm_head``; ``make_batch_for``'s vision embeddings and tokens bit for
  bit, with text past the vision tokens and with a prompt at or below them
  (1 text token);
* the training forward's logits with and without ``vision_embeds``; the
  loss, scored on the text positions only, and its LoRA gradients;
* a prefill over the vision prefix and the text, then 4 decode steps from
  the prefill's true length, with the cache after them; serving's q/k/v/o
  and prefill attentions all through the kernels' wrappers (the
  projector through neither); a bf16 prefill and decode;
* the serve launcher: its tokens are greedy decoding driven through the
  reference's model functions from the prefill's true length, the port's
  one departure from the reference's launcher, which decodes from
  ``prompt_len + vision_tokens``; the reference's position parting from
  teacher forcing where the true length meets it; a prefill plus steps
  longer than the cache refused;
* the host trainer round by round (uniform, then weighted at 50%), once
  with the launcher's tokens-only loaders (internvl2 trained as a
  text-only LM, as the reference's launchers train it) and once with
  loaders that add seeded vision embeddings on both sides; one uniform
  fedex round of the mesh trainer against the reference's (a mesh of Auto
  axes, ``tests/test_torch_mesh.py``); the launchers' host and mesh modes;
* (on a CUDA card, ``tests/test_torch_cuda.py`` holds serving's kernel
  path against its plain path at this config: that file imports no JAX.)

Tolerances are ``tests/test_torch_encdec.py``'s: caches rtol / atol 1e-4
(f32 on both sides, the products contracted in another order); logits
rtol 1e-5 with atol 1e-5 of their largest magnitude (prefill and decode
logits rtol / atol 1e-4), the loss rtol 1e-5, LoRA gradients within 1e-5
of each leaf's largest entry; the trainer's losses rtol 1e-5, divergence
rtol 1e-3, trees by relative Frobenius error ≤ 1e-2 and the AdamW
separation bound 2·lr·steps·clients; bf16 the criterion of
``tests/test_torch_bf16.py`` (twice the reference's bf16 distance from its
f32 answer over the same weights, plus one bf16 rounding at the logit
scale).
"""

import dataclasses
import functools

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
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.data import make_batch_for as jax_make_batch_for  # noqa: E402
from repro.fedsrv import RoundPolicy as JPolicy  # noqa: E402
from repro.launch import mesh_train as jmesh  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.lora import init_lora  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import (MeshFederatedTrainer,  # noqa: E402
                                           check_mesh_supported)
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "internvl2-76b-smoke"
SCALE = 2.0  # α / r = 8 / 4
TOL = dict(rtol=1e-4, atol=1e-4)
VT, D, V = 16, 256, 512  # the smoke config's vision tokens, width, vocab


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


def _jcfg(**kw):
    return dataclasses.replace(jax_get_config(ARCH), dtype="float32", **kw)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


def _perturb(tree, rng):
    """Norm scales drawn away from 1 and every adapter's b non-zero, so a
    missing term would show."""
    out = {}
    for k, x in jax_flatten(tree).items():
        x = np.asarray(x, np.float32)
        if k.endswith("/scale"):
            x = x + 0.2 * rng.standard_normal(x.shape)
        elif k.endswith("/b"):
            x = 0.02 * rng.standard_normal(x.shape)
        out[k] = x.astype(np.float32)
    return unflatten_from_paths(out)


@functools.lru_cache(maxsize=None)
def _draws():
    """The reference's f32 draws, perturbed: params and an adapter."""
    jcfg = _jcfg()
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    jl = _np(jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig()))
    rng = np.random.default_rng(2)
    return _perturb(jp, rng), _perturb(jl, rng)


def _vision(seed, bsz=2, vt=VT, d=D):
    """Patch embeddings as the reference draws them: normal × 0.02, f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, vt, d)) * 0.02).astype(np.float32)


def _batches(toks, vision):
    """(reference batch, port batch) over ``toks`` (B, T + 1); with
    ``vision`` (None: a tokens-only batch)."""
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    if vision is not None:
        jb["vision_embeds"] = jnp.asarray(vision)
        tb["vision_embeds"] = torch.as_tensor(vision)
    return jb, tb


# --------------------------------------------------------------------------
# registry, trees, data
# --------------------------------------------------------------------------

def test_registry_and_reduced_match_the_reference():
    assert "internvl2-76b" in list_configs() and len(list_configs()) == 13
    for name in ("internvl2-76b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        check_supported(get_config(name))
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size, c.vision_tokens, c.norm, c.act, c.rope,
            c.tie_embeddings) == ("vlm", 2, D, 4, 4, 512, V, VT, "rmsnorm",
                                  "silu", True, False)
    full = get_config("internvl2-76b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.vision_tokens, full.rope_theta) == (
        80, 8192, 64, 8, 128, 28_672, 128_256, 256, 500_000.0)


def test_param_adapter_and_cache_trees_line_up():
    """Path for path, shape for shape and (in the config's bf16) dtype for
    dtype: the dense stack, the untied head and ``vision_proj`` (d × d, no
    adapter); 4 adapted leaves, q/k/v/o; the dense cache."""
    jcfg = jax_get_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    jl = jax.eval_shape(lambda p: jax_init_lora(
        jax.random.key(1), p, jcfg, JLoRAConfig()), jp)
    jc = jax.eval_shape(lambda: jm.init_cache(2, 40, jnp.bfloat16))
    pm = build_model(_port_cfg(jcfg))
    gen = torch.Generator().manual_seed(0)
    pp = pm.init(gen, CPU)
    pl = init_lora(gen, pp, pm.cfg, LoRAConfig())
    pc = pm.init_cache(2, 40, torch.bfloat16, device=CPU)
    for ref, port in ((jp, pp), (jl, pl), (jc, pc)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        for k in rf:
            assert tuple(rf[k].shape) == tuple(pf[k].shape), k
            assert str(pf[k].dtype) == f"torch.{rf[k].dtype}", k
    assert tuple(pp["vision_proj"]["kernel"].shape) == (D, D)
    assert tuple(pp["lm_head"]["kernel"].shape) == (D, V)
    assert sorted(pl) == ["layers"]
    assert sorted(pl["layers"]["attn"]) == ["k_proj", "o_proj", "q_proj",
                                            "v_proj"]
    assert len(flatten_with_paths(pl)) == 8
    assert sorted(pc) == ["layers"]
    assert pc["layers"]["k"].shape == (2, 2, 40, 4, 64)


def test_bridge_carries_vision_proj_and_the_untied_head():
    """Every leaf of the reference's tree crosses to the port and back bit
    for bit, ``vision_proj`` and ``lm_head`` among them."""
    jp = _draws()[0]
    back = flatten_with_paths(to_numpy(params_from_numpy(jp, CPU)))
    want = jax_flatten(jp)
    assert sorted(back) == sorted(want)
    for k, x in want.items():
        np.testing.assert_array_equal(back[k], x, err_msg=k)
    assert {"vision_proj/kernel", "lm_head/kernel"} <= set(want)


@pytest.mark.parametrize("arch,bsz,seq,text", [
    (ARCH, 2, 40, 24), (ARCH, 2, VT, 1), (ARCH, 3, 5, 1),
    ("internvl2-76b", 1, 300, 44)], ids=["smoke", "at-vt", "below-vt",
                                         "full"])
def test_make_batch_for_draws_the_references_vision_and_tokens(arch, bsz,
                                                               seq, text):
    """The vision embeddings first, then ``max(1, seq − vision_tokens)``
    text tokens, from one generator: bit for bit the reference's, the mask
    over the text."""
    cfg = get_config(arch)
    want = jax_make_batch_for(jax_get_config(arch), bsz, seq, seed=3)
    got = make_batch_for(cfg, bsz, seq, seed=3, device=CPU)
    assert sorted(got) == sorted(want) == ["loss_mask", "targets", "tokens",
                                           "vision_embeds"]
    assert got["vision_embeds"].dtype == torch.float32
    assert tuple(got["vision_embeds"].shape) == (bsz, cfg.vision_tokens,
                                                 cfg.d_model)
    assert tuple(got["tokens"].shape) == tuple(got["loss_mask"].shape) == (
        bsz, text)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_vision", [True, False],
                         ids=["vision", "tokens-only"])
def test_train_logits_match_the_reference(with_vision):
    """The training forward's logits: (B, 16 + 24, V) over the projected
    prefix and the text, or (B, 24, V) over a tokens-only batch."""
    jcfg = _jcfg()
    jp, jl = _draws()
    toks = np.random.default_rng(3).integers(0, V, size=(2, 25))
    jb, tb = _batches(toks, _vision(7) if with_vision else None)
    jm = jax_build_model(jcfg)
    want = np.asarray(jax.jit(lambda p, lo, b: jm.apply(
        p, b, lora=lo, lora_scale=SCALE)[0])(jp, jl, jb))
    pm = build_model(_port_cfg(jcfg))
    with torch.inference_mode():
        got = pm.apply(params_from_numpy(jp, CPU), tb,
                       lora=params_from_numpy(jl, CPU), lora_scale=SCALE)
    assert tuple(got.shape) == want.shape == (2, 24 + VT * with_vision, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_loss_scores_text_only_and_its_lora_grads_match():
    """The loss over a batch with vision: the CE of the text positions'
    logits alone (``logits[:, 16:]``), the reference's; and its gradients
    with respect to the 8 adapter leaves."""
    jcfg = _jcfg()
    p, l = _draws()
    toks = np.random.default_rng(4).integers(0, V, size=(2, 25))
    jb, tb = _batches(toks, _vision(8))
    jm = jax_build_model(jcfg)
    jloss, jgrads = jax.jit(lambda lo, p, b: jax.value_and_grad(
        lambda x: jm.loss(p, b, lora=x, lora_scale=SCALE)[0])(lo))(l, p, jb)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    lora = unflatten_from_paths(flat)
    loss, met = pm.loss(tp, tb, lora=lora, lora_scale=SCALE)
    assert met["total_loss"] is loss and "aux_loss" not in met
    with torch.no_grad():
        logits = pm.apply(tp, tb, lora=lora, lora_scale=SCALE)
        text = cross_entropy(logits[:, VT:], tb["targets"],
                             tb["loss_mask"])[0]
    assert float(loss.detach()) == float(text)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(grads) and len(jf) == 8
    for k, g in jf.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(
            g).max(), k


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

TEXT, STEPS, MAX_LEN = 8, 4, 32  # the prefill fills VT + TEXT = 24 slots


def _serve_both(jp, jl, toks, vision, cfg=None, cache_dtype=jnp.float32):
    """A prefill of the vision prefix and TEXT tokens, then STEPS
    teacher-forced decode steps at positions VT + TEXT onward, in both
    frameworks (caches in ``cache_dtype``): (reference's logits, port's),
    each the prefill's last position's then every step's, and both caches
    after."""
    jcfg = cfg or _jcfg()
    jm = jax_build_model(jcfg)
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    jlog, jc = jax.jit(lambda p, lo, t, v, c: jm.prefill(
        p, {"tokens": t, "vision_embeds": v}, c, lora=lo,
        lora_scale=SCALE))(jp, jl, jnp.asarray(toks[:, :TEXT]),
                           jnp.asarray(vision),
                           jm.init_cache(2, MAX_LEN, cache_dtype))
    jdec = functools.partial(jax.jit(
        lambda p, lo, t, c, pos: jm.decode_step(p, t, c, pos, lora=lo,
                                                lora_scale=SCALE)), jp, jl)
    ref, port = [np.asarray(jlog, np.float32)[:, -1]], []
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, tdt[cache_dtype], device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :TEXT]), "vision_embeds": torch.as_tensor(vision)},
            cache, lora=tl, lora_scale=SCALE)
        assert tuple(tlog.shape) == (2, VT + TEXT, V)
        port.append(tlog[:, -1].float().numpy())
        for i in range(STEPS):
            tok, pos = toks[:, TEXT + i:TEXT + i + 1], VT + TEXT + i
            jd, jc = jdec(jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(pos, jnp.int32))
            td, cache = pm.decode_step(tp, torch.as_tensor(tok), cache, pos,
                                       lora=tl, lora_scale=SCALE)
            ref.append(np.asarray(jd, np.float32)[:, -1])
            port.append(td[:, -1].float().numpy())
    return ref, port, jc, cache


def test_prefill_with_vision_and_decode_match_the_reference():
    """A prefill of 16 vision + 8 text positions and 4 decode steps from
    position 24, f32 caches: the logits of each and the cache after them
    (28 slots written, the vision prefix's among them)."""
    jp, jl = _draws()
    toks = np.random.default_rng(5).integers(0, V, size=(2, TEXT + STEPS))
    ref, port, jc, cache = _serve_both(jp, jl, toks, _vision(9))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)
    rf, pf = jax_flatten(jc), flatten_with_paths(cache)
    assert sorted(pf) == sorted(rf) == ["layers/k", "layers/pos",
                                        "layers/v"]
    for k, x in rf.items():
        assert str(pf[k].dtype) == f"torch.{x.dtype}", k
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(x), **TOL)
    n = VT + TEXT + STEPS
    np.testing.assert_array_equal(cache["layers"]["pos"][:, :n].numpy(),
                                  np.tile(np.arange(n), (2, 1)))
    assert bool((cache["layers"]["pos"][:, n:] == -1).all())


def test_serving_runs_every_projection_and_attention_through_the_wrappers():
    """In serving every adapted projection goes through the fused LoRA
    kernel's wrapper (``lora_dense``: B3 on the card, its plain version
    here) and every prefill attention through the flash attention
    kernel's (``swa_attention``: B8): a prefill 4 B3 a layer at M = B·(16 +
    8) and one causal B8 at S 24, a decode step 4 B3 a layer at M = B and
    no B8; ``vision_proj`` has no adapter and takes neither, and the
    training forward neither."""
    jp, jl = _draws()
    pm = build_model(_port_cfg(_jcfg()))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, V, (2, 9)))
    vision = torch.as_tensor(_vision(11))
    b3, b8 = [], []
    real_ld, real_swa = pcommon.lora_dense, pattn.swa_attention

    def ld(x, w, a, b, scale):
        b3.append(x.shape[:-1].numel())
        return real_ld(x, w, a, b, scale)

    def swa(q, k, v, causal=True, window=0):
        b8.append((q.shape[1], k.shape[1], causal))
        return real_swa(q, k, v, causal=causal, window=window)

    pcommon.lora_dense, pattn.swa_attention = ld, swa
    try:
        with torch.inference_mode():
            pm.apply(tp, {"tokens": toks, "vision_embeds": vision}, lora=tl,
                     lora_scale=SCALE)
            assert b3 == [] and b8 == []
            cache = pm.init_cache(2, MAX_LEN, torch.float32, device=CPU)
            _, cache = pm.prefill(tp, {"tokens": toks[:, :TEXT],
                                       "vision_embeds": vision}, cache,
                                  lora=tl, lora_scale=SCALE)
            pre, pre8 = list(b3), list(b8)
            pm.decode_step(tp, toks[:, TEXT:], cache, VT + TEXT, lora=tl,
                           lora_scale=SCALE)
            dec, dec8 = b3[len(pre):], b8[len(pre8):]
    finally:
        pcommon.lora_dense, pattn.swa_attention = real_ld, real_swa
    assert pre == [2 * (VT + TEXT)] * 8
    assert pre8 == [(VT + TEXT, VT + TEXT, True)] * 2
    assert dec == [2] * 8 and dec8 == []


def test_bf16_prefill_and_decode_against_the_f32_answer():
    """The config's bf16 (no dtype override), the reference's bf16 draws
    with b ≠ 0, bf16 caches: the port's prefill logits and each decode
    step's no further from the reference's f32 answer over the same
    weights (f32 cache) than twice the reference's own bf16 run, plus one
    bf16 rounding at the logit scale (2⁻⁸ · max |f32 logit|)."""
    cfg = jax_get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jp = _np(jax.jit(jax_build_model(cfg).init)(jax.random.key(3)))
    jl = _perturb(_np(jax_init_lora(jax.random.key(4), jp, cfg,
                                    JLoRAConfig())), np.random.default_rng(5))
    toks = np.random.default_rng(9).integers(0, V, size=(2, TEXT + STEPS))
    vision = _vision(12)
    r16, got, _, cache = _serve_both(jp, jl, toks, vision, cfg=cfg,
                                     cache_dtype=jnp.bfloat16)
    assert cache["layers"]["k"].dtype == torch.bfloat16
    r32 = _serve_both(jax.tree.map(lambda t: t.astype(np.float32), jp), jl,
                      toks, vision, cfg=dataclasses.replace(
                          cfg, dtype="float32"))[0]
    for i, (port, b16, f32) in enumerate(zip(got, r16, r32)):
        bound = 2 * np.abs(b16 - f32).max() + 2.0 ** -8 * np.abs(f32).max()
        err = np.abs(port - f32).max()
        assert err <= bound, (i, err, bound)


# --------------------------------------------------------------------------
# the serve launcher: decode from the prefill's true length
# --------------------------------------------------------------------------

def _reference_greedy(jp, jl, prompt_len, steps, max_len, pos0):
    """Greedy decoding driven through the reference's model functions: its
    ``make_batch_for`` prompt (seed 0), its prefill, then ``steps`` decode
    steps from ``pos0``; the tokens (B, steps + 1) and each step's logits."""
    jcfg = _jcfg()
    jm = jax_build_model(jcfg)
    batch = jax_make_batch_for(jcfg, 2, prompt_len, seed=0)
    logits, cache = jax.jit(lambda p, lo, b, c: jm.prefill(
        p, b, c, lora=lo, lora_scale=SCALE))(
            jp, jl, {k: batch[k] for k in ("tokens", "vision_embeds")},
            jm.init_cache(2, max_len, jnp.float32))
    dec = jax.jit(lambda p, lo, t, c, pos: jm.decode_step(
        p, t, c, pos, lora=lo, lora_scale=SCALE))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks, rows = [tok], []
    for i in range(steps):
        logits, cache = dec(jp, jl, tok, cache,
                            jnp.asarray(pos0 + i, jnp.int32))
        rows.append(np.asarray(logits)[:, -1])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(tok)
    return np.asarray(jnp.concatenate(toks, axis=1)), rows, batch


@pytest.mark.parametrize("prompt_len", [24, 8], ids=["text-past-vt",
                                                     "prompt-below-vt"])
def test_serve_decodes_from_the_prefills_true_length(prompt_len):
    """The stated departure: ``serve()`` decodes from ``vision_tokens +
    max(1, prompt_len − vision_tokens)`` (24, and 17 for a prompt of 8:
    1 text token), where the reference's launcher decodes from
    ``prompt_len + vision_tokens``. Its tokens equal greedy decoding driven
    through the reference's model functions from the true length."""
    jp, jl = _draws()
    pos0 = VT + max(1, prompt_len - VT)
    assert serve_mod.prefill_length(get_config(ARCH), prompt_len) == pos0
    assert pos0 != prompt_len + VT
    res = serve_mod.serve(ARCH, batch_size=2, prompt_len=prompt_len,
                          steps=STEPS, max_len=MAX_LEN, device=CPU,
                          params=params_from_numpy(jp, CPU),
                          lora=params_from_numpy(jl, CPU),
                          dtype=torch.float32, cache_dtype=torch.float32)
    want = _reference_greedy(jp, jl, prompt_len, STEPS, MAX_LEN, pos0)[0]
    np.testing.assert_array_equal(res.tokens, want)


def test_the_references_serve_position_parts_from_teacher_forcing():
    """Why the port departs: fed the next text token, the reference's first
    decode step at the prefill's true length (24) is the training
    forward's logits at that position; at its launcher's position
    (``prompt_len + vision_tokens`` = 40) it is not."""
    jp, jl = _draws()
    jcfg = _jcfg()
    jm = jax_build_model(jcfg)
    batch = jax_make_batch_for(jcfg, 2, 24 + 1, seed=0)  # text 9
    prompt = {"tokens": batch["tokens"][:, :TEXT],
              "vision_embeds": batch["vision_embeds"]}
    train = np.asarray(jm.apply(jp, {"tokens": batch["tokens"],
                                     "vision_embeds": batch[
                                         "vision_embeds"]},
                                lora=jl, lora_scale=SCALE)[0])[:, VT + TEXT]
    parted = {}
    for pos in (VT + TEXT, 24 + VT):
        _, cache = jm.prefill(jp, prompt, jm.init_cache(2, 64, jnp.float32),
                              lora=jl, lora_scale=SCALE)
        step, _ = jm.decode_step(jp, batch["tokens"][:, TEXT:TEXT + 1],
                                 cache, jnp.asarray(pos, jnp.int32), lora=jl,
                                 lora_scale=SCALE)
        parted[pos] = np.abs(np.asarray(step)[:, -1] - train).max()
    scale = np.abs(train).max()
    assert parted[VT + TEXT] <= 1e-4 * scale
    assert parted[24 + VT] > 100 * parted[VT + TEXT] + 1e-3 * scale


def test_serve_refuses_a_prefill_and_steps_longer_than_the_cache():
    """The cache check counts the prefill's true length: a prompt of 8
    fills 17 positions, so 16 steps need 33 of a 32-slot cache (the
    reference's check-free launcher would accept it, counting 8 + 16);
    15 steps fit."""
    with pytest.raises(ValueError, match="17 positions.*exceeds"):
        serve_mod.serve(ARCH, batch_size=1, prompt_len=8, steps=16,
                        max_len=32, device=CPU, dtype=torch.float32)
    with pytest.raises(ValueError, match="exceeds"):
        serve_mod.serve(ARCH, batch_size=1, prompt_len=24, steps=9,
                        max_len=32, device=CPU, dtype=torch.float32)
    res = serve_mod.serve(ARCH, batch_size=1, prompt_len=8, steps=15,
                          max_len=32, device=CPU, dtype=torch.float32)
    assert res.tokens.shape == (1, 16)
    assert ((res.tokens >= 0) & (res.tokens < V)).all()


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--arch", ARCH, "--batch-size", "2",
                    "--prompt-len", "20", "--steps", "3", "--max-len",
                    "24"])
    assert "generated token ids" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the trainers and the launchers
# --------------------------------------------------------------------------

class _VisionLoader:
    """A client loader's batches with seeded vision embeddings added
    (normal × 0.02, f32), one for each framework from the same seed."""

    def __init__(self, inner, seed, to_array):
        self.inner, self.sequences = inner, inner.sequences
        self.rng = np.random.default_rng(seed)
        self.to_array = to_array

    def next_batch(self):
        batch = dict(self.inner.next_batch())
        n = batch["tokens"].shape[0]
        batch["vision_embeds"] = self.to_array(
            (self.rng.standard_normal((n, VT, D)) * 0.02).astype(np.float32))
        return batch


def _with_vision(loaders, evals, to_array, seed=100):
    wrapped = [_VisionLoader(ld, seed + i, to_array)
               for i, ld in enumerate(loaders)]
    rng = np.random.default_rng(seed - 1)
    evals = [dict(b, vision_embeds=to_array((rng.standard_normal(
        (b["tokens"].shape[0], VT, D)) * 0.02).astype(np.float32)))
        for b in evals]
    return wrapped, evals


def _assert_trees_close(ref, port, max_sep):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert sorted(rf) == sorted(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


LR, TRAIN_STEPS, CLIENTS, VOCAB, SEQ = 5e-3, 2, 4, 64, 16


@pytest.mark.parametrize("loaders", ["tokens-only", "vision"])
def test_host_trainer_matches_reference_round_by_round(loaders):
    """fedex through the engine over the 4 (2, 256, 256) q/k/v/o leaves: a
    uniform round of all 4 clients, then a weighted one at 50%
    participation with example weights. With the launcher's tokens-only
    loaders (internvl2 as a text-only LM, as both launchers train it), or
    with loaders that add seeded vision embeddings on both sides (the
    losses then text-only scored); ``vision_proj`` is not adapted and comes
    out of the closes as it went in."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=2, local_steps=TRAIN_STEPS)
    train = dict(learning_rate=LR, schedule="constant")
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2, seed=0)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2,
                                  seed=0, device=CPU)
    if loaders == "vision":
        jl, je = _with_vision(jl, je, jnp.asarray)
        pl, pe = _with_vision(pl, pe, torch.as_tensor)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", **fed),
                    train_cfg=JTrainConfig(**train), client_loaders=jl,
                    eval_batches=je, seed=0)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**train),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    assert sorted(s.key for s in pt.engine.specs) == sorted(
        f"layers/attn/{n}_proj" for n in "qkvo")
    proj = pt.params["vision_proj"]["kernel"].clone()
    for rnd in range(2):
        if rnd == 1:
            jt.coordinator.policy = JPolicy(participation=0.5,
                                            weighting="examples")
            pt.coordinator.policy = RoundPolicy(participation=0.5,
                                                weighting="examples")
        jrec = jt.run(until=rnd + 1)[rnd]
        prec = pt.run(until=rnd + 1)[rnd]
        assert pt.outcomes[-1].client_ids == jt.outcomes[-1].client_ids
        assert pt.outcomes[-1].weights == jt.outcomes[-1].weights
        assert (pt.outcomes[-1].weights is None) == (rnd == 0)
        np.testing.assert_allclose(prec.eval_loss, jrec.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(prec.client_losses, jrec.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(prec.divergence_scaled),
                                   float(jrec.divergence_scaled), rtol=1e-3,
                                   atol=1e-7)
        sep = 2 * LR * TRAIN_STEPS * CLIENTS
        _assert_trees_close(jt.params, pt.params, sep)
        _assert_trees_close(jt.global_lora, pt.global_lora, sep)
    assert torch.equal(pt.params["vision_proj"]["kernel"], proj)


def test_mesh_trainer_matches_reference_one_uniform_round():
    """One uniform fedex round of the mesh trainer (4 lanes, tokens-only:
    the lanes slice (C, L, m, r) adapters behind the layer axis), both
    trainers from the reference's draws, the reference's on a mesh of
    Auto axes."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=1, local_steps=TRAIN_STEPS)
    train = dict(learning_rate=LR, schedule="constant")
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2, seed=0)
    mesh = jax.make_mesh((1, 1), ("client", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jt = jmesh.MeshFederatedTrainer(
        model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
        fed_cfg=JFedConfig(**fed), train_cfg=JTrainConfig(**train),
        client_loaders=jl, eval_batches=je, seed=0, mesh=mesh)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2,
                                  seed=0, device=CPU)
    check_mesh_supported(FedConfig(**fed))
    pt = MeshFederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**train),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    jt.run()
    pt.run()
    for jr, pr in zip(jt.history, pt.history, strict=True):
        np.testing.assert_allclose(pr.client_losses, jr.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(pr.eval_loss, jr.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(pr.divergence_scaled, jr.divergence_scaled,
                                   rtol=1e-3, atol=1e-7)
    sep = 2 * LR * TRAIN_STEPS * CLIENTS
    _assert_trees_close(jt.params, pt.params, sep)
    _assert_trees_close(jt.global_lora, pt.global_lora, sep)


def test_lane_loss_scores_each_lanes_text_only():
    """Mesh mode's lane-stacked loss over a batch with vision: each lane's
    mean text-only loss, as the host loss over that lane's rows alone."""
    p, l = _draws()
    pm = build_model(_port_cfg(_jcfg()))
    tp = params_from_numpy(p, CPU)
    lanes = [params_from_numpy(_perturb(l, np.random.default_rng(20 + c)),
                               CPU) for c in range(2)]
    stacked = unflatten_from_paths({
        k: torch.stack([flatten_with_paths(lo)[k] for lo in lanes])
        for k in flatten_with_paths(lanes[0])})
    toks = np.random.default_rng(6).integers(0, V, size=(4, 9))
    _, tb = _batches(toks, _vision(13, bsz=4))
    with torch.inference_mode():
        got = pm.lane_loss(tp, tb, stacked, lora_scale=SCALE)
        want = [pm.loss(tp, {k: v[2 * c:2 * c + 2] for k, v in tb.items()},
                        lora=lanes[c], lora_scale=SCALE)[0]
                for c in range(2)]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["host", "mesh"])
def test_launcher_trains_internvl2_text_only(mode, capsys):
    """Both launcher modes run the config, with no refusal, on the
    tokens-only loaders; ``--data-vocab`` keeps the corpus small."""
    port_train.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
                     "--data-vocab", "32", "--clients", "2", "--rounds", "1",
                     "--local-steps", "1", "--batch-size", "2",
                     "--seq-len", "8"])
    assert "final: method=fedex" in capsys.readouterr().out
