"""The hybrid family in the port (``zamba2-7b``: Mamba2 SSD layers and one
parameter-shared attention + MLP block) against the JAX reference, in f32
unless a test says otherwise, at ``zamba2-7b-smoke`` (2 Mamba2 layers,
each followed by the shared block: no trailing layer; d 256, 4 heads of
64, d_inner 512, 16 SSM heads of P 32, state N 16) and at a variant of it
cut the same way on both sides, ``num_layers=5, attn_every=2`` (2 periods
of 2 Mamba2 layers + 1 trailing), so that ``mamba_trailing`` runs.

* the registry, and the parameter (leaf dtypes included, in bf16), adapter
  and cache trees, path for path;
* ``ssd_chunked`` at a small chunk, padded with dt 0, from a nonzero
  ``h0``, against the reference's and against a loop of ``ssd_step``;
* ``mamba2_block``'s training path and its LoRA gradients, and its prefill
  (several chunks, padded) and decode steps with the state after them;
* the logits, loss and LoRA gradients (the shared adapter's summed over
  its applications); a prefill of 300 tokens (two chunks of 256, padded)
  and 4 decode steps, and the caches after them; the conv state's dtype of
  f32 activations against a bf16 cache; serving's projections all through
  the fused LoRA kernel's wrapper; a bf16 prefill and decode;
* the host trainer round by round (uniform, then weighted at 50%); the
  launchers;
* mesh mode: ``lane_loss`` against the host loss on each lane's rows (the
  shared block given the unsliced (C, m, r) adapter in every period), one
  weighted round of the mesh trainer against the reference's, and the
  launcher's ``--mode mesh`` against the class.

Tolerances are ``tests/test_torch_mla.py``'s: logits and loss rtol 1e-5
of their scale, LoRA gradients within 1e-5 of each leaf's largest entry;
``ssd_chunked``, ``mamba2_block`` outputs, prefill and decode logits and
caches rtol / atol 1e-4 (f32 on both sides, the products contracted in
another order); the trainer's losses rtol 1e-5, divergence rtol 1e-3,
trees by relative Frobenius error ≤ 1e-2 and the AdamW separation bound;
bf16 the criterion of ``tests/test_torch_bf16.py`` (twice the reference's
bf16 distance from its f32 answer over the same weights, plus one bf16
rounding at the logit scale).
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
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.fedsrv import RoundPolicy as JPolicy  # noqa: E402
from repro.launch import mesh_train as jmesh  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models import transformer as ptransformer  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "zamba2-7b-smoke"
TRAILING = dict(num_layers=5, attn_every=2)  # 2 periods of 2 + 1 trailing
VARIANTS = {"smoke": {}, "trailing": TRAILING}
SCALE = 2.0  # α / r = 8 / 4
TOL = dict(rtol=1e-4, atol=1e-4)


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


def _jcfg(variant="smoke", **kw):
    return dataclasses.replace(jax_get_config(ARCH), dtype="float32",
                               **VARIANTS[variant], **kw)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


def _perturb(tree, rng):
    """Norm scales, D, dt_bias and the conv bias drawn away from their
    init (1, 1, 0, 0), every adapter's b non-zero, so a missing term would
    show."""
    out = {}
    for k, x in jax_flatten(tree).items():
        x = np.asarray(x, np.float32)
        if k.endswith(("/scale", "/D")):
            x = x + 0.2 * rng.standard_normal(x.shape)
        elif k.endswith(("/dt_bias", "/bias")):
            x = x + 0.3 * rng.standard_normal(x.shape)
        elif k.endswith("/b"):
            x = 0.02 * rng.standard_normal(x.shape)
        out[k] = x.astype(np.float32)
    return unflatten_from_paths(out)


@functools.lru_cache(maxsize=None)
def _draws(variant="smoke"):
    """The reference's f32 draws, perturbed: params and an adapter."""
    jcfg = _jcfg(variant)
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    jl = _np(jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig()))
    rng = np.random.default_rng(2)
    return _perturb(jp, rng), _perturb(jl, rng)


def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


# --------------------------------------------------------------------------
# registry and trees
# --------------------------------------------------------------------------

def test_registry_has_zamba2_as_the_reference():
    assert "zamba2-7b" in list_configs() and len(list_configs()) == 13
    for name in ("zamba2-7b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        check_supported(get_config(name))
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.attn_every, c.d_model, c.ssm_state,
            c.ssm_head_dim, c.ssm_expand) == ("hybrid", 2, 1, 256, 16, 32, 2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_adapter_and_cache_trees_line_up(variant):
    """The trees path for path and shape for shape; in the config's bf16
    the leaf dtypes too (A_log, D and dt_bias f32, the rest bf16)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), **VARIANTS[variant])
    jm = jax_build_model(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    jl = jax.eval_shape(lambda p: jax_init_lora(
        jax.random.key(1), p, jcfg, JLoRAConfig()), jp)
    jc = jax.eval_shape(lambda: jm.init_cache(2, 40, jnp.bfloat16))
    pm = build_model(_port_cfg(jcfg))
    gen = torch.Generator().manual_seed(0)
    pp = pm.init(gen, CPU)
    from repro_torch.core.lora import init_lora
    pl = init_lora(gen, pp, pm.cfg, LoRAConfig())
    pc = pm.init_cache(2, 40, torch.bfloat16, device=CPU)
    for ref, port in ((jp, pp), (jl, pl), (jc, pc)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        for k in rf:
            assert tuple(rf[k].shape) == tuple(pf[k].shape), k
            assert str(pf[k].dtype) == f"torch.{rf[k].dtype}", k
    assert ("mamba_trailing" in pp) == (variant == "trailing")
    assert pp["shared_attn"]["attn"]["q_proj"]["kernel"].shape == (256, 256)
    assert sorted(pl["shared_attn"]["attn"]) == ["k_proj", "o_proj",
                                                 "q_proj", "v_proj"]
    assert sorted(pl["mamba_layers"]["mamba"]) == ["in_proj", "out_proj"]
    lead = (2, 2) if variant == "trailing" else (2, 1)
    assert pl["mamba_layers"]["mamba"]["in_proj"]["a"].shape == (
        *lead, 256, 4)
    assert pc["mamba"]["ssm"].shape == (*lead, 2, 16, 32, 16)
    assert pc["mamba"]["conv"].shape == (*lead, 2, 3, 544)


# --------------------------------------------------------------------------
# the SSD and the Mamba2 block
# --------------------------------------------------------------------------

def _ssd_inputs(seed, bsz=2, s=20, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(
        np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    b = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, n)).astype(np.float32)
    h0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return x, dt, a, b, c, h0


def test_ssd_chunked_matches_the_reference_and_a_step_loop():
    """20 tokens padded to 24 with dt 0 (and x, B, C 0), chunks of 8, from a
    nonzero h0: y and the final state against the reference's
    ``ssd_chunked`` on the same padded inputs, and against 20 steps of
    ``ssd_step`` (the padded tail changes neither)."""
    x, dt, a, b, c, h0 = _ssd_inputs(3)
    pad = [(0, 0), (0, 4)]
    xp = np.pad(x, pad + [(0, 0), (0, 0)])
    dtp, bp, cp = (np.pad(t, pad + [(0, 0)]) for t in (dt, b, c))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(t) for t in (xp, dtp, a, bp, cp)),
                              chunk=8, h0=jnp.asarray(h0))
    y, hf = pssm.ssd_chunked(*(torch.as_tensor(t) for t in (xp, dtp, a, bp,
                                                            cp)),
                             chunk=8, h0=torch.as_tensor(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), **TOL)
    hs, ys = torch.as_tensor(h0), []
    for t in range(x.shape[1]):
        hs, yt = pssm.ssd_step(hs, *(torch.as_tensor(v[:, t])
                                     for v in (x, dt)), torch.as_tensor(a),
                               torch.as_tensor(b[:, t]),
                               torch.as_tensor(c[:, t]))
        ys.append(yt)
    np.testing.assert_allclose(y[:, :20].numpy(),
                               torch.stack(ys, 1).numpy(), **TOL)
    np.testing.assert_allclose(hf.numpy(), hs.numpy(), **TOL)
    # bf16 x: the products in f32 (JAX promotes), y back in bf16
    yb, _ = pssm.ssd_chunked(torch.as_tensor(xp).bfloat16(),
                             *(torch.as_tensor(t) for t in (dtp, a, bp, cp)),
                             chunk=8)
    jyb, _ = jssm.ssd_chunked(jnp.asarray(xp, jnp.bfloat16),
                              *(jnp.asarray(t) for t in (dtp, a, bp, cp)),
                              chunk=8)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(),
                               np.asarray(jyb, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


def _layer0(tree, key="mamba_layers"):
    return jax.tree.map(lambda t: np.asarray(t)[0, 0], tree[key])["mamba"]


def test_mamba2_block_train_and_its_lora_grads_match_the_reference():
    """Layer (0, 0): the training path's output and the gradients of
    ⟨output, g⟩ with respect to in_proj's and out_proj's factors."""
    jcfg = _jcfg()
    jp, jl = _draws()
    p, lo = _layer0(jp), _layer0(jl)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    g = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def jfn(l):
        out, _ = jssm.mamba2_block(jcfg, p, jnp.asarray(x), lora=l,
                                   lora_scale=SCALE)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(lo)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(lo, CPU)).items()}
    out, cache = pssm.mamba2_block(_port_cfg(jcfg), params_from_numpy(p, CPU),
                                   torch.as_tensor(x),
                                   lora=unflatten_from_paths(flat),
                                   lora_scale=SCALE)
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(),
                                list(flat.values()))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(flat)
    for k, got in zip(flat, grads):
        want = np.asarray(jf[k])
        assert np.abs(want).max() > 0, k
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), k


def test_mamba2_block_prefill_and_decode_match_the_reference():
    """Layer (0, 0) served at chunk 16: a prefill of 40 tokens (three
    chunks, padded from 40 to 48) into a zero cache, then 3 decode steps;
    each output and the ssm and conv states after each."""
    jcfg = _jcfg()
    jp, jl = _draws()
    p, lo = _layer0(jp), _layer0(jl)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 43, 256)).astype(np.float32)
    jcache = jssm.init_mamba_cache(2, jcfg, jnp.float32)
    pcfg = _port_cfg(jcfg)
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(lo, CPU)
    cache = pssm.init_mamba_cache(2, pcfg, torch.float32, CPU)
    block = jax.jit(functools.partial(jssm.mamba2_block, jcfg,
                                      lora_scale=SCALE, chunk=16),
                    static_argnames=("decode",))
    with torch.inference_mode():
        for lo_t, hi_t in ((0, 40), (40, 41), (41, 42), (42, 43)):
            decode = lo_t > 0
            jout, jcache = block(p, jnp.asarray(x[:, lo_t:hi_t]), lora=lo,
                                 cache=jcache, decode=decode)
            out, cache = pssm.mamba2_block(
                pcfg, tp, torch.as_tensor(x[:, lo_t:hi_t]), lora=tl,
                lora_scale=SCALE, cache=cache, decode=decode, chunk=16)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            for k in ("ssm", "conv"):
                np.testing.assert_allclose(cache[k].numpy(),
                                           np.asarray(jcache[k]), **TOL)


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_lora_grads(variant):
    """The logits, the loss and its LoRA gradients; the shared block's
    adapter (no layer axis) gathers the gradient of every application."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 41))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jlogits, (jloss, jgrads) = jax.jit(lambda lo: (
        jm.apply(p, jb, lora=lo, lora_scale=SCALE)[0],
        jax.value_and_grad(lambda x: jm.loss(p, jb, lora=x,
                                             lora_scale=SCALE)[0])(lo)))(l)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    logits = pm.apply(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE)
    loss, met = pm.loss(tp, tb, lora=unflatten_from_paths(flat),
                        lora_scale=SCALE)
    assert "aux_loss" not in met
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(grads)
    assert any(k.startswith("shared_attn/") for k in jf)
    assert any(k.startswith("mamba_trailing/") for k in jf) == (
        variant == "trailing")
    for k, g in jf.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(g).max(), k


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

PROMPT, STEPS, MAX_LEN = 300, 4, 320


def _tokens(seed, n=PROMPT + STEPS):
    return np.random.default_rng(seed).integers(0, 512, size=(2, n))


def _serve_both(variant, jp, jl, toks, cache_dtype=jnp.float32):
    """A prefill of all but the last STEPS tokens, then STEPS teacher-forced
    decode steps in both frameworks (caches in ``cache_dtype``):
    (reference's logits, port's logits), each the prefill's then every
    step's, and both caches after."""
    prompt = toks.shape[1] - STEPS
    jcfg = _jcfg(variant)
    jm = jax_build_model(jcfg)
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    jpre = jax.jit(lambda t, c: jm.prefill(jp, {"tokens": t}, c, lora=jl,
                                           lora_scale=SCALE))
    jdec = jax.jit(lambda t, c, pos: jm.decode_step(jp, t, c, pos, lora=jl,
                                                    lora_scale=SCALE))
    jlog, jc = jpre(jnp.asarray(toks[:, :prompt]),
                    jm.init_cache(2, MAX_LEN, cache_dtype))
    ref, port = [np.asarray(jlog)], []
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, tdt[cache_dtype], device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        port.append(tlog.numpy())
        for pos in range(prompt, prompt + STEPS):
            tok = toks[:, pos:pos + 1]
            jd, jc = jdec(jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(pos, jnp.int32))
            td, cache = pm.decode_step(tp, torch.as_tensor(tok), cache, pos,
                                       lora=tl, lora_scale=SCALE)
            ref.append(np.asarray(jd))
            port.append(td.numpy())
    return ref, port, jc, cache


def _assert_caches_close(jc, cache):
    """Path for path, dtype for dtype; values within TOL, a bf16 buffer
    (the KV cache) within one bf16 ulp more (2⁻⁷ relative: a k or v a hair
    apart in f32 may round to neighbouring bf16 values)."""
    rf, pf = jax_flatten(jc), flatten_with_paths(cache)
    assert sorted(pf) == sorted(rf)
    for k, x in rf.items():
        assert str(pf[k].dtype) == f"torch.{x.dtype}", k
        if k.endswith("pos"):
            np.testing.assert_array_equal(pf[k].numpy(), np.asarray(x))
            continue
        rtol = TOL["rtol"] + (2.0 ** -7 if x.dtype == jnp.bfloat16 else 0)
        np.testing.assert_allclose(pf[k].float().numpy(),
                                   np.asarray(x, np.float32), rtol=rtol,
                                   atol=TOL["atol"])


def test_prefill_and_decode_match_the_reference():
    """The trailing variant: a prefill of 300 tokens (padded to 512, two
    chunks of 256) and 4 decode steps, f32 caches; the logits of each, the
    Mamba2 states and the shared block's KV caches after them."""
    jp, jl = _draws("trailing")
    ref, port, jc, cache = _serve_both("trailing", jp, jl, _tokens(4))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)
    _assert_caches_close(jc, cache)
    assert int(cache["shared_attn"]["pos"].max()) == PROMPT + STEPS - 1


def test_conv_state_comes_back_in_the_activations_dtype():
    """f32 weights against a bf16 cache: the reference's conv state comes
    back in f32 (``jnp.concatenate`` promotes), so the port's conv buffers
    are widened to f32 before the first write and hold the same values;
    the ssm state stays f32, the KV cache bf16."""
    jp, jl = _draws()
    toks = _tokens(5, 40)
    ref, port, jc, cache = _serve_both("smoke", jp, jl, toks, jnp.bfloat16)
    assert cache["mamba"]["conv"].dtype == torch.float32
    assert cache["mamba"]["ssm"].dtype == torch.float32
    assert cache["shared_attn"]["k"].dtype == torch.bfloat16
    _assert_caches_close(jc, cache)
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)


def test_serving_runs_every_adapted_projection_fused():
    """In serving every adapted projection goes through the fused LoRA
    kernel's wrapper (``lora_dense``: B3 on the card, its plain version
    here) — in_proj and out_proj of each Mamba2 layer, q/k/v/o of each
    application of the shared block — and every prefill attention through
    B8's (``swa_attention``, at head dim 64); a decode step the same
    projections and no attention kernel; the training forward none."""
    jp, jl = _draws("trailing")
    pm = build_model(_port_cfg(_jcfg("trailing")))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    toks = torch.as_tensor(_tokens(8, 24))
    calls = {"lora_dense": [], "swa_attention": 0}
    real_ld, real_swa = pcommon.lora_dense, pattn.swa_attention

    def ld(x, w, a, b, scale):
        calls["lora_dense"].append((tuple(w.shape), x.shape[:-1].numel()))
        return real_ld(x, w, a, b, scale)

    def swa(q, k, v, causal=True, window=0):
        calls["swa_attention"] += 1
        assert q.shape[-1] == 64
        return real_swa(q, k, v, causal, window)

    pcommon.lora_dense, pattn.swa_attention = ld, swa
    try:
        with torch.inference_mode():
            pm.apply(tp, {"tokens": toks}, lora=tl, lora_scale=SCALE)
            assert calls == {"lora_dense": [], "swa_attention": 0}
            cache = pm.init_cache(2, 32, torch.float32, device=CPU)
            _, cache = pm.prefill(tp, {"tokens": toks[:, :20]}, cache,
                                  lora=tl, lora_scale=SCALE)
            pre = list(calls["lora_dense"])
            assert calls["swa_attention"] == 2
            pm.decode_step(tp, toks[:, 20:21], cache, 20, lora=tl,
                           lora_scale=SCALE)
            dec = calls["lora_dense"][len(pre):]
    finally:
        pcommon.lora_dense, pattn.swa_attention = real_ld, real_swa
    mamba = [(256, 1072), (512, 256)]
    shared = [(256, 256)] * 4
    layer = (mamba * 2 + shared) * 2 + mamba
    assert [w for w, _ in pre] == layer
    assert {m for _, m in pre} == {40}
    assert [w for w, _ in dec] == layer
    assert {m for _, m in dec} == {2}
    assert calls["swa_attention"] == 2


def test_bf16_prefill_and_decode_against_the_f32_answer():
    """The config's bf16 (no dtype override), the reference's bf16 draws
    with b ≠ 0, bf16 caches: the port's prefill logits and each decode
    step's no further from the reference's f32 answer over the same
    weights (f32 cache) than twice the reference's own bf16 run, plus one
    bf16 rounding at the logit scale (2⁻⁸ · max |f32 logit|)."""
    cfg = jax_get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jp = _np(jax.jit(jax_build_model(cfg).init)(jax.random.key(3)))
    rng = np.random.default_rng(5)
    jl = _perturb(_np(jax_init_lora(jax.random.key(4), jp, cfg,
                                    JLoRAConfig())), rng)
    prompt = 40
    toks = _tokens(9, prompt + STEPS)
    out = {}
    for name, c, p, cdt in (
            ("bf16", cfg, jp, jnp.bfloat16),
            ("f32", dataclasses.replace(cfg, dtype="float32"),
             jax.tree.map(lambda t: t.astype(np.float32), jp), jnp.float32)):
        m = jax_build_model(c)
        lg, jc = jax.jit(lambda cc: m.prefill(p, {"tokens": jnp.asarray(
            toks[:, :prompt])}, cc, lora=jl, lora_scale=SCALE))(
                m.init_cache(2, 64, cdt))
        rows = [np.asarray(lg, np.float32)[:, -1]]
        step = jax.jit(lambda t, cc, pos: m.decode_step(
            p, t, cc, pos, lora=jl, lora_scale=SCALE))
        for pos in range(prompt, prompt + STEPS):
            lg, jc = step(jnp.asarray(toks[:, pos:pos + 1]), jc,
                          jnp.asarray(pos, jnp.int32))
            rows.append(np.asarray(lg, np.float32)[:, -1])
        out[name] = rows
    pm = build_model(_port_cfg(cfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    got = []
    with torch.inference_mode():
        cache = pm.init_cache(2, 64, device=CPU)
        lg, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        assert cache["mamba"]["conv"].dtype == torch.bfloat16
        got.append(lg[:, -1].float().numpy())
        for pos in range(prompt, prompt + STEPS):
            lg, cache = pm.decode_step(tp, torch.as_tensor(
                toks[:, pos:pos + 1]), cache, pos, lora=tl, lora_scale=SCALE)
            got.append(lg[:, -1].float().numpy())
    for i, (port, r16, r32) in enumerate(zip(got, out["bf16"], out["f32"])):
        bound = 2 * np.abs(r16 - r32).max() + 2.0 ** -8 * np.abs(r32).max()
        err = np.abs(port - r32).max()
        assert err <= bound, (i, err, bound)


# --------------------------------------------------------------------------
# the trainer, the launchers, mesh mode
# --------------------------------------------------------------------------

def _assert_trees_close(ref, port, max_sep):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert sorted(rf) == sorted(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


LR, TRAIN_STEPS, CLIENTS, VOCAB, SEQ = 5e-3, 2, 4, 64, 32


def test_host_trainer_matches_reference_round_by_round():
    """fedex through the engine: a uniform round of all 4 clients, then a
    weighted one at 50% participation with example weights; the closes
    fold the (nper, attn_every, m, n) Mamba2 leaves beside the shared
    block's unstacked (m, n) ones."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=2, local_steps=TRAIN_STEPS)
    train = dict(learning_rate=LR, schedule="constant")
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", **fed),
                    train_cfg=JTrainConfig(**train), client_loaders=jl,
                    eval_batches=je, seed=0)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2,
                                  seed=0, device=CPU)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**train),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    assert pt.engine is not None
    keys = sorted(s.key for s in pt.engine.specs)
    assert len(keys) == 6 and sum(k.startswith("shared_attn/")
                                  for k in keys) == 4
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


def test_launchers_run_on_the_cpu(capsys):
    port_train.main(["--device", "cpu", "--arch", ARCH, "--method", "fedex",
                     "--vocab", "64", "--clients", "2", "--rounds", "1",
                     "--local-steps", "1", "--batch-size", "2", "--seq-len",
                     "16", "--weighting", "examples"])
    out = capsys.readouterr().out
    assert "final: method=fedex" in out and "close backend=plain" in out
    serve_mod.main(["--device", "cpu", "--arch", ARCH, "--batch-size", "1",
                    "--prompt-len", "8", "--steps", "2", "--max-len", "16"])
    assert "generated token ids" in capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["--weighting", "examples", "--participation", "0.5"],
    ["--method", "fedex_svd", "--svd-rank", "2"],
    ["--assignment", "reinit", "--weighting", "examples"],
    ["--assignment", "keep_local", "--weighting", "examples"],
    ["--method", "hetero", "--client-ranks", "4,2,1"],
    ["--clients", "4", "--close-chunk", "2", "--weighting", "examples"]],
    ids=["fedex-weighted", "fedex_svd", "reinit", "keep_local", "hetero",
         "chunked"])
def test_every_engine_close_runs_on_the_hybrid_stack(args, capsys):
    """Every close of the engine folds the hybrid tree, its (nper,
    attn_every, m, n) Mamba2 leaves and its shared block's (m, n) ones,
    through the port's launcher on the CPU, to finite numbers."""
    port_train.main(["--device", "cpu", "--arch", ARCH, "--vocab", "64",
                     "--rounds", "2", "--local-steps", "2", "--batch-size",
                     "2", "--seq-len", "16", "--clients", "3", *args])
    out = capsys.readouterr().out
    final = [line for line in out.splitlines() if line.startswith("final:")]
    assert len(final) == 1 and "close backend=plain" in final[0], out
    loss = float(final[0].split("eval_loss=")[1].split()[0])
    assert np.isfinite(loss)


def _lane_stack(tree, lanes, seed):
    """``lanes`` copies of an adapter tree, each leaf moved by its own
    N(0, 0.01²) draw, and their lane stack (the engine's layout)."""
    rng = np.random.default_rng(seed)
    flat = flatten_with_paths(params_from_numpy(tree, CPU))
    each = [{k: v + torch.as_tensor(0.01 * rng.standard_normal(v.shape),
                                    dtype=v.dtype) for k, v in flat.items()}
            for _ in range(lanes)]
    return ([unflatten_from_paths(e) for e in each],
            unflatten_from_paths({k: torch.stack([e[k] for e in each])
                                  for k in flat}))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lane_loss_equals_the_host_loss_on_each_lanes_rows(variant,
                                                           monkeypatch):
    """Mesh mode's loss over 2 lanes of 2 rows: each Mamba2 layer slices
    its lanes' (C, m, r) factors behind the (nper, attn_every) axes (the
    trailing layers' behind one), every period's call of the shared block
    takes the unsliced (C, m, r) adapter; each lane's CE as the host loss
    on that lane's rows."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    lanes, stacked = _lane_stack(l, 2, seed=11)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size,
                                              size=(4, 33))
    _, tb = _batches(toks)
    shared, layer = [], ptransformer.decoder_layer

    def spy(cfg, p, x, *, lora, **kw):
        shared.append(tuple(lora["attn"]["q_proj"]["a"].shape))
        return layer(cfg, p, x, lora=lora, **kw)

    monkeypatch.setattr(ptransformer, "decoder_layer", spy)
    with torch.inference_mode():
        got = pm.lane_loss(tp, tb, stacked, lora_scale=SCALE)
    monkeypatch.undo()
    with torch.inference_mode():
        want = [pm.loss(tp, {k: v[2 * c:2 * c + 2] for k, v in tb.items()},
                        lora=lanes[c], lora_scale=SCALE)[0]
                for c in range(2)]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=1e-5)
    nper = jcfg.num_layers // jcfg.attn_every
    assert shared == [(2, jcfg.d_model, 4)] * nper


MESH_FED = dict(num_clients=2, rounds=1, local_steps=3, weighting="examples")


def _mesh_trainers(jcfg, jlcfg, lcfg, data=None, **model_kw):
    """The reference's mesh trainer (on a mesh of Auto axes) and the
    port's from the reference's draws, over 2 lanes of the same loaders
    (``data(loaders, evals, to_array)`` wraps each side's)."""
    jl, je = jax_data(VOCAB, 2, seq_len=SEQ, batch_size=2, seed=0)
    pl, pe = build_federated_data(VOCAB, 2, seq_len=SEQ, batch_size=2,
                                  seed=0, device=CPU)
    if data is not None:
        jl, je = data(jl, je, jnp.asarray)
        pl, pe = data(pl, pe, torch.as_tensor)
    mesh = jax.make_mesh((1, 1), ("client", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jt = jmesh.MeshFederatedTrainer(
        model=jax_build_model(jcfg, **model_kw), lora_cfg=jlcfg,
        fed_cfg=JFedConfig(**MESH_FED),
        train_cfg=JTrainConfig(learning_rate=LR, schedule="constant"),
        client_loaders=jl, eval_batches=je, seed=0, mesh=mesh)
    pt = MeshFederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=lcfg,
        fed_cfg=FedConfig(**MESH_FED),
        train_cfg=TrainConfig(learning_rate=LR, schedule="constant"),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    return jt, pt


def _assert_rounds_match(jt, pt):
    """Run both; losses rtol 1e-5, divergence rtol 1e-3 (and above its
    atol: 3 steps move the factors apart), W0 and the global adapter
    within 1e-2 relative Frobenius and the AdamW separation bound."""
    jt.run()
    pt.run()
    for jr, pr in zip(jt.history, pt.history, strict=True):
        np.testing.assert_allclose(pr.client_losses, jr.client_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(pr.eval_loss, jr.eval_loss, rtol=1e-5)
        np.testing.assert_allclose(pr.divergence_scaled, jr.divergence_scaled,
                                   rtol=1e-3, atol=1e-7)
        assert pr.divergence_scaled > 1e-7
    sep = 2 * LR * MESH_FED["local_steps"] * MESH_FED["num_clients"]
    _assert_trees_close(jt.params, pt.params, sep)
    _assert_trees_close(jt.global_lora, pt.global_lora, sep)


def test_mesh_trainer_matches_reference_one_weighted_round():
    """One weighted fedex round of 2 lanes (example weights, 3 local
    steps) against the reference's mesh trainer: the lanes of the Mamba2
    stacks' in_proj / out_proj and of the shared block's q/k/v/o, closed
    over the 8 leaves."""
    jt, pt = _mesh_trainers(_jcfg(vocab_size=VOCAB), JLoRAConfig(),
                            LoRAConfig())
    assert sum(s.key.startswith("shared_attn/") for s in pt.closer.specs
               ) == 4
    _assert_rounds_match(jt, pt)


def test_launcher_mesh_mode_equals_the_class(tmp_path, capsys):
    """``--mode mesh`` runs the config; its history is the class's."""
    out = tmp_path / "history.json"
    port_train.main(["--device", "cpu", "--arch", ARCH, "--mode", "mesh",
                     "--vocab", str(VOCAB), "--clients", "2", "--rounds",
                     "1", "--local-steps", "3", "--batch-size", "2",
                     "--seq-len", str(SEQ), "--weighting", "examples",
                     "--out", str(out)])
    assert "mode=mesh" in capsys.readouterr().out
    cfg = dataclasses.replace(get_config(ARCH), vocab_size=VOCAB,
                              dtype="float32")
    loaders, evals = build_federated_data(VOCAB, 2, seq_len=SEQ,
                                          batch_size=2, device=CPU)
    hist = MeshFederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**MESH_FED),
        train_cfg=TrainConfig(learning_rate=LR, schedule="constant",
                              total_steps=3),
        client_loaders=loaders, eval_batches=evals, seed=0,
        device=CPU).run()
    assert [(h["round"], h["client_losses"], h["eval_loss"],
             h["divergence_scaled"]) for h in json.loads(out.read_text())
            ] == [(h.round, h.client_losses, h.eval_loss,
                   h.divergence_scaled) for h in hist]
