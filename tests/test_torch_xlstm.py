"""The ssm family in the port (``xlstm-1.3b``: periods of mLSTM blocks,
matrix memory, and one sLSTM block, scalar recurrence) against the JAX
reference, in f32 unless a test says otherwise, at ``xlstm-1.3b-smoke``
(one period of 1 mLSTM + 1 sLSTM block; d 256, 4 heads: the mLSTM's
d_inner 512 in heads of 128, the sLSTM's heads of 64, FFN width 341) and at
a variant of it cut the same way on both sides, ``num_layers=8,
slstm_every=4`` (2 periods of 3 mLSTM + 1 sLSTM blocks), so that every
stacked axis has a size above 1 and a swapped index would show.

* the registry, and the parameter (leaf dtypes included, in bf16:
  ``b_gates`` f32), adapter and cache trees, path for path; the bridge
  carrying ``b_gates`` and the raw ``r_gates`` with their dtypes;
* ``mlstm_chunked`` at a small chunk, padded, from a given state and from
  none, against the reference's and against a loop of ``mlstm_step``;
* each block's training path and its LoRA gradients, and its prefill and
  decode steps with the state after them;
* the logits, loss and LoRA gradients; a prefill of 300 tokens (two mLSTM
  chunks of 256, padded) and 4 decode steps, the caches after them, with
  an f32 and with a bf16 cache (the conv state back in the activations'
  dtype, the sLSTM's h in the cache's); serving's projections all through
  the fused LoRA kernel's wrapper; a bf16 prefill and decode;
* the host trainer round by round (uniform, then weighted at 50%); every
  engine close; the launchers;
* mesh mode: ``lane_loss`` against the host loss on each lane's rows, one
  weighted round of the mesh trainer against the reference's, and the
  launcher's ``--mode mesh`` against the class.

Tolerances are ``tests/test_torch_hybrid.py``'s: logits and loss rtol
1e-5 of their scale, LoRA gradients within 1e-5 of each leaf's largest
entry; ``mlstm_chunked``, block outputs, prefill and decode logits and
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
from repro.models import xlstm as jxl  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.lora import init_lora  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import xlstm as pxl  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "xlstm-1.3b-smoke"
PERIODS = dict(num_layers=8, slstm_every=4)  # 2 periods of 3 mLSTM + 1 sLSTM
VARIANTS = {"smoke": {}, "periods": PERIODS}
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
    """Norm scales, biases (the conv's, the norms', ``b_gates``) drawn
    away from their init, every adapter's b non-zero, so a missing term
    would show."""
    out = {}
    for k, x in jax_flatten(tree).items():
        x = np.asarray(x, np.float32)
        if k.endswith("/scale"):
            x = x + 0.2 * rng.standard_normal(x.shape)
        elif k.endswith(("/bias", "/b_gates")):
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

def test_registry_has_xlstm_as_the_reference():
    assert "xlstm-1.3b" in list_configs() and len(list_configs()) == 13
    for name in ("xlstm-1.3b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        check_supported(get_config(name))
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.slstm_every, c.d_model, c.num_heads,
            c.ssm_expand, c.norm, c.tie_embeddings) == (
        "ssm", 2, 2, 256, 4, 2, "layernorm", True)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_adapter_and_cache_trees_line_up(variant):
    """The trees path for path and shape for shape; in the config's bf16
    the leaf dtypes too (``b_gates`` f32, the rest bf16; the cache's C, n,
    m and c f32, its conv and h bf16)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), **VARIANTS[variant])
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
    nper, nm = (2, 3) if variant == "periods" else (1, 1)
    per = pl["periods"]
    assert sorted(per["mlstm"]) == ["down_proj", "k_proj", "q_proj",
                                    "up_proj", "v_proj"]
    assert sorted(per["slstm"]) == ["ffn", "w_gates"]
    assert sorted(per["slstm"]["ffn"]) == ["down_proj", "up_proj"]
    assert len(flatten_with_paths(pl)) == 16  # 8 adapted leaves, a and b
    assert per["mlstm"]["up_proj"]["a"].shape == (nper, nm, 256, 4)
    assert per["slstm"]["ffn"]["down_proj"]["a"].shape == (nper, 341, 4)
    assert pp["periods"]["slstm"]["b_gates"].dtype == torch.float32
    assert pp["periods"]["slstm"]["r_gates"].shape == (nper, 4, 4, 64, 64)
    assert pc["mlstm"]["C"].shape == (nper, nm, 2, 4, 128, 128)
    assert pc["mlstm"]["conv"].shape == (nper, nm, 2, 3, 512)
    assert pc["slstm"]["h"].shape == (nper, 2, 256)
    assert bool(torch.isneginf(pc["mlstm"]["m"]).all())
    assert bool((pc["slstm"]["n"] == 1).all())


def test_bridge_carries_the_leaves_that_are_not_kernels():
    """A bf16 tree in the reference's dtypes (its draws rounded to bf16 as
    JAX rounds them; ``b_gates`` f32, drawn non-zero) across and back:
    ``b_gates`` f32, ``r_gates`` bf16 (4, H, 64, 64) a period, bit for
    bit."""
    jp = jax.tree.map(lambda t: np.asarray(jnp.asarray(t, jnp.bfloat16)),
                      _draws("periods")[0])
    sl = jp["periods"]["slstm"]
    sl["b_gates"] = np.random.default_rng(4).standard_normal(
        sl["b_gates"].shape).astype(np.float32)
    tp = params_from_numpy(jp, CPU)
    got = tp["periods"]["slstm"]
    assert got["b_gates"].dtype == torch.float32
    assert got["r_gates"].dtype == torch.bfloat16
    assert tuple(got["r_gates"].shape) == (2, 4, 4, 64, 64)
    back = to_numpy(tp)["periods"]["slstm"]
    np.testing.assert_array_equal(back["b_gates"], sl["b_gates"])
    np.testing.assert_array_equal(back["r_gates"],
                                  np.asarray(sl["r_gates"], np.float32))


def test_serve_casts_params_to_the_models_own_dtypes():
    """``serve()`` casts given params to the model's dtype leaf by leaf as
    the model holds them: f32 params served in bf16 keep ``b_gates`` f32
    (and zamba2's A_log, D and dt_bias), the rest bf16, as a bf16 model's
    own draws are."""
    for arch in (ARCH, "zamba2-7b-smoke"):
        cfg = get_config(arch)
        gen = torch.Generator().manual_seed(0)
        own = flatten_with_paths(build_model(cfg).init(gen, CPU))
        f32 = build_model(dataclasses.replace(cfg, dtype="float32")).init(
            gen, CPU)
        got = flatten_with_paths(serve_mod._cast(f32, torch.bfloat16))
        assert {k: v.dtype for k, v in got.items()} == {
            k: v.dtype for k, v in own.items()}
        assert any(v.dtype == torch.float32 for v in own.values())


# --------------------------------------------------------------------------
# the mLSTM cell
# --------------------------------------------------------------------------

def _cell_inputs(seed, bsz=2, s=20, h=3, d=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bsz, s, h, d)).astype(np.float32)
               for _ in range(3))
    k = k * np.float32(d ** -0.5)
    i_pre = rng.standard_normal((bsz, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((bsz, s, h)) + 2.0).astype(np.float32)
    lf = -np.log1p(np.exp(-f_pre)).astype(np.float32)
    state = (rng.standard_normal((bsz, h, d, d)).astype(np.float32),
             rng.standard_normal((bsz, h, d)).astype(np.float32),
             rng.standard_normal((bsz, h)).astype(np.float32))
    return q, k, v, i_pre, lf, state


@pytest.mark.parametrize("given", [True, False], ids=["state", "empty"])
def test_mlstm_chunked_matches_the_reference_and_a_step_loop(given):
    """20 positions padded to 24 (i_pre −1e30, log f 0, q, k, v 0), chunks
    of 8, from a given state or none: h and the final state against the
    reference's ``mlstm_chunked`` on the same padded inputs, and against
    20 steps of ``mlstm_step`` (the padded tail changes neither); without
    ``final_state`` the same h and no state."""
    q, k, v, i_pre, lf, state = _cell_inputs(3)
    if not given:
        state = None
    pad = [(0, 0), (0, 4)]
    qp, kp, vp = (np.pad(t, pad + [(0, 0), (0, 0)]) for t in (q, k, v))
    ip = np.pad(i_pre, pad + [(0, 0)], constant_values=-1e30)
    lfp = np.pad(lf, pad + [(0, 0)])
    jh, js = jxl.mlstm_chunked(
        *(jnp.asarray(t) for t in (qp, kp, vp, ip, lfp)), chunk=8,
        state=None if state is None else tuple(jnp.asarray(t)
                                               for t in state))
    tstate = None if state is None else tuple(torch.as_tensor(t)
                                              for t in state)
    h, st = pxl.mlstm_chunked(
        *(torch.as_tensor(t) for t in (qp, kp, vp, ip, lfp)), chunk=8,
        state=tstate)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    for got, want in zip(st, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    h2, none = pxl.mlstm_chunked(
        *(torch.as_tensor(t) for t in (qp, kp, vp, ip, lfp)), chunk=8,
        state=tstate, final_state=False)
    assert none is None
    np.testing.assert_array_equal(h2.numpy(), h.numpy())
    cur = tstate or pxl.init_state(2, 3, 4, CPU)
    hs = []
    for t in range(q.shape[1]):
        cur, ht = pxl.mlstm_step(cur, *(torch.as_tensor(x[:, t])
                                        for x in (q, k, v, i_pre, lf)))
        hs.append(ht)
    np.testing.assert_allclose(h[:, :20].numpy(), torch.stack(hs, 1).numpy(),
                               **TOL)
    for got, want in zip(st, cur):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def _block(tree, kind, variant):
    """Block (1, last) of the mLSTM stack or period 1's sLSTM block in the
    periods variant (so a swapped index would read another block);
    block (0, 0) / period 0 at the smoke size."""
    i = 1 if variant == "periods" else 0
    pick = (lambda t: np.asarray(t)[i, -1]) if kind == "mlstm" else (
        lambda t: np.asarray(t)[i])
    return jax.tree.map(pick, tree["periods"][kind])


BLOCKS = {"mlstm": (jxl.mlstm_block, pxl.mlstm_block),
          "slstm": (jxl.slstm_block, pxl.slstm_block)}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_train_and_its_lora_grads_match_the_reference(kind):
    """The training path's output (24 positions: one mLSTM chunk of its
    own length, the reference's padded to 256) and the gradients of
    ⟨output, g⟩ with respect to the block's adapter factors."""
    jcfg = _jcfg("periods")
    jp, jl = _draws("periods")
    p, lo = _block(jp, kind, "periods"), _block(jl, kind, "periods")
    jfn_block, pfn_block = BLOCKS[kind]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    g = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def jfn(l, p, x, g):  # the arrays as arguments: no constant folding
        out, _ = jfn_block(jcfg, p, x, lora=l, lora_scale=SCALE)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        lo, p, x, g)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(lo, CPU)).items()}
    out, cache = pfn_block(_port_cfg(jcfg), params_from_numpy(p, CPU),
                           torch.as_tensor(x),
                           lora=unflatten_from_paths(flat), lora_scale=SCALE)
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(),
                                list(flat.values()))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(flat)
    assert len(jf) == (10 if kind == "mlstm" else 6)
    for k, got in zip(flat, grads):
        want = np.asarray(jf[k])
        assert np.abs(want).max() > 0, k
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), k


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_prefill_and_decode_match_the_reference(kind):
    """The block served, the mLSTM at chunk 16: a prefill of 40 tokens
    (three chunks, padded from 40 to 48) into a fresh cache, then 3
    decode steps; each output and every state after each."""
    jcfg = _jcfg("periods")
    jp, jl = _draws("periods")
    p, lo = _block(jp, kind, "periods"), _block(jl, kind, "periods")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 43, 256)).astype(np.float32)
    pcfg = _port_cfg(jcfg)
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(lo, CPU)
    jfn_block, pfn_block = BLOCKS[kind]
    kw = {"chunk": 16} if kind == "mlstm" else {}
    if kind == "mlstm":
        jcache = jxl.init_mlstm_cache(2, jcfg, jnp.float32)
        cache = pxl.init_mlstm_cache(2, pcfg, torch.float32, CPU)
    else:
        jcache = jxl.init_slstm_cache(2, jcfg, jnp.float32)
        cache = pxl.init_slstm_cache(2, pcfg, torch.float32, CPU)
    block = jax.jit(functools.partial(jfn_block, jcfg, lora_scale=SCALE,
                                      **kw), static_argnames=("decode",))
    with torch.inference_mode():
        for lo_t, hi_t in ((0, 40), (40, 41), (41, 42), (42, 43)):
            decode = lo_t > 0
            jout, jcache = block(p, jnp.asarray(x[:, lo_t:hi_t]), lora=lo,
                                 cache=jcache, decode=decode)
            out, cache = pfn_block(pcfg, tp, torch.as_tensor(x[:, lo_t:hi_t]),
                                   lora=tl, lora_scale=SCALE, cache=cache,
                                   decode=decode, **kw)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            assert sorted(cache) == sorted(jcache)
            for k in jcache:
                np.testing.assert_allclose(cache[k].numpy(),
                                           np.asarray(jcache[k]), **TOL)


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_lora_grads(variant):
    """The logits, the loss and its LoRA gradients over every stacked
    leaf of the adapter (40 positions: one mLSTM chunk)."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 41))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jlogits, (jloss, jgrads) = jax.jit(lambda lo, p, jb: (
        jm.apply(p, jb, lora=lo, lora_scale=SCALE)[0],
        jax.value_and_grad(lambda x: jm.loss(p, jb, lora=x,
                                             lora_scale=SCALE)[0])(lo)))(
                                                 l, p, jb)
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
    assert sorted(jf) == sorted(grads) and len(jf) == 16
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
    jpre = jax.jit(lambda p, lo, t, c: jm.prefill(p, {"tokens": t}, c,
                                                  lora=lo, lora_scale=SCALE))
    jdec = functools.partial(jax.jit(
        lambda p, lo, t, c, pos: jm.decode_step(p, t, c, pos, lora=lo,
                                                lora_scale=SCALE)), jp, jl)
    jlog, jc = jpre(jp, jl, jnp.asarray(toks[:, :prompt]),
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
    (the sLSTM's h) within one bf16 ulp more (2⁻⁷ relative: an h a hair
    apart in f32 may round to neighbouring bf16 values)."""
    rf, pf = jax_flatten(jc), flatten_with_paths(cache)
    assert sorted(pf) == sorted(rf)
    for k, x in rf.items():
        assert str(pf[k].dtype) == f"torch.{x.dtype}", k
        rtol = TOL["rtol"] + (2.0 ** -7 if x.dtype == jnp.bfloat16 else 0)
        np.testing.assert_allclose(pf[k].float().numpy(),
                                   np.asarray(x, np.float32), rtol=rtol,
                                   atol=TOL["atol"])


def test_prefill_and_decode_match_the_reference():
    """The periods variant: a prefill of 300 tokens (padded to 512, two
    mLSTM chunks of 256, so the inter-chunk recurrence runs) and 4 decode
    steps, f32 caches; the logits of each and every state after them."""
    jp, jl = _draws("periods")
    ref, port, jc, cache = _serve_both("periods", jp, jl, _tokens(4))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)
    _assert_caches_close(jc, cache)


def test_bf16_cache_keeps_the_references_dtypes():
    """f32 weights against a bf16 cache: the reference's conv state comes
    back in f32 (``jnp.concatenate`` promotes), so the port's conv buffers
    are widened to f32 before the first write and hold the same values;
    the sLSTM's h stays bf16 and is rounded to it at every step of the
    prefill, as the reference's carried state is; C, n, m and c stay
    f32."""
    jp, jl = _draws()
    ref, port, jc, cache = _serve_both("smoke", jp, jl, _tokens(5, 40),
                                       jnp.bfloat16)
    assert cache["mlstm"]["conv"].dtype == torch.float32
    assert cache["slstm"]["h"].dtype == torch.bfloat16
    assert {cache["mlstm"][k].dtype for k in ("C", "n", "m")} == {
        torch.float32}
    assert {cache["slstm"][k].dtype for k in ("c", "n", "m")} == {
        torch.float32}
    _assert_caches_close(jc, cache)
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)


def test_serving_runs_every_adapted_projection_fused():
    """In serving every adapted projection goes through the fused LoRA
    kernel's wrapper (``lora_dense``: B3 on the card, its plain version
    here): an mLSTM block's up_proj, q, k, v and down_proj, an sLSTM
    block's w_gates and its FFN's up_proj and down_proj — 8 a prefill and
    8 a decode step at the smoke size; the training forward none."""
    jp, jl = _draws()
    pm = build_model(_port_cfg(_jcfg()))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    toks = torch.as_tensor(_tokens(8, 24))
    calls = []
    real_ld = pcommon.lora_dense

    def ld(x, w, a, b, scale):
        calls.append((tuple(w.shape), x.shape[:-1].numel()))
        return real_ld(x, w, a, b, scale)

    pcommon.lora_dense = ld
    try:
        with torch.inference_mode():
            pm.apply(tp, {"tokens": toks}, lora=tl, lora_scale=SCALE)
            assert calls == []
            cache = pm.init_cache(2, 32, torch.float32, device=CPU)
            _, cache = pm.prefill(tp, {"tokens": toks[:, :20]}, cache,
                                  lora=tl, lora_scale=SCALE)
            pre = list(calls)
            pm.decode_step(tp, toks[:, 20:21], cache, 20, lora=tl,
                           lora_scale=SCALE)
            dec = calls[len(pre):]
    finally:
        pcommon.lora_dense = real_ld
    block = [(256, 1024), (512, 512), (512, 512), (512, 512), (512, 256),
             (256, 1024), (256, 341), (341, 256)]
    assert [w for w, _ in pre] == block
    assert {m for _, m in pre} == {40}
    assert [w for w, _ in dec] == block
    assert {m for _, m in dec} == {2}


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
        lg, jc = jax.jit(lambda p, lo, t, cc: m.prefill(
            p, {"tokens": t}, cc, lora=lo, lora_scale=SCALE))(
                p, jl, jnp.asarray(toks[:, :prompt]), m.init_cache(2, 64, cdt))
        rows = [np.asarray(lg, np.float32)[:, -1]]
        step = functools.partial(jax.jit(
            lambda p, lo, t, cc, pos: m.decode_step(
                p, t, cc, pos, lora=lo, lora_scale=SCALE)), p, jl)
        for pos in range(prompt, prompt + STEPS):
            lg, jc = step(jnp.asarray(toks[:, pos:pos + 1]), jc,
                          jnp.asarray(pos, jnp.int32))
            rows.append(np.asarray(lg, np.float32)[:, -1])
        out[name] = rows
    pm = build_model(_port_cfg(cfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    assert tp["periods"]["slstm"]["b_gates"].dtype == torch.float32
    got = []
    with torch.inference_mode():
        cache = pm.init_cache(2, 64, device=CPU)
        lg, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        assert cache["mlstm"]["conv"].dtype == torch.bfloat16
        assert cache["slstm"]["h"].dtype == torch.bfloat16
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
    """fedex through the engine on the periods variant: a uniform round
    of all 4 clients, then a weighted one at 50% participation with
    example weights; the closes fold the (2, 3, m, n) mLSTM leaves beside
    the (2, m, n) sLSTM ones."""
    jcfg = _jcfg("periods", vocab_size=VOCAB)
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
    assert len(keys) == 8 and sum(k.startswith("periods/slstm/")
                                  for k in keys) == 3
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
                     "--vocab", "64", "--clients", "2", "--rounds", "2",
                     "--local-steps", "1", "--batch-size", "2", "--seq-len",
                     "16", "--weighting", "examples", "--participation",
                     "0.5"])
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
def test_every_engine_close_runs_on_the_ssm_stack(args, capsys):
    """Every close of the engine folds the xLSTM tree, its (nper, blocks,
    m, n) mLSTM leaves and its (nper, m, n) sLSTM ones (the FFN's K or N
    341 among them), through the port's launcher on the CPU, to finite
    numbers."""
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
def test_lane_loss_equals_the_host_loss_on_each_lanes_rows(variant):
    """Mesh mode's loss over 2 lanes of 2 rows: each mLSTM block slices
    its lanes' factors behind the (nper, slstm_every − 1) axes, each sLSTM
    block behind nper (its FFN's too; w_gates' rows lane-major at every
    step of the recurrence); each lane's CE as the host loss on that
    lane's rows."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    lanes, stacked = _lane_stack(l, 2, seed=11)
    assert any(k.startswith("periods/slstm/ffn/")
               for k in flatten_with_paths(stacked))
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size,
                                              size=(4, 33))
    _, tb = _batches(toks)
    with torch.inference_mode():
        got = pm.lane_loss(tp, tb, stacked, lora_scale=SCALE)
        want = [pm.loss(tp, {k: v[2 * c:2 * c + 2] for k, v in tb.items()},
                        lora=lanes[c], lora_scale=SCALE)[0]
                for c in range(2)]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=1e-5)


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
    steps) against the reference's mesh trainer over the mLSTM and sLSTM
    blocks' 8 adapted leaves."""
    jt, pt = _mesh_trainers(_jcfg(vocab_size=VOCAB), JLoRAConfig(),
                            LoRAConfig())
    assert len(pt.closer.specs) == 8
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
