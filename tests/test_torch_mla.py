"""Multi-head Latent Attention in the port (``deepseek-v2-236b``) against
the JAX reference at its ``-smoke`` size, in f32 unless a test says
otherwise: 1 dense + 1 MoE layer, d 256, 4 heads, q_lora 64, kv_lora 32,
rope 16 / nope 32 / v 32, 4 experts top-2 of ff 256, 1 shared expert.

* the registry, and the parameter, adapter (with and without per-expert
  adapters) and cache trees, path for path; the bridge carries the MLA
  trees bit for bit;
* ``mla_block``'s training path and its LoRA gradients;
* B8's prefill with v zero-padded to q's head dim against unpadded
  ``flash_attention`` (the padded columns exactly 0);
* prefill plus absorbed decode with b ≠ 0 on every MLA projection, the
  caches after it; the decode step's parting from teacher forcing with
  k_up / v_up adapters live (the reference's decode never reads them),
  and its agreement with them zeroed;
* the logits, loss and aux; the model's LoRA gradients; the serving
  path's projections all through the fused LoRA kernel's wrapper;
* the host trainer with expert adapters round by round (uniform, then
  weighted at 50%); a bf16 prefill and decode; the launchers;
* mesh mode: ``lane_loss`` against the host loss on each lane's rows, one
  weighted round of the mesh trainer against the reference's (built with
  its dense MoE oracle, as ``tests/test_torch_moe.py`` explains), and the
  launcher's ``--mode mesh`` against the class.

Tolerances are ``tests/test_torch_moe.py``'s: logits and loss rtol 1e-5
of their scale, LoRA gradients within 1e-5 of each leaf's largest entry;
``mla_block`` outputs, prefill and decode logits and caches rtol / atol
1e-4; B8's padded prefill against ``flash_attention`` rtol / atol 1e-5
(f32 on both sides, another summation order); the trainer's losses rtol
1e-5, divergence rtol 1e-3, trees by relative Frobenius error ≤ 1e-2 and
the AdamW separation bound; bf16 the criterion of
``tests/test_torch_bf16.py`` (twice the reference's bf16 distance from
its f32 answer over the same weights, plus one bf16 rounding at the logit
scale).
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
from repro.models import mla as jmla  # noqa: E402
from repro.models.attention import flash_attention as jax_flash  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.lora import init_lora  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.kernels.flash_swa import swa_attention  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import mla as pmla  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b-smoke"
SCALE = 2.0  # α / r = 8 / 4
TOL = dict(rtol=1e-4, atol=1e-4)
EXPERTS = LoRAConfig(lora_experts=True)
J_EXPERTS = JLoRAConfig(lora_experts=True)
MLA_LEAVES = ("q_down", "q_up", "kv_down", "k_up", "v_up", "o_proj")


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


def _b_nonzero(tree, rng, std=0.02, zero=()):
    """Every adapter's b drawn N(0, std²) (init_lora's b is 0), but those
    of the projections named in ``zero``."""
    flat = jax_flatten(tree)
    return unflatten_from_paths({
        k: ((0 if k.split("/")[-2] in zero else std)
            * rng.standard_normal(x.shape)).astype(np.float32)
        if k.endswith("/b") else np.asarray(x) for k, x in flat.items()})


@functools.lru_cache(maxsize=None)
def _draws(experts=False, std=0.02, zero=()):
    """The reference's f32 draws: params, and an adapter (expert adapters
    with ``experts``) whose b is non-zero (but on ``zero``)."""
    jcfg = _jcfg()
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    lcfg = J_EXPERTS if experts else JLoRAConfig()
    jl = _np(jax_init_lora(jax.random.key(1), jp, jcfg, lcfg))
    return jp, _b_nonzero(jl, np.random.default_rng(2), std, zero)


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

def test_registry_has_deepseek_as_the_reference():
    assert "deepseek-v2-236b" in list_configs() and len(list_configs()) == 13
    for name in ("deepseek-v2-236b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        check_supported(get_config(name))
    c = get_config(ARCH)
    assert (c.mla, c.num_layers, c.first_k_dense, c.d_model, c.num_heads,
            c.q_lora_rank, c.kv_lora_rank, c.qk_rope_head_dim,
            c.qk_nope_head_dim, c.v_head_dim, c.num_experts,
            c.num_experts_per_tok, c.num_shared_experts) == (
        True, 2, 1, 256, 4, 64, 32, 16, 32, 32, 4, 2, 1)


@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
def test_param_adapter_and_cache_trees_line_up(experts):
    jcfg = _jcfg()
    jm = jax_build_model(jcfg)
    jp, jl = _draws(experts)
    jc = jm.init_cache(2, 40, jnp.float32)
    pm = build_model(_port_cfg(jcfg))
    gen = torch.Generator().manual_seed(0)
    pp = pm.init(gen, CPU)
    pl = init_lora(gen, pp, pm.cfg, EXPERTS if experts else LoRAConfig())
    pc = pm.init_cache(2, 40, torch.float32, device=CPU)
    for ref, port in ((jp, pp), (jl, pl), (jc, pc)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        assert all(tuple(rf[k].shape) == tuple(pf[k].shape) for k in rf), [
            (k, rf[k].shape, pf[k].shape) for k in rf
            if tuple(rf[k].shape) != tuple(pf[k].shape)]
    for stack in ("dense_layers", "layers"):
        assert sorted(pl[stack]["attn"]) == sorted(MLA_LEAVES)
        assert pc[stack]["c_kv"].shape[-1] == 32
        assert pc[stack]["k_rope"].shape[-1] == 16
        assert bool((pc[stack]["pos"] == -1).all())
    assert ("mlp" in pl["layers"]) == experts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_mla_trees_bit_for_bit(dtype):
    cfg = dataclasses.replace(jax_get_config(ARCH), dtype=dtype)
    jp = _np(jax.jit(jax_build_model(cfg).init)(jax.random.key(0)))
    jl = _np(jax_init_lora(jax.random.key(1), jp, cfg, J_EXPERTS))
    for tree in (jp, jl):
        port = params_from_numpy(tree, CPU)
        rf, pf = jax_flatten(tree), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        for k, x in rf.items():
            assert str(pf[k].dtype) == f"torch.{x.dtype}", k
            np.testing.assert_array_equal(
                pf[k].float().numpy(), np.asarray(x, np.float32))
    assert jax_flatten(jp)["layers/attn/kv_down/kernel"].shape == (1, 256, 48)


# --------------------------------------------------------------------------
# the MLA block
# --------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda t: np.asarray(t)[0], tree)


def test_mla_block_train_and_its_lora_grads_match_the_reference():
    """Layer 0 of the MoE stack: the output of the training path, and the
    gradients of ⟨output, g⟩ with respect to every MLA adapter factor."""
    jcfg = _jcfg()
    jp, jl = _draws()
    p, lo = _layer0(jp["layers"]["attn"]), _layer0(jl["layers"]["attn"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    g = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def jfn(l):
        out, _ = jmla.mla_block(jcfg, p, jnp.asarray(x), lora=l,
                                lora_scale=SCALE)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(lo)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(lo, CPU)).items()}
    out, cache = pmla.mla_block(_port_cfg(jcfg), params_from_numpy(p, CPU),
                                torch.as_tensor(x),
                                lora=unflatten_from_paths(flat),
                                lora_scale=SCALE)
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(),
                                list(flat.values()))
    for (k, got), want in zip(zip(flat, grads), [
            np.asarray(jax_flatten(jgrads)[k]) for k in flat]):
        assert np.abs(want).max() > 0, k
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), k


def test_padded_v_prefill_equals_unpadded_flash_attention():
    """B8 takes one head dim for q, k and v: v zero-padded from 32 to q's
    48 gives columns 32..47 exactly 0 and the first 32 those of
    ``flash_attention`` on the unpadded v (the port's and the
    reference's), at the scale 48^-½."""
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((2, 40, 4, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(t) for t in (q, k, v))
    got = swa_attention(tq, tk, torch.nn.functional.pad(tv, (0, 16)),
                        causal=True, window=0)
    assert got.shape == (2, 40, 4, 48)
    assert bool((got[..., 32:] == 0).all())
    want = flash_attention(tq, tk, tv)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               True, 0, 0, 1024))
    np.testing.assert_allclose(got[..., :32].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., :32].numpy(), ref, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

PROMPT, STEPS, MAX_LEN = 24, 6, 40


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """The reference's f32 model and its jitted prefill, decode step and
    training forward, the weights passed as arguments (one compile a
    shape for every test)."""
    jm = jax_build_model(_jcfg())
    pre = jax.jit(lambda p, l, t, c: jm.prefill(p, {"tokens": t}, c, lora=l,
                                                lora_scale=SCALE))
    dec = jax.jit(lambda p, l, t, c, pos: jm.decode_step(
        p, t, c, pos, lora=l, lora_scale=SCALE))
    apply = jax.jit(lambda p, l, t: jm.apply(p, {"tokens": t}, lora=l,
                                             lora_scale=SCALE)[0])
    return jm, pre, dec, apply


def _serve_both(jp, jl, toks):
    """Prefill of PROMPT tokens then STEPS teacher-forced decode steps,
    f32 caches, in both frameworks: (reference's logits, port's logits),
    each the prefill's then every step's, and both caches after."""
    jm, jpre, jdec, _ = _jax_fns()
    pm = build_model(_port_cfg(_jcfg()))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    jlog, jc = jpre(jp, jl, jnp.asarray(toks[:, :PROMPT]),
                    jm.init_cache(2, MAX_LEN, jnp.float32))
    ref, port = [np.asarray(jlog)], []
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, torch.float32, device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, cache, lora=tl, lora_scale=SCALE)
        port.append(tlog.numpy())
        for pos in range(PROMPT, PROMPT + STEPS):
            tok = toks[:, pos:pos + 1]
            jd, jc = jdec(jp, jl, jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(pos, jnp.int32))
            td, cache = pm.decode_step(tp, torch.as_tensor(tok), cache, pos,
                                       lora=tl, lora_scale=SCALE)
            ref.append(np.asarray(jd))
            port.append(td.numpy())
    return ref, port, _np(jc), cache


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 512,
                                                size=(2, PROMPT + STEPS))


def test_prefill_and_decode_match_the_reference():
    """b ≠ 0 on every MLA projection (and on the experts): the prefill's
    logits, each absorbed decode step's, and the latent caches after."""
    jp, jl = _draws(True)
    ref, port, jc, cache = _serve_both(jp, jl, _tokens(4))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)
    pf = flatten_with_paths(cache)
    assert sorted(pf) == sorted(jax_flatten(jc))
    for k, x in jax_flatten(jc).items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(pf[k].numpy(), x)
        else:
            np.testing.assert_allclose(pf[k].numpy(), x, **TOL)
    assert int(pf["layers/pos"].max()) == PROMPT + STEPS - 1


@pytest.mark.parametrize("k_v_up", ["live", "zeroed"])
def test_decode_parts_from_teacher_forcing_as_the_reference(k_v_up):
    """The absorbed decode reads the raw k_up / v_up kernels, never their
    adapters, while the training forward applies them. With b ~ N(0,
    0.05²) on every adapter ("live") each framework's last decode step
    parts from its own training forward over the same tokens, by the same
    amount within the tolerance; with k_up's and v_up's b zeroed both
    agree with it."""
    zero = ("k_up", "v_up") if k_v_up == "zeroed" else ()
    jp, jl = _draws(False, 0.05, zero)
    toks = _tokens(6)
    ref, port, _, _ = _serve_both(jp, jl, toks)
    jtrain = np.asarray(_jax_fns()[3](jp, jl, jnp.asarray(toks)))[:, -1]
    with torch.inference_mode():
        ptrain = build_model(_port_cfg(_jcfg())).apply(
            params_from_numpy(jp, CPU), {"tokens": torch.as_tensor(toks)},
            lora=params_from_numpy(jl, CPU), lora_scale=SCALE)[:, -1].numpy()
    np.testing.assert_allclose(ptrain, jtrain, **TOL)
    np.testing.assert_allclose(port[-1][:, -1], ref[-1][:, -1], **TOL)
    jgap = np.abs(ref[-1][:, -1] - jtrain).max()
    pgap = np.abs(port[-1][:, -1] - ptrain).max()
    scale = np.abs(jtrain).max()
    print(f"k_up/v_up adapters {k_v_up}: decode vs teacher forcing, reference "
          f"{jgap:.3e}, port {pgap:.3e}, logit scale {scale:.3f}")
    assert abs(pgap - jgap) <= TOL["atol"] + TOL["rtol"] * scale
    if k_v_up == "zeroed":
        assert pgap <= TOL["atol"] + TOL["rtol"] * scale
    else:
        assert pgap > 100 * (TOL["atol"] + TOL["rtol"] * scale)


def test_serving_runs_every_adapted_mla_projection_fused():
    """In serving every adapted projection goes through the fused LoRA
    kernel's wrapper (``lora_dense``: B3 on the card, its plain version
    here) and every prefill attention through B8's (``swa_attention``):
    a prefill 6 MLA projections a layer (k_up and v_up included), a decode
    step 4 (q_down, q_up, kv_down, o_proj: k_up and v_up are absorbed) and
    no attention kernel; the training forward none."""
    jp, jl = _draws()
    pm = build_model(_port_cfg(_jcfg()))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    toks = torch.as_tensor(_tokens(8))
    calls = {"lora_dense": [], "swa_attention": 0}
    real_ld, real_swa = pcommon.lora_dense, pmla.swa_attention

    def ld(x, w, a, b, scale):
        calls["lora_dense"].append((tuple(w.shape), x.shape[:-1].numel()))
        return real_ld(x, w, a, b, scale)

    def swa(q, k, v, causal=True, window=0):
        calls["swa_attention"] += 1
        assert q.shape[-1] == k.shape[-1] == v.shape[-1] == 48
        return real_swa(q, k, v, causal, window)

    pcommon.lora_dense, pmla.swa_attention = ld, swa
    try:
        with torch.inference_mode():
            pm.apply(tp, {"tokens": toks}, lora=tl, lora_scale=SCALE)
            assert calls == {"lora_dense": [], "swa_attention": 0}
            cache = pm.init_cache(2, MAX_LEN, torch.float32, device=CPU)
            _, cache = pm.prefill(tp, {"tokens": toks[:, :PROMPT]}, cache,
                                  lora=tl, lora_scale=SCALE)
            pre = list(calls["lora_dense"])
            assert calls["swa_attention"] == 2
            pm.decode_step(tp, toks[:, PROMPT:PROMPT + 1], cache, PROMPT,
                           lora=tl, lora_scale=SCALE)
            dec = calls["lora_dense"][len(pre):]
    finally:
        pcommon.lora_dense, pmla.swa_attention = real_ld, real_swa
    d, kvr, h = 256, 32, 4
    layer = [(d, 64), (64, h * 48), (d, kvr + 16), (kvr, h * 32),
             (kvr, h * 32), (h * 32, d)]
    assert [w for w, _ in pre] == layer * 2
    assert {m for _, m in pre} == {2 * PROMPT}
    assert [w for w, _ in dec] == [layer[i] for i in (0, 1, 2, 5)] * 2
    assert {m for _, m in dec} == {2}
    assert calls["swa_attention"] == 2


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
def test_logits_loss_and_aux(experts):
    jcfg = _jcfg()
    p, l = _draws(experts)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 41))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    (jlogits, jaux), (jloss, jmet) = jax.jit(lambda lo: (
        jm.apply(p, jb, lora=lo, lora_scale=SCALE),
        jm.loss(p, jb, lora=lo, lora_scale=SCALE)))(l)
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    with torch.no_grad():
        logits, aux = pm.apply(tp, tb, lora=tl, lora_scale=SCALE,
                               with_aux=True)
        loss, met = pm.loss(tp, tb, lora=tl, lora_scale=SCALE)
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name in ("aux_loss", "total_loss", "loss"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=1e-5)
    assert float(met["aux_loss"]) > 0


def test_lora_grads_match_the_reference():
    """The LoRA gradients of the loss (CE + aux) through both MLA stacks
    and the expert adapters."""
    jcfg = _jcfg()
    p, l = _draws(True)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 41))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jgrads = jax.jit(jax.grad(lambda x: jm.loss(p, jb, lora=x,
                                                 lora_scale=SCALE)[0]))(l)
    pm = build_model(_port_cfg(jcfg))
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    loss, _ = pm.loss(params_from_numpy(p, CPU), tb,
                      lora=unflatten_from_paths(flat), lora_scale=SCALE)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(grads)
    for k, g in jf.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(g).max(), k


def test_bf16_prefill_and_decode_against_the_f32_answer():
    """The config's bf16 (no dtype override), the reference's bf16 draws
    with b ≠ 0, bf16 caches: the port's prefill logits and each decode
    step's no further from the reference's f32 answer over the same
    weights (f32 cache) than twice the reference's own bf16 run, plus one
    bf16 rounding at the logit scale (2⁻⁸ · max |f32 logit|)."""
    cfg = jax_get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jp = _np(jax.jit(jax_build_model(cfg).init)(jax.random.key(3)))
    jl = _b_nonzero(_np(jax_init_lora(jax.random.key(4), jp, cfg,
                                      JLoRAConfig())),
                    np.random.default_rng(5))
    toks = _tokens(9)
    out = {}
    for name, c, p, cdt in (
            ("bf16", cfg, jp, jnp.bfloat16),
            ("f32", dataclasses.replace(cfg, dtype="float32"),
             jax.tree.map(lambda t: t.astype(np.float32), jp), jnp.float32)):
        m = jax_build_model(c)
        lg, jc = jax.jit(lambda cc: m.prefill(p, {"tokens": jnp.asarray(
            toks[:, :PROMPT])}, cc, lora=jl, lora_scale=SCALE))(
                m.init_cache(2, MAX_LEN, cdt))
        rows = [np.asarray(lg, np.float32)[:, -1]]
        step = jax.jit(lambda t, cc, pos: m.decode_step(
            p, t, cc, pos, lora=jl, lora_scale=SCALE))
        for pos in range(PROMPT, PROMPT + STEPS):
            lg, jc = step(jnp.asarray(toks[:, pos:pos + 1]), jc,
                          jnp.asarray(pos, jnp.int32))
            rows.append(np.asarray(lg, np.float32)[:, -1])
        out[name] = rows
    pm = build_model(get_config(ARCH))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    got = []
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, device=CPU)
        assert cache["layers"]["c_kv"].dtype == torch.bfloat16
        lg, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, cache, lora=tl, lora_scale=SCALE)
        got.append(lg[:, -1].float().numpy())
        for pos in range(PROMPT, PROMPT + STEPS):
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
    """fedex with expert adapters through the engine: a uniform round of
    all 4 clients, then a weighted one at 50% participation with example
    weights; the closes fold the MLA leaves of both stacks beside the raw
    (L, E, d, ff) expert leaves."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=2, local_steps=TRAIN_STEPS)
    train = dict(learning_rate=LR, schedule="constant")
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=J_EXPERTS,
                    fed_cfg=JFedConfig(engine="jnp", **fed),
                    train_cfg=JTrainConfig(**train), client_loaders=jl,
                    eval_batches=je, seed=0)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=2,
                                  seed=0, device=CPU)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=EXPERTS,
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**train),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    assert pt.engine is not None
    assert sum(not s.has_kernel for s in pt.engine.specs) == 3
    assert sum(s.key.endswith("k_up") for s in pt.engine.specs) == 2
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


@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
def test_lane_loss_equals_the_host_loss_on_each_lanes_rows(experts):
    """Mesh mode's loss over 2 lanes of 2 rows: lane c's factors on every
    MLA projection of both stacks (and its expert factors) apply to its
    rows alone; each lane's CE plus its own aux, as the host loss on that
    lane's rows."""
    jcfg = _jcfg()
    p, l = _draws(experts)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    lanes, stacked = _lane_stack(l, 2, seed=11)
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


def test_mesh_trainer_matches_the_references_dense_oracle():
    """One weighted fedex round of 2 lanes (example weights, 3 local
    steps) with per-expert adapters against the reference's mesh trainer,
    whose MoE model is the dense oracle (its ragged one cannot run under
    the round's vmap); the close folds the MLA leaves of both stacks and
    the raw expert leaves."""
    jt, pt = _mesh_trainers(_jcfg(vocab_size=VOCAB), J_EXPERTS, EXPERTS,
                            moe_impl="dense")
    assert sum(s.key.endswith("k_up") for s in pt.closer.specs) == 2
    assert sum(not s.has_kernel for s in pt.closer.specs) == 3
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
