"""The MoE family in the port (``mixtral-8x22b``) against the JAX reference
at its ``-smoke`` size in f32: 2 layers, d 256, 4 heads of 64, 4 experts
top-2 of ff 256, window 64.

* the registry and the parameter, adapter and cache trees, with and
  without per-expert adapters (``LoRAConfig.lora_experts``);
* ``router_topk``: indices, weights and aux loss, on random inputs and on
  constructed ties (``lax.top_k`` puts the lower index first);
* ``moe_block``, ragged and dense, with and without expert adapters and
  with a shared expert, against the reference's; ragged against dense in
  the port;
* ``merge_lora`` and ``apply_residual`` on the raw expert leaves;
* the forward, loss (aux included) and LoRA gradients, also with a shared
  expert and a leading dense layer; prefill plus decode;
* the host trainer with expert adapters (a uniform round, then a weighted
  one at 50%) round by round, the engine's hetero close over expert
  leaves, a bf16 prefill;
* mesh mode: ``lane_loss`` (each lane's CE plus its own aux) against the
  host loss on that lane's rows, ``moe_block`` under lanes against each
  lane alone (ragged and dense) and ragged against dense, one weighted
  round of the mesh trainer against the reference's, built with its
  dense oracle (its ragged one raises under the round's vmap, pinned),
  and the launcher's ``--mode mesh`` against the class.

Every whole-model comparison first asserts that the routing of every layer
(the top-k indices each call of ``router_topk`` returns) equals the
reference's, so that a flip across frameworks shows as one and is never
absorbed by a tolerance; each test reports the smallest gap between the
k-th and (k+1)-th probability it saw.

Tolerances are ``tests/test_torch_zoo.py``'s: logits and loss rtol 1e-5 of
their scale, LoRA gradients within 1e-5 of each leaf's largest entry;
prefill and decode logits, ``moe_block`` outputs and the raw folds rtol /
atol 1e-4 (ragged against dense: the same, the two sum the experts in
another order); the trainer's losses rtol 1e-5, divergence rtol 1e-3,
trees by relative Frobenius error ≤ 1e-2 and the AdamW separation bound;
the hetero close ``tests/test_torch_closes.py``'s (1e-4 of the update);
the bf16 prefill ``tests/test_torch_bf16.py``'s criterion (twice the
reference's bf16 distance from its f32 answer over the same weights, plus
one bf16 rounding at the logit scale).
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
from repro.core import aggregation as jagg  # noqa: E402
from repro.core.engine import RoundCloseEngine as JaxEngine  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.core.lora import merge_lora as jax_merge_lora  # noqa: E402
from repro.fedsrv import RoundPolicy as JPolicy  # noqa: E402
from repro.launch import mesh_train as jmesh  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core.engine import RoundCloseEngine  # noqa: E402
from repro_torch.core.lora import init_lora, merge_lora  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "mixtral-8x22b-smoke"
SCALE = 2.0  # α / r = 8 / 4
TOL = dict(rtol=1e-4, atol=1e-4)
EXPERTS = LoRAConfig(lora_experts=True)
J_EXPERTS = JLoRAConfig(lora_experts=True)
# the variants of the config, each applied on both sides
VARIANTS = {"mixtral": {}, "shared": {"num_shared_experts": 1},
            "first_k_dense": {"first_k_dense": 1, "dense_d_ff": 256}}


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


def _jcfg(variant="mixtral", **kw):
    return dataclasses.replace(jax_get_config(ARCH), dtype="float32",
                               **VARIANTS[variant], **kw)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


def _b_nonzero(tree, rng):
    """Every adapter's b drawn N(0, 0.02²) (init_lora's b is 0)."""
    flat = jax_flatten(tree)
    return unflatten_from_paths({
        k: ((0.02 * rng.standard_normal(x.shape)).astype(np.float32)
            if k.endswith("/b") else np.asarray(x)) for k, x in flat.items()})


@functools.lru_cache(maxsize=None)
def _draws(variant="mixtral", experts=True):
    """The reference's f32 draws: params, and an adapter (expert adapters
    with ``experts``) whose b is non-zero."""
    jcfg = _jcfg(variant)
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    lcfg = J_EXPERTS if experts else JLoRAConfig()
    jl = _np(jax_init_lora(jax.random.key(1), jp, jcfg, lcfg))
    return jp, _b_nonzero(jl, np.random.default_rng(2))


def _margin(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability."""
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


@pytest.fixture
def routes(monkeypatch):
    """The top-k indices (and the k-th margin) of every ``router_topk``
    call, in call order: (reference's, port's)."""
    ref, port = [], []
    j_orig, p_orig = jmoe.router_topk, pmoe.router_topk

    def j_logged(cfg, rp, x):
        w, idx, aux = j_orig(cfg, rp, x)
        probs = jax.nn.softmax(jnp.matmul(x, rp["kernel"]).astype(
            jnp.float32), axis=-1)
        jax.debug.callback(lambda i, p: ref.append((np.asarray(i),
                                                    np.asarray(p))),
                           idx, probs, ordered=True)
        return w, idx, aux

    def p_logged(cfg, rp, x, lanes=None):
        w, idx, aux = p_orig(cfg, rp, x, lanes)
        probs = torch.softmax(torch.matmul(x, rp["kernel"]).float(), -1)
        port.append((idx.numpy().copy(), probs.detach().numpy().copy()))
        return w, idx, aux

    monkeypatch.setattr(jmoe, "router_topk", j_logged)
    monkeypatch.setattr(pmoe, "router_topk", p_logged)
    return ref, port


def _same_routes(routes, k=2):
    """Every layer's routing equals the reference's; the smallest k-th
    margin seen."""
    ref, port = routes
    assert len(ref) == len(port) > 0
    for (ji, jp), (pi, _) in zip(ref, port):
        np.testing.assert_array_equal(pi, ji)
    return min(_margin(jp, k) for _, jp in ref)


# --------------------------------------------------------------------------
# registry and trees
# --------------------------------------------------------------------------

def test_registry_has_mixtral_as_the_reference():
    assert "mixtral-8x22b" in list_configs()
    for name in ("mixtral-8x22b", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.num_experts, c.num_experts_per_tok,
            c.moe_d_ff, c.sliding_window) == ("moe", 2, 4, 2, 256, 64)


@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_adapter_and_cache_trees_line_up(variant, experts):
    jcfg = _jcfg(variant)
    jm = jax_build_model(jcfg)
    jp, jl = _draws(variant, experts)
    jc = jm.init_cache(2, 96, jnp.float32)
    pm = build_model(_port_cfg(jcfg))
    gen = torch.Generator().manual_seed(0)
    pp = pm.init(gen, CPU)
    pl = init_lora(gen, pp, pm.cfg, EXPERTS if experts else LoRAConfig())
    pc = pm.init_cache(2, 96, torch.float32, device=CPU)
    for ref, port in ((jp, pp), (jl, pl), (jc, pc)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        assert all(tuple(rf[k].shape) == tuple(pf[k].shape) for k in rf), [
            (k, rf[k].shape, pf[k].shape) for k in rf
            if tuple(rf[k].shape) != tuple(pf[k].shape)]
    assert pp["layers"]["mlp"]["experts"]["down_proj"].shape == (
        pm.cfg.num_layers - pm.cfg.first_k_dense, 4, 256, 256)
    assert ("experts" in pl["layers"]["mlp"]) == experts if "mlp" in pl[
        "layers"] else not experts
    assert pc["layers"]["k"].shape[2] == 64  # the window's ring


def test_include_mlp_adapts_no_raw_expert_tensor():
    """As in the reference, ``include_mlp`` adapts projection modules (the
    shared expert's) and never the raw expert stacks."""
    jcfg = _jcfg("shared")
    jp, _ = _draws("shared")
    ref = jax_init_lora(jax.random.key(1), jp, jcfg,
                        JLoRAConfig(include_mlp=True))
    pm = build_model(_port_cfg(jcfg))
    pl = init_lora(torch.Generator().manual_seed(0),
                   params_from_numpy(jp, CPU), pm.cfg,
                   LoRAConfig(include_mlp=True))
    assert sorted(jax_flatten(ref)) == sorted(flatten_with_paths(pl))
    assert "experts" not in pl["layers"]["mlp"]
    assert "shared" in pl["layers"]["mlp"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_moe_trees_bit_for_bit(dtype):
    """The bridge needs no MoE branch: the raw expert leaves, the router
    and the per-expert adapters cross as any nested-dict leaf, bf16 ones as
    bf16."""
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
    assert jax_flatten(jp)["layers/mlp/experts/up_proj"].shape == (2, 4, 256,
                                                                   256)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

def _tie_case():
    """x = I (5 × 5) and a router (5, 4) whose rows are the logits: ties
    between the 2nd and 3rd, the 1st and 2nd, all four, and two pairs."""
    rows = np.asarray([[.1, .3, .3, .3], [.5, .5, .1, 0.], [.2, .2, .2, .2],
                       [0., .4, .1, .4], [.3, .1, .3, .3]], np.float32)
    return np.eye(5, dtype=np.float32), rows


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "ties"])
def test_router_topk_matches_the_reference(case):
    jcfg = _jcfg()
    if case == "ties":
        x, kernel = _tie_case()
        jcfg = dataclasses.replace(jcfg, num_experts=4)
    else:
        rng = np.random.default_rng(int(case[-1]))
        x = rng.standard_normal((64, 256)).astype(np.float32)
        kernel = (0.02 * rng.standard_normal((256, 4))).astype(np.float32)
    jw, ji, jaux = jax.jit(lambda a, k: jmoe.router_topk(
        jcfg, {"kernel": k}, a))(x, kernel)
    pw, pi, paux = pmoe.router_topk(_port_cfg(jcfg),
                                    {"kernel": torch.as_tensor(kernel)},
                                    torch.as_tensor(x))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    if case == "ties":
        # lax.top_k's order among equal probabilities; torch.topk's differs
        np.testing.assert_array_equal(pi.numpy(), [[1, 2], [0, 1], [0, 1],
                                                   [1, 3], [0, 2]])


# --------------------------------------------------------------------------
# the MoE block
# --------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda t: np.asarray(t)[0], tree)


def _block_inputs(variant, experts, seed=5):
    jp, jl = _draws(variant, experts)
    p = _layer0(jp["layers"]["mlp"])
    lo = _layer0(jl["layers"]["mlp"]) if "mlp" in jl["layers"] else None
    x = np.random.default_rng(seed).standard_normal((2, 24, 256)).astype(
        np.float32)
    return p, lo, x


@pytest.mark.parametrize("impl", ["ragged", "dense"])
@pytest.mark.parametrize("variant,experts", [("mixtral", True),
                                             ("mixtral", False),
                                             ("shared", True)])
def test_moe_block_matches_the_reference(impl, variant, experts):
    jcfg = _jcfg(variant)
    p, lo, x = _block_inputs(variant, experts)
    if variant == "shared" and lo is not None:
        # an adapter on the shared expert too (d = ff = 256 at -smoke)
        rng = np.random.default_rng(9)
        lo = dict(lo, shared={k: {
            "a": (0.02 * rng.standard_normal((256, 4))).astype(np.float32),
            "b": (0.02 * rng.standard_normal((4, 256))).astype(np.float32)}
            for k in ("up_proj", "gate_proj", "down_proj")})
    jy, jaux = jax.jit(lambda a: jmoe.moe_block(
        jcfg, p, a, lora=lo, lora_scale=SCALE, impl=impl))(x)
    ty, taux = pmoe.moe_block(_port_cfg(jcfg), params_from_numpy(p, CPU),
                              torch.as_tensor(x),
                              lora=None if lo is None else params_from_numpy(
                                  lo, CPU),
                              lora_scale=SCALE, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
def test_ragged_equals_dense_in_the_port(experts):
    cfg = _port_cfg(_jcfg())
    p, lo, x = _block_inputs("mixtral", experts, seed=6)
    tp = params_from_numpy(p, CPU)
    tl = None if lo is None else params_from_numpy(lo, CPU)
    tx = torch.as_tensor(x)
    yr, ar = pmoe.moe_block(cfg, tp, tx, lora=tl, lora_scale=SCALE)
    yd, ad = pmoe.moe_block(cfg, tp, tx, lora=tl, lora_scale=SCALE,
                            impl="dense")
    np.testing.assert_allclose(yr.numpy(), yd.numpy(), **TOL)
    assert float(ar) == float(ad)
    with pytest.raises(ValueError, match="moe impl"):
        pmoe.moe_block(cfg, tp, tx, impl="megablocks")


def test_ragged_serving_path_equals_the_training_path():
    """``fused`` (a cache is present) sends every expert group's adapted
    projections through ``lora_dense``; on the CPU its plain version gives
    the training path's function."""
    cfg = _port_cfg(_jcfg())
    p, lo, x = _block_inputs("mixtral", True, seed=7)
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(lo, CPU)
    calls = []
    real = pmoe.project

    def counted(inp, params, lora, scale, fused):
        calls.append((fused, lora is not None))
        return real(inp, params, lora, scale, fused)

    pmoe.project = counted
    try:
        with torch.inference_mode():
            y0, _ = pmoe.moe_block(cfg, tp, torch.as_tensor(x), lora=tl,
                                   lora_scale=SCALE)
            y1, _ = pmoe.moe_block(cfg, tp, torch.as_tensor(x), lora=tl,
                                   lora_scale=SCALE, fused=True)
    finally:
        pmoe.project = real
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), **TOL)
    assert calls[len(calls) // 2:] == [(True, True)] * (len(calls) // 2)


# --------------------------------------------------------------------------
# merge_lora and apply_residual on raw leaves
# --------------------------------------------------------------------------

def test_merge_lora_and_apply_residual_fold_raw_expert_leaves():
    jp, jl = _draws()
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    want = _np(jax_merge_lora(jp, jl, SCALE))
    got = to_numpy(merge_lora(tp, tl, SCALE))
    rng = np.random.default_rng(3)
    res = jax.tree.map(lambda f: np.asarray(f["a"] @ f["b"]) + np.float32(
        0.01) * rng.standard_normal(f["a"].shape[:-1] + f["b"].shape[-1:]
                                    ).astype(np.float32),
        jl, is_leaf=lambda n: isinstance(n, dict) and "a" in n)
    # the reference's walk takes jax arrays as residual leaves
    want_r = _np(jagg.apply_residual(jp, jax.tree.map(jnp.asarray, res),
                                     SCALE))
    got_r = to_numpy(agg.apply_residual(tp, params_from_numpy(res, CPU),
                                        SCALE))
    for w, g in ((want, got), (want_r, got_r)):
        wf, gf = jax_flatten(w), flatten_with_paths(g)
        assert sorted(wf) == sorted(gf)
        for k in wf:
            np.testing.assert_allclose(gf[k], wf[k], rtol=1e-6, atol=1e-7)
    key = "layers/mlp/experts/up_proj"
    for g in (got, got_r):
        assert not np.array_equal(flatten_with_paths(g)[key],
                                  jax_flatten(jp)[key])


# --------------------------------------------------------------------------
# forward, loss and gradients; prefill and decode
# --------------------------------------------------------------------------

def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_aux(variant, routes):
    """A sequence of 80 tokens, past the window of 64: logits, the router
    aux loss summed over the layers, and the loss (CE + aux) with its
    metrics."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 81))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    (jlogits, jaux), (jloss, jmet) = jax.jit(lambda lo: (
        jm.apply(p, jb, lora=lo, lora_scale=SCALE),
        jm.loss(p, jb, lora=lo, lora_scale=SCALE)))(l)
    jax.effects_barrier()
    del routes[0][len(routes[0]) // 2:]  # the loss's own forward
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    logits, aux = pm.apply(tp, tb, lora=tl, lora_scale=SCALE, with_aux=True)
    margin = _same_routes(routes)
    assert margin > 1e-6, margin
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
    assert float(loss) == float(met["loss"] + met["aux_loss"])


def test_lora_grads_and_the_aux_gradient():
    """The LoRA gradients of the loss, and those of the aux loss alone,
    which reach the attention adapters upstream of the router through p̄,
    as in the reference."""
    jcfg = _jcfg()
    p, l = _draws()
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 81))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    jgrads, jaux_grads = jax.jit(lambda lo: (
        jax.grad(lambda x: jm.loss(p, jb, lora=x, lora_scale=SCALE)[0])(lo),
        jax.grad(lambda x: jm.apply(p, jb, lora=x,
                                    lora_scale=SCALE)[1])(lo)))(l)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    loss, _ = pm.loss(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    _, aux = pm.apply(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE, with_aux=True)
    aux_grads = dict(zip(flat, torch.autograd.grad(
        aux, list(flat.values()), allow_unused=True)))
    for k, g in jax_flatten(jgrads).items():
        g = np.asarray(g)
        assert np.abs(grads[k].numpy() - g).max() <= 1e-5 * np.abs(g).max(), k
    for k in ("layers/attn/q_proj/a", "layers/attn/v_proj/b"):
        want = np.asarray(jax_flatten(jaux_grads)[k])
        assert np.abs(want).max() > 0
        assert np.abs(aux_grads[k].numpy() - want).max() <= 1e-4 * np.abs(
            want).max(), k


@pytest.mark.parametrize("variant", ["mixtral", "first_k_dense"])
def test_prefill_and_decode_match_the_reference(variant, routes):
    """Prefill of 64 tokens (the window: a full ring), then 8
    teacher-forced decode steps past it, f32 caches on both sides; the last
    step equals the port's own training forward. (A prompt longer than the
    ring and not a multiple of it leaves the ring misaligned for decode, in
    the reference as in the port: ROADMAP.)"""
    jcfg = _jcfg(variant)
    p, l = _draws(variant)
    prompt, steps, max_len = 64, 8, 96
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             size=(2, prompt + steps))
    jpre = jax.jit(lambda c: jm.prefill(p, {"tokens": jnp.asarray(
        toks[:, :prompt])}, c, lora=l, lora_scale=SCALE))
    jdec = jax.jit(lambda t, c, pos: jm.decode_step(p, t, c, pos, lora=l,
                                                    lora_scale=SCALE))
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    jlog, jc = jpre(jm.init_cache(2, max_len, jnp.float32))
    with torch.inference_mode():
        cache = pm.init_cache(2, max_len, torch.float32, device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for pos in range(prompt, prompt + steps):
            tok = toks[:, pos:pos + 1]
            jl_i, jc = jdec(jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32))
            tl_i, cache = pm.decode_step(tp, torch.as_tensor(tok), cache,
                                         pos, lora=tl, lora_scale=SCALE)
            np.testing.assert_allclose(tl_i.numpy(), np.asarray(jl_i), **TOL)
        jax.effects_barrier()
        margin = _same_routes(routes)
        assert margin > 1e-6, margin
        full = pm.apply(tp, {"tokens": torch.as_tensor(toks)}, lora=tl,
                        lora_scale=SCALE)
        np.testing.assert_allclose(tl_i[:, -1].numpy(), full[:, -1].numpy(),
                                   **TOL)
    pf = flatten_with_paths(cache)
    for k, x in jax_flatten(_np(jc)).items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(pf[k].numpy(), x)
        else:
            np.testing.assert_allclose(pf[k].numpy(), x, **TOL)


def test_bf16_prefill_against_the_f32_answer(routes):
    """The config's bf16 (no dtype override), the reference's bf16 draws
    with expert adapters: the port's prefill logits are held to the
    criterion against the reference's f32 prefill over the same bf16
    weights. Routing first: bf16 rounds at other places in the two
    frameworks, so a token whose top-k margin in the reference's bf16 run
    is within twice the reference's own bf16 noise on the probabilities
    (their largest distance from its f32 run's) may route either way; every
    other token routes as the reference's. The near-ties, the flips among
    them with their margins, and the rows with an exact tie among the
    bf16-rounded probabilities are printed."""
    cfg = jax_get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    jp = _np(jax.jit(jax_build_model(cfg).init)(jax.random.key(3)))
    jl = _b_nonzero(_np(jax_init_lora(jax.random.key(4), jp, cfg, J_EXPERTS)),
                    np.random.default_rng(5))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 40))
    batch = {"tokens": jnp.asarray(toks)}
    out, ref_routes = {}, {}
    for name, c, p in (("bf16", cfg, jp),
                       ("f32", dataclasses.replace(cfg, dtype="float32"),
                        jax.tree.map(lambda t: t.astype(np.float32), jp))):
        m = jax_build_model(c)
        lg, _ = jax.jit(jax_prefill_step(m, J_EXPERTS))(
            p, jl, batch, m.init_cache(2, 40))
        out[name] = np.asarray(lg)[:, -1]
        jax.effects_barrier()
        ref_routes[name] = list(routes[0])
        routes[0].clear()
    pm = build_model(get_config(ARCH))
    with torch.inference_mode():
        lg, _ = make_prefill_step(pm, EXPERTS)(
            params_from_numpy(jp, CPU), params_from_numpy(jl, CPU),
            {"tokens": torch.as_tensor(toks)}, pm.init_cache(2, 40,
                                                             device=CPU))
    assert len(routes[1]) == len(ref_routes["bf16"]) == cfg.num_layers
    near, flips, ties = 0, [], 0
    for (ji, jpb), (_, jpf), (pi, pp) in zip(ref_routes["bf16"],
                                             ref_routes["f32"], routes[1]):
        noise = 2 * float(np.abs(jpb - jpf).max())
        top = np.sort(jpb, axis=-1)[:, ::-1]
        margin = top[:, 1] - top[:, 2]
        sure = margin > noise
        np.testing.assert_array_equal(pi[sure], ji[sure])
        near += int((~sure).sum())
        flips += [float(x) for x in margin[(pi != ji).any(-1)]]
        ties += int((np.diff(np.sort(pp, -1), axis=-1) == 0).any(-1).sum())
    print(f"bf16 routing: {near} near-tie tokens, flips at margins {flips}, "
          f"rows with an exact tie {ties}")
    bound = (2 * float(np.abs(out["bf16"] - out["f32"]).max())
             + 2.0 ** -8 * float(np.abs(out["f32"]).max()))
    err = float(np.abs(lg[:, -1].float().numpy() - out["f32"]).max())
    assert err <= bound, (err, bound)


# --------------------------------------------------------------------------
# the trainer, the engine's closes, the launchers, mesh mode
# --------------------------------------------------------------------------

def _assert_trees_close(ref, port, max_sep):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert sorted(rf) == sorted(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


LR, STEPS, CLIENTS, VOCAB, SEQ = 5e-3, 2, 4, 64, 32


def test_host_trainer_matches_reference_round_by_round():
    """fedex with expert adapters through the engine: a uniform round of
    all 4 clients, then a weighted one at 50% participation with example
    weights; the closes fold the raw (L, E, d, ff) expert leaves beside the
    attention kernels."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=2, local_steps=STEPS)
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
        _assert_trees_close(jt.params, pt.params, 2 * LR * STEPS * CLIENTS)
        _assert_trees_close(jt.global_lora, pt.global_lora,
                            2 * LR * STEPS * CLIENTS)


M, N, RMAX = 24, 20, 6
HETERO = {"weighted": ([2, 6, 4], [0, 1, 2], [1.0, 2.0, 0.5]),
          "partial": ([2, 6, 4], [0, 2], [3.0, 1.0])}


def _hetero_setting(ranks):
    """A projection and a stacked-expert (raw, (2, M, N)) leaf, and client
    adapters at ``ranks`` zero-padded to RMAX."""
    rng = np.random.default_rng(47)

    def n(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    params = {"blk": {"q_proj": {"kernel": n(M, N)},
                      "experts": {"w_up": n(2, M, N)}}}
    clients = []
    for r in ranks:
        tree = {}
        for key, lead in (("q_proj", ()), ("w_up", (2,))):
            a, b = n(*lead, M, RMAX), n(*lead, RMAX, N)
            a[..., r:] = 0.0
            b[..., r:, :] = 0.0
            tree[key] = {"a": a, "b": b}
        clients.append({"blk": {"q_proj": tree["q_proj"],
                                "experts": {"w_up": tree["w_up"]}}})
    return params, clients


@pytest.mark.parametrize("backend", ["plain", "kernels"])
@pytest.mark.parametrize("round_", list(HETERO))
def test_hetero_close_over_expert_leaves_matches_the_reference(round_,
                                                               backend):
    ranks, delivered, weights = HETERO[round_]
    c = len(ranks)
    params, clients = _hetero_setting(ranks)
    template = jagg.map_factors(lambda f: {"a": np.zeros_like(f["a"]),
                                           "b": np.zeros_like(f["b"])},
                                clients[0])
    jeng = JaxEngine(params, template, c_max=c, scale=SCALE, method="hetero",
                     backend="jnp", client_ranks=ranks)
    peng = RoundCloseEngine(params_from_numpy(params, CPU),
                            params_from_numpy(template, CPU), c_max=c,
                            scale=SCALE, method="hetero", backend=backend,
                            client_ranks=ranks)
    assert [s.has_kernel for s in peng.specs] == [
        s.has_kernel for s in jeng.specs]
    jrid = jeng.buffers.begin_round({i: i for i in range(c)})
    prid = peng.buffers.begin_round({i: i for i in range(c)})
    for cid in delivered:
        jeng.buffers.write(cid, clients[cid], round_id=jrid)
        peng.buffers.write(cid, params_from_numpy(clients[cid], CPU),
                           round_id=prid)
    jout, jloras, _, jdiv = jeng.close_hetero([params] * c, delivered,
                                              weights, round_id=jrid)
    pout, ploras, _, pdiv = peng.close_hetero(
        [params_from_numpy(params, CPU) for _ in range(c)], delivered, weights,
        round_id=prid)
    np.testing.assert_allclose(float(pdiv), float(jdiv), rtol=1e-4)
    for cid in delivered:
        for path in ("blk/q_proj/kernel", "blk/experts/w_up"):
            old = jax_flatten(params)[path]
            want = np.asarray(jax_flatten(_np(jout[cid]))[path])
            got = flatten_with_paths(pout[cid])[path].numpy()
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(
                want - old) + 1e-9, (path, cid)
        jf, pf = jax_flatten(_np(jloras[cid])), flatten_with_paths(
            ploras[cid])
        for key in ("blk/q_proj", "blk/experts/w_up"):
            assert pf[key + "/a"].shape[-1] == ranks[cid]
            jprod = jf[key + "/a"] @ jf[key + "/b"]
            pprod = (pf[key + "/a"] @ pf[key + "/b"]).numpy()
            assert np.linalg.norm(pprod - jprod) <= 1e-4 * max(
                np.linalg.norm(jprod), 1e-12), (key, cid)


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


# --------------------------------------------------------------------------
# mesh mode: the lanes folded into the batch, each with its own aux loss
# --------------------------------------------------------------------------

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
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lane_loss_equals_the_host_loss_on_each_lanes_rows(variant,
                                                           experts):
    """Mesh mode's loss over 2 lanes of 2 rows: each lane's CE plus its
    own router aux loss (f and p̄ over its rows alone), as the host loss
    on that lane's rows with that lane's adapters."""
    jcfg = _jcfg(variant)
    p, l = _draws(variant, experts)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    lanes, stacked = _lane_stack(l, 2, seed=11)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size,
                                              size=(4, 33))
    _, tb = _batches(toks)
    with torch.inference_mode():
        got = pm.lane_loss(tp, tb, stacked, lora_scale=SCALE)
        host = [pm.loss(tp, {k: v[2 * c:2 * c + 2] for k, v in tb.items()},
                        lora=lanes[c], lora_scale=SCALE) for c in range(2)]
    assert got.shape == (2,)
    np.testing.assert_allclose(
        got.numpy(), [float(loss) for loss, _ in host], rtol=1e-5)
    assert all(float(m["aux_loss"]) > 0 for _, m in host)


def _lane_block_inputs(variant):
    """Layer 0's MoE leaves, 2 lanes of per-expert adapters (the shared
    expert's too in the ``shared`` variant) and x of 2 lanes × 2 rows."""
    p, lo, x = _block_inputs(variant, True)
    if variant == "shared":
        rng = np.random.default_rng(9)
        lo = dict(lo, shared={k: {
            "a": (0.02 * rng.standard_normal((256, 4))).astype(np.float32),
            "b": (0.02 * rng.standard_normal((4, 256))).astype(np.float32)}
            for k in ("up_proj", "gate_proj", "down_proj")})
    lanes, stacked = _lane_stack(lo, 2, seed=13)
    x = np.concatenate([x, np.random.default_rng(14).standard_normal(
        x.shape).astype(np.float32)])
    return params_from_numpy(p, CPU), lanes, stacked, torch.as_tensor(x)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
@pytest.mark.parametrize("variant", ["mixtral", "shared"])
def test_moe_block_under_lanes_equals_each_lane_alone(impl, variant):
    """``moe_block`` with ``lanes=2`` over lane-stacked per-expert
    adapters: lane c's rows and aux as the block on those rows alone with
    lane c's adapters (ragged: each expert's group split into its lanes'
    subgroups, not indexed by lane; dense: the lane axis in the
    einsums)."""
    cfg = _port_cfg(_jcfg(variant))
    tp, lanes, stacked, tx = _lane_block_inputs(variant)
    y, aux = pmoe.moe_block(cfg, tp, tx, lora=stacked, lora_scale=SCALE,
                            impl=impl, lanes=2)
    assert aux.shape == (2,)
    for c in range(2):
        yc, auxc = pmoe.moe_block(cfg, tp, tx[2 * c:2 * c + 2],
                                  lora=lanes[c], lora_scale=SCALE, impl=impl)
        np.testing.assert_allclose(y[2 * c:2 * c + 2].detach().numpy(),
                                   yc.detach().numpy(), **TOL)
        np.testing.assert_allclose(float(aux[c]), float(auxc), rtol=1e-6)


def test_ragged_equals_dense_under_lanes():
    """The two expert paths agree under lanes with per-expert adapters,
    the aux losses bit for bit (one router)."""
    cfg = _port_cfg(_jcfg())
    tp, _, stacked, tx = _lane_block_inputs("mixtral")
    yr, ar = pmoe.moe_block(cfg, tp, tx, lora=stacked, lora_scale=SCALE,
                            lanes=2)
    yd, ad = pmoe.moe_block(cfg, tp, tx, lora=stacked, lora_scale=SCALE,
                            impl="dense", lanes=2)
    np.testing.assert_allclose(yr.detach().numpy(), yd.detach().numpy(),
                               **TOL)
    assert torch.equal(ar, ad)


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


@pytest.mark.parametrize("experts", [True, False], ids=["experts", "attn"])
def test_mesh_trainer_matches_the_references_dense_oracle(experts):
    """One weighted fedex round of 2 lanes (example weights, 3 local
    steps) of the port's mesh trainer (ragged) against the reference's,
    whose MoE model is the dense oracle (its ragged one cannot run under
    the round's vmap); with per-expert adapters the close folds the raw
    expert leaves."""
    jt, pt = _mesh_trainers(_jcfg(vocab_size=VOCAB),
                            J_EXPERTS if experts else JLoRAConfig(),
                            EXPERTS if experts else LoRAConfig(),
                            moe_impl="dense")
    assert sum(not s.has_kernel for s in pt.closer.specs) == 3 * experts
    _assert_rounds_match(jt, pt)


def test_the_references_ragged_mesh_round_raises():
    """The reference caveat the port's parity tests work around: at its
    default ``moe_impl="ragged"`` the reference's mesh round fails under
    its vmap (``ragged_dot`` batched over a dim other than 0 is not
    implemented in jax 0.9)."""
    jt, _ = _mesh_trainers(_jcfg(vocab_size=VOCAB), JLoRAConfig(),
                           LoRAConfig(), moe_impl="ragged")
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        jt.run()


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
