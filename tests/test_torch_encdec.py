"""The encdec family in the port (``whisper-medium``: a bidirectional
encoder over stub frames, a decoder of causal self-attention,
cross-attention to the encoder's output and the MLP; self and cross caches)
against the JAX reference, in f32 unless a test says otherwise, at
``whisper-medium-smoke`` (2 encoder + 2 decoder layers, d 256, 4 heads of
64, MLP 512, 64 frames, vocab 512).

* the registry and ``reduced()``; the parameter, adapter and cache trees
  path for path; the bridge carrying every leaf that is not a kernel;
  ``make_batch_for``'s frames and tokens bit for bit;
* ``encode``; cross-attention in training (with its LoRA gradients), at
  prefill (the cross cache filled) and at decode (the cache read, not
  written); B8's plain version at Sq ≠ Sk against the Pallas kernel in
  interpret mode, and the bf16 probe at Sq ≠ Sk;
* the logits, loss and LoRA gradients; a prefill and 4 decode steps with
  both caches after them; serving's projections and prefill attentions
  all through the kernels' wrappers; a bf16 prefill and decode;
* the host trainer round by round (uniform, then weighted at 50%), with
  client loaders that add seeded frames to each batch on both sides; the
  serve launcher; the launcher's refusals (host and mesh mode) and the
  decoder-only stack's, and the reference's own failure with a
  tokens-only loader, which the launcher's refusal stands for;
* mesh mode: ``lane_loss`` over folded frames and tokens against the host
  loss on each lane's rows, and one weighted round of the mesh trainer
  against the reference's, both on loaders that add frames.

Tolerances are ``tests/test_torch_xlstm.py``'s: blocks and caches rtol /
atol 1e-4 (f32 on both sides, the products contracted in another order);
logits rtol 1e-5 with atol 1e-5 of their largest magnitude, the loss rtol
1e-5, LoRA gradients within 1e-5 of each leaf's largest entry; the
trainer's losses rtol 1e-5, divergence rtol 1e-3, trees by relative
Frobenius error ≤ 1e-2 and the AdamW separation bound 2·lr·steps·clients;
bf16 the criterion of ``tests/test_torch_bf16.py`` (twice the reference's
bf16 distance from its f32 answer over the same weights, plus one bf16
rounding at the logit scale).
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
from repro.kernels.flash_swa import flash_swa as jax_flash_swa  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.lora import init_global_state, init_lora  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.fedsrv import RoundPolicy  # noqa: E402
from repro_torch.kernels import probes  # noqa: E402
from repro_torch.kernels.flash_swa import (swa_attention,  # noqa: E402
                                           swa_attention_plain,
                                           swa_error_bound)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import encdec as pencdec  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
ARCH = "whisper-medium-smoke"
SCALE = 2.0  # α / r = 8 / 4
TOL = dict(rtol=1e-4, atol=1e-4)
ATTN = ("self_attn", "cross_attn")


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
    """Norm scales and every bias (q/k/v's, the MLP's, the LayerNorms')
    drawn away from their init, every adapter's b non-zero, so a missing
    term would show."""
    out = {}
    for k, x in jax_flatten(tree).items():
        x = np.asarray(x, np.float32)
        if k.endswith("/scale"):
            x = x + 0.2 * rng.standard_normal(x.shape)
        elif k.endswith("/bias"):
            x = x + 0.3 * rng.standard_normal(x.shape)
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


def _frames(seed, bsz=2, s=64, d=256):
    """Stub frames as the reference draws them: normal × 0.02, f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, s, d)) * 0.02).astype(np.float32)


def _batches(toks, frames):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1)),
          "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1),
          "frames": torch.as_tensor(frames)}
    return jb, tb


# --------------------------------------------------------------------------
# registry, trees, data
# --------------------------------------------------------------------------

def test_registry_and_reduced_match_the_reference():
    assert "whisper-medium" in list_configs() and len(list_configs()) == 13
    for name in ("whisper-medium", ARCH):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        check_supported(get_config(name))
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.enc_layers, c.enc_seq_len, c.d_model,
            c.num_heads, c.num_kv_heads, c.d_ff, c.norm, c.act, c.qkv_bias,
            c.learned_pos_embeddings, c.rope, c.tie_embeddings) == (
        "encdec", 2, 2, 64, 256, 4, 4, 512, "layernorm", "gelu", True,
        True, False, True)
    full = get_config("whisper-medium")
    assert (full.num_layers, full.enc_layers, full.enc_seq_len,
            full.d_model, full.vocab_size) == (24, 24, 1500, 1024, 51_865)


def test_param_adapter_and_cache_trees_line_up():
    """Path for path, shape for shape and (in the config's bf16) dtype for
    dtype; 12 adapted leaves, q/k/v/o of the encoder's attention and the
    decoder's self- and cross-attention, tied embeddings (no lm_head)."""
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
    assert "lm_head" not in pp
    assert sorted(pl) == ["decoder", "encoder"]
    assert sorted(pl["decoder"]) == sorted(ATTN)
    assert len(flatten_with_paths(pl)) == 24  # 12 adapted leaves, a and b
    assert pl["decoder"]["cross_attn"]["k_proj"]["a"].shape == (2, 256, 4)
    assert pp["enc_pos_embed"]["embedding"].shape == (64, 256)
    assert pp["pos_embed"]["embedding"].shape == (4096, 256)
    assert pp["decoder"]["cross_attn"]["v_proj"]["bias"].shape == (2, 256)
    assert "bias" not in pp["encoder"]["attn"]["o_proj"]
    assert pp["encoder"]["mlp"]["up_proj"]["bias"].shape == (2, 512)
    assert pc["self"]["k"].shape == (2, 2, 40, 4, 64)
    assert pc["cross"]["v"].shape == (2, 2, 64, 4, 64)
    assert bool((pc["cross"]["pos"] == -1).all())


def test_bridge_carries_every_whisper_leaf():
    """Every leaf of the reference's tree crosses to the port and back bit
    for bit: ``enc_pos_embed``, the q/k/v and MLP biases, the LayerNorms'
    scales and biases among them."""
    jp = _draws()[0]
    back = flatten_with_paths(to_numpy(params_from_numpy(jp, CPU)))
    want = jax_flatten(jp)
    assert sorted(back) == sorted(want)
    for k, x in want.items():
        np.testing.assert_array_equal(back[k], x, err_msg=k)
    names = {k.rsplit("/", 1)[-1] for k in want}
    assert {"bias", "scale", "kernel", "embedding"} == names
    assert sum(k.endswith("/bias") for k in want) == 20


@pytest.mark.parametrize("arch,bsz,seq", [(ARCH, 2, 16),
                                          ("whisper-medium", 1, 8)],
                         ids=["smoke", "full"])
def test_make_batch_for_draws_the_references_frames_and_tokens(arch, bsz,
                                                               seq):
    cfg = get_config(arch)
    want = jax_make_batch_for(jax_get_config(arch), bsz, seq, seed=3)
    got = make_batch_for(cfg, bsz, seq, seed=3, device=CPU)
    assert sorted(got) == sorted(want)
    assert got["frames"].dtype == torch.float32
    assert tuple(got["frames"].shape) == (bsz, cfg.enc_seq_len, cfg.d_model)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------------------
# the encoder and cross-attention
# --------------------------------------------------------------------------

def test_encode_matches_the_reference():
    jcfg = _jcfg()
    jp, jl = _draws()
    frames = _frames(4, s=50)  # fewer frames than enc_seq_len
    want = jax.jit(lambda p, lo, f: jencdec.encode(
        jcfg, p, f, lora=lo, lora_scale=SCALE))(jp, jl, frames)
    got = pencdec.encode(_port_cfg(jcfg), params_from_numpy(jp, CPU),
                         torch.as_tensor(frames),
                         lora=params_from_numpy(jl, CPU), lora_scale=SCALE)
    assert tuple(got.shape) == (2, 50, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _cross_layer():
    """Decoder layer 1's cross-attention params and adapter."""
    jp, jl = _draws()
    pick = functools.partial(jax.tree.map, lambda t: np.asarray(t)[1])
    return (pick(jp["decoder"]["cross_attn"]),
            pick(jl["decoder"]["cross_attn"]))


def test_cross_attention_train_and_its_lora_grads_match_the_reference():
    """Queries (2, 24) against 64 encoder keys, no causal mask, no RoPE:
    the output and the gradients of ⟨output, g⟩ with respect to the four
    adapters (k and v's through the encoder's rows)."""
    jcfg = _jcfg()
    p, lo = _cross_layer()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 64, 256)).astype(np.float32)
    g = rng.standard_normal((2, 24, 256)).astype(np.float32)

    def jfn(l, p, x, enc, g):
        out, _ = jattn.attention_block(jcfg, p, x, lora=l, lora_scale=SCALE,
                                       kv_x=enc, cross=True, causal=False)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        lo, p, x, enc, g)
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(lo, CPU)).items()}
    out, cache = pattn.attention_block(
        _port_cfg(jcfg), params_from_numpy(p, CPU), torch.as_tensor(x),
        lora=unflatten_from_paths(flat), lora_scale=SCALE,
        kv_x=torch.as_tensor(enc), cross=True, causal=False)
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(),
                                list(flat.values()))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(flat) and len(jf) == 8
    for k, got in zip(flat, grads):
        want = np.asarray(jf[k])
        assert np.abs(want).max() > 0, k
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), k


def test_cross_attention_prefill_fills_and_decode_reads_the_cache():
    """Serving: a prefill of 20 queries fills the cross cache with k and v
    of the 64 encoder rows at positions 0..63; then 2 decode steps (one
    query each, ``kv_x`` None) read it and leave it as it was. Outputs and
    cache against the reference's."""
    jcfg = _jcfg()
    p, lo = _cross_layer()
    pcfg = _port_cfg(jcfg)
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(lo, CPU)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 22, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 64, 256)).astype(np.float32)
    jcache = jattn.init_kv_cache(2, 64, 4, 64, jnp.float32)
    cache = pattn.init_kv_cache(2, 64, 4, 64, torch.float32, CPU)
    jout, jcache = jattn.attention_block(
        jcfg, p, jnp.asarray(x[:, :20]), lora=lo, lora_scale=SCALE,
        kv_x=jnp.asarray(enc), cross=True, cache=jcache, causal=False)
    with torch.inference_mode():
        out, cache = pattn.attention_block(
            pcfg, tp, torch.as_tensor(x[:, :20]), lora=tl, lora_scale=SCALE,
            kv_x=torch.as_tensor(enc), cross=True, cache=cache, causal=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.arange(64))
        filled = {k: v.clone() for k, v in cache.items()}
        for pos in (20, 21):
            jd, jcache = jattn.attention_block(
                jcfg, p, jnp.asarray(x[:, pos:pos + 1]), lora=lo,
                lora_scale=SCALE, cross=True, cache=jcache,
                decode_position=jnp.asarray(pos, jnp.int32), causal=False)
            d, cache = pattn.attention_block(
                pcfg, tp, torch.as_tensor(x[:, pos:pos + 1]), lora=tl,
                lora_scale=SCALE, cross=True, cache=cache,
                decode_position=pos, causal=False)
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
        for k, v in filled.items():
            assert torch.equal(cache[k], v), k


@pytest.mark.parametrize("sq,sk", [(24, 100), (1, 100), (40, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_attention_at_sq_ne_sk_matches_the_pallas_kernel(sq, sk, dtype):
    """B8's plain version (what the wrapper runs on the CPU) at a
    cross-attention's shapes, non-causal, against the reference's Pallas
    kernel in interpret mode (one tile each way), within
    ``swa_error_bound``."""
    rng = np.random.default_rng(sq + sk)
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(rng.standard_normal((2, n, 4, 64)), jdt)
               for n in (sq, sk, sk))

    def heads(t):
        return t.transpose(0, 2, 1, 3).reshape(8, t.shape[1], 64)

    want = jax_flash_swa(heads(q), heads(k), heads(v), causal=False,
                         window=0, bq=sq, bk=sk, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(2, 4, sq, 64
                                                        ).transpose(0, 2, 1,
                                                                    3)
    tq, tk, tv = (torch.as_tensor(np.asarray(t.astype(jnp.float32))).to(
        getattr(torch, dtype)) for t in (q, k, v))
    got = swa_attention(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and tuple(got.shape) == (2, sq, 4, 64)
    bound = swa_error_bound(tq, tk, tv, False, 0).numpy()
    assert (np.abs(got.float().numpy() - want) <= bound).all()


@pytest.mark.parametrize("sq", [64, 33, 1])
def test_swa_probe_at_sq_ne_sk_pins_where_p_is_rounded(sq):
    """The bf16 probe with Sk 150 keys for Sq queries: the plain version
    equals the Pallas kernel in interpret mode bit for bit, and p left
    unrounded, or l summing the rounded p, gives another answer."""
    sk = 150
    q, k, v, faults = probes.swa_probe(2, sq, 4, 4, 64, causal=False, sk=sk,
                                       seed=sq)
    assert tuple(k.shape) == (2, sk, 4, 64) and tuple(q.shape) == (2, sq, 4,
                                                                   64)
    got = swa_attention(q, k, v, False, 0)
    np.testing.assert_array_equal(
        got.float().numpy(),
        swa_attention_plain(q, k, v, False, 0).float().numpy())

    def heads(t):
        return jnp.asarray(t.float().transpose(1, 2).reshape(
            8, t.shape[1], 64).numpy(), jnp.bfloat16)

    ref = jax_flash_swa(heads(q), heads(k), heads(v), causal=False, window=0,
                        bq=sq, bk=sk, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(2, 4, sq, 64
                                                      ).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert bool((got != 0).any())
    seen = probes.differing(got, faults)
    assert len(seen) == 2 and min(seen.values()) > 0, seen


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------

def _port_lora_grads(pm, tp, l, tb):
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_with_paths(params_from_numpy(l, CPU)).items()}
    loss, _ = pm.loss(tp, tb, lora=unflatten_from_paths(flat),
                      lora_scale=SCALE)
    return dict(zip(flat, (g.numpy() for g in torch.autograd.grad(
        loss, list(flat.values())))))


def test_logits_loss_and_lora_grads():
    """The logits, the loss (CE alone; ``with_aux`` a zero aux) and its
    LoRA gradients over all 12 adapted leaves (encoder q/k/v/o reached
    through the cross-attention's k and v). Each leaf within 1e-5 of its
    largest entry plus 3 × the model's own f32 spread on it: the port's
    gradient again with the frames moved by 1e-7 of their size. The
    cross-attention's q and k gradients need it: at these draws its
    softmax over the 64 frames is nearly flat, so their terms nearly
    cancel and f32 noise moves them by 3–9·10⁻⁴ of their size (the
    reference's differ from the port's by 2.6·10⁻⁴); every other leaf's
    spread is ≈ 10⁻⁶ of its size. The spread itself is held below 10⁻⁶ of
    the largest gradient entry of any leaf."""
    jcfg = _jcfg()
    p, l = _draws()
    toks = np.random.default_rng(3).integers(0, 512, size=(2, 25))
    jb, tb = _batches(toks, _frames(7))
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
    with torch.no_grad():
        _, aux = pm.apply(tp, tb, lora=unflatten_from_paths(flat),
                          lora_scale=SCALE, with_aux=True)
    assert float(aux) == 0.0
    loss, met = pm.loss(tp, tb, lora=unflatten_from_paths(flat),
                        lora_scale=SCALE)
    assert "aux_loss" not in met and met["total_loss"] is loss
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    frames = np.asarray(jb["frames"])
    moved = (frames * (1 + 1e-7 * np.random.default_rng(0).standard_normal(
        frames.shape))).astype(np.float32)
    again = _port_lora_grads(pm, tp, l, dict(tb, frames=torch.as_tensor(
        moved)))
    jf = jax_flatten(jgrads)
    assert sorted(jf) == sorted(grads) and len(jf) == 24
    top = max(np.abs(np.asarray(g)).max() for g in jf.values())
    for k, g in jf.items():
        g = np.asarray(g)
        spread = np.abs(again[k] - grads[k].numpy()).max()
        assert spread <= 1e-6 * top, k
        assert np.abs(g).max() > 0, k
        assert np.abs(grads[k].numpy() - g).max() <= (
            1e-5 * np.abs(g).max() + 3 * spread), k


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

PROMPT, STEPS, MAX_LEN = 20, 4, 32


def _serve_both(jp, jl, toks, frames, cache_dtype=jnp.float32):
    """A prefill of all but the last STEPS tokens (the frames encoded
    through it), then STEPS teacher-forced decode steps in both frameworks
    (caches in ``cache_dtype``): (reference's logits, port's logits), each
    the prefill's then every step's, and both caches after."""
    prompt = toks.shape[1] - STEPS
    jcfg = _jcfg()
    jm = jax_build_model(jcfg)
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    jpre = jax.jit(lambda p, lo, t, f, c: jm.prefill(
        p, {"tokens": t, "frames": f}, c, lora=lo, lora_scale=SCALE))
    jdec = functools.partial(jax.jit(
        lambda p, lo, t, c, pos: jm.decode_step(p, t, c, pos, lora=lo,
                                                lora_scale=SCALE)), jp, jl)
    jlog, jc = jpre(jp, jl, jnp.asarray(toks[:, :prompt]),
                    jnp.asarray(frames), jm.init_cache(2, MAX_LEN,
                                                       cache_dtype))
    ref, port = [np.asarray(jlog)], []
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, tdt[cache_dtype], device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt]), "frames": torch.as_tensor(frames)}, cache,
            lora=tl, lora_scale=SCALE)
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


def test_prefill_and_decode_match_the_reference():
    """A prefill of 20 tokens over 64 frames and 4 decode steps, f32
    caches: the logits of each, and both caches after them (the self
    cache's written slots and pos, the cross cache as the prefill filled
    it)."""
    jp, jl = _draws()
    toks = np.random.default_rng(4).integers(0, 512, size=(2, PROMPT + STEPS))
    ref, port, jc, cache = _serve_both(jp, jl, toks, _frames(8))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got, want, **TOL)
    rf, pf = jax_flatten(jc), flatten_with_paths(cache)
    assert sorted(pf) == sorted(rf) == ["cross/k", "cross/pos", "cross/v",
                                        "self/k", "self/pos", "self/v"]
    for k, x in rf.items():
        assert str(pf[k].dtype) == f"torch.{x.dtype}", k
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(x), **TOL)
    np.testing.assert_array_equal(
        cache["self"]["pos"][:, :PROMPT + STEPS].numpy(),
        np.tile(np.arange(PROMPT + STEPS), (2, 1)))


def test_decode_position_row_is_clamped_as_the_reference():
    """A decode step past the learned position table reads its last row
    (the reference's clamp) and still writes its self cache at position
    % length."""
    jp, jl = _draws()
    jcfg = _jcfg(max_position_embeddings=16)
    pcfg = _port_cfg(jcfg)
    jm, pm = jax_build_model(jcfg), build_model(pcfg)
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 9))
    frames = _frames(10)
    jp = dict(jp, pos_embed={"embedding": jp["pos_embed"]["embedding"][:16]})
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8]),
                            "frames": jnp.asarray(frames)},
                       jm.init_cache(2, 32, jnp.float32), lora=jl,
                       lora_scale=SCALE)
    jd, jc = jm.decode_step(jp, jnp.asarray(toks[:, 8:9]), jc,
                            jnp.asarray(20, jnp.int32), lora=jl,
                            lora_scale=SCALE)
    with torch.inference_mode():
        _, cache = pm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :8]),
                                   "frames": torch.as_tensor(frames)},
                              pm.init_cache(2, 32, torch.float32, device=CPU),
                              lora=tl, lora_scale=SCALE)
        d, cache = pm.decode_step(tp, torch.as_tensor(toks[:, 8:9]), cache,
                                  20, lora=tl, lora_scale=SCALE)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    assert int(cache["self"]["pos"][0, 20]) == 20


def test_serving_runs_every_adapted_projection_and_attention_fused():
    """In serving every adapted projection goes through the fused LoRA
    kernel's wrapper (``lora_dense``: B3 on the card, its plain version
    here), the encoder's included (its pass has no cache, and passes
    ``fused``), and every prefill attention through the flash attention
    kernel's (``swa_attention``: B8): a prefill 4 B3 an encoder layer
    (M = B·64) and 8 a decoder layer (cross k, v at M = B·64), 3 B8 a
    layer pair (the encoder's and the cross-attention non-causal, Sq ≠ Sk
    for the latter); a decode step 6 B3 a decoder layer (self q/k/v/o,
    cross q and o; the cross cache read) and no B8; the training forward
    neither."""
    jp, jl = _draws()
    pm = build_model(_port_cfg(_jcfg()))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, 512,
                                                             (2, 21)))
    frames = torch.as_tensor(_frames(11))
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
            pm.apply(tp, {"tokens": toks, "frames": frames}, lora=tl,
                     lora_scale=SCALE)
            assert b3 == [] and b8 == []
            cache = pm.init_cache(2, 32, torch.float32, device=CPU)
            _, cache = pm.prefill(tp, {"tokens": toks[:, :20],
                                       "frames": frames}, cache, lora=tl,
                                  lora_scale=SCALE)
            pre, pre8 = list(b3), list(b8)
            pm.decode_step(tp, toks[:, 20:21], cache, 20, lora=tl,
                           lora_scale=SCALE)
            dec, dec8 = b3[len(pre):], b8[len(pre8):]
    finally:
        pcommon.lora_dense, pattn.swa_attention = real_ld, real_swa
    enc_layer, dec_layer = [128] * 4, [40] * 4 + [40, 128, 128, 40]
    assert pre == enc_layer * 2 + dec_layer * 2
    assert pre8 == [(64, 64, False)] * 2 + [(20, 20, True),
                                            (20, 64, False)] * 2
    assert dec == [2] * 12 and dec8 == []


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
    toks = np.random.default_rng(9).integers(0, 512, size=(2, PROMPT + STEPS))
    frames = _frames(12)
    out = {}
    for name, c, p, cdt in (
            ("bf16", cfg, jp, jnp.bfloat16),
            ("f32", dataclasses.replace(cfg, dtype="float32"),
             jax.tree.map(lambda t: t.astype(np.float32), jp), jnp.float32)):
        m = jax_build_model(c)
        lg, jc = jax.jit(lambda p, lo, t, f, cc: m.prefill(
            p, {"tokens": t, "frames": f}, cc, lora=lo, lora_scale=SCALE))(
                p, jl, jnp.asarray(toks[:, :PROMPT]), jnp.asarray(frames),
                m.init_cache(2, MAX_LEN, cdt))
        rows = [np.asarray(lg, np.float32)[:, -1]]
        step = functools.partial(jax.jit(
            lambda p, lo, t, cc, pos: m.decode_step(
                p, t, cc, pos, lora=lo, lora_scale=SCALE)), p, jl)
        for pos in range(PROMPT, PROMPT + STEPS):
            lg, jc = step(jnp.asarray(toks[:, pos:pos + 1]), jc,
                          jnp.asarray(pos, jnp.int32))
            rows.append(np.asarray(lg, np.float32)[:, -1])
        out[name] = rows
    pm = build_model(_port_cfg(cfg))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    got = []
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, device=CPU)
        lg, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :PROMPT]), "frames": torch.as_tensor(frames)}, cache,
            lora=tl, lora_scale=SCALE)
        assert cache["cross"]["k"].dtype == torch.bfloat16
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
# the trainer, the launchers, the refusals
# --------------------------------------------------------------------------

class _FramesLoader:
    """A client loader's batches with stub frames added, drawn from its own
    seeded generator (normal × 0.02, f32) — the caller-built loader that
    whisper trains on, one for each framework from the same seed."""

    def __init__(self, inner, seed, to_array, enc_seq, d):
        self.inner, self.sequences = inner, inner.sequences
        self.rng = np.random.default_rng(seed)
        self.to_array, self.shape = to_array, (enc_seq, d)

    def next_batch(self):
        batch = dict(self.inner.next_batch())
        n = batch["tokens"].shape[0]
        frames = (self.rng.standard_normal((n, *self.shape)) * 0.02
                  ).astype(np.float32)
        batch["frames"] = self.to_array(frames)
        return batch


def _with_frames(loaders, evals, to_array, seed=100):
    wrapped = [_FramesLoader(ld, seed + i, to_array, 64, 256)
               for i, ld in enumerate(loaders)]
    rng = np.random.default_rng(seed - 1)
    evals = [dict(b, frames=to_array((rng.standard_normal(
        (b["tokens"].shape[0], 64, 256)) * 0.02).astype(np.float32)))
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


LR, TRAIN_STEPS, CLIENTS, VOCAB, SEQ = 5e-3, 2, 4, 64, 32


def test_host_trainer_matches_reference_round_by_round():
    """fedex through the engine with loaders that add frames: a uniform
    round of all 4 clients, then a weighted one at 50% participation with
    example weights; the closes fold the 12 (2, 256, 256) leaves of the
    encoder's attention and the decoder's self- and cross-attention."""
    jcfg = _jcfg(vocab_size=VOCAB)
    fed = dict(num_clients=CLIENTS, rounds=2, local_steps=TRAIN_STEPS)
    train = dict(learning_rate=LR, schedule="constant")
    jl, je = _with_frames(*jax_data(VOCAB, CLIENTS, seq_len=SEQ,
                                    batch_size=2, seed=0), jnp.asarray)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", **fed),
                    train_cfg=JTrainConfig(**train), client_loaders=jl,
                    eval_batches=je, seed=0)
    pl, pe = _with_frames(*build_federated_data(
        VOCAB, CLIENTS, seq_len=SEQ, batch_size=2, seed=0, device=CPU),
        torch.as_tensor)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**fed), train_cfg=TrainConfig(**train),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
    assert pt.engine is not None
    keys = sorted(s.key for s in pt.engine.specs)
    assert len(keys) == 12
    assert sum(k.startswith("decoder/cross_attn/") for k in keys) == 4
    assert sum(k.startswith("encoder/attn/") for k in keys) == 4
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


def test_serve_launcher_and_server_state_run_on_the_cpu(capsys):
    """The serve launcher prefills a prompt with its frames and decodes;
    the HTTP federation server's state (``--mode serve`` runs the model
    only to draw it) builds for an encdec config."""
    serve_mod.main(["--device", "cpu", "--arch", ARCH, "--batch-size", "2",
                    "--prompt-len", "8", "--steps", "3", "--max-len", "16"])
    out = capsys.readouterr().out
    assert "generated token ids" in out
    res = serve_mod.serve(ARCH, batch_size=1, prompt_len=6, steps=2,
                          max_len=8, device=CPU, dtype=torch.float32)
    assert res.tokens.shape == (1, 3)
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    params, glob = init_global_state(build_model(get_config(ARCH)),
                                     LoRAConfig(), device=CPU)
    assert len(flatten_with_paths(glob)) == 24
    assert params["enc_pos_embed"]["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["host", "mesh"])
def test_launcher_refuses_encdec_by_name(mode):
    with pytest.raises(NotImplementedError, match=f"{ARCH}.*frames"):
        port_train.main(["--device", "cpu", "--arch", ARCH, "--mode", mode,
                         "--vocab", "64", "--clients", "2", "--rounds", "1",
                         "--local-steps", "1", "--batch-size", "2",
                         "--seq-len", "8"])


def test_the_decoder_only_stack_refuses_encdec_by_name():
    cfg = get_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: transformer.make_params(gen, cfg, CPU),
                 lambda: transformer.init_cache(cfg, 1, 8, device=CPU),
                 lambda: transformer.forward(cfg, {}, torch.zeros(
                     1, 4, dtype=torch.int64))):
        with pytest.raises(NotImplementedError, match="encdec"):
            call()


def test_the_references_tokens_only_loader_has_no_frames():
    """What the launcher's refusal stands for: the reference's own client
    loader yields tokens only, and its whisper loss then fails with
    ``KeyError: 'frames'``."""
    jcfg = _jcfg(vocab_size=VOCAB)
    loaders, _ = jax_data(VOCAB, 2, seq_len=8, batch_size=2, seed=0)
    batch = loaders[0].next_batch()
    assert "frames" not in batch
    jm = jax_build_model(jcfg)
    params = jax.eval_shape(jm.init, jax.random.key(0))
    with pytest.raises(KeyError, match="frames"):
        jax.eval_shape(lambda p, b: jm.loss(p, b)[0], params, batch)


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


def test_lane_loss_equals_the_host_loss_on_each_lanes_rows():
    """Mesh mode's loss over 2 lanes of 2 rows, frames and tokens folded
    lane-major: lane c's factors apply in every encoder and decoder layer
    to its rows alone (its cross-attention reading its own frames'
    encoding); each lane's CE as the host loss on that lane's rows."""
    jcfg = _jcfg()
    p, l = _draws()
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    lanes, stacked = _lane_stack(l, 2, seed=11)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size,
                                              size=(4, 17))
    _, tb = _batches(toks, _frames(13, bsz=4))
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
    steps) against the reference's mesh trainer, both given loaders that
    add seeded frames (each trainer stacks every batch key): the encoder's
    and the decoder's lanes over the 12 leaves."""
    jt, pt = _mesh_trainers(_jcfg(vocab_size=VOCAB), JLoRAConfig(),
                            LoRAConfig(), data=_with_frames)
    assert len(pt.closer.specs) == 12
    _assert_rounds_match(jt, pt)
