"""The rest of the reference's dense zoo in the port — ``granite-8b``,
``starcoder2-15b`` and ``gemma3-12b`` — against the JAX reference at their
``-smoke`` sizes (2 layers, d 256, 4 heads of 64; gemma3's is one period of
1 local layer at window 64 and 1 global layer).

* the registry, and the parameter, adapter and cache trees (gemma3's
  ``periods/local`` stacked ``(nper, ratio, …)`` and ``periods/global``
  ``(nper, …)``; ring caches of ``min(window, cache_len)``);
* the training forward, loss and LoRA gradients, at a sequence longer than
  gemma3's window;
* prefill plus 8 decode steps on an f32 cache against the reference's
  ``init_cache`` / ``forward`` (gemma3 at a prompt of twice its window);
* gemma3 through the host trainer (example weights at 50%), round by round
  (its mesh round is in ``tests/test_torch_window.py``), and the two
  launchers on the CPU.

Both frameworks run the same numpy-made inputs from the reference's draws
(``repro_torch.bridge``); starcoder2's biases and LayerNorm parameters are
drawn away from their zero / unit init first (``tests/test_torch_gpt2.py``'s
``_perturb``), so a missing bias would show.

Tolerances (f32 on the CPU): logits and loss rtol 1e-5 of their scale and
LoRA gradients within 1e-5 of each leaf's largest entry
(``tests/test_torch_model.py``'s); prefill and decode logits rtol / atol
1e-4 (an f32 cache on both sides, so no bf16 rounding); the trainers
``tests/test_torch_federated.py``'s and ``tests/test_torch_mesh.py``'s:
losses rtol 1e-5, the §6 divergence rtol 1e-3, W0 and adapters by relative
Frobenius error ≤ 1e-2 and the AdamW separation bound (round 0's
divergence, ≈ 4e-9 of f32 noise around b = 0, is held to atol 1e-7 as in
``tests/test_torch_mesh.py``).
"""

import dataclasses
import functools

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
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config, list_configs)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core.lora import init_lora  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
SCALE = 2.0  # α / r = 8 / 4
ARCHS = ["granite-8b-smoke", "starcoder2-15b-smoke", "gemma3-12b-smoke"]
TOL = dict(rtol=1e-4, atol=1e-4)
LR, STEPS, CLIENTS, ROUNDS, VOCAB, SEQ = 5e-3, 2, 4, 1, 64, 96


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


def _jcfg(name, **kw):
    return dataclasses.replace(jax_get_config(name), dtype="float32", **kw)


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


def _perturb(params, seed=11):
    """Biases and norm parameters drawn away from their init (numpy)."""
    rng = np.random.default_rng(seed)
    flat = jax_flatten(_np(params))
    for path, x in flat.items():
        if path.endswith("/scale"):
            x = 1.0 + 0.2 * rng.standard_normal(x.shape)
        elif path.endswith("/bias"):
            x = 0.1 * rng.standard_normal(x.shape)
        flat[path] = np.asarray(x, np.float32)
    return unflatten_from_paths(flat)


@functools.lru_cache(maxsize=None)
def _draws(arch):
    """The reference's draws at ``arch``: params and a fresh adapter."""
    jcfg = _jcfg(arch)
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    return jp, _np(jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig()))


def _state(arch):
    """Reference params (perturbed) and an adapter with non-zero b."""
    jp, jl = _draws(arch)
    rng = np.random.default_rng(0)
    jl = jax.tree.map(lambda x: x + (0.02 * rng.standard_normal(
        x.shape)).astype(np.float32), jl)
    return _perturb(jp), jl


# --------------------------------------------------------------------------
# registry and trees
# --------------------------------------------------------------------------

def test_registry_has_every_dense_config_of_the_reference():
    names = ("granite-8b", "starcoder2-15b", "gemma3-12b")
    assert set(names) <= set(list_configs())
    # and mixtral-8x22b (test_torch_moe), deepseek-v2-236b (test_torch_mla),
    # zamba2-7b (test_torch_hybrid), xlstm-1.3b (test_torch_xlstm),
    # whisper-medium (test_torch_encdec), internvl2-76b (test_torch_vlm)
    assert len(list_configs()) == 13
    for name in names:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        assert (dataclasses.asdict(get_config(name + "-smoke"))
                == dataclasses.asdict(jax_get_config(name + "-smoke")))
    g = get_config("gemma3-12b-smoke")
    assert (g.num_layers, g.local_global_ratio, g.local_window,
            g.head_dim) == (2, 1, 64, 64)


# every family of the reference runs in the port (the vlm one since
# internvl2-76b's slice); a family the reference does not have is refused by
# its name
@pytest.mark.parametrize("name,family", [("internvl2-76b", "bogus")],
                         ids=["internvl2-76b"])
def test_other_families_stay_refused(name, family):
    cfg = jax_get_config(name)
    check_supported(_port_cfg(cfg))
    with pytest.raises(NotImplementedError, match=family):
        check_supported(_port_cfg(dataclasses.replace(cfg, family=family)))


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-7b-smoke",
                                          "xlstm-1.3b-smoke"])
def test_param_adapter_and_cache_trees_line_up(arch):
    jcfg = _jcfg(arch)
    jm = jax_build_model(jcfg)
    jp, jl = _draws(arch)
    jc = jm.init_cache(2, 160, jnp.float32)
    pm = build_model(_port_cfg(jcfg))
    gen = torch.Generator().manual_seed(0)
    pp = pm.init(gen, CPU)
    pl = init_lora(gen, pp, pm.cfg, LoRAConfig())
    pc = pm.init_cache(2, 160, torch.float32, device=CPU)
    for ref, port in ((jp, pp), (jl, pl), (jc, pc)):
        rf, pf = jax_flatten(ref), flatten_with_paths(port)
        assert sorted(rf) == sorted(pf)
        assert all(tuple(rf[k].shape) == tuple(pf[k].shape) for k in rf), [
            (k, rf[k].shape, pf[k].shape) for k in rf
            if tuple(rf[k].shape) != tuple(pf[k].shape)]
    if arch.startswith("gemma3"):
        assert pc["local"]["k"].shape == (1, 1, 2, 64, 4, 64)  # a ring
        assert pc["global"]["k"].shape == (1, 2, 160, 4, 64)
        assert pl["periods"]["local"]["attn"]["q_proj"]["a"].shape == (
            1, 1, 256, 4)


# --------------------------------------------------------------------------
# training forward and gradients
# --------------------------------------------------------------------------

def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_lora_grads(arch):
    """A sequence of 96 tokens: gemma3's local layer sees only its window
    of 64."""
    jcfg = _jcfg(arch)
    p, l = _state(arch)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 97))
    jb, tb = _batches(toks)
    jm = jax_build_model(jcfg)
    ((jloss, _), jgrads), (jlogits, _) = jax.jit(lambda lo: (
        jax.value_and_grad(lambda x: jm.loss(p, jb, lora=x, lora_scale=SCALE),
                           has_aux=True)(lo),
        jm.apply(p, jb, lora=lo, lora_scale=SCALE)))(l)

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


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill, then 8 teacher-forced decode steps, both on f32 caches of
    160 positions (gemma3: a prompt of 128, twice its window, so its local
    layer's ring of 64 is full when decoding starts); the decode logits
    equal the reference's and the port's own training forward's."""
    jcfg = _jcfg(arch)
    p, l = _state(arch)
    prompt = 128 if arch.startswith("gemma3") else 40
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             size=(2, prompt + 8))
    jpre = jax.jit(lambda c: jm.prefill(p, {"tokens": jnp.asarray(
        toks[:, :prompt])}, c, lora=l, lora_scale=SCALE))
    jdec = jax.jit(lambda t, c, pos: jm.decode_step(p, t, c, pos, lora=l,
                                                    lora_scale=SCALE))
    jlog, jc = jpre(jm.init_cache(2, 160, jnp.float32))
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    with torch.inference_mode():
        cache = pm.init_cache(2, 160, torch.float32, device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for pos in range(prompt, prompt + 8):
            tok = toks[:, pos:pos + 1]
            jl_i, jc = jdec(jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32))
            tl_i, cache = pm.decode_step(tp, torch.as_tensor(tok), cache,
                                         pos, lora=tl, lora_scale=SCALE)
            np.testing.assert_allclose(tl_i.numpy(), np.asarray(jl_i), **TOL)
        full = pm.apply(tp, {"tokens": torch.as_tensor(toks)}, lora=tl,
                        lora_scale=SCALE)
        np.testing.assert_allclose(tl_i[:, -1].numpy(), full[:, -1].numpy(),
                                   **TOL)
    for k, x in jax_flatten(_np(jc)).items():
        got = flatten_with_paths(cache)[k].numpy()
        if k.endswith("pos"):
            np.testing.assert_array_equal(got, x)
        else:
            np.testing.assert_allclose(got, x, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_the_cpu(arch, capsys):
    port_train.main(["--device", "cpu", "--arch", arch, "--method", "fedex",
                     "--vocab", "64", "--clients", "2", "--rounds", "1",
                     "--local-steps", "1", "--batch-size", "2", "--seq-len",
                     "16", "--weighting", "examples"])
    out = capsys.readouterr().out
    assert "final: method=fedex" in out and "close backend=plain" in out
    serve_mod.main(["--device", "cpu", "--arch", arch, "--batch-size", "1",
                    "--prompt-len", "8", "--steps", "2", "--max-len", "16"])
    assert "generated token ids" in capsys.readouterr().out


# --------------------------------------------------------------------------
# gemma3 through the trainers, round by round
# --------------------------------------------------------------------------

def _assert_trees_close(ref, port, max_sep):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert sorted(rf) == sorted(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


FED = dict(num_clients=CLIENTS, rounds=ROUNDS, local_steps=STEPS,
           participation=0.5, weighting="examples")
TRAIN = dict(learning_rate=LR, schedule="constant")


def test_gemma3_host_trainer_matches_reference_round_by_round():
    """Weighted rounds at 50% participation: the port's weighted close
    folds the (nper, ratio, m, n) local leaves and the (nper, m, n) global
    ones (the reference's jnp close, the same function as its Pallas
    close, which runs in interpret mode here)."""
    jcfg = _jcfg("gemma3-12b-smoke", vocab_size=VOCAB)
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=4, seed=0)
    jt = JaxTrainer(model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", **FED),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je, seed=0)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=4,
                                  seed=0, device=CPU)
    pt = FederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**FED), train_cfg=TrainConfig(**TRAIN),
        client_loaders=pl, eval_batches=pe, seed=0, device=CPU,
        params=params_from_numpy(_np(jt.params), CPU),
        global_lora=params_from_numpy(_np(jt.global_lora), CPU))
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
                                   atol=1e-7)
        _assert_trees_close(jt.params, pt.params, 2 * LR * STEPS * CLIENTS)
        _assert_trees_close(jt.global_lora, pt.global_lora,
                            2 * LR * STEPS * CLIENTS)
    assert "periods" in pt.global_lora
