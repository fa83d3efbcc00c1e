"""Windowed attention in the port against the JAX reference: the sliding
window of every layer (``sliding_window``), gemma3's periods of local
(windowed) and global layers, their ring caches, and the pieces under them.

* B8's plain versions at head dim 256 (gemma3's) against the reference's
  ``ref.flash_swa_ref``, causal, windowed and not causal;
* the folds over gemma3's two stacked layer axes: the plain fold against the
  reference's oracle per layer, and the layer stride the CUDA wrappers take
  from a (C, nper, ratio, …) stack;
* ``paper-tiny`` with ``sliding_window=16``: three local steps and the
  served tokens (prefill + decode on ring caches of 16) against the
  reference's;
* ``gemma3-12b-smoke`` served at a prompt of 100, not a multiple of its
  window of 64, where the reference's ring cache overwrites keys still
  inside the window at the first decode steps: the port keeps the
  reference's decode, which then parts from the training forward (at twice
  the window, ``tests/test_torch_zoo.py``, the two agree);
* mesh mode over gemma3's periods: the lane-stacked loss, and a weighted
  round of the mesh trainer against the reference's, round by round.

Tolerances (f32 on the CPU): attention outputs the reference kernel
tests' rtol 2e-5, atol 4e-5; folds 1e-6 relative of their scale (two
frameworks, other summation orders); logits and local steps as
``tests/test_torch_model.py`` (rtol 1e-5; adapters atol 1e-5); prefill and
decode logits on f32 caches rtol / atol 1e-4; the mesh trainers
``tests/test_torch_mesh.py``'s (losses rtol 1e-5, the divergence rtol 1e-3,
atol 1e-7, W0 and adapters by relative Frobenius error ≤ 1e-2 and the
AdamW separation bound).
"""

import dataclasses

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
from repro.core.federated import make_local_step as jax_local_step  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.launch import mesh_train as jmesh  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import init_adamw as jax_init_adamw  # noqa: E402
from repro.util.tree import flatten_with_paths as jax_flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core.federated import make_local_step  # noqa: E402
from repro_torch.kernels import (fedex_fold, flash_swa_plain,  # noqa: E402
                                 swa_attention_plain)
from repro_torch.kernels.fedex_residual import _layer_strides  # noqa: E402
from repro_torch.launch.mesh_train import MeshFederatedTrainer  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.optim import init_adamw  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
SCALE, LR = 2.0, 5e-3
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS, CLIENTS, VOCAB, SEQ = 2, 4, 64, 96
FED = dict(num_clients=CLIENTS, rounds=1, local_steps=STEPS,
           participation=0.5, weighting="examples")
TRAIN = dict(learning_rate=LR, schedule="constant")


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


def _state(jcfg):
    """The reference's draws, the adapter's b made non-zero, as numpy."""
    jp = _np(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    rng = np.random.default_rng(0)
    return jp, jax.tree.map(lambda x: np.asarray(x) + (
        0.02 * rng.standard_normal(x.shape)).astype(np.float32), jl)


# --------------------------------------------------------------------------
# B8's plain versions at head dim 256, and the folds over two layer axes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 1024), (False, 50)],
                         ids=["causal", "window64", "window>S", "non-causal"])
def test_flash_swa_plain_at_head_dim_256_matches_reference(causal, window):
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((2, 200, 256)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_ref.flash_swa_ref(q, k, v, causal=causal,
                                            window=window))
    got = flash_swa_plain(*map(torch.from_numpy, (q, k, v)), causal, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=4e-5)
    # the GQA form (16 query heads over 8 K/V heads, gemma3's) per head
    b, s, h, kvh, d = 1, 96, 16, 8, 256
    q4 = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k4, v4 = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
              for _ in range(2))
    got = swa_attention_plain(*map(torch.from_numpy, (q4, k4, v4)), causal,
                              window).numpy()
    flat = [x.transpose(0, 2, 1, 3).reshape(-1, s, d) for x in (
        q4, np.repeat(k4, h // kvh, 2), np.repeat(v4, h // kvh, 2))]
    want = np.asarray(jax_ref.flash_swa_ref(*flat, causal=causal,
                                            window=window))
    np.testing.assert_allclose(got, want.reshape(b, h, s, d).transpose(
        0, 2, 1, 3), rtol=2e-5, atol=4e-5)


def test_fold_over_two_layer_axes_matches_reference():
    """W0 (nper, ratio, m, n), stacks (C, nper, ratio, …), weighted: the
    port's fold (its plain version on the CPU) against the reference's
    oracle on each layer."""
    rng = np.random.default_rng(1)
    c, lead, m, n, r = 4, (2, 3), 24, 40, 4
    w0 = rng.standard_normal((*lead, m, n)).astype(np.float32)
    a = (0.1 * rng.standard_normal((c, *lead, m, r))).astype(np.float32)
    b = (0.1 * rng.standard_normal((c, *lead, r, n))).astype(np.float32)
    w = np.array([0.4, 0.0, 0.25, 0.35], np.float32)
    got = fedex_fold(*map(torch.from_numpy, (w0, a, b)), SCALE,
                     weights=torch.from_numpy(w)).numpy()
    for i in range(lead[0]):
        for j in range(lead[1]):
            want = np.asarray(jax_ref.fedex_residual_ref(
                w0[i, j], a[:, i, j], b[:, i, j], SCALE, weights=w))
            np.testing.assert_allclose(got[i, j], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_layer_stride_flattens_the_stacked_axes_or_refuses():
    """The CUDA wrappers' one layer axis over (nper, ratio): the engine's
    client-leading stacks (contiguous, or a layer-leading storage read
    through strides) flatten; axes that do not nest are refused."""
    w0 = torch.zeros(2, 3, 8, 16)
    a = torch.zeros(4, 2, 3, 8, 5)
    b = torch.zeros(4, 2, 3, 5, 16)
    assert _layer_strides(w0, a, b, "f") == (6, 40, 80)
    a_lc = torch.zeros(2, 3, 4, 8, 5).permute(2, 0, 1, 3, 4)
    assert _layer_strides(w0, a_lc, b, "f")[1] == 4 * 40
    assert _layer_strides(w0[0, 0], a[:, 0, 0], b[:, 0, 0], "f") == (1, 0, 0)
    assert _layer_strides(w0[0], a[:, 0], b[:, 0], "f") == (3, 40, 80)
    swapped = torch.zeros(4, 3, 2, 8, 5).transpose(1, 2)
    with pytest.raises(ValueError, match="do not flatten"):
        _layer_strides(w0, swapped, b, "f")


# --------------------------------------------------------------------------
# paper-tiny with a sliding window of 16 on every layer
# --------------------------------------------------------------------------

def _batches(toks):
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.ones((toks.shape[0], toks.shape[1] - 1))}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "targets": torch.as_tensor(toks[:, 1:]),
          "loss_mask": torch.ones(toks.shape[0], toks.shape[1] - 1)}
    return jb, tb


def test_sliding_window_local_steps_match():
    """Three local steps at seq 48 (three windows) from the reference's
    draws: losses, gradient norms and the adapters."""
    jcfg = _jcfg("paper-tiny", vocab_size=64, sliding_window=16)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    jstep = jax_local_step(jm, SCALE, JTrainConfig(learning_rate=LR))
    pstep = make_local_step(build_model(_port_cfg(jcfg)), SCALE,
                            TrainConfig(learning_rate=LR))
    tp, tl = params_from_numpy(_np(jp), CPU), params_from_numpy(_np(jl), CPU)
    jst, tst = jax_init_adamw(jl), init_adamw(tl)
    rng = np.random.default_rng(5)
    for _ in range(3):
        jb, tb = _batches(rng.integers(0, 64, size=(4, 49)))
        jl, jst, jloss, jgn = jstep(jp, jl, jst, jb, jnp.float32(LR))
        tl, tst, tloss, tgn = pstep(tp, tl, tst, tb, LR)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-4)
    ref = jax_flatten(_np(jl))
    for k, x in flatten_with_paths(to_numpy(tl)).items():
        np.testing.assert_allclose(x, ref[k], rtol=0, atol=1e-5)


def _serve_both(jcfg, prompt, decode, max_len, seed=3):
    """Prefill ``prompt`` tokens and ``decode`` teacher-forced steps in both
    frameworks on f32 caches of ``max_len``; returns the decode logits of
    each side and the port's training-forward logits at those positions."""
    p, l = _state(jcfg)
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(2, prompt + decode))
    jpre = jax.jit(lambda c: jm.prefill(p, {"tokens": jnp.asarray(
        toks[:, :prompt])}, c, lora=l, lora_scale=SCALE))
    jdec = jax.jit(lambda t, c, pos: jm.decode_step(p, t, c, pos, lora=l,
                                                    lora_scale=SCALE))
    jlog, jc = jpre(jm.init_cache(2, max_len, jnp.float32))
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    jdecs, tdecs = [], []
    with torch.inference_mode():
        cache = pm.init_cache(2, max_len, torch.float32, device=CPU)
        tlog, cache = pm.prefill(tp, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache, lora=tl, lora_scale=SCALE)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for pos in range(prompt, prompt + decode):
            tok = toks[:, pos:pos + 1]
            jl_i, jc = jdec(jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32))
            tl_i, cache = pm.decode_step(tp, torch.as_tensor(tok), cache,
                                         pos, lora=tl, lora_scale=SCALE)
            jdecs.append(np.asarray(jl_i)[:, 0])
            tdecs.append(tl_i.numpy()[:, 0])
        full = pm.apply(tp, {"tokens": torch.as_tensor(toks)}, lora=tl,
                        lora_scale=SCALE).numpy()[:, prompt:]
    return np.stack(jdecs, 1), np.stack(tdecs, 1), full


def test_sliding_window_serving_matches_reference_and_forward():
    """paper-tiny, window 16, prompt 32 (two windows), 8 decode steps on
    ring caches of 16 slots: the reference's logits, and the training
    forward's at the same positions."""
    jcfg = _jcfg("paper-tiny", vocab_size=64, sliding_window=16)
    jdec, tdec, full = _serve_both(jcfg, 32, 8, 64)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    np.testing.assert_allclose(tdec, full, **TOL)


def test_gemma3_ring_cache_keeps_the_references_caveat():
    """A prompt of 100, not a multiple of the window of 64: the ring holds
    positions 36–99 in slots 0–63, and decode step 100 writes slot 36, over
    position 72, which is still inside the window. The port decodes as the
    reference does, and both part from the training forward."""
    jdec, tdec, full = _serve_both(_jcfg("gemma3-12b-smoke"), 100, 8, 160)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    assert np.abs(tdec - full).max() > 10 * TOL["atol"]


# --------------------------------------------------------------------------
# mesh mode's lane-stacked loss over gemma3's periods
# --------------------------------------------------------------------------

def test_lane_loss_slices_the_periods_lane_axis():
    """Lane-stacked adapters (C, nper, ratio, m, r) and (C, nper, m, r):
    lane c's loss from one folded forward equals the loss of lane c's own
    adapter on its own rows."""
    jcfg = _jcfg("gemma3-12b-smoke")
    p, l = _state(jcfg)
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    rng = np.random.default_rng(7)
    lanes = [jax.tree.map(lambda x: x + (0.05 * rng.standard_normal(
        x.shape)).astype(np.float32), l) for _ in range(3)]
    stacked = params_from_numpy(jax.tree.map(lambda *xs: np.stack(xs),
                                             *lanes), CPU)
    toks = rng.integers(0, jcfg.vocab_size, size=(3 * 2, 81))
    _, tb = _batches(toks)
    with torch.inference_mode():
        got = pm.lane_loss(tp, tb, stacked, lora_scale=SCALE)
        for c, lane in enumerate(lanes):
            rows = {k: v[2 * c:2 * c + 2] for k, v in tb.items()}
            logits = pm.apply(tp, rows, lora=params_from_numpy(lane, CPU),
                              lora_scale=SCALE)
            want, _ = cross_entropy(logits, rows["targets"],
                                    rows["loss_mask"])
            np.testing.assert_allclose(float(got[c]), float(want),
                                       rtol=1e-5)


def _assert_trees_close(ref, port, max_sep):
    rf = jax_flatten(_np(ref))
    pf = flatten_with_paths(to_numpy(port))
    assert sorted(rf) == sorted(pf)
    for k, want in rf.items():
        diff = pf[k] - want
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(want) + 1e-7, k
        assert np.abs(diff).max() <= max_sep, k


def test_gemma3_mesh_trainer_matches_reference_round_by_round():
    """A weighted mesh round at 50% participation: the lanes slice
    (C, nper, ratio, m, r) adapters behind their layer axes; both trainers
    from the reference's draws, the reference's on a mesh of Auto axes
    (``tests/test_torch_mesh.py``)."""
    jcfg = _jcfg("gemma3-12b-smoke", vocab_size=VOCAB)
    jl, je = jax_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=4, seed=0)
    mesh = jax.make_mesh((1, 1), ("client", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jt = jmesh.MeshFederatedTrainer(
        model=jax_build_model(jcfg), lora_cfg=JLoRAConfig(),
        fed_cfg=JFedConfig(**FED), train_cfg=JTrainConfig(**TRAIN),
        client_loaders=jl, eval_batches=je, seed=0, mesh=mesh)
    pl, pe = build_federated_data(VOCAB, CLIENTS, seq_len=SEQ, batch_size=4,
                                  seed=0, device=CPU)
    pt = MeshFederatedTrainer(
        model=build_model(_port_cfg(jcfg)), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(**FED), train_cfg=TrainConfig(**TRAIN),
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
    _assert_trees_close(jt.params, pt.params, 2 * LR * STEPS * CLIENTS)
    _assert_trees_close(jt.global_lora, pt.global_lora,
                        2 * LR * STEPS * CLIENTS)
