"""The port's serving path — the fused LoRA projection (B3), flash attention
(B8), the KV cache, prefill and decode, ``make_batch_for`` and ``serve`` —
against the JAX reference, from the same numpy-made inputs and the
reference's own draws (carried across with ``repro_torch.bridge``). On the
CPU the port's kernel wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode. Every adapter has non-zero b (a fresh adapter's
b = 0 would test the adapter term with zeros).

Tolerances (f32, two frameworks that sum in other orders):
* B3: ``lora_matmul_error_bound`` — 2·(K + r + 4) unit roundoffs of
  |x|@|w| + |s|·(|x|@|a|)@|b|, the bound of any two f32 evaluations.
* B8: the reference's own f32 kernel tolerance (``tests/test_kernels.py``):
  rtol 2e-5, atol 4e-5 at unit-scale inputs.
* decode attention: the cache is bf16 in both; the scores and the PV sum are
  f32 over the same bf16 values and round once to bf16, so at least 99% of
  the outputs agree bitwise and the rest within one bf16 step (2⁻⁷
  relative), where the two f32 sums straddle a rounding boundary.
* the slice: prefill logits rtol 1e-4, atol 1e-4; decode logits rtol 5e-3,
  atol 8e-3 (the reference's own prefill + decode vs train tolerance,
  ``tests/test_models_smoke.py``: a K/V entry that rounds to bf16 the other
  way moves a logit by ~1e-3); greedy tokens agree wherever the reference's
  top-2 margin exceeds 2 × atol.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.data import make_batch_for as jax_make_batch_for  # noqa: E402
from repro.kernels import lora_dense as jax_lora_dense  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import swa_attention as jax_swa_attention  # noqa: E402
from repro.kernels.flash_swa import flash_swa as jax_flash_swa  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as jax_lora_matmul  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import LoRAConfig, get_config  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.fedsrv import TransientTransportError  # noqa: E402
from repro_torch.kernels import (flash_swa, flash_swa_plain,  # noqa: E402
                                 launch_counts, lora_dense, lora_matmul,
                                 lora_matmul_error_bound, lora_matmul_plain,
                                 swa_attention, swa_attention_plain)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402

CPU = torch.device("cpu")
SCALE = 2.0  # α / r = 8 / 4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --------------------------------------------------------------------------
# B3: lora_matmul / lora_dense
# --------------------------------------------------------------------------

LORA_CASES = [  # (M, K, N, r)
    (7, 777, 333, 1),     # decode-sized M, odd K and N
    (7, 777, 333, 16),
    (130, 200, 96, 4),    # M past one 128-row tile
    (8, 256, 384, 4),
]


@pytest.mark.parametrize("case", LORA_CASES, ids=str)
def test_lora_matmul_matches_the_pallas_kernel(case):
    m, k, n, r = case
    rng = np.random.default_rng(sum(case))
    x, w, a, b = (_rand(rng, m, k), _rand(rng, k, n), _rand(rng, k, r),
                  _rand(rng, r, n))
    want = np.asarray(jax_lora_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(a), jnp.asarray(b),
                                      scale=0.7, interpret=True))
    oracle = np.asarray(jax_ref.lora_matmul_ref(x, w, a, b, 0.7))
    tx, tw, ta, tb = _t(x, w, a, b)
    got = lora_matmul(tx, tw, ta, tb, 0.7)
    bound = lora_matmul_error_bound(tx, tw, ta, tb, 0.7).numpy()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (np.abs(got.numpy() - oracle) <= bound).all()
    assert torch.equal(got, lora_matmul_plain(tx, tw, ta, tb, 0.7))


def test_lora_dense_leading_dims_and_scale_zero():
    rng = np.random.default_rng(1)
    x, w, a, b = (_rand(rng, 2, 5, 96), _rand(rng, 96, 160), _rand(rng, 96, 8),
                  _rand(rng, 8, 160))
    want = np.asarray(jax_lora_dense(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(a), jnp.asarray(b), 0.5))
    tx, tw, ta, tb = _t(x, w, a, b)
    got = lora_dense(tx, tw, ta, tb, 0.5)
    bound = lora_matmul_error_bound(tx.reshape(10, 96), tw, ta, tb, 0.5)
    assert got.shape == (2, 5, 160)
    assert (np.abs(got.numpy() - want) <= bound.reshape(2, 5, 160).numpy()
            ).all()
    # scale 0 is the base product exactly (the adapter term adds 0·finite)
    assert torch.equal(lora_dense(tx, tw, ta, tb, 0.0), torch.matmul(tx, tw))


def test_lora_kernels_refuse_grad_and_other_dtypes():
    x, w, a, b = (torch.ones(4, 8), torch.ones(8, 6), torch.ones(8, 2),
                  torch.ones(2, 6))
    with pytest.raises(TypeError):
        lora_matmul(x.bfloat16(), w, a, b, 1.0)
    with pytest.raises(ValueError, match="grad"):
        lora_dense(x, w, a.requires_grad_(True), b, 1.0)
    with pytest.raises(ValueError, match="shapes"):
        lora_matmul(x, w, torch.ones(6, 2), b, 1.0)


# --------------------------------------------------------------------------
# B8: flash_swa / swa_attention
# --------------------------------------------------------------------------

def _close(got, want, rtol=2e-5, atol=4e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 200),
                                           (False, 0), (False, 64)])
def test_flash_swa_matches_the_pallas_kernel(causal, window):
    rng = np.random.default_rng(window + causal)
    q, k, v = (_rand(rng, 3, 256, 32) for _ in range(3))
    want = jax_flash_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=128, bk=128,
                         interpret=True)
    got = flash_swa(*_t(q, k, v), causal=causal, window=window)
    _close(got, want)
    assert torch.equal(got, flash_swa_plain(*_t(q, k, v), causal, window))


@pytest.mark.parametrize("s,window", [(100, 0), (100, 30), (100, 500)])
def test_flash_swa_untileable_lengths_match_the_oracle(s, window):
    """S the reference kernel cannot tile (its wrapper falls back to the
    oracle); the port's kernel masks instead — the same function."""
    rng = np.random.default_rng(s + window)
    q, k, v = (_rand(rng, 2, s, 32) for _ in range(3))
    _close(flash_swa(*_t(q, k, v), True, window),
           jax_ref.flash_swa_ref(q, k, v, causal=True, window=window))


@pytest.mark.parametrize("s,h,kvh,causal,window", [
    (128, 8, 2, True, 0), (128, 8, 2, True, 48), (256, 4, 4, False, 0),
    (100, 6, 3, True, 0)])
def test_swa_attention_gqa_matches_the_reference(s, h, kvh, causal, window):
    rng = np.random.default_rng(s + h)
    q, k, v = _rand(rng, 2, s, h, 32), _rand(rng, 2, s, kvh, 32), \
        _rand(rng, 2, s, kvh, 32)
    want = jax_swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = swa_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (2, s, h, 32)
    _close(got, want)
    torch.testing.assert_close(got, swa_attention_plain(*_t(q, k, v), causal,
                                                        window))


def test_swa_attention_refuses_grad_dtype_and_heads():
    q, k = torch.ones(1, 4, 4, 8), torch.ones(1, 4, 2, 8)
    with pytest.raises(TypeError):
        swa_attention(q.double(), k, k)
    with pytest.raises(ValueError, match="grad"):
        swa_attention(q.requires_grad_(True), k, k)
    with pytest.raises(ValueError, match="heads"):
        swa_attention(torch.ones(1, 4, 5, 8), k, k)


# --------------------------------------------------------------------------
# KV cache and decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("length,position,window", [(16, 9, 0), (16, 9, 4),
                                                    (8, 13, 0)])
def test_cache_write_and_decode_attention(length, position, window):
    """bf16 caches written step by step (the last case wraps the ring)."""
    rng = np.random.default_rng(length + position)
    b, h, kvh, d = 2, 6, 2, 16
    jc = jax_attention.init_kv_cache(b, length, kvh, d)
    pc = attention.init_kv_cache(b, length, kvh, d, device=CPU)
    for p in range(position + 1):
        kn, vn = _rand(rng, b, 1, kvh, d), _rand(rng, b, 1, kvh, d)
        jc = jax_attention.cache_write(jc, jnp.asarray(kn), jnp.asarray(vn),
                                       jnp.asarray(p, jnp.int32))
        pc = attention.cache_write(pc, *_t(kn, vn), p)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(
            np.asarray(jc[key].astype(jnp.float32)), pc[key].float().numpy())
    q = _rand(rng, b, 1, h, d)
    want = jax_attention.decode_attention(jnp.asarray(q), jc,
                                          jnp.asarray(position, jnp.int32),
                                          window=window)
    got = attention.decode_attention(torch.from_numpy(q), pc, position,
                                     window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 1, h, d)
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


# --------------------------------------------------------------------------
# the slice: prefill + decode against the reference
# --------------------------------------------------------------------------

def _jcfg():
    return dataclasses.replace(jax_get_config("paper-tiny"), dtype="float32")


def _port_cfg(jcfg):
    return get_config("paper-tiny").__class__(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def state():
    """Reference params and an adapter with b drawn non-zero, as numpy."""
    jcfg = _jcfg()
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.key(0))
    jl = jax_init_lora(jax.random.key(1), jp, jcfg, JLoRAConfig())
    rng = np.random.default_rng(7)
    jl = jax.tree.map(np.asarray, jl)
    for leaf in jl["layers"]["attn"].values():
        leaf["b"] = (0.02 * rng.standard_normal(leaf["b"].shape)
                     ).astype(np.float32)
    return jcfg, jax.tree.map(np.asarray, jp), jl


PROMPT, STEPS, MAX_LEN = 16, 8, 32
P_TOL = dict(rtol=1e-4, atol=1e-4)
D_TOL = dict(rtol=5e-3, atol=8e-3)


def _count_calls(monkeypatch):
    calls = {"lora_dense": 0, "swa_attention": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(model_common, "lora_dense",
                        counted("lora_dense", model_common.lora_dense))
    monkeypatch.setattr(attention, "swa_attention",
                        counted("swa_attention", attention.swa_attention))
    return calls


def test_prefill_and_decode_match_the_reference(state, monkeypatch):
    """Prefill t[:16], then 8 teacher-forced decode steps, in both
    frameworks from the same params, adapter and tokens; each adapted
    projection goes through lora_dense and each prefill attention through
    swa_attention."""
    jcfg, p, l = state
    lcfg = JLoRAConfig()
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             size=(2, PROMPT + STEPS))
    jpre = jax.jit(jax_prefill_step(jm, lcfg))
    jdec = jax.jit(jax_decode_step(jm, lcfg))
    jlog, jc = jpre(p, l, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                    jm.init_cache(2, MAX_LEN))
    jnone, _ = jpre(p, None, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                    jm.init_cache(2, MAX_LEN))

    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    pre, dec = make_prefill_step(pm, LoRAConfig()), make_decode_step(
        pm, LoRAConfig())
    calls = _count_calls(monkeypatch)
    with torch.inference_mode():
        cache = pm.init_cache(2, MAX_LEN, device=CPU)
        tlog, cache = pre(tp, tl, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, cache)
        layers = jcfg.num_layers
        assert calls == {"lora_dense": 4 * layers, "swa_attention": layers}
        assert tlog.shape == (2, 1, jcfg.vocab_size)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **P_TOL)
        # the adapter moves the logits past the comparison's tolerance
        moved = np.abs(tlog.numpy() - np.asarray(jnone))
        assert moved.max() > P_TOL["atol"] + P_TOL["rtol"] * np.abs(
            np.asarray(jnone)).max()
        np.testing.assert_array_equal(cache["layers"]["pos"][0, :PROMPT + 1],
                                      list(range(PROMPT)) + [-1])
        for i in range(STEPS):
            pos = PROMPT + i
            tok = toks[:, pos:pos + 1]
            jnext, jl_i, jc = jdec(p, l, jnp.asarray(tok, jnp.int32), jc,
                                   jnp.asarray(pos, jnp.int32))
            tnext, tl_i, cache = dec(tp, tl, torch.as_tensor(tok), cache, pos)
            assert calls == {"lora_dense": 4 * layers * (i + 2),
                             "swa_attention": layers}
            jl_i = np.asarray(jl_i)
            np.testing.assert_allclose(tl_i.numpy(), jl_i, **D_TOL)
            top2 = np.sort(jl_i[:, -1], axis=-1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * D_TOL["atol"]
            assert tnext.dtype == torch.int32 and tnext.shape == (2, 1)
            np.testing.assert_array_equal(tnext.numpy()[sure],
                                          np.asarray(jnext)[sure])
    assert launch_counts()["lora_matmul"] == 0  # the CPU launches nothing


def test_prefill_plus_decode_is_the_training_forward(state):
    """Teacher forcing in the port alone: prefill(t[:-1]) + decode(t[-1])
    against the training forward over t; and the adapter moves the logits
    by more than the tolerance."""
    jcfg, p, l = state
    pm = build_model(_port_cfg(jcfg))
    tp, tl = params_from_numpy(p, CPU), params_from_numpy(l, CPU)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(2, PROMPT + 1)))
    with torch.inference_mode():
        full = pm.apply(tp, {"tokens": toks}, lora=tl, lora_scale=SCALE)
        logits = {}
        for name, lo in (("lora", tl), ("none", None)):
            cache = pm.init_cache(2, MAX_LEN, device=CPU)
            pl, cache = pm.prefill(tp, {"tokens": toks[:, :-1]}, cache,
                                   lora=lo, lora_scale=SCALE)
            dl, _ = pm.decode_step(tp, toks[:, -1:], cache, PROMPT, lora=lo,
                                   lora_scale=SCALE)
            logits[name] = (pl, dl)
    pl, dl = logits["lora"]
    np.testing.assert_allclose(pl.numpy(), full[:, :-1].numpy(), **P_TOL)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, -1].numpy(), **D_TOL)
    moved = (logits["lora"][1] - logits["none"][1]).abs()
    assert float(moved.max()) > D_TOL["atol"] + D_TOL["rtol"] * float(
        dl.abs().max())


def test_forward_modes_check_their_arguments(state):
    jcfg, p, _ = state
    pm = build_model(_port_cfg(jcfg))
    tp = params_from_numpy(p, CPU)
    toks = torch.zeros(1, 4, dtype=torch.int64)
    cache = pm.init_cache(1, 8, device=CPU)
    from repro_torch.models import transformer
    with pytest.raises(ValueError, match="needs a"):
        transformer.forward(pm.cfg, tp, toks, mode="prefill")
    with pytest.raises(ValueError, match="takes no"):
        transformer.forward(pm.cfg, tp, toks, cache=cache)
    with pytest.raises(ValueError, match="position"):
        transformer.forward(pm.cfg, tp, toks[:, :1], mode="decode",
                            cache=cache)
    bogus = dataclasses.replace(_port_cfg(jax_get_config("internvl2-76b")),
                                family="bogus")
    with pytest.raises(NotImplementedError, match="bogus"):
        transformer.init_cache(bogus, 1, 8, device=CPU)


# --------------------------------------------------------------------------
# data and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,b,s,seed", [("paper-tiny", 2, 16, 0),
                                           ("paper-llama3.2-3b", 3, 33, 4)])
def test_make_batch_for_is_bitwise_the_references(name, b, s, seed):
    want = jax_make_batch_for(jax_get_config(name), b, s, seed=seed)
    got = make_batch_for(get_config(name), b, s, seed=seed, device=CPU)
    for k in ("tokens", "targets", "loss_mask"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


def test_serve_end_to_end_matches_the_reference_greedy_loop(state):
    """``serve(device="cpu")`` on the bridged params and non-zero adapter
    generates the reference's greedy tokens (compared up to the first step
    whose reference top-2 margin is within 2 × atol)."""
    jcfg, p, l = state
    res = serve_mod.serve("paper-tiny", batch_size=2, prompt_len=PROMPT,
                          steps=STEPS, max_len=MAX_LEN, seed=0, device="cpu",
                          params=params_from_numpy(p, CPU),
                          lora=params_from_numpy(l, CPU),
                          dtype=torch.float32)
    assert res.tokens.shape == (2, STEPS + 1) and res.tokens.dtype == np.int32
    assert res.prefill_ms > 0 and res.decode_ms > 0
    lcfg = JLoRAConfig()
    jm = jax_build_model(jcfg)
    batch = jax_make_batch_for(jcfg, 2, PROMPT, seed=0)
    logits, cache = jax.jit(jax_prefill_step(jm, lcfg))(
        p, l, batch, jm.init_cache(2, MAX_LEN))
    dec = jax.jit(jax_decode_step(jm, lcfg))
    live = np.ones(2, bool)
    for i in range(STEPS + 1):
        last = np.asarray(logits)[:, -1]
        top2 = np.sort(last, axis=-1)[:, -2:]
        live &= top2[:, 1] - top2[:, 0] > 2 * D_TOL["atol"]
        tok = np.argmax(last, axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(res.tokens[live, i], tok[live, 0])
        if i < STEPS:
            _, logits, cache = dec(p, l, jnp.asarray(tok), cache,
                                   jnp.asarray(PROMPT + i, jnp.int32))
    assert live.any()


def test_serve_cli_on_the_cpu_and_its_refusals(capsys):
    serve_mod.main(["--device", "cpu", "--batch-size", "1", "--prompt-len",
                    "8", "--steps", "2", "--max-len", "16"])
    assert "generated token ids" in capsys.readouterr().out
    # --pull-from is ported: a server that does not answer is refused
    with pytest.raises(TransientTransportError, match="connect"):
        serve_mod.main(["--device", "cpu", "--pull-from", "http://localhost:1"])
    with pytest.raises(ValueError, match="exceed"):
        serve_mod.serve("paper-tiny", prompt_len=30, steps=8, max_len=32,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_mod.serve("paper-tiny")
