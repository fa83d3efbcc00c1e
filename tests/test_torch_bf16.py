"""Serving in bf16, the reference's default dtype: the port's bf16 B3
(``lora_matmul``) and B8 (``flash_swa`` / ``swa_attention``), the weight
bridge's bf16 leaves, the serving projection with an f32 adapter on a bf16
model, and prefill, teacher-forced decode and ``serve()`` end to end,
against the JAX reference from the same numpy-made inputs and the
reference's own bf16 draws. On the CPU the port's kernel wrappers run their
plain versions; the JAX kernels run in Pallas interpret mode.

Tolerances:
* B3: ``lora_matmul_error_bound`` with its bf16 term, |s|·2⁻⁷·(|x|@|a|)@|b|
  (x@a rounded to bf16 once in each evaluation, possibly to neighbouring
  values) on top of the f32 terms of any two f32 evaluations; the two also
  agree inside the reference's own bf16 tolerance (rtol 4e-2, atol
  4e-2·max|y|, ``tests/test_kernels.py``).
* B8: ``swa_error_bound`` in bf16: the f32 tolerance (rtol 2e-5, atol 4e-5
  of A = P@|v|) plus 2·2⁻⁸·A for P's rounding (relative to the running max
  of 64-key tiles here, 128-key blocks in the JAX kernel as called) and
  2⁻⁷·A for the output's rounding.
* the slice: bf16 rounds at other places in the two frameworks (XLA fuses
  the reference's bf16 ops, torch rounds after each op; the port's B3 adds
  in f32 and rounds once), so the port's bf16 logits are held against the
  reference's f32 logits over the same bf16 weights (the f32 answer): no
  further than twice the reference's bf16 logits are, plus a floor of one
  bf16 rounding at the logit scale (2⁻⁸·max|logit|). Greedy tokens are
  compared only on rows whose f32 top-2 margin exceeds twice that bound.
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
from repro.kernels import swa_attention as jax_swa_attention  # noqa: E402
from repro.kernels.flash_swa import flash_swa as jax_flash_swa  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as jax_lora_matmul  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.common import dense as jax_dense  # noqa: E402
from repro_torch.bridge import (params_from_numpy, tensor_from_numpy,  # noqa: E402
                                to_numpy)
from repro_torch.configs import LoRAConfig, get_config  # noqa: E402
from repro_torch.kernels import (flash_swa, flash_swa_plain,  # noqa: E402
                                 lora_dense, lora_matmul,
                                 lora_matmul_error_bound, lora_matmul_plain,
                                 probes, swa_attention, swa_attention_plain,
                                 swa_error_bound)
from repro_torch.kernels.lora_matmul import (_body,  # noqa: E402
                                             _split_plan,
                                             _tc_split_plan)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402

BF16 = jnp.bfloat16
CPU = "cpu"
SCALE = 0.7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see test_torch_baselines.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, *shape):
    """N(0, 1) draws rounded to bf16, as an ``ml_dtypes`` numpy array."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape), BF16))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# the bridge
# --------------------------------------------------------------------------

def test_bridge_carries_bf16_leaves_bit_for_bit():
    """The reference's own bf16 draws (and a strided bf16 view) across and
    back: the same 16-bit patterns, and the f32 values exactly."""
    cfg = jax_get_config("paper-tiny")
    assert cfg.dtype == "bfloat16"
    jp = jax.tree.map(np.asarray,
                      jax.jit(jax_build_model(cfg).init)(jax.random.key(0)))
    strided = np.asarray(jp["layers"]["attn"]["q_proj"]["kernel"])[:, ::3].T
    tree = {"params": jp, "strided": strided, "f32": np.arange(
        6, dtype=np.float32).reshape(2, 3)}
    got = params_from_numpy(tree, CPU)
    back = to_numpy(got)
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_in) > 5
    for path, want in flat_in:
        t = got
        for key in path:
            t = t[key.key]
        b = back
        for key in path:
            b = b[key.key]
        if want.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(b, want)
            continue
        assert t.dtype == torch.bfloat16 and t.shape == want.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.ascontiguousarray(want).view(np.uint16))
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, want.astype(np.float32))
    # the tensor owns a copy
    src = _bf16(np.random.default_rng(0), 4, 4).copy()
    t = tensor_from_numpy(src)
    src[...] = 0
    assert bool(t.float().abs().sum() > 0)


# --------------------------------------------------------------------------
# B3: lora_matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,r", [
    (64, 128, 128, 1), (64, 128, 128, 4), (128, 256, 128, 16),
    (8, 256, 384, 4),      # decode rows
    (100, 96, 160, 16),    # tile-indivisible
    (7, 77, 33, 4),        # odd: the kernel's scalar paths
])
def test_lora_matmul_plain_bf16_matches_the_pallas_kernel(m, k, n, r):
    rng = np.random.default_rng(m + k + r)
    x, w, a, b = (_bf16(rng, m, k), _bf16(rng, k, n), _bf16(rng, k, r),
                  _bf16(rng, r, n))
    want = np.asarray(jax_lora_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        scale=SCALE, bm=min(128, m), bn=min(128, n), bk=min(128, k),
        interpret=True))
    tx, tw, ta, tb = (tensor_from_numpy(v) for v in (x, w, a, b))
    got = lora_matmul_plain(tx, tw, ta, tb, SCALE)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    bound = lora_matmul_error_bound(tx, tw, ta, tb, SCALE)
    assert (np.abs(got.numpy() - want) <= bound.numpy()).all()
    # the bf16 term is there; the two agree inside the reference's own bf16
    # tolerance too (rtol 4e-2, atol 4e-2·max|y|)
    f32_bound = lora_matmul_error_bound(tx.float(), tw.float(), ta.float(),
                                        tb.float(), SCALE)
    assert bool((bound > f32_bound).all())
    err = np.abs(got.numpy() - want)
    assert (err <= 4e-2 * (np.abs(want) + np.abs(want).max())).all()
    # the wrapper on the CPU is the plain version, f32 out
    assert torch.equal(lora_matmul(tx, tw, ta, tb, SCALE), got)


def test_lora_matmul_plain_bf16_rounds_x_at_once():
    """x@a is rounded to bf16 after the whole K sum, not kept in f32 (the
    TPU kernel's cast to b's dtype): with b = 1 and w = 0 the output is
    exactly scale × the rounded x@a."""
    rng = np.random.default_rng(2)
    x, a = _bf16(rng, 16, 300), _bf16(rng, 300, 4)
    tx, ta = tensor_from_numpy(x), tensor_from_numpy(a)
    tw = torch.zeros(300, 8, dtype=torch.bfloat16)
    tb = torch.ones(4, 8, dtype=torch.bfloat16)
    got = lora_matmul_plain(tx, tw, ta, tb, 1.0)
    xa = torch.matmul(tx.float(), ta.float())
    want = xa.to(torch.bfloat16).float().sum(-1, keepdim=True).expand(16, 8)
    assert torch.equal(got, want)
    assert not torch.equal(got, xa.sum(-1, keepdim=True).expand(16, 8))


@pytest.mark.parametrize("m,k,n,r", [
    (8, 768, 768, 4), (1, 3072, 1024, 1), (16, 300, 96, 16),  # split-K rows
    (4, 64, 256, 4),                                          # one K chunk
    (64, 256, 128, 16), (17, 777, 333, 3),                    # tiled rows
])
def test_lora_probe_pins_where_x_at_a_is_rounded(m, k, n, r):
    """On the probe's integer inputs every sum is exact, so the plain
    version (and the wrapper on the CPU) equals the exact answer bit for
    bit, as the Pallas kernel in interpret mode does; x@a left unrounded or
    rounded per K chunk (the chunks of the split-K body the shape takes,
    tensor-core or SIMT, for an H100's 132 SMs, or 64 rows; none where one
    chunk takes the whole K) gives another answer in many elements."""
    plan = _tc_split_plan if _body(m, k, n, True, True) == \
        "tensor-core split-K" else _split_plan
    chunk = plan(n, k, 132)[1] if m <= 16 else 64
    x, w, a, b, scale, want, faults = probes.lora_probe(m, k, n, r,
                                                        chunk=chunk, seed=m)
    assert torch.equal(lora_matmul_plain(x, w, a, b, scale), want)
    assert torch.equal(lora_matmul(x, w, a, b, scale), want)
    ref = np.asarray(jax_lora_matmul(
        *(jnp.asarray(to_numpy(t), BF16) for t in (x, w, a, b)), scale=scale,
        bm=min(128, m), bn=min(128, n), bk=min(128, k), interpret=True))
    np.testing.assert_array_equal(ref, want.numpy())
    seen = probes.differing(want, faults)
    assert len(seen) == 1 + (chunk < k)
    assert min(seen.values()) > want.numel() // 10, seen


def test_lora_dense_bf16_returns_x_dtype():
    rng = np.random.default_rng(4)
    x, w, a, b = (_bf16(rng, 2, 5, 64), _bf16(rng, 64, 48), _bf16(rng, 64, 4),
                  _bf16(rng, 4, 48))
    tx, tw, ta, tb = (tensor_from_numpy(v) for v in (x, w, a, b))
    got = lora_dense(tx, tw, ta, tb, SCALE)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 48)
    want = lora_matmul_plain(tx.reshape(10, 64), tw, ta, tb, SCALE)
    assert torch.equal(got, want.reshape(2, 5, 48).to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["x", "w", "a", "b"])
def test_lora_matmul_refuses_a_mix_of_dtypes(bad):
    """All f32 or all bf16: any one operand in the other dtype (or in
    float16) is a TypeError naming it, on the CPU too."""
    ops = {"x": torch.ones(4, 8), "w": torch.ones(8, 6),
           "a": torch.ones(8, 2), "b": torch.ones(2, 6)}
    for dt, other in ((torch.bfloat16, torch.float32),
                      (torch.float32, torch.bfloat16),
                      (torch.float32, torch.float16)):
        args = {k: v.to(dt) for k, v in ops.items()}
        args[bad] = args[bad].to(other)
        with pytest.raises(TypeError, match="lora_matmul"):
            lora_matmul(args["x"], args["w"], args["a"], args["b"], 1.0)


# --------------------------------------------------------------------------
# B8: flash_swa / swa_attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 200),
                                           (False, 0), (False, 64)])
def test_flash_swa_plain_bf16_matches_the_pallas_kernel(causal, window):
    rng = np.random.default_rng(10 + window + causal)
    q, k, v = (_bf16(rng, 3, 256, 32) for _ in range(3))
    want = jax_flash_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=128, bk=128,
                         interpret=True)
    assert want.dtype == BF16
    tq, tk, tv = (tensor_from_numpy(t) for t in (q, k, v))
    got = flash_swa(tq, tk, tv, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 256, 32)
    assert torch.equal(got, flash_swa_plain(tq, tk, tv, causal, window))
    bound = swa_error_bound(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                            causal, window)[:, :, 0]
    err = np.abs(got.float().numpy() - _f32(want))
    assert (err <= bound.numpy()).all()
    # inside the reference's own bf16 tolerance (rtol 3e-2, atol 6e-2)
    assert (bound.numpy() <= 6e-2 + 3e-2 * np.abs(_f32(want))).all()
    # bf16 rounding shows: the f32 oracle on the same values is not it
    f32 = flash_swa_plain(tq.float(), tk.float(), tv.float(), causal, window)
    assert not torch.equal(got.float(), f32)


@pytest.mark.parametrize("s,h,kvh,causal,window", [
    (128, 8, 2, True, 0), (128, 8, 2, True, 48), (256, 4, 4, False, 0)])
def test_swa_attention_bf16_gqa_matches_the_reference(s, h, kvh, causal,
                                                      window):
    rng = np.random.default_rng(s + h + window)
    q, k, v = _bf16(rng, 2, s, h, 32), _bf16(rng, 2, s, kvh, 32), \
        _bf16(rng, 2, s, kvh, 32)
    want = jax_swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    tq, tk, tv = (tensor_from_numpy(t) for t in (q, k, v))
    got = swa_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, h, 32)
    bound = swa_error_bound(tq, tk, tv, causal, window)
    assert (np.abs(got.float().numpy() - _f32(want)) <= bound.numpy()).all()


@pytest.mark.parametrize("b,s,h,kvh,d,causal", [
    (2, 130, 4, 2, 64, True), (1, 70, 2, 1, 66, False),
    (1, 100, 3, 3, 128, True), (1, 96, 2, 1, 256, True),
    (1, 80, 2, 2, 192, True), (1, 80, 2, 2, 112, True)])
def test_swa_probe_pins_where_p_is_rounded(b, s, h, kvh, d, causal):
    """On the probe's inputs only key 0 (p = 1, v = 0) and one key j* of
    each row survive, in the first KV tile, so the plain version equals
    the Pallas kernel in interpret mode bit for bit; p left unrounded, or l
    summing the rounded p, gives another answer in many elements."""
    q, k, v, faults = probes.swa_probe(b, s, h, kvh, d, causal=causal,
                                       seed=s + d)
    got = swa_attention(q, k, v, causal, 0)

    def heads(t):  # (B, S, H', D) → (B·H, S, D), KV heads repeated
        t = t.repeat_interleave(h // t.shape[2], dim=2)
        return jnp.asarray(to_numpy(t.transpose(1, 2).reshape(b * h, s, d)),
                           BF16)

    ref = jax_flash_swa(heads(q), heads(k), heads(v), causal=causal,
                        window=0, bq=s, bk=s, interpret=True)
    ref = _f32(ref).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert bool((got != 0).any())
    seen = probes.differing(got, faults)
    assert len(seen) == 2 and min(seen.values()) > 100, seen


def _scaled_after(q, k, v, causal):
    """``swa_attention_plain``'s bf16 function (no window) with the score
    scaled after the product, fl(q·k)·d^-½, as B8's tensor-core body
    scales its f32 accumulator, where the plain version and the Pallas
    kernel scale q first."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * d ** -0.5
    if causal:
        seen = torch.ones(sq, sk, dtype=torch.bool).tril()
        s = s.masked_fill(~seen, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bkgqc,bckd->bqkgd", p.to(torch.bfloat16).float(),
                       v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, d).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,s,h,kvh,d,causal", [
    (2, 512, 12, 12, 64, True), (2, 512, 24, 8, 128, True),
    (1, 256, 16, 8, 256, True), (2, 300, 4, 2, 128, False),
    (2, 130, 4, 4, 66, True), (1, 100, 3, 3, 128, True),
    (2, 256, 4, 4, 192, True), (2, 256, 4, 4, 112, True)])
def test_swa_probe_output_holds_under_either_scale_order(b, s, h, kvh, d,
                                                         causal, seed):
    """The probe's premise for B8's tensor-core body: on its inputs the
    plain version's output is bitwise the same whether the score is scaled
    before the product (q·d^-½, the reference) or after it (the tensor
    cores' f32 accumulator), so both evaluations must equal it bit for bit.
    The card tests' shapes (gemma3's at S 256 here) at batch ≤ 2."""
    q, k, v, _ = probes.swa_probe(b, s, h, kvh, d, causal=causal,
                                  seed=seed)
    want = swa_attention_plain(q, k, v, causal, 0)
    got = _scaled_after(q, k, v, causal)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_swa_attention_refuses_mixed_dtypes():
    q, k = torch.ones(1, 4, 4, 8), torch.ones(1, 4, 2, 8)
    with pytest.raises(TypeError, match="share"):
        swa_attention(q.bfloat16(), k, k)
    with pytest.raises(TypeError, match="share"):
        flash_swa(q[0], k[0].bfloat16(), k[0].bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        swa_attention(q.half(), k.half(), k.half())


# --------------------------------------------------------------------------
# the serving projection: an f32 adapter on a bf16 model
# --------------------------------------------------------------------------

def test_project_casts_an_f32_adapter_to_a_bf16_x():
    """``project`` (serving) with f32 factors on bf16 x and W runs B3 in
    bf16 (the factors cast first, as ``dense`` casts them), and lands
    within bf16's roundings of the f32 answer, as the reference's ``dense``
    does: at most 4·2⁻⁸ of |x|@|W| + |s|·(|x|@|a|)@|b| (the reference rounds
    x@W, x@a, the adapter product, its scaling and the sum; the port x@a
    and the output) plus the f32 terms."""
    rng = np.random.default_rng(6)
    x, w = _bf16(rng, 3, 7, 96), _bf16(rng, 96, 80)
    a = (0.5 * rng.standard_normal((96, 4))).astype(np.float32)
    b = (0.5 * rng.standard_normal((4, 80))).astype(np.float32)
    want = _f32(jax_dense(jnp.asarray(x), {"kernel": jnp.asarray(w)},
                          {"a": jnp.asarray(a), "b": jnp.asarray(b)}, SCALE))
    tx, tw = tensor_from_numpy(x), tensor_from_numpy(w)
    lora = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    got = model_common.project(tx, {"kernel": tw}, lora, SCALE, fused=True)
    assert got.dtype == torch.bfloat16
    cast = {k: v.to(torch.bfloat16) for k, v in lora.items()}
    assert torch.equal(got, lora_dense(tx, tw, cast["a"], cast["b"], SCALE))
    xa, wa = tx.float().reshape(21, 96).abs(), tw.float().abs()
    ab, bb = cast["a"].float().abs(), cast["b"].float().abs()
    mag = xa @ wa + SCALE * (xa @ ab) @ bb
    exact = lora_matmul_plain(tx.reshape(21, 96).double(), tw.double(),
                              cast["a"].double(), cast["b"].double(), SCALE)
    limit = 4 * 2.0 ** -8 * mag + lora_matmul_error_bound(
        tx.reshape(21, 96).float(), tw.float(), cast["a"].float(),
        cast["b"].float(), SCALE)
    for y in (got.float().reshape(21, 80), torch.from_numpy(want.copy())
              .reshape(21, 80)):
        assert bool(((y.double() - exact).abs() <= limit.double()).all())


# --------------------------------------------------------------------------
# the slice: prefill + decode and serve() in bf16 against the reference
# --------------------------------------------------------------------------

# arch → prompt: gemma3's prompt is past its window of 64 (a ring cache)
ARCHS = {"paper-tiny": 16, "paper-gpt2-smoke": 16, "gemma3-12b-smoke": 80}
STEPS = 4


def _b_nonzero(tree, rng):
    for key, node in tree.items():
        if key == "b":
            tree[key] = (0.02 * rng.standard_normal(node.shape)
                         ).astype(np.float32)
        elif isinstance(node, dict):
            _b_nonzero(node, rng)


@pytest.fixture(scope="module")
def reference():
    """arch → the reference's bf16 draws (params, an adapter with b drawn
    non-zero), and its prefill / decode steps jitted at bf16 (the config's
    dtype) and at f32 (the same bf16 weights widened: the f32 answer)."""
    out = {}
    lcfg = JLoRAConfig()
    for i, arch in enumerate(ARCHS):
        cfg = jax_get_config(arch)
        assert cfg.dtype == "bfloat16"
        jp = jax.tree.map(np.asarray, jax.jit(jax_build_model(cfg).init)(
            jax.random.key(i)))
        jl = jax.tree.map(np.asarray, jax_init_lora(jax.random.key(10 + i),
                                                    jp, cfg, lcfg))
        _b_nonzero(jl, np.random.default_rng(7 + i))
        steps = {}
        for name, c, p in (
                ("bf16", cfg, jp),
                ("f32", dataclasses.replace(cfg, dtype="float32"),
                 jax.tree.map(lambda t: t.astype(np.float32), jp))):
            m = jax_build_model(c)
            steps[name] = (m, p, jax.jit(jax_prefill_step(m, lcfg)),
                           jax.jit(jax_decode_step(m, lcfg)))
        out[arch] = (cfg, jp, jl, steps)
    return out


def _ref_run(steps, lora, toks, prompt, max_len):
    """Last-position logits of a prefill of toks[:, :prompt] and of each
    teacher-forced decode step after it."""
    m, p, pre, dec = steps
    lg, cache = pre(p, lora, {"tokens": jnp.asarray(toks[:, :prompt])},
                    m.init_cache(toks.shape[0], max_len))
    out = [np.asarray(lg)[:, -1]]
    for i in range(toks.shape[1] - prompt):
        pos = prompt + i
        _, lg, cache = dec(p, lora, jnp.asarray(toks[:, pos:pos + 1],
                                                jnp.int32), cache,
                           jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(lg)[:, -1])
    return out


def _bound(ref_bf16, ref_f32):
    """The criterion: twice the reference's bf16 distance from the f32
    answer plus one bf16 rounding at the logit scale."""
    return (2 * float(np.abs(ref_bf16 - ref_f32).max())
            + 2.0 ** -8 * float(np.abs(ref_f32).max()))


def _dtype_log(monkeypatch):
    """The dtypes of every x that reaches lora_dense and every q that
    reaches swa_attention."""
    seen = {"lora_dense": [], "swa_attention": []}

    def logged(name, fn):
        def wrapper(x, *args, **kw):
            seen[name].append(x.dtype)
            return fn(x, *args, **kw)
        return wrapper

    monkeypatch.setattr(model_common, "lora_dense",
                        logged("lora_dense", model_common.lora_dense))
    monkeypatch.setattr(attention, "swa_attention",
                        logged("swa_attention", attention.swa_attention))
    return seen


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_prefill_and_decode_against_the_f32_answer(arch, reference,
                                                        monkeypatch):
    """The port in bf16 from the reference's bf16 draws: prefill, then
    teacher-forced decode steps, each step's logits no further from the
    reference's f32 logits than the criterion allows, every adapted
    projection and prefill attention in bf16, greedy tokens agreeing on
    every row whose f32 margin is past twice the criterion."""
    cfg, jp, jl, steps = reference[arch]
    prompt = ARCHS[arch]
    max_len = prompt + STEPS
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, prompt + STEPS))
    ref = {k: _ref_run(s, jl, toks, prompt, max_len)
           for k, s in steps.items()}
    pm = build_model(get_config(arch))
    tp, tl = params_from_numpy(jp, CPU), params_from_numpy(jl, CPU)
    pre, dec = make_prefill_step(pm, LoRAConfig()), make_decode_step(
        pm, LoRAConfig())
    seen = _dtype_log(monkeypatch)
    got = []
    with torch.inference_mode():
        cache = pm.init_cache(2, max_len, device=CPU)
        lg, cache = pre(tp, tl, {"tokens": torch.as_tensor(
            toks[:, :prompt])}, cache)
        got.append(lg[:, -1].numpy())
        nexts = []
        for i in range(STEPS):
            pos = prompt + i
            nxt, lg, cache = dec(tp, tl, torch.as_tensor(toks[:, pos:pos + 1]),
                                 cache, pos)
            got.append(lg[:, -1].numpy())
            nexts.append(nxt.numpy()[:, 0])
    layers = cfg.num_layers
    assert seen["lora_dense"] == [torch.bfloat16] * 4 * layers * (1 + STEPS)
    assert seen["swa_attention"] == [torch.bfloat16] * layers
    for i, (g, rb, rf) in enumerate(zip(got, ref["bf16"], ref["f32"])):
        bound = _bound(rb, rf)
        err = float(np.abs(g - rf).max())
        assert err <= bound, (arch, i, err, bound)
        if i == 0:
            continue
        top2 = np.sort(rf, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * bound
        np.testing.assert_array_equal(nexts[i - 1][sure],
                                      np.argmax(rf, -1)[sure])
        np.testing.assert_array_equal(nexts[i - 1][sure],
                                      np.argmax(rb, -1)[sure])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_runs_the_configs_bf16_as_the_reference(arch, reference,
                                                      monkeypatch):
    """``serve()`` with no ``dtype`` serves the config's bf16, as the
    reference's launcher: every projection and prefill attention sees bf16;
    an f32 copy of the same weights is served cast to bf16 (the same
    tokens); and its greedy tokens are the f32 answer's greedy loop up to
    the first step whose f32 top-2 margin is within twice the criterion."""
    cfg, jp, jl, steps = reference[arch]
    prompt = ARCHS[arch]
    max_len = prompt + STEPS
    seen = _dtype_log(monkeypatch)
    kw = dict(batch_size=2, prompt_len=prompt, steps=STEPS, max_len=max_len,
              seed=0, device=CPU, lora=params_from_numpy(jl, CPU))
    res = serve_mod.serve(arch, params=params_from_numpy(jp, CPU), **kw)
    assert res.tokens.shape == (2, STEPS + 1)
    assert set(seen["lora_dense"]) == {torch.bfloat16}
    assert set(seen["swa_attention"]) == {torch.bfloat16}
    wide = params_from_numpy(jax.tree.map(lambda t: t.astype(np.float32), jp),
                             CPU)
    np.testing.assert_array_equal(serve_mod.serve(arch, params=wide,
                                                  **kw).tokens, res.tokens)
    batch = jax_make_batch_for(cfg, 2, prompt, seed=0)
    m32, p32, pre32, dec32 = steps["f32"]
    mbf, pbf, prebf, decbf = steps["bf16"]
    lg32, c32 = pre32(p32, jl, batch, m32.init_cache(2, max_len))
    lgbf, cbf = prebf(pbf, jl, batch, mbf.init_cache(2, max_len))
    live = np.ones(2, bool)
    for i in range(STEPS + 1):
        f32, bf = np.asarray(lg32)[:, -1], np.asarray(lgbf)[:, -1]
        top2 = np.sort(f32, axis=-1)[:, -2:]
        live &= top2[:, 1] - top2[:, 0] > 2 * _bound(bf, f32)
        tok = np.argmax(f32, axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(res.tokens[live, i], tok[live, 0])
        if i < STEPS:
            pos = jnp.asarray(prompt + i, jnp.int32)
            _, lg32, c32 = dec32(p32, jl, jnp.asarray(tok), c32, pos)
            _, lgbf, cbf = decbf(pbf, jl, jnp.asarray(tok), cbf, pos)
    assert live.any()
