"""xLSTM (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory) blocks, the counterpart of ``repro/models/xlstm.py``.

The mLSTM trains and prefills *chunkwise-parallel* with the reference's
log-space stabilisation: within a chunk a quadratic, attention-like product
under a decay mask; across chunks a recurrence over the stabilised matrix
memory ``(C, n, m)``, here a Python loop over the chunks where the
reference scans. Decode is the O(1) recurrent update. The sLSTM is a true
recurrence over time (a Python loop over the positions) with block-diagonal
per-head recurrent weights and exponential-gate stabilisation. The
reference has no Pallas kernel for either cell: both are ``jnp`` ops and
``lax.scan``, so the port computes them in torch ops, on the card too.
Serving's adapted projections (the mLSTM's up_proj, q/k/v and down_proj;
the sLSTM's w_gates and its FFN's up_proj and down_proj) run the fused LoRA
kernel (B3), as every adapted projection of serving does.

Block layout follows the paper: mLSTM blocks are pre-LN up-projected
(factor ``ssm_expand``) with a causal-conv q/k path and output gating;
sLSTM blocks are post-normed with a gated FFN (factor 4/3). ``slstm_every``
sets the period (xLSTM[7:1]: one sLSTM block per 8).

Rounding follows the reference's: the cells run in f32 whatever the
model's dtype, their outputs cast back to the activations' dtype. The
sLSTM's carried ``h`` is cast back to the state's dtype every step (x's
dtype without a cache, the cache's with one), the h it outputs is not.

LoRA targets: up_proj, q_proj, k_proj, v_proj, down_proj (mLSTM), w_gates
and the FFN's up_proj / down_proj (sLSTM).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.util.cost import Loop
from repro_torch.models.common import (Params, apply_norm, dense,
                                       make_norm_params, maybe_lora, project,
                                       stacked_normal)
from repro_torch.models.mlp import mlp_block
from repro_torch.models.ssm import _causal_conv, _softplus, _store
from repro_torch.util.device import resolve_device

CONV = 4  # the mLSTM's causal conv width (fixed in the reference)
M_FLOOR = -1e30  # the stabiliser's floor: keeps m finite on empty rows


def _log_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: −softplus(−x)."""
    return -_softplus(-v)


def _floor(v: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(v, -1e30)`` (``torch.maximum``: a tie splits the
    gradient, as JAX's does; ``clamp_min`` would pass all of it)."""
    return torch.maximum(v, v.new_tensor(M_FLOOR))


# ==========================================================================
# mLSTM cell
# ==========================================================================

def mlstm_step(state, q, k, v, i_pre, lf):
    """One stabilised recurrent step (torch ops, no kernel).

    state: (C (B,H,Dk,Dv), n (B,H,Dk), m (B,H))
    q, k, v: (B,H,D); i_pre, lf: (B,H)  [lf = log f = logsigmoid(f_pre)]
    """
    c, n, m = state
    m_new = torch.maximum(lf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = (f_s[..., None, None] * c
             + i_s[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = f_s[..., None] * n + i_s[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, c_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new))
    den = torch.maximum(den, torch.exp(-m_new))
    h = num / den[..., None]
    return (c_new, n_new, m_new), h


def mlstm_chunked(q, k, v, i_pre, lf, *, chunk: int = 256, state=None,
                  final_state: bool = True):
    """Chunkwise-parallel stabilised mLSTM (torch ops, no kernel).

    q, k, v: (B, S, H, D) (k pre-scaled by D^-0.5); i_pre, lf: (B, S, H).
    state: optional (C, n, m). Returns (h (B,S,H,D) f32, final state, or
    None without ``final_state``).

    The chunks run in a Python loop (the reference's ``lax.scan``; a
    :class:`~repro_torch.util.cost.Loop`, so that the dry run's counter
    runs one of the middle chunks for all of them). With
    no ``state`` the memory starts empty (C, n zero, m −inf): the state's
    branch then has weight exp(−inf) = 0 and adds exact zeros, so the
    first chunk leaves it out, and no zero (B, H, D, D) product is kept
    for the backward pass; ``final_state=False`` (training) skips the last
    chunk's state update, which nothing reads.
    """
    bsz, s, h, d = q.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk

    def per_chunk(t):  # (B, S, H, ...) → (NC, B, H, L, ...)
        t = t.float().reshape(bsz, nc, chunk, h, *t.shape[3:])
        return t.permute(1, 0, 3, 2, *range(4, t.dim()))

    qc, kc, vc, ic, lfc = (per_chunk(t) for t in (q, k, v, i_pre, lf))
    c_st = n_st = m_st = None
    if state is not None:
        c_st, n_st, m_st = state
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    outs = []
    chunks = Loop(nc, q.device)  # the reference's lax.scan over the chunks
    for z in chunks:
        qb, kb, vb, ib, lfb = qc[z], kc[z], vc[z], ic[z], lfc[z]
        b_cum = torch.cumsum(lfb, dim=-1)  # (B,H,L) inclusive
        # D_ij = b_i - b_j + i_j (j <= i)
        dmat = b_cum[..., :, None] - b_cum[..., None, :] + ib[..., None, :]
        dmat = dmat.masked_fill(~causal, float("-inf"))
        m_i = torch.amax(dmat, dim=-1)
        if m_st is not None:
            state_scale = b_cum + m_st[..., None]  # log-scale of the state
            m_i = torch.maximum(m_i, state_scale)
        m_i = _floor(m_i)
        w = torch.exp(dmat - m_i[..., None])  # (B,H,L,L)
        sc = torch.matmul(qb, kb.transpose(-1, -2)) * w
        num = torch.matmul(sc, vb)
        # normalizer via n-vector: den_i = q_i · (Σ_j w_ij k_j + state_w_i n)
        n_comb = torch.matmul(w, kb)
        if m_st is not None:
            state_w = torch.exp(state_scale - m_i)[..., None]  # (B,H,L,1)
            num = num + state_w * torch.matmul(qb, c_st)
            n_comb = n_comb + state_w * n_st[..., None, :]
        den = torch.abs(torch.sum(qb * n_comb, dim=-1))
        den = torch.maximum(den, torch.exp(-m_i))
        outs.append(num / den[..., None])  # (B,H,L,D)
        if z == nc - 1 and not final_state:
            break

        # ---- state update to the chunk's end ----
        b_tot = b_cum[..., -1]  # (B,H)
        g = b_tot[..., None] - b_cum + ib  # (B,H,L): decay j→L + input gate
        m_next = torch.amax(g, dim=-1)
        if m_st is not None:
            m_next = torch.maximum(b_tot + m_st, m_next)
        m_next = _floor(m_next)
        w_state = torch.exp(g - m_next[..., None])[..., None]  # (B,H,L,1)
        c_in = torch.matmul((w_state * kb).transpose(-1, -2), vb)
        n_in = torch.sum(w_state * kb, dim=-2)
        if m_st is None:
            c_st, n_st = c_in, n_in
        else:
            decay = torch.exp(b_tot + m_st - m_next)
            c_st = decay[..., None, None] * c_st + c_in
            n_st = decay[..., None] * n_st + n_in
        m_st = m_next
    hs = chunks.stack(outs, dim=0)  # (NC, B, H, L, D)
    hs = hs.permute(1, 0, 3, 2, 4).reshape(bsz, s, h, d)
    return hs, (c_st, n_st, m_st) if final_state else None


def init_state(bsz: int, nheads: int, d_head: int, device):
    """The empty matrix memory: C, n zero, m −inf, all f32."""
    return (torch.zeros((bsz, nheads, d_head, d_head), dtype=torch.float32,
                        device=device),
            torch.zeros((bsz, nheads, d_head), dtype=torch.float32,
                        device=device),
            torch.full((bsz, nheads), float("-inf"), dtype=torch.float32,
                       device=device))


# ==========================================================================
# mLSTM block
# ==========================================================================

def _xlstm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.num_heads
    d_head = d_inner // nheads
    return d_inner, nheads, d_head


def _kernel(gen, k, n, lead, dtype, device, stddev=0.02) -> Params:
    return {"kernel": stacked_normal(gen, (*lead, k, n), lead, dtype, device,
                                     stddev)}


def make_mlstm_params(gen, cfg, dtype, device, lead=()) -> Params:
    """One mLSTM block's leaves, stacked on the ``lead`` axes: LayerNorm,
    ``up_proj`` (d → x, z: 2·d_inner), the depthwise ``conv`` (width 4,
    kernel N(0, 0.1²), zero bias), q/k/v (d_inner → d_inner), ``gate_proj``
    (d_inner → i, f: 2·H), the per-head norm and ``down_proj`` (d_inner →
    d), all in ``dtype``; kernels drawn a layer at a time."""
    d = cfg.d_model
    d_inner, nheads, _ = _xlstm_dims(cfg)
    return {
        "norm": make_norm_params("layernorm", (*lead, d), dtype, device),
        "up_proj": _kernel(gen, d, 2 * d_inner, lead, dtype, device),
        "conv": {
            "kernel": stacked_normal(gen, (*lead, CONV, d_inner), lead,
                                     dtype, device, stddev=0.1),
            "bias": torch.zeros((*lead, d_inner), dtype=dtype, device=device),
        },
        "q_proj": _kernel(gen, d_inner, d_inner, lead, dtype, device),
        "k_proj": _kernel(gen, d_inner, d_inner, lead, dtype, device),
        "v_proj": _kernel(gen, d_inner, d_inner, lead, dtype, device),
        "gate_proj": _kernel(gen, d_inner, 2 * nheads, lead, dtype, device),
        "head_norm": {"scale": torch.ones((*lead, d_inner), dtype=dtype,
                                          device=device)},
        "down_proj": _kernel(gen, d_inner, d, lead, dtype, device),
    }


def init_mlstm_cache(batch: int, cfg, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """``C`` (batch, H, Dh, Dh), ``n`` (batch, H, Dh) zero and ``m``
    (batch, H) −inf, f32 in every cache dtype; ``conv`` (batch, 3,
    d_inner) zero in ``dtype``."""
    d_inner, nheads, d_head = _xlstm_dims(cfg)
    dev = resolve_device(device)
    c, n, m = init_state(batch, nheads, d_head, dev)
    return {"C": c, "n": n, "m": m,
            "conv": torch.zeros((batch, CONV - 1, d_inner), dtype=dtype,
                                device=dev)}


def _per_head_rmsnorm(x: torch.Tensor, scale: torch.Tensor, nheads: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm-style per-head RMS norm over (B, S, H·Dh)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, nheads, d // nheads)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).reshape(b, s, d)
    return (y * scale.float()).to(x.dtype)


def mlstm_block(cfg, params: Params, x: torch.Tensor, *,
                lora: Optional[Params] = None, lora_scale: float = 0.0,
                cache: Optional[Params] = None, decode: bool = False,
                chunk: int = 256) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d_model) → (x + block(x), cache).

    Training: ``cache=None``. Serving: prefill (a ``cache``) and decode
    (``decode=True``, S = 1) update the cache's C, n, m and conv in place
    and run the adapted projections through the fused LoRA kernel. A
    sequence longer than ``chunk`` is padded to a multiple of it (i_pre
    −1e30, log f 0, q, k, v 0, as the reference pads) and runs chunk by
    chunk; one of at most ``chunk`` tokens runs as a single chunk of its
    own length. The reference pads that one to ``chunk`` too, which adds
    only terms of weight 0: a padded key lies above every real row's
    diagonal (masked to −inf), its state weight is exp(−1e30 − m) = 0,
    and log f 0 leaves the decay to the chunk's end unchanged."""
    bsz, s, _ = x.shape
    d_inner, nheads, d_head = _xlstm_dims(cfg)
    serving = cache is not None
    if decode and not (serving and s == 1):
        raise ValueError("mlstm_block: decode takes one token and a cache")

    def proj(inp, name):
        return project(inp, params[name], maybe_lora(lora, name), lora_scale,
                       serving)

    xn = apply_norm("layernorm", params["norm"], x)
    up = proj(xn, "up_proj")
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    x_conv, new_conv = _causal_conv(x_in, params["conv"]["kernel"],
                                    params["conv"]["bias"],
                                    cache["conv"] if serving else None)

    q = proj(x_conv, "q_proj")
    k = proj(x_conv, "k_proj")
    v = proj(x_in, "v_proj")
    gates = dense(x_conv, params["gate_proj"]).float()
    i_pre = gates[..., :nheads]
    lf = _log_sigmoid(gates[..., nheads:])

    qh = q.reshape(bsz, s, nheads, d_head).float()
    kh = k.reshape(bsz, s, nheads, d_head).float() * (d_head ** -0.5)
    vh = v.reshape(bsz, s, nheads, d_head).float()
    state = (cache["C"], cache["n"], cache["m"]) if serving else None

    if decode:
        state, h = mlstm_step(state, qh[:, 0], kh[:, 0], vh[:, 0],
                              i_pre[:, 0], lf[:, 0])
        h = h[:, None]
    else:
        pad = (-s) % chunk if s > chunk else 0
        if pad:
            qh, kh, vh = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (qh, kh, vh))
            i_pre = torch.nn.functional.pad(i_pre, (0, 0, 0, pad),
                                            value=M_FLOOR)
            lf = torch.nn.functional.pad(lf, (0, 0, 0, pad))
        h, state = mlstm_chunked(qh, kh, vh, i_pre, lf, chunk=chunk,
                                 state=state, final_state=serving)
        h = h[:, :s]
    if serving:
        for key, value in zip(("C", "n", "m"), state):
            _store(cache, key, value)
        _store(cache, "conv", new_conv)

    h = h.reshape(bsz, s, d_inner).to(x.dtype)
    h = _per_head_rmsnorm(h, params["head_norm"]["scale"], nheads)
    h = h * torch.nn.functional.silu(z)
    return x + proj(h, "down_proj").to(x.dtype), cache


# ==========================================================================
# sLSTM
# ==========================================================================

def make_slstm_params(gen, cfg, dtype, device, lead=()) -> Params:
    """One sLSTM block's leaves, stacked on the ``lead`` axes: LayerNorm,
    ``w_gates`` (d → z, i, f, o: 4·d), the raw per-head recurrent weights
    ``r_gates`` (4, H, Dh, Dh; N(0, 0.05²)), ``b_gates`` (4·d, zero, f32
    whatever ``dtype`` is), the per-head norm, the FFN's LayerNorm and its
    gated FFN of width int(4·d / 3) (up, gate, down; no biases)."""
    d = cfg.d_model
    nheads = cfg.num_heads
    d_head = d // nheads
    ff = int(d * 4 / 3)
    return {
        "norm": make_norm_params("layernorm", (*lead, d), dtype, device),
        "w_gates": _kernel(gen, d, 4 * d, lead, dtype, device),
        "r_gates": stacked_normal(gen, (*lead, 4, nheads, d_head, d_head),
                                  lead, dtype, device, stddev=0.05),
        "b_gates": torch.zeros((*lead, 4 * d), dtype=torch.float32,
                               device=device),
        "head_norm": {"scale": torch.ones((*lead, d), dtype=dtype,
                                          device=device)},
        "ffn_norm": make_norm_params("layernorm", (*lead, d), dtype, device),
        "ffn": {
            "up_proj": _kernel(gen, d, ff, lead, dtype, device),
            "gate_proj": _kernel(gen, d, ff, lead, dtype, device),
            "down_proj": _kernel(gen, ff, d, lead, dtype, device),
        },
    }


def init_slstm_cache(batch: int, cfg, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """``c`` zero, ``n`` one, ``m`` zero (batch, d) f32; ``h`` (batch, d)
    zero in ``dtype``."""
    d = cfg.d_model
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), dtype=dtype, device=dev)}


def _recurrent(r_gates: torch.Tensor) -> torch.Tensor:
    """``r_gates`` (4, H, Dh_i, Dh_j) as one f32 matrix a head, (H, 4·Dh_i,
    Dh_j), for a batched product over the heads."""
    g, h, di, dj = r_gates.shape
    return r_gates.float().permute(1, 0, 2, 3).reshape(h, g * di, dj)


def slstm_step(r: torch.Tensor, state: Dict, x_t: torch.Tensor):
    """One step of the recurrence (the reference's ``slstm_step``, its
    ``r_gates`` given as ``r`` = :func:`_recurrent` of them, once for a
    loop over time). x_t: (B, 4d) pre-computed input gate pre-activations
    W x + b, gate major (z | i | f | o); ``rec[g, b, h, i] = Σ_j
    r_gates[g, h, i, j] · h[b, h, j]``."""
    c, n, m, h_prev = state["c"], state["n"], state["m"], state["h"]
    b, d = c.shape
    nheads = r.shape[0]
    d_head = d // nheads
    hp = h_prev.float().reshape(b, nheads, d_head).permute(1, 2, 0)
    rec = torch.bmm(r, hp)  # (H, 4·Dh, B)
    rec = rec.reshape(nheads, 4, d_head, b).permute(1, 3, 0, 2).reshape(
        4, b, d)
    pre = x_t.float().reshape(b, 4, d).transpose(0, 1) + rec
    z = torch.tanh(pre[0])
    i_pre = pre[1]
    lf = _log_sigmoid(pre[2])
    o = torch.sigmoid(pre[3])
    m_new = torch.maximum(lf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.maximum(n_new, n_new.new_tensor(1e-6))
    return {"c": c_new, "n": n_new, "m": m_new,
            "h": h_new.to(h_prev.dtype)}, h_new


def slstm_block(cfg, params: Params, x: torch.Tensor, *,
                lora: Optional[Params] = None, lora_scale: float = 0.0,
                cache: Optional[Params] = None, decode: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d_model) → (block output, cache). The recurrence runs
    position by position (the reference's ``lax.scan``; a ``cost.Loop``,
    which the dry run's counter shortens); with a cache
    (serving) it starts from the cache's state, writes the state after the
    last position back in place (``h`` stays in the cache's dtype) and runs
    w_gates and the FFN's adapted projections through the fused LoRA
    kernel."""
    bsz, s, d = x.shape
    nheads = cfg.num_heads
    serving = cache is not None
    if decode and not (serving and s == 1):
        raise ValueError("slstm_block: decode takes one token and a cache")
    xn = apply_norm("layernorm", params["norm"], x)
    pre = project(xn, params["w_gates"], maybe_lora(lora, "w_gates"),
                  lora_scale, serving)
    pre = pre.float() + params["b_gates"]

    state = (dict(cache) if serving
             else init_slstm_cache(bsz, cfg, x.dtype, x.device))
    r = _recurrent(params["r_gates"])
    hs = []
    steps = Loop(s, x.device)
    for t in steps:
        state, h = slstm_step(r, state, pre[:, t])
        hs.append(h)
    hs = steps.stack(hs, dim=1)
    if serving:
        for key in ("c", "n", "m", "h"):
            _store(cache, key, state[key])

    hs = _per_head_rmsnorm(hs.to(x.dtype), params["head_norm"]["scale"],
                           nheads)
    y = x + hs
    yn = apply_norm("layernorm", params["ffn_norm"], y)
    ff = mlp_block(cfg, params["ffn"], yn, lora=maybe_lora(lora, "ffn"),
                   lora_scale=lora_scale, fused=serving)
    return (y + ff).to(x.dtype), cache
