"""Roofline constants of one H100 SXM + the MODEL_FLOPS yardstick.

Counterpart of ``repro/launch/roofline.py``. Two terms per (arch × shape)
step on one card, seconds:

    compute = flops / peak_flops(dtype)
    memory  = bytes / HBM_BYTES_PER_S

The flops and bytes come from :mod:`repro_torch.launch.cost`'s counter.
There is no interconnect term: on one card a step moves no collective
bytes. ``active_params`` and ``model_flops_per_step`` are the reference's
analytic yardstick (6·N_active·D train / 2·N_active·D inference), copied
verbatim, so that the "useful FLOPs" ratio reads the same work whatever
implements it.
"""

from __future__ import annotations

# H100 SXM data sheet. TF32 stays off in the port, so f32 matmuls run
# outside the tensor cores, at the f32 rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # bf16 dense tensor cores
F32_FLOPS_PER_S = 67e12    # f32 outside the tensor cores
HBM_BYTES = 80 * 2 ** 30   # device memory of one card


def peak_flops(dtype: str) -> float:
    """The card's peak FLOP/s for a step run in ``dtype`` (a config's
    dtype name): the bf16 tensor cores' for bf16, f32's otherwise."""
    return BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S


def model_flops_per_step(cfg, shape, lora_rank: int = 0) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference —
    the 'useful FLOPs' yardstick for the HLO_FLOPs ratio."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Parameter count touched per token (MoE: top-k experts only)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    v = cfg.vocab_size
    emb = v * d

    if cfg.family == "ssm":  # xlstm
        d_inner = cfg.ssm_expand * d
        per_mlstm = 2 * d * d_inner + 3 * d_inner * d_inner + d_inner * d + 2 * d_inner * cfg.num_heads
        per_slstm = 4 * d * d + int(d * 4 / 3) * d * 3
        period = cfg.slstm_every
        nper = cfg.num_layers // period
        return emb + nper * ((period - 1) * per_mlstm + per_slstm)

    def attn_params():
        if cfg.mla:
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            return (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qk
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    + cfg.kv_lora_rank * cfg.num_heads
                    * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + cfg.num_heads * cfg.v_head_dim * d)
        return (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                + cfg.num_heads * hd * d)

    def mlp_params(ff):
        gated = cfg.act == "silu"
        return (3 if gated else 2) * d * ff

    if cfg.family == "moe":
        ff = cfg.moe_d_ff or cfg.d_ff
        active_ff = ff * (cfg.num_experts_per_tok + cfg.num_shared_experts)
        n_moe = cfg.num_layers - cfg.first_k_dense
        total = emb + n_moe * (attn_params() + mlp_params(active_ff) + d * cfg.num_experts)
        total += cfg.first_k_dense * (attn_params() + mlp_params(cfg.dense_d_ff or cfg.d_ff))
        return total

    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        n = cfg.ssm_state
        per_mamba = d * (2 * d_inner + 2 * n + d_inner // cfg.ssm_head_dim) + d_inner * d
        napp = cfg.num_layers // cfg.attn_every
        return emb + cfg.num_layers * per_mamba + napp * (attn_params() + mlp_params(cfg.d_ff))

    if cfg.family == "encdec":
        per_enc = attn_params() + mlp_params(cfg.d_ff)
        per_dec = 2 * attn_params() + mlp_params(cfg.d_ff)
        return emb + cfg.enc_layers * per_enc + cfg.num_layers * per_dec

    # dense / vlm
    return emb + cfg.num_layers * (attn_params() + mlp_params(cfg.d_ff))
