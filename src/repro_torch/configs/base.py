"""Config dataclasses for models, LoRA, federated runs and training.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing of
the JAX package): the same fields, defaults and validation, so a config built
here reads exactly like the reference's. The port runs every family of
:class:`ModelConfig`: dense, MoE, hybrid, ssm (xLSTM), encdec (whisper)
and vlm (internvl2); ``build_model`` raises ``NotImplementedError`` for any
other family name. :class:`ServeConfig`
holds the HTTP federation service's socket settings
(:mod:`repro_torch.fedsrv.server`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation for the config (paper / model card)

    # --- attention ----------------------------------------------------------
    head_dim: int = 0  # 0 → d_model // num_heads
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0  # >0 → SWA with this window on ALL attn layers
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global
    local_window: int = 0  # window used by "local" layers
    max_position_embeddings: int = 131_072
    learned_pos_embeddings: bool = False  # whisper-style

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden; 0 → d_ff
    first_k_dense: int = 0  # leading dense layers (deepseek)
    dense_d_ff: int = 0  # d_ff for those leading dense layers
    router_aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0  # zamba2: shared attention block every N mamba layers

    # --- xLSTM ---------------------------------------------------------------
    slstm_every: int = 0  # one sLSTM block per period of this many blocks

    # --- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0
    enc_seq_len: int = 0  # frames emitted by the (stubbed) audio frontend

    # --- vlm -----------------------------------------------------------------
    vision_tokens: int = 0  # patch embeddings emitted by the (stubbed) ViT

    # --- misc ----------------------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k tokens is sub-quadratic / windowed (DESIGN §4)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 or self.local_global_ratio > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (whisper is enc-dec)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv_heads = max(1, min(self.num_kv_heads, num_heads))
        kw: Dict = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else 0,
            max_position_embeddings=4096,
        )
        if self.is_moe:
            kw.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 256),
                first_k_dense=min(self.first_k_dense, 1),
                dense_d_ff=min(self.dense_d_ff, 256) if self.dense_d_ff else 0,
            )
        if self.mla:
            kw.update(kv_lora_rank=32, q_lora_rank=64, qk_rope_head_dim=16,
                      qk_nope_head_dim=32, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32)
        if self.attn_every:
            kw.update(attn_every=1, num_layers=2)
        if self.slstm_every:
            kw.update(slstm_every=2, num_layers=2)
        if self.enc_layers:
            kw.update(enc_layers=2, enc_seq_len=64)
        if self.vision_tokens:
            kw.update(vision_tokens=16)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.local_global_ratio:
            # keep exactly one (1 local + 1 global) period
            kw.update(local_global_ratio=1, local_window=64, num_layers=2)
        elif self.local_window:
            kw.update(local_window=64)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 4
    alpha: float = 8.0
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    include_mlp: bool = False  # also adapt FFN / expert projections
    lora_experts: bool = False  # per-expert adapters on MoE expert matrices
    dropout: float = 0.0  # kept for config parity; applied host-side in train

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class FedConfig:
    """Federated run settings (paper: 3-client cross-silo, FedAvg-style rounds)."""

    num_clients: int = 3
    rounds: int = 5
    local_steps: int = 10  # steps per client per round ("local epochs" analog)
    method: str = "fedex"  # fedex | fedit | ffa | fedex_svd | hetero | centralized
    svd_rank: int = 0  # fedex_svd: truncation rank r' (0 → k*r, i.e. exact)
    assignment: str = "average"  # average | keep_local | reinit  (Table 5)
    dirichlet_alpha: float = 0.5  # non-IID split concentration
    seed: int = 0
    # differential privacy on uploads (paper §7 future work; core/privacy.py):
    dp_clip: float = 0.0  # 0 → off; else L2 clip on the adapter delta
    dp_noise_multiplier: float = 0.0  # Gaussian σ = multiplier · clip
    # heterogeneous client ranks (paper §6 open problem; core/hetero.py +
    # core/engine.py method="hetero"): client i trains a rank-rᵢ adapter,
    # padded to r_max = lora.rank at the server; ``method="hetero"`` with an
    # empty tuple defaults every client to lora.rank (uniform hetero).
    client_ranks: Tuple[int, ...] = ()  # non-empty → the hetero close
    # per-client local step counts (mesh mode masks scan iterations past a
    # client's budget); empty → every client runs ``local_steps``
    client_local_steps: Tuple[int, ...] = ()
    # --- fedsrv coordinator (partial participation / stragglers / async) ---
    participation: float = 1.0  # fraction of clients sampled per round
    min_quorum: int = 0  # deliveries needed before the deadline cuts (0 → 1)
    round_deadline: float = 0.0  # sim-seconds; 0 → wait for every non-dropout
    weighting: str = "uniform"  # uniform | examples (wᵢ = nᵢ/Σnⱼ)
    mean_latency: float = 1.0  # straggler model: fleet-baseline sim-seconds
    latency_jitter: float = 0.25  # lognormal σ on client latency
    dropout_prob: float = 0.0  # P(client accepts round, never reports)
    straggler_prob: float = 0.0  # P(latency × straggler_factor)
    straggler_factor: float = 5.0
    async_buffer: int = 0  # >0 → FedBuff-style commits of this buffer size
    staleness_alpha: float = 0.5  # async: weight ∝ (1+staleness)^(−α)
    quantize_uplink: str = "none"  # none | fp16 | int8 adapter uplink codec
    # --- fused round-close engine (core/engine.py) ---
    # "auto" → the CUDA kernels (fedex_fold + factor_mean) when the tensors
    # lie on a CUDA device, their plain PyTorch versions on the CPU; "plain"
    # → the plain versions everywhere; "kernels" → the kernel close on any
    # device (on CPU tensors the wrappers run the plain versions, in place);
    # "off" → no engine: the eager list-of-trees close of
    # core/aggregation.py (fedit, ffa and centralized never build one).
    engine: str = "auto"
    # RoundBuffers ring depth: how many rounds' uplink stacks may be in
    # flight at once (2 = classic double buffering; >2 lets FedBuff commits
    # pipeline deeper). With an async buffer, rounds lagging ring_max_lag or
    # more commit versions are EVICTED from a full ring rather than wedging
    # it (stale uplinks for them are dropped).
    ring_depth: int = 2
    ring_max_lag: int = 1
    # chunked streaming round closes (core/engine.py chunked ring mode):
    # 0 → the classic stacked (C_max, …) close; N ≥ 1 → uplinks accumulate
    # in fixed-size N-client chunks, each full chunk folding eagerly on the
    # device while later uplinks keep streaming, so peak close memory is
    # O(chunk) instead of O(C). Auto semantics: a round whose candidate set
    # fits in one chunk still takes the stacked close, preserving the
    # stacked path's bitwise contract for small rounds.
    close_chunk: int = 0
    # observability mode (repro_torch.obs): "off" → shared zero-overhead no-op
    # recorder, "basic" → metrics + per-round records, "trace" → spans too
    # (Chrome trace-event export). The launcher's --trace/--metrics-out
    # flags imply trace/basic respectively.
    obs: str = "off"
    # --- fault injection + defended uplink (fedsrv/faults.py) ---
    # fault plan DSL, e.g. "nan@0.1;truncate@1(clients=2,rounds=0+1)" — ""
    # disables injection entirely. Seeded from `seed` via per-purpose rng
    # streams, so a plan replays bitwise regardless of participation.
    faults: str = ""
    # validate every decoded uplink against the registered adapter spec
    # (finite check, per-leaf shape/dtype, optional ∞-norm ceiling). Bad
    # uplinks are QUARANTINED: lane weight-masked to zero, close exact over
    # the survivors.
    uplink_validation: bool = True
    uplink_max_norm: float = 0.0  # 0 → no norm-outlier rejection
    uplink_retries: int = 2  # transient decode failures: bounded retries
    retry_backoff: float = 0.05  # sim-seconds; backoff · 2^attempt
    # --- crash-safe round state (checkpoint/) ---
    checkpoint_dir: str = ""  # "" → no round-state snapshots
    checkpoint_every: int = 1  # snapshot every N round boundaries

    def __post_init__(self):
        if self.method not in ("fedex", "fedit", "ffa", "fedex_svd",
                               "hetero", "centralized"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.client_ranks:
            if len(self.client_ranks) != self.num_clients:
                raise ValueError(
                    f"client_ranks has {len(self.client_ranks)} entries for "
                    f"{self.num_clients} clients")
            if any(r < 1 for r in self.client_ranks):
                raise ValueError(
                    f"client_ranks must be ≥ 1, got {self.client_ranks}")
        if self.client_local_steps:
            if len(self.client_local_steps) != self.num_clients:
                raise ValueError(
                    f"client_local_steps has {len(self.client_local_steps)} "
                    f"entries for {self.num_clients} clients")
            if any(not 1 <= s <= self.local_steps
                   for s in self.client_local_steps):
                raise ValueError(
                    f"client_local_steps must lie in [1, local_steps="
                    f"{self.local_steps}], got {self.client_local_steps}")
        if self.assignment not in ("average", "keep_local", "reinit"):
            raise ValueError(f"unknown assignment {self.assignment!r}")
        if self.engine not in ("auto", "plain", "kernels", "off"):
            raise ValueError(f"unknown engine {self.engine!r} "
                             "(auto | plain | kernels | off)")
        if self.svd_rank < 0:
            raise ValueError(
                f"svd_rank must be ≥ 0, got {self.svd_rank} "
                "(0 → exact aggregation, r' ≥ 1 → rank-r' truncation)")
        if self.weighting not in ("uniform", "examples"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if self.ring_depth < 1:
            raise ValueError(f"ring_depth must be ≥ 1, got {self.ring_depth}")
        if self.ring_max_lag < 1:
            raise ValueError(
                f"ring_max_lag must be ≥ 1, got {self.ring_max_lag} "
                "(a commit may always lag up to its own version)")
        if self.close_chunk < 0:
            raise ValueError(
                f"close_chunk must be ≥ 0, got {self.close_chunk} "
                "(0 → stacked closes, N ≥ 1 → N-client streaming chunks)")
        if self.obs not in ("off", "basic", "trace"):
            raise ValueError(f"unknown obs mode {self.obs!r} "
                             "(off | basic | trace)")
        if self.uplink_retries < 0:
            raise ValueError(
                f"uplink_retries must be ≥ 0, got {self.uplink_retries}")
        if self.uplink_max_norm < 0:
            raise ValueError(
                f"uplink_max_norm must be ≥ 0, got {self.uplink_max_norm}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be ≥ 1, got {self.checkpoint_every}")
        if self.faults:
            # parse up front, so a bad plan fails at config time (imported
            # here: the configs import nothing of fedsrv at module level)
            from repro_torch.fedsrv.faults import FaultPlan
            FaultPlan.parse(self.faults, seed=self.seed)


@dataclass(frozen=True)
class ServeConfig:
    """The HTTP federation service's socket surface
    (:mod:`repro_torch.fedsrv.server`). Everything federation-semantic
    (clients, rounds, quorum, deadline, weighting, codec, engine) stays in
    :class:`FedConfig`, so a served deployment and an in-process run are
    configured by the same dataclass and close identically."""

    host: str = "127.0.0.1"
    port: int = 8077  # 0 → ephemeral (the bound port is reported)
    # concurrent uplink decodes admitted; more POSTs get 429 + Retry-After
    max_concurrent: int = 16
    # POSTs a (client, round) may make before 429 (quota)
    quota_per_round: int = 4
    # shared bearer token: "" disables auth; otherwise every POST carries
    # "Authorization: Bearer <token>"
    token: str = ""

    def __post_init__(self):
        if not 0 <= self.port <= 65535:
            raise ValueError(f"port must be in [0, 65535], got {self.port}")
        if self.max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be ≥ 1, got {self.max_concurrent}")
        if self.quota_per_round < 1:
            raise ValueError(
                f"quota_per_round must be ≥ 1, got {self.quota_per_round}")


def validate_fed_lora(fed: "FedConfig", lora: "LoRAConfig") -> None:
    """Cross-config validation needing both dataclasses (call at launch).

    The fedex_svd truncation rank r' is bounded by the residual's rank:
    ΔW_res = Σwᵢaᵢ(bᵢ − b̄) has at most k·r nonzero singular values, so any
    r' > k·r transmits pure padding — reject it up front instead of letting
    ``fedex_svd_aggregate`` fall through to a silently-degenerate dense SVD.
    ``svd_rank = 0`` keeps the documented "exact" meaning (the plain fedex
    close; nothing is truncated).
    """
    if fed.method == "fedex_svd" and fed.svd_rank > fed.num_clients * lora.rank:
        raise ValueError(
            f"svd_rank={fed.svd_rank} exceeds the residual rank bound "
            f"k·r = {fed.num_clients}·{lora.rank} = "
            f"{fed.num_clients * lora.rank}; use 0 for the exact close")
    if fed.client_ranks and max(fed.client_ranks) > lora.rank:
        raise ValueError(
            f"client_ranks max {max(fed.client_ranks)} exceeds the r_max "
            f"template lora.rank={lora.rank}; ragged uplinks are padded to "
            "lora.rank, never truncated")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_ratio: float = 0.02
    schedule: str = "cosine"  # cosine | linear | constant
    total_steps: int = 1000
    batch_size: int = 8
    seq_len: int = 128
    microbatch: int = 0  # 0 → no grad accumulation
    seed: int = 0


def config_dict(cfg) -> Dict:
    return dataclasses.asdict(cfg)
