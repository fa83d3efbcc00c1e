"""Federated fine-tuning trainer (paper §4.2 pipeline, host-orchestrated).

Counterpart of ``repro/core/federated.py``: k clients, each taking
``local_steps`` AdamW steps on its LoRA factors only, then the server's
close. The engine methods close through
:class:`~repro_torch.core.engine.RoundCloseEngine`:

* ``fedex`` with the ``average`` assignment — weighted factor means plus
  the residual fold ``W0 ← W0 + (α/r)·ΔW_res`` (Eq. 14); with ``reinit``
  the full ideal update folds and every client restarts from fresh
  adapters; with ``keep_local`` every delivered client keeps its adapters
  and its own base absorbs Σwⱼaⱼbⱼ − aᵢbᵢ (Table 5);
* ``fedex_svd`` — the residual truncated to rank ``svd_rank`` (Eq. 15–16;
  ``svd_rank=0`` means exact, the fedex close);
* ``hetero`` / ``client_ranks`` — client i trains at rank rᵢ; its uplink is
  zero-padded to r_max = ``lora.rank`` and the close hands it the leading
  rᵢ slice of one shared truncation, its own base absorbing the rest (§6).

The paper's baselines build no engine and close eagerly over the list of
delivered adapter trees (``repro_torch.core.aggregation``): ``fedit``
(FedAvg of the factors), ``ffa`` (FFA-LoRA: the a-gradients are zeroed, so
a moves only by weight decay, identically on every client) and
``centralized`` (one worker, client ``round % k``'s data, no coordinator
round). ``engine="off"`` closes every engine method eagerly the same way,
its divergence the eager §6 ``mean_deviation`` of the delivered adapters.
``dp_clip > 0`` clips and noises each coordinated client's adapter delta
before it is uploaded (``repro_torch.core.privacy``).

``close_chunk > 0`` closes rounds of more than that many clients in the
engine's chunked streaming mode: uplinks fold into running accumulators
chunk by chunk as they arrive, weighted by their raw weights (example
counts under ``weighting="examples"``).

Rounds are orchestrated by :class:`~repro_torch.fedsrv.RoundCoordinator`
(sampling, dropout, arrival order, the deadline cut under ``min_quorum``,
weighting) or, with ``async_buffer > 0``, by the FedBuff
:class:`~repro_torch.fedsrv.AsyncBufferCoordinator` (each round one commit
of the earliest arrivals, trained from their launch-version snapshot and
weighted n·(1 + staleness)^(−α)). Every uplink crosses the
:class:`~repro_torch.fedsrv.AdapterCodec` (``quantize_uplink`` none, fp16
or int8; validation with the ``uplink_max_norm`` ceiling quarantines a
lane) and streams into the engine's ring when there is one; every payload,
and the analytic downlink of the factored residual, lands in
``self.ledger``. A fault plan (``faults``; ``repro_torch.fedsrv.faults``)
corrupts, drops, duplicates or delays uplinks between encode and delivery,
and the close runs over the clients that delivered. Hetero and centralized
rounds never run through the coordinator, as the reference's do not, so the
coordinator's settings are refused under them; under a fault plan a hetero
round's uplinks cross its defended path all the same. keep_local and
hetero keep one base per client; under the engine each has its own copy of
the adapted W0 leaves, because the kernel closes fold in place (the eager
closes make new tensors).

The engine close returns its divergence as a device scalar, resolved at the
next round boundary, so the close runs on the device while the next
round's clients start.

``FedConfig.obs`` (``off`` | ``basic`` | ``trace``) builds the trainer's
``recorder`` (:mod:`repro_torch.obs`; ``off`` is the shared no-op
:data:`~repro_torch.obs.NULL`), shared with the engine, the coordinator, the
codec and the fault injector. Each round gets the ``round.close`` and
``round.eval`` spans, its ``eval_loss`` / ``eval_acc``, the ledger's totals
and, where the analytic table applies, ``comm_match``: the measured ledger
against :func:`repro_torch.core.comm.round_comm_params` at the delivered
count (:meth:`FederatedTrainer._reconcile_comm`); under a fault plan also
``global_finite``. The recorder adds no host sync to a round: the
divergence still resolves at the next round boundary.

With ``checkpoint_dir`` the trainer snapshots its round state every
``checkpoint_every`` round boundaries (:meth:`FederatedTrainer.save_state`,
``repro_torch.checkpoint``); a fresh trainer of the same configs that
:meth:`~FederatedTrainer.load_state`s the snapshot runs the remaining rounds
bitwise as the uninterrupted run. Every draw keys off ``(seed, round[,
client])`` (reinit's and DP's generators, the coordinator's and the fault
plan's numpy streams), so no generator state is saved.

The trainer takes optional initial ``params`` / ``global_lora`` trees and
per-client ``client_loras`` (the parity tests hand it the reference's
draws); without them it draws its own on its device.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (load_checkpoint, round_state_path,
                                    save_checkpoint)
from repro_torch.configs.base import (FedConfig, LoRAConfig, TrainConfig,
                                      validate_fed_lora)
from repro_torch.core import aggregation as agg
from repro_torch.core import privacy
from repro_torch.core.comm import adapted_matrices, round_comm_params
from repro_torch.core.decompose import (factored_residual_params,
                                        truncated_residual_params)
from repro_torch.core.divergence import mean_deviation
from repro_torch.core.engine import (DeferredDivergence, RoundCloseEngine,
                                     collect_w0_leaves, fold_back_w0)
from repro_torch.core.hetero import hetero_fedex_aggregate, pad_adapters
from repro_torch.core.lora import init_global_state, init_lora
from repro_torch.fedsrv import (AdapterCodec, AsyncBufferCoordinator,
                                BytesLedger, ClientInfo, ClientRegistry,
                                FaultInjector, FaultPlan, RoundCoordinator,
                                RoundPolicy, StragglerModel, ValidationPolicy)
from repro_torch.fedsrv.coordinator import Delivery, RoundOutcome
from repro_torch.obs import make_recorder
from repro_torch.optim import (adamw_update, clip_by_global_norm, init_adamw,
                               lr_at)
from repro_torch.util.device import resolve_device
from repro_torch.util.tree import (count_params, flatten_with_paths,
                                   unflatten_from_paths)


def _freeze_a(grads):
    return agg.map_factors(
        lambda f: {"a": torch.zeros_like(f["a"]), "b": f["b"]}, grads)


def make_local_step(model, lora_scale: float, train_cfg: TrainConfig,
                    freeze_a: bool = False) -> Callable:
    """One local step: LoRA-only gradients through autograd, global-norm
    clipping, AdamW. ``step(params, lora, opt_state, batch, lr) → (lora,
    opt_state, loss, gnorm)``; the frozen params get no gradient.
    ``freeze_a`` (FFA-LoRA) zeroes the a-gradients before the clipping."""

    def step(params, lora, opt_state, batch, lr):
        flat = {p: x.detach().requires_grad_(True)
                for p, x in flatten_with_paths(lora).items()}
        loss, _ = model.loss(params, batch, lora=unflatten_from_paths(flat),
                             lora_scale=lora_scale)
        grads = torch.autograd.grad(loss, list(flat.values()))
        grads = unflatten_from_paths(dict(zip(flat, grads)))
        if freeze_a:
            grads = _freeze_a(grads)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        new_lora, opt_state = adamw_update(
            grads, opt_state, unflatten_from_paths(
                {p: x.detach() for p, x in flat.items()}),
            learning_rate=lr, beta1=train_cfg.beta1, beta2=train_cfg.beta2,
            eps=train_cfg.eps, weight_decay=train_cfg.weight_decay)
        return new_lora, opt_state, loss.detach(), gnorm

    return step


def make_eval_fn(model, lora_scale: float) -> Callable:
    @torch.no_grad()
    def ev(params, lora, batch):
        _, metrics = model.loss(params, batch, lora=lora,
                                lora_scale=lora_scale)
        return metrics["loss"], metrics["accuracy"]

    return ev


def evaluate_on_batches(eval_fn, params, lora, batches) -> tuple[float, float]:
    """Mean (loss, accuracy) of ``eval_fn`` over ``batches`` (NaNs when
    empty). Shared by the host and mesh trainers."""
    if not batches:
        return float("nan"), float("nan")
    ls, accs = [], []
    for b in batches:
        l, a = eval_fn(params, lora, b)
        ls.append(float(l))
        accs.append(float(a))
    return sum(ls) / len(ls), sum(accs) / len(accs)


def resolve_divergences(history) -> None:
    """Round boundary: swap every :class:`DeferredDivergence` of the
    history for its value (the trainers' only wait on a close). Shared by
    the host and mesh trainers."""
    for rec in history:
        if isinstance(rec.divergence_scaled, DeferredDivergence):
            rec.divergence_scaled = rec.divergence_scaled.resolve()


@dataclass
class RoundRecord:
    round: int
    client_losses: List[float]
    eval_loss: float
    eval_acc: float
    # briefly a DeferredDivergence; the float after the next round boundary
    divergence_scaled: Any
    lr: float


RING_DEPTH = FedConfig.__dataclass_fields__["ring_depth"].default


def _hetero(fed: FedConfig) -> bool:
    """Client i trains at rank rᵢ (``method="hetero"`` without ranks: every
    client at ``lora.rank``); this takes precedence over ``method``."""
    return bool(fed.client_ranks) or fed.method == "hetero"


def _check_supported(fed: FedConfig) -> None:
    """Raise ``ValueError`` for a setting the run would ignore (the
    reference ignores these silently; the port ignores none)."""
    if _hetero(fed) or fed.method == "centralized":
        method = "hetero" if _hetero(fed) else "centralized"
        coordinated = {
            "participation": fed.participation < 1,
            "min_quorum": fed.min_quorum > 0,
            "round_deadline": fed.round_deadline > 0,
            "dropout_prob": fed.dropout_prob > 0,
            "async_buffer": fed.async_buffer > 0,
            "quantize_uplink": fed.quantize_uplink != "none",
            "uplink_max_norm": fed.uplink_max_norm > 0,
        }
        asked = [k for k, v in coordinated.items() if v]
        if asked:
            raise ValueError(f"FedConfig sets {asked} under {method}, whose "
                             "rounds never run through the coordinator")
    if fed.dp_noise_multiplier > 0 and fed.dp_clip <= 0:
        raise ValueError(f"dp_noise_multiplier={fed.dp_noise_multiplier} "
                         f"with dp_clip={fed.dp_clip}: uploads are "
                         "privatized only under a clip, so the noise would "
                         "never be added")
    if fed.dp_clip > 0 and (_hetero(fed) or fed.method == "centralized"):
        method = "hetero" if _hetero(fed) else "centralized"
        raise ValueError(f"dp_clip={fed.dp_clip} under {method}, whose "
                         "uploads are never privatized")
    if fed.faults and (fed.method == "centralized"
                       or (_hetero(fed) and fed.engine == "off")):
        method = "centralized" if fed.method == "centralized" else (
            "the eager hetero close")
        raise ValueError(f"faults={fed.faults!r} under {method}, whose "
                         "uploads never cross the uplink path")
    if engine_method(fed) is None:
        why = ("engine='off'" if fed.engine == "off"
               else f"method={fed.method!r}")
        ignored = {"close_chunk": fed.close_chunk > 0,
                   "ring_depth": fed.ring_depth != RING_DEPTH}
        asked = [k for k, v in ignored.items() if v]
        if asked:
            raise ValueError(f"FedConfig sets {asked}, which only the engine "
                             f"close uses, and {why} builds no engine")


def engine_method(fed: FedConfig) -> Optional[str]:
    """The engine close a config runs (the reference's selection); ``None``
    for the eager closes (``engine="off"``, fedit, ffa, centralized)."""
    if fed.engine == "off":
        return None
    if _hetero(fed):
        return "hetero"
    if fed.method == "fedex_svd":
        return "fedex_svd" if fed.svd_rank else "fedex"  # 0 means exact
    if fed.method == "fedex":
        return {"average": "fedex", "keep_local": "keep_local",
                "reinit": "reinit"}[fed.assignment]
    return None


@dataclass
class FederatedTrainer:
    model: Any
    lora_cfg: LoRAConfig
    fed_cfg: FedConfig
    train_cfg: TrainConfig
    client_loaders: List[Any]
    eval_batches: List[Dict] = field(default_factory=list)
    seed: int = 0
    device: Any = "cuda"
    params: Optional[Dict] = None
    global_lora: Optional[Dict] = None
    # hetero: each client's initial rank-rᵢ adapters (default: own draws).
    # It exists for the parity tests, which hand it the reference's draws.
    client_loras: Optional[List[Dict]] = None
    # the obs recorder; None → built from fed_cfg.obs (pass a shared one to
    # collect several runs, each under its own set_run label)
    recorder: Any = None

    def __post_init__(self):
        _check_supported(self.fed_cfg)
        validate_fed_lora(self.fed_cfg, self.lora_cfg)
        self.device = resolve_device(self.device)
        if self.recorder is None:
            self.recorder = make_recorder(self.fed_cfg.obs, self.device)
        if (self.params is None) != (self.global_lora is None):
            raise ValueError("pass both params and global_lora, or neither")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        if self.params is None:
            self.params, self.global_lora = init_global_state(
                self.model, self.lora_cfg, device=self.device, generator=gen)
        if not self.global_lora:
            raise ValueError("no LoRA targets matched — check target_modules")
        self.scale = self.lora_cfg.scale
        self.method = self.fed_cfg.method
        self.local_step = make_local_step(self.model, self.scale,
                                          self.train_cfg,
                                          freeze_a=self.method == "ffa")
        self.eval_fn = make_eval_fn(self.model, self.scale)
        self.history: List[RoundRecord] = []
        # RoundOutcome per round; adapter payloads are kept only on the last
        self.outcomes: List[Any] = []
        self._global_step = 0
        self._total_steps = self.fed_cfg.rounds * self.fed_cfg.local_steps
        self._start_round = 0
        fc = self.fed_cfg
        k = fc.num_clients
        method = engine_method(fc)
        self.hetero = _hetero(fc)
        self.keep_local = (self.method == "fedex"
                           and fc.assignment == "keep_local")
        self.client_ranks = None
        if self.hetero:  # no explicit ranks: every client at lora.rank
            self.client_ranks = (list(fc.client_ranks)
                                 or [self.lora_cfg.rank] * k)
        clients = [
            ClientInfo(client_id=i, num_examples=len(
                self.client_loaders[i % len(self.client_loaders)].sequences))
            for i in range(k)]
        self.engine = None
        if method is not None:
            self.engine = RoundCloseEngine(
                self.params, self.global_lora, c_max=k, scale=self.scale,
                method=method,
                svd_rank=fc.svd_rank if method == "fedex_svd" else 0,
                backend=fc.engine, depth=fc.ring_depth,
                client_ranks=self.client_ranks, chunk=fc.close_chunk,
                recorder=self.recorder)
        # keep_local and hetero: one base per client. The kernel closes fold
        # into them in place, so under the engine each has its OWN adapted
        # W0 leaves (no two clients, and not self.params, may share one);
        # the eager closes make new tensors and may start from shared ones
        self.client_params: Optional[List[Dict]] = None
        self._client_lora: Optional[List[Dict]] = None
        if self.keep_local or self.hetero:
            if self.engine is None:
                self.client_params = [self.params] * k
            else:
                specs = self.engine.specs
                self.client_params = [
                    fold_back_w0(specs, self.params, {
                        key: leaf.clone() for key, leaf in
                        collect_w0_leaves(specs, self.params).items()})
                    for _ in range(k)]
            self._client_lora = [self.global_lora] * k
        if self.hetero:
            if self.client_loras is None:
                self.client_loras = [
                    init_lora(gen, self.params, self.model.cfg,
                              replace(self.lora_cfg, rank=r))
                    for r in self.client_ranks]
            if len(self.client_loras) != k:
                raise ValueError(f"{len(self.client_loras)} client_loras for "
                                 f"{k} clients")
            self._client_lora = list(self.client_loras)
        self.ledger = BytesLedger()
        self.coordinator = self._build_coordinator(clients)

    def _build_coordinator(self, clients: List[ClientInfo]):
        """The coordinator of ``fed_cfg`` (the reference's selection): its
        policy, straggler and dropout model, the uplink codec with its
        validation, ``self.ledger``, the fault plan's injector
        (``self.fault_injector``, None without a plan) and the engine's ring
        as its sink."""
        fc = self.fed_cfg
        registry = ClientRegistry(clients, seed=fc.seed)
        policy = RoundPolicy(participation=fc.participation,
                             min_quorum=fc.min_quorum,
                             deadline=fc.round_deadline,
                             weighting=fc.weighting)
        stragglers = StragglerModel(
            mean_latency=fc.mean_latency, jitter=fc.latency_jitter,
            dropout_prob=fc.dropout_prob, straggler_prob=fc.straggler_prob,
            straggler_factor=fc.straggler_factor, seed=fc.seed)
        codec = AdapterCodec(fc.quantize_uplink, validation=ValidationPolicy(
            enabled=fc.uplink_validation, max_norm=fc.uplink_max_norm))
        self.fault_injector = (FaultInjector(FaultPlan.parse(
            fc.faults, seed=fc.seed), recorder=self.recorder)
            if fc.faults else None)
        common = dict(sink=self.engine.buffers if self.engine else None,
                      faults=self.fault_injector,
                      uplink_retries=fc.uplink_retries,
                      retry_backoff=fc.retry_backoff, recorder=self.recorder)
        if fc.async_buffer > 0:
            return AsyncBufferCoordinator(
                registry, policy, stragglers, codec, self.ledger,
                buffer_size=fc.async_buffer,
                staleness_alpha=fc.staleness_alpha,
                max_version_lag=fc.ring_max_lag, **common)
        return RoundCoordinator(registry, policy, stragglers, codec,
                                self.ledger, **common)

    def _ledger_residual(self, rnd: int, k_delivered: int, leaf_shapes,
                         truncated_rank: int = 0) -> None:
        """Ledger the server → client residual broadcast analytically, in
        the factored form of :mod:`repro_torch.core.decompose` (never the
        dense m×n matrix), to each of the ``k_delivered`` clients."""
        per_client = 0
        for shape in leaf_shapes:
            if len(shape) < 2:
                continue
            copies = math.prod(shape[:-2])
            m, n = int(shape[-2]), int(shape[-1])
            if truncated_rank:
                per_client += copies * truncated_residual_params(
                    m, n, truncated_rank)
            else:
                per_client += copies * factored_residual_params(
                    m, n, self.lora_cfg.rank, k_delivered)
        self.ledger.record_analytic(rnd, "downlink",
                                    per_client * k_delivered,
                                    note="factored-residual broadcast")

    def _stamp_comm(self, rnd: int) -> None:
        """The ledger's totals of round ``rnd`` on its round record."""
        tot = self.ledger.round_totals(rnd)
        self.recorder.round_set(
            rnd, uplink_params=tot["uplink_params"],
            uplink_bytes=tot["uplink_bytes"],
            downlink_params=tot["downlink_params"],
            downlink_bytes=tot["downlink_bytes"])

    def _reconcile_comm(self, rnd: int, outcome) -> None:
        """Stamp the round's measured ledger totals and, where the analytic
        table applies (fedex with the average assignment, fedit, fedex_svd,
        when the adapters are the table's matrices),
        ``comm_match``: the measured parameter counts against
        :func:`~repro_torch.core.comm.round_comm_params` at the observed
        delivered count — two independent accountings of one round."""
        rec = self.recorder
        self._stamp_comm(rnd)
        k_d = len(outcome.delivered)
        method = self.method
        if (k_d == 0 or method not in ("fedex", "fedit", "fedex_svd")
                or (method == "fedex"
                    and self.fed_cfg.assignment != "average")):
            return
        mats = adapted_matrices(self.model.cfg, self.lora_cfg)
        r = self.lora_cfg.rank
        if count_params(self.global_lora) != sum(ms.m * r + r * ms.n
                                                 for ms in mats):
            return  # the adapters are not the table's matrix set
        svd = self.fed_cfg.svd_rank
        eff = "fedex" if method == "fedex_svd" and not svd else method
        analytic = round_comm_params(
            eff, mats, r, self.fed_cfg.num_clients,
            svd_rank=min(svd, r * k_d) if svd else 0, participants=k_d)
        recon = self.ledger.reconcile(rnd, analytic)
        rec.round_set(rnd, comm_match=int(recon["ok"]))
        rec.counter(f"comm.reconcile_{'ok' if recon['ok'] else 'mismatch'}"
                    ).inc()
        if not recon["ok"]:
            rec.event("comm.mismatch", cat="trainer", round=rnd,
                      uplink=recon["uplink"], downlink=recon["downlink"])

    # ------------------------------------------------------------------
    def _client_round(self, client: int, params, lora):
        loader = self.client_loaders[client % len(self.client_loaders)]
        opt_state = init_adamw(lora)
        losses = []
        steps = (self.fed_cfg.client_local_steps[client]
                 if self.fed_cfg.client_local_steps
                 else self.fed_cfg.local_steps)
        for s in range(steps):
            batch = loader.next_batch()
            lr = lr_at(self._global_step + s,
                       base_lr=self.train_cfg.learning_rate,
                       total_steps=self._total_steps,
                       warmup_ratio=self.train_cfg.warmup_ratio,
                       kind=self.train_cfg.schedule)
            lora, opt_state, loss, _ = self.local_step(params, lora,
                                                       opt_state, batch, lr)
            losses.append(float(loss))
        return lora, losses

    def _evaluate(self, params, lora) -> tuple[float, float]:
        return evaluate_on_batches(self.eval_fn, params, lora,
                                   self.eval_batches)

    def _resolve_divergences(self) -> None:
        resolve_divergences(self.history)

    def _record_outcome(self, outcome) -> None:
        """Keep the round's outcome; adapter payloads only of the last."""
        self.outcomes.append(outcome)
        if len(self.outcomes) > 1:
            for d in self.outcomes[-2].delivered:
                d.lora = None

    # ------------------------------------------------------------------
    def _close_round(self, rnd: int, outcome) -> Any:
        """The close of a coordinated round; returns its divergence."""
        eng, rid = self.engine, outcome.round_id
        if eng is None:
            return self._eager_close(rnd, outcome)
        if eng.method == "keep_local":
            new_cp, div = eng.close_keep_local(
                self.client_params, outcome.client_ids, outcome.weights,
                round_id=rid)
            for d in outcome.delivered:
                cid = d.client.client_id
                self._client_lora[cid] = d.lora
                self.client_params[cid] = new_cp[cid]
            self.global_lora = outcome.delivered[0].lora
            return div
        rng = None
        if eng.method == "reinit":
            rng = torch.Generator(device=self.device)
            rng.manual_seed(self.seed + rnd)
        self.global_lora, self.params, div = eng.close(
            self.params, outcome.client_ids, outcome.weights, round_id=rid,
            rng=rng)
        # the truncation rank clamped to the delivered subset's bound k_d·r
        k_d = len(outcome.client_ids)
        self._ledger_residual(
            rnd, k_d, [s.w0_shape for s in eng.specs],
            truncated_rank=(min(eng.svd_rank, self.lora_cfg.rank * k_d)
                            if eng.method == "fedex_svd" else 0))
        return div

    def _eager_close(self, rnd: int, outcome) -> float:
        """The reference's eager close over the delivered adapter trees; the
        divergence is the §6 deviation of those trees, taken before it."""
        loras = [d.lora for d in outcome.delivered]
        weights = outcome.weights
        div = mean_deviation(loras)
        method, assignment = self.method, self.fed_cfg.assignment
        residual, truncated = None, 0
        if method == "fedit":
            self.global_lora = agg.fedit_aggregate(loras, weights)
        elif method == "ffa":
            self.global_lora = agg.ffa_aggregate(loras, weights)
        elif method == "fedex_svd":
            # clamp to the delivered subset's rank bound k_d·r (config-time
            # validation bounds r' by k·r only; 0 means exact)
            bound = self.lora_cfg.rank * len(loras)
            truncated = min(self.fed_cfg.svd_rank or bound, bound)
            self.global_lora, residual = agg.fedex_svd_aggregate(
                loras, truncated, weights)
            self.params = agg.apply_residual(self.params, residual,
                                             self.scale)
        elif assignment == "average":
            self.global_lora, residual = agg.fedex_aggregate(loras, weights)
            self.params = agg.apply_residual(self.params, residual,
                                             self.scale)
        elif assignment == "reinit":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed + rnd)
            new_loras, residual = agg.assign_after_aggregation(
                "reinit", loras, gen, weights)
            self.global_lora = new_loras[0]
            self.params = agg.apply_residual(self.params, residual,
                                             self.scale)
        else:  # keep_local
            residuals = agg.per_client_residuals(loras, weights)
            for cid, lora_i, res_i in zip(outcome.client_ids, loras,
                                          residuals):
                self._client_lora[cid] = lora_i
                self.client_params[cid] = agg.apply_residual(
                    self.client_params[cid], res_i, self.scale)
            self.global_lora = loras[0]
        if residual is not None:
            self._ledger_residual(
                rnd, len(loras), [x.shape for x in
                                  flatten_with_paths(residual).values()],
                truncated_rank=truncated)
        return div

    def _hetero_round(self, rnd: int):
        """Every client trains at its rank rᵢ; its uplink is zero-padded to
        r_max (and, under the engine, written straight into the ring with
        its true rank); the close folds each client's residual into its own
        base. Under a fault plan each padded uplink instead crosses the
        coordinator's defended path with its true rank, and the close runs
        over the clients it delivered: a quarantined or dropped lane is
        never written and contributes nothing."""
        k, eng = self.fed_cfg.num_clients, self.engine
        coord = self.coordinator
        rid = (eng.buffers.begin_round({c: c for c in range(k)}, rnd)
               if eng else rnd)
        if self.fault_injector is not None:
            coord._ensure_spec(self.global_lora)
        client_losses, delivered, uplinks, quarantined = [], [], [], []
        for c in range(k):
            lora_c, losses = self._client_round(c, self.client_params[c],
                                                self._client_lora[c])
            client_losses.append(losses[-1])
            padded = pad_adapters(lora_c, self.lora_cfg.rank)
            if self.fault_injector is not None:
                res = coord._uplink(padded, rid, c,
                                    rank=self.client_ranks[c])
                if not res.ok:
                    quarantined.append((c, res.reason))
                    continue
                padded = res.tree
            elif eng:
                eng.buffers.write(c, padded, round_id=rid,
                                  rank=self.client_ranks[c])
            uplinks.append(lora_c)
            delivered.append(Delivery(client=coord.registry.get(c),
                                      lora=padded, launched_at=0.0,
                                      arrived_at=0.0))
        self._record_outcome(RoundOutcome(
            round_id=rid, sampled=list(range(k)), delivered=delivered,
            dropped_out=[], dropped_deadline=[], weights=None,
            opened_at=0.0, closed_at=0.0, quarantined=quarantined))
        # round boundary: the previous round's divergence resolves only now
        self._resolve_divergences()
        if eng is None:
            return client_losses, self._eager_hetero_close(uplinks)
        ids = self.outcomes[-1].client_ids
        with self.recorder.span("round.close", cat="trainer", round=rnd,
                                engine=True):
            new_cp, new_loras, self.global_lora, div = eng.close_hetero(
                self.client_params, ids, round_id=rid)
        for c in ids:
            self.client_params[c] = new_cp[c]
            self._client_lora[c] = new_loras[c]
        if self.recorder.enabled:
            # a faulty round's uplinks crossed the codec; otherwise nothing
            # measurable was sent
            self._stamp_comm(rnd)
        return client_losses, div

    def _eager_hetero_close(self, loras: List[Dict]) -> float:
        """``hetero_fedex_aggregate`` over the rank-rᵢ uplinks; the
        divergence is the dispersion of client 0's product around the
        clients' mean product (the uplinks' ranks differ, so the factor
        deviation is undefined), summed over the adapted leaves."""
        k = len(loras)
        new_loras, residuals = hetero_fedex_aggregate(
            loras, list(self.client_ranks), r_max=self.lora_cfg.rank)
        self._client_lora = new_loras
        self.client_params = [agg.apply_residual(p, r_i, self.scale)
                              for p, r_i in zip(self.client_params, residuals)]
        self.global_lora = new_loras[0]
        prods = [flatten_with_paths(agg.product_mean([x])) for x in loras]
        return sum(float(torch.sqrt(torch.mean(torch.square(
            x - sum(p[key] for p in prods) / k))))
            for key, x in prods[0].items())

    def _train_fn(self, round_losses: Dict[int, float]) -> Callable:
        """One coordinated client's local steps (from its own adapters and
        base under keep_local), its upload privatized when ``dp_clip > 0``;
        its last loss lands in ``round_losses``."""
        fc = self.fed_cfg

        def train_fn(client, start_lora, round_id):
            c = client.client_id
            base = self.client_params[c] if self.keep_local else self.params
            start = self._client_lora[c] if self.keep_local else start_lora
            lora_c, losses = self._client_round(c, base, start)
            if fc.dp_clip > 0:
                gen = torch.Generator(device=self.device)
                # the reference's integer, so a seed names the same streams
                gen.manual_seed(hash((self.seed, round_id, c)) % 2 ** 31)
                lora_c = privacy.privatize_upload(
                    gen, lora_c, start, clip=fc.dp_clip,
                    noise_multiplier=fc.dp_noise_multiplier)
            round_losses[c] = losses[-1]
            return lora_c

        return train_fn

    def run(self, until: Optional[int] = None) -> List[RoundRecord]:
        """Run rounds ``[_start_round, until)`` (default: all configured)."""
        stop = self.fed_cfg.rounds if until is None else until
        k = self.fed_cfg.num_clients
        for rnd in range(self._start_round, stop):
            lr_now = lr_at(self._global_step,
                           base_lr=self.train_cfg.learning_rate,
                           total_steps=self._total_steps,
                           kind=self.train_cfg.schedule,
                           warmup_ratio=self.train_cfg.warmup_ratio)
            if self.hetero:
                client_losses, div = self._hetero_round(rnd)
            elif self.method == "centralized":
                # one worker sees every client's stream round-robin
                self.global_lora, losses = self._client_round(
                    rnd % k, self.params, self.global_lora)
                client_losses, div = [losses[-1]], 0.0
            else:
                round_losses: Dict[int, float] = {}
                outcome = self.coordinator.run_round(
                    rnd, self._train_fn(round_losses), self.global_lora)
                # round boundary: the previous round's divergence resolves
                # only after this round's clients ran, so its close
                # overlapped them
                self._resolve_divergences()
                self._record_outcome(outcome)
                client_losses = [round_losses[c] for c in outcome.client_ids]
                if not outcome.delivered or outcome.degraded:
                    div = 0.0  # carry the previous global forward
                    if not client_losses:
                        client_losses = [float("nan")]
                else:
                    with self.recorder.span("round.close", cat="trainer",
                                            round=rnd,
                                            engine=self.engine is not None):
                        div = self._close_round(rnd, outcome)
                if self.recorder.enabled:
                    self._reconcile_comm(rnd, outcome)
            self._global_step += self.fed_cfg.local_steps
            if self.client_params is not None:
                eval_params, eval_lora = (self.client_params[0],
                                          self._client_lora[0])
            else:
                eval_params, eval_lora = self.params, self.global_lora
            with self.recorder.span("round.eval", cat="trainer", round=rnd,
                                    batches=len(self.eval_batches)):
                ev_loss, ev_acc = self._evaluate(eval_params, eval_lora)
            if self.recorder.enabled:
                self.recorder.round_set(rnd, eval_loss=round(ev_loss, 6),
                                        eval_acc=round(ev_acc, 6))
                if self.fault_injector is not None:
                    # the quarantine held: no poisoned uplink reached the
                    # served adapter (after the eval, which synced already)
                    finite = torch.stack([
                        torch.isfinite(x).all() for x in
                        flatten_with_paths(eval_lora).values()]).all()
                    self.recorder.round_set(rnd, global_finite=int(finite))
            self.history.append(RoundRecord(
                round=rnd, client_losses=client_losses, eval_loss=ev_loss,
                eval_acc=ev_acc, divergence_scaled=div, lr=lr_now))
            fc = self.fed_cfg
            if fc.checkpoint_dir and (rnd + 1) % fc.checkpoint_every == 0:
                self.save_state(round_state_path(fc.checkpoint_dir))
            self._start_round = rnd + 1
        self._resolve_divergences()
        return self.history

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Snapshot the round boundary to ``path``: params, the global
        adapter, every client's base and adapter (keep_local, hetero), the
        clock, the ledger, the loaders, the history, the step counter, the
        ring (its open rounds through the host) and FedBuff's version,
        in-flight launches and launch snapshots. Resolves the deferred
        divergences first, as a round boundary does."""
        self._resolve_divergences()
        tree: Dict[str, Any] = {"params": self.params,
                                "global": self.global_lora}
        if self.client_params is not None:
            tree["cparams"] = {str(i): p
                               for i, p in enumerate(self.client_params)}
            tree["clora"] = {str(i): x
                             for i, x in enumerate(self._client_lora)}
        meta: Dict[str, Any] = {
            "next_round": len(self.history),
            "global_step": self._global_step,
            # the reference's key: the last round's divergence (not restored:
            # each close computes its own)
            "last_div": (float(self.history[-1].divergence_scaled)
                         if self.history else 0.0),
            "clock": self.coordinator.clock.state_dict(),
            "ledger": self.ledger.state_dict(),
            "loaders": [ld.state_dict() for ld in self.client_loaders],
            "history": [asdict(r) for r in self.history],
        }
        if self.engine is not None:
            meta["ring"], ring_arrays = self.engine.buffers.state_dict()
            if ring_arrays:
                tree["ringarr"] = ring_arrays
        co = self.coordinator
        if isinstance(co, AsyncBufferCoordinator):
            meta["async"] = {
                "version": co._version,
                "inflight": [[c.client_id, t, v] for t, c, v in co._inflight],
                "snapshot_versions": sorted(co._snapshots)}
            tree["snap"] = {str(v): x for v, x in co._snapshots.items()}
        save_checkpoint(path, tree, meta)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` snapshot into a freshly built trainer
        of the same configs (its engine, ring and coordinator already built)
        onto its device; :meth:`run` then continues at the saved boundary.
        ``outcomes`` restarts empty."""
        tree, meta = load_checkpoint(path, self.device)
        self.params, self.global_lora = tree["params"], tree["global"]
        if "cparams" in tree:
            n = len(tree["cparams"])
            self.client_params = [tree["cparams"][str(i)] for i in range(n)]
            self._client_lora = [tree["clora"][str(i)] for i in range(n)]
        self._start_round = int(meta["next_round"])
        self._global_step = int(meta["global_step"])
        self.coordinator.clock.load_state(meta["clock"])
        self.ledger.load_state(meta["ledger"])
        for ld, st in zip(self.client_loaders, meta["loaders"]):
            ld.load_state(st)
        self.history = [RoundRecord(**r) for r in meta["history"]]
        self.outcomes = []
        if self.engine is not None:
            self.engine.buffers.load_state(
                meta["ring"], flatten_with_paths(tree.get("ringarr", {})))
        if "async" in meta:
            co, st = self.coordinator, meta["async"]
            co._version = int(st["version"])
            co._inflight = [(float(t), co.registry.get(int(cid)), int(v))
                            for cid, t, v in st["inflight"]]
            co._snapshots = {int(v): tree["snap"][str(v)]
                             for v in st["snapshot_versions"]}
