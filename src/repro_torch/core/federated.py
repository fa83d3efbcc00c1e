"""Federated fine-tuning trainer (paper §4.2 pipeline, host-orchestrated).

Counterpart of ``repro/core/federated.py`` for the engine methods: k
clients, each taking ``local_steps`` AdamW steps on its LoRA factors only,
then the server's close through
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

``close_chunk > 0`` closes rounds of more than that many clients in the
engine's chunked streaming mode: uplinks fold into running accumulators
chunk by chunk as they arrive, weighted by their raw weights (example
counts under ``weighting="examples"``).

Rounds are orchestrated by :class:`~repro_torch.fedsrv.RoundCoordinator`
(sampling, arrival order, weighting), whose uplinks stream into the
engine's ring; hetero rounds run every client and write straight into the
ring, as the reference's engine branch does. keep_local and hetero keep one
base per client, each with its own copy of the adapted W0 leaves, because
the kernel closes fold in place.

The close returns its divergence as a device scalar, resolved at the next
round boundary, so the close runs on the device while the next round's
clients start. The trainer takes optional initial ``params`` /
``global_lora`` trees and per-client ``client_loras`` (the parity tests
hand it the reference's draws); without them it draws its own on its
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import (FedConfig, LoRAConfig, TrainConfig,
                                      validate_fed_lora)
from repro_torch.core.engine import (DeferredDivergence, RoundCloseEngine,
                                     collect_w0_leaves, fold_back_w0)
from repro_torch.core.hetero import pad_adapters
from repro_torch.core.lora import init_lora
from repro_torch.fedsrv import (ClientInfo, ClientRegistry, RoundCoordinator,
                                RoundPolicy, StragglerModel)
from repro_torch.fedsrv.coordinator import Delivery, RoundOutcome
from repro_torch.optim import (adamw_update, clip_by_global_norm, init_adamw,
                               lr_at)
from repro_torch.util.device import resolve_device
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths


def make_local_step(model, lora_scale: float,
                    train_cfg: TrainConfig) -> Callable:
    """One local step: LoRA-only gradients through autograd, global-norm
    clipping, AdamW. ``step(params, lora, opt_state, batch, lr) → (lora,
    opt_state, loss, gnorm)``; the frozen params get no gradient."""

    def step(params, lora, opt_state, batch, lr):
        flat = {p: x.detach().requires_grad_(True)
                for p, x in flatten_with_paths(lora).items()}
        loss, _ = model.loss(params, batch, lora=unflatten_from_paths(flat),
                             lora_scale=lora_scale)
        grads = torch.autograd.grad(loss, list(flat.values()))
        grads = unflatten_from_paths(dict(zip(flat, grads)))
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


@dataclass
class RoundRecord:
    round: int
    client_losses: List[float]
    eval_loss: float
    eval_acc: float
    # briefly a DeferredDivergence; the float after the next round boundary
    divergence_scaled: Any
    lr: float


def _check_supported(fed: FedConfig) -> None:
    """Raise ``NotImplementedError`` for any federation feature the port has
    not taken up yet — none is ignored silently."""
    unsupported = {
        "method": fed.method in ("fedit", "ffa", "centralized"),
        "dp_clip": fed.dp_clip > 0,
        "round_deadline": fed.round_deadline > 0,
        "dropout_prob": fed.dropout_prob > 0,
        "async_buffer": fed.async_buffer > 0,
        "quantize_uplink": fed.quantize_uplink != "none",
        "obs": fed.obs != "off",
        "faults": bool(fed.faults),
        "uplink_max_norm": fed.uplink_max_norm > 0,
        "checkpoint_dir": bool(fed.checkpoint_dir),
    }
    asked = [k for k, v in unsupported.items() if v]
    if asked:
        raise NotImplementedError(
            f"FedConfig asks for {asked}, which the port does not run yet "
            "(the engine methods fedex with any assignment, fedex_svd and "
            "hetero, stacked or chunked, with participation sampling, "
            "min_quorum and example weighting only)")


def engine_method(fed: FedConfig) -> str:
    """The engine close a config runs (the reference's selection)."""
    if fed.client_ranks or fed.method == "hetero":
        return "hetero"
    if fed.method == "fedex_svd" and fed.svd_rank:
        return "fedex_svd"
    if fed.method == "fedex":
        return {"average": "fedex", "keep_local": "keep_local",
                "reinit": "reinit"}[fed.assignment]
    return "fedex"  # fedex_svd with svd_rank = 0 means exact


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

    def __post_init__(self):
        _check_supported(self.fed_cfg)
        validate_fed_lora(self.fed_cfg, self.lora_cfg)
        self.device = resolve_device(self.device)
        if (self.params is None) != (self.global_lora is None):
            raise ValueError("pass both params and global_lora, or neither")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        if self.params is None:
            self.params = self.model.init(gen, self.device)
            self.global_lora = init_lora(gen, self.params, self.model.cfg,
                                         self.lora_cfg)
        if not self.global_lora:
            raise ValueError("no LoRA targets matched — check target_modules")
        self.scale = self.lora_cfg.scale
        self.method = self.fed_cfg.method
        self.local_step = make_local_step(self.model, self.scale,
                                          self.train_cfg)
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
        self.hetero = method == "hetero"
        self.client_ranks = None
        if self.hetero:  # no explicit ranks: every client at lora.rank
            self.client_ranks = (list(fc.client_ranks)
                                 or [self.lora_cfg.rank] * k)
        clients = [
            ClientInfo(client_id=i, num_examples=len(
                self.client_loaders[i % len(self.client_loaders)].sequences))
            for i in range(k)]
        self.engine = RoundCloseEngine(
            self.params, self.global_lora, c_max=k, scale=self.scale,
            method=method, svd_rank=fc.svd_rank if method == "fedex_svd" else 0,
            backend=fc.engine, depth=fc.ring_depth,
            client_ranks=self.client_ranks, chunk=fc.close_chunk)
        # keep_local and hetero: one base per client, each with its OWN
        # adapted W0 leaves — the kernel closes fold into them in place, so
        # no two clients (and not self.params) may share one
        self.client_params: Optional[List[Dict]] = None
        self._client_lora: Optional[List[Dict]] = None
        if method in ("keep_local", "hetero"):
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
        self.coordinator = RoundCoordinator(
            ClientRegistry(clients, seed=fc.seed),
            RoundPolicy(participation=fc.participation,
                        min_quorum=fc.min_quorum, weighting=fc.weighting),
            StragglerModel(mean_latency=fc.mean_latency,
                           jitter=fc.latency_jitter,
                           straggler_prob=fc.straggler_prob,
                           straggler_factor=fc.straggler_factor, seed=fc.seed),
            sink=self.engine.buffers, validate=fc.uplink_validation)

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
        """Mean (loss, accuracy) over the eval batches (NaNs when empty)."""
        if not self.eval_batches:
            return float("nan"), float("nan")
        ls, accs = [], []
        for b in self.eval_batches:
            l, a = self.eval_fn(params, lora, b)
            ls.append(float(l))
            accs.append(float(a))
        return sum(ls) / len(ls), sum(accs) / len(accs)

    def _resolve_divergences(self) -> None:
        for rec in self.history:
            if isinstance(rec.divergence_scaled, DeferredDivergence):
                rec.divergence_scaled = rec.divergence_scaled.resolve()

    def _record_outcome(self, outcome) -> None:
        """Keep the round's outcome; adapter payloads only of the last."""
        self.outcomes.append(outcome)
        if len(self.outcomes) > 1:
            for d in self.outcomes[-2].delivered:
                d.lora = None

    # ------------------------------------------------------------------
    def _close_round(self, rnd: int, outcome) -> Any:
        """The engine close of a coordinated round; returns its divergence."""
        eng, rid = self.engine, outcome.round_id
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
        return div

    def _hetero_round(self, rnd: int):
        """Every client trains at its rank rᵢ; its uplink is zero-padded to
        r_max and written straight into the ring with its true rank; the
        close folds each client's residual into its own base."""
        k = self.fed_cfg.num_clients
        rid = self.engine.buffers.begin_round({c: c for c in range(k)}, rnd)
        client_losses, delivered = [], []
        for c in range(k):
            lora_c, losses = self._client_round(c, self.client_params[c],
                                                self._client_lora[c])
            client_losses.append(losses[-1])
            padded = pad_adapters(lora_c, self.lora_cfg.rank)
            self.engine.buffers.write(c, padded, round_id=rid,
                                      rank=self.client_ranks[c])
            delivered.append(Delivery(client=self.coordinator.registry.get(c),
                                      lora=padded, launched_at=0.0,
                                      arrived_at=0.0))
        self._record_outcome(RoundOutcome(
            round_id=rid, sampled=list(range(k)), delivered=delivered,
            weights=None, opened_at=0.0, closed_at=0.0))
        # round boundary: the previous round's divergence resolves only now
        self._resolve_divergences()
        new_cp, new_loras, self.global_lora, div = self.engine.close_hetero(
            self.client_params, list(range(k)), round_id=rid)
        for c in range(k):
            self.client_params[c] = new_cp[c]
            self._client_lora[c] = new_loras[c]
        return client_losses, div

    def run(self, until: Optional[int] = None) -> List[RoundRecord]:
        """Run rounds ``[_start_round, until)`` (default: all configured)."""
        stop = self.fed_cfg.rounds if until is None else until
        keep_local = self.engine.method == "keep_local"
        for rnd in range(self._start_round, stop):
            lr_now = lr_at(self._global_step,
                           base_lr=self.train_cfg.learning_rate,
                           total_steps=self._total_steps,
                           kind=self.train_cfg.schedule,
                           warmup_ratio=self.train_cfg.warmup_ratio)
            if self.hetero:
                client_losses, div = self._hetero_round(rnd)
            else:
                round_losses: Dict[int, float] = {}

                def train_fn(client, start_lora, round_id,
                             _losses=round_losses):
                    c = client.client_id
                    base = (self.client_params[c] if keep_local
                            else self.params)
                    start = self._client_lora[c] if keep_local else start_lora
                    lora_c, losses = self._client_round(c, base, start)
                    _losses[c] = losses[-1]
                    return lora_c

                outcome = self.coordinator.run_round(rnd, train_fn,
                                                     self.global_lora)
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
                    div = self._close_round(rnd, outcome)
            self._global_step += self.fed_cfg.local_steps
            if self.client_params is not None:
                ev_loss, ev_acc = self._evaluate(self.client_params[0],
                                                 self._client_lora[0])
            else:
                ev_loss, ev_acc = self._evaluate(self.params,
                                                 self.global_lora)
            self.history.append(RoundRecord(
                round=rnd, client_losses=client_losses, eval_loss=ev_loss,
                eval_acc=ev_acc, divergence_scaled=div, lr=lr_now))
            self._start_round = rnd + 1
        self._resolve_divergences()
        return self.history
