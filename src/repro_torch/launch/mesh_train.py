"""Mesh mode: co-scheduled client lanes on one device, closed by the
engine's weighted close.

Counterpart of ``repro/launch/mesh_train.py``. The host trainer
(:mod:`repro_torch.core.federated`) runs its clients one after another; here
every client is a *lane* of one stacked program, and lane c is client c:

* **local training** — :func:`make_mesh_round_fn`. The reference vmaps one
  lane's scan of clipped AdamW steps over a ``(C_max, …)`` client axis; the
  port folds the lanes into the batch instead. The adapters stay in the
  engine's layout (``(C, L, m, r)`` and ``(C, L, r, n)``), one forward and
  backward runs over the tokens ``(C·B, S)`` with lane c owning rows
  ``[c·B, (c+1)·B)``, every adapted projection applies lane c's factors to
  lane c's rows (:func:`repro_torch.models.common.dense`; a MoE layer's
  per-expert factors lane by lane in each expert's group, its router aux
  loss each lane's own), and the loss is the sum of the lanes' mean
  losses. Every batch key is folded alike (an encdec config's frames).
  Lanes share no trainable tensor, so
  the one backward gives every lane exactly its own gradient; the clip is
  by each lane's own norm (:func:`repro_torch.optim.clip_by_lane_norm`) and
  AdamW runs on the stacks as they are.
* **the round close** — :class:`MeshRoundCloser`: the engine's weighted
  close (:func:`repro_torch.core.engine.make_close_fn`) over the lane
  stacks, on CUDA through the kernels (``factor_mean`` and ``fedex_fold``,
  or ``product_fold`` under fedex_svd), on the CPU through their plain
  versions. A round's sampled subset and its weights enter only through the
  ``(C_max,)`` weight vector; zero weight masks a lane, whatever it holds.
  Lanes not sampled still train (their compute is the padding cost).

Every round takes the weighted branch: a uniform round is the uniform
weight vector. The divergence leaves the close as a
:class:`~repro_torch.core.engine.DeferredDivergence`, resolved at the next
round boundary after the next round's training was dispatched.

The reference's mesh placement (``launch/mesh.py``, ``sharding/``) lays the
client axis over TPU devices; on one card there is one device, so placing a
stack means putting it on the trainer's device. The reference counts its
compiled close programs (``compiled_programs``, ``engine.compile_*``); the
port compiles none, and has no such count.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (FedConfig, LoRAConfig, TrainConfig,
                                      validate_fed_lora)
from repro_torch.core import aggregation as agg
from repro_torch.core.engine import (DeferredDivergence, _resolve_backend,
                                     build_factor_specs, collect_w0_leaves,
                                     fold_back_w0, make_close_fn)
from repro_torch.core.federated import (RoundRecord, evaluate_on_batches,
                                        make_eval_fn, resolve_divergences)
from repro_torch.core.lora import init_global_state
from repro_torch.fedsrv.faults import MESH_KINDS, FaultInjector, FaultPlan
from repro_torch.obs import NULL, make_recorder
from repro_torch.optim import (AdamWState, adamw_update, clip_by_lane_norm,
                               init_adamw, lr_at)
from repro_torch.util.device import resolve_device
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

Params = Dict[str, Any]

MESH_METHODS = ("fedex", "fedex_svd")


# --------------------------------------------------------------------------
# the stacked local-training round
# --------------------------------------------------------------------------

def _select(live: torch.Tensor, new: Params, old: Params) -> Params:
    """Lane c of the tree ``new`` where ``live[c]``, else of ``old``."""
    old = flatten_with_paths(old)
    return unflatten_from_paths({
        p: torch.where(live.reshape((-1,) + (1,) * (x.ndim - 1)), x, old[p])
        for p, x in flatten_with_paths(new).items()})


def make_mesh_round_fn(model, lora_scale: float, train_cfg: TrainConfig,
                       masked: bool = False) -> Callable:
    """One round of local training for every lane at once.

    ``round_fn(params, lora_stack, batches, lrs)`` takes the lane-stacked
    adapter tree (leaves ``(C, …)``), batch leaves ``(C, steps, B, …)`` and
    the ``steps`` learning rates every lane shares; each step is one
    forward and backward over all lanes, a clip by each lane's own norm and
    AdamW from a fresh state (the host trainer's
    :func:`~repro_torch.core.federated.make_local_step`, lane by lane).
    Returns ``(new_lora_stack, losses (C, steps))``.

    ``masked=True``: ``round_fn(params, lora_stack, batches, lrs, budgets)``
    freezes lane c's adapters and optimizer state once ``t ≥ budgets[c]``,
    by selection; a frozen lane's loss repeats its last live loss. The
    unmasked round makes no selection at all.
    """

    def round_fn(params, lora_stack, batches, lrs, budgets=None):
        if masked == (budgets is None):
            raise ValueError("budgets go with masked=True, and only with it")
        lora = unflatten_from_paths({p: x.detach() for p, x in
                                     flatten_with_paths(lora_stack).items()})
        opt = init_adamw(lora)
        last, losses = None, []
        for t, lr in enumerate(lrs):
            batch = {k: v[:, t].reshape(-1, *v.shape[3:])
                     for k, v in batches.items()}
            leaves = {p: x.detach().requires_grad_(True)
                      for p, x in flatten_with_paths(lora).items()}
            lane_losses = model.lane_loss(
                params, batch, lora=unflatten_from_paths(leaves),
                lora_scale=lora_scale)
            grads = torch.autograd.grad(lane_losses.sum(),
                                        list(leaves.values()))
            grads, _ = clip_by_lane_norm(
                unflatten_from_paths(dict(zip(leaves, grads))),
                train_cfg.grad_clip)
            new, new_opt = adamw_update(
                grads, opt, lora, learning_rate=lr, beta1=train_cfg.beta1,
                beta2=train_cfg.beta2, eps=train_cfg.eps,
                weight_decay=train_cfg.weight_decay)
            loss = lane_losses.detach()
            if masked:
                live = t < torch.as_tensor(budgets, device=loss.device)
                new = _select(live, new, lora)
                new_opt = AdamWState(step=new_opt.step,
                                     mu=_select(live, new_opt.mu, opt.mu),
                                     nu=_select(live, new_opt.nu, opt.nu))
                loss = torch.where(live, loss, 0.0 if last is None else last)
            lora, opt, last = new, new_opt, loss
            losses.append(loss)
        stack = unflatten_from_paths({p: x.contiguous() for p, x in
                                      flatten_with_paths(lora).items()})
        return stack, torch.stack(losses, dim=1)

    return round_fn


# --------------------------------------------------------------------------
# the mesh close: the engine's weighted close over the lane stacks
# --------------------------------------------------------------------------

class MeshRoundCloser:
    """The round close of mesh mode: lane c is client c, and a round's
    participation lives entirely in the ``(C_max,)`` weight vector, so
    full, sampled and weighted rounds run the same close, the same kernel
    launches every round. ``backend`` is the engine's (``"auto"``: the
    kernels on CUDA, their plain versions on the CPU). The close returns
    the divergence as a :class:`DeferredDivergence`, with no host sync.
    ``params`` passed to :meth:`close` is consumed, as the engine's: the
    kernel close folds into its W0 leaves in place."""

    def __init__(self, params: Params, lora_template: Params, *,
                 c_max: int, scale: float, method: str = "fedex",
                 svd_rank: int = 0, backend: str = "auto", recorder=None):
        if method not in MESH_METHODS:
            raise ValueError(
                f"mesh mode closes {MESH_METHODS} rounds, got {method!r} "
                "(the §6 assignment strategies are host-orchestrated — "
                "see core/federated.py)")
        self.c_max = c_max
        self.method = method
        self.rec = recorder if recorder is not None else NULL
        self.specs = build_factor_specs(params, lora_template)
        self.device = collect_w0_leaves(self.specs, params)[
            self.specs[0].key].device
        self.backend = _resolve_backend(backend, self.device)
        self._close = make_close_fn(self.specs, scale=scale, c_max=c_max,
                                    method=method, svd_rank=svd_rank,
                                    backend=self.backend)

    def shard_stacks(self, stacks: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The ``(C_max, …)`` stacks placed for the close: on one card,
        on its device (the reference's client-axis sharding)."""
        return {p: x.to(self.device) for p, x in stacks.items()}

    def weight_vector(self, client_ids: Sequence[int],
                      weights: Optional[Sequence[float]] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(C_max,) weight vector and 0/1 mask of the sampled subset,
        uniform over it when ``weights`` is None; ``weights[i]`` belongs to
        ``client_ids[i]`` in the caller's order."""
        if not client_ids:
            raise ValueError("cannot close a round with no participants")
        ids = sorted(client_ids)
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate client ids in {list(client_ids)}")
        if ids[0] < 0 or ids[-1] >= self.c_max:
            raise ValueError(f"client ids {ids} outside [0, {self.c_max})")
        mask = np.zeros(self.c_max, np.float32)
        mask[ids] = 1.0
        w = np.zeros(self.c_max, np.float32)
        norm = agg.normalize_weights(weights, len(ids))
        if norm is None:
            w[ids] = 1.0 / len(ids)
        else:
            for cid, wi in zip(client_ids, norm):
                w[cid] = wi
        return w, mask

    def close(self, params: Params, stacks: Dict[str, torch.Tensor],
              client_ids: Sequence[int],
              weights: Optional[Sequence[float]] = None, *, round_id=None
              ) -> Tuple[Params, Params, DeferredDivergence]:
        """Close a round over the sampled subset. ``stacks`` is the
        flattened lane-stacked adapter tree (path → ``(C_max, …)``).
        Returns ``(global_lora, new_params, divergence)``."""
        w, mask = self.weight_vector(client_ids, weights)
        w, mask = (torch.from_numpy(x).to(self.device) for x in (w, mask))
        w0_leaves = collect_w0_leaves(self.specs, params)
        rec = self.rec
        if rec.enabled:
            t0 = time.perf_counter_ns()
            with rec.span("close.dispatch", cat="engine", round=round_id,
                          method=self.method, mesh=True):
                new_w0, glob, div = self._close(w0_leaves, stacks, w, mask,
                                                uniform=False)
            dispatch_us = (time.perf_counter_ns() - t0) / 1e3
            rec.hist("engine.close_dispatch_us").observe(dispatch_us)
            if round_id is not None:
                rec.round_set(round_id, method=self.method,
                              close_dispatch_us=round(dispatch_us, 1))
        else:
            new_w0, glob, div = self._close(w0_leaves, stacks, w, mask,
                                            uniform=False)
        flat = {}
        for s in self.specs:
            flat[s.key + "/a"] = glob[s.key]["a"]
            flat[s.key + "/b"] = glob[s.key]["b"]
        return (unflatten_from_paths(flat),
                fold_back_w0(self.specs, params, new_w0),
                DeferredDivergence(div, round_id,
                                   recorder=rec if rec.enabled else None))


# --------------------------------------------------------------------------
# the mesh-mode federated loop
# --------------------------------------------------------------------------

RING_DEPTH, RETRIES, EVERY = (
    FedConfig.__dataclass_fields__[k].default
    for k in ("ring_depth", "uplink_retries", "checkpoint_every"))


def check_mesh_supported(fed: FedConfig) -> None:
    """Raise ``ValueError`` for a setting mesh mode cannot honour (the
    reference warns and ignores them): the host-orchestrated methods, the
    coordinator's and the transport's settings, DP, client ranks, the
    engine's tuning, checkpoints, fault kinds outside
    :data:`~repro_torch.fedsrv.faults.MESH_KINDS` (co-scheduled lanes cross
    no wire), and a norm ceiling without a fault plan (the reference screens
    the lanes only under a plan). Every model family runs, as in the
    reference: a MoE config with each lane's own router aux loss, an encdec
    one on loaders whose batches carry frames (the trainer stacks every
    batch key), a vlm one as a text-only LM on tokens-only loaders."""
    if fed.method not in MESH_METHODS:
        raise ValueError(f"--mode mesh supports {MESH_METHODS}, "
                         f"got method={fed.method!r}")
    host_only = {
        "assignment": fed.assignment != "average",
        "straggler_prob": fed.straggler_prob > 0,
        "dropout_prob": fed.dropout_prob > 0,
        "round_deadline": fed.round_deadline > 0,
        "min_quorum": fed.min_quorum > 0,
        "async_buffer": fed.async_buffer > 0,
        "quantize_uplink": fed.quantize_uplink != "none",
        "dp_clip": fed.dp_clip > 0,
        "dp_noise_multiplier": fed.dp_noise_multiplier > 0,
        "client_ranks": bool(fed.client_ranks),
        "engine": fed.engine != "auto",
        "ring_depth": fed.ring_depth != RING_DEPTH,
        "close_chunk": fed.close_chunk > 0,
        "uplink_validation": not fed.uplink_validation,
        "uplink_retries": fed.uplink_retries != RETRIES,
        "checkpoint_dir": bool(fed.checkpoint_dir),
        "checkpoint_every": fed.checkpoint_every != EVERY,
        "uplink_max_norm": fed.uplink_max_norm > 0 and not fed.faults,
    }
    asked = [k for k, v in host_only.items() if v]
    if asked:
        raise ValueError(f"FedConfig sets {asked}, which mesh mode cannot "
                         "honour: its lanes are co-scheduled (no coordinator, "
                         "transport, DP or ring) and every round closes "
                         "through the engine's weighted close")
    if fed.faults:
        kinds = sorted({s.kind for s in FaultPlan.parse(fed.faults).specs
                        if s.kind not in MESH_KINDS})
        if kinds:
            raise ValueError(f"faults={fed.faults!r}: mesh mode applies the "
                             f"value faults {MESH_KINDS} only, and kind(s) "
                             f"{kinds} need a wire or a ring")


@dataclass
class MeshFederatedTrainer:
    """Mesh-mode rounds: each round samples a seeded subset, trains every
    lane from the global adapter in one stacked round
    (:func:`make_mesh_round_fn`), screens the sampled lanes under a fault
    plan (against the norm ceiling too, where one is set), and closes through :class:`MeshRoundCloser`.
    The records are the host trainer's :class:`RoundRecord`.

    ``params`` / ``global_lora`` default to the host trainer's draws at
    ``seed`` (one ``torch.Generator`` on the device); the parity tests hand
    it the reference's. ``quarantined`` lists each round's (client, reason)
    pairs."""

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
    recorder: Any = None

    def __post_init__(self):
        fc = self.fed_cfg
        check_mesh_supported(fc)
        validate_fed_lora(fc, self.lora_cfg)
        self.device = resolve_device(self.device)
        if self.recorder is None:
            self.recorder = make_recorder(fc.obs, self.device)
        if (self.params is None) != (self.global_lora is None):
            raise ValueError("pass both params and global_lora, or neither")
        if self.params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            self.params, self.global_lora = init_global_state(
                self.model, self.lora_cfg, device=self.device, generator=gen)
        if not self.global_lora:
            raise ValueError("no LoRA targets matched — check "
                             "target_modules")
        self.scale = self.lora_cfg.scale
        method = fc.method
        if method == "fedex_svd" and not fc.svd_rank:
            method = "fedex"  # svd_rank=0 means exact
        self.closer = MeshRoundCloser(
            self.params, self.global_lora, c_max=fc.num_clients,
            scale=self.scale, method=method,
            svd_rank=fc.svd_rank if method == "fedex_svd" else 0,
            recorder=self.recorder)
        self._budgets = (list(fc.client_local_steps)
                         if fc.client_local_steps else None)
        self.round_fn = make_mesh_round_fn(self.model, self.scale,
                                           self.train_cfg,
                                           masked=self._budgets is not None)
        self.eval_fn = make_eval_fn(self.model, self.scale)
        self.history: List[RoundRecord] = []
        self.quarantined: List[List[Tuple[int, str]]] = []
        self._total_steps = fc.rounds * fc.local_steps
        self._examples = [len(ld.sequences) for ld in self.client_loaders]
        self.fault_injector = (FaultInjector(FaultPlan.parse(
            fc.faults, seed=fc.seed), recorder=self.recorder)
            if fc.faults else None)

    # ------------------------------------------------------------------
    def _sample_round(self, rnd: int) -> Tuple[List[int],
                                               Optional[List[float]]]:
        """The reference's seeded subset and optional example weights."""
        fc = self.fed_cfg
        k = fc.num_clients
        n = max(1, int(round(fc.participation * k)))
        rng = np.random.default_rng((self.seed, rnd))
        ids = sorted(rng.choice(k, size=n, replace=False).tolist())
        weights = None
        if fc.weighting == "examples":
            weights = [float(self._examples[c % len(self._examples)])
                       for c in ids]
        return ids, weights

    def _stack_batches(self, steps: int) -> Dict[str, torch.Tensor]:
        """(C_max, steps, B, …) batch stacks, lane c fed by loader
        ``c % len(loaders)``."""
        per_lane = []
        for c in range(self.fed_cfg.num_clients):
            loader = self.client_loaders[c % len(self.client_loaders)]
            per_lane.append([loader.next_batch() for _ in range(steps)])
        return {k: torch.stack([torch.stack([b[k] for b in lane])
                                for lane in per_lane])
                for k in per_lane[0][0]}

    def _screen_lanes(self, rnd: int, stacks: Dict[str, torch.Tensor],
                      ids: List[int], weights: Optional[List[float]]):
        """Apply the round's value faults to the sampled lanes, then
        quarantine a lane with a non-finite entry or (``uplink_max_norm``)
        an ∞-norm above the ceiling, its reason the first failing leaf's.
        A quarantined lane is zeroed, not only masked: 0·NaN = NaN. One
        host sync reads the (C,) verdicts. Returns (stacks, survivors,
        their weights, quarantined pairs)."""
        fc, rec = self.fed_cfg, self.recorder
        if self.fault_injector is not None:
            for cid in ids:
                lane = {p: x[cid] for p, x in stacks.items()}
                hit, applied = self.fault_injector.corrupt_lane(rnd, cid, lane)
                if applied:
                    for p, x in stacks.items():
                        if hit[p] is not lane[p]:
                            x[cid] = hit[p]
        codes = []  # per leaf, (C,): 1 non-finite, 2 above the ceiling
        for x in stacks.values():
            flat = x.reshape(x.shape[0], -1)
            code = (~torch.isfinite(flat).all(1)).to(torch.int8)
            if fc.uplink_max_norm > 0:
                over = flat.abs().amax(1) > fc.uplink_max_norm
                code = torch.where(code == 0, 2 * over.to(torch.int8), code)
            codes.append(code)
        codes = torch.stack(codes).T.tolist()
        survivors: List[int] = []
        surv_w: List[float] = []
        quarantined: List[Tuple[int, str]] = []
        for j, cid in enumerate(ids):
            bad = next((("", "nonfinite", "norm")[v] for v in codes[cid]
                        if v), "")
            if bad:
                for x in stacks.values():
                    x[cid] = 0
                quarantined.append((cid, bad))
                if rec.enabled:
                    rec.counter(f"uplink.quarantined[{bad}]").inc()
                rec.event("uplink.quarantine", cat="fedsrv", round=rnd,
                          client=cid, reason=bad)
            else:
                survivors.append(cid)
                if weights is not None:
                    surv_w.append(weights[j])
        return (stacks, survivors,
                surv_w if weights is not None else None, quarantined)

    # ------------------------------------------------------------------
    def run(self) -> List[RoundRecord]:
        fc, rec = self.fed_cfg, self.recorder
        c = fc.num_clients
        screen = self.fault_injector is not None
        step0 = 0
        for rnd in range(fc.rounds):
            lrs = [lr_at(step0 + s, base_lr=self.train_cfg.learning_rate,
                         total_steps=self._total_steps,
                         warmup_ratio=self.train_cfg.warmup_ratio,
                         kind=self.train_cfg.schedule)
                   for s in range(fc.local_steps)]
            ids, weights = self._sample_round(rnd)
            n_sampled = len(ids)
            # downlink broadcast: every lane starts from the global adapter
            lora_stack = unflatten_from_paths({
                p: x.unsqueeze(0).repeat((c,) + (1,) * x.ndim)
                for p, x in flatten_with_paths(self.global_lora).items()})
            batches = self._stack_batches(fc.local_steps)
            with rec.span("mesh.train_round", cat="trainer", round=rnd,
                          lanes=c):
                args = (() if self._budgets is None else (self._budgets,))
                new_stack, losses = self.round_fn(self.params, lora_stack,
                                                  batches, lrs, *args)
            # round boundary: the previous close's divergence resolves only
            # after this round's training was dispatched
            resolve_divergences(self.history)
            stacks = flatten_with_paths(new_stack)
            quarantined: List[Tuple[int, str]] = []
            if screen:
                stacks, ids, weights, quarantined = self._screen_lanes(
                    rnd, stacks, ids, weights)
            self.quarantined.append(quarantined)
            if not ids:
                # every sampled lane quarantined: the global adapter and
                # the base carry forward
                div: Any = 0.0
                if rec.enabled:
                    rec.counter("round.degraded").inc()
                rec.event("round.degraded", cat="fedsrv", round=rnd,
                          delivered=0, quarantined=len(quarantined))
            else:
                with rec.span("round.close", cat="trainer", round=rnd,
                              mesh=True):
                    self.global_lora, self.params, div = self.closer.close(
                        self.params, self.closer.shard_stacks(stacks), ids,
                        weights, round_id=rnd)
            step0 += fc.local_steps
            with rec.span("round.eval", cat="trainer", round=rnd,
                          batches=len(self.eval_batches)):
                ev_loss, ev_acc = self._evaluate()
            if rec.enabled:
                rec.round_set(rnd, sampled=n_sampled, delivered=len(ids),
                              quarantined=len(quarantined),
                              degraded=int(not ids),
                              eval_loss=round(ev_loss, 6),
                              eval_acc=round(ev_acc, 6))
                if self.fault_injector is not None:
                    finite = all(bool(torch.isfinite(x).all()) for x in
                                 flatten_with_paths(self.global_lora).values())
                    rec.round_set(rnd, global_finite=int(finite))
            lane_losses = losses[:, -1].tolist()
            self.history.append(RoundRecord(
                round=rnd, client_losses=([lane_losses[i] for i in ids]
                                          or [float("nan")]),
                eval_loss=ev_loss, eval_acc=ev_acc, divergence_scaled=div,
                lr=lrs[0]))
        resolve_divergences(self.history)
        return self.history

    def _evaluate(self) -> Tuple[float, float]:
        return evaluate_on_batches(self.eval_fn, self.params,
                                   self.global_lora, self.eval_batches)
