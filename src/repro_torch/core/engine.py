"""The weighted round close over stacked client buffers (stacked mode, fedex).

Counterpart of ``repro/core/engine.py`` for the ``fedex`` method (average
assignment) in stacked mode:

* :class:`RoundBuffers` — preallocated ``(C_max, …)`` device stacks per
  adapter leaf in a ring of ``depth`` rotating sets: ``begin_round`` opens a
  fresh zero set (sets are never reused across rounds), ``write_flat`` copies
  one client's uplink into its lane, ``take`` pops the oldest open round for
  its close. At most ``depth`` rounds may be open.
* :class:`DeferredDivergence` — the §6 divergence leaves the close as a
  device scalar; the host sync happens only in :meth:`~DeferredDivergence.
  resolve`, which the trainer calls at the next round boundary.
* :func:`make_close_fn` / :class:`RoundCloseEngine` — the close. Uniform
  full-participation rounds compose the aggregation operators of
  :mod:`repro_torch.core.aggregation` exactly as the reference's
  ``_uniform_close`` does (its bitwise contract). Weighted and partial rounds
  go through the weight vector, zeros masking non-delivered lanes: on CUDA
  tensors through the ``factor_mean`` and ``fedex_fold`` kernels (the
  counterpart of ``_weighted_close_pallas``), on the CPU through the same
  close on the kernels' plain PyTorch versions (the counterpart of
  ``_weighted_close_jnp``).

JAX donates the W0 leaves and stacks to its close program; here the kernel
close writes the fold into W0's own storage instead, so a caller must treat
the ``params`` it passes to :meth:`RoundCloseEngine.close` as consumed.
The other engine methods (fedex_svd, reinit, keep_local, hetero) and the
chunked streaming mode are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.kernels import (factor_mean, factor_mean_plain, fedex_fold,
                                 fedex_fold_plain)
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

Params = Dict[str, Any]

BACKENDS = ("auto", "plain", "kernels")


class DeferredDivergence:
    """§6 divergence as a device scalar with the host sync deferred to
    :meth:`resolve` (or ``float()``), which caches the value."""

    __slots__ = ("_raw", "_value", "round_id")

    def __init__(self, raw: torch.Tensor, round_id=None):
        self._raw = raw
        self._value: Optional[float] = None
        self.round_id = round_id

    @property
    def resolved(self) -> bool:
        return self._value is not None

    def resolve(self) -> float:
        """Block on the device value (the only host sync) and cache it."""
        if self._value is None:
            self._value = float(self._raw)
            self._raw = None  # drop the device reference
        return self._value

    def __float__(self) -> float:
        return self.resolve()


# --------------------------------------------------------------------------
# factor specs: pair every lora {a, b} node with its W0 leaf in params
# --------------------------------------------------------------------------

class FactorSpec:
    """One adapted matrix: the lora factor node at ``key`` and the W0 leaf
    ``{key}/kernel`` it updates. Leading axes before the trailing (m, n) are
    stacked layers."""

    def __init__(self, key: str, w0_shape: Tuple[int, ...], w0_dtype,
                 a_shape: Tuple[int, ...], b_shape: Tuple[int, ...]):
        self.key = key
        self.w0_shape = w0_shape
        self.w0_dtype = w0_dtype
        self.a_shape = a_shape
        self.b_shape = b_shape


def build_factor_specs(params: Params, lora: Params) -> List[FactorSpec]:
    """Walk the adapter tree against params, one spec per {a, b} node."""
    specs: List[FactorSpec] = []

    def walk(prefix: List[str], p: Any, l: Any) -> None:
        if isinstance(l, dict) and set(l.keys()) >= {"a", "b"}:
            if not (isinstance(p, dict) and "kernel" in p):
                raise NotImplementedError(
                    f"{'/'.join(prefix)}: adapters on raw tensors (MoE "
                    "experts) are not ported")
            w0 = p["kernel"]
            specs.append(FactorSpec("/".join(prefix), tuple(w0.shape),
                                    w0.dtype, tuple(l["a"].shape),
                                    tuple(l["b"].shape)))
            return
        if isinstance(l, dict):
            for k in l:
                if isinstance(p, dict) and k in p:
                    walk(prefix + [k], p[k], l[k])

    walk([], params, lora)
    if not specs:
        raise ValueError("no adapter factors found — empty lora tree?")
    return specs


def _get_path(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _set_path(tree: Params, path: str, value: Any) -> Params:
    """Functional nested-dict update (copies only the spine)."""
    parts = path.split("/")
    out = dict(tree)
    node = out
    for p in parts[:-1]:
        node[p] = dict(node[p])
        node = node[p]
    node[parts[-1]] = value
    return out


def collect_w0_leaves(specs: Sequence[FactorSpec],
                      params: Params) -> Dict[str, torch.Tensor]:
    """key → the adapted W0 leaf (the ``kernel`` child of the module)."""
    return {s.key: _get_path(params, s.key)["kernel"] for s in specs}


def fold_back_w0(specs: Sequence[FactorSpec], params: Params,
                 new_w0: Dict[str, torch.Tensor]) -> Params:
    """Write the close's W0 leaves back into the params tree (spine copy).
    Inverse of :func:`collect_w0_leaves`."""
    new_params = params
    for s in specs:
        node = dict(_get_path(params, s.key), kernel=new_w0[s.key])
        new_params = _set_path(new_params, s.key, node)
    return new_params


# --------------------------------------------------------------------------
# streaming round buffers (depth-2 ring)
# --------------------------------------------------------------------------

class RoundBuffers:
    """Preallocated ``(C_max, …)`` f32 device stacks, one per adapter leaf,
    written lane by lane, in a ring of at most ``depth`` open rounds.

    * every ``begin_round`` allocates a fresh zero set — a set is never
      reused, so an in-flight close never sees the next round's writes;
    * opening more than ``depth`` rounds raises (never a silent overwrite);
    * a lane is written at most once per round (a duplicate is dropped);
      lanes nobody wrote stay zero, and the weight vector masks them.
    """

    def __init__(self, lora_template: Params, c_max: int, depth: int = 2,
                 device: Optional[torch.device] = None):
        if c_max < 1:
            raise ValueError("c_max must be ≥ 1")
        if depth < 1:
            raise ValueError("depth must be ≥ 1")
        self.c_max = c_max
        self.depth = depth
        flat = flatten_with_paths(lora_template)
        self._shapes = {p: tuple(x.shape) for p, x in flat.items()}
        self.device = (next(iter(flat.values())).device if device is None
                       else device)
        # round_id → {"slots": cid→lane, "written": cid→lane, "stacks": dict}
        self._open: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._auto = 0

    def _alloc(self) -> Dict[str, torch.Tensor]:
        return {p: torch.zeros((self.c_max,) + s, dtype=torch.float32,
                               device=self.device)
                for p, s in self._shapes.items()}

    def _entry(self, round_id=None) -> Tuple[Any, Dict[str, Any]]:
        if not self._open:
            raise RuntimeError("no open round — begin_round() first")
        if round_id is None:
            rid = next(iter(self._open))
            return rid, self._open[rid]
        if round_id not in self._open:
            raise KeyError(f"round {round_id!r} is not open "
                           f"(open: {list(self._open)})")
        return round_id, self._open[round_id]

    def begin_round(self, slots: Dict[int, int], round_id=None):
        """Open a round: ``slots`` maps client_id → lane over the round's
        candidates. Returns the round id (auto-assigned when omitted)."""
        if len(slots) > self.c_max:
            raise ValueError(f"{len(slots)} candidates > C_max={self.c_max}")
        if any(not 0 <= s < self.c_max for s in slots.values()):
            raise ValueError(f"slot out of range in {slots}")
        if round_id is None:
            round_id = f"_auto{self._auto}"
            self._auto += 1
        if round_id in self._open:
            raise ValueError(f"round {round_id!r} is already open")
        if len(self._open) >= self.depth:
            raise RuntimeError(
                f"all {self.depth} buffer sets are in flight (open rounds: "
                f"{list(self._open)}) — take() the oldest before opening "
                "another")
        self._open[round_id] = {"slots": dict(slots), "written": {},
                                "stacks": self._alloc()}
        return round_id

    def evict(self, round_id) -> Dict[int, int]:
        """Drop an open round without closing it; returns its delivered
        {client_id: lane} map."""
        rid, e = self._entry(round_id)
        del self._open[rid]
        return dict(e["written"])

    def write_flat(self, client_id: int, flat: Dict[str, torch.Tensor],
                   round_id=None) -> bool:
        """Copy one client's adapter leaves (path → tensor) into its lane of
        the named (default: oldest) open round. Returns ``False`` (and writes
        nothing) for a duplicate (client, round) write."""
        _, e = self._entry(round_id)
        if client_id in e["written"]:
            return False
        if flat.keys() != self._shapes.keys():
            raise ValueError(
                f"uplink tree mismatch (missing="
                f"{sorted(set(self._shapes) - set(flat))}, extra="
                f"{sorted(set(flat) - set(self._shapes))})")
        for p, shape in self._shapes.items():
            if tuple(flat[p].shape) != shape:
                raise ValueError(f"{p}: shape {tuple(flat[p].shape)} != "
                                 f"template {shape}")
        slot = e["slots"][client_id]
        with torch.no_grad():
            for p in self._shapes:
                e["stacks"][p][slot].copy_(flat[p])
        e["written"][client_id] = slot
        return True

    def write(self, client_id: int, lora_tree: Params, round_id=None) -> bool:
        return self.write_flat(client_id, flatten_with_paths(lora_tree),
                               round_id)

    @property
    def open_rounds(self) -> List[Any]:
        return list(self._open)

    def delivered_in(self, round_id=None) -> Dict[int, int]:
        return dict(self._entry(round_id)[1]["written"])

    def lanes(self, round_id=None) -> Dict[int, int]:
        """client_id → lane for all of a round's candidates."""
        return dict(self._entry(round_id)[1]["slots"])

    def slot_of(self, client_id: int, round_id=None) -> int:
        return self._entry(round_id)[1]["slots"][client_id]

    def take(self, round_id=None) -> Dict[str, torch.Tensor]:
        """Pop the oldest (or named) open round and hand over its stacks."""
        rid, e = self._entry(round_id)
        del self._open[rid]
        return e["stacks"]


# --------------------------------------------------------------------------
# the close
# --------------------------------------------------------------------------

def _stacked_residual_factors(a_stack: torch.Tensor, b_stack: torch.Tensor,
                              u: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_c u_c·a_c b_c − ā b̄ = L @ R with L = [u_0·a_0 | … ] (…, m, C·r) and
    R = [b_0 − b̄ ; …] (…, C·r, n), b̄ = Σ_c u_c·b_c."""
    a, b = a_stack.float(), b_stack.float()
    c = a.shape[0]
    bbar = torch.einsum("c,c...rn->...rn", u, b)
    L = torch.cat([u[i] * a[i] for i in range(c)], dim=-1)
    R = torch.cat([b[i] - bbar for i in range(c)], dim=-2)
    return L, R


def _dev_fro_scaled(a_stack: torch.Tensor, b_stack: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Scaled Frobenius norm of Σu_c·a_c b_c − ā b̄ via the factored Grams —
    never materialises the (…, m, n) deviation. Returns (…,)."""
    L, R = _stacked_residual_factors(a_stack, b_stack, u)
    gl = torch.einsum("...mi,...mj->...ij", L, L)
    gr = torch.einsum("...in,...jn->...ij", R, R)
    fro_sq = torch.clamp(torch.einsum("...ij,...ij->...", gl, gr), min=0.0)
    m, n = a_stack.shape[-2], b_stack.shape[-1]
    return torch.sqrt(fro_sq) / math.sqrt(m * n)


def _slice_client_trees(specs, stacks, c_max) -> List[Params]:
    return [{s.key: {"a": stacks[s.key + "/a"][c],
                     "b": stacks[s.key + "/b"][c]} for s in specs}
            for c in range(c_max)]


def _uniform_close(specs, scale, w0_leaves, stacks, c_max):
    """Full-participation uniform close: literally the aggregation operators
    over the stack lanes."""
    client_trees = _slice_client_trees(specs, stacks, c_max)
    g = agg.fedit_aggregate(client_trees)
    res = agg.fedex_residual(client_trees, g)
    new_w0 = {s.key: (w0_leaves[s.key].float() + scale * res[s.key]
                      ).to(s.w0_dtype) for s in specs}
    glob = {s.key: g[s.key] for s in specs}
    return new_w0, glob


def _weighted_close(specs, scale, w0_leaves, stacks, w, *, kernels: bool):
    """Weighted/masked close: two factor means and one fold per adapted
    leaf; zero-weight lanes vanish from every sum. With ``kernels`` the
    wrappers run (the CUDA kernels on CUDA tensors) and the fold is written
    into W0's own storage; otherwise the kernels' plain PyTorch versions."""
    new_w0, glob = {}, {}
    for s in specs:
        a = stacks[s.key + "/a"]  # (C, L, m, r), read in place
        b = stacks[s.key + "/b"]
        w0 = w0_leaves[s.key]
        if not kernels:
            glob[s.key] = {"a": factor_mean_plain(a, w),
                           "b": factor_mean_plain(b, w)}
            new_w0[s.key] = fedex_fold_plain(w0, a, b, scale, w
                                             ).to(s.w0_dtype)
            continue
        glob[s.key] = {"a": factor_mean(a, w), "b": factor_mean(b, w)}
        if w0.dtype == torch.float32 and w0.is_contiguous():
            new_w0[s.key] = fedex_fold(w0, a, b, scale, weights=w, out=w0)
        else:
            new_w0[s.key] = fedex_fold(w0.float().contiguous(), a, b, scale,
                                       weights=w).to(s.w0_dtype)
    return new_w0, glob


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown engine backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    if backend == "auto":
        return "kernels" if device.type == "cuda" else "plain"
    return backend


def make_close_fn(specs: Sequence[FactorSpec], *, scale: float, c_max: int,
                  method: str = "fedex", backend: str = "plain"):
    """The close for one engine method: ``close(w0_leaves, stacks, weights,
    mask, *, uniform) → (new_w0_leaves, global_factors, divergence)``.

    ``uniform=True`` is the full-participation branch composed of the
    aggregation operators; otherwise ``weights`` is the (C_max,) f32 device
    vector with zeros on non-delivered lanes and ``mask`` its 0/1 indicator
    (the divergence is uniform over the delivered lanes). ``backend`` is
    ``"kernels"`` (factor_mean + fedex_fold) or ``"plain"``.
    """
    if method != "fedex":
        raise NotImplementedError(
            f"engine method {method!r} is not ported (fedex only)")
    if backend not in ("plain", "kernels"):
        raise ValueError(f"backend must be 'plain' or 'kernels', got "
                         f"{backend!r}")
    specs = list(specs)

    @torch.no_grad()
    def close(w0_leaves, stacks, weights, mask, *, uniform: bool):
        if uniform:
            new_w0, glob = _uniform_close(specs, scale, w0_leaves, stacks,
                                          c_max)
            u = torch.full((c_max,), 1.0 / c_max, dtype=torch.float32,
                           device=weights.device)
        else:
            new_w0, glob = _weighted_close(specs, scale, w0_leaves, stacks,
                                           weights,
                                           kernels=backend == "kernels")
            u = mask / torch.clamp(mask.sum(), min=1.0)
        parts = [_dev_fro_scaled(stacks[s.key + "/a"], stacks[s.key + "/b"],
                                 u).reshape(-1) for s in specs]
        div = torch.cat(parts).mean()
        return new_w0, glob, div

    return close


class RoundCloseEngine:
    """Owns the streaming buffers and the close for a trainer.

    ``backend``: ``"auto"`` (the kernels for CUDA tensors, their plain
    versions on the CPU), ``"plain"``, or ``"kernels"`` (the kernel close on
    any device: on CPU tensors the wrappers run the plain versions, which
    lets the CPU tests drive the kernel close's plumbing).

    ``buffers`` is the coordinator's delivery sink; :meth:`close` closes the
    oldest open round over whatever subset arrived, with any weighting. The
    C_max padding contract: stacks are always ``(C_max, …)``, a round's
    candidates get lanes in client-id order, and zero weights mask the rest.
    """

    def __init__(self, params: Params, lora_template: Params, *,
                 c_max: int, scale: float, method: str = "fedex",
                 backend: str = "auto", depth: int = 2):
        self.specs = build_factor_specs(params, lora_template)
        self.c_max = c_max
        self.scale = scale
        self.method = method
        device = _get_path(params, self.specs[0].key)["kernel"].device
        self.device = device
        self.backend = _resolve_backend(backend, device)
        self.buffers = RoundBuffers(lora_template, c_max, depth=depth,
                                    device=device)
        self._close = make_close_fn(self.specs, scale=scale, c_max=c_max,
                                    method=method, backend=self.backend)

    def weight_vector(self, client_ids: Sequence[int],
                      weights: Optional[Sequence[float]],
                      round_id=None) -> Tuple[np.ndarray, np.ndarray, bool]:
        """(C_max,) weights + mask from the delivered ids; uniform? flag."""
        slots = [self.buffers.slot_of(cid, round_id) for cid in client_ids]
        mask = np.zeros(self.c_max, np.float32)
        mask[slots] = 1.0
        norm = agg.normalize_weights(weights, len(client_ids))
        uniform = norm is None and len(client_ids) == self.c_max
        w = np.zeros(self.c_max, np.float32)
        if norm is None:
            w[slots] = 1.0 / len(client_ids)
        else:
            for s, wi in zip(slots, norm):
                w[s] = wi
        return w, mask, uniform

    def close(self, params: Params, client_ids: Sequence[int],
              weights: Optional[Sequence[float]] = None, *, round_id=None
              ) -> Tuple[Params, Params, DeferredDivergence]:
        """Close the round over the delivered subset. Returns
        ``(global_lora, new_params, divergence)``. ``params`` is consumed:
        on the kernel path its W0 leaves are overwritten with the fold. No
        host sync happens here; the divergence is a device scalar."""
        if round_id is None and self.buffers.open_rounds:
            round_id = self.buffers.open_rounds[0]  # oldest — same as take()
        if not client_ids:
            raise ValueError("cannot close a round with no deliveries")
        written = self.buffers.delivered_in(round_id)
        missing = [c for c in client_ids if c not in written]
        if missing:
            raise ValueError(f"clients {missing} were never written to the "
                             "round buffers")
        w, mask, uniform = self.weight_vector(client_ids, weights, round_id)
        w0_leaves = collect_w0_leaves(self.specs, params)
        stacks = self.buffers.take(round_id)
        new_w0, glob, div = self._close(
            w0_leaves, stacks, torch.from_numpy(w).to(self.device),
            torch.from_numpy(mask).to(self.device), uniform=uniform)
        new_params = fold_back_w0(self.specs, params, new_w0)
        flat = {}
        for s in self.specs:
            flat[s.key + "/a"] = glob[s.key]["a"]
            flat[s.key + "/b"] = glob[s.key]["b"]
        return (unflatten_from_paths(flat), new_params,
                DeferredDivergence(div, round_id))
