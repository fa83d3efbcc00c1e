"""Loop-aware FLOP, byte and memory accounting of one eager step.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference parses the
compiled HLO; the port counts the ops as they run, in one
``TorchDispatchMode`` (:class:`CostMode`), on the meta device (the dry
run: shapes only, nothing allocated) or on the card, the same way:

* **FLOPs** of the matmul-like ops, by ``torch.utils.flop_counter``'s
  formulas (the reference counts dot and convolution only);
* **bytes**: operands plus outputs of every op that is not a view or a
  metadata op (the eager counterpart of the reference's per-instruction
  bytes and its ``_FREE_OPS``);
* **peak**: the largest sum of live storages, each storage from the op
  that makes it until it is freed, the step's arguments included.

A kernel wrapper reports its own work (:meth:`CostMode.kernel`): B3
(``lora_matmul``) by :func:`~repro_torch.util.cost.lora_matmul_work`, B8
(``flash_swa`` / ``swa_attention``) by
:func:`~repro_torch.util.cost.attention_work`; the ops inside it, its
plain version's on the CPU among them, add no FLOPs or bytes, only
storages. The wrappers and the model loops find the counter of their
thread in ``repro_torch.util.cost.LOCAL``, and import nothing of this
module.

**The loop-aware rule** (the reference's ``compute_multipliers``): a model
loop of identical iterations is written ``for i in Loop(n, device)``
(:class:`repro_torch.util.cost.Loop`). Under
a counter on the meta device it runs the first and last iterations and two
of the middle ones, A and B: A's ops, and the backward of the autograd
nodes it made, count for all the middle iterations but B; the storages A
leaves live past B (its outputs, the tensors autograd saved) count that
many times too, from then on and in the peak reached inside B; the carry
it hands to B, freed in B, counts once. ``Loop.stack`` gives the loop's
stacked outputs their full length. On any other device, or with
``count(..., shortcut=False)``, every iteration runs.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from repro_torch.util.cost import LOCAL

_aten = torch.ops.aten
# ops that move no data besides the views: aliases, allocations without a
# write, a scalar read back to the host, shape queries
_FREE_OPS = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
             _aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided,
             _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
             _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
             _aten.resolve_conj, _aten.resolve_neg}


@dataclass
class Costs:
    """One step's counts; bytes in bytes. ``collective_*`` stay empty on one
    card (the reference's keys)."""

    flops: int = 0
    bytes_accessed: int = 0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    output_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree, out: list) -> list:
    """The tensors of an op's arguments or result, or of a step's (nested
    lists, tuples, NamedTuples and dicts), appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storages(tree) -> Dict[int, torch.UntypedStorage]:
    return {s._cdata: s for s in (t.untyped_storage()
                                  for t in _tensors(tree, []))}


_OPS: Dict[Any, tuple] = {}


def _op(func) -> tuple:
    """(its FLOP formula or None, whether it moves no data, whether it is
    a composite op to decompose) for an op, cached."""
    kind = _OPS.get(func)
    if kind is None:
        formula = flop_registry.get(func.overloadpacket)
        composite = formula is None and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
        kind = _OPS[func] = (formula, func.is_view
                             or func.overloadpacket in _FREE_OPS, composite)
    return kind


_PROBE = []


def _sequence_nr() -> int:
    """The autograd sequence number the next node made on this thread
    takes (a throwaway view of a leaf, made outside every mode)."""
    with _disable_current_modes(), torch.inference_mode(False), \
            torch.enable_grad():
        if not _PROBE:
            _PROBE.append(torch.zeros((), requires_grad=True))
        return _PROBE[0].view(()).grad_fn._sequence_nr() + 1


class CostMode(TorchDispatchMode):
    """The counter. ``with CostMode() as mode: mode.arguments(args); out =
    fn(*args); mode.outputs(out)``, then ``mode.close()`` and
    ``mode.costs()``; :func:`count` does all of it. ``shortcut=False``
    runs every iteration of a :class:`~repro_torch.util.cost.Loop` on the
    meta device too."""

    def __init__(self, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.flops = 0
        self.bytes = 0
        self.weight = 1          # the multiplier of the forward ops now
        self.in_kernel = 0       # > 0 inside a kernel wrapper
        self.live: Dict[int, int] = {}    # storage → bytes it stands for
        self.total = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._finalizers: Dict[int, weakref.finalize] = {}
        self._watch: list = []   # storage sets of the iterations watched
        self._ranges: list = []  # (first, last sequence nr, weight)
        self._node_weight: Dict[int, int] = {}
        self._args: set = set()  # the arguments' storages
        self._born: Dict[int, int] = {}  # storage → its serial number
        self._serial = 0
        self._prev: list = []

    # ---- mode -----------------------------------------------------------
    def __enter__(self):
        self._prev.append(LOCAL.mode)
        LOCAL.mode = self
        return super().__enter__()

    def __exit__(self, *exc):
        LOCAL.mode = self._prev.pop()
        return super().__exit__(*exc)

    def close(self) -> None:
        """Stop following the storages still live."""
        for f in self._finalizers.values():
            f.detach()
        self._finalizers.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula, free, composite = _op(func)
        if composite:
            # inference mode sees matmul, not mm: count the ops it
            # decomposes into, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        if not self.in_kernel:
            w = self._weight()
            if formula is not None:
                self.flops += w * formula(*args, **kwargs, out_val=out)
            if not free:
                self.bytes += w * (_tensor_bytes(_tensors((args, kwargs), []))
                                   + _tensor_bytes(outs))
        self._track(outs)
        return out

    # ---- storages -------------------------------------------------------
    def _track(self, tensors) -> None:
        """Follow the storages of ``tensors`` not followed yet (an op's
        outputs; its inputs were outputs or arguments before)."""
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key in self.live:
                continue
            self.live[key] = s.nbytes()
            self.total += s.nbytes()
            self._finalizers[key] = weakref.finalize(s, self._free, key)
            self._serial += 1  # a freed storage's key may come back
            self._born[key] = self._serial
            for keys in self._watch:
                keys.add((key, self._serial))
        self.peak = max(self.peak, self.total)

    def _free(self, key: int) -> None:
        self.total -= self.live.pop(key, 0)
        self._finalizers.pop(key, None)
        self._born.pop(key, None)

    def arguments(self, *trees) -> None:
        """Count ``trees``' storages live from the start, as arguments."""
        new = {k: s for k, s in _storages(trees).items() if k not in self.live}
        self.argument_bytes += sum(s.nbytes() for s in new.values())
        self._args.update(new)
        self._track(_tensors(trees, []))

    def outputs(self, tree) -> None:
        """Count the result's storages that the step made as its outputs."""
        self.output_bytes += sum(
            s.nbytes() for k, s in _storages(tree).items()
            if k in self.live and k not in self._args)

    def costs(self) -> Costs:
        return Costs(flops=self.flops, bytes_accessed=self.bytes,
                     argument_bytes=self.argument_bytes,
                     peak_bytes=self.peak, output_bytes=self.output_bytes)

    # ---- weights --------------------------------------------------------
    def _weight(self) -> int:
        """The forward ops' weight, or in backward that of the autograd
        node running, from the iteration that made it (a node made in no
        shortened iteration: the weight of the iteration the backward
        runs in)."""
        if not self._ranges:
            return self.weight
        node = torch._C._current_autograd_node()
        if node is None:
            return self.weight
        seq = node._sequence_nr()
        w = self._node_weight.get(seq, 0)
        if w == 0:
            w = self._node_weight[seq] = next(
                (w for lo, hi, w in self._ranges if lo <= seq < hi), None)
        return self.weight if w is None else w

    @contextlib.contextmanager
    def iteration(self, weight: int):
        """One loop iteration standing for ``weight`` of them: its ops and
        the backward of the nodes it makes count ``weight`` times. Yields
        the set of (storage, serial number) it makes."""
        keys: set = set()
        self._watch.append(keys)
        grad = torch.is_grad_enabled() and weight != 1
        lo = _sequence_nr() if grad else 0
        self.weight *= weight
        try:
            yield keys
        finally:
            self.weight //= weight
            self._watch.remove(keys)
            if grad:
                self._ranges.append((lo, _sequence_nr(),
                                     weight * self.weight))

    def kernel(self, work, fn: Callable, *args) -> Any:
        """Run a kernel wrapper's body ``fn(*args)``, counting ``work`` =
        (flops, bytes) for it and nothing for the ops inside."""
        flops, nbytes = work
        w = self._weight()
        self.flops += w * flops
        self.bytes += w * nbytes
        self.in_kernel += 1
        try:
            return fn(*args)
        finally:
            self.in_kernel -= 1


def count(fn: Callable, *args, shortcut: bool = True, **kwargs) -> Costs:
    """The :class:`Costs` of ``fn(*args, **kwargs)``: its arguments live
    from the start, its result's new storages its outputs."""
    mode = CostMode(shortcut=shortcut)
    try:
        with mode:
            mode.arguments(args, kwargs)
            out = fn(*args, **kwargs)
            mode.outputs(out)
            del out
    finally:
        mode.close()
    return mode.costs()
