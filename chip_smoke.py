#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports no JAX. It puts ``src`` on
``sys.path`` itself and runs, each phase raising on failure:

1. environment: torch/CUDA versions and the card's name and power limit;
   TF32 off for matmuls and cuDNN (the fold's exactness is f32's);
2. build: ``nvcc`` compiles the kernels into ``build/kernels/``;
3. kernels: ``fedex_fold`` (both bodies) and ``factor_mean`` (both bodies)
   against their plain PyTorch versions at the main path's leaf shapes and
   at edge cases, each timed with CUDA events (median of 20 after warm-up,
   the 50 MB L2 flushed before each repetition) beside its plain version,
   its bound on the card and, for ``factor_mean``, ``torch.tensordot``;
4. main path: the port's ``FederatedTrainer`` at ``paper-llama3.2-3b`` full
   width (28 layers, d 3072, GQA 24/8, vocab 128,256, float32), LoRA rank 4,
   α 8 on q/k/v/o, 4 clients, batch 8 × seq 64 on a 512-token data
   vocabulary: one uniform full-participation round, then two rounds with
   example weighting at 50% participation. The kernels' launch counters must
   show every weighted close went through them, and one weighted round is
   checked against the exact-aggregation identity
   new_W0 + s·ā b̄ = old_W0 + s·Σ_c w_c a_c b_c on the card;
5. one JSON line with every ported kernel, then the result line.

Tolerances. ``factor_mean`` rounds each product and sum like separate
PyTorch ops, in the same slot order, so it must match its plain version
within 2·C unit roundoffs of Σ|w||x| (in practice bitwise). ``fedex_fold``
sums the same terms in the same client order as its plain version, but its
rank-r dot products are FMA-contracted in another order than
``torch.matmul``; it is held to ``fold_error_bound``: 2·(C + r + 4) unit
roundoffs of |W0| + |s|·(Σ|w||a||b| + |ā||b̄|) per element. The identity
check is held to the same bound.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, f32 outside the tensor cores
U = 2.0 ** -24
REPS, WARMUP = 20, 3


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over REPS repetitions (after WARMUP),
    each bracketed by its own CUDA events with the L2 flushed just before."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(WARMUP):
            fn()
        pairs = []
        for _ in range(REPS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def main_path_leaves(cfg):
    """(name, L, m, n) of the adapted leaves of the main path."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return [("q_proj", cfg.num_layers, d, cfg.num_heads * hd),
            ("k_proj", cfg.num_layers, d, cfg.num_kv_heads * hd),
            ("v_proj", cfg.num_layers, d, cfg.num_kv_heads * hd),
            ("o_proj", cfg.num_layers, cfg.num_heads * hd, d)]


def make_inputs(torch, device, c, lead, m, n, r, live, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randn(*shape, std):
        return torch.empty(shape, device=device).normal_(0.0, std, generator=g)

    w0 = randn(*lead, m, n, std=0.02)
    a = randn(c, *lead, m, r, std=0.02)
    b = randn(c, *lead, r, n, std=0.01)
    w = torch.zeros(c, device=device)
    w[list(live)] = torch.rand(len(live), device=device, generator=g) + 0.1
    return w0, a, b, w / w.sum()


def check_fold(torch, kernels, w0, a, b, scale, w):
    got = kernels.fedex_fold(w0, a, b, scale, weights=w)
    torch.cuda.synchronize()
    want = kernels.fedex_fold_plain(w0, a, b, scale, w)
    bound = kernels.fold_error_bound(w0, a, b, scale, w)
    err = (got - want).abs()
    ok = bool((err <= bound).all())
    return float(err.max()), ok


def check_mean(torch, kernels, x, w):
    got = kernels.factor_mean(x, w)
    torch.cuda.synchronize()
    want = kernels.factor_mean_plain(x, w)
    c = x.shape[0]
    wabs = (torch.full((c,), 1.0 / c, device=x.device) if w is None
            else w.abs())
    bound = 2 * c * U * torch.tensordot(wabs, x.abs(), dims=1)
    err = (got - want).abs()
    return float(err.max()), bool((err <= bound).all()), bool(torch.equal(
        got, want))


def fold_cost(leaves, c_live, r):
    """Bytes each input read once and each output written once, and flops,
    of one fold per leaf (zero-weight lanes are not read)."""
    nbytes = flops = 0
    for _, L, m, n in leaves:
        nbytes += 8 * L * m * n + 4 * c_live * L * (m * r + r * n)
        flops += L * m * n * (2 * (c_live + 1) * r + 4)
    return nbytes, flops


def mean_cost(leaves, c_live, r):
    nbytes = flops = 0
    for _, L, m, n in leaves:
        for count in (L * m * r, L * r * n):
            nbytes += 4 * (c_live + 1) * count
            flops += 2 * c_live * count
    return nbytes, flops


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, kernels, device, cfg, *, c, r, scale):
    """Both bodies of both kernels against their plain versions at the main
    path's shapes and at edge cases; timings at the main path's shapes."""
    timer = Timer(torch, device)
    leaves = main_path_leaves(cfg)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0}
    timings = {}
    live_sets = {"weighted-partial": (0, 1), "weighted-full": tuple(range(c)),
                 "uniform": tuple(range(c))}
    for body, live in live_sets.items():
        weighted = body != "uniform"
        bufs = []
        for i, (name, L, m, n) in enumerate(leaves):
            w0, a, b, w = make_inputs(torch, device, c, (L,), m, n, r, live,
                                      seed=i)
            wts = w if weighted else None
            err, ok = check_fold(torch, kernels, w0, a, b, scale, wts)
            errs["fedex_fold"] = max(errs["fedex_fold"], err)
            print(f"  fedex_fold[{body}] {name} ({L},{m},{n}) C={c} r={r}: "
                  f"max_abs_err={err:.3e} within bound={ok}", flush=True)
            if not ok:
                raise AssertionError(f"fedex_fold[{body}] {name} disagrees "
                                     "with its plain version")
            for fac in (a, b):
                err, ok, same = check_mean(torch, kernels, fac, wts)
                errs["factor_mean"] = max(errs["factor_mean"], err)
                if not ok:
                    raise AssertionError(f"factor_mean[{body}] {name} "
                                         "disagrees with its plain version")
            print(f"  factor_mean[{body}] {name} a/b: bitwise={same}",
                  flush=True)
            bufs.append((w0, a, b, wts, torch.empty_like(w0)))

        def fold_kernel():
            for w0, a, b, wts, out in bufs:
                kernels.fedex_fold(w0, a, b, scale, weights=wts, out=out)

        def fold_plain():
            for w0, a, b, wts, _ in bufs:
                kernels.fedex_fold_plain(w0, a, b, scale, wts)

        def mean_kernel():
            for _, a, b, wts, _ in bufs:
                kernels.factor_mean(a, wts)
                kernels.factor_mean(b, wts)

        def mean_plain():
            for _, a, b, wts, _ in bufs:
                kernels.factor_mean_plain(a, wts)
                kernels.factor_mean_plain(b, wts)

        def mean_library():
            for _, a, b, wts, _ in bufs:
                wl = (wts if wts is not None
                      else torch.full((c,), 1.0 / c, device=device))
                torch.tensordot(wl, a, dims=1)
                torch.tensordot(wl, b, dims=1)

        c_live = len(live)
        t = {"fedex_fold": (timer(fold_kernel), timer(fold_plain), None,
                            bound_ms(*fold_cost(leaves, c_live, r))),
             "factor_mean": (timer(mean_kernel), timer(mean_plain),
                             timer(mean_library),
                             bound_ms(*mean_cost(leaves, c_live, r)))}
        for name, (ms, plain, lib, (bms, by)) in t.items():
            print(f"  time {name}[{body}] one close (4 leaves): kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                  f"{bms:.4f} ms ({by})", flush=True)
        timings[body] = t
        del bufs
        torch.cuda.empty_cache()

    # edge cases, both bodies: (C, L, m, n, r, live lanes)
    for c_e, L, m, n, r_e, live in [(3, 2, 1000, 777, 4, (0, 1, 2)),
                                    (1, 2, 512, 640, 4, (0,)),
                                    (8, 2, 384, 256, 4, (1, 4, 6)),
                                    (4, 2, 256, 384, 16, (0, 1, 2, 3)),
                                    (20, 2, 96, 200, 4, tuple(range(17)))]:
        w0, a, b, w = make_inputs(torch, device, c_e, (L,), m, n, r_e, live,
                                  seed=99)
        for wts in (w, None):
            err, ok = check_fold(torch, kernels, w0, a, b, scale, wts)
            errs["fedex_fold"] = max(errs["fedex_fold"], err)
            e2, ok2, _ = check_mean(torch, kernels, a, wts)
            e3, ok3, _ = check_mean(torch, kernels, b, wts)
            errs["factor_mean"] = max(errs["factor_mean"], e2, e3)
            body = "weighted" if wts is not None else "uniform"
            print(f"  edge C={c_e} L={L} m={m} n={n} r={r_e} live={live} "
                  f"[{body}]: fold err {err:.3e} ok={ok}, mean ok="
                  f"{ok2 and ok3}", flush=True)
            if not (ok and ok2 and ok3):
                raise AssertionError(f"edge case C={c_e} m={m} n={n} r={r_e} "
                                     f"[{body}] disagrees")
    return errs, timings


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def main_path(torch, device, cfg, *, clients=4, local_steps=2,
              weighted_rounds=2, batch=8, seq=64, data_vocab=512):
    """Drive the port's FederatedTrainer: round 0 uniform over every client,
    then ``weighted_rounds`` rounds with example weights at 50%
    participation. Returns (trainer, per-round timings, identity check)."""
    from repro_torch.configs import FedConfig, LoRAConfig, TrainConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.fedsrv import RoundPolicy
    from repro_torch.kernels import fold_error_bound
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model
    from repro_torch.util.tree import count_params

    rounds = 1 + weighted_rounds
    t0 = time.perf_counter()
    loaders, evals = build_federated_data(data_vocab, clients, seq_len=seq,
                                          batch_size=batch, device=device)
    trainer = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(rank=4, alpha=8.0),
        fed_cfg=FedConfig(num_clients=clients, rounds=rounds,
                          local_steps=local_steps),
        train_cfg=TrainConfig(learning_rate=5e-3, schedule="constant",
                              total_steps=rounds * local_steps),
        client_loaders=loaders, eval_batches=evals, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"  set-up (data + {count_params(trainer.params) / 1e9:.2f} B "
          f"params on the card): {time.perf_counter() - t0:.1f} s",
          flush=True)

    step_ms, close_ms, eval_ms = [], [], []

    def timed(fn, sink):
        """``fn`` bracketed by device syncs; its wall time (ms) → ``sink``."""
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    trainer.local_step = timed(trainer.local_step, step_ms)
    trainer.engine.close = timed(trainer.engine.close, close_ms)
    trainer._evaluate = timed(trainer._evaluate, eval_ms)
    rows, identity = [], None
    for rnd in range(rounds):
        if rnd == 1:
            trainer.coordinator.policy = RoundPolicy(participation=0.5,
                                                     weighting="examples")
        keys = [s.key for s in trainer.engine.specs]
        old_w0 = None
        if rnd == rounds - 1:  # the exactness identity on the last round
            old_w0 = {k: _node(trainer.params, k)["kernel"].clone()
                      for k in keys}
        n_steps, n_close = len(step_ms), len(close_ms)
        t = time.perf_counter()
        rec = trainer.run(until=rnd + 1)[rnd]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out = trainer.outcomes[-1]
        rows.append({
            "round": rnd, "clients": out.client_ids,
            "weights": out.weights,
            "step_ms": statistics.median(step_ms[n_steps:]),
            "close_ms": close_ms[n_close:][0], "eval_ms": eval_ms[-1],
            "round_s": wall,
            "eval_loss": rec.eval_loss,
            "divergence": float(rec.divergence_scaled),
            "client_losses": rec.client_losses})
        r = rows[-1]
        print(f"  round {rnd} [{'uniform' if out.weights is None else 'weighted'}"
              f" clients={out.client_ids}]: client step {r['step_ms']:.1f} ms "
              f"(median of {len(step_ms) - n_steps}), close "
              f"{r['close_ms']:.2f} ms, eval {r['eval_ms']:.1f} ms, round "
              f"{wall:.2f} s, eval_loss "
              f"{rec.eval_loss:.4f}, divergence {r['divergence']:.3e}",
              flush=True)
        if old_w0 is not None:
            identity = exactness_identity(torch, trainer, out, old_w0,
                                          fold_error_bound)
    return trainer, rows, identity


def exactness_identity(torch, trainer, outcome, old_w0, fold_error_bound):
    """new_W0 + s·ā b̄ against old_W0 + s·Σ_c w_c a_c b_c per adapted leaf,
    over the delivered clients' own adapters."""
    s = trainer.scale
    w = torch.tensor(outcome.weights, dtype=torch.float32,
                     device=trainer.device)
    worst = 0.0
    for key, w0_old in old_w0.items():
        a = torch.stack([_node(d.lora, key)["a"] for d in outcome.delivered])
        b = torch.stack([_node(d.lora, key)["b"] for d in outcome.delivered])
        g = _node(trainer.global_lora, key)
        w0_new = _node(trainer.params, key)["kernel"]
        lhs = w0_new + s * torch.matmul(g["a"], g["b"])
        rhs = w0_old.clone()
        for i in range(a.shape[0]):
            rhs += s * w[i] * torch.matmul(a[i], b[i])
        bound = fold_error_bound(w0_old, a, b, s, w)
        err = (lhs - rhs).abs()
        ok = bool((err <= bound).all())
        folded = float((w0_new - w0_old).abs().max())
        print(f"  identity {key}: max |lhs - rhs| = {float(err.max()):.3e}, "
              f"max bound {float(bound.max()):.3e}, within bound={ok}; "
              f"max |residual folded into W0| = {folded:.3e}", flush=True)
        if not ok:
            raise AssertionError(f"exact-aggregation identity fails on {key}")
        worst = max(worst, float(err.max()))
        del w0_new, lhs, rhs, bound, err
    return worst


def _node(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


# --------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on the "
              "card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch)"
              " — run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1/5] environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          "TF32 off", flush=True)
    print(smi, flush=True)

    t = time.perf_counter()
    lib = kbuild.build(verbose=True)
    kbuild.load_library()
    print(f"[2/5] build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    c, r, scale = 4, 4, 8.0 / 4
    print(f"[3/5] kernels vs plain versions (C={c}, r={r}, scale={scale})",
          flush=True)
    errs, timings = kernel_phase(torch, kernels, device, cfg, c=c, r=r,
                                 scale=scale)
    torch.cuda.empty_cache()

    print(f"[4/5] main path: FederatedTrainer at {cfg.name} full width "
          f"({cfg.num_layers} layers, d={cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype})", flush=True)
    kernels.fedex_fold.launches = 0
    kernels.factor_mean.launches = 0
    trainer, rows, identity = main_path(torch, device, cfg)
    launches = {"fedex_fold": kernels.fedex_fold.launches,
                "factor_mean": kernels.factor_mean.launches}
    n_weighted = sum(1 for row in rows if row["weights"] is not None)
    n_leaves = len(trainer.engine.specs)
    expected = {"fedex_fold": n_leaves * n_weighted,
                "factor_mean": 2 * n_leaves * n_weighted}
    print(f"  launches on the main path: {launches} (expected {expected} for "
          f"{n_weighted} weighted closes); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    values = [v for row in rows for v in
              (row["eval_loss"], row["divergence"], *row["client_losses"])]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite losses or divergence: {rows}")

    main_body = timings["weighted-partial"]
    out = []
    for name, source, replaces in [
            ("fedex_fold", "src/repro_torch/kernels/csrc/fedex_fold.cu",
             "src/repro/kernels/fedex_residual.py:108"),
            ("factor_mean", "src/repro_torch/kernels/csrc/factor_mean.cu",
             "src/repro/kernels/factor_mean.py:50")]:
        ms, plain, lib_ms, (bms, by) = main_body[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    print(f"[5/5] done in {time.perf_counter() - t_start:.1f} s; identity "
          f"max err {identity:.3e}; rounds "
          + json.dumps([{k: v for k, v in row.items() if k != "client_losses"}
                        for row in rows]), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
