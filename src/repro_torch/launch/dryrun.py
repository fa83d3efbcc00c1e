"""Dry run on one H100: every (architecture × input shape) step run on the
meta device under the loop-aware counter — shapes only, nothing allocated,
no card needed — with its memory, cost and roofline on one card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
step on a TPU mesh and reads the compiled HLO. Here the step runs eagerly
on meta tensors in the config's dtype (:mod:`repro_torch.launch.steps`)
under :func:`repro_torch.launch.cost.count`; the roofline divides its
FLOPs and bytes by one H100's peak and HBM rate
(:mod:`repro_torch.launch.roofline`). The mesh is one card (``1xH100``):
the collective terms are 0, and ``fits`` says whether the step's peak
fits the card's 80 GiB. Most assigned shapes do not: that is the honest
per-card reading until mesh mode across cards shards them, not an error.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --out dryrun.jsonl
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (ASSIGNED, LoRAConfig, TrainConfig,
                                 get_config, get_shape)
from repro_torch.launch.cost import count
from repro_torch.launch.roofline import (HBM_BYTES, HBM_BYTES_PER_S,
                                         model_flops_per_step, peak_flops)
from repro_torch.launch.steps import (abstract_cache, abstract_state,
                                      input_specs, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.model import build_model
from repro_torch.util.logging import get_logger

logger = get_logger("dryrun")

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESH = "1xH100"

# microbatch split for the train_4k global batch of 256 (activation memory)
TRAIN_MICROBATCHES = 8


def should_skip(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 500k decode skipped per assignment "
                "(see DESIGN.md §4)")
    return None


def count_step(cfg, shape, *, moe_impl: str = "dense",
               lora_cfg: LoRAConfig = LoRAConfig(rank=16, alpha=32),
               microbatches: int = TRAIN_MICROBATCHES):
    """The :class:`~repro_torch.launch.cost.Costs` of one step of ``cfg``
    at ``shape`` on the meta device (the abstract state, inputs and cache:
    nothing allocated): the train step with ``microbatches``, the prefill
    and decode steps under ``torch.inference_mode()`` (decode at the
    cache's last position)."""
    model = build_model(cfg, moe_impl=moe_impl)
    params, lora, opt_state = abstract_state(model, cfg, lora_cfg)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(model, lora_cfg, TrainConfig(total_steps=1000),
                               num_microbatches=microbatches)
        return count(step, params, lora, opt_state, batch, 0)
    cache = abstract_cache(model, shape.global_batch, shape.seq_len)
    with torch.inference_mode():
        if shape.kind == "prefill":
            return count(make_prefill_step(model, lora_cfg), params, lora,
                         batch, cache)
        return count(make_decode_step(model, lora_cfg), params, lora,
                     batch["tokens"], cache, shape.seq_len - 1)


def run_one(arch: str, shape_name: str, *,
            moe_impl: str = "dense") -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": MESH,
                           "moe_impl": moe_impl}

    skip = should_skip(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    t0 = time.time()
    try:
        costs = count_step(cfg, shape, moe_impl=moe_impl)
        rec["status"] = "ok"
        rec["count_s"] = round(time.time() - t0, 2)
        rec["memory"] = {
            "argument_bytes": costs.argument_bytes,
            "output_bytes": costs.output_bytes,
            "temp_bytes": (costs.peak_bytes - costs.argument_bytes
                           - costs.output_bytes),
            "peak_bytes": costs.peak_bytes,
        }
        rec["fits"] = costs.peak_bytes <= HBM_BYTES
        compute_s = costs.flops / peak_flops(cfg.dtype)
        memory_s = costs.bytes_accessed / HBM_BYTES_PER_S
        collective_s = 0.0
        dominant = max((("compute", compute_s), ("memory", memory_s),
                        ("collective", collective_s)), key=lambda kv: kv[1])[0]
        mflops = model_flops_per_step(cfg, shape)
        rec["roofline"] = {
            "flops": costs.flops,
            "hbm_bytes": costs.bytes_accessed,
            "collective_bytes": costs.total_collective_bytes,
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dominant,
            "collectives": costs.collective_bytes,
            "collective_counts": costs.collective_counts,
            "model_flops_global": mflops,
            "model_flops_per_device": mflops,
            "useful_flops_ratio": mflops / costs.flops if costs.flops else None,
        }
        logger.info(
            "%s × %s × %s: OK count=%.1fs flops=%.3e bytes=%.3e peak=%.1f GiB "
            "fits=%s dominant=%s useful=%.2f", arch, shape_name, MESH,
            rec["count_s"], costs.flops, costs.bytes_accessed,
            costs.peak_bytes / 2 ** 30, rec["fits"], dominant,
            rec["roofline"]["useful_flops_ratio"] or -1)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {str(e)[:500]}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        logger.error("%s × %s × %s: FAILED %s", arch, shape_name, MESH,
                     rec["error"][:200])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all' (assigned pool)")
    ap.add_argument("--shape", default="all", choices=("all",) + SHAPE_NAMES)
    ap.add_argument("--moe-impl", default="dense", choices=("ragged", "dense"),
                    help="dense: every expert on every token (the ragged "
                         "loop reads group sizes on the host, which the meta "
                         "device cannot)")
    ap.add_argument("--out", default="", help="append JSON-lines records here")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_NAMES) if args.shape == "all" else [args.shape]

    records = []
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, moe_impl=args.moe_impl)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run summary: {ok} ok, {sk} skipped, {err} failed / {len(records)} total")
    if err:
        for r in records:
            if r["status"] == "error":
                print(f"  FAIL {r['arch']} × {r['shape']} × {r['mesh']}: {r['error'][:160]}")
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
