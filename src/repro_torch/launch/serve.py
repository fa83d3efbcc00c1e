"""Batched serving of the port: prefill + greedy decode with the KV
cache, of a LoRA-adapted model.

Counterpart of ``repro/launch/serve.py``. The served adapter can be a
fresh one (``init_lora``: b = 0, a no-op), or what a ``FederatedTrainer``
aggregated: pass its folded W0 (``params=trainer.params``) and global
adapter (``lora=trainer.global_lora``). The model runs in its config's
dtype, as the reference serves it: bfloat16 for every registered config
(``ModelConfig.dtype``'s default); :func:`serve`'s ``dtype`` keyword picks
another (float32). The adapted q/k/v/o projections of prefill and decode
run the fused LoRA kernel (B3) and the prefill attention the flash
attention kernel (B8), each in that dtype (a hybrid config's Mamba2
``in_proj`` / ``out_proj`` through B3 too, and an xLSTM config's adapted
projections, which have no attention; an encdec config's encoder pass over
the prompt's ``frames`` and its decoder's self- and cross-attention, the
decode steps reading the cross cache filled at prefill; a vlm config's
prefill over its prompt's projected patch prefix and text); an f32 adapter
(``init_lora``'s, a trainer's, a pulled one) is cast to it once before the
prefill (the reference's ``dense`` casts it where it is applied, to the
same values). Runs on CUDA unless ``--device cpu`` is given (the CPU runs
the kernels' plain versions).

A vlm config (internvl2) is served at the prefill's true length, the one
departure from the reference: ``make_batch_for`` gives its prompt
``vision_tokens`` patch embeddings and ``max(1, prompt_len −
vision_tokens)`` text tokens, so the prefill fills ``vision_tokens +
max(1, prompt_len − vision_tokens)`` cache positions and decode starts
there. The reference decodes from ``prompt_len + vision_tokens``
(``repro/launch/serve.py``), past the prefill's end, which leaves cache
slots unwritten and can run past the cache; the port counts the prefill
plus the steps against ``max_len`` and raises ``ValueError`` beyond it.

``--pull-from URL`` fetches the global adapter a running federation server
(``repro_torch.launch.train --mode serve``) holds now, through
:meth:`~repro_torch.fedsrv.client.FedClient.pull_latest`, and generates with
it on the model's own drawn base, as the reference does (the arch and rank
must match the server's).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch paper-tiny --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch paper-gpt2-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch gemma3-12b-smoke --batch-size 2 --prompt-len 128 --steps 8 \\
      --max-len 160
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch mixtral-8x22b-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch zamba2-7b-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch xlstm-1.3b-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch whisper-medium-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch internvl2-76b-smoke --batch-size 2 --prompt-len 32 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch paper-tiny --pull-from http://127.0.0.1:8077
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import LoRAConfig, ModelConfig, get_config
from repro_torch.core.lora import init_lora
from repro_torch.data import make_batch_for
from repro_torch.fedsrv.client import FedClient
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.common import DTYPES, dtype_of
from repro_torch.util.device import resolve_device
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths


@dataclass
class ServeResult:
    tokens: np.ndarray   # (batch, steps + 1) int32: the prefill's token first
    prefill_ms: float    # host clock around the prefill step, synchronised
    decode_ms: float     # host clock around all decode steps, synchronised
    steps: int

    @property
    def ms_per_token(self) -> float:
        return self.decode_ms / max(self.steps, 1)


# leaves the reference keeps in float32 whatever the model's dtype (Mamba2's
# A_log, D and dt_bias; the sLSTM's gate bias)
F32_LEAVES = ("A_log", "D", "dt_bias", "b_gates")


def _cast(tree: dict, dtype: torch.dtype) -> dict:
    """``tree`` with its floating leaves in ``dtype`` (a new tree), but
    for a float32 leaf of ``F32_LEAVES``, which stays float32."""
    def keep(path, v):
        return (v.dtype == torch.float32
                and path.rsplit("/", 1)[-1] in F32_LEAVES)

    return unflatten_from_paths({
        k: v.to(dtype) if v.is_floating_point() and not keep(k, v) else v
        for k, v in flatten_with_paths(tree).items()})


def prefill_length(cfg, prompt_len: int) -> int:
    """The positions a ``make_batch_for`` prompt of ``prompt_len`` fills:
    ``prompt_len``, or for a vlm config its patch prefix and text,
    ``vision_tokens + max(1, prompt_len − vision_tokens)``; decode starts
    there."""
    if cfg.family == "vlm":
        return cfg.vision_tokens + max(1, prompt_len - cfg.vision_tokens)
    return prompt_len


def serve(arch, *, batch_size: int = 2, prompt_len: int = 32,
          steps: int = 8, max_len: int = 128, rank: int = 4,
          use_lora: bool = True, seed: int = 0, device="cuda",
          params: Optional[dict] = None,
          lora: Optional[dict] = None, pull_from: str = "",
          dtype: Optional[torch.dtype] = None,
          cache_dtype: torch.dtype = torch.bfloat16) -> ServeResult:
    """Prefill a ``make_batch_for`` prompt of ``prompt_len`` tokens, then
    ``steps`` greedy decode steps against a cache of ``max_len`` positions
    (a windowed layer's ring: ``min(window, max_len)``) in ``cache_dtype``
    (bf16, the reference's, by default). ``params`` / ``lora`` default to the port's own draws from
    ``seed`` (``lora``: ``init_lora`` from ``seed + 1`` unless
    ``use_lora=False``; a given ``lora`` is served as it is).
    ``pull_from`` (a federation server's URL) serves the global adapter
    pulled from it instead. The model runs in ``dtype`` (None: the
    config's own, bf16 as the reference's); ``params`` and the adapter,
    given, drawn or pulled, are served cast to it (the float32 leaves
    of ``F32_LEAVES`` kept in float32, as the model holds them). ``arch``
    is a registered config's name, or a :class:`ModelConfig` itself (a
    config cut in depth, say). A vlm prompt is ``vision_tokens`` patch
    embeddings and ``max(1, prompt_len − vision_tokens)`` text tokens,
    decoded from :func:`prefill_length` (not the reference's
    ``prompt_len + vision_tokens``); the prefill plus ``steps`` must fit in
    ``max_len``."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if dtype is not None:
        names = {t: n for n, t in DTYPES.items()}
        if dtype not in names:
            raise ValueError(f"serve: dtype {dtype} is not one of "
                             f"{sorted(DTYPES)}")
        cfg = replace(cfg, dtype=names[dtype])
    model = build_model(cfg)
    mdt = dtype_of(cfg)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen, dev)
    else:
        params = _cast(params, mdt)
    lora_cfg = LoRAConfig(rank=rank)
    if pull_from:
        pulled = FedClient(pull_from, client_id=-1, device=dev).pull_latest()
        lora = pulled.lora
        print(f"pulled global adapter v{pulled.version} from {pull_from} "
              f"(W0 digest {pulled.w0_digest[:12]}…)")
    if lora is None and use_lora:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        lora = init_lora(gen, params, cfg, lora_cfg)
    if lora is not None:
        # once here, so that the projections' cast to x's dtype is a no-op
        lora = _cast(lora, mdt)
    pos0 = prefill_length(cfg, prompt_len)
    if pos0 + steps > max_len:
        raise ValueError(f"serve: a prefill of {pos0} positions + {steps} "
                         f"steps exceeds the cache's {max_len} positions")
    batch = make_batch_for(cfg, batch_size, prompt_len, seed=seed, device=dev)
    cache = model.init_cache(batch_size, max_len, cache_dtype, device=dev)
    prefill = make_prefill_step(model, lora_cfg)
    decode = make_decode_step(model, lora_cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, lora, batch, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0
        generated = [next_tok]
        t0 = time.perf_counter()
        for i in range(steps):
            next_tok, logits, cache = decode(params, lora, next_tok, cache,
                                             pos0 + i)
            generated.append(next_tok)
        sync()
        t_decode = time.perf_counter() - t0
        tokens = torch.cat(generated, dim=1).cpu().numpy()
    return ServeResult(tokens=tokens, prefill_ms=1e3 * t_prefill,
                       decode_ms=1e3 * t_decode, steps=steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--arch", default="paper-tiny",
                    help="a registered config of the port (dense, vlm, "
                         "MoE, hybrid, ssm or encdec family; a vlm prompt's "
                         "length counts its vision tokens)")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-lora", action="store_true")
    ap.add_argument("--pull-from", default="",
                    help="serve the global adapter of the federation server "
                         "at this URL (train --mode serve)")
    args = ap.parse_args(argv)
    res = serve(args.arch, batch_size=args.batch_size,
                prompt_len=args.prompt_len, steps=args.steps,
                max_len=args.max_len, rank=args.rank,
                use_lora=not args.no_lora, seed=args.seed, device=args.device,
                pull_from=args.pull_from)
    print(f"arch={args.arch} device={args.device} prefill="
          f"{res.prefill_ms:.1f} ms decode={res.decode_ms:.1f} ms "
          f"({res.ms_per_token:.2f} ms/token)")
    print("generated token ids:\n", res.tokens)


if __name__ == "__main__":
    main()
