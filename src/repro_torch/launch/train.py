"""Federated fine-tuning launcher of the port: host mode, mesh mode and the
HTTP federation service.

Counterpart of ``repro/launch/train.py``. ``--mode host`` (the default)
runs what the port runs:
every method — ``--method fedex`` with ``--assignment average``,
``keep_local`` or ``reinit``, ``--method fedex_svd --svd-rank r'``,
``--method hetero`` / ``--client-ranks``, and the paper's baselines
``--method fedit|ffa|centralized`` — with per-client step budgets
(``--client-local-steps``), participation sampling,
``--min-quorum``, ``--weighting``, ``--close-chunk`` (the chunked streaming
close), ``--engine off`` (the eager close), DP uploads (``--dp-clip``,
``--dp-noise``), the coordinator's policies (``--deadline``,
``--stragglers``, ``--dropout-prob``), FedBuff commits (``--async-buffer``,
``--ring-depth``), the uplink transport (``--quantize-uplink``,
``--uplink-max-norm``, ``--no-uplink-validation``, ``--uplink-retries``),
seeded fault injection (``--faults``), round-state checkpoints
(``--checkpoint-dir``, ``--checkpoint-every``, ``--resume``) and
observability (``--obs off|basic|trace``; ``--trace t.json`` writes a
Chrome trace and implies ``--obs trace``, ``--metrics-out m.jsonl`` writes
the JSONL stream ``scripts/obs_report.py`` reads and implies ``--obs
basic``); the measured bytes ledger is printed after the run, with its
quarantined and dropped buckets and each round's quarantined or dropped
(client, reason) pairs. Runs on CUDA unless ``--device cpu`` is given.
An encdec config (whisper-medium) is refused in host and mesh mode by name:
the federated loaders yield tokens only and its batches need frames (the
reference fails there with ``KeyError: 'frames'``); a caller that supplies
frames trains it through ``FederatedTrainer`` or ``MeshFederatedTrainer``
directly. A vlm config
(internvl2-76b) trains in host and mesh mode as the reference's launcher
trains it: a text-only LM over the loaders' tokens (no ``vision_embeds``
in the batches; its ``vision_proj`` carries no adapter).

``--mode serve`` boots the HTTP federation service
(:mod:`repro_torch.fedsrv.server`) with ``--host``, ``--port`` (0 =
ephemeral), ``--serve-token``, ``--max-concurrent`` and ``--quota``, prints
``SERVING http://host:port`` when it is ready, closes rounds as clients POST
their deltas (``--deadline`` in wall seconds), keeps answering GETs for
``--linger`` seconds after the last close, and prints the ledger measured
over HTTP.

``--mode mesh`` co-schedules the clients
(:mod:`repro_torch.launch.mesh_train`): every client is a lane of one
stacked training round, and every round closes through the engine's
weighted close (the kernels on the GPU), for ``--method fedex`` and
``fedex_svd``, for every family the launcher trains (dense, MoE, hybrid,
ssm, vlm), with ``--participation``, ``--weighting``,
``--client-local-steps`` (lane c freezes after its budget), ``--faults`` of
the value kinds (nan, inf, scale), ``--uplink-max-norm`` with such a plan,
and ``--obs``. A setting it cannot honour (the host-only flags: the
coordinator's policies, the transport's codec and retries, DP, client
ranks, ``--engine``, the ring, checkpoints, and a norm ceiling without a
fault plan, which the reference's mesh mode ignores) raises ``ValueError``
naming it.

``--data-vocab`` draws the synthetic corpus from a smaller vocabulary than
the model's (its transition tensor is dense vocab², ~526 GB at 128,256 and
~20 GB a task at paper-gpt2's 50,257); the model keeps its full embedding
and unembedding.

Examples (CPU, tiny model):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch paper-tiny --clients 3 --rounds 3 --local-steps 5 --vocab 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --assignment keep_local
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --method hetero --client-ranks 4,2,1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --clients 6 --close-chunk 4 --weighting examples
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --method fedit --dp-clip 1.0 --dp-noise 0.1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch paper-gpt2-smoke --vocab 64 --rounds 2 --local-steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3-12b-smoke --method fedex --vocab 64 --rounds 2 \\
      --seq-len 96 --weighting examples --participation 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch mixtral-8x22b-smoke --method fedex --vocab 64 --rounds 2 \\
      --weighting examples --participation 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch zamba2-7b-smoke --method fedex --vocab 64 --rounds 2 \\
      --weighting examples --participation 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch xlstm-1.3b-smoke --method fedex --vocab 64 --rounds 2 \\
      --weighting examples --participation 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch internvl2-76b-smoke --method fedex --data-vocab 64 \\
      --rounds 2 --weighting examples --participation 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --clients 4 --rounds 3 --deadline 1.0 --min-quorum 2 \\
      --dropout-prob 0.25 --stragglers 0.25 --weighting examples
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --rounds 3 --async-buffer 2 --weighting examples
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --rounds 2 --quantize-uplink int8 --uplink-max-norm 1.0
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --clients 4 --rounds 2 \\
      --faults 'nan@1(clients=1);truncate@1(clients=2);crash@0.5(rounds=1)'
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --rounds 1 --checkpoint-dir /tmp/ck   # killed after round 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --rounds 3 --checkpoint-dir /tmp/ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --rounds 3 --participation 0.5 --weighting examples \\
      --obs trace --trace t.json --metrics-out m.jsonl
  python scripts/obs_report.py m.jsonl --trace t.json --check
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch paper-tiny --mode mesh --participation 0.5 \\
      --weighting examples --clients 4 --rounds 2 --local-steps 3 --vocab 32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --vocab 64 --mode serve --port 0 --clients 3 --rounds 2 --linger 5
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np

from repro_torch.checkpoint import round_state_path
from repro_torch.configs import (FedConfig, LoRAConfig, ServeConfig,
                                 TrainConfig, get_config, validate_fed_lora)
from repro_torch.core import FederatedTrainer, init_global_state
from repro_torch.data import ClientLoader, SyntheticLM, dirichlet_partition
from repro_torch.launch.mesh_train import MeshFederatedTrainer
from repro_torch.models import build_model
from repro_torch.util.device import resolve_device


def build_federated_data(vocab: int, num_clients: int, *,
                         seqs_per_task: int = 120, seq_len: int = 64,
                         alpha: float = 0.5, seed: int = 0,
                         batch_size: int = 8, device="cuda"):
    """Client loaders and eval batches over a synthetic Markov corpus —
    the reference's ``build_federated_data`` draws, emitted on ``device``."""
    device = resolve_device(device)
    ds = SyntheticLM(vocab=vocab, num_tasks=num_clients, seed=seed)
    seqs, labels = [], []
    for t in range(num_clients):
        s = ds.sample(task=t, num_sequences=seqs_per_task, seq_len=seq_len,
                      seed=seed + t)
        seqs.append(s)
        labels += [t] * seqs_per_task
    seqs = np.concatenate(seqs)
    parts = dirichlet_partition(np.array(labels), num_clients, alpha=alpha,
                                seed=seed)
    loaders = [ClientLoader(seqs[p], batch_size=batch_size, seed=seed + i,
                            device=device)
               for i, p in enumerate(parts)]
    eval_batches = [ds.to_batch(ds.sample(task=t, num_sequences=16,
                                          seq_len=seq_len,
                                          seed=seed + 1000 + t), device)
                    for t in range(num_clients)]
    return loaders, eval_batches


def write_obs(rec, args) -> None:
    """Print the recorder's summary and write ``--trace`` /
    ``--metrics-out``."""
    if not rec.enabled:
        return
    for line in rec.summary_lines():
        print(line)
    if args.trace:
        rec.write_trace(args.trace)
        print(f"trace → {args.trace} (Perfetto / chrome://tracing)")
    if args.metrics_out:
        rec.write_metrics(args.metrics_out)
        print(f"metrics JSONL → {args.metrics_out} (scripts/obs_report.py)")


def print_ledger(trainer) -> None:
    """The host trainer's measured bytes ledger, its quarantined and
    dropped buckets, and each round's quarantined or dropped pairs."""
    if trainer.ledger.entries:
        print("comm ledger (measured, fedsrv transport):")
        for line in trainer.ledger.summary_lines():
            print("  " + line)
        tot = trainer.ledger.totals()
        for bucket in ("quarantined", "dropped"):
            if f"{bucket}_params" in tot:
                print(f"  {bucket}: {tot[bucket + '_params']} params, "
                      f"{tot[bucket + '_bytes']} B")
    for out in trainer.outcomes:
        if out.quarantined:
            print(f"round={out.round_id} quarantined or dropped "
                  f"(client, reason): {out.quarantined}")


def run_serve(args, model, lora_cfg, fed_cfg, device) -> None:
    """``--mode serve``: boot the HTTP federation service and block until
    every round closed (or Ctrl-C). The clients train in their own
    processes; this one ingests deltas, closes rounds and serves the global
    adapter."""
    from repro_torch.fedsrv.server import FederationServer, start_http_server

    serve_cfg = ServeConfig(host=args.host, port=args.port,
                            max_concurrent=args.max_concurrent,
                            quota_per_round=args.quota,
                            token=args.serve_token)
    params, global_lora = init_global_state(model, lora_cfg, seed=args.seed,
                                            device=device)
    fed = FederationServer(params, global_lora, scale=lora_cfg.scale,
                           fed_cfg=fed_cfg, serve_cfg=serve_cfg)
    httpd = start_http_server(fed, host=serve_cfg.host, port=serve_cfg.port)
    host, port = httpd.server_address[:2]
    print(f"SERVING http://{host}:{port}", flush=True)  # the readiness line
    try:
        while not fed.done:
            time.sleep(0.05)
            fed.tick()  # a passed deadline closes without a POST
        # the clients still pull the final adapter and the metrics
        time.sleep(args.linger)
    except KeyboardInterrupt:
        print(f"interrupted after {fed.version} close(s)")
    httpd.shutdown()
    httpd.server_close()
    fed.finalize()  # the last divergence, before the metrics are written
    write_obs(fed.rec, args)
    if fed.ledger.entries:
        print("comm ledger (measured over HTTP):")
        for line in fed.ledger.summary_lines():
            print("  " + line)
    print(f"served {fed.version}/{fed_cfg.rounds} round close(s) "
          f"(C={fed_cfg.num_clients}, method={fed_cfg.method}, "
          f"device={device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--mode", default="host",
                    choices=("host", "serve", "mesh"),
                    help="host = the coordinator's simulation; mesh = the "
                         "clients co-scheduled as lanes of one stacked "
                         "round, closed by the weighted kernel close (fedex, "
                         "fedex_svd); serve = the HTTP federation service "
                         "(clients POST deltas; --deadline means wall "
                         "seconds)")
    ap.add_argument("--arch", default="paper-tiny")
    ap.add_argument("--method", default="fedex",
                    choices=("fedex", "fedit", "ffa", "fedex_svd", "hetero",
                             "centralized"))
    ap.add_argument("--assignment", default="average",
                    choices=("average", "keep_local", "reinit"),
                    help="fedex: what clients start the next round from "
                         "(Table 5)")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--svd-rank", type=int, default=0,
                    help="fedex_svd: truncation rank r' (0 = exact)")
    ap.add_argument("--client-ranks", default="",
                    help="comma-separated per-client ranks, e.g. 4,2,1 — "
                         "non-empty (or --method hetero) runs the ragged-rank "
                         "close; adapters pad to --rank = r_max")
    ap.add_argument("--client-local-steps", default="",
                    help="comma-separated per-client local step budgets, "
                         "e.g. 1,2,2,1 ('' = every client runs "
                         "--local-steps; mesh mode freezes a lane after its "
                         "budget)")
    ap.add_argument("--alpha", type=float, default=8.0, help="LoRA alpha")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override the model vocab (small = faster CPU demo)")
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="vocabulary of the synthetic corpus (0 = the "
                         "model's); must stay small, see above")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--include-mlp", action="store_true")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round")
    ap.add_argument("--min-quorum", type=int, default=0,
                    help="deliveries a round needs (0 = one)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="round deadline in sim-seconds (0 = wait for all)")
    ap.add_argument("--weighting", default="uniform",
                    choices=("uniform", "examples"),
                    help="client weights: uniform or example counts n_i/Σn_j")
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="straggler probability per (round, client); latency "
                         "is inflated ×5 for stragglers")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="P(client accepts the round but never reports back)")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help=">0 → FedBuff-style buffered commits of this size")
    ap.add_argument("--quantize-uplink", default="none",
                    choices=("none", "fp16", "int8"),
                    help="uplink adapter codec (fedsrv transport)")
    ap.add_argument("--uplink-max-norm", type=float, default=0.0,
                    help="quarantine uplinks whose ∞-norm exceeds this "
                         "(0 = off)")
    ap.add_argument("--ring-depth", type=int, default=2,
                    help="rounds whose uplink stacks may be in flight at "
                         "once (2 = double buffering; >2 pipelines FedBuff "
                         "commits deeper, with deadline eviction)")
    ap.add_argument("--close-chunk", type=int, default=0,
                    help="chunked streaming round closes: uplinks fold into "
                         "running accumulators N clients at a time as they "
                         "arrive (0 = the stacked close; a round of at most "
                         "N clients always takes the stacked close)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "plain", "off"),
                    help="round close: auto = the CUDA kernels on the GPU, "
                         "their plain PyTorch versions on the CPU; off = "
                         "the eager close over the list of client adapters")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="DP: L2 clip on each client's adapter delta "
                         "(0 = off)")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="DP: Gaussian noise multiplier σ (std = σ · clip)")
    ap.add_argument("--faults", default="",
                    help="seeded fault plan, e.g. "
                         "'nan@0.2;truncate@1(clients=2,rounds=0+1)': "
                         "corrupts uplinks between encode and delivery; the "
                         "validation quarantines them, the close stays exact "
                         "over the survivors")
    ap.add_argument("--no-uplink-validation", action="store_true",
                    help="turn off the defended decode (finite, shape and "
                         "spec checks on every uplink)")
    ap.add_argument("--uplink-retries", type=int, default=2,
                    help="retries of a transient decode failure")
    ap.add_argument("--checkpoint-dir", default="",
                    help="snapshot the round state here at round boundaries "
                         "('' = off)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="snapshot every N round boundaries")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir's snapshot (the run "
                         "continues bitwise as if never interrupted)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="serve mode: bind address")
    ap.add_argument("--port", type=int, default=8077,
                    help="serve mode: bind port (0 = ephemeral, printed)")
    ap.add_argument("--serve-token", default="",
                    help="serve mode: shared bearer token ('' = no auth)")
    ap.add_argument("--max-concurrent", type=int, default=16,
                    help="serve mode: concurrent uplink decodes before POSTs "
                         "get 429")
    ap.add_argument("--quota", type=int, default=4,
                    help="serve mode: POSTs per (client, round) before 429")
    ap.add_argument("--linger", type=float, default=15.0,
                    help="serve mode: seconds to keep answering GETs after "
                         "the last close")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default="", help="write round history JSON here")
    ap.add_argument("--obs", default="", choices=("", "off", "basic", "trace"),
                    help="observability mode (default off; --trace / "
                         "--metrics-out imply trace / basic)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON here (Perfetto); "
                         "implies --obs trace")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics / round-record JSONL stream here "
                         "(scripts/obs_report.py reads it); implies --obs "
                         "basic")
    args = ap.parse_args(argv)
    obs_mode = args.obs or ("trace" if args.trace
                            else ("basic" if args.metrics_out else "off"))
    if args.trace and obs_mode != "trace":
        ap.error(f"--trace requires --obs trace (got --obs {obs_mode})")
    if args.mode == "mesh" and args.resume:
        raise ValueError("--resume under --mode mesh, which takes no "
                         "checkpoints")

    device = resolve_device(args.device)
    lora_cfg = LoRAConfig(rank=args.rank, alpha=args.alpha,
                          include_mlp=args.include_mlp)
    fed_cfg = FedConfig(num_clients=args.clients, rounds=args.rounds,
                        local_steps=args.local_steps, method=args.method,
                        assignment=args.assignment, svd_rank=args.svd_rank,
                        client_ranks=tuple(int(x) for x in
                                           args.client_ranks.split(",") if x),
                        client_local_steps=tuple(
                            int(x) for x in args.client_local_steps.split(",")
                            if x),
                        dirichlet_alpha=args.dirichlet_alpha, seed=args.seed,
                        participation=args.participation,
                        min_quorum=args.min_quorum, weighting=args.weighting,
                        round_deadline=args.deadline,
                        straggler_prob=args.stragglers,
                        dropout_prob=args.dropout_prob,
                        async_buffer=args.async_buffer,
                        quantize_uplink=args.quantize_uplink,
                        uplink_max_norm=args.uplink_max_norm,
                        ring_depth=args.ring_depth,
                        close_chunk=args.close_chunk, engine=args.engine,
                        dp_clip=args.dp_clip,
                        dp_noise_multiplier=args.dp_noise,
                        faults=args.faults,
                        uplink_validation=not args.no_uplink_validation,
                        uplink_retries=args.uplink_retries,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every, obs=obs_mode)
    validate_fed_lora(fed_cfg, lora_cfg)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    cfg = get_config(args.arch)
    if args.mode in ("host", "mesh") and cfg.family == "encdec":
        # the reference's loaders yield tokens only, and its loss then
        # fails with KeyError: 'frames'; a caller that supplies frames
        # trains whisper through FederatedTrainer or MeshFederatedTrainer
        raise NotImplementedError(
            f"--mode {args.mode} does not run the encdec config "
            f"{cfg.name!r}: its batches need frames, which the federated "
            "loaders do not carry")
    if args.vocab:
        cfg = replace(cfg, vocab_size=args.vocab)
    cfg = replace(cfg, dtype=args.dtype)
    model = build_model(cfg)
    if args.mode == "serve":
        run_serve(args, model, lora_cfg, fed_cfg, device)
        return
    loaders, eval_batches = build_federated_data(
        args.data_vocab or cfg.vocab_size, args.clients, seq_len=args.seq_len,
        alpha=args.dirichlet_alpha, seed=args.seed,
        batch_size=args.batch_size, device=device)
    train_cfg = TrainConfig(learning_rate=args.lr, schedule="constant",
                            total_steps=args.rounds * args.local_steps)
    if args.mode == "mesh":
        trainer = MeshFederatedTrainer(
            model=model, lora_cfg=lora_cfg, fed_cfg=fed_cfg,
            train_cfg=train_cfg, client_loaders=loaders,
            eval_batches=eval_batches, seed=args.seed, device=device)
        backend = trainer.closer.backend
    else:
        trainer = FederatedTrainer(model=model, lora_cfg=lora_cfg,
                                   fed_cfg=fed_cfg, train_cfg=train_cfg,
                                   client_loaders=loaders,
                                   eval_batches=eval_batches, seed=args.seed,
                                   device=device)
        backend = trainer.engine.backend if trainer.engine else "eager"
        if args.resume:
            trainer.load_state(round_state_path(args.checkpoint_dir))
    history = trainer.run()
    for rec in history:
        print(f"round={rec.round} eval_loss={rec.eval_loss:.4f} "
              f"eval_acc={rec.eval_acc:.4f} "
              f"div={rec.divergence_scaled:.3e} "
              f"client_loss={sum(rec.client_losses) / len(rec.client_losses):.4f}")
    final = history[-1]
    print(f"\nfinal: method={args.method} eval_loss={final.eval_loss:.4f} "
          f"eval_acc={final.eval_acc:.4f} "
          f"divergence={final.divergence_scaled:.3e} "
          f"(device={device}, mode={args.mode}, close backend={backend})")
    if args.mode == "mesh":
        for rnd, pairs in enumerate(trainer.quarantined):
            if pairs:
                print(f"round={rnd} quarantined (client, reason): {pairs}")
    else:
        print_ledger(trainer)
    write_obs(trainer.recorder, args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.__dict__ for r in history], f, indent=2)


if __name__ == "__main__":
    main()
