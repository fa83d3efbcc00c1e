#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --launch-cost SRC   # the launch-path costs only
    python3 chip_smoke.py --decode-sweep      # B3's decode bodies and plans
    python3 chip_smoke.py --prefill-sweep     # B3's bf16 prefill body
    python3 chip_smoke.py --attention-sweep   # B8's bf16 tensor-core body
    python3 chip_smoke.py --obs-http          # phase 6 alone
    python3 chip_smoke.py --mesh              # phase 7 alone
    python3 chip_smoke.py --zoo               # phase 8 alone
    python3 chip_smoke.py --bf16              # phase 9 alone
    python3 chip_smoke.py --moe               # phase 10 alone
    python3 chip_smoke.py --mla               # phase 11 alone
    python3 chip_smoke.py --hybrid            # phase 12 alone
    python3 chip_smoke.py --xlstm             # phase 13 alone
    python3 chip_smoke.py --encdec            # phase 14 alone
    python3 chip_smoke.py --vlm               # phase 15 alone
    python3 chip_smoke.py --dryrun            # phase 16 alone
    python3 chip_smoke.py --fold-check        # phase 3's fedex_fold checks

Needs one CUDA card and ``nvcc``; imports no JAX. It puts ``src`` on
``sys.path`` itself and runs, each phase raising on failure:

1. environment: torch/CUDA versions and the card's name and power limit;
   TF32 off for matmuls and cuDNN (the folds' exactness is f32's), the
   settings read back, and cuBLAS's bf16 reduced-precision reduction read
   back (left at PyTorch's default);
2. build: one ``nvcc`` per kernel source, all in parallel, into
   ``build/kernels/``, with ``-Xptxas -v``; the registers, spills and
   static shared memory of ``factor_mean``'s grouped kernel, of
   ``lora_matmul``'s kernels (the tiled body, its x@a prepasses, the
   tensor-core body, the SIMT and the tensor-core split-K bodies) and of
   ``flash_swa``'s kernels (the
   SIMT body ``flash_swa_tile``, the tensor-core body ``flash_swa_tc``)
   are summed up on lines of their own;
3. kernels: ``fedex_fold`` (both bodies), ``factor_mean`` (both bodies),
   ``product_fold``, ``perclient_fold``, ``hetero_fold`` and
   ``product_accum`` against their plain PyTorch versions at the main
   path's leaf shapes and at edge cases (odd m, n; one lane at rank 8; 3
   live lanes of 8; rank 16; hetero ranks −1, 0 and ragged; a trailing
   chunk with 2 of 4 rows written; masked lanes, unwritten rows and rank
   columns filled with NaN), each timed (:class:`Timer`: host-inclusive
   CUDA-event medians of 20 after warm-up, and for the main body the
   device time, the same with the repetitions queued behind a spin kernel,
   the 50 MB L2 flushed before each repetition) beside its plain version, its bound on the card
   and one PyTorch call that computes the same function: 8
   ``torch.tensordot`` calls against one grouped ``factor_mean`` launch over
   a close's a and b stacks (bitwise the plain version, also over a group
   that mixes 16-byte and 4-byte tensors with NaN / Inf in its zero-weight
   lanes, uniform, and in accumulate mode), or
   ``torch.baddbmm`` over concatenated factors (``fedex_fold``, given ā and
   b̄: W0 + s·[w_0 a_0 | … | −ā] [b_0; …; b̄]; ``product_fold``; each produced
   lane one batch for ``perclient_fold`` and ``hetero_fold``;
   ``acc.baddbmm_`` in place for ``product_accum``), which must agree with
   the kernel within twice its error bound. A ``fedex_fold`` check that
   fails says what it saw (:func:`fold_disagreement`). ``product_accum``
   (B5) must also equal its old body (``product_fold`` with acc as W0 and out)
   bitwise at every checked shape: the main chunk (4 uplinks, r 4), the
   chunk of 64 uplinks at r = 8 that docs/benchmarks.md documents, 16
   lanes at r 64, an a stack off 16-byte alignment (r 3, odd m), zero
   lanes in the middle slots and no lane written (acc unchanged, −0 → +0,
   one launch); both chunks are timed in turns against the old body
   (``prior_ms``) and ``acc.baddbmm_``, the plain version at the main
   chunk only; then the serving kernels:
   ``lora_matmul`` at one layer's q/k/v/o at prefill (M = 8 × 512) and
   decode (M = 8) shapes, the split-K body at M 1, 7, 9 and 16 and r 0,
   16 and 64, at M 7, 9, 16 and 1000 with K 777, N 333, r 1, 16 and 64,
   at the tiled body's edges (M 17 and 4095; r 64 and 0 at the prefill
   q_proj shape; an x view one row into its storage with K 777, so not
   16-byte aligned) and at scale 0 against x@w, each within
   ``lora_matmul_error_bound`` and each run twice, bitwise equal
   (library: ``torch.addmm(x @ w, x @ a, b, alpha=s)``, which must agree
   within the bound too); ``flash_swa`` through ``swa_attention`` at the
   prefill shape (B 8, S 512, GQA 24/8, d 128, causal), at S 500 and 333,
   windows 64, 200 and 1000 (> S), non-causal, and at S 4096 (batch 1)
   causal and with a window of 1024, each run twice and bitwise equal, and
   within rtol 2e-5, atol 4e-5 of ``swa_attention_plain`` at unit-scale
   inputs (library:
   ``scaled_dot_product_attention`` in f32 with ``enable_gqa``, an explicit
   boolean mask for windows; its difference is printed); then
   ``paper-gpt2``'s shapes (:func:`gpt2_kernel_phase`): ``fedex_fold`` and
   ``factor_mean`` over a weighted close's 4 leaves of (12, 768, 768) at 2
   live lanes of 4, ``lora_matmul`` at one layer's q/k/v/o at prefill
   (M = 8 × 512, K = N = 768) and decode (M = 8), ``flash_swa`` at B 8,
   S 512, MHA 12/12, d 64, causal, and ``lora_matmul`` at the serve
   launcher's default prompt (batch 2 × prompt 32, M 64) for both models,
   each checked as above and timed in device time too;
4. main paths: the port's ``FederatedTrainer`` at ``paper-llama3.2-3b``
   full width (28 layers, d 3072, GQA 24/8, vocab 128,256, float32), LoRA
   rank 4, α 8 on q/k/v/o, 4 clients, batch 8 × seq 64 on a 512-token data
   vocabulary, one path after another, each with the launch counters set to
   0 just before it and read just after, and its trainer freed after it:
   * fedex: one uniform full-participation round, then two rounds with
     example weighting at 50% participation (``fedex_fold`` 4 and
     ``factor_mean`` 1 per weighted close: one grouped launch over the a
     and b stacks of the 4 leaves);
   * reinit and keep_local: two rounds each at 50% participation with
     example weighting (``product_fold`` 4; ``perclient_fold`` 4 per close);
   * fedex_svd (r' = 8): two rounds of all 4 clients with example weighting,
     so the residual's rank (up to 12) exceeds r' (``product_fold`` 4 and
     ``factor_mean`` 1 per close);
   * hetero with client ranks (4, 2, 1, 3): two rounds (``hetero_fold`` 4
     per close);
   * the chunked streaming closes (``close_chunk=4``, 6 clients, every
     client each round, example weights, 3 local steps so that the first
     round's A factors differ between clients): fedex (two rounds), then
     reinit,
     keep_local, fedex_svd (r' = 8; the residual has rank up to 20) and
     hetero (ranks 4, 2, 1, 3, 4, 2), one round each. Chunk 0 (slots 0–3)
     and chunk 1 (slots 4 and 5, 2 of its 4 rows written) each fold at
     ingest once their uplinks are in: ``factor_mean`` 2 (one grouped
     launch a chunk, accumulating into the running sums) and
     ``product_accum`` 8 per round (fedex_svd: ``product_accum`` 0), no
     stacked fold kernel. Each fold is timed (eager at ingest, or flushed
     in the close).
   * the paper's baselines, which build no engine: fedit and ffa (two
     rounds each at 50% participation with example weighting, 3 local
     steps) with their eager closes, and centralized (two rounds, one
     worker on client ``round % 4``'s data, no close); no kernel launch;
   * fedex+dp: fedex with every upload's delta clipped to 1 and noised at
     σ = 1e-3 (two rounds at 50% participation with example weighting;
     ``fedex_fold`` 4 and ``factor_mean`` 1 per close);
   * fedex[eager]: the fedex path's weighted rounds with ``engine="off"``,
     the eager close (its §6 divergence included in its time), no kernel
     launch; its close ms is printed beside the kernel close's;
   * the coordinator's policies and the uplink transport
     (:class:`TransportProbe`; the ring's fresh lanes hold NaN, and every
     lane opened but never written must still hold only NaN at its close):
     fedex+deadline (a deadline of 1 sim-second, ``min_quorum`` 2,
     dropout 0.25, stragglers 0.25, example weights, 2 rounds: seed 0's
     draws drop one client out and cut one at the deadline each round),
     fedbuff (FedBuff commits of 2, ``staleness_alpha`` 0.5, ring depth 3,
     example weights, 3 commits, some at staleness 1; the identity at every
     commit, the weights n·(1 + s)^(−α) renormalised, exactly) and
     fedex+int8 (int8 uplinks under ``uplink_max_norm`` 1 at 50%
     participation with example weights, 2 rounds; round 0's first uplink
     scaled × 100 and quarantined; the identity over the decoded uplinks;
     the ledger's uplink bytes params + 4 × leaves; the card's int8 codes
     and scales, and fp16 bits, bitwise the CPU's): ``fedex_fold`` 4 and
     ``factor_mean`` 1 a close, and the codec's ms per uplink on the card
     (encode, decode, validation) for each codec;
   * gpt2-fedex: the fedex path at ``paper-gpt2`` full width (12 layers,
     d 768, MHA 12/12, vocab 50,257, LayerNorm, tanh-GELU MLP, biases,
     learned positions, float32), its biases drawn N(0, 0.02²) from a
     seeded generator (their init is 0): ``fedex_fold`` 4 and
     ``factor_mean`` 1 per weighted close, and every leaf that is not
     adapted (biases, norms, learned positions, the tied embedding)
     bitwise as at the path's start;
   * the fault paths, each against its crash twin (the same seed, the
     faulted clients crashed; the ring's fresh lanes hold NaN, and every
     lane opened and never written must still hold only NaN at its close):
     fedex+faults (6 clients, 3 local steps, 2 rounds of every client,
     example weights; ``FAULT_PLAN``: client 1's uplink poisoned with NaN
     and client 3's truncated, both quarantined, client 5's replayed to the
     round before and dropped by the ring, client 0's first two decodes
     failing and retried, client 2's uplink delivered twice and the copy
     dropped; ``fedex_fold`` 4 and ``factor_mean`` 1 a close) and
     hetero+faults (ranks 4, 2, 1, 3, 4, 2 local steps, one round; NaN on
     client 1, truncation on client 3; ``hetero_fold`` 4): the global
     adapter and the adapted W0 leaves (hetero: each surviving client's
     base and rank-rᵢ adapter) bitwise equal to the twin's;
   * the resume paths: ring-snapshot (a chunked fedex ring at the main
     path's adapter shapes, drawn adapters, 6 lanes in chunks of 2 with raw
     weights, snapshotted after 3 writes, chunk 0 folded at ingest through
     ``factor_mean`` and ``product_accum`` and chunk 1 half written, through
     ``repro_torch.checkpoint`` to a temporary directory under ``build/``,
     loaded into a fresh engine and finished: its close bitwise the
     uninterrupted one's; ``factor_mean`` 6 and ``product_accum`` 24) and
     gpt2-resume (fedex at ``paper-gpt2``'s full width, 3 clients, 2 local
     steps, 3 rounds at 50%, example weights, a cosine schedule, client 1's
     round-1 uplink poisoned; killed after round 1 and resumed in a fresh
     trainer from its snapshot: history, params and global adapter bitwise
     the uninterrupted run's, the quarantine replayed; ``fedex_fold`` 4 and
     ``factor_mean`` 1 a close), each printing the snapshot's bytes and its
     save and load seconds.
   The last round of each path is checked against its exactness identity
   (below), and every path's peak memory is printed, the stacked and the
   chunked path of each method side by side;
5. serving (``serve_phase``), first ``paper-llama3.2-3b``, then
   ``paper-gpt2`` (``lora_matmul`` 48 a prefill and a decode step,
   ``flash_swa`` 12 a prefill, its biases drawn as in phase 4), each at
   full width in float32 with a non-zero rank-4 adapter, batch 8, a 512-token
   ``make_batch_for`` prompt over the full vocabulary, a bf16 cache of 1024
   positions: per-step launch counts (one prefill: ``lora_matmul`` 112,
   ``flash_swa`` 28; one decode step: ``lora_matmul`` 112), the kernel path
   against the plain path, teacher forcing against the training forward,
   the adapter's effect (its docstring has the tolerances); then the main
   path, ``serve(dtype=torch.float32)`` with 32 greedy decode steps and the
   counters set to 0
   just before, printing prefill ms, decode ms/token, tokens/s and peak
   memory, and a ``torch.profiler`` breakdown of one prefill and one decode
   step (device time by kernel, busy share);
6. obs and the HTTP federation service at ``paper-llama3.2-3b``'s full width
   (:func:`obs_http_phase`, ``[obs]`` / ``[http]`` lines), each path with
   the counters set to 0 just before it and read just after:
   * fedex+obs: the fedex path (4 clients, 2 local steps, 1 uniform round
     then 2 at 50% with example weights) with ``obs="trace"`` and again
     with ``obs="off"``: the global adapter and the 4 adapted W0 leaves
     bitwise equal, ``fedex_fold`` 4 and ``factor_mean`` 1 a weighted
     close in both, the same number of synchronising calls in the last
     weighted close (``torch.cuda.set_sync_debug_mode("warn")``), every
     round ``comm_match`` 1, each round's ``close_dispatch_us`` and
     ``close_block_us`` printed, and ``scripts/obs_report.py --check
     --trace`` (a subprocess) on the streams, written under ``build/``;
   * serve-http: a ``FederationServer`` on 127.0.0.1 (an ephemeral port),
     fedex, 4 clients, 2 rounds, example weights, ``obs="trace"``; four
     ``FedClient`` threads POST seeded deltas at the adapter's shapes (b ≠
     0; 9.2 MB each); ``pull_latest``'s adapter and ``X-Fed-W0-Digest``
     bitwise equal to an in-process twin engine (its own W0) fed the same
     payloads through ``decode_into``; ``fedex_fold`` 4 and ``factor_mean``
     1 a close; statuses 401, 403, 400, 409, 422, 429 and 410 probed once
     each; the server's metrics through ``obs_report.py --check``; the POST
     latency, the close's dispatch / block split, the digest seconds and
     the HTTP and overhead bytes printed;
   * pull-serve: ``serve(pull_from=url)`` (batch 2, prompt 32, 4 steps;
     ``lora_matmul`` 112 a prefill and a decode step, ``flash_swa`` 28) on
     the still-running server generates the tokens of ``serve`` given the
     twin's adapter;
   * serve-http-hetero: a hetero server (client ranks 4, 2, 1, 3, 1 round)
     fed ragged POSTs that carry their rank, after the first server is
     freed: every client's base and rank-rᵢ adapter and the hetero digest
     bitwise the twin's; ``hetero_fold`` 4;
7. mesh mode (``mesh_phase``) at ``paper-llama3.2-3b``'s full width: the
   port's ``MeshFederatedTrainer``, 4 lanes of batch 8 × seq 64 stacked
   into one forward and backward, from one draw of the weights that the
   paths share (each its own copy of the adapted W0 leaves); every round's
   training timed, every close's lanes left out of the round filled with
   NaN before it, its launches counted (``factor_mean`` 1 and
   ``fedex_fold`` 4, ``product_fold`` 4 under fedex_svd: the same in
   every round), its identity checked over the round's lanes and its
   outputs finite:
   * mesh-fedex: 3 rounds at 50% participation with example weights;
   * mesh-fedex[host-twin]: 2 full uniform rounds against the host
     ``FederatedTrainer`` at the same seed, draws and data (its uniform
     close launches nothing): client and eval losses within rtol 1e-5,
     divergences rtol 1e-3 / atol 1e-7, W0 and the global adapter within
     1e-2 relative Frobenius and the AdamW separation bound; the stacked
     round's ms printed beside the host's 8 client steps;
   * mesh-budgets: ``client_local_steps`` (1, 2, 2, 1), 2 rounds; in round
     1 (round 0's only live step has lr 0) the budget-1 lanes' losses
     repeat and their adapters equal, bit for bit, an unmasked 1-step
     round's from the same start and batches;
   * mesh-fedex_svd: r' 8, all lanes, example weights, 3 local steps (so
     round 0's lanes differ in a), 2 rounds, ``identity_svd`` at each
     close;
   * mesh+faults: ``nan@1(clients=1,rounds=1)``, 2 rounds: lane 1
     quarantined as ``nonfinite`` and zeroed in round 1 only, the global
     adapter finite, the identity over the survivors;
8. the rest of the dense zoo (``zoo_phase``, ``[zoo]`` lines; ``python3
   chip_smoke.py --zoo`` runs it alone), f32 at full width and depth: first
   the kernels at gemma3-12b's shapes — ``flash_swa`` at head dim 256
   (batch 2, prompt 2048, GQA 16/8) without a window and with its window
   of 1024, ``lora_matmul`` at one layer's q/k/v/o at prefill (M 4096) and
   decode (M 2), ``fedex_fold`` and ``factor_mean`` over a weighted
   close's 8 leaves — each against its plain version and timed beside its
   bound and library call; then gemma3-12b (48 layers, 8 periods of 5
   local layers at window 1024 and 1 global, d 3840, vocab 262,144),
   granite-8b (36 layers, d 4096) and starcoder2-15b (40 layers, d 6144),
   one at a time, each trained (the trainer at batch 8 × seq 64 on the
   512-token data vocabulary, 4 clients: gemma3 1 uniform + 2 rounds at
   50% with example weights, 2 local steps; the others one such weighted
   round of 3 local steps; ``fedex_fold`` one a leaf — 8 at gemma3, q/k/v/o
   of its local and global layers — and ``factor_mean`` 1 a weighted close;
   the folded W0 against its plain fold on the first and the last layer of
   each leaf, :func:`identity_sampled`), then served from its folded W0 and
   global adapter on an f32 cache (:func:`zoo_serve`: gemma3 batch 2 ×
   prompt 2048, the others batch 8 × prompt 512, 32 greedy steps;
   teacher forcing against the training forward; ``flash_swa`` one a layer
   a prefill, gemma3's 40 at window 1024 and 8 global), with its seconds
   and peak memory, and the phase's;
9. serving in bf16, the reference's default dtype (``bf16_phase``,
   ``[bf16]`` lines; ``python3 chip_smoke.py --bf16`` runs it alone):
   B3's and B8's tensor-core bodies' ptxas lines (registers, spills),
   then B3 and B8 in bf16 against their bf16 plain versions within their
   bounds (``lora_matmul_error_bound`` and ``swa_error_bound``, bf16 terms
   included), each run twice and bitwise equal, timed beside the plain
   version, the library call in bf16 (``torch.addmm``, whose bf16 output
   differs by more than the bound and is printed, not held; SDPA with
   ``enable_gqa``) and the bound at HBM's rate and the bf16 tensor-core
   peak (989 TFLOP/s): B3 at each served model's q/k/v/o at its prefill
   and decode rows (paper-llama3.2-3b and paper-gpt2 M 4096 and 8,
   gemma3-12b 4096 and 2; each also at 64; every prefill and M 64 call
   through the tensor-core body, each shape's largest error printed as a
   share of its bound), at r 1, 3 and 64, odd K and N and an x view off
   16-byte alignment (the tiled body); B8 at d 64 (paper-gpt2), 128
   (paper-llama3.2-3b, GQA 24/8) and 256 (gemma3-12b, no window and window
   1024), every call through its tensor-core body
   (``flash_swa.bf16_tc_launches``); both on the exact-rounding probes
   (``kernels/probes.py``, :func:`bf16_probes`) at those shapes, bitwise
   their plain versions and apart from every faulty variant; then
   ``serve()`` with no
   ``dtype`` (the config's bf16) at full width and depth,
   paper-llama3.2-3b and paper-gpt2 at phase 5's shape and gemma3-12b at
   phase 8's (:func:`bf16_serve`: bf16 launches counted apart, B3's 4·L
   of a prefill all through its tensor-core body and none of a decode
   step (``lora_matmul.bf16_tc_launches``), B8's L of a prefill all
   through its tensor-core body (``flash_swa.bf16_tc_launches``: 28, 12
   and 48 in the three ``serve()`` runs), the kernel
   path against the bf16 plain path and both against the f32 serving
   prefill over the same weights, teacher forcing against the bf16
   training forward within ``TF_BF16``, prefill ms, decode ms/token, peak
   GiB and a profile);
10. the MoE family (``moe_phase``, ``[moe]`` lines; ``python3
   chip_smoke.py --moe`` runs it alone): ``mixtral-8x22b`` at full width,
   cut in depth (``MOE_DEPTH``: 4 of its 56 layers in f32, 8 in bf16; a
   layer is ≈ 10 GB in f32). B1 at the up-proj expert leaf (32 × 6144 ×
   16384, 3.2·10⁹ elements) against its plain version in chunks of 8
   matrices, far end included, and B2, B3 and B8 at its shapes, each timed
   beside its plain version, the bound and the library call; one MoE layer
   (ragged, plain and through B3) against the dense oracle; fedex training
   with per-expert adapters (a uniform round, then 50% with example
   weights: ``factor_mean`` 1, ``fedex_fold`` 7), the fold held on experts
   0 and 7 of the first and last layer (``moe_snapshot``); ``serve()`` of
   the folded tree in f32 and of fresh draws in bf16, B3 three launches a
   non-empty expert group; every comparison of two evaluations replays one
   routing (``route_log``) and counts the tokens routed to other experts:
   in f32 at a margin below ``MOE_FLIP_MARGIN``, in bf16 (where roundings
   accumulate over the layers) the kernel path's prefill logits, routing
   and teacher-forced decode held against the f32 answer over the same
   weights, widened a layer at a time, as phase 9 holds its serves;
11. Multi-head Latent Attention on the MoE stack (``mla_phase``, ``[mla]``
   lines; ``--mla``): ``deepseek-v2-236b`` at full width, cut in depth
   (``DS_DEPTH``), trained and served as phase 10 runs mixtral;
12. the hybrid family (``hybrid_phase``, ``[zb]`` lines; ``--hybrid``):
   ``zamba2-7b`` at full width and depth (``ZB_DEPTH``: 81 Mamba2 layers,
   13 applications of the one shared attention + MLP block). B1 at the
   stacked in_proj leaf (78 × 3584 × 14,576, 4.07·10⁹ elements) in
   8-matrix chunks against its plain version, B2 over a close's 16 stacks,
   B3 at in_proj and out_proj (f32 and bf16, M 4096 and 8: every body) and
   B8 at the shared block's head dim 112 (f32 and bf16), each timed beside
   its plain version, the bound and the library call, and the d-112 and
   projection probes bitwise; fedex training (a uniform round, then 50%
   with example weights: ``factor_mean`` 1, ``fedex_fold`` 8); ``serve()``
   of the folded tree in f32 and of fresh draws in bf16 (B3 214 a prefill
   and a decode step, B8 13 a prefill), the kernel path against the plain
   path, teacher forcing, in bf16 against the f32 answer widened a layer at
   a time; the Mamba2 state's bytes a sequence and the shared KV cache's
   bytes a token;
13. the ssm family (``xlstm_phase``, ``[xl]`` lines; ``--xlstm``):
   ``xlstm-1.3b`` at full width and depth (``XL_DEPTH``: 48 blocks, 6
   periods of 7 mLSTM + 1 sLSTM; d 2048, 4 heads, the mLSTM's head dim
   1024; ≈ 3.50·10⁹ parameters). B1 at the stacked q_proj leaf (42 × 4096
   × 4096, 7.05·10⁸ elements) in 8-matrix chunks against its plain
   version, B2 over a close's 16 stacks, B3 at an mLSTM block's five
   projections and the sLSTM's w_gates (``xl``) and at its FFN's two at K
   or N 2730 (``xl_ffn``: in bf16 the SIMT bodies) in f32 and bf16 at M
   4096 and 8, each timed beside its plain version, the bound and the
   library call, and the projection probes bitwise; fedex training (a
   uniform round, then 50% with example weights: ``factor_mean`` 1,
   ``fedex_fold`` 8); ``serve()`` of the folded tree in f32 and of fresh
   draws in bf16 (B3 228 a prefill and a decode step, 216 of them through
   the tensor-core bodies in bf16; the prompt of 512 two mLSTM chunks of
   256), the kernel path against the plain path and teacher forcing in
   f32 each within its tolerance plus three times the model's own f32
   spread (the plain path again with every projection summed over K in
   two halves: a random xLSTM multiplies an f32 rounding difference by
   ≈ 10⁵ over 48 blocks), in bf16 against the f32 answer widened a block
   at a time, and period 0 a block at a time against each block's f32
   answer (at full depth the bf16 logits part from the f32 answer by
   about the logit scale, the plain path's as much); the recurrent
   state's bytes a sequence;
14. the encdec family (``whisper_phase``, ``[wh]`` lines; ``--encdec``):
   ``whisper-medium`` at full width and depth, trained given loaders that
   add frames and served in f32 and bf16;
15. the vlm family (``vlm_phase``, ``[vl]`` lines; ``--vlm``):
   ``internvl2-76b`` at full width (d 8192, GQA 64/8, d_ff 28,672, vocab
   128,256, 256 vision tokens), cut in depth (``VL_DEPTH``: 12 of its 80
   layers in f32, 24 in bf16). B1 at the stacked q_proj leaf (12 × 8192 ×
   8192) in 8-matrix chunks against its plain version, B2 over a close's 8
   stacks, B3 at a layer's q/k/v/o (K 8192, N 8192 and 1024) at M 4096
   and 8 in f32 and bf16, B8 at the prefill (B 8, S 512, GQA 64/8, d 128)
   in f32 and bf16, each timed beside its plain version, the bound and the
   library call, and the probes at these shapes bitwise; fedex training as
   the reference's launchers train it, a text-only LM on the launcher's
   tokens-only loaders (both rounds at 50% with example weights:
   ``factor_mean`` 1 and ``fedex_fold`` 4 a close, each fold held on the
   first and the last layer of each leaf); one client step on a batch
   with vision embeddings, its loss the text positions' CE alone;
   ``serve()`` of the folded tree in f32 and of fresh draws in bf16 at
   batch 8 × a prompt of 256 vision + 256 text tokens, 16 decode steps
   from the prefill's true length (B3 4·L a prefill and a decode step, B8
   L a prefill), the kernel path against the plain path, teacher forcing
   over all 16 steps, the first step at the reference's serve position
   (+256) printed, bf16 against the f32 answer widened a layer at a time;
16. the dry run and the roofline on one H100 (``dryrun_phase``, ``[dry]``
   lines; ``--dryrun``): (a) ``repro_torch.launch.dryrun``'s record of
   every assigned architecture × assigned shape, on the meta device in
   this process, each ``ok`` or skipped where the reference skips; (b)
   ``paper-llama3.2-3b``'s three steps at full width and depth, each at
   the largest global batch whose dry-run peak is under 70 GiB (train in
   f32 at train_4k's 4096 tokens, 2 microbatches; prefill in bf16 at
   prefill_32k's 32,768 tokens, through B3's and B8's tensor-core bodies;
   decode in bf16 against a 32,768-slot cache, through B3's split-K body):
   the dry run's FLOPs, bytes and peak, the same step counted on the card
   (FLOPs and bytes equal to the meta count), the median step ms of 3
   after a warm-up (CUDA events), the measured peak
   (``max_memory_allocated`` over the state's baseline) within 10% of the
   dry run's, MODEL_FLOPS, the model TFLOP/s and MFU, and the roofline
   bound with the step's share of it; the last run's outputs finite and of
   their shapes (train's loss, gnorm and LoRA; the logits; decode's next
   tokens their argmax); the launches through the tensor-core bodies
   counted too; then B3 at the serving steps' own shapes (M = B·S for
   prefill, B for decode; layer 0's q/k/v/o with the steps' weights and b
   draws, r 16, bf16), each call through the step's body, against the
   plain version within ``lora_matmul_error_bound``; (c) B8 at S 32,768
   (batch 1, GQA 24/8, d 128, bf16): its last 512 query rows against the
   plain version over all 32,768 keys within ``swa_error_bound``, timed
   beside SDPA;
17. one JSON line with every ported kernel: ``ms`` and ``library_ms``
   host-inclusive, ``device_ms`` and ``library_device_ms`` device time
   (:meth:`Timer.device`), at the main body; B2's row adds one close's launch path
   (``close_wall_us``, ``close_enqueue_us``: :func:`launch_cost`), B3's
   its decode body at one decode layer (``decode_ms``,
   ``decode_library_ms``, ``decode_bound_ms``, ``decode_device_ms``,
   ``decode_library_device_ms``, ``decode_wall_us``,
   ``decode_enqueue_us``), B8's the S 4096 cases (``S4096_*`` causal,
   ``W1024_*`` with the window: ``ms``, ``plain_ms``, ``library_ms``,
   ``bound_ms``, ``device_ms``, ``library_device_ms``); the same six
   fields at ``paper-gpt2``'s shapes as ``gpt2_*`` on the rows of B1, B2,
   B3 (prefill layer; ``gpt2_decode_*`` the decode layer) and B8, and at
   the serve launcher's default prompt as ``M64_*`` (paper-llama3.2-3b)
   and ``gpt2_M64_*`` on B3's row; at gemma3-12b's shapes (phase 8) as
   ``gemma3_*`` on the rows of B1, B2, B3 (prefill layer;
   ``gemma3_decode_*`` the decode layer) and B8 (``gemma3_W1024_*`` with
   the window); in bf16 (phase 9) as ``bf16_*`` on B3's row (Llama's
   prefill layer; ``bf16_decode_*``, ``bf16_M64_*``, ``gpt2_bf16_*``,
   ``gpt2_bf16_decode_*``, ``gpt2_bf16_M64_*``, ``gemma3_bf16_*``,
   ``gemma3_bf16_decode_*``, ``gemma3_bf16_M64_*``)
   and on B8's (Llama's prefill;
   ``bf16_gpt2_*``, ``bf16_gemma3_*``, ``bf16_gemma3_W1024_*``), with
   ``bf16_launches`` (phase 9's ``serve()`` runs; B3's and B8's rows
   also ``bf16_tc_launches``, those through their tensor-core bodies) and
   ``bf16_max_abs_err`` (``max_abs_err`` stays the f32 checks'); at
   mixtral-8x22b's shapes (phase 10) as ``mixtral_*`` on the rows of B1
   (the up-proj expert leaf) and B2 (a close's 14 stacks), on B3's
   ``mixtral_bf16_*`` and ``mixtral_bf16_decode_*`` (one layer's q/k/v/o),
   ``mixtral_expert_*`` (f32), ``mixtral_expert_bf16_*`` and
   ``mixtral_expert_bf16_decode_*`` (the expert projections), on B8's
   ``mixtral_*`` and ``mixtral_bf16_*``, with ``mixtral_bf16_launches``
   and ``mixtral_bf16_tc_launches`` (B3's also
   ``mixtral_bf16_tc_decode_launches``) of its bf16 ``serve()`` run and
   ``mixtral_bf16_max_abs_err`` (its bf16 kernel checks'); at
   deepseek-v2-236b's (phase 11) as ``ds_*`` and at zamba2-7b's (phase
   12) as ``zb_*`` likewise (B3's ``zb``, ``zb_decode``, ``zb_bf16``,
   ``zb_bf16_decode``: in_proj and out_proj; B8's ``zb`` and ``zb_bf16``
   at d 112) and at xlstm-1.3b's (phase 13) as ``xl_*`` on the rows of
   B1, B2 and B3 (B3's ``xl``, ``xl_decode``, ``xl_bf16``,
   ``xl_bf16_decode`` and ``xl_ffn_*`` likewise, with
   ``xl_bf16_launches``, ``xl_bf16_tc_launches``,
   ``xl_bf16_tc_decode_launches`` and ``xl_bf16_max_abs_err``), at
   whisper-medium's (phase 14) as ``wh_*`` and at internvl2-76b's (phase
   15) as ``vl_*`` on the rows of B1, B2, B3 (``vl``, ``vl_decode``,
   ``vl_bf16``, ``vl_bf16_decode``) and B8 (``vl``, ``vl_bf16``), with
   ``vl_launches`` (phase 15's main paths: training, the f32 and the bf16
   ``serve()``) and ``vl_bf16_launches``,
   ``vl_bf16_tc_launches`` (B3's also ``vl_bf16_tc_decode_launches``) and
   ``vl_bf16_max_abs_err`` of its bf16 ``serve()`` run; phase 16's B3 and
   B8 launches as ``dry_launches``, B3's errors at the prefill and decode
   steps' shapes as ``dry_prefill_max_abs_err`` and
   ``dry_decode_max_abs_err``, and B8 at S 32,768 as ``S32768_*``
   (``plain_ms`` None: the plain version's scores there are 103 GB); then
   the result line.

``--launch-cost SRC`` runs :func:`launch_cost` alone on the port found
under ``SRC`` (another tree's ``src`` too, to compare two trees in one
call) and prints it as one JSON line; ``--decode-sweep`` times B3's
decode bodies: the SIMT split-K body in f32 at every plan, then at each
served model's bf16 decode shapes the tensor-core split-K body at every
plan beside the SIMT body and ``addmm`` bf16, and each decode layer
(:func:`decode_sweep`, :func:`bf16_decode_sweep`); ``--prefill-sweep``
times B3's bf16 tensor-core body one projection at a time, at r 0 to 64,
beside cuBLAS's bare bf16 x@W (:func:`prefill_sweep`);
``--attention-sweep`` times B8's bf16 tensor-core body beside SDPA in bf16
at d 64, 128 and 256, windows included, in TFLOP/s and as a share of the
bound (:func:`attention_sweep`); ``--obs-http`` runs
phase 6 alone (:func:`obs_http_phase`), ``--mesh`` phase 7
(:func:`mesh_phase`), ``--zoo`` phase 8 (:func:`zoo_phase`), ``--bf16``
phase 9 (:func:`bf16_phase`), ``--moe`` phase 10 (:func:`moe_phase`),
``--mla`` phase 11 (:func:`mla_phase`), ``--hybrid`` phase 12
(:func:`hybrid_phase`), ``--xlstm`` phase 13 (:func:`xlstm_phase`),
``--encdec`` phase 14 (:func:`whisper_phase`), ``--vlm`` phase 15
(:func:`vlm_phase`), ``--dryrun`` phase 16 (:func:`dryrun_phase`), and ``--fold-check`` phase 3's main-shape
``fedex_fold`` checks (:func:`fold_check_main`).

Identities, per adapted leaf, on the last round of each path:
* fedex: new_W0 + s·ā b̄ = old_W0 + s·Σ_c w_c a_c b_c;
* reinit: new_W0 = old_W0 + s·Σ_c w_c a_c b_c;
* keep_local, each delivered i: new_W0ᵢ + s·aᵢbᵢ = old_W0ᵢ + s·Σ_j w_j a_j b_j;
* hetero, each lane i: new_W0ᵢ + s·a′ᵢb′ᵢ = old_W0ᵢ + s·Σ_j w_j (a_j∘mask_j) b_j;
* fedex_svd: on layer 0 of ``k_proj``, new_W0 − old_W0 equals s times the
  rank-r' truncation of the residual from a dense float64
  ``torch.linalg.svd`` on the host, and has rank ≤ r'; the part the cut
  drops exceeds 10 × the check's tolerance;
* the chunked paths: the same identities against a float64 computation on
  the host from the round's uplinks and normalised raw weights
  (``identity_host``);
* the zoo paths: the folded W0 against the plain fold on the first and
  the last layer of each adapted leaf (``identity_sampled``);
* fedex+dp, fedex[eager], gpt2-fedex, the coordinator paths and the
  fault paths: the fedex (hetero+faults: the hetero) identity over the
  delivered subset, over the privatized uploads
  for fedex+dp and the decoded uploads for fedex+int8 (the residual
  absorbs whatever the clients sent);
* fedit: global a and b = Σ_c w_c a_c and Σ_c w_c b_c against float64 on
  the card, within 2·(C + 2) unit roundoffs of Σ_c |w_c| |x_c| (the weight's
  rounding to f32, C products and C − 1 additions); W0 bitwise as at the
  path's start; the divergence > 0;
* ffa: every upload's a bitwise equal to the others'; global b as fedit's;
  W0 bitwise as at the path's start; the divergence < 1e-6;
* centralized: W0 bitwise as at the path's start and every divergence 0.

Tolerances. ``factor_mean`` rounds each product and sum like separate
PyTorch ops, in the same slot order, so it must match its plain version
within 2·C unit roundoffs of Σ|w||x| at every leaf, and bitwise over a
close's group and the group edge cases. The folds sum
the same terms in the same lane order as their plain versions, but their
rank-r dot products are FMA-contracted in another order than
``torch.matmul``; each is held to its error bound (``fold_error_bound``,
``product_error_bound``, ``perclient_error_bound``,
``hetero_error_bound``): 2·(C + r + 4) unit roundoffs of the magnitudes
each element carries, e.g. |W0| + |s|·(Σ|w||a||b| + |ā||b̄|) for the fedex
fold. The identities are held to the same bounds (``product_accum``'s is
``product_error_bound`` with acc as W0). The fedex_svd check is
held to the f32 rounding of W0 (2 unit roundoffs of |old W0| + |new W0|,
in Frobenius norm) plus 1e-4 of the fold's norm: the factored truncation
squares the Grams and keeps about half of the f32 digits.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


def _port_module(rel: str):
    """A module of this checkout's port that imports only torch and numpy,
    loaded from its file under ``src/repro_torch`` without importing the
    package (``--launch-cost SRC`` imports another tree's port)."""
    path = SRC / "repro_torch" / rel
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{path.stem}", path)
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except FileNotFoundError:
        sys.exit(f"chip_smoke: the port's sources are missing ({path}) — "
                 "run it from a checkout of the repository")
    return module


# the H100 SXM data sheet's rates and B3's and B8's work, as the port states
# them
_roofline = _port_module("launch/roofline.py")
port_cost = _port_module("util/cost.py")
HBM_BYTES_PER_S = _roofline.HBM_BYTES_PER_S
F32_FLOPS_PER_S = _roofline.F32_FLOPS_PER_S
BF16_FLOPS_PER_S = _roofline.BF16_FLOPS_PER_S
U = 2.0 ** -24
REPS, WARMUP = 20, 3


def template_args(mangled: str) -> list:
    """The template arguments at the start of ``mangled`` (what follows a
    kernel name's ``I``, up to its ``E``): literals ``Lb1E`` (true),
    ``Li16E`` (16), builtin types (``f``: float) and length-prefixed names
    (``13__nv_bfloat16``: bf16)."""
    args, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":
            j = mangled.index("E", i)
            lit = mangled[i + 1:j]
            args.append({"b0": "false", "b1": "true"}.get(lit, lit[1:]))
            i = j + 1
        elif mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group(0)
            start = i + len(n)
            ident = mangled[start:start + int(n)]
            args.append("bf16" if "bfloat16" in ident else ident)
            i = start + int(n)
        else:
            args.append({"f": "float"}.get(mangled[i], mangled[i]))
            i += 1
    return args


def ptxas_summary(text: str, prefix: str) -> list:
    """One line per kernel whose name starts with ``prefix``, from ``nvcc
    -Xptxas -v`` output: registers, spill stores/loads and static shared
    memory."""
    lines, out = text.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        fn = line.split("'")[1]
        # the mangled name: the identifier (lower case) ends at the template
        # arguments (I Lb1E Li16E ... E) or at the nested name's end (E)
        found = re.search(re.escape(prefix) + r"[a-z0-9_]*", fn)
        if found is None:
            continue
        name, rest = found.group(0), fn[found.end():]
        if rest.startswith("I"):
            name += f"<{', '.join(template_args(rest[1:]))}>"
        props = " ".join(lines[i + 1:i + 4])
        regs = props.split("Used ")[1].split(" registers")[0]
        stores = props.split(" bytes spill stores")[0].rsplit(" ", 1)[-1]
        loads = props.split(" bytes spill loads")[0].rsplit(" ", 1)[-1]
        smem = (props.split(" bytes smem")[0].rsplit(" ", 1)[-1]
                if " bytes smem" in props else "0")
        out.append(f"{name}: {regs} registers, spill stores {stores} B, "
                   f"spill loads {loads} B, static shared memory {smem} B")
    return out


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
    """Two clocks for ``fn`` on the card, each over REPS repetitions after
    WARMUP, the L2 flushed before each repetition:
    * ``timer(fn)``: host-inclusive ms, the median of CUDA-event pairs
      around each repetition (the events are queued by the host, so for a
      launch-bound job this is the host's launch path);
    * ``timer.device(fn, floor_ms)``: device ms, the median of CUDA-event
      pairs around each repetition with every repetition queued behind a
      spin kernel (``torch.cuda._sleep``), so the device runs them back to
      back and no launch gap of the host's lands between a pair. The same
      method for a kernel and for a library call. The spin lasts twice the
      host's time to queue the repetitions (from the warm-up's), and the
      time counts only when the spin still ran after the last one was
      queued (one retry with a spin four times as long) and is not below
      ``floor_ms`` (the bound of the work: less is not possible); else it
      is None, printed as not measured. A function whose launch path waits
      for the device (a synchronous copy) cannot be timed so.
      ``torch.profiler`` dropped records in long runs (a flush recorded 19
      times of 20, a kernel 5 times of 20), so it is not used here."""

    CYCLES_PER_S = 2e9  # above the H100's 1.98 GHz boost clock

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

    def device(self, fn, floor_ms=0.0):
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(WARMUP):
            self.flush.zero_()
            fn()
        host_s = (time.perf_counter() - t) * REPS / WARMUP
        spin_s = min(2 * host_s + 2e-3, 0.2)
        why = "the spin ended before the last repetition was queued"
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda._sleep(int(spin_s * self.CYCLES_PER_S))
            gate = torch.cuda.Event()
            gate.record()
            pairs = []
            for _ in range(REPS):
                self.flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            queued = not gate.query()
            torch.cuda.synchronize()
            if queued:
                ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
                if ms >= floor_ms:
                    return ms
                why = f"{ms:.4f} ms < bound {floor_ms:.4f} ms"
                break
            spin_s *= 4
        print(f"  device time not measured ({why})", flush=True)
        return None


def fmt_ms(v) -> str:
    """A time of :meth:`Timer.device` as printed: ms, or not measured."""
    return "not measured" if v is None else f"{v:.4f} ms"


def share(bound, v) -> str:
    """`` (x% of the bound)`` for a measured device time, else nothing."""
    return "" if v is None else f" ({bound / v:.0%} of the bound)"


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def main_path_leaves(cfg):
    """(name, L, m, n) of the adapted leaves of the main path; a
    local/global config's (gemma3's) local and global leaves apart, each
    with its stacked layers flattened into L, as the folds take them."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = [("q_proj", d, cfg.num_heads * hd),
              ("k_proj", d, cfg.num_kv_heads * hd),
              ("v_proj", d, cfg.num_kv_heads * hd),
              ("o_proj", cfg.num_heads * hd, d)]
    stacks = [("", cfg.num_layers)]
    if cfg.local_global_ratio:
        nper = cfg.num_layers // (cfg.local_global_ratio + 1)
        stacks = [("local/", nper * cfg.local_global_ratio),
                  ("global/", nper)]
    return [(prefix + name, L, m, n) for prefix, L in stacks
            for name, m, n in shapes]


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
    """(max err, ok, what a failure saw: "" when ok)."""
    got = kernels.fedex_fold(w0, a, b, scale, weights=w)
    torch.cuda.synchronize()
    want = kernels.fedex_fold_plain(w0, a, b, scale, w)
    bound = kernels.fold_error_bound(w0, a, b, scale, w)
    err = (got - want).abs()
    ok = bool((err <= bound).all())
    seen = "" if ok else fold_disagreement(torch, kernels, (w0, a, b, scale,
                                                            w), got, want,
                                           bound)
    return float(err.max()), ok, seen


def fold_disagreement(torch, kernels, args, got, want, bound) -> str:
    """What a failed ``fedex_fold`` check saw, for its error message: the
    elements outside the bound, the non-finite counts, the worst element,
    whether a second launch and a second plain evaluation repeat the first
    bit for bit, and the card's ECC error counts, clock and temperature."""
    w0, a, b, scale, w = args
    bad = ~((got - want).abs() <= bound)
    worst = torch.where(bad, (got - want).abs().nan_to_num(math.inf), -1.0)
    at = tuple(int(i) for i in torch.unravel_index(worst.argmax(),
                                                   worst.shape))
    again = kernels.fedex_fold(w0, a, b, scale, weights=w)
    torch.cuda.synchronize()
    plain_again = kernels.fedex_fold_plain(w0, a, b, scale, w)
    try:
        smi = " | ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=ecc.errors.corrected.volatile.total,"
             "ecc.errors.uncorrected.volatile.total,clocks.sm,temperature.gpu",
             "--format=csv"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not read ({e})"
    return (f"{int(bad.sum())} of {bad.numel()} elements outside the bound; "
            f"non-finite: kernel {int((~got.isfinite()).sum())}, plain "
            f"{int((~want.isfinite()).sum())}, bound "
            f"{int((~bound.isfinite()).sum())}; worst at {at}: kernel "
            f"{float(got[at])!r}, plain {float(want[at])!r}, bound "
            f"{float(bound[at])!r}; a second launch bitwise the first: "
            f"{bool(torch.equal(bits(torch, again), bits(torch, got)))}; a "
            "second plain evaluation bitwise the first: "
            f"{bool(torch.equal(bits(torch, plain_again), bits(torch, want)))}"
            f"; nvidia-smi: {smi}")


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


def bound_ms(nbytes, flops, peak=F32_FLOPS_PER_S):
    """The least time of a call (ms) and what sets it: its bytes at HBM's
    rate or its operations at ``peak`` (f32's; bf16 work: the tensor
    cores' ``BF16_FLOPS_PER_S``, the least time the card could take)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, kernels, device, cfg, *, c, r, scale,
                 bodies=("weighted-partial", "weighted-full", "uniform"),
                 edges=True):
    """Both bodies of both kernels against their plain versions at the main
    path's shapes (``bodies``: the live lanes of a close) and, with
    ``edges``, at edge cases; timings at the main path's shapes."""
    timer = Timer(torch, device)
    leaves = main_path_leaves(cfg)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0}
    timings = {}
    live_sets = {"weighted-partial": (0, 1), "weighted-full": tuple(range(c)),
                 "uniform": tuple(range(c))}
    for body in bodies:
        live = live_sets[body]
        weighted = body != "uniform"
        bufs = []
        for i, (name, L, m, n) in enumerate(leaves):
            w0, a, b, w = make_inputs(torch, device, c, (L,), m, n, r, live,
                                      seed=i)
            wts = w if weighted else None
            err, ok, seen = check_fold(torch, kernels, w0, a, b, scale, wts)
            errs["fedex_fold"] = max(errs["fedex_fold"], err)
            print(f"  fedex_fold[{body}] {cfg.name} {name} ({L},{m},{n}) "
                  f"C={c} r={r}: "
                  f"max_abs_err={err:.3e} within bound={ok}", flush=True)
            if not ok:
                raise AssertionError(f"fedex_fold[{body}] {name} disagrees "
                                     f"with its plain version: {seen}")
            for fac in (a, b):
                err, ok, same = check_mean(torch, kernels, fac, wts)
                errs["factor_mean"] = max(errs["factor_mean"], err)
                if not ok:
                    raise AssertionError(f"factor_mean[{body}] {name} "
                                         "disagrees with its plain version")
            print(f"  factor_mean[{body}] {name} a/b: bitwise={same}",
                  flush=True)
            # B1's function as one library call, given ā and b̄:
            # W0 + s·[w_0 a_0 | … | −ā] [b_0; …; b̄]
            wl = (wts if wts is not None
                  else torch.full((c,), 1.0 / c, device=device))
            abar = kernels.factor_mean_plain(a, wl)
            bbar = kernels.factor_mean_plain(b, wl)
            lib_a = torch.cat([wl[j] * a[j] for j in live] + [-abar], dim=-1)
            lib_b = torch.cat([b[j] for j in live] + [bbar], dim=-2)
            bufs.append((w0, a, b, wts, torch.empty_like(w0), lib_a, lib_b))
            del abar, bbar

        # the library call's result against the kernel's, on the first leaf
        w0, a, b, wts, out, lib_a, lib_b = bufs[0]
        lib_out = torch.baddbmm(w0, lib_a, lib_b, alpha=scale)
        kernels.fedex_fold(w0, a, b, scale, weights=wts, out=out)
        lib_diff = (lib_out - out).abs()
        if not bool((lib_diff <= 2 * kernels.fold_error_bound(
                w0, a, b, scale, wts)).all()):
            raise AssertionError(f"fedex_fold[{body}]: the library call "
                                 "disagrees with the kernel")
        print(f"  fedex_fold[{body}] baddbmm vs kernel: max diff "
              f"{float(lib_diff.max()):.3e}", flush=True)
        del lib_out, lib_diff

        def fold_library():
            for w0, _, _, _, out, lib_a, lib_b in bufs:
                torch.baddbmm(w0, lib_a, lib_b, alpha=scale, out=out)

        def fold_kernel():
            for w0, a, b, wts, out, _, _ in bufs:
                kernels.fedex_fold(w0, a, b, scale, weights=wts, out=out)

        def fold_plain():
            for w0, a, b, wts, *_ in bufs:
                kernels.fedex_fold_plain(w0, a, b, scale, wts)

        # one close's means: a and b of the 4 leaves, one grouped launch
        group = [x for _, a, b, *_ in bufs for x in (a, b)]
        got = kernels.factor_mean_group(group, wts)
        torch.cuda.synchronize()
        if not all(torch.equal(bits(torch, g), bits(
                torch, kernels.factor_mean_plain(x, wts)))
                   for g, x in zip(got, group)):
            raise AssertionError(f"factor_mean[{body}]: one close's grouped "
                                 "means are not bitwise the plain version")
        print(f"  factor_mean[{body}] one grouped launch over the close's "
              f"{len(group)} stacks: bitwise=True", flush=True)
        del got

        def mean_kernel():
            kernels.factor_mean_group(group, wts)

        def mean_plain():
            for _, a, b, wts, *_ in bufs:
                kernels.factor_mean_plain(a, wts)
                kernels.factor_mean_plain(b, wts)

        def mean_library():
            for _, a, b, wts, *_ in bufs:
                wl = (wts if wts is not None
                      else torch.full((c,), 1.0 / c, device=device))
                torch.tensordot(wl, a, dims=1)
                torch.tensordot(wl, b, dims=1)

        c_live = len(live)
        # device times at the main path's body (2 live lanes of 4) only
        main = body == "weighted-partial"
        fb = bound_ms(*fold_cost(leaves, c_live, r))
        mb = bound_ms(*mean_cost(leaves, c_live, r))
        t = {"fedex_fold": (timer(fold_kernel), timer(fold_plain),
                            timer(fold_library), fb,
                            timer.device(fold_kernel, fb[0]) if main else None,
                            timer.device(fold_library, fb[0]) if main
                            else None),
             "factor_mean": (timer(mean_kernel), timer(mean_plain),
                             timer(mean_library), mb,
                             timer.device(mean_kernel, mb[0]) if main else None,
                             timer.device(mean_library, mb[0]) if main
                             else None)}
        for name, (ms, plain, lib, (bms, by), dev, dev_lib) in t.items():
            print(f"  time {name}[{body}] {cfg.name} one close "
                  f"({len(leaves)} leaves"
                  f"{', one grouped launch' if name == 'factor_mean' else ''}"
                  f"): kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
                  f"{lib:.4f} ms ({'baddbmm' if name == 'fedex_fold' else '8 tensordot'}), "
                  f"bound {bms:.4f} ms ({by})"
                  + (f"; device time kernel {fmt_ms(dev)}, library "
                     f"{fmt_ms(dev_lib)}" if main else ""), flush=True)
        timings[body] = t
        del bufs
        torch.cuda.empty_cache()

    # edge cases, both bodies: (C, L, m, n, r, live lanes)
    edge_cases = [(3, 2, 1000, 777, 4, (0, 1, 2)), (1, 2, 512, 640, 4, (0,)),
                  (8, 2, 384, 256, 4, (1, 4, 6)),
                  (4, 2, 256, 384, 16, (0, 1, 2, 3)),
                  (20, 2, 96, 200, 4, tuple(range(17)))]
    for c_e, L, m, n, r_e, live in edge_cases if edges else []:
        w0, a, b, w = make_inputs(torch, device, c_e, (L,), m, n, r_e, live,
                                  seed=99)
        for wts in (w, None):
            err, ok, seen = check_fold(torch, kernels, w0, a, b, scale, wts)
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
                                     f"[{body}] disagrees: {seen}")
    if edges:
        mean_group_edges(torch, kernels, device)
    return errs, timings


def mean_group_edges(torch, kernels, device):
    """``factor_mean_group`` bitwise against ``factor_mean_plain`` in one
    launch each: a group mixing 16-byte and 4-byte tensors (odd counts; a
    stack one lane into its storage with an odd lane stride) with NaN / Inf
    in its zero-weight lanes (weighted), the same group uniform, and
    accumulate mode (acc + mean, as the chunked fold's acc.add_)."""
    g = torch.Generator(device=device)
    g.manual_seed(7)
    c = 6
    shapes = [(c, 28, 3072, 4), (c, 28, 4, 1024), (c, 3, 1000, 3),
              (c, 3, 3, 777), (c + 1, 2, 33, 5)]
    stacks = [torch.randn(*sh, device=device, generator=g) for sh in shapes]
    stacks[-1] = stacks[-1][1:]  # base 660 bytes in, lane stride 165
    w = torch.rand(c, device=device, generator=g) + 0.1
    w[1] = w[4] = 0.0
    w = w / w.sum()
    clean = [x.clone() for x in stacks]
    for x in stacks:
        x[1] = float("nan")
        x[4] = float("inf")
    cases = [("weighted, NaN/Inf lanes", stacks, w, False),
             ("uniform", clean, None, False),
             ("accumulate, NaN/Inf lanes", stacks, w, True)]
    for label, group, wts, acc in cases:
        priors = [torch.randn(*x.shape[1:], device=device, generator=g)
                  for x in group]
        out = [p.clone() for p in priors] if acc else None
        before = kernels.factor_mean.launches
        got = kernels.factor_mean_group(group, wts, out=out, accumulate=acc)
        torch.cuda.synchronize()
        ok = kernels.factor_mean.launches == before + 1
        for x, o, p in zip(clean, got, priors):
            want = kernels.factor_mean_plain(x, wts)
            ok = ok and torch.equal(bits(torch, o), bits(
                torch, p + want if acc else want))
        print(f"  factor_mean group edge [{label}] over {len(group)} stacks "
              "(16-byte and 4-byte tensors): one launch and bitwise the "
              f"plain version={ok}", flush=True)
        if not ok:
            raise AssertionError(f"factor_mean group edge [{label}] "
                                 "disagrees")


# --------------------------------------------------------------------------
# phase 3b: the per-lane folds (product_fold, perclient_fold, hetero_fold)
# --------------------------------------------------------------------------

def poison(torch, a, b, live, ranks=None):
    """Fill the lanes outside ``live`` and, with ``ranks``, each lane's
    rank columns past its rank with NaN: the kernels must never read them."""
    nan = float("nan")
    for lane in range(a.shape[0]):
        if lane not in live:
            a[lane] = nan
            b[lane] = nan
        elif ranks is not None and 0 <= ranks[lane] < a.shape[-1]:
            a[lane, ..., ranks[lane]:] = nan
            b[lane, ..., ranks[lane]:, :] = nan


def hetero_ranks(c, r, live):
    """−1 (full), ragged and 0 ranks over the live lanes, 0 elsewhere."""
    cycle = [-1, max(1, r // 2), 1, 0]
    ranks = [0] * c
    for j, lane in enumerate(live):
        ranks[lane] = cycle[j % len(cycle)]
    return ranks


def raw_weights(torch, device, c, live):
    """The chunk's raw ingest weights: example counts 40, 65, 90, … on the
    live lanes (written rows), 0 elsewhere."""
    s = torch.zeros(c, device=device)
    for j in live:
        s[j] = 40.0 + 25.0 * j
    return s


def bits(torch, x):
    x = x.contiguous()
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def lane_case(torch, kernels, device, kind, c, lead, m, n, r, live, ranks,
              scale, seed, a_offset=0):
    """One kernel call against its plain version; returns (max err, ok).
    ``a_offset`` > 0 hands the kernel a view of a larger a stack that starts
    that many lanes in (a base that need not be 16-byte aligned)."""
    w0, a, b, w = make_inputs(torch, device, c + a_offset, lead, m, n, r,
                              live, seed)
    a, b = a[a_offset:], b[:c]
    poison(torch, a, b, live, ranks if kind == "hetero" else None)
    if kind == "accum":  # w0 plays the accumulator, s the raw ingest weights
        s = raw_weights(torch, device, c, live)
        if not live:  # signed zeros: the fold turns -0 into +0, nothing else
            w0[..., 0, :5] = -0.0
        before = kernels.product_accum.launches
        acc, prior = w0.clone(), w0.clone()
        kernels.product_accum(acc, a, b, s, 1.0)
        kernels.product_fold(prior, a, b, s, 1.0, out=prior)  # the old body
        torch.cuda.synchronize()
        want = [kernels.product_accum_plain(w0, a, b, s, 1.0)]
        bound = [kernels.product_accum_error_bound(w0, a, b, s, 1.0)]
        # bitwise the old body's result, in one launch; acc + 0 when no
        # lane is written
        exact = (torch.equal(bits(torch, acc), bits(torch, prior))
                 and kernels.product_accum.launches == before + 1
                 and (bool(live) or torch.equal(bits(torch, acc),
                                                bits(torch, w0 + 0.0))))
        if not exact:
            print(f"  product_accum C={c} m={m} n={n} r={r} differs from the "
                  "old body's bits or did not launch once", flush=True)
            return float((acc - want[0]).abs().max()), False
        got = [acc]
    elif kind == "product":
        s = w.clone()
        s[live[0]] = -s[live[0]]  # signed
        got = [kernels.product_fold(w0, a, b, s, scale)]
        torch.cuda.synchronize()
        want = [kernels.product_fold_plain(w0, a, b, s, scale)]
        bound = [kernels.product_error_bound(w0, a, b, s, scale)]
    else:
        lanes = [w0 + 0.001 * i if i in live else None for i in range(c)]
        if kind == "perclient":
            args = (lanes, a, b, w)
            fold, plain, err_bound = (kernels.perclient_fold,
                                      kernels.perclient_fold_plain,
                                      kernels.perclient_error_bound)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(seed + 1)
            oa = torch.empty(*lead, m, r, device=device).normal_(
                0.0, 0.02, generator=g)
            ob = torch.empty(*lead, r, n, device=device).normal_(
                0.0, 0.01, generator=g)
            rk = torch.tensor(ranks, dtype=torch.int32, device=device)
            args = (lanes, a, b, w, rk, oa, ob)
            fold, plain, err_bound = (kernels.hetero_fold,
                                      kernels.hetero_fold_plain,
                                      kernels.hetero_error_bound)
        got = fold(*args, scale)
        torch.cuda.synchronize()
        want = plain(*args, scale)
        bound = err_bound(*args, scale)
    err, ok = 0.0, True
    for g_, w_, b_ in zip(got, want, bound):
        if g_ is None:
            continue
        e = (g_ - w_).abs()
        err = max(err, float(e.max()))
        ok = ok and bool((e <= b_).all()) and bool(torch.isfinite(g_).all())
    return err, ok


def lane_cost(leaves, kind, c_live, k_live, k_out, r):
    """Bytes (each input read once, each output written once) and flops of
    one close's folds over ``leaves``: ``k_live`` / ``k_out`` are the rank
    columns of the weighted lanes and of the produced lanes' own products."""
    nbytes = flops = 0
    for _, L, m, n in leaves:
        mn, fac = L * m * n, L * (m + n)
        if kind in ("product", "accum"):
            nbytes += 8 * mn + 4 * fac * sum(k_live)
            flops += mn * (sum(2 * k + 2 for k in k_live) + 2)
        else:
            nbytes += 8 * len(k_out) * mn + 4 * fac * sum(k_live)
            flops += mn * (sum(2 * k + 2 for k in k_live)
                           + sum(2 * k + 3 for k in k_out))
            if kind == "hetero":
                nbytes += 4 * fac * r  # A', B'
    return nbytes, flops


def lane_timing_buffers(torch, kernels, device, kind, c, L, m, n, r, live,
                        ranks, k_live, scale, seed):
    """One leaf's inputs for timing a per-lane fold, as closures: ``kernel``
    (into preallocated outputs), ``plain``, ``library`` (one
    ``torch.baddbmm`` that computes the same function) and ``check``, which
    returns (library result, kernel result, the fold's error bound) from
    fresh calls. For perclient and hetero the produced lanes' W0 and outputs
    are views of one (C_out, L, m, n) stack each, so the library call needs
    no copy: lane c's batch is W0_c + s·[w_0 a_0 | … | −a_c] [b_0; …; b_c],
    each lane's factors cut to its rank k_j, the own term (A′ for hetero)
    zero-padded to r. For accum (``product_accum``) the kernel, the old
    body (``prior``: ``product_fold`` with acc as W0 and out) and the
    library call each accumulate into their own copy of acc, in place:
    acc.baddbmm_([s_0 a_0 | …], [b_0; …]) with s the raw ingest weights."""
    w0, a, b, w = make_inputs(torch, device, c, (L,), m, n, r, live, seed)
    if kind == "accum":
        w = raw_weights(torch, device, c, live)
    wa = [w[j] * a[j][..., :k] for j, k in zip(live, k_live)]
    bs = [b[j][..., :k, :] for j, k in zip(live, k_live)]
    ac, bc = torch.cat(wa, dim=-1), torch.cat(bs, dim=-2)
    if kind == "accum":
        acc, acc_prior, acc_lib = w0.clone(), w0.clone(), w0.clone()

        def check():
            x = kernels.product_accum(w0.clone(), a, b, w, 1.0)
            return (w0.clone().baddbmm_(ac, bc), x,
                    kernels.product_accum_error_bound(w0, a, b, w, 1.0))

        return {"kernel": lambda: kernels.product_accum(acc, a, b, w, 1.0),
                "prior": lambda: kernels.product_fold(acc_prior, a, b, w, 1.0,
                                                      out=acc_prior),
                "plain": lambda: kernels.product_accum_plain(w0, a, b, w,
                                                             1.0),
                "library": lambda: acc_lib.baddbmm_(ac, bc), "check": check}
    if kind == "product":
        out = torch.empty_like(w0)

        def check():
            lib = torch.baddbmm(w0, ac, bc, alpha=scale)
            kernels.product_fold(w0, a, b, w, scale, out=out)
            return lib, out, kernels.product_error_bound(w0, a, b, w, scale)

        return {"kernel": lambda: kernels.product_fold(w0, a, b, w, scale,
                                                       out=out),
                "plain": lambda: kernels.product_fold_plain(w0, a, b, w,
                                                            scale),
                "library": lambda: torch.baddbmm(w0, ac, bc, alpha=scale,
                                                 out=out),
                "check": check}
    offsets = torch.tensor([0.001 * j for j in live], device=device)
    stack = w0 + offsets.view(-1, 1, 1, 1)
    ostack = torch.empty_like(stack)
    del w0
    lanes, outs = [None] * c, [None] * c
    for p, j in enumerate(live):
        lanes[j], outs[j] = stack[p], ostack[p]
    if kind == "perclient":
        args = (lanes, a, b, w)
        fold, plain, err_bound = (kernels.perclient_fold,
                                  kernels.perclient_fold_plain,
                                  kernels.perclient_error_bound)
        own = [(-a[j], b[j]) for j in live]
    else:
        rk = torch.tensor(ranks, dtype=torch.int32, device=device)
        oa, ob = a[0].clone(), b[0].clone()
        args = (lanes, a, b, w, rk, oa, ob)
        fold, plain, err_bound = (kernels.hetero_fold,
                                  kernels.hetero_fold_plain,
                                  kernels.hetero_error_bound)
        own = [(torch.nn.functional.pad(-oa[..., :k], (0, r - k)), ob)
               for k in k_live]
    acs = torch.stack([torch.cat(wa + [x], dim=-1) for x, _ in own])
    bcs = torch.stack([torch.cat(bs + [y], dim=-2) for _, y in own])
    inp, ao = stack.view(-1, m, n), ostack.view(-1, m, n)
    acs, bcs = acs.view(-1, m, acs.shape[-1]), bcs.view(-1, bcs.shape[-2], n)

    def check():
        lib = torch.baddbmm(inp, acs, bcs, alpha=scale)
        fold(*args, scale, out=outs)
        bound = torch.stack([x for x in err_bound(*args, scale)
                             if x is not None]).view(-1, m, n)
        return lib, ao, bound

    return {"kernel": lambda: fold(*args, scale, out=outs),
            "plain": lambda: plain(*args, scale),
            "library": lambda: torch.baddbmm(inp, acs, bcs, alpha=scale,
                                             out=ao),
            "check": check}


def lane_kernel_phase(torch, kernels, device, cfg, *, c, r, scale):
    """The per-lane folds at the main path's leaf shapes (checked per leaf,
    then timed over one close's 4 leaves) and at edge cases. Returns the
    max errors, the timings (kernel, plain, library, bound) of each body,
    and ``product_accum``'s old-body times (``prior``) of each accum body."""
    timer = Timer(torch, device)
    leaves = main_path_leaves(cfg)
    errs = {"product_fold": 0.0, "perclient_fold": 0.0, "hetero_fold": 0.0,
            "product_accum": 0.0}
    timings, prior = {}, {}
    # the main paths' bodies: reinit and keep_local at 2 live lanes of 4,
    # the svd fold (one lane at r' = 8), hetero at ranks (4, 2, 1, 3), the
    # chunked closes' partial fold of a full chunk of 4 uplinks, and of the
    # chunk of 64 uplinks at r = 8 that docs/benchmarks.md documents
    bodies = {
        "product_fold": ("product", 4, r, (0, 1), None),
        "product_fold[svd]": ("product", 1, 8, (0,), None),
        "perclient_fold": ("perclient", 4, r, (0, 1), None),
        "hetero_fold": ("hetero", 4, r, (0, 1, 2, 3), [4, 2, 1, 3]),
        "product_accum": ("accum", 4, r, (0, 1, 2, 3), None),
        "product_accum[C64r8]": ("accum", 64, 8, tuple(range(64)), None),
    }
    for body, (kind, c_b, r_b, live, ranks) in bodies.items():
        name = body.split("[")[0]
        for i, (leaf, L, m, n) in enumerate(leaves):
            err, ok = lane_case(torch, kernels, device, kind, c_b, (L,), m,
                                n, r_b, live, ranks, scale, seed=10 + i)
            errs[name] = max(errs[name], err)
            print(f"  {body} {leaf} ({L},{m},{n}) C={c_b} r={r_b} live="
                  f"{live if len(live) < 8 else f'{len(live)} lanes'}: "
                  f"max_abs_err={err:.3e} within bound"
                  f"{' and bitwise equal to the old body' if kind == 'accum' else ''}"
                  f"={ok}", flush=True)
            if not ok:
                raise AssertionError(f"{body} {leaf} disagrees with its "
                                     "plain version")
            torch.cuda.empty_cache()
        # timing over one close's leaves
        k_live = [r_b if ranks is None else (r_b if ranks[j] < 0 else ranks[j])
                  for j in live]
        bufs = [lane_timing_buffers(torch, kernels, device, kind, c_b, L, m,
                                    n, r_b, live, ranks, k_live, scale,
                                    seed=20 + i)
                for i, (_, L, m, n) in enumerate(leaves)]

        def run(part):
            def fn():
                for buf in bufs:
                    buf[part]()
            return fn

        if kind == "accum":
            # in turns: B5, the old body, the library call, (the plain
            # version at the main shape only), the old body, B5
            t1, p1, lib_ms = (timer(run("kernel")), timer(run("prior")),
                              timer(run("library")))
            plain = timer(run("plain")) if c_b == c else None
            p2, t2 = timer(run("prior")), timer(run("kernel"))
            ms, prior[body] = (t1 + t2) / 2, (p1 + p2) / 2
            print(f"  time {body}: B5 {t1:.4f} / {t2:.4f} ms, old body "
                  f"{p1:.4f} / {p2:.4f} ms", flush=True)
        else:
            lib_ms = timer(run("library"))
        # the library call's result against the kernel's, on the first leaf
        lib_out, kern_out, bound = bufs[0]["check"]()
        lib_err = float((lib_out - kern_out).abs().max())
        if not bool(((lib_out - kern_out).abs() <= 2 * bound).all()):
            raise AssertionError(f"{body}: the library call disagrees with "
                                 "the kernel")
        del lib_out, kern_out, bound
        if kind != "accum":
            ms, plain = timer(run("kernel")), timer(run("plain"))
        k_out = [] if kind in ("product", "accum") else k_live
        bms, by = bound_ms(*lane_cost(leaves, kind, len(live), k_live, k_out,
                                      r_b))
        dev, dev_lib = (timer.device(run("kernel"), bms),
                        timer.device(run("library"), bms))
        timings[body] = (ms, plain, lib_ms, (bms, by), dev, dev_lib)
        print(f"  time {body} one close (4 leaves, {len(live)} live): kernel "
              f"{ms:.4f} ms"
              + (f", old body {prior[body]:.4f} ms" if body in prior else "")
              + (f", plain {plain:.4f} ms" if plain is not None else "")
              + f", library {lib_ms:.4f} ms (baddbmm, max |library − kernel| "
              f"{lib_err:.3e}), bound {bms:.4f} ms ({by}, {bms / ms:.0%} of "
              f"it reached); device time kernel {fmt_ms(dev)}, library "
              f"{fmt_ms(dev_lib)}", flush=True)
        del bufs
        torch.cuda.empty_cache()

    # edge cases: (C, L, m, n, r, live lanes); NaN in every masked lane and
    # (hetero) every masked rank column
    for c_e, L, m, n, r_e, live in [(3, 2, 1000, 777, 4, (0, 1, 2)),
                                    (1, 2, 512, 640, 8, (0,)),
                                    (8, 2, 384, 256, 4, (1, 4, 6)),
                                    (4, 2, 256, 384, 16, (0, 1, 2, 3))]:
        ranks = hetero_ranks(c_e, r_e, live)
        for kind in ("product", "perclient", "hetero"):
            err, ok = lane_case(torch, kernels, device, kind, c_e, (L,), m, n,
                                r_e, live, ranks, scale, seed=99)
            errs[kind + "_fold"] = max(errs[kind + "_fold"], err)
            print(f"  edge {kind}_fold C={c_e} L={L} m={m} n={n} r={r_e} "
                  f"live={live}{f' ranks={ranks}' if kind == 'hetero' else ''}"
                  f": err {err:.3e} ok={ok}", flush=True)
            if not ok:
                raise AssertionError(f"edge case {kind}_fold C={c_e} m={m} "
                                     f"n={n} r={r_e} disagrees")
    # product_accum, each also bitwise against the old body: odd m, n (the
    # 4-byte copy variant); rank 16; a trailing chunk with 2 of its 4 rows
    # written; one lane; 16 lanes at rank 64 (32 slabs of the K axis); an a
    # stack that starts one lane into its storage (r = 3, odd m: a base off
    # 16-byte alignment); zero lanes in the middle slots (1, 3); no lane
    # written (acc unchanged but -0 -> +0). NaN in every unwritten row.
    for c_e, L, m, n, r_e, live, off in [
            (4, 2, 1000, 777, 4, (0, 1, 2, 3), 0),
            (4, 2, 256, 384, 16, (0, 1, 2, 3), 0),
            (4, 2, 384, 256, 4, (0, 1), 0),
            (1, 2, 512, 640, 4, (0,), 0),
            (16, 2, 256, 384, 64, tuple(range(16)), 0),
            (4, 3, 255, 384, 3, (0, 1, 2, 3), 1),
            (4, 2, 384, 256, 4, (0, 2), 0),
            (4, 2, 256, 384, 4, (), 0)]:
        err, ok = lane_case(torch, kernels, device, "accum", c_e, (L,), m, n,
                            r_e, live, None, scale, seed=99, a_offset=off)
        errs["product_accum"] = max(errs["product_accum"], err)
        print(f"  edge product_accum C={c_e} L={L} m={m} n={n} r={r_e} "
              f"written={live}{f' a offset {off} lane' if off else ''}: err "
              f"{err:.3e} ok (bound, bitwise old body, one launch)={ok}",
              flush=True)
        if not ok:
            raise AssertionError(f"edge case product_accum C={c_e} m={m} "
                                 f"n={n} r={r_e} disagrees")
    return errs, timings, prior


# --------------------------------------------------------------------------
# phase 3c: the serving kernels (lora_matmul, flash_swa)
# --------------------------------------------------------------------------

def serving_projections(cfg):
    """(name, K, N) of the adapted projections of one layer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return [("q_proj", d, cfg.num_heads * hd),
            ("k_proj", d, cfg.num_kv_heads * hd),
            ("v_proj", d, cfg.num_kv_heads * hd),
            ("o_proj", cfg.num_heads * hd, d)]


def lora_inputs(torch, device, m, k, n, r, seed):
    """Unit-scale x, w, a, b (N(0, 1), as the reference's kernel tests)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(*shape, device=device, generator=g)
            for shape in ((m, k), (k, n), (k, r), (r, n))]


def lora_cost(shapes, r, elem=4):
    """Bytes (each input read once at ``elem`` bytes an element, the f32
    output written once) and flops of lora_matmul over (M, K, N) shapes:
    ``port_cost.lora_matmul_work``'s, the flops with the epilogue's scale
    and add (2·M·N) besides."""
    nbytes = flops = 0
    for m, k, n in shapes:
        f, b = port_cost.lora_matmul_work(m, k, n, r, elem)
        nbytes += b
        flops += f + 2 * m * n
    return nbytes, flops


def lora_case(torch, kernels, timer, bufs, scale, label, device_times=False):
    """Check lora_matmul on each (x, w, a, b) of ``bufs`` against its plain
    version (and the library call against the kernel) within
    lora_matmul_error_bound, and a second run bitwise against the first,
    then time all of them together: kernel, plain, library
    (``torch.addmm(x @ w, x @ a, b, alpha=s)``, cuBLAS, TF32 off) and the
    bound; with ``device_times`` also the kernel's and the library call's
    device time. bf16 operands: the bound has its bf16 term; the library
    call runs in bf16 on the tensor cores and rounds x@w, x@a and its
    output to bf16, so its difference is printed, not held; bytes at 2 an
    input element, the bound's operations at the bf16 tensor-core peak.
    Prints the largest error as a share of the bound. Returns (max
    error, (ms, plain, library, bound, device ms, library device ms)).
    """
    low = bufs[0][0].dtype == torch.bfloat16
    err = lib_err = worst = 0.0
    for x, w, a, b in bufs:
        got = kernels.lora_matmul(x, w, a, b, scale)
        again = kernels.lora_matmul(x, w, a, b, scale)
        torch.cuda.synchronize()
        want = kernels.lora_matmul_plain(x, w, a, b, scale)
        lib = torch.addmm(x @ w, x @ a, b, alpha=scale)
        bound = kernels.lora_matmul_error_bound(x, w, a, b, scale)
        e = (got - want).abs()
        err = max(err, float(e.max()))
        worst = max(worst, float((e / bound.clamp_min(
            torch.finfo(torch.float32).tiny)).max()))
        lib_err = max(lib_err, float((lib.float() - got).abs().max()))
        ok = bool((e <= bound).all()) and (low or bool(
            ((lib - got).abs() <= bound).all()))
        if not ok:
            raise AssertionError(f"lora_matmul {label} {tuple(x.shape)} x "
                                 f"{tuple(w.shape)} r={a.shape[1]}: disagrees "
                                 f"with its plain version or the library "
                                 f"call (max err {err:.3e})")
        if not torch.equal(bits(torch, got), bits(torch, again)):
            raise AssertionError(f"lora_matmul {label} {tuple(x.shape)} x "
                                 f"{tuple(w.shape)}: two runs differ")
        del got, again, want, lib, bound, e

    def kernel():
        for buf in bufs:
            kernels.lora_matmul(*buf, scale)

    def library():
        for x, w, a, b in bufs:
            torch.addmm(x @ w, x @ a, b, alpha=scale)

    r = bufs[0][2].shape[1]
    bound = bound_ms(*lora_cost([(x.shape[0], x.shape[1], w.shape[1])
                                 for x, w, _, _ in bufs], r, 2 if low else 4),
                     BF16_FLOPS_PER_S if low else F32_FLOPS_PER_S)
    t = (timer(kernel),
         timer(lambda: [kernels.lora_matmul_plain(*buf, scale)
                        for buf in bufs]),
         timer(library), bound,
         timer.device(kernel, bound[0]) if device_times else None,
         timer.device(library, bound[0]) if device_times else None)
    ms, plain, lib, (bms, by), dev, dev_lib = t
    print(f"  lora_matmul[{label}] max_abs_err={err:.3e} within bound "
          f"(largest error {worst:.3e} of it)"
          + (f" (bf16; addmm bf16 {lib_err:.3e} off)" if low else "")
          + f", two runs bitwise equal; time kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {lib:.4f} ms (addmm), bound {bms:.4f} "
          f"ms ({by})"
          + (f"; device time kernel {fmt_ms(dev)}{share(bms, dev)}, "
             f"library {fmt_ms(dev_lib)}" if device_times else ""),
          flush=True)
    return err, t


def visible_mask(torch, device, sq, sk, causal, window, q0=0):
    """The visible (query, key) pairs as a boolean (Sq, Sk) mask, the query
    rows at positions q0 … q0 + Sq − 1."""
    qpos = torch.arange(q0, q0 + sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    return mask


def flash_case(torch, kernels, timer, device, b, s, h, kvh, d, causal, window,
               seed, device_times=False, dtype=None, tc=False, sk=0):
    """swa_attention (B, S, H, D) against swa_attention_plain within the
    reference's f32 tolerance (rtol 2e-5, atol 4e-5) at unit-scale inputs,
    k and v of ``sk`` rows (0: S; a cross-attention's Sq ≠ Sk),
    and a second run bitwise against the first; timed beside the plain
    version, the bound (4·d flops per visible pair) and
    ``scaled_dot_product_attention`` in f32 (is_causal, enable_gqa; an
    explicit boolean mask for windows). ``dtype`` bf16: the inputs rounded
    to bf16, held to ``swa_error_bound`` (its bf16 terms), SDPA in bf16,
    bytes at 2 an element and the bound's operations at the bf16
    tensor-core peak; ``tc``: both runs must take B8's tensor-core body
    (``bf16_tc_launches``), else neither. Returns (max error, timings)."""
    import torch.nn.functional as F
    sk = sk or s
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(b, s, h, d, device=device, generator=g)
    k = torch.randn(b, sk, kvh, d, device=device, generator=g)
    v = torch.randn(b, sk, kvh, d, device=device, generator=g)
    low = dtype == torch.bfloat16
    if low:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = kernels.flash_swa.bf16_tc_launches
    got = kernels.swa_attention(q, k, v, causal, window)
    again = kernels.swa_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    if kernels.flash_swa.bf16_tc_launches - before != 2 * tc:
        raise AssertionError(f"flash_swa B={b} S={s} d={d}: "
                             f"{kernels.flash_swa.bf16_tc_launches - before}"
                             f" of 2 runs took the tensor-core body, not "
                             f"{2 * tc}")
    if not torch.equal(bits(torch, got), bits(torch, again)):
        raise AssertionError(f"flash_swa B={b} S={s} window={window}: two "
                             "runs differ")
    del again
    want = kernels.swa_attention_plain(q, k, v, causal, window)
    e = (got.float() - want.float()).abs()
    err = float(e.max())
    tol = (kernels.swa_error_bound(q, k, v, causal, window) if low
           else 4e-5 + 2e-5 * want.abs())
    mask = visible_mask(torch, device, s, sk, causal, window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window:
        kw = {"attn_mask": mask}
    else:
        kw = {"is_causal": causal}
    lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    label = (f"B={b} S={s}{f' Sk={sk}' if sk != s else ''} H={h}/{kvh} "
             f"d={d} {'causal' if causal else 'non-causal'} window={window}")
    # the library call is a yardstick only: its difference is printed
    lib_err = float((lib.transpose(1, 2).float() - got.float()).abs().max())
    if not bool((e <= tol).all()):
        raise AssertionError(f"flash_swa {label}: max err {err:.3e} vs the "
                             "plain version")
    del got, want, e, lib, tol
    flops, nbytes = port_cost.attention_work(b, s, sk, h, kvh, d, causal,
                                             window, 2 if low else 4)

    def kernel():
        kernels.swa_attention(q, k, v, causal, window)

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)

    bound = bound_ms(nbytes, flops,
                     BF16_FLOPS_PER_S if low else F32_FLOPS_PER_S)
    t = (timer(kernel),
         timer(lambda: kernels.swa_attention_plain(q, k, v, causal, window)),
         timer(library), bound,
         timer.device(kernel, bound[0]) if device_times else None,
         timer.device(library, bound[0]) if device_times else None)
    ms, plain, libt, (bms, by), dev, dev_lib = t
    print(f"  flash_swa[{label}{' bf16' if low else ''}] max_abs_err="
          f"{err:.3e} (SDPA {lib_err:.3e}), "
          f"two runs bitwise equal; time kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {libt:.4f} ms (SDPA), bound {bms:.4f} ms "
          f"({by})"
          + (f"; device time kernel {fmt_ms(dev)}{share(bms, dev)}, "
             f"library {fmt_ms(dev_lib)}" if device_times else ""),
          flush=True)
    return err, t


def serving_kernel_phase(torch, kernels, device, cfg, *, batch, prompt, r,
                         scale):
    """B3 at one layer's four projections at prefill (M = batch·prompt) and
    decode (M = batch) shapes, odd sizes at r 1 and 16, the tiled body's
    edges (M 17 and 4095, r 64 and 0 at the prefill q_proj shape, an x view
    off 16-byte alignment), and scale 0 against the base product; B8 at the
    prefill shape (GQA through ``swa_attention``) and at S 500 and 333,
    windows 64, 200 and one larger than S, non-causal, and at S 4096 (batch
    1) causal and with a window of 1024. Each case checked and timed (the
    prefill and S 4096 cases also in device time)."""
    timer = Timer(torch, device)
    projs = serving_projections(cfg)
    errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    for label, m in (("prefill", batch * prompt), ("decode", batch)):
        bufs = [lora_inputs(torch, device, m, k, n, r, seed=30 + i)
                for i, (_, k, n) in enumerate(projs)]
        err, timings[f"lora_matmul[{label}]"] = lora_case(
            torch, kernels, timer, bufs,
            scale, f"{label} layer: q/k/v/o at M={m}", device_times=True)
        errs["lora_matmul"] = max(errs["lora_matmul"], err)
        del bufs
    # odd sizes on both bodies; the split-K body at M 1, 7, 9 and 16 and r
    # 0, 16 and 64 at the decode widths; the tiled body's edges: its first
    # M (17), rows ragged against its 128-row tile (4095), r 64 and r 0 (x@w
    # alone) at the prefill q_proj shape
    d, nq, nkv = projs[0][1], projs[0][2], projs[1][2]
    for m, k, n, r_e in [(7, 777, 333, 1), (7, 777, 333, 16),
                         (9, 777, 333, 16), (16, 777, 333, 64),
                         (1, d, nq, r), (7, d, nkv, r), (9, d, nkv, r),
                         (16, d, nq, r), (batch, d, nkv, 0),
                         (batch, d, nkv, 16), (batch, d, nq, 64),
                         (1000, 777, 333, 16), (17, d, nq, r),
                         (4095, d, nkv, r), (batch * prompt, d, nq, 64),
                         (batch * prompt, d, nq, 0)]:
        bufs = [lora_inputs(torch, device, m, k, n, r_e, seed=m + r_e)]
        err, _ = lora_case(torch, kernels, timer, bufs, scale,
                           f"edge M={m} K={k} N={n} r={r_e}")
        errs["lora_matmul"] = max(errs["lora_matmul"], err)
        del bufs
    # x one row into its storage with an odd K: not 16-byte aligned, so the
    # tiled body takes its 4-byte copies
    x, w, a, b = lora_inputs(torch, device, 1001, 777, 333, r, seed=9)
    view = [x[1:], w, a, b]
    if view[0].data_ptr() % 16 == 0:
        raise AssertionError("the misaligned case is 16-byte aligned")
    err, _ = lora_case(torch, kernels, timer, [view], scale,
                       "x view one row in, M=1000 K=777 N=333")
    errs["lora_matmul"] = max(errs["lora_matmul"], err)
    del x, w, a, b, view
    x, w, a, b = lora_inputs(torch, device, 4096, 3072, 1024, r, seed=5)
    got = kernels.lora_matmul(x, w, a, b, 0.0)
    base = torch.matmul(x, w)
    e = (got - base).abs()
    if not bool((e <= kernels.lora_matmul_error_bound(x, w, a, b, 0.0)).all()):
        raise AssertionError("lora_matmul at scale 0 is not the base product")
    print(f"  lora_matmul[scale 0] vs x@w: max diff {float(e.max()):.3e} "
          "within bound", flush=True)
    del x, w, a, b, got, base, e
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cases = {"prefill": (batch, prompt, h, kvh, hd, True, 0),
             "S500": (4, 500, h, kvh, hd, True, 0),
             "S333": (4, 333, h, kvh, hd, True, 0),
             "window64": (4, 512, h, kvh, hd, True, 64),
             "window200": (4, 500, h, kvh, hd, True, 200),
             "window1000": (4, 500, h, kvh, hd, True, 1000),
             "non-causal": (4, 333, h, kvh, hd, False, 0),
             "S4096": (1, 4096, h, kvh, hd, True, 0),
             "S4096-window1024": (1, 4096, h, kvh, hd, True, 1024)}
    for i, (label, case) in enumerate(cases.items()):
        err, t = flash_case(torch, kernels, timer, device, *case,
                            seed=40 + i, device_times=label in (
                                "prefill", "S4096", "S4096-window1024"))
        errs["flash_swa"] = max(errs["flash_swa"], err)
        timings[f"flash_swa[{label}]"] = t
    torch.cuda.empty_cache()
    return errs, timings


def short_prompt_rows():
    """M of the serve launcher's default prompt (batch_size × prompt_len
    of ``repro_torch.launch.serve.serve``: 2 × 32)."""
    import inspect

    from repro_torch.launch.serve import serve
    params = inspect.signature(serve).parameters
    return params["batch_size"].default * params["prompt_len"].default


def gpt2_kernel_phase(torch, kernels, device, cfg, gcfg, *, batch, prompt, r,
                      scale):
    """B3 and B8 at ``gcfg``'s (paper-gpt2's) serving shapes, held and
    timed as :func:`serving_kernel_phase` holds the main model's: B3 at one
    layer's q/k/v/o at prefill (M = batch·prompt) and decode (M = batch),
    B8 at the prefill shape (MHA, d 64); then B3 at the serve launcher's
    default prompt (M 64) for ``gcfg`` and ``cfg``. Every case in device
    time too. Returns (max errors, timings)."""
    timer = Timer(torch, device)
    errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    m64 = short_prompt_rows()
    for key, mcfg, m in (("gpt2", gcfg, batch * prompt),
                         ("gpt2_decode", gcfg, batch),
                         ("gpt2_M64", gcfg, m64), ("M64", cfg, m64)):
        bufs = [lora_inputs(torch, device, m, k, n, r, seed=50 + i)
                for i, (_, k, n) in enumerate(serving_projections(mcfg))]
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{mcfg.name} layer: q/k/v/o at M={m}", device_times=True)
        errs["lora_matmul"] = max(errs["lora_matmul"], err)
        del bufs
    err, timings["flash_gpt2"] = flash_case(
        torch, kernels, timer, device, batch, prompt, gcfg.num_heads,
        gcfg.num_kv_heads, gcfg.resolved_head_dim, True, 0, seed=60,
        device_times=True)
    errs["flash_swa"] = err
    torch.cuda.empty_cache()
    return errs, timings


def timing_fields(prefix, t):
    """A timing tuple as the kernels line's ``<prefix>_*`` fields."""
    ms, plain, lib_ms, (bms, _), dev, dev_lib = t
    return {f"{prefix}_ms": ms, f"{prefix}_plain_ms": plain,
            f"{prefix}_library_ms": lib_ms, f"{prefix}_bound_ms": bms,
            f"{prefix}_device_ms": dev, f"{prefix}_library_device_ms": dev_lib}


# --------------------------------------------------------------------------
# phase 4: the main paths
# --------------------------------------------------------------------------

# name → (FedConfig fields, rounds, clients, local steps,
#          {kernel: launches per close per leaf}, {kernel: launches per close})
CHUNKED = {"close_chunk": 4, "weighting": "examples"}
# a chunked round of 6 clients folds 2 chunks: per chunk one grouped
# factor_mean launch (a and b of every leaf) and per leaf one product_accum
CHUNK_FOLDS = ({"product_accum": 2}, {"factor_mean": 2})
PARTIAL = {"participation": 0.5, "weighting": "examples"}
# client 0's first two decodes fail (two retries), client 2's uplink is
# delivered twice (the ring drops the copy); 1, 3 and 5 never land
FAULT_PLAN = ("nan@1(clients=1);truncate@1(clients=3);replay@1(clients=5);"
              "decode_error@1(clients=0,count=2);duplicate@1(clients=2)")
HETERO_FAULT_RANKS = (4, 2, 1, 3, 4)
PATHS = {
    "fedex": ({}, 3, 4, 2, {"fedex_fold": 1}, {"factor_mean": 1}),
    "reinit": ({"assignment": "reinit", "participation": 0.5,
                "weighting": "examples"}, 2, 4, 2, {"product_fold": 1}, {}),
    "keep_local": ({"assignment": "keep_local", "participation": 0.5,
                    "weighting": "examples"}, 2, 4, 2, {"perclient_fold": 1},
                   {}),
    # all 4 clients: the residual has rank up to 3r = 12, so r' = 8 cuts it
    # (at 2 clients it has rank ≤ r = 4 and the cut would change nothing)
    "fedex_svd": ({"method": "fedex_svd", "svd_rank": 8,
                   "weighting": "examples"}, 2, 4, 2,
                  {"product_fold": 1}, {"factor_mean": 1}),
    "hetero": ({"method": "hetero", "client_ranks": (4, 2, 1, 3)}, 2, 4, 2,
               {"hetero_fold": 1}, {}),
    # the chunked streaming closes: 6 clients, chunks of 4 (the second
    # holds slots 4 and 5, 2 of its 4 rows written), example weights. 3
    # local steps: the schedule's step 0 has lr 0 and b starts at 0, so in a
    # path's first round the A factors move only from step 2 on, and with 2
    # steps every client would uplink the same A (a zero residual)
    "fedex[chunked]": (CHUNKED, 2, 6, 3, *CHUNK_FOLDS),
    "reinit[chunked]": ({"assignment": "reinit", **CHUNKED}, 1, 6, 3,
                        *CHUNK_FOLDS),
    "keep_local[chunked]": ({"assignment": "keep_local", **CHUNKED}, 1, 6, 3,
                            *CHUNK_FOLDS),
    # 6 clients: the residual has rank up to 5r = 20, so r' = 8 cuts it
    "fedex_svd[chunked]": ({"method": "fedex_svd", "svd_rank": 8,
                            **CHUNKED}, 1, 6, 3, {}, {"factor_mean": 2}),
    "hetero[chunked]": ({"method": "hetero", "client_ranks": (4, 2, 1, 3, 4,
                                                              2),
                         "close_chunk": 4}, 1, 6, 3, *CHUNK_FOLDS),
    # the paper's baselines: no engine, an eager close (centralized: none).
    # 3 local steps for fedit and ffa, so that the first round's A factors
    # differ between clients (see the chunked paths)
    "fedit": ({"method": "fedit", **PARTIAL}, 2, 4, 3, {}, {}),
    "ffa": ({"method": "ffa", **PARTIAL}, 2, 4, 3, {}, {}),
    "centralized": ({"method": "centralized"}, 2, 4, 2, {}, {}),
    # DP uploads through the kernel close. σ 1e-3: the q/k/v/o adapters hold
    # ≈ 2.3 M entries, so the noise has norm ≈ 1.5 against the clip of 1
    "fedex+dp": ({"dp_clip": 1.0, "dp_noise_multiplier": 1e-3, **PARTIAL}, 2,
                 4, 2, {"fedex_fold": 1}, {"factor_mean": 1}),
    # the eager close of the fedex path's weighted rounds
    "fedex[eager]": ({"engine": "off", **PARTIAL}, 2, 4, 2, {}, {}),
    # the coordinator's policies and the uplink transport (TransportProbe).
    # Seed 0's draws at a deadline of 1 sim-second: each round one client
    # drops out and one arrives after the deadline with the quorum met
    "fedex+deadline": ({"round_deadline": 1.0, "min_quorum": 2,
                        "dropout_prob": 0.25, "straggler_prob": 0.25,
                        "weighting": "examples"}, 2, 4, 2,
                       {"fedex_fold": 1}, {"factor_mean": 1}),
    # FedBuff: commits of 2, the rest in flight across commits
    "fedbuff": ({"async_buffer": 2, "staleness_alpha": 0.5, "ring_depth": 3,
                 "weighting": "examples"}, 3, 4, 2,
                {"fedex_fold": 1}, {"factor_mean": 1}),
    # int8 uplinks under a norm ceiling of 1 (the honest adapters' ∞-norm
    # is ≈ 0.1: a ~ N(0, 0.02²)); round 0's first uplink is scaled × 100
    "fedex+int8": ({"quantize_uplink": "int8", "uplink_max_norm": 1.0,
                    **PARTIAL}, 2, 4, 2, {"fedex_fold": 1},
                   {"factor_mean": 1}),
    # the fedex path at paper-gpt2's width (GPT2_PATHS)
    "gpt2-fedex": ({}, 3, 4, 2, {"fedex_fold": 1}, {"factor_mean": 1}),
    # fault plans against their crash twins (FAULT_TWINS): every round the
    # faulted clients' uplinks are quarantined or dropped, and the close
    # must equal the twin's, in which they crashed, bit for bit
    "fedex+faults": ({"faults": FAULT_PLAN, "weighting": "examples"}, 2, 6,
                     3, {"fedex_fold": 1}, {"factor_mean": 1}),
    "fedex+faults[twin]": ({"faults": "crash@1(clients=1+3+5)",
                            "weighting": "examples"}, 2, 6, 3,
                           {"fedex_fold": 1}, {"factor_mean": 1}),
    "hetero+faults": ({"method": "hetero", "client_ranks": HETERO_FAULT_RANKS,
                       "faults": "nan@1(clients=1);truncate@1(clients=3)"},
                      1, 5, 2, {"hetero_fold": 1}, {}),
    "hetero+faults[twin]": ({"method": "hetero",
                             "client_ranks": HETERO_FAULT_RANKS,
                             "faults": "crash@1(clients=1+3)"}, 1, 5, 2,
                            {"hetero_fold": 1}, {}),
}
GPT2_PATHS = ("gpt2-fedex",)  # run at paper-gpt2, the others at the main cfg
TRANSPORT_PATHS = ("fedex+deadline", "fedbuff", "fedex+int8")
# faulty path → its crash twin, and what each faulted client must become
FAULT_TWINS = {"fedex+faults": "fedex+faults[twin]",
               "hetero+faults": "hetero+faults[twin]"}
FAULTED = {"fedex+faults": {1: ("nonfinite",), 3: ("bytes",),
                            5: ("unroutable", "stale")},
           "fedex+faults[twin]": {c: ("crash",) for c in (1, 3, 5)},
           "hetero+faults": {1: ("nonfinite",), 3: ("bytes",)},
           "hetero+faults[twin]": {c: ("crash",) for c in (1, 3)}}
EVERY_ROUND = ("fedbuff",)  # the identity checked at every commit
# round 0 uniform over every client, later rounds weighted at 50%
STAGED = ("fedex", "gpt2-fedex", "gemma3-fedex")
# phase 8's training paths, each at its model's full width and depth (the
# zoo's weighted closes fold 8 leaves at gemma3: q/k/v/o of its local and
# its global layers; 4 at the others). The one-round paths take 3 local
# steps: with 2, every client of a first round uplinks the same A (see the
# chunked paths) and the fold's residual is 0
ZOO_PATHS = {
    "gemma3-fedex": ({}, 3, 4, 2, {"fedex_fold": 1}, {"factor_mean": 1}),
    "granite-fedex": (PARTIAL, 1, 4, 3, {"fedex_fold": 1},
                      {"factor_mean": 1}),
    "starcoder2-fedex": (PARTIAL, 1, 4, 3, {"fedex_fold": 1},
                         {"factor_mean": 1}),
}


def frozen_leaves(torch, params, keys, gen):
    """Every leaf of ``params`` that no close may move (all but the adapted
    kernels: biases, norms, learned positions, the tied embedding), its
    biases first drawn N(0, 0.02²) from ``gen`` (the init's zeros would
    leave the bias terms untested); returns clones to compare against."""
    from repro_torch.util.tree import flatten_with_paths
    adapted = {f"{k}/kernel" for k in keys}
    out = {}
    for k, leaf in flatten_with_paths(params).items():
        if k in adapted:
            continue
        if k.endswith("/bias"):
            leaf.normal_(0.0, 0.02, generator=gen)
        out[k] = leaf.clone()
    return out


def watch_unwritten_lanes(torch, trainer, name):
    """Fill the trainer's ring's fresh stacks with NaN instead of zeros and,
    before every stacked close, check that each lane opened and never
    written (cut at the deadline, quarantined, dropped, crashed) still holds
    only NaN: a lane the close read would put NaN into W0. Returns a
    one-element list that counts the lanes checked."""
    eng = trainer.engine
    buffers, unread = eng.buffers, [0]

    def nan_alloc(lanes):
        return {p: torch.full((lanes,) + shp, float("nan"),
                              device=buffers.device)
                for p, shp in buffers._shapes.items()}

    buffers._alloc = nan_alloc

    def checked(close):
        def wrapper(*args, round_id=None, **kw):
            written = buffers.delivered_in(round_id)
            stacks = buffers._open[round_id]["stacks"]
            for cid, lane in buffers.lanes(round_id).items():
                if cid in written:
                    continue
                if not all(bool(torch.isnan(st[lane]).all())
                           for st in stacks.values()):
                    raise AssertionError(f"{name}: client {cid}'s lane "
                                         "was written")
                unread[0] += 1
            return close(*args, round_id=round_id, **kw)
        return wrapper

    for fn in ("close", "close_hetero"):
        setattr(eng, fn, checked(getattr(eng, fn)))
    return unread


class TransportProbe:
    """The checks of the coordinator paths (``TRANSPORT_PATHS``), hooked
    into one trainer:

    * the ring's fresh stacks hold NaN instead of zeros, and before every
      close each lane that was opened but never written (cut at the
      deadline, or quarantined) must still hold only NaN: a lane the
      close read would put NaN into W0, which the identity check refuses;
    * fedex+deadline: some round drops a client out and some round cuts
      one at the deadline;
    * fedbuff: some commit has staleness ≥ 1, and every commit's weights
      are n·(1 + s)^(−α) renormalised, exactly;
    * fedex+int8: round 0's first uplink is scaled × 100 past
      ``uplink_max_norm`` and must be quarantined (ledger direction
      ``quarantined``, its lane unwritten); every delivered payload's
      ledger bytes are params + 4 × leaves; the first uplink's int8 codes
      and scales, and its fp16 bits, encoded on the card equal bitwise
      those encoded on the CPU from the same tensors;
    * every path: the codec's ms per uplink on the card (encode, the
      dequantizing decode, the validation with its one host sync; medians
      of 20 after warm-up, synchronised), beside the other codecs'.
    """

    def __init__(self, torch, trainer, name):
        self.torch, self.trainer, self.name = torch, trainer, name
        self.first = None    # the first honest uplink's adapter tree
        self.first_client = None
        self.scaled = None   # the client whose uplink was scaled
        codec = trainer.coordinator.codec
        # unwritten lanes checked before a close
        self.unread = watch_unwritten_lanes(torch, trainer, name)
        encode = codec.encode

        def keep_first(tree, **kw):
            scaled = (kw["round_id"], kw["client_id"]) == (0, self.scaled)
            if (self.first is None and not scaled
                    and kw.get("direction", "uplink") == "uplink"):
                self.first, self.first_client = tree, kw["client_id"]
            return encode(tree, **kw)

        codec.encode = keep_first
        if name == "fedex+int8":
            make = trainer._train_fn

            def scaled_train_fn(round_losses):
                fn = make(round_losses)

                def train_fn(client, start, round_id):
                    lora = fn(client, start, round_id)
                    if round_id == 0 and self.scaled is None:
                        self.scaled = client.client_id
                        lora = _scaled(lora, 100.0)
                    return lora

                return train_fn

            trainer._train_fn = scaled_train_fn

    def round_line(self, out):
        print(f"  [{self.name}] round {out.round_id}: sampled {out.sampled}, "
              f"delivered {out.client_ids}, dropped out {out.dropped_out}, "
              f"cut at the deadline {out.dropped_deadline}, quarantined "
              f"{out.quarantined}, staleness "
              f"{[d.staleness for d in out.delivered]}, weights "
              f"{out.weights}", flush=True)

    def finish(self, rows):
        torch, trainer, name = self.torch, self.trainer, self.name
        outs = trainer.outcomes
        if name == "fedex+deadline":
            if not (any(o.dropped_out for o in outs)
                    and any(o.dropped_deadline for o in outs)):
                raise AssertionError(f"{name}: no dropout or no deadline "
                                     "drop in the run")
        if name == "fedbuff":
            alpha = trainer.fed_cfg.staleness_alpha
            for o in outs:
                raw = [d.client.num_examples * (1.0 + d.staleness) ** -alpha
                       for d in o.delivered]
                if o.weights != [x / sum(raw) for x in raw]:
                    raise AssertionError(f"{name}: commit {o.round_id}'s "
                                         f"weights {o.weights} are not "
                                         "the discounted example counts")
            if not any(d.staleness >= 1 for o in outs for d in o.delivered):
                raise AssertionError(f"{name}: no commit with staleness ≥ 1")
        if name == "fedex+int8":
            self._int8_checks(outs)
        need_unread = name != "fedbuff"
        print(f"  [{name}] {self.unread[0]} lanes opened and never written, "
              "each still all NaN at its close (W0 finite after it)",
              flush=True)
        if need_unread and not self.unread[0]:
            raise AssertionError(f"{name}: no lane was left unwritten")
        self._codec_times(rows)

    def _int8_checks(self, outs):
        from repro_torch.fedsrv import AdapterCodec
        torch, trainer, name = self.torch, self.trainer, self.name
        ledger = trainer.ledger.entries
        q0 = outs[0].quarantined
        quarantined = [(e.round_id, e.client_id) for e in ledger
                       if e.direction == "quarantined"]
        if q0 != [(self.scaled, "norm")] or quarantined != [(0,
                                                             self.scaled)]:
            raise AssertionError(f"{name}: the scaled uplink of client "
                                 f"{self.scaled} was not quarantined "
                                 f"({q0}, ledger {quarantined})")
        ups = [e for e in ledger if e.direction == "uplink"]
        n_leaves = len(_flat(self.first))
        bad = [e for e in ups if e.nbytes != e.params + 4 * n_leaves]
        delivered = sum(len(o.delivered) for o in outs)
        print(f"  [{name}] ledger: {len(ups)} delivered uplinks of "
              f"{ups[0].params} params and {ups[0].nbytes} B each "
              f"(params + 4 × {n_leaves} leaves), client {self.scaled}'s "
              f"scaled uplink quarantined (ledger round 0: "
              f"{trainer.ledger.round_totals(0)})", flush=True)
        if bad or len(ups) != delivered:
            raise AssertionError(f"{name}: uplink ledger entries {bad} "
                                 f"({len(ups)} for {delivered} deliveries)")
        cpu = torch.device("cpu")
        host = {p: x.to(cpu) for p, x in _flat(self.first).items()}
        for codec in ("int8", "fp16"):
            on_card = AdapterCodec(codec).encode(self.first, round_id=0,
                                                 client_id=0).tensors
            on_cpu = AdapterCodec(codec).encode(_unflat(host), round_id=0,
                                                client_id=0).tensors
            same = all(torch.equal(on_card[p].data.to(cpu), on_cpu[p].data)
                       for p in on_cpu)
            if codec == "int8":
                same = same and all(
                    float(on_card[p].scale) == float(on_cpu[p].scale)
                    for p in on_cpu)
            print(f"  [{name}] {codec} encode of client "
                  f"{self.first_client}'s uplink "
                  f"({sum(x.numel() for x in host.values())} entries): card "
                  f"== CPU bitwise ({'codes and scales' if codec == 'int8' else 'bits'}): "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError(f"{name}: {codec} codes on the card "
                                     "differ from the CPU's")
        verdicts = self._verdicts(host)
        print(f"  [{name}] defended decode, the same uplink with one entry "
              f"changed, card verdict == CPU verdict for every codec: "
              f"{json.dumps(verdicts)}", flush=True)

    def _verdicts(self, host):
        """Each codec's verdict (the quarantine reason, or "ok"), with no
        norm ceiling and with the path's, on the card and on the CPU for
        copies of one uplink with one entry set to NaN, +inf, 7e4 (past
        fp16's range) or 5 (past the ceiling)."""
        from repro_torch.fedsrv import (AdapterCodec, TransportError,
                                        ValidationPolicy)
        torch, device = self.torch, self.trainer.device
        max_norm = self.trainer.fed_cfg.uplink_max_norm
        first = next(iter(host))
        out = {}
        for label, value in (("nan", float("nan")), ("inf", float("inf")),
                             ("7e4", 7e4), ("5", 5.0)):
            bad = dict(host)
            bad[first] = host[first].clone()
            bad[first].view(-1)[bad[first].numel() // 2] = value
            for codec, limit in itertools.product(("none", "fp16", "int8"),
                                                  (0.0, max_norm)):
                got = []
                for dev in (device, torch.device("cpu")):
                    c = AdapterCodec(codec, validation=ValidationPolicy(
                        max_norm=limit))
                    tree = _unflat({p: x.to(dev) for p, x in bad.items()})
                    c.register_spec(tree)
                    try:
                        c.decode(c.encode(tree, round_id=0, client_id=0))
                        got.append("ok")
                    except TransportError as e:
                        got.append(e.reason)
                if got[0] != got[1]:
                    raise AssertionError(f"{self.name}: {codec} verdict on "
                                         f"an uplink with {label}: card "
                                         f"{got[0]}, CPU {got[1]}")
                out[f"{label}/{codec}/max_norm={limit:g}"] = got[0]
        return out

    def _codec_times(self, rows):
        from repro_torch.fedsrv import AdapterCodec, ValidationPolicy
        torch, trainer = self.torch, self.trainer
        max_norm = trainer.fed_cfg.uplink_max_norm
        main = trainer.fed_cfg.quantize_uplink
        times = {}
        for codec_name in dict.fromkeys((main, "none", "fp16", "int8")):
            codec = AdapterCodec(codec_name, validation=ValidationPolicy(
                max_norm=max_norm))
            codec.register_spec(self.first)
            payload = codec.encode(self.first, round_id=0, client_id=0)
            flat = codec._decode_flat(payload)

            def med(fn):
                for _ in range(3):
                    fn()
                ts = []
                for _ in range(20):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t) * 1e3)
                return statistics.median(ts)

            times[codec_name] = {
                "encode_ms": med(lambda: codec.encode(
                    self.first, round_id=0, client_id=0)),
                "decode_ms": med(lambda: codec._decode_flat(payload)),
                "validate_ms": med(lambda: codec._validate_flat(payload,
                                                                flat)),
                "wire_bytes": payload.nbytes}
        rows[-1]["codec"] = times
        print(f"  [{self.name}] codec per uplink on the card (ms, median of "
              f"20; this path's codec first; validation with max_norm "
              f"{max_norm}): {json.dumps(times)}", flush=True)


def _flat(tree):
    from repro_torch.util.tree import flatten_with_paths
    return flatten_with_paths(tree)


def _unflat(flat):
    from repro_torch.util.tree import unflatten_from_paths
    return unflatten_from_paths(flat)


def _scaled(tree, factor):
    return _unflat({p: x * factor for p, x in _flat(tree).items()})


def _end_layers(w0):
    """The first and the last stacked layer of a (*L, m, n) leaf, as
    indices."""
    lead = w0.shape[:-2]
    return [tuple(0 for _ in lead), tuple(n - 1 for n in lead)]


def _snapshot(w0, name):
    """W0's copy for the identity check: the whole leaf, or for a
    ``ZOO_PATHS`` path its first and last layer (:func:`identity_sampled`),
    since the whole adapted leaves of a 15 B model would not fit beside
    it."""
    if name in ZOO_PATHS:
        return {idx: w0[idx].clone() for idx in _end_layers(w0)}
    return w0.clone()


def drive_path(torch, device, cfg, name, *, batch=8, seq=64, data_vocab=512):
    """Drive one path of the port's FederatedTrainer at full width; a
    ``STAGED`` path's round 0 is uniform over every client, its later
    rounds weighted at 50% participation; a ``GPT2_PATHS`` path holds its
    leaves that are not adapted bitwise (:func:`frozen_leaves`). A chunked
    path times each chunk fold (eager during ingest, or a flush inside the
    close). Returns (trainer, per-round rows, number of kernel closes,
    identity check's worst error)."""
    from repro_torch.configs import FedConfig, LoRAConfig, TrainConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.fedsrv import RoundPolicy
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model
    from repro_torch.util.tree import count_params, flatten_with_paths

    fed_kw, rounds, clients, local_steps, *_ = {**PATHS, **ZOO_PATHS}[name]
    t0 = time.perf_counter()
    loaders, evals = build_federated_data(data_vocab, clients, seq_len=seq,
                                          batch_size=batch, device=device)
    trainer = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(rank=4, alpha=8.0),
        fed_cfg=FedConfig(num_clients=clients, rounds=rounds,
                          local_steps=local_steps, **fed_kw),
        train_cfg=TrainConfig(learning_rate=5e-3, schedule="constant",
                              total_steps=rounds * local_steps),
        client_loaders=loaders, eval_batches=evals, seed=0, device=device)
    torch.cuda.synchronize()
    eng = trainer.engine
    print(f"  [{name}] set-up (data + {count_params(trainer.params) / 1e9:.2f}"
          f" B params on the card, engine "
          f"{eng.method if eng else 'none: eager close'}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
    fold_ms, in_close = [], [False]  # (ms, folded inside the close?)

    def flagged(fn):
        def wrapper(*args, **kw):
            in_close[0] = True
            try:
                return fn(*args, **kw)
            finally:
                in_close[0] = False
        return wrapper

    if eng is None:  # the eager close, its divergence included
        trainer._close_round = timed(trainer._close_round, close_ms)
    else:
        for fn in ("close", "close_keep_local", "close_hetero"):
            setattr(eng, fn, timed(flagged(getattr(eng, fn)), close_ms))
    if eng is not None and eng.chunk:
        fold = eng.buffers.on_chunk

        def timed_fold(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fold(*args)
            torch.cuda.synchronize()
            fold_ms.append(((time.perf_counter() - t) * 1e3, in_close[0]))
            return out

        eng.buffers.on_chunk = timed_fold
    trainer._evaluate = timed(trainer._evaluate, eval_ms)
    # after the timing wrappers, so that its checks stay out of the times
    probe = (TransportProbe(torch, trainer, name) if name in TRANSPORT_PATHS
             else None)
    unread = (watch_unwritten_lanes(torch, trainer, name) if name in FAULTED
              else None)
    keys = ([s.key for s in eng.specs] if eng else
            [k[:-2] for k in flatten_with_paths(trainer.global_lora)
             if k.endswith("/a")])
    frozen = None
    if name in GPT2_PATHS:
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        frozen = frozen_leaves(torch, trainer.params, keys, gen)
    rows, identity, kernel_closes = [], None, 0
    # the baselines fold nothing: their W0 is held to the path's start
    baseline = trainer.method in ("fedit", "ffa", "centralized")
    for rnd in range(rounds):
        if name in STAGED and rnd == 1:
            trainer.coordinator.policy = RoundPolicy(participation=0.5,
                                                     weighting="examples")
        check = rnd == rounds - 1 or name in EVERY_ROUND
        if rnd == (0 if baseline else rounds - 1) or name in EVERY_ROUND:
            # the exactness identity on the last round (every commit)
            bases = trainer.client_params or [trainer.params]
            old = [{k: _snapshot(_node(p, k)["kernel"], name) for k in keys}
                   for p in bases]
        n_steps, n_close, n_fold = len(step_ms), len(close_ms), len(fold_ms)
        t = time.perf_counter()
        rec = trainer.run(until=rnd + 1)[rnd]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        # the path's peak before any identity check's own temporaries
        run_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = trainer.outcomes[-1] if trainer.outcomes else None
        uniform = name in STAGED and out.weights is None
        kernel_closes += (eng is not None and not uniform
                          and bool(out.delivered) and not out.degraded)
        kind = ("uniform" if uniform else "kernel" if eng
                else "eager" if out else "no")
        rows.append({
            "path": name, "round": rnd,
            "clients": out.client_ids if out else [rnd % clients],
            "weights": out.weights if out else None,
            "step_ms": statistics.median(step_ms[n_steps:]),
            "close_ms": (close_ms[n_close:] or [None])[0],
            "eval_ms": eval_ms[-1],
            "round_s": wall, "run_peak_gib": run_peak,
            "eval_loss": rec.eval_loss,
            "divergence": float(rec.divergence_scaled),
            "client_losses": rec.client_losses})
        r = rows[-1]
        if eng is not None and eng.chunk:
            folds = fold_ms[n_fold:]
            r["eager_fold_ms"] = [ms for ms, closing in folds if not closing]
            r["flush_fold_ms"] = [ms for ms, closing in folds if closing]
            eager = ", ".join(f"{x:.2f}" for x in r["eager_fold_ms"])
            flush = ", ".join(f"{x:.2f}" for x in r["flush_fold_ms"])
            print(f"  [{name}] round {rnd} chunk folds: eager (at ingest) "
                  f"{eager or 'none'} ms; flushed in the close "
                  f"{flush or 'none'} ms", flush=True)
        close = ("none" if r["close_ms"] is None
                 else f"{r['close_ms']:.2f} ms")
        print(f"  [{name}] round {rnd} [{kind} close, clients="
              f"{r['clients']}]: client step "
              f"{r['step_ms']:.1f} ms (median of {len(step_ms) - n_steps}), "
              f"close {close}, eval {r['eval_ms']:.1f} ms, "
              f"round {wall:.2f} s, eval_loss {rec.eval_loss:.4f}, "
              f"divergence {r['divergence']:.3e}", flush=True)
        if probe is not None:
            probe.round_line(out)
        if check:
            t = time.perf_counter()
            worst = IDENTITIES[name](torch, trainer, out, old, keys)
            identity = worst if identity is None else max(identity, worst)
            print(f"  [{name}] identity check {time.perf_counter() - t:.1f} s",
                  flush=True)
            del old
    if probe is not None:
        probe.finish(rows)
    if unread is not None:
        fault_checks(trainer, name, unread[0])
    if frozen is not None:
        now = flatten_with_paths(trainer.params)
        moved = [k for k, x in frozen.items() if not torch.equal(now[k], x)]
        print(f"  [{name}] the {len(frozen)} leaves not adapted (biases, "
              f"norms, learned positions, the tied embedding) bitwise as at "
              f"the path's start: {not moved}", flush=True)
        if moved:
            raise AssertionError(f"{name}: leaves not adapted moved: {moved}")
    return trainer, rows, kernel_closes, identity


def fault_checks(trainer, name, unread):
    """A fault path's outcomes: every round each client of ``FAULTED[name]``
    is quarantined or dropped for its reason, the others delivered, and its
    lane left unwritten (all NaN) and unread; under ``FAULT_PLAN`` client 0
    is delivered after 2 retries and the ring drops client 2's duplicate
    copy once a round."""
    want = FAULTED[name]
    k, bufs = trainer.fed_cfg.num_clients, trainer.engine.buffers
    outs = trainer.outcomes
    for out in outs:
        got = dict(out.quarantined)
        print(f"  [faults] {name} round {out.round_id}: delivered "
              f"{out.client_ids}, quarantined or dropped {out.quarantined}, "
              f"retries {out.retries}", flush=True)
        ok = (got.keys() == want.keys()
              and all(got[c] in want[c] for c in got)
              and out.client_ids == [c for c in range(k) if c not in want])
        if name == "fedex+faults":
            ok = ok and out.retries == 2
        if not ok:
            raise AssertionError(f"{name}: round {out.round_id}'s outcome "
                                 f"is not the plan's")
    buckets = {d: sorted({e.client_id for e in trainer.ledger.entries
                          if e.direction == d and e.client_id in want})
               for d in ("quarantined", "dropped")}
    print(f"  [faults] {name}: ring drops duplicate {bufs.duplicate_drops}, "
          f"replay {bufs.replay_drops}, stale {bufs.stale_drops}; ledger "
          f"buckets of the faulted clients {buckets}; {unread} lanes opened "
          "and never written, each still all NaN at its close", flush=True)
    dups = len(outs) if name == "fedex+faults" else 0
    if bufs.duplicate_drops != dups or unread != len(outs) * len(want):
        raise AssertionError(f"{name}: {bufs.duplicate_drops} duplicate "
                             f"drops (want {dups}), {unread} unwritten lanes")


def twin_leaves(trainer):
    """What a crash twin must reproduce bit for bit: the global adapter and
    the adapted W0 leaves, or (keep_local, hetero) each delivered client's
    own base and adapter."""
    keys = [s.key for s in trainer.engine.specs]
    out = {f"global {p}": x for p, x in _flat(trainer.global_lora).items()}
    if trainer.client_params is None:
        out.update({f"W0 {k}": _node(trainer.params, k)["kernel"]
                    for k in keys})
        return out
    for c in trainer.outcomes[-1].client_ids:
        out.update({f"client {c} W0 {k}": _node(trainer.client_params[c],
                                                k)["kernel"] for k in keys})
        out.update({f"client {c} lora {p}": x for p, x in
                    _flat(trainer._client_lora[c]).items()})
    return out


def ring_snapshot_phase(torch, device, cfg):
    """``ring-snapshot``: a chunked fedex ring at ``cfg``'s adapter shapes
    (drawn adapters, no training): 6 lanes in chunks of 2, raw weights 30,
    50, …, 130. A twin written 3 of 6 uplinks (chunk 0 folded at ingest
    through B2 and B5, chunk 1 half written) is snapshotted through
    ``repro_torch.checkpoint`` to disk, loaded into a fresh engine and
    finished; its close must equal the uninterrupted one bit for bit.
    Returns the snapshot's stats and the launches to expect."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.engine import RoundCloseEngine

    c, chunk, r, written = 6, 2, 4, 3
    raw_w = [30.0, 50.0, 70.0, 90.0, 110.0, 130.0]
    gen = torch.Generator(device=device)
    gen.manual_seed(23)

    def randn(*shape, std):
        return torch.empty(shape, device=device).normal_(0.0, std,
                                                         generator=gen)

    leaves = main_path_leaves(cfg)
    w0 = {k: randn(L, m, n, std=0.02) for k, L, m, n in leaves}
    loras = [{k: {"a": randn(L, m, r, std=0.02), "b": randn(L, r, n,
                                                          std=0.01)}
              for k, L, m, n in leaves} for _ in range(c)]

    def base():  # the kernel close folds into W0 in place
        return {k: {"kernel": x.clone()} for k, x in w0.items()}

    def make():
        eng = RoundCloseEngine({k: {"kernel": x} for k, x in w0.items()},
                               loras[0], c_max=c, scale=2.0, chunk=chunk)
        eng.buffers.begin_round({i: i for i in range(c)}, round_id=0)
        return eng

    def write(eng, i):
        eng.buffers.write(i, loras[i], round_id=0, weight=raw_w[i])

    whole, crashed = make(), make()
    for i in range(c):
        write(whole, i)
        if i < written:
            write(crashed, i)
    torch.cuda.synchronize()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "ring.npz")
        t = time.perf_counter()
        meta, arrays = crashed.buffers.state_dict()
        save_checkpoint(path, {"ring": arrays}, meta)
        save_s = time.perf_counter() - t
        nbytes = Path(path).stat().st_size
        del crashed, arrays
        torch.cuda.empty_cache()
        t = time.perf_counter()
        tree, meta = load_checkpoint(path, device)
        resumed = make()
        resumed.buffers.load_state(meta, _flat(tree["ring"]))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        del tree
    for i in range(written, c):
        write(resumed, i)
    outs = []
    for eng in (whole, resumed):
        glob, params, div = eng.close(base(), list(range(c)), raw_w)
        outs.append(({**{f"global {p}": x for p, x in _flat(glob).items()},
                      **{f"W0 {p}": x for p, x in _flat(params).items()}},
                     div.resolve()))
    (want, want_div), (got, got_div) = outs
    same = (want.keys() == got.keys() and got_div == want_div
            and all(torch.equal(want[k], got[k]) for k in want))
    entry = meta["open"][0]
    print(f"  [resume] ring-snapshot ({c} lanes of {cfg.name}'s 4 adapted "
          f"leaves, chunks of {chunk}, raw weights): snapshot after "
          f"{written} writes (next chunk {entry['next_chunk']}, chunk 1 "
          f"filled {entry['filled'][1]} of {chunk}, accumulators "
          f"{len(entry['acc_keys'])}): {nbytes} B on disk, save "
          f"{save_s:.3f} s (device → host → disk), load {load_s:.3f} s "
          f"(disk → device); the resumed close == the uninterrupted one "
          f"bitwise (global adapter, W0, divergence {got_div:.6e}): {same}",
          flush=True)
    if not (same and entry["next_chunk"] == 1 and entry["acc_keys"]):
        raise AssertionError("ring-snapshot: the resumed close differs")
    # chunk folds: 3 uninterrupted, 1 before the snapshot, 2 after it; one
    # grouped factor_mean and a product_accum a leaf each
    folds = 3 + 1 + 2
    stats = {"snapshot_bytes": nbytes, "save_s": save_s, "load_s": load_s}
    return stats, {"factor_mean": folds,
                   "product_accum": folds * len(leaves)}


def gpt2_resume_phase(torch, device, gcfg, *, batch=8, seq=64,
                      data_vocab=512):
    """``gpt2-resume``: fedex at ``gcfg``'s full width, 3 clients, 2 local
    steps, 3 rounds at 50% participation, example weights, a cosine
    schedule and the plan ``nan@1(clients=1,rounds=1)``. A run killed after
    round 1 (its snapshot on disk) and resumed in a fresh trainer must equal
    the uninterrupted run bit for bit: history, params, global adapter, the
    same quarantine replayed. Returns the snapshot's stats and the launches
    to expect."""
    import tempfile

    from repro_torch.checkpoint import round_state_path
    from repro_torch.configs import FedConfig, LoRAConfig, TrainConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model

    rounds, local_steps = 3, 2

    def make(checkpoint_dir=""):
        loaders, evals = build_federated_data(
            data_vocab, 3, seq_len=seq, batch_size=batch, device=device)
        return FederatedTrainer(
            model=build_model(gcfg), lora_cfg=LoRAConfig(rank=4, alpha=8.0),
            fed_cfg=FedConfig(num_clients=3, rounds=rounds,
                              local_steps=local_steps, participation=0.5,
                              weighting="examples",
                              faults="nan@1(clients=1,rounds=1)",
                              checkpoint_dir=checkpoint_dir),
            train_cfg=TrainConfig(learning_rate=5e-3, schedule="cosine",
                                  total_steps=rounds * local_steps),
            client_loaders=loaders, eval_batches=evals, seed=0, device=device)

    def closes(trainer):
        return sum(bool(o.delivered) and not o.degraded
                   for o in trainer.outcomes)

    t = time.perf_counter()
    full = make()
    full.run()
    full_s = time.perf_counter() - t
    want = {**{f"params {p}": x for p, x in _flat(full.params).items()},
            **{f"global {p}": x for p, x in _flat(full.global_lora).items()}}
    history, quarantined = full.history, full.outcomes[1].quarantined
    n_closes = closes(full)
    del full
    gc.collect()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        killed = make(tmp)
        save_s = []
        save = killed.save_state

        def timed_save(path):
            t = time.perf_counter()
            save(path)
            save_s.append(time.perf_counter() - t)

        killed.save_state = timed_save
        killed.run(until=1)
        n_closes += closes(killed)
        nbytes = Path(round_state_path(tmp)).stat().st_size
        del killed
        gc.collect()
        resumed = make(tmp)
        t = time.perf_counter()
        resumed.load_state(round_state_path(tmp))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        resumed.run()
    got = {**{f"params {p}": x for p, x in _flat(resumed.params).items()},
           **{f"global {p}": x for p, x in _flat(resumed.global_lora).items()}}
    n_closes += closes(resumed)
    same = (resumed.history == history and want.keys() == got.keys()
            and all(torch.equal(want[k], got[k]) for k in want))
    replayed = resumed.outcomes[0].quarantined
    print(f"  [resume] gpt2-resume ({gcfg.name}, {rounds} rounds at 50%, "
          f"example weights, cosine; uninterrupted {full_s:.1f} s): killed "
          f"after round 1, snapshot {nbytes} B on disk, save "
          f"{save_s[0]:.3f} s, load {load_s:.3f} s; round 1's quarantine "
          f"{quarantined} replayed as {replayed}; history, params and "
          f"global adapter ({len(want)} leaves) == the uninterrupted run's "
          f"bitwise: {same}", flush=True)
    if not (same and quarantined == replayed == [(1, "nonfinite")]):
        raise AssertionError("gpt2-resume: the resumed run differs")
    del resumed, want, got
    stats = {"snapshot_bytes": nbytes, "save_s": save_s[0], "load_s": load_s,
             "uninterrupted_s": full_s}
    return stats, {"fedex_fold": 4 * n_closes, "factor_mean": n_closes}


def _stacks(torch, outcome, key):
    a = torch.stack([_node(d.lora, key)["a"] for d in outcome.delivered])
    b = torch.stack([_node(d.lora, key)["b"] for d in outcome.delivered])
    return a, b


def _weights(torch, trainer, outcome):
    k = len(outcome.delivered)
    w = outcome.weights or [1.0 / k] * k
    return torch.tensor(w, dtype=torch.float32, device=trainer.device)


def _report(name, key, lhs, rhs, bound, folded):
    err = (lhs - rhs).abs()
    ok = bool((err <= bound).all())
    print(f"  [{name}] identity {key}: max |lhs - rhs| = "
          f"{float(err.max()):.3e}, max bound {float(bound.max()):.3e}, "
          f"within bound={ok}; max |update folded into W0| = {folded:.3e}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: exactness identity fails on {key}")
    return float(err.max())


def identity_fedex(torch, trainer, outcome, old, keys):
    """new_W0 + s·ā b̄ = old_W0 + s·Σ_c w_c a_c b_c."""
    from repro_torch.kernels import fold_error_bound
    s, w, worst = trainer.scale, _weights(torch, trainer, outcome), 0.0
    for key in keys:
        a, b = _stacks(torch, outcome, key)
        g = _node(trainer.global_lora, key)
        w0_old, w0_new = old[0][key], _node(trainer.params, key)["kernel"]
        lhs = w0_new + s * torch.matmul(g["a"], g["b"])
        rhs = w0_old.clone()
        for i in range(a.shape[0]):
            rhs += s * w[i] * torch.matmul(a[i], b[i])
        worst = max(worst, _report(
            "fedex", key, lhs, rhs, fold_error_bound(w0_old, a, b, s, w),
            float((w0_new - w0_old).abs().max())))
    return worst


def identity_sampled(torch, trainer, outcome, old, keys, tag="zoo-fold"):
    """The zoo's weighted close on the first and the last stacked layer of
    each adapted leaf (gemma3's local leaves: (0, 0) and (nper − 1, ratio −
    1); phase 10's the matrices of :func:`moe_snapshot`, raw expert leaves
    too): the folded W0 against the plain fold of the round's uplinks and
    weights from the round's old W0, within ``fold_error_bound``."""
    from repro_torch.kernels import fedex_fold_plain, fold_error_bound
    s, w, worst = trainer.scale, _weights(torch, trainer, outcome), 0.0
    for key in keys:
        a, b = _stacks(torch, outcome, key)
        new = _w0(_node(trainer.params, key))
        for idx, w0_old in old[0][key].items():
            ai, bi = a[(slice(None), *idx)], b[(slice(None), *idx)]
            worst = max(worst, _report(
                tag, f"{key}{list(idx)}", new[idx],
                fedex_fold_plain(w0_old, ai, bi, s, w),
                fold_error_bound(w0_old, ai, bi, s, w),
                float((new[idx] - w0_old).abs().max())))
    return worst


def identity_reinit(torch, trainer, outcome, old, keys):
    """new_W0 = old_W0 + s·Σ_c w_c a_c b_c (the fresh adapters have b = 0)."""
    from repro_torch.kernels import product_error_bound
    s, w, worst = trainer.scale, _weights(torch, trainer, outcome), 0.0
    for key in keys:
        a, b = _stacks(torch, outcome, key)
        w0_old, w0_new = old[0][key], _node(trainer.params, key)["kernel"]
        rhs = w0_old.clone()
        for i in range(a.shape[0]):
            rhs += s * w[i] * torch.matmul(a[i], b[i])
        worst = max(worst, _report(
            "reinit", key, w0_new, rhs,
            product_error_bound(w0_old, a, b, w, s),
            float((w0_new - w0_old).abs().max())))
        if bool(_node(trainer.global_lora, key)["b"].any()):
            raise AssertionError("reinit: the fresh adapters' b is not 0")
    return worst


def identity_keep_local(torch, trainer, outcome, old, keys):
    """For each delivered i: new_W0ᵢ + s·aᵢbᵢ = old_W0ᵢ + s·Σ_j w_j a_j b_j."""
    from repro_torch.kernels import perclient_error_bound
    s, w, worst = trainer.scale, _weights(torch, trainer, outcome), 0.0
    ids = outcome.client_ids
    for key in keys:
        a, b = _stacks(torch, outcome, key)
        ideal = torch.zeros_like(old[0][key])
        for j in range(a.shape[0]):
            ideal += w[j] * torch.matmul(a[j], b[j])
        bounds = perclient_error_bound([old[c][key] for c in ids], a, b, w, s)
        for j, c in enumerate(ids):
            w0_new = _node(trainer.client_params[c], key)["kernel"]
            lhs = w0_new + s * torch.matmul(a[j], b[j])
            worst = max(worst, _report(
                "keep_local", f"{key} client {c}", lhs,
                old[c][key] + s * ideal, bounds[j],
                float((w0_new - old[c][key]).abs().max())))
        del ideal, bounds
    return worst


def identity_hetero(torch, trainer, outcome, old, keys):
    """For each delivered lane i: new_W0ᵢ + s·a′ᵢb′ᵢ = old_W0ᵢ + s·Σ_j w_j
    (a_j∘mask_j) b_j over the delivered j, with a′ᵢ, b′ᵢ client i's new
    rank-rᵢ adapters."""
    from repro_torch.kernels import hetero_error_bound
    s, w, worst = trainer.scale, _weights(torch, trainer, outcome), 0.0
    ids = outcome.client_ids
    ranks = [trainer.client_ranks[c] for c in ids]
    for key in keys:
        a, b = _stacks(torch, outcome, key)  # padded to r_max
        ideal = torch.zeros_like(old[0][key])
        for j, k in enumerate(ranks):
            ideal += w[j] * torch.matmul(a[j][..., :k], b[j][..., :k, :])
        g = _node(trainer.global_lora, key)
        bounds = hetero_error_bound(
            [old[c][key] for c in ids], a, b, w,
            torch.tensor(ranks, dtype=torch.int32, device=trainer.device),
            g["a"], g["b"], s)
        for j, c in enumerate(ids):
            mine = _node(trainer._client_lora[c], key)
            if mine["a"].shape[-1] != trainer.client_ranks[c]:
                raise AssertionError("hetero: client adapters of the wrong "
                                     "rank")
            w0_new = _node(trainer.client_params[c], key)["kernel"]
            lhs = w0_new + s * torch.matmul(mine["a"], mine["b"])
            worst = max(worst, _report(
                "hetero", f"{key} client {c}", lhs, old[c][key] + s * ideal,
                bounds[j], float((w0_new - old[c][key]).abs().max())))
        del ideal, bounds
    return worst


def identity_host(torch, trainer, outcome, old, keys):
    """A chunked round against a float64 computation on the host from the
    round's uplinks and the normalised raw ingest weights ŵ (example counts,
    or 1 each), per adapted leaf:
    * fedex: new_W0 + s·ā b̄ = old_W0 + s·Σ ŵ_c a_c b_c;
    * reinit: new_W0 = old_W0 + s·Σ ŵ_c a_c b_c;
    * keep_local, each delivered i: new_W0ᵢ + s·aᵢbᵢ = old_W0ᵢ + s·Σ ŵ a b;
    * hetero, each i: new_W0ᵢ + s·a′ᵢb′ᵢ = old_W0ᵢ + s·Σ ŵ a b (the uplinks
      are zero-padded past each rank, so Σ ŵ a b is the masked sum).
    Held to 2·(C + r + 4) unit roundoffs of M = |old_W0| + |s|·(Σ ŵ |a| |b|
    + |the subtracted product|), the bound of the stacked folds: the f32
    close passes each term through at most C + r + 6 roundings. Computed
    one stacked layer at a time in preallocated float64 buffers, the
    product terms as one matmul each: (new − old) + s·[a′ | −ŵ_0 a_0 | …]
    [b′; b_0; …] and |old| + |s|·[|a′| | ŵ_0 |a_0| | …] [|b′|; |b_0|; …]."""
    method, s = trainer.engine.method, trainer.scale
    cpu, f64 = torch.device("cpu"), torch.float64

    def host(x):
        return x.to(cpu, f64)

    raw = [float(d.client.num_examples) if outcome.weights else 1.0
           for d in outcome.delivered]
    w = torch.tensor(raw, dtype=f64)
    w = w / w.sum()
    ids = outcome.client_ids
    k = 2 * (len(ids) + trainer.lora_cfg.rank + 4) * U
    worst = 0.0
    for key in keys:
        a, b = (host(x) for x in _stacks(torch, outcome, key))
        wa = torch.cat([w[j] * a[j] for j in range(len(ids))], dim=-1)
        bb = torch.cat(list(b), dim=-2)
        if method in ("fedex", "reinit"):
            own = None
            if method == "fedex":
                g = _node(trainer.global_lora, key)
                own = (host(g["a"]), host(g["b"]))
            lanes = [(key, old[0][key], _node(trainer.params, key)["kernel"],
                      own)]
        else:
            lanes = []
            for j, c in enumerate(ids):
                if method == "hetero":
                    mine = _node(trainer._client_lora[c], key)
                    own = (host(mine["a"]), host(mine["b"]))
                else:
                    own = (a[j], b[j])
                lanes.append((f"{key} client {c}", old[c][key],
                              _node(trainer.client_params[c], key)["kernel"],
                              own))
        m, n = a.shape[-2], b.shape[-1]
        stage = torch.empty((m, n), pin_memory=torch.cuda.is_available())
        diff, prod, bound = (torch.empty((m, n), dtype=f64) for _ in range(3))
        for label, w0_old, w0_new, own in lanes:
            la = wa if own is None else torch.cat([own[0], -wa], dim=-1)
            rb = bb if own is None else torch.cat([own[1], bb], dim=-2)
            la_abs, rb_abs = la.abs(), rb.abs()
            if own is None:
                la = -la
            err_max = bound_max = folded = 0.0
            ok = True
            for l in range(a.shape[1]):
                stage.copy_(w0_new[l])
                diff.copy_(stage)
                stage.copy_(w0_old[l])
                bound.copy_(stage)
                diff.sub_(bound)                      # new − old
                folded = max(folded, float(diff.max()), -float(diff.min()))
                bound.abs_()                          # |old|
                torch.matmul(la[l], rb[l], out=prod)  # own − Σ ŵ a b
                diff.add_(prod, alpha=s).abs_()       # |lhs − rhs|
                torch.matmul(la_abs[l], rb_abs[l], out=prod)
                bound.add_(prod, alpha=abs(s)).mul_(k)
                err_max = max(err_max, float(diff.max()))
                bound_max = max(bound_max, float(bound.max()))
                ok = ok and bool(diff.le_(bound).all())
            print(f"  [{method}[chunked]] identity {label} (float64, host): "
                  f"max |lhs - rhs| = {err_max:.3e}, max bound "
                  f"{bound_max:.3e}, within bound={ok}; max |update folded "
                  f"into W0| = {folded:.3e}", flush=True)
            if not ok:
                raise AssertionError(f"{method}[chunked]: exactness identity "
                                     f"fails on {label}")
            worst = max(worst, err_max)
    return worst


def identity_svd(torch, trainer, outcome, old, keys):
    """On layer 0 of k_proj: new_W0 − old_W0 = s·(rank-r' truncation of the
    residual by a dense float64 SVD), and has rank ≤ r'. The part of the
    residual the cut drops, s·‖σ_{r'+1…}‖, must exceed 10 × the tolerance:
    otherwise the check could not tell the truncation from no cut at all."""
    s, rp = trainer.scale, trainer.engine.svd_rank
    key = next(k for k in keys if k.endswith("k_proj"))
    cpu = torch.device("cpu")
    a, b = _stacks(torch, outcome, key)
    a, b = a[:, 0].to(cpu, torch.float64), b[:, 0].to(cpu, torch.float64)
    w = _weights(torch, trainer, outcome).to(cpu, torch.float64)
    abar = torch.einsum("c,cmr->mr", w, a)
    bbar = torch.einsum("c,crn->rn", w, b)
    res = torch.einsum("c,cmr,crn->mn", w, a, b) - abar @ bbar
    u, sv, vh = torch.linalg.svd(res, full_matrices=False)
    trunc = s * (u[:, :rp] * sv[:rp]) @ vh[:rp]
    w0_old = old[0][key][0].to(cpu, torch.float64)
    w0_new = _node(trainer.params, key)["kernel"][0].to(cpu, torch.float64)
    d = w0_new - w0_old
    floor = float(torch.linalg.norm(2 * U * (w0_old.abs() + w0_new.abs())))
    tol = floor + 1e-4 * float(torch.linalg.norm(trunc))
    err = float(torch.linalg.norm(d - trunc))
    tail = float(torch.linalg.svdvals(d)[rp])
    cut = s * float(torch.linalg.norm(sv[rp:]))
    ok = err <= tol and tail <= tol
    print(f"  [fedex_svd] identity {key} layer 0: ||ΔW0 − s·T_r'(res)||_F = "
          f"{err:.3e}, σ_{rp + 1}(ΔW0) = {tail:.3e}, tolerance {tol:.3e} "
          f"(rounding floor {floor:.3e}), ||s·T|| = "
          f"{float(torch.linalg.norm(trunc)):.3e}; the cut drops s·σ_{rp + 1}"
          f"(res) = {s * float(sv[rp]):.3e}, s·||σ_{rp + 1}..(res)|| = "
          f"{cut:.3e} (residual rank {int((sv > sv[0] * 1e-6).sum())}); "
          f"within={ok}", flush=True)
    if not ok:
        raise AssertionError("fedex_svd: the fold is not the rank-r' "
                             "truncation of the residual")
    if cut <= 10 * tol:
        raise AssertionError(f"fedex_svd: the rank-{rp} cut drops only "
                             f"{cut:.3e} of the residual, not above 10 × the "
                             f"tolerance {tol:.3e}: the check cannot see it")
    return err


def _unchanged(torch, name, trainer, old, keys):
    """W0 bitwise as it was at the path's start (nothing folds into it)."""
    for key in keys:
        if not torch.equal(_node(trainer.params, key)["kernel"], old[0][key]):
            raise AssertionError(f"{name}: W0 of {key} moved")


def identity_mean(torch, trainer, outcome, old, keys, factors=("a", "b")):
    """Each global factor f = Σ_c w_c f_c (FedAvg), against float64 on the
    card within 2·(C + 2) unit roundoffs of Σ_c |w_c| |f_c|; W0 bitwise
    unchanged."""
    name, worst = trainer.method, 0.0
    w = _weights(torch, trainer, outcome).double()
    bound_k = 2 * (len(outcome.delivered) + 2) * U
    for key in keys:
        g = _node(trainer.global_lora, key)
        for f in factors:
            x = torch.stack([_node(d.lora, key)[f].double()
                             for d in outcome.delivered])
            want = torch.einsum("c,c...->...", w, x)
            bound = bound_k * torch.einsum("c,c...->...", w.abs(), x.abs())
            worst = max(worst, _report(name, f"{key}/{f}", g[f].double(),
                                       want, bound, 0.0))
    _unchanged(torch, name, trainer, old, keys)
    return worst


def identity_fedit(torch, trainer, outcome, old, keys):
    """FedAvg of both factors, W0 unchanged, the round's divergence > 0."""
    worst = identity_mean(torch, trainer, outcome, old, keys)
    div = float(trainer.history[-1].divergence_scaled)
    print(f"  [fedit] divergence {div:.3e} (> 0: FedIT is inexact)",
          flush=True)
    if not div > 0:
        raise AssertionError(f"fedit: divergence {div} is not > 0")
    return worst


def identity_ffa(torch, trainer, outcome, old, keys):
    """Every delivered a bitwise equal to the others (FFA-LoRA zeroes the
    a-gradients, weight decay moves a the same on every client); b the
    FedAvg of the b's; W0 unchanged; the divergence below 1e-6."""
    for key in keys:
        a = [_node(d.lora, key)["a"] for d in outcome.delivered]
        if not all(torch.equal(x, a[0]) for x in a):
            raise AssertionError(f"ffa: the uploads' a of {key} differ")
    print(f"  [ffa] the {len(outcome.delivered)} uploads' a factors are "
          "bitwise equal at every leaf", flush=True)
    worst = identity_mean(torch, trainer, outcome, old, keys, factors=("b",))
    div = float(trainer.history[-1].divergence_scaled)
    print(f"  [ffa] divergence {div:.3e} (< 1e-6: FFA-LoRA is exact)",
          flush=True)
    if not div < 1e-6:
        raise AssertionError(f"ffa: divergence {div} is not < 1e-6")
    return worst


def identity_centralized(torch, trainer, outcome, old, keys):
    """W0 unchanged and no divergence (one worker, no aggregation)."""
    _unchanged(torch, "centralized", trainer, old, keys)
    divs = [h.divergence_scaled for h in trainer.history]
    print(f"  [centralized] W0 bitwise as at the start, divergences {divs}",
          flush=True)
    if any(d != 0.0 for d in divs):
        raise AssertionError(f"centralized: divergences {divs} are not 0")
    return 0.0


IDENTITIES = {"fedex": identity_fedex, "reinit": identity_reinit,
              "keep_local": identity_keep_local, "hetero": identity_hetero,
              "fedex_svd": identity_svd,
              **{f"{m}[chunked]": identity_host
                 for m in ("fedex", "reinit", "keep_local", "hetero")},
              "fedex_svd[chunked]": identity_svd,
              "fedit": identity_fedit, "ffa": identity_ffa,
              "centralized": identity_centralized,
              "fedex+dp": identity_fedex, "fedex[eager]": identity_fedex,
              "gpt2-fedex": identity_fedex,
              **{name: identity_fedex for name in TRANSPORT_PATHS},
              **{name: identity_hetero if name.startswith("hetero")
                 else identity_fedex for name in FAULTED},
              **{name: identity_sampled for name in ZOO_PATHS}}


def _node(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def check_launches(kernels, name, want, note=""):
    """The launch counts since the last reset against ``want`` (0 for every
    kernel it leaves out); raises on a difference, returns the counts."""
    counts = kernels.launch_counts()
    expected = {k: 0 for k in SOURCES}
    expected.update(want)
    print(f"  [{name}] launches {counts} (expected {expected}){note}",
          flush=True)
    if counts != expected:
        raise AssertionError(f"{name}: kernel launches {counts} != "
                             f"{expected}")
    return counts


def train_paths(torch, kernels, device, cfg, gcfg, names):
    """Phase 4's training paths ``names`` (of ``PATHS``), one after another,
    each with the launch counters set to 0 just before it and read just
    after, its trainer freed after it; a faulty path's leaves are kept for
    its crash twin (``FAULT_TWINS``), which must equal them bit for bit.
    Returns (launches, rows, identity errors, peaks)."""
    launches = {name: 0 for name in SOURCES}
    all_rows, identities, peaks, kept = [], {}, {}, {}
    for name in names:
        *_, per_leaf, per_close = PATHS[name]
        pcfg = gcfg if name in GPT2_PATHS else cfg
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        trainer, rows, closes, identity = drive_path(torch, device, pcfg,
                                                     name)
        n_leaves = len(main_path_leaves(pcfg))
        want = {k: v * n_leaves * closes for k, v in per_leaf.items()}
        want.update({k: v * closes for k, v in per_close.items()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = check_launches(kernels, name, want,
                                f" for {closes} kernel closes; peak memory "
                                f"{peak:.1f} GiB")
        values = [v for row in rows for v in
                  (row["eval_loss"], row["divergence"],
                   *row["client_losses"])]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: non-finite losses or divergence: "
                                 f"{rows}")
        for k, v in counts.items():
            launches[k] += v
        for row in rows:
            row["peak_gib"] = peak
        peaks[name] = rows[-1]["run_peak_gib"]
        all_rows += rows
        identities[name] = identity
        if name in FAULT_TWINS:  # keep the leaves, free the trainer
            kept[name] = twin_leaves(trainer)
        faulty = next((f for f, t in FAULT_TWINS.items() if t == name), None)
        if faulty is not None:
            want, got = kept.pop(faulty), twin_leaves(trainer)
            same = want.keys() == got.keys() and all(
                torch.equal(want[k], got[k]) for k in want)
            what = ("the global adapter and W0" if trainer.client_params is
                    None else "the global adapter and the bases and adapters "
                    f"of clients {trainer.outcomes[-1].client_ids}")
            print(f"  [faults] {faulty} == {name} bitwise over {len(want)} "
                  f"leaves ({what}): {same}", flush=True)
            if not same:
                raise AssertionError(f"{faulty} differs from its crash twin")
            del want, got
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return launches, all_rows, identities, peaks


def resume_paths(torch, kernels, device, cfg, gcfg):
    """Phase 4's resume paths: ``ring-snapshot`` at ``cfg``'s adapter
    shapes, ``gpt2-resume`` at ``gcfg``'s width, each with the launch
    counters set to 0 just before it and read just after. Returns
    (launches, stats)."""
    launches = {name: 0 for name in SOURCES}
    resume = {}
    for name, phase, pcfg in (("ring-snapshot", ring_snapshot_phase, cfg),
                              ("gpt2-resume", gpt2_resume_phase, gcfg)):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        stats, want = phase(torch, device, pcfg)
        stats.update(seconds=time.perf_counter() - t,
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        counts = check_launches(kernels, name, want,
                                f"; {stats['seconds']:.1f} s, peak memory "
                                f"{stats['peak_gib']:.1f} GiB")
        for k, v in counts.items():
            launches[k] += v
        resume[name] = stats
        gc.collect()
        torch.cuda.empty_cache()
    return launches, resume


# --------------------------------------------------------------------------
# phase 5: the serving path
# --------------------------------------------------------------------------

SERVE = {"batch": 8, "prompt": 512, "steps": 32, "max_len": 1024}
P_TOL = (1e-4, 1e-4)  # (rtol, atol): kernel path vs plain path, f32 alike
D_TOL = (5e-3, 8e-3)  # teacher-forced decode vs the training forward


class plain_ops:
    """Within the block the serving path runs the kernels' plain versions
    on the card (``lora_dense_plain``, ``swa_attention_plain``) in place of
    the kernel wrappers (MLA's prefill attention too); ``dense`` replaces
    ``lora_dense_plain`` (:func:`lora_dense_halves`)."""

    def __init__(self, kernels, dense=None):
        from repro_torch.models import attention, common, mla
        self.patches = [(common, "lora_dense",
                         dense or kernels.lora_dense_plain),
                        (attention, "swa_attention",
                         kernels.swa_attention_plain),
                        (mla, "swa_attention", kernels.swa_attention_plain)]

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.patches]
        for mod, name, fn in self.patches:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.patches, self.saved):
            setattr(mod, name, fn)


def _expect(kernels, name, want):
    counts = kernels.launch_counts()
    expected = {k: 0 for k in SOURCES}
    expected.update(want)
    print(f"  [serve] launches {name}: {counts}", flush=True)
    if counts != expected:
        raise AssertionError(f"serve {name}: kernel launches {counts} != "
                             f"{expected}")


def _allclose(a, b, rtol, atol):
    err = (a - b).abs()
    return bool((err <= atol + rtol * b.abs()).all()), float(err.max())


def profile_serving(torch, model, params, lora, prefill, decode, batch,
                    bsz, prompt, max_len, res):
    """Device time by kernel of one prefill and of one decode step
    (``torch.profiler``, CUDA activity; the second of two profiled decode
    steps after three warm ones), and each one's device busy share: device
    time over the unprofiled host-clock time of ``serve()``'s prefill and
    mean decode step. Prints the five kernels that take the most device
    time; returns the device times and busy shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(prof, top):
        # kernels only: an operator's self device time repeats its kernels'
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        total = sum(ms for _, ms, _ in rows)
        for name, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
            print(f"    {ms:9.3f} ms  {100 * ms / total:5.1f}%  x{n:<5d} "
                  f"{name[:90]}", flush=True)
        # B3's kernels (every lora_mm_* grid)
        return total, sum(ms for name, ms, _ in rows if "lora_mm" in name)

    with torch.inference_mode():
        cache = model.init_cache(bsz, max_len, device=params["embed"][
            "embedding"].device)
        with profile(activities=[ProfilerActivity.CUDA]) as p_pre:
            logits, cache = prefill(params, lora, batch, cache)
            torch.cuda.synchronize()
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(3):
            tok, _, cache = decode(params, lora, tok, cache, prompt + i)
        with profile(activities=[ProfilerActivity.CUDA]) as p_dec:
            for i in range(2):
                tok, _, cache = decode(params, lora, tok, cache,
                                       prompt + 3 + i)
            torch.cuda.synchronize()
        del cache, logits
    print("  [serve] profile of one prefill, device time by kernel:",
          flush=True)
    pre_ms, pre_b3 = device_ms(p_pre, 5)
    print("  [serve] profile of two decode steps, device time by kernel:",
          flush=True)
    dec_ms, dec_b3 = (v / 2 for v in device_ms(p_dec, 5))
    print(f"  [serve] B3 (lora_mm_*) device time: prefill {pre_b3:.3f} ms, "
          f"decode {dec_b3:.3f} ms a step", flush=True)
    out = {"prefill_device_ms": pre_ms,
           "prefill_busy": pre_ms / res.prefill_ms,
           "decode_device_ms_per_step": dec_ms,
           "decode_busy": dec_ms / res.ms_per_token,
           "prefill_b3_device_ms": pre_b3,
           "decode_b3_device_ms_per_step": dec_b3}
    print(f"  [serve] device time: prefill {pre_ms:.1f} ms "
          f"({100 * out['prefill_busy']:.0f}% of serve()'s {res.prefill_ms:.1f}"
          f" ms), decode {dec_ms:.2f} ms a step "
          f"({100 * out['decode_busy']:.0f}% of {res.ms_per_token:.2f} ms): "
          f"idle share {100 * (1 - out['prefill_busy']):.0f}% / "
          f"{100 * (1 - out['decode_busy']):.0f}%", flush=True)
    return out


def serve_phase(torch, kernels, device, cfg):
    """Serve ``cfg`` at full width with a non-zero adapter (b drawn N(0,
    0.05²) from a seeded generator; a fresh adapter's b is 0) and any
    biases drawn N(0, 0.02²) (their init is 0). First the
    checks, each with the counters set to 0 just before it:
    * one prefill (``lora_matmul`` 4·L, ``flash_swa`` L launches) and one
      decode step of the last prompt token (``lora_matmul`` 4·L, no
      ``flash_swa``);
    * the prefill's last-position logits against the plain path's on the
      card (plain projections and ``swa_attention_plain``; no launch),
      rtol / atol ``P_TOL``;
    * teacher forcing: prefill(t[:−1]) + decode(t[−1]) against the training
      forward over t, rtol / atol ``D_TOL`` (the reference's
      ``tests/test_models_smoke.py``), and the argmax agrees on every row
      whose top-2 margin exceeds twice that tolerance. Held with an f32
      cache: with the reference's bf16 cache (what ``serve()`` runs) the
      decode logits drift from the f32 forward by ≈ 0.12 at this depth and
      width (2% of the logit scale; the plain path and the adapter-free
      model drift alike: bf16 K/V entries are off by up to 1.6e-2), far past
      a tolerance made for 2-layer smoke models. That drift is printed;
      the CPU tests hold the bf16 cache's casts against the reference;
    * the adapter moves the prefill logits by more than that tolerance.
    Then the main path, ``serve()`` itself, with the counters set to 0 just
    before and read just after. Returns (stats, launches)."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.core.lora import init_lora
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.util.tree import flatten_with_paths

    bsz, prompt, steps, max_len = (SERVE[k] for k in
                                   ("batch", "prompt", "steps", "max_len"))
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lcfg = LoRAConfig(rank=4, alpha=8.0)
    with torch.inference_mode():
        params = model.init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for leaf in lora["layers"]["attn"].values():
            leaf["b"].normal_(0.0, 0.05, generator=gen)
        # biases (paper-gpt2's) drawn away from the init's zeros
        for k, leaf in flatten_with_paths(params).items():
            if k.endswith("/bias"):
                leaf.normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    print(f"  [serve] set-up ({cfg.name}, params and a rank-{lcfg.rank} "
          f"adapter on the card): {time.perf_counter() - t0:.1f} s",
          flush=True)
    prefill = make_prefill_step(model, lcfg)
    decode = make_decode_step(model, lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)

    with torch.inference_mode():
        decs, kv = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            kernels.reset_launch_counts()
            cache = model.init_cache(bsz, max_len, dtype, device=device)
            pre, cache = prefill(params, lora, batch, cache)
            torch.cuda.synchronize()
            _expect(kernels, "one prefill", {"lora_matmul": 4 * L,
                                             "flash_swa": L})
            kernels.reset_launch_counts()
            _, decs[dtype], cache = decode(params, lora, full[:, -1:], cache,
                                           prompt)
            torch.cuda.synchronize()
            _expect(kernels, "one decode step", {"lora_matmul": 4 * L})
            kv[dtype] = cache["layers"]
            del cache
        # the bf16 cache's rounding of the prompt's K/V (the same f32 values
        # in both; the decode step's own entry has drifted already)
        kv_diff = max(float((kv[torch.float32][n][:, :, :prompt]
                             - kv[torch.bfloat16][n][:, :, :prompt]
                             .float()).abs().max()) for n in ("k", "v"))
        kv_max = max(float(kv[torch.float32][n].abs().max())
                     for n in ("k", "v"))
        print(f"  [serve] bf16 cache vs f32 cache: max |prompt K/V entry diff| "
              f"{kv_diff:.3e} (max |entry| {kv_max:.3e})", flush=True)
        del kv

        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, "the plain path", {})
        ok, err_plain = _allclose(pre, pre_plain, *P_TOL)
        print(f"  [serve] prefill last-position logits, kernels vs plain "
              f"path: max |diff| {err_plain:.3e} (rtol, atol {P_TOL}): "
              f"ok={ok}", flush=True)
        if not ok:
            raise AssertionError("serve: the kernel path's prefill logits "
                                 "disagree with the plain path's")

        train = model.apply(params, {"tokens": full}, lora=lora,
                            lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        top2 = torch.topk(train, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > 2 * (D_TOL[1] + D_TOL[0] * top2[:, 0].abs())
        errs_tf = {}
        for dtype, dec in decs.items():
            got = dec[:, -1]
            ok, errs_tf[dtype] = _allclose(got, train, *D_TOL)
            same = got.argmax(-1) == train.argmax(-1)
            agree = bool(same[sure].all())
            print(f"  [serve] teacher-forced decode ({dtype} cache) vs the "
                  f"training forward: max |diff| {errs_tf[dtype]:.3e} (rtol, "
                  f"atol {D_TOL}): within={ok}; argmax agrees on "
                  f"{int(same.sum())} of {bsz} rows, on the {int(sure.sum())} "
                  f"rows whose top-2 margin exceeds 2 x tol: {agree} (margins "
                  f"{[round(float(x), 4) for x in margin]}; logit scale "
                  f"{float(train.abs().max()):.3f})", flush=True)
            if dtype == torch.float32 and not (ok and agree):
                raise AssertionError("serve: prefill + decode disagree with "
                                     "the training forward")
        err_tf, err_tf_bf16 = errs_tf[torch.float32], errs_tf[torch.bfloat16]

        cache = model.init_cache(bsz, max_len, device=device)
        pre_none, cache = prefill(params, None, batch, cache)
        del cache
        moved = float((pre - pre_none).abs().max())
        tol = D_TOL[1] + D_TOL[0] * float(pre_none.abs().max())
        print(f"  [serve] the adapter moves the prefill logits by {moved:.3e} "
              f"(tolerance {tol:.3e})", flush=True)
        if moved <= tol:
            raise AssertionError("serve: the adapter does not move the logits "
                                 "past the tolerance")
        del pre, pre_plain, pre_none, decs, dec, train, got
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = serve(cfg.name, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                dtype=torch.float32)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _expect(kernels, f"serve() (1 prefill + {steps} decode steps)",
            {"lora_matmul": 4 * L * (1 + steps), "flash_swa": L})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve: bad tokens {toks.shape}")
    prof = profile_serving(torch, model, params, lora, prefill, decode, batch,
                           bsz, prompt, max_len, res)
    stats = {"prefill_ms": res.prefill_ms, "decode_ms_per_token":
             res.ms_per_token, "decode_tokens_per_s":
             bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": peak, "err_plain": err_plain,
             "err_teacher_forced": err_tf,
             "err_teacher_forced_bf16_cache": err_tf_bf16,
             "kv_entry_diff_bf16": kv_diff, "adapter_moves": moved, **prof}
    print(f"  [serve] {cfg.name} batch {bsz}, prompt {prompt}, {steps} "
          f"decode steps, bf16 cache of {max_len}: prefill "
          f"{res.prefill_ms:.1f} ms ({stats['prefill_tokens_per_s']:.0f} "
          f"tokens/s), decode {res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), "
          f"peak {peak:.2f} GiB; first row {toks[0, :8].tolist()}",
          flush=True)
    del params, lora
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches


# --------------------------------------------------------------------------
# phase 6: obs and the HTTP federation service
# --------------------------------------------------------------------------

OBS_RUN = {"clients": 4, "rounds": 3, "local_steps": 2}
HTTP_RUN = {"clients": 4, "rounds": 2}
HTTP_EXAMPLES = (120, 40, 200, 80)  # the clients' X-Fed-Examples
HTTP_HETERO_RANKS = (4, 2, 1, 3)
PULL_SERVE = {"batch_size": 2, "prompt_len": 32, "steps": 4}  # f32


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(torch, device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def obs_report(paths, *flags):
    """``scripts/obs_report.py`` on ``paths`` (metrics, trace) as a
    subprocess; raises unless it exits 0; returns its last line."""
    metrics, trace = paths
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "obs_report.py"),
         str(metrics), "--trace", str(trace), *flags],
        capture_output=True, text=True, timeout=300)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0:
        raise AssertionError(f"obs_report.py {' '.join(flags)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}")
    return last


def write_obs(rec, tmp: Path, name: str):
    """The recorder's JSONL stream and Chrome trace under ``tmp``."""
    paths = (tmp / f"{name}_metrics.jsonl", tmp / f"{name}_trace.json")
    rec.write_metrics(str(paths[0]))
    rec.write_trace(str(paths[1]))
    return paths


def obs_trainer_run(torch, device, cfg, obs, syncs, *, batch=8, seq=64,
                    data_vocab=512):
    """The fedex path's setup (``OBS_RUN``: round 0 uniform over every
    client, later rounds at 50% with example weights, changed inside one
    ``run()`` so that every divergence resolves at the next round's
    boundary) with ``obs``. The last weighted close runs under
    ``torch.cuda.set_sync_debug_mode("warn")``: the (file, line) of each of
    its synchronising calls goes into ``syncs``. Returns the trainer."""
    import warnings

    from repro_torch.configs import FedConfig, LoRAConfig, TrainConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.fedsrv import RoundPolicy
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model

    k, rounds, steps = (OBS_RUN[x] for x in ("clients", "rounds",
                                             "local_steps"))
    loaders, evals = build_federated_data(data_vocab, k, seq_len=seq,
                                          batch_size=batch, device=device)
    trainer = FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(rank=4, alpha=8.0),
        fed_cfg=FedConfig(num_clients=k, rounds=rounds, local_steps=steps,
                          obs=obs),
        train_cfg=TrainConfig(learning_rate=5e-3, schedule="constant",
                              total_steps=rounds * steps),
        client_loaders=loaders, eval_batches=evals, seed=0, device=device)
    coord, eng = trainer.coordinator, trainer.engine
    run_round, close = coord.run_round, eng.close

    def staged(round_id, *args, **kw):
        if round_id >= 1:
            coord.policy = RoundPolicy(participation=0.5,
                                       weighting="examples")
        return run_round(round_id, *args, **kw)

    def counted(*args, **kw):
        if kw.get("round_id") != rounds - 1 or device.type != "cuda":
            return close(*args, **kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return close(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.extend(f"{Path(w.filename).name}:{w.lineno}"
                             for w in caught
                             if "synchroniz" in str(w.message))

    coord.run_round, eng.close = staged, counted
    trainer.run()
    _sync(torch, device)
    return trainer


def obs_path(torch, kernels, device, cfg, tmp: Path, check=check_launches):
    """``fedex+obs``: the fedex path with ``obs="trace"`` against the same
    run with ``obs="off"``, each with the counters set to 0 just before it:
    the global adapter and the adapted W0 leaves bitwise equal, the same
    launches (``fedex_fold`` 4 and ``factor_mean`` 1 a weighted close), the
    same synchronising calls in the last weighted close, every closed round
    ``comm_match`` 1, and ``scripts/obs_report.py --check --trace`` on the
    streams. Returns (launches, stats)."""
    from repro_torch.core.engine import collect_w0_leaves

    import warnings

    n_leaves = len(main_path_leaves(cfg))
    weighted = OBS_RUN["rounds"] - 1
    want = {"fedex_fold": n_leaves * weighted, "factor_mean": weighted}
    launches = {name: 0 for name in SOURCES}
    out, leaves, syncs, secs = {}, {}, {}, {}
    if device.type == "cuda":
        # the process's first sync-debug window counts one call more,
        # whichever run comes first (a one-time effect, not obs's)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            torch.zeros(1).to(device)
            torch.cuda.set_sync_debug_mode("default")
    for obs in ("trace", "off"):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        syncs[obs] = []
        trainer = obs_trainer_run(torch, device, cfg, obs, syncs[obs])
        secs[obs] = time.perf_counter() - t
        counts = check(kernels, f"fedex+obs[{obs}]", want,
                       f"; {secs[obs]:.1f} s")
        for key, v in counts.items():
            launches[key] += v
        leaves[obs] = {**{f"global {p}": x for p, x in
                          _flat(trainer.global_lora).items()},
                       **{f"W0 {key}": x for key, x in collect_w0_leaves(
                           trainer.engine.specs, trainer.params).items()}}
        if obs == "trace":
            rec = trainer.recorder
            recs = rec.round_records()
            closed = [r for r in recs if "close_dispatch_us" in r]
            out["rounds"] = [{key: r.get(key) for key in (
                "round", "delivered", "close_dispatch_us", "close_block_us",
                "peak_bytes", "comm_match")} for r in recs]
            for r in out["rounds"]:
                print(f"  [obs] fedex+obs round {r['round']}: delivered "
                      f"{r['delivered']}, close_dispatch_us "
                      f"{r['close_dispatch_us']}, close_block_us "
                      f"{r['close_block_us']}, peak_bytes {r['peak_bytes']}, "
                      f"comm_match {r['comm_match']}", flush=True)
            if len(closed) != OBS_RUN["rounds"] or any(
                    r.get("comm_match") != 1 for r in closed):
                raise AssertionError(f"fedex+obs: closed rounds {closed}")
            paths = write_obs(rec, tmp, "fedex_obs")
            out["obs_report"] = obs_report(paths, "--check")
            out["spans"] = len(rec.tracer.spans)
            print(f"  [obs] obs_report.py --check --trace: "
                  f"{out['obs_report']} ({out['spans']} spans)", flush=True)
        del trainer
        _free(torch, device)
    same = leaves["trace"].keys() == leaves["off"].keys() and all(
        torch.equal(x, leaves["off"][k]) for k, x in leaves["trace"].items())
    print(f"  [obs] obs=trace == obs=off bitwise over "
          f"{len(leaves['trace'])} leaves (the global adapter and W0): "
          f"{same}; synchronising calls in the last weighted close: trace "
          f"{syncs['trace']}, off {syncs['off']}; run seconds trace "
          f"{secs['trace']:.1f}, off {secs['off']:.1f}", flush=True)
    if not same:
        raise AssertionError("fedex+obs: obs=trace differs from obs=off")
    if syncs["trace"] != syncs["off"]:
        raise AssertionError(f"fedex+obs: obs=trace syncs {syncs['trace']} "
                             f"!= obs=off {syncs['off']}")
    out.update(syncs_trace=syncs["trace"], syncs_off=syncs["off"],
               seconds_trace=secs["trace"], seconds_off=secs["off"])
    return launches, out


def http_deltas(torch, glob, rnd: int, cid: int, rank=None):
    """Client ``cid``'s seeded round-``rnd`` delta at the adapter's shapes
    (a and b ~ N(0, 0.02²), so b ≠ 0; a ragged client's leading ``rank``
    columns / rows)."""
    from repro_torch.util.tree import flatten_with_paths

    flat = flatten_with_paths(glob)
    gen = torch.Generator(device=next(iter(flat.values())).device)
    gen.manual_seed(1000 * rnd + cid)
    out = {}
    for p, x in flat.items():
        shape = list(x.shape)
        if rank is not None:
            shape[-1 if p.endswith("/a") else -2] = rank
        out[p] = torch.empty(shape, device=x.device).normal_(
            0.0, 0.02, generator=gen)
    return _unflat(out)


def w0_gb(specs) -> float:
    """GB of one copy of the adapted W0 leaves (what a digest hashes)."""
    return sum(4 * math.prod(s.w0_shape) for s in specs) / 1e9


def post_round(clients, deltas, rnd, ranks=None):
    """Every client POSTs its delta from its own thread, all started behind
    one barrier; returns the POSTs' seconds (host clock)."""
    import threading

    secs, errors = [None] * len(clients), []
    barrier = threading.Barrier(len(clients))

    def go(i):
        try:
            barrier.wait()
            t = time.perf_counter()
            resp = clients[i].submit_delta(
                deltas[i], round_id=rnd,
                rank=None if ranks is None else ranks[i])
            secs[i] = time.perf_counter() - t
            if resp["status"] != "accepted":
                errors.append(resp)
        except Exception as e:  # raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(s is None for s in secs):
        raise AssertionError(f"round {rnd} POSTs failed: {errors}")
    return secs


def http_server(torch, device, cfg, fed_kw, token=""):
    """A ``FederationServer`` at ``cfg``'s full width on 127.0.0.1 (an
    ephemeral port) over ``init_global_state``'s seed-0 draws, and the
    twin's params: the same leaves with the adapted W0 leaves cloned.
    Returns (server, httpd, url, twin params, global template)."""
    from repro_torch.configs import FedConfig, LoRAConfig, ServeConfig
    from repro_torch.core.engine import (build_factor_specs,
                                         collect_w0_leaves, fold_back_w0)
    from repro_torch.core.lora import init_global_state
    from repro_torch.fedsrv.server import FederationServer, start_http_server
    from repro_torch.models import build_model

    lcfg = LoRAConfig(rank=4, alpha=8.0)
    params, glob = init_global_state(build_model(cfg), lcfg, seed=0,
                                     device=device)
    specs = build_factor_specs(params, glob)
    twin_params = fold_back_w0(specs, params, {
        k: x.clone() for k, x in collect_w0_leaves(specs, params).items()})
    srv = FederationServer(params, glob, scale=lcfg.scale,
                           fed_cfg=FedConfig(obs="trace", **fed_kw),
                           serve_cfg=ServeConfig(port=0, token=token,
                                                 quota_per_round=2))
    httpd = start_http_server(srv, port=0)
    _sync(torch, device)
    return (srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}",
            twin_params, glob)


def http_probe(name, want, fn):
    """One status probe: ``fn`` must raise the transport error with
    ``want``'s (type, reason)."""
    from repro_torch.fedsrv import StaleUplinkError, TransportError

    try:
        fn()
    except (StaleUplinkError, TransportError) as e:
        got = (type(e).__name__, e.reason)
    else:
        got = ("accepted", "")
    print(f"  [http] probe {name}: {got}", flush=True)
    if got != want:
        raise AssertionError(f"probe {name}: {got} != {want}")


def http_status_probes(torch, srv, url, glob, phase):
    """``phase`` "open" (round 0 open): 401, 403, 400 (the payload's round
    is not the path's), 422 (a NaN uplink); "closed" (round 0 closed):
    409 (a round-0 POST), 429 (client 0's third round-0 POST); "done":
    410."""
    import urllib.error
    import urllib.request

    from repro_torch.fedsrv import AdapterCodec, FedClient
    from repro_torch.fedsrv.wire import payload_to_wire

    dev = srv.device

    def client(cid, **kw):
        return FedClient(url, cid, token=kw.pop("token", "tok"), retries=0,
                         device=dev, **kw)

    delta = http_deltas(torch, glob, 0, 0)
    if phase == "open":
        http_probe("401 bad token", ("TransportError", "auth"),
                   lambda: client(0, token="wrong").submit_delta(
                       delta, round_id=0))
        http_probe("403 unknown client", ("TransportError",
                                          "unknown_client"),
                   lambda: client(99).submit_delta(delta, round_id=0))
        body = payload_to_wire(AdapterCodec("none").encode(
            delta, round_id=1, client_id=0))
        req = urllib.request.Request(
            f"{url}/v1/rounds/0/deltas", data=body, method="POST",
            headers={"Authorization": "Bearer tok"})
        try:
            urllib.request.urlopen(req, timeout=120)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        print(f"  [http] probe 400 payload round 1 on path round 0: {code}",
              flush=True)
        if code != 400:
            raise AssertionError(f"probe 400: HTTP {code}")
        nan = http_deltas(torch, glob, 0, 3)
        next(iter(_flat(nan).values())).view(-1)[0] = float("nan")
        http_probe("422 NaN uplink", ("TransportError", "nonfinite"),
                   lambda: client(3).submit_delta(nan, round_id=0))
    elif phase == "closed":
        http_probe("409 round-0 POST after its close",
                   ("StaleUplinkError", "stale"),
                   lambda: client(0).submit_delta(delta, round_id=0))
        http_probe("429 quota", ("TransportError", "retries_exhausted"),
                   lambda: client(0).submit_delta(delta, round_id=0))
    else:
        http_probe("410 after the last close", ("StaleUplinkError", "done"),
                   lambda: client(0).submit_delta(delta, round_id=2))


def twin_feed(twin, codec, deltas, rnd, ranks=None):
    """The twin's round ``rnd``: every client's payload (the codec's encode
    of the same delta) through ``decode_into``, as the server's ingest."""
    twin.buffers.begin_round({i: i for i in range(len(deltas))},
                             round_id=rnd)
    for i, d in enumerate(deltas):
        codec.decode_into(codec.encode(
            d, round_id=rnd, client_id=i,
            rank=None if ranks is None else ranks[i]), twin.buffers)


def digest_beside(fn, pull):
    """``pull()`` (the server hashes its W0 in its handler thread) while
    ``fn()`` hashes the twin's here; hashlib releases the GIL. Returns
    (pull result, fn result, fn's seconds)."""
    import threading

    box = {}
    th = threading.Thread(target=lambda: box.update(pull=pull()))
    th.start()
    t = time.perf_counter()
    mine = fn()
    secs = time.perf_counter() - t
    th.join(timeout=600)
    if "pull" not in box:
        raise AssertionError("pull_latest failed")
    return box["pull"], mine, secs


def http_path(torch, kernels, device, cfg, tmp: Path, check=check_launches):
    """``serve-http`` then ``pull-serve``: a fedex server over 2 rounds of
    4 clients' POSTs (example weights, obs trace) against an in-process
    twin engine fed the same payloads, every status probed once, the
    server's metrics through ``obs_report.py --check``; then
    ``serve(pull_from=url)`` against ``serve`` given the twin's adapter.
    Returns (launches, stats)."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.core.engine import RoundCloseEngine
    from repro_torch.fedsrv import AdapterCodec, FedClient
    from repro_torch.fedsrv.server import w0_digest
    from repro_torch.launch.serve import serve

    k, rounds = HTTP_RUN["clients"], HTTP_RUN["rounds"]
    n_leaves = len(main_path_leaves(cfg))
    launches = {name: 0 for name in SOURCES}
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    srv, httpd, url, twin_params, glob = http_server(
        torch, device, cfg, dict(num_clients=k, rounds=rounds,
                                 weighting="examples"), token="tok")
    stats = {"setup_s": time.perf_counter() - t0}
    clients = [FedClient(url, i, token="tok", num_examples=HTTP_EXAMPLES[i],
                         device=device) for i in range(k)]
    deltas = [[http_deltas(torch, glob, rnd, i) for i in range(k)]
              for rnd in range(rounds)]
    post_s = []
    try:
        http_status_probes(torch, srv, url, glob, "open")
        for rnd in range(rounds):
            post_s += post_round(clients, deltas[rnd], rnd)
            if rnd == 0:
                http_status_probes(torch, srv, url, glob, "closed")
        _sync(torch, device)
        counts = check(kernels, "serve-http", {
            "fedex_fold": n_leaves * rounds, "factor_mean": rounds},
            f" ({rounds} closes)")
        for key, v in counts.items():
            launches[key] += v
        http_status_probes(torch, srv, url, glob, "done")
        # the twin: its own W0, the same payloads through decode_into
        twin = RoundCloseEngine(twin_params, glob, c_max=k,
                                scale=srv.engine.scale)
        codec = AdapterCodec("none")
        tparams, tglob = twin_params, None
        ns = [float(n) for n in HTTP_EXAMPLES]
        for rnd in range(rounds):
            twin_feed(twin, codec, deltas[rnd], rnd)
            tglob, tparams, div = twin.close(
                tparams, list(range(k)), [n / sum(ns) for n in ns],
                round_id=rnd)
            div.resolve()
        pull, twin_digest, twin_digest_s = digest_beside(
            lambda: w0_digest(twin.specs, tparams), clients[0].pull_latest)
        same = all(torch.equal(x, _flat(tglob)[p])
                   for p, x in _flat(pull.lora).items())
        print(f"  [http] pull_latest v{pull.version} == twin's global "
              f"adapter bitwise: {same}; X-Fed-W0-Digest "
              f"{pull.w0_digest[:16]}… == twin's: "
              f"{pull.w0_digest == twin_digest} (server digest "
              f"{srv.digest_s:.2f} s, twin's {twin_digest_s:.2f} s, "
              f"{w0_gb(twin.specs):.2f} GB each)", flush=True)
        if not same or pull.w0_digest != twin_digest or pull.version != 2:
            raise AssertionError("serve-http differs from its twin")
        srv.finalize()
        rec = srv.rec
        recs = rec.round_records()
        counters = rec.metrics.snapshot()["counters"]
        stats.update(
            post_ms_median=1e3 * statistics.median(post_s),
            post_ms_max=1e3 * max(post_s),
            close_ms=[(r["close_dispatch_us"] + r["close_block_us"]) / 1e3
                      for r in recs],
            close_dispatch_us=[r["close_dispatch_us"] for r in recs],
            close_block_us=[r["close_block_us"] for r in recs],
            digest_s=srv.digest_s, twin_digest_s=twin_digest_s,
            http_bytes=counters["uplink.http_bytes"],
            http_overhead_bytes=counters["uplink.http_overhead_bytes"],
            uplink_bytes=srv.ledger.totals()["uplink_bytes"],
            payload_bytes=4 * sum(x.numel() for x in _flat(glob).values()),
            pull_nbytes=pull.nbytes)
        stats["obs_report"] = obs_report(write_obs(rec, tmp, "serve_http"),
                                         "--check")
        print(f"  [http] serve-http: POST latency median "
              f"{stats['post_ms_median']:.1f} ms, max "
              f"{stats['post_ms_max']:.1f} ms ({len(post_s)} honest POSTs of "
              f"{stats['payload_bytes']} B from {k} threads); close ms "
              f"{[round(x, 2) for x in stats['close_ms']]} (dispatch us "
              f"{stats['close_dispatch_us']}, block us "
              f"{stats['close_block_us']}); HTTP bytes "
              f"{stats['http_bytes']}, overhead {stats['http_overhead_bytes']}"
              f", uplink payload bytes {stats['uplink_bytes']}; "
              f"obs_report.py --check: {stats['obs_report']}", flush=True)
        # pull-serve: serve() on its own drawn base with the pulled adapter
        kernels.reset_launch_counts()
        t = time.perf_counter()
        pulled = serve(cfg.name, device=device, pull_from=url, rank=4,
                       seed=0, dtype=torch.float32, **PULL_SERVE)
        stats["pull_serve_s"] = time.perf_counter() - t
        L = cfg.num_layers
        counts = check(kernels, "pull-serve", {
            "lora_matmul": 4 * L * (1 + PULL_SERVE["steps"]),
            "flash_swa": L}, f"; {stats['pull_serve_s']:.1f} s")
        for key, v in counts.items():
            launches[key] += v
    finally:
        httpd.shutdown()
        httpd.server_close()
    direct = serve(cfg.name, device=device, lora=tglob, rank=4, seed=0,
                   dtype=torch.float32, **PULL_SERVE)
    same = bool((pulled.tokens == direct.tokens).all())
    print(f"  [http] pull-serve tokens == serve with the twin's adapter: "
          f"{same} (first row {pulled.tokens[0].tolist()})", flush=True)
    if not same:
        raise AssertionError("pull-serve tokens differ from the twin's")
    del srv, twin, tparams, twin_params, glob, tglob, deltas, pull, clients
    _free(torch, device)
    return launches, stats


def http_hetero_path(torch, kernels, device, cfg, check=check_launches):
    """``serve-http-hetero``: a hetero server (ranks ``HTTP_HETERO_RANKS``,
    1 round), ragged POSTs carrying their rank, against an in-process twin:
    every client's base and rank-rᵢ adapter and the hetero digest bitwise
    the twin's; ``hetero_fold`` 4. Returns (launches, stats)."""
    from repro_torch.core.engine import (RoundCloseEngine, collect_w0_leaves,
                                         fold_back_w0)
    from repro_torch.fedsrv import AdapterCodec, FedClient
    from repro_torch.fedsrv.server import hetero_w0_digest

    k, ranks = len(HTTP_HETERO_RANKS), HTTP_HETERO_RANKS
    launches = {name: 0 for name in SOURCES}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    srv, httpd, url, twin_params, glob = http_server(
        torch, device, cfg, dict(num_clients=k, rounds=1, method="hetero",
                                 client_ranks=ranks))
    stats = {"setup_s": time.perf_counter() - t0}
    deltas = [http_deltas(torch, glob, 0, i, ranks[i]) for i in range(k)]
    try:
        clients = [FedClient(url, i, device=device) for i in range(k)]
        post_s = post_round(clients, deltas, 0, ranks)
        _sync(torch, device)
        counts = check(kernels, "serve-http-hetero",
                       {"hetero_fold": len(main_path_leaves(cfg))})
        for key, v in counts.items():
            launches[key] += v
        specs = srv.engine.specs
        twin = RoundCloseEngine(twin_params, glob, c_max=k,
                                scale=srv.engine.scale, method="hetero",
                                client_ranks=list(ranks))
        bases = [fold_back_w0(specs, twin_params, {
            key: x.clone() for key, x in
            collect_w0_leaves(specs, twin_params).items()}) for _ in ranks]
        codec = AdapterCodec("none")
        codec.register_spec(glob)  # pads the ragged payloads, as the server
        twin_feed(twin, codec, deltas, 0, ranks)
        new_cp, loras, tglob, div = twin.close_hetero(bases, list(range(k)),
                                                      round_id=0)
        div.resolve()
        bases = [new_cp[i] for i in range(k)]
        pull, twin_digest, twin_digest_s = digest_beside(
            lambda: hetero_w0_digest(specs, bases), clients[0].pull_latest)
        same = {
            "global": all(torch.equal(x, _flat(tglob)[p])
                          for p, x in _flat(pull.lora).items()),
            "bases": all(torch.equal(w, collect_w0_leaves(
                specs, bases[i])[key]) for i in range(k) for key, w in
                collect_w0_leaves(specs, srv.client_params[i]).items()),
            "adapters": all(torch.equal(x, _flat(loras[i])[p])
                            for i in range(k) for p, x in
                            _flat(srv.client_loras[i]).items()),
            "digest": pull.w0_digest == twin_digest}
        widths = {i: tuple(_flat(srv.client_loras[i]).values())[0].shape[-1]
                  for i in range(k)}
        print(f"  [http] serve-http-hetero (ranks {list(ranks)}, adapter "
              f"widths {widths}): bitwise the twin's {same} (server digest "
              f"{srv.digest_s:.2f} s, twin's {twin_digest_s:.2f} s, "
              f"{k} × {w0_gb(specs):.2f} GB); POSTs {[round(1e3 * s, 1) for s in post_s]}"
              f" ms", flush=True)
        if not all(same.values()) or widths != dict(enumerate(ranks)):
            raise AssertionError(f"serve-http-hetero differs: {same}")
        srv.finalize()
        stats.update(post_ms=[1e3 * s for s in post_s],
                     digest_s=srv.digest_s, twin_digest_s=twin_digest_s)
    finally:
        httpd.shutdown()
        httpd.server_close()
    del srv, twin, bases, new_cp, loras, tglob, twin_params, glob, deltas
    _free(torch, device)
    return launches, stats


def obs_http_phase(torch, kernels, device, cfg, check=check_launches):
    """Phase 6: ``fedex+obs``, ``serve-http`` with ``pull-serve``, then
    ``serve-http-hetero`` (after the first server is freed: each hetero
    client's W0 copy is 2.82 GB at ``paper-llama3.2-3b``). Streams go to a
    temporary directory under ``build/``. Returns (launches, stats)."""
    import tempfile

    launches = {name: 0 for name in SOURCES}
    stats = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, fn in (("fedex+obs", lambda: obs_path(
                              torch, kernels, device, cfg, Path(tmp), check)),
                         ("serve-http", lambda: http_path(
                             torch, kernels, device, cfg, Path(tmp), check)),
                         ("serve-http-hetero", lambda: http_hetero_path(
                             torch, kernels, device, cfg, check))):
            t = time.perf_counter()
            got, stats[name] = fn()
            stats[name]["seconds"] = time.perf_counter() - t
            for key, v in got.items():
                launches[key] += v
    return launches, stats


# --------------------------------------------------------------------------
# phase 7: mesh mode

MESH_RUN = {"clients": 4, "batch": 8, "seq": 64, "data_vocab": 512}
# name → (FedConfig settings, rounds, local steps). Step 0 of a run has lr 0
# (the warm-up), so a path's first round moves only b at its later steps
# and every lane's a stays equal: mesh-fedex_svd takes 3 steps, so that
# round 0's residual has rank above r' = 8 (its cut is visible), and
# mesh-budgets and the host twin run 2 rounds, whose second moves every
# factor from its first step on
MESH_PATHS = {
    "mesh-fedex": ({"participation": 0.5, "weighting": "examples"}, 3, 2),
    "mesh-fedex[host-twin]": ({}, 2, 2),
    "mesh-budgets": ({"client_local_steps": (1, 2, 2, 1)}, 2, 2),
    "mesh-fedex_svd": ({"method": "fedex_svd", "svd_rank": 8,
                        "weighting": "examples"}, 2, 3),
    "mesh+faults": ({"faults": "nan@1(clients=1,rounds=1)"}, 2, 2),
}
MESH_QUARANTINED = {"mesh+faults": [[], [(1, "nonfinite")]]}


def own_w0(base):
    """(params, global_lora) of the shared draw ``base``, with a copy of the
    adapted W0 leaves of its own (the kernel close folds into them in
    place) and the other leaves shared."""
    from repro_torch.core.engine import (build_factor_specs,
                                         collect_w0_leaves, fold_back_w0)

    params, glob = base
    specs = build_factor_specs(params, glob)
    return fold_back_w0(specs, params, {
        k: w.clone() for k, w in collect_w0_leaves(specs, params).items()}
    ), glob


def mesh_configs(cfg, fed_kw, rounds, steps):
    from repro_torch.configs import FedConfig, LoRAConfig, TrainConfig
    from repro_torch.models import build_model

    return dict(model=build_model(cfg),
                lora_cfg=LoRAConfig(rank=4, alpha=8.0),
                fed_cfg=FedConfig(num_clients=MESH_RUN["clients"],
                                  rounds=rounds, local_steps=steps, **fed_kw),
                train_cfg=TrainConfig(learning_rate=5e-3,
                                      schedule="constant",
                                      total_steps=rounds * steps),
                seed=0)


def mesh_data(device):
    from repro_torch.launch.train import build_federated_data

    loaders, evals = build_federated_data(
        MESH_RUN["data_vocab"], MESH_RUN["clients"], seq_len=MESH_RUN["seq"],
        batch_size=MESH_RUN["batch"], device=device)
    return dict(client_loaders=loaders, eval_batches=evals)


def mesh_twin(torch, kernels, device, cfg, base, mesh, rows, check):
    """``mesh-fedex[host-twin]``'s other half: the host FederatedTrainer at
    the same seed, draws and data (a full uniform round closes without a
    kernel). Its client losses, eval losses and divergences within the CPU
    parity tolerances of the mesh run's, its W0 and global adapter within
    1e-2 relative Frobenius and the AdamW separation bound. Returns the
    host rounds' client-step ms."""
    from repro_torch.core import FederatedTrainer

    kw = mesh_configs(cfg, *MESH_PATHS["mesh-fedex[host-twin]"])
    params, glob = own_w0(base)
    host = FederatedTrainer(**kw, **mesh_data(device), device=device,
                            params=params, global_lora=glob)
    step_ms, local_step = [], host.local_step

    def timed(*args):
        _sync(torch, device)
        t = time.perf_counter()
        out = local_step(*args)
        _sync(torch, device)
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    host.local_step = timed
    kernels.reset_launch_counts()
    hist = host.run()
    check(kernels, "mesh-fedex[host-twin] host", {},
          " (full uniform rounds: the uniform close)")
    fc = kw["fed_cfg"]
    sep = 2 * kw["train_cfg"].learning_rate * fc.local_steps * fc.num_clients
    worst = {"loss": 0.0, "eval": 0.0, "div": 0.0, "fro": 0.0, "abs": 0.0}
    for h, m in zip(hist, mesh.history):
        for key, a, b in (("loss", h.client_losses, m.client_losses),
                          ("eval", [h.eval_loss], [m.eval_loss])):
            for x, y in zip(a, b):
                worst[key] = max(worst[key], abs(x - y) / abs(x))
        d = abs(h.divergence_scaled - m.divergence_scaled)
        if d > 1e-3 * abs(h.divergence_scaled) + 1e-7:
            raise AssertionError(f"host twin: divergence {h.divergence_scaled}"
                                 f" vs mesh {m.divergence_scaled}")
        worst["div"] = max(worst["div"], d / abs(h.divergence_scaled))
    specs = mesh.closer.specs
    pairs = [(f"{s.key}/kernel", _node(host.params, s.key)["kernel"],
              _node(mesh.params, s.key)["kernel"]) for s in specs]
    pairs += [(k, x, _flat(mesh.global_lora)[k])
              for k, x in _flat(host.global_lora).items()]
    for k, x, y in pairs:
        diff = (x - y).float()
        fro = float(torch.linalg.norm(diff)) / max(
            float(torch.linalg.norm(x.float())), 1e-30)
        worst["fro"] = max(worst["fro"], fro)
        worst["abs"] = max(worst["abs"], float(diff.abs().max()))
    ok = (worst["loss"] <= 1e-5 and worst["eval"] <= 1e-5
          and worst["fro"] <= 1e-2 and worst["abs"] <= sep)
    steps = fc.local_steps * fc.num_clients
    host_ms = [sum(step_ms[i * steps:(i + 1) * steps])
               for i in range(fc.rounds)]
    print(f"  [mesh-fedex[host-twin]] against the host trainer: max rel "
          f"client loss {worst['loss']:.3e}, eval loss {worst['eval']:.3e} "
          f"(rtol 1e-5), divergence {worst['div']:.3e} (rtol 1e-3, atol "
          f"1e-7); W0 and global adapter max rel Frobenius "
          f"{worst['fro']:.3e} (≤ 1e-2), max |Δ| {worst['abs']:.3e} (≤ "
          f"{sep:.3e}); within={ok}", flush=True)
    for rnd, (row, ms) in enumerate(zip(rows, host_ms)):
        median = statistics.median(step_ms[rnd * steps:(rnd + 1) * steps])
        print(f"  [mesh-fedex[host-twin]] round {rnd}: mesh training round "
              f"{row['train_ms']:.1f} ms (4 lanes × {fc.local_steps} steps "
              f"in one stacked round) vs the host's {steps} client steps "
              f"{ms:.1f} ms (median step {median:.1f} ms)", flush=True)
    if not ok:
        raise AssertionError(f"mesh-fedex[host-twin]: mesh and host trainers "
                             f"differ: {worst}")
    return {"host_round_ms": host_ms, "host_step_ms": step_ms, **worst}


def mesh_path(torch, kernels, device, cfg, base, name, check=check_launches):
    """One path of ``MESH_PATHS``: the port's MeshFederatedTrainer at full
    width on its own copy of the adapted W0 leaves of ``base``. Its round
    function and close are wrapped: each training round is timed (device
    syncs around it), each close fills the lanes its round left out with
    NaN, is timed, its launches counted (the same every round) and its
    identity checked over the round's lanes (``identity_fedex``, or
    ``identity_svd``), its outputs finite. Returns (launches, stats)."""
    from types import SimpleNamespace

    from repro_torch.launch.mesh_train import (MeshFederatedTrainer,
                                               make_mesh_round_fn)

    fed_kw, rounds, steps = MESH_PATHS[name]
    kw = mesh_configs(cfg, fed_kw, rounds, steps)
    params, glob = own_w0(base)
    trainer = MeshFederatedTrainer(**kw, **mesh_data(device), device=device,
                                   params=params, global_lora=glob)
    closer, c = trainer.closer, kw["fed_cfg"].num_clients
    svd = closer.method == "fedex_svd"
    keys = [s.key for s in closer.specs]
    per_close = {"factor_mean": 1,
                 "product_fold" if svd else "fedex_fold": len(keys)}
    identity = identity_svd if svd else identity_fedex
    rows, round_fn, close = [], trainer.round_fn, closer.close

    def timed_round(params, lora_stack, batches, lrs, *budgets):
        _sync(torch, device)
        t = time.perf_counter()
        out = round_fn(params, lora_stack, batches, lrs, *budgets)
        _sync(torch, device)
        rows.append({"round": len(rows),
                     "train_ms": (time.perf_counter() - t) * 1e3,
                     "losses": out[1].tolist(), "lr0": lrs[0]})
        if budgets and lrs[0] > 0:  # the budget lanes against 1 step
            one, _ = make_mesh_round_fn(trainer.model, trainer.scale,
                                        kw["train_cfg"])(
                params, lora_stack, {k: v[:, :1] for k, v in
                                     batches.items()}, lrs[:1])
            lanes = [i for i, b in enumerate(budgets[0]) if b == 1]
            got, want = _flat(out[0]), _flat(one)
            same = all(torch.equal(got[k][i], want[k][i])
                       for k in got for i in lanes)
            repeat = all(out[1][i, 0] == out[1][i, -1] for i in lanes)
            print(f"  [{name}] round {len(rows) - 1}: budget-1 lanes "
                  f"{lanes} bitwise an unmasked 1-step round from the same "
                  f"start and batches: {same}; their losses repeat: "
                  f"{repeat}", flush=True)
            if not (same and repeat):
                raise AssertionError(f"{name}: the frozen lanes moved")
            rows[-1]["budget_lanes_bitwise"] = same
        return out

    def checked_close(params, stacks, ids, weights=None, *, round_id=None):
        row = rows[-1]
        out_lanes = [i for i in range(c) if i not in ids]
        row["zeroed"] = [i for i in out_lanes
                         if all(not x[i].any() for x in stacks.values())]
        for x in stacks.values():
            x[out_lanes] = float("nan")
        old = {k: _node(params, k)["kernel"].clone() for k in keys}
        before = kernels.launch_counts()
        _sync(torch, device)
        t = time.perf_counter()
        new_glob, new_params, div = close(params, stacks, ids, weights,
                                          round_id=round_id)
        _sync(torch, device)
        row["close_ms"] = (time.perf_counter() - t) * 1e3
        after = kernels.launch_counts()
        row["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        if device.type == "cuda" and row["launches"] != per_close:
            raise AssertionError(f"{name}: a close launched "
                                 f"{row['launches']}, not {per_close}")
        w, _ = closer.weight_vector(ids, weights)
        outcome = SimpleNamespace(
            delivered=[SimpleNamespace(lora=_unflat(
                {p: x[i] for p, x in stacks.items()})) for i in ids],
            weights=[float(w[i]) for i in ids])
        view = SimpleNamespace(scale=trainer.scale, global_lora=new_glob,
                               params=new_params, device=device,
                               engine=SimpleNamespace(
                                   svd_rank=kw["fed_cfg"].svd_rank))
        row.update(ids=list(ids), identity=identity(torch, view, outcome,
                                                    [old], keys))
        bad = [k for k, x in (*_flat(new_glob).items(),
                              *((k, _node(new_params, k)["kernel"])
                                for k in keys))
               if not bool(torch.isfinite(x).all())]
        if bad:
            raise AssertionError(f"{name}: the close's outputs are not "
                                 f"finite at {bad} (NaN in lanes "
                                 f"{out_lanes})")
        return new_glob, new_params, div

    trainer.round_fn, closer.close = timed_round, checked_close
    t = time.perf_counter()
    hist = trainer.run()
    _sync(torch, device)
    wall = time.perf_counter() - t
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    closes = sum(1 for row in rows if "close_ms" in row)
    counts = check(kernels, name, {k: v * closes for k, v in
                                   per_close.items()},
                   f" for {closes} closes; peak memory {peak:.1f} GiB")
    values = [v for h in hist for v in (h.eval_loss, h.divergence_scaled,
                                        *h.client_losses)]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{name}: non-finite losses or divergence")
    for row, h in zip(rows, hist):
        nan = [i for i in range(c) if i not in row.get("ids", ())]
        print(f"  [{name}] round {row['round']} [lanes {row.get('ids')}, "
              f"NaN-filled {nan}]: training round {row['train_ms']:.1f} ms, "
              "close "
              f"{row.get('close_ms', float('nan')):.2f} ms (launches "
              f"{row.get('launches')}), eval_loss {h.eval_loss:.4f}, "
              f"divergence {h.divergence_scaled:.3e}", flush=True)
    want_q = MESH_QUARANTINED.get(name, [[] for _ in range(rounds)])
    got_q = [[tuple(p) for p in q] for q in trainer.quarantined]
    zeroed = [row.get("zeroed", []) for row in rows]
    if got_q != want_q or any(
            [cid for cid, _ in q if cid not in z] for q, z in
            zip(got_q, zeroed)):
        raise AssertionError(f"{name}: quarantined {got_q} (zeroed lanes "
                             f"{zeroed}), expected {want_q}")
    if name in MESH_QUARANTINED:
        print(f"  [{name}] quarantined (client, reason) per round {got_q}, "
              f"each zeroed before the close ({zeroed}); the global adapter "
              "finite, the identity held over the survivors", flush=True)
    stats = {"rounds": [{k: v for k, v in row.items() if k != "losses"}
                        for row in rows],
             "peak_gib": peak, "wall_s": wall,
             "eval_loss": [h.eval_loss for h in hist],
             "divergence": [h.divergence_scaled for h in hist]}
    if name == "mesh-fedex[host-twin]":
        stats["host"] = mesh_twin(torch, kernels, device, cfg, base, trainer,
                                  rows, check)
    return counts, stats


def mesh_phase(torch, kernels, device, cfg, check=check_launches):
    """Phase 7: ``MESH_PATHS`` in turn, from one draw of ``cfg``'s weights
    (seed 0, the host trainer's recipe), each path with the launch counters
    set to 0 just before it and read just after. Returns (launches,
    stats)."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.core import init_global_state
    from repro_torch.models import build_model
    from repro_torch.util.tree import count_params

    t = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    base = init_global_state(build_model(cfg), LoRAConfig(rank=4, alpha=8.0),
                             device=device, generator=gen)
    _sync(torch, device)
    print(f"  [mesh] one draw of {cfg.name} ({count_params(base[0]) / 1e9:.2f}"
          f" B params), shared by the paths, each on its own copy of the "
          f"adapted W0 leaves: {time.perf_counter() - t:.1f} s; "
          f"{MESH_RUN['clients']} lanes of batch {MESH_RUN['batch']} × seq "
          f"{MESH_RUN['seq']}", flush=True)
    launches = {name: 0 for name in SOURCES}
    stats = {}
    for name in MESH_PATHS:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        got, stats[name] = mesh_path(torch, kernels, device, cfg, base, name,
                                     check)
        stats[name]["seconds"] = time.perf_counter() - t
        for key, v in got.items():
            launches[key] += v
        _free(torch, device)
    return launches, stats


# --------------------------------------------------------------------------
# phase 8: the rest of the dense zoo
# --------------------------------------------------------------------------

# model → (its training path, serving batch, prompt, greedy decode steps).
# gemma3's prompt is twice its window: the reference fills a ring cache
# left-aligned with the prompt's tail, so a prompt longer than the window
# and not a multiple of it has its first decode steps overwrite keys still
# inside the window (tests/test_torch_window.py holds the port to that)
ZOO = {"gemma3-12b": ("gemma3-fedex", 2, 2048, 32),
       "granite-8b": ("granite-fedex", 8, 512, 32),
       "starcoder2-15b": ("starcoder2-fedex", 8, 512, 32)}


class window_log:
    """Within the block, the window of every prefill attention call
    (``swa_attention``, passed through to the kernel wrapper) goes into
    ``windows``."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.windows = attention, []

    def __enter__(self):
        self.saved = self.mod.swa_attention

        def logged(q, k, v, causal=True, window=0):
            self.windows.append(window)
            return self.saved(q, k, v, causal, window)

        self.mod.swa_attention = logged
        return self

    def __exit__(self, *exc):
        self.mod.swa_attention = self.saved


def prefill_windows(cfg) -> dict:
    """window → prefill attention launches of ``cfg`` (0: global)."""
    if cfg.local_global_ratio:
        nper = cfg.num_layers // (cfg.local_global_ratio + 1)
        return {cfg.local_window: nper * cfg.local_global_ratio, 0: nper}
    return {cfg.sliding_window: cfg.num_layers}


def zoo_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At gemma3's shapes: B8 at its prefill (batch 2, prompt 2048, GQA
    16/8, head dim 256) without a window and with its window of 1024, each
    against its plain version with SDPA beside it (:func:`flash_case`); B3
    at one layer's q/k/v/o at prefill (M 4096) and decode (M 2)
    (:func:`lora_case`); B1 and B2 over a weighted close's 8 leaves at 2
    live lanes of 4 (:func:`kernel_phase`). Every case in device time too.
    Returns (max errors, timings)."""
    _, bsz, prompt, _ = ZOO[cfg.name]
    timer = Timer(torch, device)
    errs = {"flash_swa": 0.0, "lora_matmul": 0.0}
    timings = {}
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for i, (key, window) in enumerate((("gemma3", 0),
                                       ("gemma3_W1024", cfg.local_window))):
        err, timings[f"flash_{key}"] = flash_case(
            torch, kernels, timer, device, bsz, prompt, h, kvh, hd, True,
            window, seed=70 + i, device_times=True)
        errs["flash_swa"] = max(errs["flash_swa"], err)
    for key, m in (("gemma3", bsz * prompt), ("gemma3_decode", bsz)):
        bufs = [lora_inputs(torch, device, m, k, n, r, seed=80 + i)
                for i, (_, k, n) in enumerate(serving_projections(cfg))]
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{cfg.name} layer: q/k/v/o at M={m}", device_times=True)
        errs["lora_matmul"] = max(errs["lora_matmul"], err)
        del bufs
    fold_errs, fold = kernel_phase(torch, kernels, device, cfg, c=4, r=r,
                                   scale=scale, bodies=("weighted-partial",),
                                   edges=False)
    errs.update(fold_errs)
    timings.update(fold["weighted-partial"])
    torch.cuda.empty_cache()
    return errs, timings


def zoo_serve(torch, kernels, device, cfg, params, lora, *, batch, prompt,
              steps):
    """Serve ``cfg`` from ``params`` / ``lora`` (a trainer's folded W0 and
    global adapter) on an f32 cache of prompt + steps positions (a windowed
    layer's: a ring of ``min(window, prompt + steps)``). First teacher
    forcing, with the counters set to 0 just before each step: one prefill
    of the prompt (``lora_matmul`` 4·L, ``flash_swa`` L, their windows
    :func:`prefill_windows`) and one decode step of the next token
    (``lora_matmul`` 4·L) against the training forward over prompt + 1
    within ``D_TOL``, its argmax agreeing on every row whose top-2 margin
    exceeds twice that. Then the main path, ``serve()`` with 1 prefill and
    ``steps`` greedy decode steps, the counters set to 0 just before and
    read just after. Returns (stats, launches)."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    L, lcfg = cfg.num_layers, LoRAConfig(rank=4, alpha=8.0)
    model = build_model(cfg)
    max_len = prompt + steps
    data = make_batch_for(cfg, batch, prompt, seed=0, device=device)
    full = torch.cat([data["tokens"], data["targets"][:, -1:]], dim=1)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(batch, max_len, torch.float32, device=device)
        with window_log() as log:
            _, cache = make_prefill_step(model, lcfg)(params, lora, data,
                                                      cache)
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} one prefill",
                {"lora_matmul": 4 * L, "flash_swa": L})
        windows = {w: log.windows.count(w) for w in sorted(set(log.windows))}
        print(f"  [serve] {cfg.name} prefill attention launches by window "
              f"(0: global): {windows}", flush=True)
        if windows != prefill_windows(cfg):
            raise AssertionError(f"serve {cfg.name}: prefill windows "
                                 f"{windows} != {prefill_windows(cfg)}")
        kernels.reset_launch_counts()
        _, dec, cache = make_decode_step(model, lcfg)(
            params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} one decode step", {"lora_matmul": 4 * L})
        del cache
        got = dec[:, -1]
        train = model.apply(params, {"tokens": full}, lora=lora,
                            lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        ok, err_tf = _allclose(got, train, *D_TOL)
        top2 = torch.topk(train, 2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > 2 * (D_TOL[1]
                                              + D_TOL[0] * top2[:, 0].abs())
        same = got.argmax(-1) == train.argmax(-1)
        agree = bool(same[sure].all())
        print(f"  [serve] {cfg.name} teacher-forced decode (f32 cache) vs the "
              f"training forward: max |diff| {err_tf:.3e} (rtol, atol "
              f"{D_TOL}): within={ok}; argmax agrees on {int(same.sum())} of "
              f"{batch} rows, on the {int(sure.sum())} rows whose top-2 "
              f"margin exceeds 2 x tol: {agree}; logit scale "
              f"{float(train.abs().max()):.3f}", flush=True)
        if not (ok and agree):
            raise AssertionError(f"serve {cfg.name}: prefill + decode "
                                 "disagree with the training forward")
        del dec, got, train, top2
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(cfg.name, batch_size=batch, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                dtype=torch.float32, cache_dtype=torch.float32)
    launches = kernels.launch_counts()
    _expect(kernels, f"{cfg.name} serve() (1 prefill + {steps} decode steps)",
            {"lora_matmul": 4 * L * (1 + steps), "flash_swa": L})
    toks = res.tokens
    if toks.shape != (batch, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve {cfg.name}: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": batch * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": batch * prompt / (res.prefill_ms / 1e3),
             "err_teacher_forced": err_tf}
    print(f"  [serve] {cfg.name} batch {batch}, prompt {prompt}, {steps} "
          f"decode steps, f32 cache of {max_len}: prefill "
          f"{res.prefill_ms:.1f} ms ({stats['prefill_tokens_per_s']:.0f} "
          f"tokens/s), decode {res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch); "
          f"first row {toks[0, :8].tolist()}", flush=True)
    return stats, launches


def zoo_model(torch, kernels, device, name):
    """One zoo model at full width and depth in float32: its training path
    (``ZOO_PATHS`` through :func:`drive_path`, the counters set to 0 just
    before it and read just after: ``factor_mean`` 1 and ``fedex_fold`` one
    a leaf per weighted close), then :func:`zoo_serve` of the trained W0
    and global adapter; its peak memory over both. Returns (stats,
    launches)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.util.tree import count_params

    path, bsz, prompt, steps = ZOO[name]
    cfg = replace(get_config(name), dtype="float32")
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trainer, rows, closes, identity = drive_path(torch, device, cfg, path)
    n_leaves = len(trainer.engine.specs)
    if n_leaves != len(main_path_leaves(cfg)):
        raise AssertionError(f"{path}: {n_leaves} adapted leaves, expected "
                             f"{len(main_path_leaves(cfg))}")
    *_, per_leaf, per_close = ZOO_PATHS[path]
    want = {k: v * n_leaves * closes for k, v in per_leaf.items()}
    want.update({k: v * closes for k, v in per_close.items()})
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(check_launches(
        kernels, path, want, f" for {closes} kernel closes of {n_leaves} "
        f"leaves; peak memory {train_peak:.1f} GiB"))
    values = [v for row in rows for v in
              (row["eval_loss"], row["divergence"], *row["client_losses"])]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{path}: non-finite losses or divergence: "
                             f"{rows}")
    last = rows[-1]
    stats = {"params_b": count_params(trainer.params) / 1e9,
             "layers": cfg.num_layers, "train_s": time.perf_counter() - t,
             "client_step_ms": last["step_ms"], "close_ms": last["close_ms"],
             "train_peak_gib": train_peak, "fold_err": identity,
             "rounds": [{k: v for k, v in row.items()
                         if k != "client_losses"} for row in rows]}
    t = time.perf_counter()
    served, got = zoo_serve(torch, kernels, device, cfg, trainer.params,
                            trainer.global_lora, batch=bsz, prompt=prompt,
                            steps=steps)
    for k, v in got.items():
        launches[k] += v
    stats.update(served, serve_s=time.perf_counter() - t,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  [zoo] {name}: {stats['params_b']:.2f} B params, "
          f"{cfg.num_layers} layers; train {stats['train_s']:.1f} s (client "
          f"step {last['step_ms']:.1f} ms, weighted close "
          f"{last['close_ms']:.2f} ms), serve {stats['serve_s']:.1f} s; "
          f"peak {stats['peak_gib']:.2f} GiB", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches


def zoo_phase(torch, kernels, device):
    """Phase 8: the kernels at gemma3's shapes (:func:`zoo_kernel_phase`),
    then each model of ``ZOO`` trained and served (:func:`zoo_model`), one
    at a time, each freed before the next. Returns (max errors, timings,
    launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gcfg = replace(get_config(next(iter(ZOO))), dtype="float32")  # gemma3
    errs, timings = zoo_kernel_phase(torch, kernels, device, gcfg, r=4,
                                     scale=2.0)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    for name in ZOO:
        stats[name], got = zoo_model(torch, kernels, device, name)
        for k, v in got.items():
            launches[k] += v
    stats["seconds"] = time.perf_counter() - t
    stats["peak_gib"] = max([stats["kernels_peak_gib"]]
                            + [stats[n]["peak_gib"] for n in ZOO])
    print(f"  [zoo] phase 8 in {stats['seconds']:.1f} s, peak memory "
          f"{stats['peak_gib']:.2f} GiB", flush=True)
    return errs, timings, launches, stats


# --------------------------------------------------------------------------
# phase 9: serving in bf16, the reference's default dtype
# --------------------------------------------------------------------------

# name → (batch, prompt, decode steps, cache length): phase 5's shape for
# paper-llama3.2-3b and paper-gpt2, phase 8's for gemma3-12b
BF16_SERVE = {"paper-llama3.2-3b": (8, 512, 32, 1024),
              "paper-gpt2": (8, 512, 32, 1024),
              "gemma3-12b": (2, 2048, 32, 2080)}
# teacher-forced decode (bf16 cache) against the bf16 training forward:
# at most this share of the training forward's largest |logit|, stated
# before the first run (phase 5 saw 2% at f32 weights with a bf16 cache).
# It and bf16_serve's limits against the f32 prefill are smoke checks: they
# catch a broken path (a missed layer, a wrong cast), not a rounding at
# another place, which the kernel checks pin (each kernel within its bound
# at every served shape, and bitwise on the probes). On an H100 sound runs
# read 1.2-6.4% here and the kernel path 1.01-1.04x the plain path's
# distance from the f32 answer.
TF_BF16 = 0.1


def tc_calls(torch, kernels, bufs, scale, label, want, decode=False):
    """Run ``lora_matmul`` once on each of ``bufs`` and require ``want``
    of the calls to take the tensor-core body (``bf16_tc_launches``), or
    with ``decode`` the tensor-core split-K body
    (``bf16_tc_decode_launches``)."""
    key = "bf16_tc_decode_launches" if decode else "bf16_tc_launches"
    before = getattr(kernels.lora_matmul, key)
    for buf in bufs:
        kernels.lora_matmul(*buf, scale)
    torch.cuda.synchronize()
    got = getattr(kernels.lora_matmul, key) - before
    if got != want:
        raise AssertionError(f"lora_matmul {label}: {got} of {len(bufs)} "
                             f"calls took the tensor-core "
                             f"{'split-K ' if decode else ''}body, not "
                             f"{want}")


def bf16_kernel_phase(torch, kernels, device):
    """B3 and B8 in bf16 against their bf16 plain versions, each within its
    bound (``lora_matmul_error_bound`` / ``swa_error_bound``, bf16 terms),
    two runs bitwise equal, timed beside the plain version, the library
    call in bf16 (``torch.addmm`` / SDPA with ``enable_gqa``) and the bound
    at the bf16 tensor-core peak (:func:`lora_case`, :func:`flash_case`):
    B3 at each served model's q/k/v/o at prefill (batch · prompt rows) and
    decode (batch rows) and at the serve launcher's M 64 (every prefill
    and M 64 call through the tensor-core body, every decode call through
    the tensor-core split-K body: :func:`tc_calls`), then r 1, 4 and 64 and
    odd K and N (the
    scalar paths) and an x view off 16-byte alignment; B8 at d 64
    (paper-gpt2, B 8, S 512, MHA 12/12), d 128 (paper-llama3.2-3b, B 8, S
    512, GQA 24/8) and d 256 (gemma3-12b, B 2, S 2048, GQA 16/8, no window
    and window 1024), each call through its tensor-core body; then both on
    the exact-rounding probes (:func:`bf16_probes`). Returns (max errors,
    timings)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    timer = Timer(torch, device)
    low = torch.bfloat16
    cfg = get_config("paper-llama3.2-3b")
    r, scale = 4, 2.0
    errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}

    def bf16(bufs):
        return [t.to(low) for t in bufs]

    # each served model's q/k/v/o at its prefill rows (batch · prompt), its
    # decode rows (batch) and the serve launcher's M 64
    gcfg, g3 = get_config("paper-gpt2"), get_config("gemma3-12b")
    for prefix, c in (("", cfg), ("gpt2_", gcfg), ("gemma3_", g3)):
        bsz, prompt = BF16_SERVE[c.name][:2]
        rows = [("bf16", bsz * prompt), ("bf16_decode", bsz),
                ("bf16_M64", short_prompt_rows())]
        for key, m in rows:
            bufs = [bf16(lora_inputs(torch, device, m, k, n, r, seed=90 + i))
                    for i, (_, k, n) in enumerate(serving_projections(c))]
            tc_calls(torch, kernels, bufs, scale, f"bf16 {c.name} M={m}",
                     len(bufs), decode=m <= SKINNY_ROWS)
            err, timings[prefix + key] = lora_case(
                torch, kernels, timer, bufs, scale,
                f"bf16 {c.name} layer: q/k/v/o at M={m}", device_times=True)
            errs["lora_matmul"] = max(errs["lora_matmul"], err)
            del bufs
    projs = serving_projections(cfg)
    d, nq, nkv = projs[0][1], projs[0][2], projs[1][2]
    for m, k, n, r_e in [(4096, d, nq, 1), (4096, d, nq, 64), (8, d, nq, 1),
                         (8, d, nkv, 64), (7, 777, 333, 1), (9, 777, 333, 16),
                         (16, 777, 333, 64), (1000, 777, 333, 4),
                         (17, d, nq, 3)]:
        bufs = [bf16(lora_inputs(torch, device, m, k, n, r_e, seed=m + r_e))]
        err, _ = lora_case(torch, kernels, timer, bufs, scale,
                           f"bf16 edge M={m} K={k} N={n} r={r_e}")
        errs["lora_matmul"] = max(errs["lora_matmul"], err)
        del bufs
    x, w, a, b = bf16(lora_inputs(torch, device, 1001, 777, 333, r, seed=9))
    if x[1:].data_ptr() % 16 == 0:
        raise AssertionError("the misaligned bf16 case is 16-byte aligned")
    err, _ = lora_case(torch, kernels, timer, [[x[1:], w, a, b]], scale,
                       "bf16 x view one row in, M=1000 K=777 N=333")
    errs["lora_matmul"] = max(errs["lora_matmul"], err)
    del x, w, a, b
    for i, (key, c, bsz, s, window) in enumerate((
            ("flash_bf16_gpt2", gcfg, 8, 512, 0),
            ("flash_bf16", cfg, 8, 512, 0),
            ("flash_bf16_gemma3", g3, 2, 2048, 0),
            ("flash_bf16_gemma3_W1024", g3, 2, 2048, g3.local_window))):
        err, timings[key] = flash_case(
            torch, kernels, timer, device, bsz, s, c.num_heads,
            c.num_kv_heads, c.resolved_head_dim, True, window, seed=100 + i,
            device_times=True, dtype=low, tc=True)
        errs["flash_swa"] = max(errs["flash_swa"], err)
    torch.cuda.empty_cache()
    bf16_probes(torch, kernels, device, (cfg, gcfg, g3))
    return errs, timings


def bf16_probes(torch, kernels, device, cfgs):
    """B3 and B8 on the exact-rounding probes of ``kernels/probes.py``, at
    each model of ``cfgs``' served shapes (``BF16_SERVE``): B3 at every
    q/k/v/o at the decode rows (the split-K body, each at its plan's K
    chunks) and the prefill rows (the tensor-core body), then at odd K and
    N (the tiled body's scalar paths), at K 64 (one chunk) and at the
    tensor-core body's other plans (r 1, 12, 17, 33 and 64: x@a as
    m64nNAk16 at NA 8, 16, 32 and 64; ragged M, K and N; no second W box);
    B8 at each model's prefill
    (causal), non-causal and at d 66 (the scalar loads). Each result must
    equal the plain version bit for bit (B3: and the exact answer), and
    differ from every faulty
    variant (x@a unrounded or rounded per K chunk; p unrounded, or l summing
    the rounded p) in some element. Launches here are not the main path's
    (the counters are reset before it)."""
    cases = []
    for c in cfgs:
        bsz, prompt = BF16_SERVE[c.name][:2]
        for _, k, n in serving_projections(c):
            cases += [(c.name, bsz, k, n, 4), (c.name, bsz * prompt, k, n, 4)]
    cases += [("odd", 9, 777, 333, 3), ("odd", 1, 200, 512, 64),
              ("one chunk", 4, 64, 256, 4),
              ("odd", 17, 777, 333, 3), ("odd", 1000, 776, 333, 64),
              ("tc", 4095, 3072, 1024, 1), ("tc", 300, 3072, 40, 17),
              ("tc", 1000, 3840, 2048, 33), ("tc", 17, 776, 1000, 64),
              ("tc", 129, 3072, 1024, 12)]
    lora_probes(torch, kernels, device, cases, bodies=True)
    flash = [(c.name, *BF16_SERVE[c.name][:2], c.num_heads, c.num_kv_heads,
              c.resolved_head_dim, True) for c in cfgs]
    flash += [("non-causal", 2, 300, 4, 2, 128, False),
              ("d 66", 2, 130, 4, 4, 66, True)]
    flash_probes(torch, kernels, device, flash)


def lora_probes(torch, kernels, device, cases, bodies=False):
    """B3 on :func:`~repro_torch.kernels.probes.lora_probe` at each
    (label, M, K, N, r) of ``cases``, bitwise the plain version and the
    exact answer and apart from every faulty variant; with ``bodies`` the
    cases must reach the tensor-core and the tiled body."""
    from repro_torch.kernels import probes
    from repro_torch.kernels.lora_matmul import (SKINNY_ROWS, _adapter_rows,
                                                 _body, _sm_count,
                                                 _split_plan, _tc_split_plan)

    sms = _sm_count(device.index or 0)
    seen, plans, padded = {}, set(), set()
    for i, (label, m, k, n, r) in enumerate(cases):
        body = _body(m, k, n, True, True)
        plan = None if m > SKINNY_ROWS else (
            _tc_split_plan if body == "tensor-core split-K" else _split_plan)(
                n, k, sms)
        chunk = plan[1] if plan else 64
        x, w, a, b, scale, want, faults = probes.lora_probe(
            m, k, n, r, chunk=chunk, device=device, seed=i)
        tc, tcd = (kernels.lora_matmul.bf16_tc_launches,
                   kernels.lora_matmul.bf16_tc_decode_launches)
        got = kernels.lora_matmul(x, w, a, b, scale)
        tc, tcd = (kernels.lora_matmul.bf16_tc_launches - tc,
                   kernels.lora_matmul.bf16_tc_decode_launches - tcd)
        if tcd != (body == "tensor-core split-K"):
            raise AssertionError(f"lora_matmul bf16 probe {label} M={m} "
                                 f"K={k} N={n}: {tcd} launches of the "
                                 "tensor-core split-K body")
        plain = kernels.lora_matmul_plain(x, w, a, b, scale)
        torch.cuda.synchronize()
        diff = probes.differing(got, faults)
        if not (torch.equal(got, plain) and torch.equal(got, want)
                and min(diff.values()) > 0):
            raise AssertionError(
                f"lora_matmul bf16 probe {label} M={m} K={k} N={n} r={r} "
                f"(plan {plan}): kernel == plain {torch.equal(got, plain)}, "
                f"== exact {torch.equal(got, want)} (max |kernel - exact| "
                f"{float((got - want).abs().max()):.3e}); elements apart from "
                f"the faults {diff}")
        plans.add(("tc-split-K", plan[0]) if tcd else
                  ("split-K", plan[0]) if plan else
                  "tensor-core" if tc else "tiled")
        if tc:
            padded.add(_adapter_rows(r))
        for name, v in diff.items():
            seen[name] = seen.get(name, 0) + v
        del x, w, a, b, want, faults, got, plain
    if bodies and not {"tensor-core", "tiled"} <= plans:
        raise AssertionError(f"lora_matmul bf16 probes: bodies {plans}")
    chunks = {body: sorted(p[1] for p in plans if p[0] == body)
              for body in ("tc-split-K", "split-K")}
    print(f"  lora_matmul bf16 probes: {len(cases)} cases (the tensor-core "
          f"split-K body at {chunks['tc-split-K']} K chunks, the SIMT "
          f"split-K body at {chunks['split-K']}, the tensor-core body with "
          f"x@a at N {sorted(padded)}, the tiled body) bitwise the plain "
          f"version and the exact answer; elements apart from the faulty "
          f"variants {seen}", flush=True)


def flash_probes(torch, kernels, device, flash):
    """B8 on :func:`~repro_torch.kernels.probes.swa_probe` at each (label,
    B, S, H, KVH, d, causal[, Sk]) of ``flash`` (Sk ≠ S: a
    cross-attention's keys): bitwise the plain version, apart from every
    faulty variant, through the tensor cores at every head dim that is a
    multiple of 8."""
    from repro_torch.kernels import probes

    seen = {}
    for label, b, s, h, kvh, d, causal, *sk in flash:
        q, k, v, faults = probes.swa_probe(b, s, h, kvh, d, causal=causal,
                                           sk=sk[0] if sk else 0,
                                           device=device, seed=s + d)
        tc = kernels.flash_swa.bf16_tc_launches
        got = kernels.swa_attention(q, k, v, causal, 0)
        tc = kernels.flash_swa.bf16_tc_launches - tc
        plain = kernels.swa_attention_plain(q, k, v, causal, 0)
        torch.cuda.synchronize()
        diff = probes.differing(got, faults)
        same = torch.equal(bits(torch, got.float()), bits(torch, plain.float()))
        if tc != (d % 8 == 0):
            raise AssertionError(f"flash_swa bf16 probe {label}: {tc} "
                                 "tensor-core launches")
        if not (same and min(diff.values()) > 0):
            raise AssertionError(
                f"flash_swa bf16 probe {label} B={b} S={s} H={h}/{kvh} d={d}: "
                f"kernel == plain {same} ({int((got != plain).sum())} "
                f"elements differ); elements apart from the faults {diff}")
        for name, n in diff.items():
            seen[name] = seen.get(name, 0) + n
        del q, k, v, faults, got, plain
    print(f"  flash_swa bf16 probes: {len(flash)} cases (d "
          f"{sorted({f[5] for f in flash})}; every d a multiple of 8 through "
          f"the tensor-core body) bitwise the plain version; "
          f"elements apart from the faulty variants {seen}", flush=True)
    torch.cuda.empty_cache()


def tc_launch_counts(kernels) -> dict:
    """B3's and B8's launches through their tensor-core bodies since the
    last reset (B3's decode body apart)."""
    return {"lora_matmul": kernels.lora_matmul.bf16_tc_launches,
            "lora_matmul_decode": kernels.lora_matmul.bf16_tc_decode_launches,
            "flash_swa": kernels.flash_swa.bf16_tc_launches}


def _expect_bf16(kernels, name, want, tc):
    """The launch counts are ``want`` (every other kernel 0), every one of
    them a bf16 launch, and the tensor-core bodies' ``tc`` (kernel →
    launches): B3's every prefill projection (``lora_matmul``) and every
    decode one (``lora_matmul_decode``), B8's every prefill attention."""
    _expect(kernels, name, want)
    got = kernels.bf16_launch_counts()
    expected = {k: want.get(k, 0) for k in got}
    if got != expected:
        raise AssertionError(f"serve {name}: bf16 launches {got} != "
                             f"{expected}")
    if tc_launch_counts(kernels) != tc:
        raise AssertionError(f"serve {name}: tensor-core launches "
                             f"{tc_launch_counts(kernels)} != {tc}")


def bf16_serve(torch, kernels, device, name):
    """Serve ``name`` in bf16 (its config's dtype) at full width and depth,
    the shape of ``BF16_SERVE``, from the port's own bf16 draws and a
    rank-4 adapter in f32 with b drawn N(0, 0.05²) (biases N(0, 0.02²)).
    Each check with the counters set to 0 just before it:
    * one prefill (``lora_matmul`` 4·L, ``flash_swa`` L launches, all bf16)
      and one teacher-forced decode step (``lora_matmul`` 4·L bf16);
    * the kernel path's prefill logits against the bf16 plain path's (no
      launch): printed, and held by the next check;
    * teacher forcing: the decode step's logits against the bf16 training
      forward within ``TF_BF16`` of its largest |logit|, the argmax agreeing
      on every row whose top-2 margin exceeds twice that;
    Then the main path, ``serve()`` with no ``dtype`` (so the config's
    bf16, as the reference), 1 prefill and the decode steps, the counters
    set to 0 just before and read just after (all bf16), with its prefill
    ms, decode ms/token and peak GiB, and a ``torch.profiler`` breakdown of
    one prefill and one decode step (:func:`profile_serving`). Last, the
    f32 answer: the same
    weights widened to f32 (the bf16 copy freed) and the f32 serving
    prefill; the kernel path's bf16 logits must be no further from its
    logits than twice the bf16 plain path's are, plus one bf16 rounding at
    the logit scale (2⁻⁸·max|f32 logit|), and no further from the plain
    path's than three times that distance plus the same floor. Returns
    (stats, launches of the main path, its bf16 launches, B3's and B8's
    tensor-core launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

    bsz, prompt, steps, max_len = BF16_SERVE[name]
    cfg = get_config(name)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{name}: config dtype {cfg.dtype}")
    L = cfg.num_layers
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lcfg = LoRAConfig(rank=4, alpha=8.0)
    with torch.inference_mode():
        params = model.init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in flatten_with_paths(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
        for k, leaf in flatten_with_paths(params).items():
            if k.endswith("/bias"):
                leaf.normal_(0.0, 0.02, generator=gen)
    dtypes = {str(v.dtype) for v in flatten_with_paths(params).values()}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"{name}: params in {dtypes}")
    prefill = make_prefill_step(model, lcfg)
    decode = make_decode_step(model, lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    torch.cuda.synchronize()
    print(f"  [bf16] {name}: params and adapter on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, device=device)
        pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        _expect_bf16(kernels, f"{name} bf16 one prefill",
                     {"lora_matmul": 4 * L, "flash_swa": L},
                     tc={"lora_matmul": 4 * L, "lora_matmul_decode": 0,
                         "flash_swa": L})
        kernels.reset_launch_counts()
        _, dec, cache = decode(params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        _expect_bf16(kernels, f"{name} bf16 one decode step",
                     {"lora_matmul": 4 * L},
                     tc={"lora_matmul": 0, "lora_matmul_decode": 4 * L,
                         "flash_swa": 0})
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{name} bf16 plain path", {})
        train = model.apply(params, {"tokens": full}, lora=lora,
                            lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        got = dec[:, -1]
        tf_scale = float(train.abs().max())
        tol = TF_BF16 * tf_scale
        err_tf = float((got - train).abs().max())
        top2 = torch.topk(train, 2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > 2 * tol
        same = got.argmax(-1) == train.argmax(-1)
        agree = bool(same[sure].all())
        print(f"  [bf16] {name} teacher-forced decode (bf16 cache) vs the bf16 "
              f"training forward: max |diff| {err_tf:.4e} (bound {tol:.4e} = "
              f"{TF_BF16} x logit scale {tf_scale:.3f}); argmax agrees on "
              f"{int(same.sum())} of {bsz} rows, on the {int(sure.sum())} "
              f"rows past 2 x bound: {agree}", flush=True)
        if not (err_tf <= tol and agree):
            raise AssertionError(f"bf16 serve {name}: prefill + decode "
                                 "disagree with the training forward")
        del dec, got, train, top2
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(name, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora)
    launches, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"lora_matmul": 4 * L * (1 + steps), "flash_swa": L}
    _expect_bf16(kernels, f"{name} bf16 serve() (1 prefill + {steps} decode "
                 "steps)", want, tc={"lora_matmul": 4 * L,
                                     "lora_matmul_decode": 4 * L * steps,
                                     "flash_swa": L})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"bf16 serve {name}: bad tokens {toks.shape}")
    prof = profile_serving(torch, model, params, lora, prefill, decode, batch,
                           bsz, prompt, max_len, res)

    # the f32 answer over the same weights
    flat = flatten_with_paths(params)
    del params
    for k in list(flat):
        flat[k] = flat[k].float()
    wide = unflatten_from_paths(flat)
    del flat
    f32 = build_model(replace(cfg, dtype="float32"))
    with torch.inference_mode():
        cache = f32.init_cache(bsz, max_len, device=device)
        pre32, cache = make_prefill_step(f32, lcfg)(wide, lora, batch, cache)
        del cache
    torch.cuda.synchronize()
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [bf16] {name} prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"bf16 serve {name}: the kernel path's logits "
                             "are further from the f32 answer than allowed")
    stats = {"prefill_ms": res.prefill_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": peak, "err_vs_f32": err_k,
             "err_plain_vs_f32": err_p, "err_kernel_vs_plain": err_kp,
             "err_teacher_forced": err_tf, "tf_bound": tol, **prof,
             "seconds": time.perf_counter() - t0}
    print(f"  [bf16] {name} batch {bsz}, prompt {prompt}, {steps} decode "
          f"steps, bf16 model and cache of {max_len}: prefill "
          f"{res.prefill_ms:.1f} ms ({stats['prefill_tokens_per_s']:.0f} "
          f"tokens/s), decode {res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), "
          f"peak {peak:.2f} GiB; {stats['seconds']:.1f} s; first row "
          f"{toks[0, :8].tolist()}", flush=True)
    del wide, lora, pre, pre_plain, pre32, f32, model
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def bf16_phase(torch, kernels, device):
    """Phase 9: the ptxas summaries of B3's and B8's tensor-core bodies
    (from the last :func:`build_kernels`), the bf16 kernels
    (:func:`bf16_kernel_phase`), then :func:`bf16_serve` of each model of
    ``BF16_SERVE``, one at a time. Returns (max errors, timings, launches,
    bf16 launches, stats); the bf16 launches hold ``lora_matmul_tc``,
    ``lora_matmul_decode_tc`` and ``flash_swa_tc``, B3's and B8's
    tensor-core launches."""
    t = time.perf_counter()
    for line in PTXAS:
        if line.startswith(("lora_mm_tc", "lora_mm_at", "lora_mm_dec",
                            "flash_swa_tc")):
            print(f"  [bf16] ptxas {line}", flush=True)
    errs, timings = bf16_kernel_phase(torch, kernels, device)
    stats = {"kernels_s": time.perf_counter() - t}
    launches = {name: 0 for name in SOURCES}
    bf16 = {"lora_matmul": 0, "flash_swa": 0, "lora_matmul_tc": 0,
            "lora_matmul_decode_tc": 0, "flash_swa_tc": 0}
    for name in BF16_SERVE:
        stats[name], got, got_bf16, tc = bf16_serve(torch, kernels, device,
                                                    name)
        for k, v in got.items():
            launches[k] += v
        for k, v in got_bf16.items():
            bf16[k] += v
        for k, v in tc.items():
            bf16[f"{k}_tc"] += v
    stats["seconds"] = time.perf_counter() - t
    print(f"  [bf16] phase 9 in {stats['seconds']:.1f} s", flush=True)
    return errs, timings, launches, bf16, stats


# --------------------------------------------------------------------------
# phase 10: the MoE family (mixtral-8x22b)
# --------------------------------------------------------------------------

MOE = "mixtral-8x22b"
# Depth cuts, stated as cuts: full depth is 56 layers of ≈ 2.5 B parameters
# (≈ 10 GB a layer in f32, 5 GB in bf16), which one 80 GB card cannot hold.
# Training and its f32 serve run 4 layers (≈ 42 GB of weights), the bf16
# serve 8 (≈ 41 GB); every width is the config's.
MOE_DEPTH = {"float32": 4, "bfloat16": 8}
MOE_TRAIN = {"clients": 4, "local_steps": 3, "batch": 8, "seq": 64,
             "data_vocab": 512}
MOE_SERVE = {"batch": 8, "prompt": 512, "steps": 32}  # cache prompt + steps
# one MoE layer, ragged (plain and kernel) against the dense oracle:
# |diff| ≤ rtol·|dense| + atol·max|dense| (the dense path sums experts and
# ff in one K of E·ff = 131,072, the ragged one per expert)
MOE_LAYER_TOL = (1e-4, 1e-4)
# f32: a routing flip (a token routed to another set of experts by two
# evaluations of the same function) must sit at a k-th margin no larger
# than this (f32 rounding moves a probability by ~1e-7). bf16: 2⁻⁵ was
# stated before the first run and missed — bf16 roundings accumulate over
# the layers (PERF.md §6, PR 31) — so bf16 flips are held as phase 9 holds
# the logits: the kernel path's flips against the bf16 plain path no more
# than twice the plain path's own against the f32 answer.
MOE_FLIP_MARGIN = {"float32": 1e-5}
# f32 kernel path against plain path at the prefill's last-position
# logits: |diff| ≤ rtol·|plain| + atol·max|plain|. The dense phases' P_TOL
# is absolute; a MoE layer's expert products sum K = 16,384 terms of
# activations ≈ 20 (the one-layer check's max|y|), so the two f32
# accumulation orders part by more at the logits (the first run read
# 1.43e-4 against P_TOL's absolute 1e-4); each B3 call is held to
# ``lora_matmul_error_bound`` at these shapes by the kernel checks.
MOE_P_TOL = (1e-4, 1e-4)


class route_log:
    """Within the block every call of the MoE router
    (``models.moe.router_topk``) logs its top-k expert indices (on the
    card, read after the block). Unless ``light``, it also logs the
    tokens whose k-th and (k+1)-th probabilities tie exactly. With
    ``replay`` (index tensors, one a call, in call order) each call routes
    as the replayed indices, its weights renormalised over them from its
    own probabilities, and logs how many of its tokens it would have routed
    to another set of experts and the largest k-th margin among them: two
    evaluations then
    differ by their rounding only, and a flip (a near-tie rounded the
    other way) is counted, not compared."""

    def __init__(self, replay=None, light=False):
        from repro_torch.models import moe
        self.mod, self.replay, self.light = moe, replay, light
        self.indices, self.ties, self.flips, self.margins = [], [], [], []
        self.own = []  # with replay: each call's own choice

    def __enter__(self):
        torch = self.mod.torch
        self.saved = self.mod.router_topk

        def logged(cfg, rp, x, lanes=None):
            w, idx, aux = self.saved(cfg, rp, x, lanes)
            if not (self.light and self.replay is None):
                k = cfg.num_experts_per_tok
                probs = torch.softmax(torch.matmul(x, rp["kernel"]).float(),
                                      dim=-1)
                top = torch.sort(probs, dim=-1, descending=True).values
                margin = top[:, k - 1] - top[:, k]
                self.ties.append((margin == 0).sum())
            if self.replay is not None:
                forced = self.replay[len(self.indices)]
                # a flip changes the set of experts; two near-equal top
                # probabilities swapped within the set change nothing
                differ = (idx.sort(-1).values
                          != forced.sort(-1).values).any(-1)
                self.flips.append(differ.sum())
                self.margins.append(torch.where(differ, margin, 0.0).max())
                self.own.append(idx)
                w = probs.gather(-1, forced)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
                idx = forced
            self.indices.append(idx)
            return w, idx, aux

        self.mod.router_topk = logged
        return self

    def __exit__(self, *exc):
        self.mod.router_topk = self.saved

    def counts(self) -> dict:
        """calls, exact ties, flips and the largest flip margin."""
        return {"calls": len(self.indices),
                "ties": int(sum(int(t) for t in self.ties)),
                "flips": int(sum(int(f) for f in self.flips)),
                "flip_margin": max([float(m) for m in self.margins],
                                   default=0.0)}

    def b3_calls(self, torch, cfg) -> tuple:
        """(B3 launches of the logged calls' expert groups: 3 a non-empty
        group, those of groups of more than SKINNY_ROWS rows: the prefill
        bodies')."""
        from repro_torch.kernels.lora_matmul import SKINNY_ROWS
        groups = wide = 0
        for idx in self.indices:
            sizes = torch.bincount(idx.flatten(), minlength=cfg.num_experts)
            groups += int((sizes > 0).sum())
            wide += int((sizes > SKINNY_ROWS).sum())
        return 3 * groups, 3 * wide


def _held_flips(log, dtype, label):
    """Print a replayed run's flips; in f32 raise if one sits past the
    stated margin (a flip there is not rounding)."""
    got = log.counts()
    limit = MOE_FLIP_MARGIN.get(dtype)
    print(f"  [moe] {label}: {got['calls']} router calls replayed, "
          f"{got['flips']} tokens would route to other experts (largest k-th "
          f"margin among them {got['flip_margin']:.3e}"
          + (f", limit {limit:.3e})" if limit else ")"), flush=True)
    if limit is not None and got["flip_margin"] > limit:
        raise AssertionError(f"moe {label}: a token flips at margin "
                             f"{got['flip_margin']:.3e}")
    return got


def _set_flips(lhs, rhs) -> int:
    """Tokens routed to another set of experts, over the calls of two
    logs' index lists."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(lhs, rhs))


def _joined_routes(torch, prefill, decode, batch):
    """The routing of a training forward over prompt + 1 tokens, per layer,
    from a prefill's (B·S, k) and a decode step's (B, k) indices."""
    return [torch.cat([p.view(batch, -1, p.shape[-1]),
                       d.view(batch, 1, d.shape[-1])], dim=1).flatten(0, 1)
            for p, d in zip(prefill, decode)]


def _w0(node):
    """A W0 leaf: a module's kernel or a raw expert tensor."""
    return node["kernel"] if isinstance(node, dict) else node


def expert_fold_case(torch, kernels, timer, device, tag, n_mat, d, ff, c,
                     live, r, scale, seed, leaf="up-proj"):
    """B1 at a ``leaf`` of ``n_mat`` stacked (d, ff) matrices (an expert
    leaf; zamba2's stacked in_proj), ``live`` lanes of ``c`` weighted,
    against its plain version in chunks of 8 matrices (every chunk, the
    far end of the leaf included), timed beside ``baddbmm``. Returns (max
    error, timings, the lane weights)."""
    w0, a, b, w = make_inputs(torch, device, c, (n_mat,), d, ff, r, live,
                              seed=seed)
    out = torch.empty_like(w0)
    kernels.fedex_fold(w0, a, b, scale, weights=w, out=out)
    torch.cuda.synchronize()
    chunk, err_max = 8, 0.0
    for i in range(0, n_mat, chunk):
        part = slice(i, i + chunk)
        want = kernels.fedex_fold_plain(w0[part], a[:, part], b[:, part],
                                        scale, w)
        bound = kernels.fold_error_bound(w0[part], a[:, part], b[:, part],
                                         scale, w)
        err = (out[part] - want).abs()
        err_max = max(err_max, float(err.max()))
        if not bool((err <= bound).all()):
            raise AssertionError(f"fedex_fold at {tag}'s {leaf} leaf, "
                                 f"matrices {i}..{i + chunk - 1}: disagrees "
                                 "with its plain version")
        del want, bound, err
    far = out[-1, -1, -1]
    print(f"  [{tag}] fedex_fold {leaf} leaf ({n_mat}, {d}, {ff}) = "
          f"{w0.numel():,} elements, C={c} r={r}, live {list(live)}: every "
          f"chunk of {chunk} within bound of the plain version, max_abs_err "
          f"{err_max:.3e}; the far end out[{n_mat - 1}, {d - 1}, "
          f"{ff - 1}] = {float(far):.6e}", flush=True)
    abar = kernels.factor_mean_plain(a, w)
    bbar = kernels.factor_mean_plain(b, w)
    lib_a = torch.cat([w[j] * a[j] for j in live] + [-abar], dim=-1)
    lib_b = torch.cat([b[j] for j in live] + [bbar], dim=-2)
    del abar, bbar
    fb = bound_ms(*fold_cost([("experts/up_proj", n_mat, d, ff)], len(live),
                             r))

    def fold_kernel():
        kernels.fedex_fold(w0, a, b, scale, weights=w, out=out)

    def fold_plain():
        for i in range(0, n_mat, chunk):
            kernels.fedex_fold_plain(w0[i:i + chunk], a[:, i:i + chunk],
                                     b[:, i:i + chunk], scale, w)

    def fold_library():
        torch.baddbmm(w0, lib_a, lib_b, alpha=scale, out=out)

    t = (timer(fold_kernel), timer(fold_plain), timer(fold_library), fb,
         timer.device(fold_kernel, fb[0]), timer.device(fold_library, fb[0]))
    ms, plain, lib, (bms, by), dev, dev_lib = t
    print(f"  [{tag}] time fedex_fold {leaf} leaf: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms ({-(-n_mat // chunk)} chunks), library {lib:.4f} "
          f"ms (baddbmm), bound {bms:.4f} ms ({by}); device time kernel "
          f"{fmt_ms(dev)}{share(bms, dev)}, library {fmt_ms(dev_lib)}",
          flush=True)
    del w0, out, a, b, lib_a, lib_b
    torch.cuda.empty_cache()
    return err_max, t, w


def group_mean_case(torch, kernels, timer, device, tag, leaves, c, live, r,
                    w, seed):
    """B2 in one grouped launch over a close's a and b stacks of
    ``leaves`` ((name, L, m, n)), weights ``w`` over ``live`` lanes of
    ``c``: bitwise the plain version, timed beside a ``tensordot`` a
    stack. Returns the timings."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    group = []
    for _, n_l, m, n in leaves:
        group += [torch.randn(c, n_l, m, r, device=device, generator=g) * 0.02,
                  torch.randn(c, n_l, r, n, device=device, generator=g) * 0.01]
    got = kernels.factor_mean_group(group, w)
    torch.cuda.synchronize()
    if not all(torch.equal(bits(torch, x), bits(
            torch, kernels.factor_mean_plain(s, w)))
               for x, s in zip(got, group)):
        raise AssertionError(f"factor_mean: {tag}'s grouped means are not "
                             "bitwise the plain version")
    del got
    mb = bound_ms(*mean_cost(leaves, len(live), r))
    t = (timer(lambda: kernels.factor_mean_group(group, w)),
         timer(lambda: [kernels.factor_mean_plain(s, w) for s in group]),
         timer(lambda: [torch.tensordot(w, s, dims=1) for s in group]), mb,
         timer.device(lambda: kernels.factor_mean_group(group, w), mb[0]),
         timer.device(lambda: [torch.tensordot(w, s, dims=1) for s in group],
                      mb[0]))
    ms, plain, lib, (bms, by), dev, dev_lib = t
    print(f"  [{tag}] factor_mean one grouped launch over a close's "
          f"{len(group)} stacks: bitwise=True; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {lib:.4f} ms ({len(group)} tensordot), "
          f"bound {bms:.4f} ms ({by}); device time kernel {fmt_ms(dev)}, "
          f"library {fmt_ms(dev_lib)}", flush=True)
    del group
    return t


def moe_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At mixtral's shapes: B1 at the up-proj expert leaf of the f32 depth
    (L·E stacked matrices of 6144 × 16384, ≈ 3.2·10⁹ elements, past 2³¹),
    2 live lanes of 4 weighted, against its plain version in chunks of 8
    matrices (every chunk, the far end of the leaf included) and timed
    beside ``baddbmm``; B2 over a close's 14 factor stacks (q/k/v/o and
    the three expert leaves), bitwise; B3 at one layer's q/k/v/o in bf16
    at the prefill (M 4096) and decode (M 8) rows, each call through its
    tensor-core body, and at the expert projections (K or N 16,384) at a
    prefill group of M 1024 (f32 and bf16) and a decode group of M 2
    (bf16); B8 at the prefill (B 8, S 512, GQA 48/8, d 128, window 4096)
    in f32 and in bf16 through its tensor-core body. Returns (max errors
    of the f32 cases, of the bf16 cases, timings)."""
    timer = Timer(torch, device)
    L, E = MOE_DEPTH["float32"], cfg.num_experts
    d, ff = cfg.d_model, cfg.moe_d_ff
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0,
            "flash_swa": 0.0}
    bf16_errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "moe", L * E, d, ff, c, live, r, scale,
        seed=110)
    # B2: one weighted close's 14 stacks, the weights of B1's lanes
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    leaves = [("q_proj", L, d, nq), ("k_proj", L, d, nkv),
              ("v_proj", L, d, nkv), ("o_proj", L, nq, d),
              ("experts/up_proj", L * E, d, ff),
              ("experts/gate_proj", L * E, d, ff),
              ("experts/down_proj", L * E, ff, d)]
    timings["factor_mean"] = group_mean_case(torch, kernels, timer, device,
                                             "moe", leaves, c, live, r, w,
                                             seed=120)

    # B3: q/k/v/o in bf16 (prefill and decode rows), the expert projections
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    low = torch.bfloat16
    bsz, prompt = MOE_SERVE["batch"], MOE_SERVE["prompt"]
    attn = serving_projections(cfg)
    experts = [("up/gate", d, ff), ("down", ff, d)]
    for key, dtype, m, shapes in (
            ("mixtral_bf16", low, bsz * prompt, attn),
            ("mixtral_bf16_decode", low, bsz, attn),
            ("mixtral_expert", torch.float32, 1024, experts),
            ("mixtral_expert_bf16", low, 1024, experts),
            ("mixtral_expert_bf16_decode", low, 2, experts)):
        bufs = [[t.to(dtype) for t in lora_inputs(torch, device, m, k, n, r,
                                                  seed=140 + i)]
                for i, (_, k, n) in enumerate(shapes)]
        if dtype == low:
            tc_calls(torch, kernels, bufs, scale, f"{key} M={m}", len(bufs),
                     decode=m <= SKINNY_ROWS)
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{cfg.name} {key}: {'/'.join(s[0] for s in shapes)} at M={m}",
            device_times=True)
        sink = bf16_errs if dtype == low else errs
        sink["lora_matmul"] = max(sink["lora_matmul"], err)
        del bufs
    # B8 at the prefill, f32 (SIMT body) and bf16 (tensor-core body)
    for i, (key, dtype) in enumerate((("flash_mixtral", None),
                                      ("flash_mixtral_bf16", low))):
        err, timings[key] = flash_case(
            torch, kernels, timer, device, bsz, prompt, cfg.num_heads,
            cfg.num_kv_heads, hd, True, cfg.sliding_window, seed=150 + i,
            device_times=True, dtype=dtype, tc=dtype == low)
        sink = bf16_errs if dtype == low else errs
        sink["flash_swa"] = max(sink["flash_swa"], err)
    torch.cuda.empty_cache()
    return errs, bf16_errs, timings


def moe_layer_check(torch, kernels, device, cfg, params, lora, scale,
                    tag="moe"):
    """One MoE layer at full width in f32 (layer 0 of ``params``), batch 8 ×
    seq 64 of unit-scale inputs, with its per-expert adapters' b drawn
    N(0, 0.05²): the ragged path, plain (training) and fused (B3 on every
    non-empty expert group's up, gate and down), against the dense oracle
    within ``MOE_LAYER_TOL``; the router's aux loss equal. Returns the
    largest error."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer_slice
    p = _layer_slice(params["layers"], 0)["mlp"]
    g = torch.Generator(device=device)
    g.manual_seed(160)
    lo = {"experts": {
        k: {"a": v["a"][0].clone(),
            "b": torch.randn(v["b"][0].shape, device=device,
                             generator=g) * 0.05}
        for k, v in lora["layers"]["mlp"]["experts"].items()}}
    x = torch.randn(MOE_TRAIN["batch"], MOE_TRAIN["seq"], cfg.d_model,
                    device=device, generator=g)
    rtol, atol = MOE_LAYER_TOL
    worst = 0.0
    with torch.inference_mode():
        yd, ad = moe.moe_block(cfg, p, x, lora=lo, lora_scale=scale,
                               impl="dense")
        tol = rtol * yd.abs() + atol * float(yd.abs().max())
        before = kernels.launch_counts()["lora_matmul"]
        with route_log() as log:
            yk, ak = moe.moe_block(cfg, p, x, lora=lo, lora_scale=scale,
                                   fused=True)
        yr, ar = moe.moe_block(cfg, p, x, lora=lo, lora_scale=scale)
        torch.cuda.synchronize()
        calls = kernels.launch_counts()["lora_matmul"] - before
        want_calls, _ = log.b3_calls(torch, cfg)
        for label, y, aux in (("ragged", yr, ar), ("ragged+B3", yk, ak)):
            err = (y - yd).abs()
            worst = max(worst, float(err.max()))
            ok = bool((err <= tol).all()) and float(aux) == float(ad)
            print(f"  [{tag}] one MoE block at full width (T {x.shape[0]} x "
                  f"{x.shape[1]}, E {cfg.num_experts}, top-"
                  f"{cfg.num_experts_per_tok}, ff {cfg.moe_d_ff}): {label} vs "
                  f"the dense oracle max |diff| {float(err.max()):.3e} (rtol "
                  f"{rtol}, atol {atol} x max|y| {float(yd.abs().max()):.3f})"
                  f", aux {float(aux):.6e} vs {float(ad):.6e}: ok={ok}",
                  flush=True)
            if not ok:
                raise AssertionError(f"moe layer: the {label} path disagrees "
                                     "with the dense oracle")
        print(f"  [{tag}] the fused block launched lora_matmul {calls} times "
              f"(3 a non-empty expert group: {want_calls})", flush=True)
        if calls != want_calls:
            raise AssertionError("moe layer: B3 launches != 3 a group")
    return worst


def moe_snapshot(trainer, specs=None, params=None):
    """W0's copy for the identity check: the first and the last layer of
    each attention leaf; experts 0 and E − 1 of the first and the last
    layer of each expert leaf (of ``specs`` and ``params``, by default the
    trainer's engine's and its own)."""
    out = {}
    for s in specs or trainer.engine.specs:
        w0 = _w0(_node(trainer.params if params is None else params, s.key))
        lead = w0.shape[:-2]
        idx = list(itertools.product(*[(0, n - 1) for n in lead]))
        out[s.key] = {i: w0[i].clone() for i in idx}
    return out


def moe_train(torch, kernels, device, cfg, scale, tag="moe", lcfg=None,
              run=None, data=None, full_identity=False, weighted_from=1):
    """Phase 10's training path at the f32 depth cut: 4 clients, 3 local
    steps, batch 8 × seq 64 of a 512-token data vocabulary, fedex with
    per-expert adapters (or ``lcfg``'s); round 0 uniform over all clients,
    round 1 at 50% participation with example weights (the weighted close:
    ``factor_mean`` 1, ``fedex_fold`` one an adapted leaf: mixtral's 7, q,
    k, v, o, up, gate, down; deepseek's 15, six MLA projections in each of
    its two stacks and the three expert leaves; zamba2's 8, in_proj and
    out_proj of its two Mamba2 stacks and the shared block's q, k, v, o),
    the counters set to 0 just before the rounds and read just after, the
    fold checked by :func:`identity_sampled` on :func:`moe_snapshot`'s
    matrices. Before it, a MoE config's :func:`moe_layer_check` on the
    drawn layer 0 (an MLA config also :func:`mla_layer_check`). ``run``
    replaces ``MOE_TRAIN``; ``data(loaders, evals)`` returns the loaders
    and eval batches to train on (whisper's add frames to every batch);
    ``full_identity`` checks the fold on every matrix of every leaf
    (:func:`identity_fedex`). ``weighted_from`` 0 runs both rounds at 50%
    with example weights (two weighted closes, each launch count doubled),
    the fold checked after each. Returns (trainer, stats, launches)."""
    from repro_torch.configs import (FedConfig, LoRAConfig, TrainConfig,
                                     get_config)
    from repro_torch.core import FederatedTrainer
    from repro_torch.fedsrv import RoundPolicy
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model
    from repro_torch.util.tree import count_params

    t0 = time.perf_counter()
    run = run or MOE_TRAIN
    loaders, evals = build_federated_data(
        run["data_vocab"], run["clients"], seq_len=run["seq"],
        batch_size=run["batch"], device=device)
    if data is not None:
        loaders, evals = data(loaders, evals)
    trainer = FederatedTrainer(
        model=build_model(cfg),
        lora_cfg=lcfg or LoRAConfig(rank=4, alpha=8.0, lora_experts=True),
        fed_cfg=FedConfig(num_clients=run["clients"], rounds=2,
                          local_steps=run["local_steps"]),
        train_cfg=TrainConfig(learning_rate=5e-3, schedule="constant",
                              total_steps=2 * run["local_steps"]),
        client_loaders=loaders, eval_batches=evals, seed=0, device=device)
    torch.cuda.synchronize()
    eng = trainer.engine
    raw = sum(not s.has_kernel for s in eng.specs)
    print(f"  [{tag}] {cfg.name} at depth {cfg.num_layers} of "
          f"{get_config(cfg.name).num_layers}, "
          f"{cfg.dtype}: {count_params(trainer.params) / 1e9:.2f} B params "
          f"on the card, {len(eng.specs)} adapted leaves ({raw} raw expert "
          f"stacks); set-up {time.perf_counter() - t0:.1f} s", flush=True)
    layer_err = None
    if cfg.family == "moe":
        layer_err = moe_layer_check(torch, kernels, device, cfg,
                                    trainer.params, trainer.global_lora,
                                    scale, tag)
    if cfg.mla:
        layer_err = max(layer_err, mla_layer_check(
            torch, kernels, device, cfg, trainer.params, trainer.global_lora,
            scale))
    close_ms = []
    close = eng.close

    def timed_close(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = close(*args, **kw)
        torch.cuda.synchronize()
        close_ms.append((time.perf_counter() - t) * 1e3)
        return res

    eng.close = timed_close
    step_ms, local_step = [], trainer.local_step

    def timed_step(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = local_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return res

    trainer.local_step = timed_step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, old, t1 = [], None, time.perf_counter()
    keys, identity = [s.key for s in eng.specs], 0.0
    for rnd in range(2):
        if rnd == weighted_from:
            trainer.coordinator.policy = RoundPolicy(participation=0.5,
                                                     weighting="examples")
        if rnd >= weighted_from:
            old = [{s.key: _w0(_node(trainer.params, s.key)).clone()
                    for s in eng.specs} if full_identity
                   else moe_snapshot(trainer)]
        t = time.perf_counter()
        step_ms.clear()
        rec = trainer.run(until=rnd + 1)[rnd]
        torch.cuda.synchronize()
        out = trainer.outcomes[-1]
        rows.append({"round": rnd, "clients": out.client_ids,
                     "step_ms": statistics.median(step_ms),
                     "weights": out.weights,
                     "round_s": time.perf_counter() - t,
                     "close_ms": close_ms[-1] if close_ms else None,
                     "eval_loss": rec.eval_loss,
                     "divergence": float(rec.divergence_scaled),
                     "client_losses": rec.client_losses})
        kind = "uniform" if out.weights is None else "weighted"
        print(f"  [{tag}] round {rnd} [{kind} close, clients="
              f"{out.client_ids}]: client step {rows[-1]['step_ms']:.1f} ms "
              f"(median of {len(step_ms)}), round "
              f"{rows[-1]['round_s']:.2f} s, close "
              f"{rows[-1]['close_ms']:.2f} ms, eval_loss {rec.eval_loss:.4f}"
              f", divergence {rows[-1]['divergence']:.3e}", flush=True)
        if rnd >= weighted_from:
            identity = max(identity, (
                identity_fedex if full_identity else identity_sampled)(
                    torch, trainer, out, old, keys))
            del old
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    closes = 2 - weighted_from
    launches = dict(check_launches(
        kernels, f"{tag}-fedex",
        {"factor_mean": closes, "fedex_fold": closes * len(eng.specs)},
        f" for {closes} weighted close{'s' * (closes > 1)} of "
        f"{len(eng.specs)} leaves; peak {peak:.1f} GiB"))
    if [row["weights"] is None for row in rows] != [
            rnd < weighted_from for rnd in range(2)]:
        raise AssertionError(f"{tag}-fedex: rounds before {weighted_from} "
                             "must be uniform, the others weighted")
    values = [v for row in rows for v in
              (row["eval_loss"], row["divergence"], *row["client_losses"])]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{tag}-fedex: non-finite values: {rows}")
    stats = {"params_b": count_params(trainer.params) / 1e9,
             "layers": cfg.num_layers, "train_s": train_s,
             "train_peak_gib": peak, "fold_err": identity,
             "layer_err": layer_err, "close_ms": rows[-1]["close_ms"],
             "rounds": [{k: v for k, v in row.items()
                         if k != "client_losses"} for row in rows]}
    return trainer, stats, launches


# The mesh round of phases 10–14 (``mesh-<arch>``): 2 lanes of batch 8 ×
# seq 64 folded into one batch of 16 rows, 2 local steps, 1 round, example
# weights, a 512-token data vocabulary
MESH_FAMILY_RUN = {"clients": 2, "local_steps": 2, "batch": 8, "seq": 64,
                   "data_vocab": 512}


def dense_halves(dense):
    """``models.common.dense`` summed over K in two halves: x₀W₀ +
    s(x₀a₀)b + x₁W₁ + s(x₁a₁)b (+ bias), the same function rounded in
    another order. Training through it is a second f32 evaluation of the
    model; its distance from the first is the model's own f32 spread."""
    def halves(x, params, lora=None, lora_scale=0.0):
        k = x.shape[-1] // 2
        parts = []
        for rows in (slice(None, k), slice(k, None)):
            lo = None if lora is None else {"a": lora["a"][..., rows, :],
                                            "b": lora["b"]}
            parts.append(dense(x[..., rows],
                               {"kernel": params["kernel"][..., rows, :]},
                               lo, lora_scale))
        y = parts[0] + parts[1]
        return y + params["bias"] if "bias" in params else y
    return halves


def family_mesh_run(torch, kernels, device, cfg, trainer, lcfg, tag,
                    data=None, spread=False):
    """Phases 10–14's ``mesh-<arch>`` run: the port's
    MeshFederatedTrainer (``MESH_FAMILY_RUN``) on the phase's trained
    params and global adapter, no second draw (its close folds into that
    W0 in place, so the run comes after the phase's f32 serve).
    ``data(loaders, evals)`` adds what the batches need (whisper's
    frames). The counters are set to 0 just before ``run()`` and read just
    after: one close, ``factor_mean`` 1 and ``fedex_fold`` one a leaf.

    The round function is wrapped: timed, then each lane's losses and
    adapters held against the host trainer's local step
    (``make_local_step``) on that lane's client alone, from the same
    global adapter and batches: losses rtol 1e-5, adapters within 1e-2
    relative Frobenius and phase 7's AdamW separation bound 2·lr·steps·
    lanes. ``spread`` (xlstm) adds 3 × the model's own f32 spread to each
    bound: lane 0's host steps again through :func:`dense_halves`. A MoE
    config's lanes' router aux losses (step 0, one folded forward) are
    printed beside the host loss's aux on each lane's rows. The close is
    wrapped: timed (host clock, synchronised), its launches counted, the
    fold held on :func:`moe_snapshot`'s matrices of every leaf against the
    plain fold within ``fold_error_bound`` (:func:`identity_sampled`); after
    the run, B2's and B1's device ms from one replay of the close behind a
    spin kernel. Returns (stats, launches)."""
    from types import SimpleNamespace

    from repro_torch.configs import FedConfig, TrainConfig
    from repro_torch.core import engine as core_engine
    from repro_torch.core.federated import make_local_step
    from repro_torch.launch.mesh_train import MeshFederatedTrainer
    from repro_torch.launch.train import build_federated_data
    from repro_torch.models import build_model, common, transformer
    from repro_torch.models.model import lanes_by_layer
    from repro_torch.optim import init_adamw

    run = MESH_FAMILY_RUN
    c, steps = run["clients"], run["local_steps"]
    _free(torch, device)
    loaders, evals = build_federated_data(
        run["data_vocab"], c, seq_len=run["seq"], batch_size=run["batch"],
        device=device)
    if data is not None:
        loaders, evals = data(loaders, evals)
    train_cfg = TrainConfig(learning_rate=5e-3, schedule="constant",
                            total_steps=steps)
    model = build_model(cfg)
    mt = MeshFederatedTrainer(
        model=model, lora_cfg=lcfg,
        fed_cfg=FedConfig(num_clients=c, rounds=1, local_steps=steps,
                          weighting="examples"),
        train_cfg=train_cfg, client_loaders=loaders, eval_batches=evals,
        seed=0, device=device, params=trainer.params,
        global_lora=trainer.global_lora)
    closer, cuda = mt.closer, device.type == "cuda"
    keys = [s.key for s in closer.specs]
    per_close = {"factor_mean": 1, "fedex_fold": len(keys)}
    sep = 2 * train_cfg.learning_rate * steps * c
    host_step = make_local_step(model, mt.scale, train_cfg)
    row, closed = {"lanes": c, "leaves": len(keys)}, {}
    round_fn, close = mt.round_fn, closer.close

    def host_lane(params, start, batches, lrs, lane):
        lora, opt, losses = start, init_adamw(start), []
        for t, lr in enumerate(lrs):
            lora, opt, loss, _ = host_step(
                params, lora, opt, {k: v[lane, t] for k, v in
                                    batches.items()}, lr)
            losses.append(float(loss))
        return _flat(lora), losses

    def apart(losses, lanes, ref_losses, ref):
        """(max rel loss gap, max rel Frobenius, max |Δ|) of a lane."""
        loss = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
        fro = dif = 0.0
        for p, x in ref.items():
            d = (lanes[p] - x).float()
            fro = max(fro, float(torch.linalg.norm(d)) / max(
                float(torch.linalg.norm(x.float())), 1e-30))
            dif = max(dif, float(d.abs().max()))
        return loss, fro, dif

    def checked_round(params, lora_stack, batches, lrs):
        _sync(torch, device)
        t = time.perf_counter()
        out = round_fn(params, lora_stack, batches, lrs)
        _sync(torch, device)
        row["round_ms"] = (time.perf_counter() - t) * 1e3
        stack, mesh_losses = _flat(out[0]), out[1].tolist()
        worst, host_ms = [0.0, 0.0, 0.0], []
        for lane in range(c):
            start = _unflat({p: x[lane] for p, x in
                             _flat(lora_stack).items()})
            _sync(torch, device)
            t = time.perf_counter()
            ref, ref_losses = host_lane(params, start, batches, lrs, lane)
            _sync(torch, device)
            host_ms.append((time.perf_counter() - t) * 1e3)
            gaps = apart(mesh_losses[lane], {p: x[lane] for p, x in
                                             stack.items()},
                         ref_losses, ref)
            worst = [max(w, g) for w, g in zip(worst, gaps)]
            if lane == 0 and spread:
                plain = common.dense
                common.dense = dense_halves(plain)
                try:
                    halves = host_lane(params, start, batches, lrs, 0)
                finally:
                    common.dense = plain
                row["spread"] = apart(halves[1], halves[0], ref_losses,
                                      ref)
        row.update(host_lane_ms=host_ms, apart=worst)
        own = row.get("spread", (0.0, 0.0, 0.0))
        bounds = [1e-5 + 3 * own[0], 1e-2 + 3 * own[1], sep + 3 * own[2]]
        ok = all(w <= b for w, b in zip(worst, bounds))
        print(f"  [mesh] {cfg.name} lanes against the host's local steps "
              f"(each lane's client alone, same start and batches): max "
              f"rel loss {worst[0]:.3e} (≤ {bounds[0]:.3e}), adapters max "
              f"rel Frobenius {worst[1]:.3e} (≤ {bounds[1]:.3e}), max |Δ| "
              f"{worst[2]:.3e} (≤ {bounds[2]:.3e})"
              + (f"; own f32 spread {own[0]:.3e} / {own[1]:.3e} / "
                 f"{own[2]:.3e} (bounds + 3 ×)" if spread else "")
              + f"; within={ok}", flush=True)
        if not ok:
            raise AssertionError(f"mesh-{tag}: the lanes part from the "
                                 f"host steps: {worst} > {bounds}")
        if cfg.family == "moe":
            first = {k: v[:, 0].reshape(-1, *v.shape[3:])
                     for k, v in batches.items()}
            with torch.no_grad():
                _, aux = transformer.forward(
                    cfg, params, first["tokens"], lora=lanes_by_layer(
                        lora_stack)[1], lora_scale=mt.scale, with_aux=True,
                    lanes=c)
                host_aux = [float(model.loss(
                    params, {k: v[lane, 0] for k, v in batches.items()},
                    lora=_unflat({p: x[lane] for p, x in
                                  _flat(lora_stack).items()}),
                    lora_scale=mt.scale)[1]["aux_loss"]) for lane in range(c)]
            row["aux"], row["host_aux"] = aux.tolist(), host_aux
            gap = max(abs(x - y) / abs(y) for x, y in zip(row["aux"],
                                                          host_aux))
            print(f"  [mesh] {cfg.name} each lane's router aux (step 0): "
                  f"{[f'{x:.6e}' for x in row['aux']]}, the host loss's on "
                  f"its rows {[f'{x:.6e}' for x in host_aux]}; max rel "
                  f"{gap:.3e} (≤ 1e-5)", flush=True)
            if gap > 1e-5:
                raise AssertionError(f"mesh-{tag}: a lane's aux parts from "
                                     "the host's")
        return out

    def checked_close(params, stacks, ids, weights=None, *, round_id=None):
        old = moe_snapshot(None, closer.specs, params)
        before = kernels.launch_counts()
        _sync(torch, device)
        t = time.perf_counter()
        new_glob, new_params, div = close(params, stacks, ids, weights,
                                          round_id=round_id)
        _sync(torch, device)
        row["close_ms"] = (time.perf_counter() - t) * 1e3
        after = kernels.launch_counts()
        row["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        w, _ = closer.weight_vector(ids, weights)
        outcome = SimpleNamespace(
            delivered=[SimpleNamespace(lora=_unflat(
                {p: x[i] for p, x in stacks.items()})) for i in ids],
            weights=[float(w[i]) for i in ids])
        view = SimpleNamespace(scale=mt.scale, global_lora=new_glob,
                               params=new_params, device=device)
        row.update(ids=list(ids), weights=outcome.weights,
                   fold_err=identity_sampled(torch, view, outcome, [old],
                                             keys, tag=f"mesh-{tag}"))
        closed.update(stacks=stacks, w=w)
        return new_glob, new_params, div

    def close_device_ms():
        """B2's and B1's device ms at the close's shapes: the round's
        close replayed once more into the W0 it folded (which the phase
        frees next), queued behind a spin kernel so that no host gap lands
        inside a pair of CUDA events around each launch (one retry with a
        longer spin; None where the spin ended first). These launches are
        not the run's."""
        from repro_torch.core.engine import collect_w0_leaves

        names = {"factor_mean": "factor_mean_group",
                 "fedex_fold": "fedex_fold"}
        plain = {k: getattr(core_engine, v) for k, v in names.items()}
        w = torch.from_numpy(closed["w"]).to(device)
        spin_s = min(2 * row["close_ms"] / 1e3 + 2e-3, 0.2)
        for _ in range(2):
            events = {k: [] for k in names}

            def evented(name):
                def launch(*args, **kw):
                    pair = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
                    pair[0].record()
                    res = plain[name](*args, **kw)
                    pair[1].record()
                    events[name].append(pair)
                    return res
                return launch

            torch.cuda.synchronize()
            torch.cuda._sleep(int(spin_s * Timer.CYCLES_PER_S))
            gate = torch.cuda.Event()
            gate.record()
            for k, v in names.items():
                setattr(core_engine, v, evented(k))
            try:
                closer._close(collect_w0_leaves(closer.specs, mt.params),
                              closed["stacks"], w, (w > 0).float(),
                              uniform=False)
            finally:
                for k, v in names.items():
                    setattr(core_engine, v, plain[k])
            queued = not gate.query()
            torch.cuda.synchronize()
            if queued:
                return {k: sum(a.elapsed_time(b) for a, b in v)
                        for k, v in events.items()}
            spin_s *= 4
        return {k: None for k in names}

    mt.round_fn, closer.close = checked_round, checked_close
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    hist = mt.run()
    _sync(torch, device)
    row["run_s"] = time.perf_counter() - t
    counts = check_launches(kernels, f"mesh-{tag}", per_close,
                            f" for one weighted close of {len(keys)} leaves")
    if cuda and row["launches"] != per_close:
        raise AssertionError(f"mesh-{tag}: the close launched "
                             f"{row['launches']}, not {per_close}")
    row["device_ms"] = (close_device_ms() if cuda else
                        {"factor_mean": None, "fedex_fold": None})
    rec = hist[-1]
    values = [rec.eval_loss, rec.divergence_scaled, *rec.client_losses]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"mesh-{tag}: non-finite values: {values}")
    row.update(peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else 0.0), eval_loss=rec.eval_loss,
               divergence=rec.divergence_scaled)
    dev = row["device_ms"]
    print(f"  [mesh] {cfg.name} (mesh-{tag}): {c} lanes × batch "
          f"{run['batch']} × seq {run['seq']}, {steps} local steps, lanes "
          f"{row['ids']} at weights {[f'{x:.4f}' for x in row['weights']]};"
          f" training round {row['round_ms']:.1f} ms (the host's lanes "
          f"{[f'{x:.1f}' for x in row['host_lane_ms']]} ms), close "
          f"{row['close_ms']:.2f} ms; device: B2 factor_mean "
          f"{fmt_ms(dev['factor_mean'])} × {counts['factor_mean']}, B1 "
          f"fedex_fold {fmt_ms(dev['fedex_fold'])} × "
          f"{counts['fedex_fold']}; "
          f"fold max err {row['fold_err']:.3e}; eval_loss "
          f"{rec.eval_loss:.4f}, divergence {rec.divergence_scaled:.3e}; "
          f"peak {row['peak_gib']:.2f} GiB; "
          f"{smi_line() if cuda else 'no card'}", flush=True)
    del mt
    return row, {k: counts[k] for k in per_close}


def _moe_expect(kernels, name, b3, flash, dtype, tc=None):
    """The launch counts of a MoE serving step; bf16 also the bf16 and the
    tensor-core counts."""
    want = {"lora_matmul": b3, "flash_swa": flash}
    want = {k: v for k, v in want.items() if v}
    if dtype == "bfloat16":
        _expect_bf16(kernels, name, want, tc)
    else:
        _expect(kernels, name, want)


def moe_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``MOE_SERVE``'s shape, its cache in the model's dtype. With the counters
    set to 0 just before each: one prefill (``lora_matmul`` 4·L + 3 a
    non-empty expert group, ``flash_swa`` L; bf16: every B3 call at a
    prefill group through the tensor-core body, B8's too) and one decode
    step (4·L + 3 a group; bf16: every one through the tensor-core split-K
    body); the kernel path's prefill logits against the plain path's (no
    launch; the kernel path's routing replayed, :class:`route_log`);
    teacher forcing, the decode step's logits against the training forward
    over prompt + 1 (the serve runs' routing replayed): f32 within
    ``D_TOL``, the argmax agreeing on every row whose top-2 margin exceeds
    twice that (bf16: printed, and held by :func:`moe_bf16`). Then the
    main path, ``serve()`` (f32: ``dtype`` float32 and an f32 cache; bf16:
    no ``dtype``, the config's), 1 prefill and the decode steps, the
    counters set to 0 just before and read just after. Returns (stats,
    main-path launches, its bf16 launches, B3's and B8's tensor-core
    launches, and for :func:`moe_bf16` what it compares: the prefill's
    last-position logits on the kernel and the plain path, the decode
    step's and the training forward's, the tokens, the serve runs'
    routing over prompt + 1 and the plain path's own)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    bsz, prompt, steps = (MOE_SERVE[k] for k in ("batch", "prompt", "steps"))
    max_len, L, dt = prompt + steps, cfg.num_layers, cfg.dtype
    mdt = torch.float32 if dt == "float32" else torch.bfloat16
    low = dt == "bfloat16"
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        with route_log() as pre_log:
            pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        calls, wide = pre_log.b3_calls(torch, cfg)
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", 4 * L + calls,
                    L, dt, tc={"lora_matmul": 4 * L + wide,
                               "lora_matmul_decode": calls - wide,
                               "flash_swa": L})
        ties = pre_log.counts()["ties"]
        print(f"  [moe] {cfg.name} {dt} prefill: {ties} of "
              f"{bsz * prompt * L} token-layers with the router's 2nd and "
              "3rd probabilities exactly tied", flush=True)
        kernels.reset_launch_counts()
        with route_log() as dec_log:
            _, dec, cache = decode(params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        dcalls, dwide = dec_log.b3_calls(torch, cfg)
        _moe_expect(kernels, f"{cfg.name} {dt} one decode step",
                    4 * L + dcalls, 0, dt,
                    tc={"lora_matmul": dwide,
                        "lora_matmul_decode": 4 * L + dcalls - dwide,
                        "flash_swa": 0})
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels), route_log(replay=pre_log.indices) as log:
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        plain_flips = _held_flips(log, dt, f"{dt} plain-path prefill")
        plain_own = log.own
        err_kp = float((pre - pre_plain).abs().max())
        if not low:
            lscale = float(pre_plain.abs().max())
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale).all())
            print(f"  [moe] f32 prefill last-position logits, kernel path vs "
                  f"plain path: max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}"
                  f", atol {MOE_P_TOL[1]} x logit scale {lscale:.3f}): "
                  f"within={ok}", flush=True)
            if not ok:
                raise AssertionError("moe f32 serve: the kernel path "
                                     "disagrees with the plain path")
        routes = _joined_routes(torch, pre_log.indices, dec_log.indices, bsz)
        with route_log(replay=routes) as log:
            train = model.apply(params, {"tokens": full}, lora=lora,
                                lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        tf_flips = _held_flips(log, dt, f"{dt} training forward")
        got = dec[:, -1].clone()
        scale_tf = float(train.abs().max())
        err_tf = float((got - train).abs().max())
        if low:
            # held against the f32 answer by moe_bf16; TF_BF16, phase 9's
            # absolute limit, printed beside
            print(f"  [moe] {cfg.name} bf16 teacher-forced decode vs the bf16 "
                  f"training forward: max |diff| {err_tf:.4e} = "
                  f"{err_tf / scale_tf:.3f} of the logit scale {scale_tf:.3f}"
                  f" (phase 9's TF_BF16 {TF_BF16})", flush=True)
        else:
            ok, _ = _allclose(got, train, *D_TOL)
            margin_tol = D_TOL[1] + D_TOL[0] * scale_tf
            top2 = torch.topk(train, 2, dim=-1).values
            sure = top2[:, 0] - top2[:, 1] > 2 * margin_tol
            same = got.argmax(-1) == train.argmax(-1)
            agree = bool(same[sure].all())
            print(f"  [moe] {cfg.name} f32 teacher-forced decode vs the "
                  f"training forward: max |diff| {err_tf:.4e} (rtol, atol "
                  f"{D_TOL}; logit scale {scale_tf:.3f}): within={ok}; argmax "
                  f"agrees on {int(same.sum())} of {bsz} rows, on the "
                  f"{int(sure.sum())} rows past 2 x tol: {agree}", flush=True)
            if not (ok and agree):
                raise AssertionError("moe f32 serve: prefill + decode "
                                     "disagree with the training forward")
        cmp = {"pre": pre, "pre_plain": pre_plain, "routes": routes,
               "plain_own": plain_own, "decode": got, "train": train,
               "full": full}
        del dec
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    with route_log(light=True) as log:
        res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                    max_len=max_len, device=device, params=params, lora=lora,
                    **({} if low else {"dtype": torch.float32,
                                       "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    calls, wide = log.b3_calls(torch, cfg)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", 4 * L * (1 + steps) + calls, L, dt,
                tc={"lora_matmul": 4 * L + wide,
                    "lora_matmul_decode": 4 * L * steps + calls - wide,
                    "flash_swa": L})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"moe serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             "router_ties": ties, "plain_flips": plain_flips["flips"],
             "tf_flips": tf_flips["flips"],
             "b3_expert_calls_serve": calls,
             "seconds": time.perf_counter() - t0}
    print(f"  [moe] {cfg.name} {dt} batch {bsz}, prompt {prompt}, {steps} "
          f"decode steps, cache of {max_len}: prefill {res.prefill_ms:.1f} ms "
          f"({stats['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), peak {stats['peak_gib']:.2f} GiB; "
          f"B3 on expert groups {calls} of {launches['lora_matmul']}; "
          f"{stats['seconds']:.1f} s; first row {toks[0, :8].tolist()}",
          flush=True)
    return stats, launches, bf16, tc, cmp


def moe_f32_answer(torch, cfg, params, lora, lcfg, tokens, replay):
    """The f32 training forward over ``tokens`` (B, S) and ``params``
    (bf16; leading dense layers first, as the model runs them), widened
    one layer at a time (the whole tree in f32 would not fit
    beside it), the routing ``replay``ed (:class:`route_log`): the logits
    at the last two positions (the prompt's last, for the prefill; the
    next token's, for the decode step) and the log."""
    from dataclasses import replace

    from repro_torch.models import transformer
    from repro_torch.models.common import apply_norm, embed, unembed

    f32 = replace(cfg, dtype="float32")

    def wide(tree):
        return _unflat({k: v.float() for k, v in _flat(tree).items()})

    positions = torch.arange(tokens.shape[1], device=tokens.device)
    stacks = [k for k in ("dense_layers", "layers") if k in params]
    with torch.inference_mode(), route_log(replay=replay) as log:
        x = embed(wide(params["embed"]), tokens)
        for key in stacks:
            for i in range(params[key]["attn_norm"]["scale"].shape[0]):
                p = wide(transformer._layer_slice(params[key], i))
                x, _ = transformer.decoder_layer(
                    f32, p, x, lora=transformer._layer_slice(lora.get(key), i),
                    lora_scale=lcfg.scale, positions=positions,
                    window=cfg.sliding_window, cache=None, position=None)
                del p
        x = apply_norm(cfg.norm, wide(params["final_norm"]), x[:, -2:])
        logits = unembed(wide(params["lm_head"]), x)
    return logits, log


def moe_bf16(torch, kernels, device, scale):
    """The bf16 serve at the bf16 depth cut from fresh draws (the port's
    own bf16 params, a rank-4 f32 adapter with per-expert adapters and b
    drawn N(0, 0.05²)) through :func:`moe_serve`, then the f32 answer over
    the same weights and prompt + 1 tokens (:func:`moe_f32_answer`, the
    serve runs' routing replayed). Held as phase 9 holds its bf16 serves:
    the kernel path's prefill logits no further from the f32 answer than
    twice the bf16 plain path's plus one bf16 rounding at the logit scale
    (2⁻⁸·max|f32 logit|), and from the plain path's no further than three
    times that distance plus the same floor; teacher forcing likewise, the
    decode step's logits no further from the f32 answer than twice the
    bf16 training forward's plus the floor, the argmax agreeing with it on
    every row whose f32 top-2 margin exceeds twice that bound; the routing
    likewise, the kernel path's expert sets apart from the plain path's on
    no more than twice the token-layers the plain path's are apart from the
    f32 answer's. Returns (stats, launches, bf16 launches, tensor-core
    launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(MOE), num_layers=MOE_DEPTH["bfloat16"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{MOE}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale, lora_experts=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    print(f"  [moe] {cfg.name} bf16 at depth {cfg.num_layers} (a cut of 56): "
          f"params and adapter on the card in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    stats, launches, bf16, tc, cmp = moe_serve(torch, kernels, device, cfg,
                                               params, lora, lcfg)
    f32, log = moe_f32_answer(torch, cfg, params, lora, lcfg, cmp["full"],
                              cmp["routes"])
    torch.cuda.synchronize()
    f32_flips = _held_flips(log, "bfloat16", "f32 answer (bf16 weights "
                            "widened)")
    bsz = cmp["full"].shape[0]
    prompt_own = [x.view(bsz, -1, x.shape[-1])[:, :-1].flatten(0, 1)
                  for x in log.own]
    n_kp = _set_flips([x.view(bsz, -1, x.shape[-1])[:, :-1].flatten(0, 1)
                       for x in cmp["routes"]], cmp["plain_own"])
    n_pf = _set_flips(cmp["plain_own"], prompt_own)
    print(f"  [moe] bf16 prefill routing: the kernel path's expert sets "
          f"differ from the plain path's on {n_kp} token-layers, the plain "
          f"path's from the f32 answer's on {n_pf} (limit 2 x that): "
          f"ok={n_kp <= 2 * n_pf}", flush=True)
    if n_kp > 2 * n_pf:
        raise AssertionError("moe bf16 serve: the kernel path routes further "
                             "from the plain path than bf16 from f32")
    pre32, next32 = f32[:, 0], f32[:, 1]
    pre, pre_plain = cmp["pre"][:, -1], cmp["pre_plain"][:, -1]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [moe] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("moe bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [moe] bf16 teacher forcing: the decode step vs the f32 answer "
          f"{err_d:.4e}, the bf16 training forward vs it {err_t:.4e} (bound "
          f"2 x that + {floor:.4e} = {bound:.4e}); argmax agrees with f32 on "
          f"{int(same.sum())} of {bsz} rows, on the {int(sure.sum())} rows "
          f"past 2 x bound: {agree}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("moe bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 f32_flips=f32_flips["flips"], flips_kernel_plain=n_kp,
                 flips_plain_f32=n_pf,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp, f32
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def moe_phase(torch, kernels, device):
    """Phase 10: mixtral-8x22b at full width. The kernels at its shapes
    (:func:`moe_kernel_phase`); training at the f32 depth cut
    (:func:`moe_train`, after one layer against the dense oracle) and the
    f32 serve of its folded W0 and global adapter (:func:`moe_serve`), then
    a 2-lane mesh round on them (:func:`family_mesh_run`); that state
    freed, the bf16 serve at the bf16 depth cut (:func:`moe_bf16`).
    Returns (max errors of the f32 cases, of the bf16 cases, timings,
    launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(MOE), num_layers=MOE_DEPTH["float32"],
                  dtype="float32")
    r, scale = 4, 2.0
    errs, bf16_errs, timings = moe_kernel_phase(torch, kernels, device, cfg,
                                                r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(torch, kernels, device, cfg,
                                             scale)
    for k, v in got.items():
        launches[k] += v
    lcfg = LoRAConfig(rank=r, alpha=8.0, lora_experts=True)
    served, got, *_ = moe_serve(
        torch, kernels, device, cfg, trainer.params, trainer.global_lora,
        lcfg)
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    stats["mesh"], got = family_mesh_run(torch, kernels, device, cfg,
                                         trainer, lcfg, "moe")
    for k, v in got.items():
        launches[k] += v
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = moe_bf16(torch, kernels, device, scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [moe] phase 10 in {stats['seconds']:.1f} s; peak memory: "
          f"kernels {stats['kernels_peak_gib']:.2f} GiB, f32 training "
          f"{stats['train']['train_peak_gib']:.2f} GiB, f32 serve "
          f"{stats['f32']['peak_gib']:.2f} GiB, mesh round "
          f"{stats['mesh']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats


# --------------------------------------------------------------------------
# phase 11: Multi-head Latent Attention on the MoE stack (deepseek-v2-236b)
# --------------------------------------------------------------------------

DS = "deepseek-v2-236b"
# Depth cuts, stated as cuts: full depth is 60 layers (1 dense + 59 MoE);
# a MoE layer is ≈ 15.9 GB in f32 (routed experts 15.1, MLA 0.60, shared
# 0.19), the dense layer ≈ 1.35 GB, embed + lm_head ≈ 4.2 GB, so one 80 GB
# card holds 4 MoE layers in f32 at most. Training and its f32 serve run 1
# dense + 2 MoE layers (≈ 37 GB of weights; the uniform close's two
# temporaries of the 10 GB expert leaf come on top), the bf16 serve 1 + 4
# (≈ 35 GB, the f32 answer widened a layer at a time beside it); every
# width is the config's.
DS_DEPTH = {"float32": 3, "bfloat16": 5}
DS_SERVE = {"batch": 8, "prompt": 512, "steps": 32}  # cache prompt + steps
# the rows of a prefill expert group (8 × 512 tokens × top-6 over 160
# experts: 153.6 on average) and of a decode one (48 slots over 160)
DS_GROUP_ROWS = {"prefill": 160, "decode": 1}


def mla_projections(cfg):
    """(name, K, N) of one layer's six adapted MLA projections."""
    d, h, kvr = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    return [("q_down", d, cfg.q_lora_rank),
            ("q_up", cfg.q_lora_rank, h * (nope + rope)),
            ("kv_down", d, kvr + rope), ("k_up", kvr, h * nope),
            ("v_up", kvr, h * dv), ("o_proj", h * dv, d)]


def mla_flash_case(torch, kernels, timer, device, b, s, h, dk, dv, seed,
                   dtype=None):
    """B8 as MLA's prefill runs it: q and k of ``dk`` (nope + rope), v of
    ``dv`` zero-padded to ``dk``, causal, no window, MHA; the output's
    padded columns must be exactly 0, the rest within the plain version's
    tolerance (f32: rtol 2e-5, atol 4e-5; bf16: ``swa_error_bound``), two
    runs bitwise equal, bf16 through the tensor-core body. Timed beside
    the plain version, the pad and SDPA on the unpadded v (it takes dv ≠
    dk: the fair yardstick); the bound counts the function's own bytes
    (q, k at dk, v and the output at dv) and operations (2·dk + 2·dv a
    visible pair). Returns (max error, timings)."""
    import torch.nn.functional as F
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(b, s, h, dk, device=device, generator=g)
    k = torch.randn(b, s, h, dk, device=device, generator=g)
    v = torch.randn(b, s, h, dv, device=device, generator=g)
    low = dtype == torch.bfloat16
    if low:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    vp = F.pad(v, (0, dk - dv))
    before = kernels.flash_swa.bf16_tc_launches
    got = kernels.swa_attention(q, k, vp, True, 0)
    again = kernels.swa_attention(q, k, vp, True, 0)
    torch.cuda.synchronize()
    label = f"MLA B={b} S={s} H={h} dk={dk} dv={dv} (v padded){' bf16' * low}"
    if kernels.flash_swa.bf16_tc_launches - before != 2 * low:
        raise AssertionError(f"flash_swa {label}: "
                             f"{kernels.flash_swa.bf16_tc_launches - before}"
                             f" of 2 runs took the tensor-core body")
    if not torch.equal(bits(torch, got), bits(torch, again)):
        raise AssertionError(f"flash_swa {label}: two runs differ")
    if not bool((got[..., dv:] == 0).all()):
        raise AssertionError(f"flash_swa {label}: the padded columns are not "
                             "0")
    want = kernels.swa_attention_plain(q, k, vp, True, 0)
    e = (got.float() - want.float()).abs()
    err = float(e.max())
    tol = (kernels.swa_error_bound(q, k, vp, True, 0) if low
           else 4e-5 + 2e-5 * want.abs())
    if not bool((e <= tol).all()):
        raise AssertionError(f"flash_swa {label}: max err {err:.3e} vs the "
                             "plain version")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float((lib.transpose(1, 2).float()
                     - got[..., :dv].float()).abs().max())
    del got, again, want, e, tol, lib
    pairs = port_cost.attention_pairs(s, s, True, 0)
    elem = 2 if low else 4
    nbytes = elem * b * s * h * (2 * dk + 2 * dv)
    flops = (2 * dk + 2 * dv) * pairs * b * h

    def kernel():
        kernels.swa_attention(q, k, vp, True, 0)

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    bound = bound_ms(nbytes, flops,
                     BF16_FLOPS_PER_S if low else F32_FLOPS_PER_S)
    t = (timer(kernel),
         timer(lambda: kernels.swa_attention_plain(q, k, vp, True, 0)),
         timer(library), bound, timer.device(kernel, bound[0]),
         timer.device(library, bound[0]))
    pad_ms = timer(lambda: F.pad(v, (0, dk - dv)))
    ms, plain, libt, (bms, by), dev, dev_lib = t
    print(f"  flash_swa[{label}] max_abs_err={err:.3e} (SDPA on the unpadded "
          f"v {lib_err:.3e}), padded columns 0, two runs bitwise equal; time "
          f"kernel {ms:.4f} ms (the pad {pad_ms:.4f} ms more), plain "
          f"{plain:.4f} ms, library {libt:.4f} ms (SDPA, dv {dv}), bound "
          f"{bms:.4f} ms ({by}); device time kernel {fmt_ms(dev)}"
          f"{share(bms, dev)}, library {fmt_ms(dev_lib)}", flush=True)
    return err, t


def mla_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At deepseek-v2-236b's shapes: B1 at the up-proj expert leaf of the
    f32 depth (2 MoE layers × 160 stacked matrices of 5120 × 1536, ≈ 2.5·10⁹
    elements), 2 live lanes of 4 weighted, against its plain version in
    8-matrix chunks and beside ``baddbmm``; B2 over the weighted close's 30
    stacks (six MLA projections in the dense and the MoE stack, the three
    expert leaves), bitwise; B3 in f32 and bf16 at the six MLA projections
    at the prefill rows (M 4096) and at the four a decode step runs (M 8:
    k_up and v_up are absorbed), and at the expert projections at a
    prefill group (M 160, f32 and bf16) and a decode group (M 1, bf16),
    each bf16 call through its tensor-core body; B8 at the MLA prefill (B 8,
    S 512, 128 heads, dk 192, v padded from 128) in f32 and bf16 (the
    tensor-core body); then the exact-rounding probes at d 192 and at the
    MLA projections, bitwise. Returns (max errors of the f32 cases, of the
    bf16 cases, timings)."""
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    timer = Timer(torch, device)
    L, E = DS_DEPTH["float32"] - cfg.first_k_dense, cfg.num_experts
    d, ff = cfg.d_model, cfg.moe_d_ff
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0,
            "flash_swa": 0.0}
    bf16_errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "mla", L * E, d, ff, c, live, r,
        scale, seed=210)
    attn = mla_projections(cfg)
    leaves = [(f"{stack}/{name}", n_l, k, n)
              for stack, n_l in (("dense_layers", cfg.first_k_dense),
                                 ("layers", L))
              for name, k, n in attn]
    leaves += [("experts/up_proj", L * E, d, ff),
               ("experts/gate_proj", L * E, d, ff),
               ("experts/down_proj", L * E, ff, d)]
    timings["factor_mean"] = group_mean_case(torch, kernels, timer, device,
                                             "mla", leaves, c, live, r, w,
                                             seed=220)
    low = torch.bfloat16
    bsz, prompt = DS_SERVE["batch"], DS_SERVE["prompt"]
    decode = [p for p in attn if p[0] not in ("k_up", "v_up")]
    experts = [("up/gate", d, ff), ("down", ff, d)]
    pre, dec = DS_GROUP_ROWS["prefill"], DS_GROUP_ROWS["decode"]
    for key, dtype, m, shapes in (
            ("ds", torch.float32, bsz * prompt, attn),
            ("ds_decode", torch.float32, bsz, decode),
            ("ds_bf16", low, bsz * prompt, attn),
            ("ds_bf16_decode", low, bsz, decode),
            ("ds_expert", torch.float32, pre, experts),
            ("ds_expert_bf16", low, pre, experts),
            ("ds_expert_bf16_decode", low, dec, experts)):
        bufs = [[t.to(dtype) for t in lora_inputs(torch, device, m, k, n, r,
                                                  seed=240 + i)]
                for i, (_, k, n) in enumerate(shapes)]
        if dtype == low:
            tc_calls(torch, kernels, bufs, scale, f"{key} M={m}", len(bufs),
                     decode=m <= SKINNY_ROWS)
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{cfg.name} {key}: {'/'.join(s[0] for s in shapes)} at M={m}",
            device_times=True)
        sink = bf16_errs if dtype == low else errs
        sink["lora_matmul"] = max(sink["lora_matmul"], err)
        del bufs
        torch.cuda.empty_cache()
    dk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    for i, (key, dtype) in enumerate((("flash_ds", None),
                                      ("flash_ds_bf16", low))):
        err, timings[key] = mla_flash_case(
            torch, kernels, timer, device, bsz, prompt, cfg.num_heads, dk,
            cfg.v_head_dim, seed=250 + i, dtype=dtype)
        sink = bf16_errs if dtype == low else errs
        sink["flash_swa"] = max(sink["flash_swa"], err)
    torch.cuda.empty_cache()
    lora_probes(torch, kernels, device,
                [("deepseek-v2-236b", m, k, n, 4) for _, k, n in attn
                 for m in (bsz, bsz * prompt)])
    flash_probes(torch, kernels, device,
                 [("deepseek-v2-236b", bsz, prompt, cfg.num_heads,
                   cfg.num_heads, dk, True),
                  ("d 192 non-causal", 2, 300, 4, 4, dk, False)])
    return errs, bf16_errs, timings


def mla_layer_check(torch, kernels, device, cfg, params, lora, scale):
    """One MLA + MoE layer at full width in f32 (layer 0 of the MoE stack of
    ``params``), a prefill of batch 8 × 512 unit-scale inputs into a fresh
    f32 cache, every adapter of the layer (its six MLA projections and its
    expert leaves) with b drawn N(0, 0.05²): the kernel path (B3 on the six
    projections and on every non-empty expert group, B8 on the attention,
    counted) against the plain path (the kernels' plain versions, the
    routing replayed) within ``MOE_P_TOL`` (rtol, and atol of the plain
    output's largest magnitude); the caches' latents likewise. Returns the
    largest error."""
    from repro_torch.models import transformer
    g = torch.Generator(device=device)
    g.manual_seed(260)
    p = transformer._layer_slice(params["layers"], 0)
    lo = transformer._layer_slice(lora["layers"], 0)
    lo = _unflat({k: (torch.randn(v.shape, device=device, generator=g) * 0.05
                      if k.endswith("/b") else v.clone())
                  for k, v in _flat(lo).items()})
    bsz, prompt = DS_SERVE["batch"], DS_SERVE["prompt"]
    x = torch.randn(bsz, prompt, cfg.d_model, device=device, generator=g)
    positions = torch.arange(prompt, device=device)
    rtol, atol = MOE_P_TOL

    def run():
        cache = transformer.init_cache(cfg, bsz, prompt, torch.float32,
                                       device)
        cache = transformer._layer_slice(cache["layers"], 0)
        y, _ = transformer.decoder_layer(
            cfg, p, x, lora=lo, lora_scale=scale, positions=positions,
            window=0, cache=cache, position=None)
        return y, cache

    with torch.inference_mode():
        kernels.reset_launch_counts()
        with route_log() as log:
            yk, ck = run()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        calls, _ = log.b3_calls(torch, cfg)
        want = {"lora_matmul": 6 + calls, "flash_swa": 1}
        if {k: counts[k] for k in want} != want or sum(counts.values()) != (
                sum(want.values())):
            raise AssertionError(f"mla layer: launches {counts}, expected "
                                 f"{want}")
        with plain_ops(kernels), route_log(replay=log.indices) as plog:
            yp, cp = run()
        torch.cuda.synchronize()
        flips = plog.counts()["flips"]
        worst = 0.0
        for label, got, ref in (("layer output", yk, yp),
                                ("c_kv", ck["c_kv"], cp["c_kv"]),
                                ("k_rope", ck["k_rope"], cp["k_rope"])):
            err = (got - ref).abs()
            scale_ref = float(ref.abs().max())
            ok = bool((err <= rtol * ref.abs() + atol * scale_ref).all())
            worst = max(worst, float(err.max()))
            print(f"  [mla] one MLA + MoE layer at full width (B {bsz}, S "
                  f"{prompt}, {cfg.num_heads} heads, E {cfg.num_experts} top-"
                  f"{cfg.num_experts_per_tok}), kernel path vs plain path, "
                  f"{label}: max |diff| {float(err.max()):.3e} (rtol {rtol}, "
                  f"atol {atol} x {scale_ref:.3f}): ok={ok}", flush=True)
            if not ok:
                raise AssertionError(f"mla layer: the kernel path's {label} "
                                     "disagrees with the plain path")
        print(f"  [mla] the layer launched lora_matmul {6 + calls} times (6 "
              f"MLA projections, 3 a non-empty expert group: {calls}) and "
              f"flash_swa once; the plain path would route {flips} tokens "
              "elsewhere", flush=True)
    del yk, yp, ck, cp, x
    torch.cuda.empty_cache()
    return worst


def merged_kv_up(torch, params, lora, scale):
    """(params, lora) with k_up's and v_up's adapters merged into their
    kernels (W + s·a·b, new leaves) and taken out of the adapter: the
    function the training forward computes with them live, in a form the
    absorbed decode reads too (it reads the raw k_up / v_up kernels and
    never their adapters)."""
    from repro_torch.core.lora import merge_lora
    kv = ("k_up", "v_up")
    sub = {stack: {"attn": {k: lora[stack]["attn"][k] for k in kv}}
           for stack in ("dense_layers", "layers") if stack in lora}
    merged = merge_lora(params, sub, scale)
    rest = _unflat({k: v for k, v in _flat(lora).items()
                    if k.split("/")[-2] not in kv})
    return merged, rest


def mla_cache_bytes(cache, cfg) -> dict:
    """The cache's bytes a token (every layer's c_kv and k_rope, over batch
    × length) beside a 128-head GQA cache at these dims: K of nope + rope
    and V of v_head_dim a head (the decompressed width), and the
    reference's own yardstick, K and V of 128 a head."""
    ckv = [v for k, v in _flat(cache).items() if not k.endswith("pos")]
    b, length = ckv[0].shape[1], ckv[0].shape[2]
    per_token = sum(t.numel() * t.element_size() for t in ckv) / (b * length)
    elem, h, L = ckv[0].element_size(), cfg.num_heads, cfg.num_layers
    gqa = L * h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                   + cfg.v_head_dim) * elem
    ref = L * h * (128 + 128) * elem
    return {"bytes_per_token": per_token, "gqa_bytes_per_token": gqa,
            "ratio": gqa / per_token, "ref_gqa_bytes_per_token": ref,
            "ref_ratio": ref / per_token}


def mla_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``DS_SERVE``'s shape, its cache in the model's dtype. With the counters
    set to 0 just before each: one prefill (``lora_matmul`` 6·L + 3 a
    non-empty expert group, ``flash_swa`` L; bf16: every B3 call at a
    prefill group and every attention through the tensor-core bodies) and
    one decode step (4·L + 3 a group); the kernel path's prefill logits
    against the plain path's (no launch, the routing replayed); the decode
    step's parting from the training forward with k_up's and v_up's
    adapters live, printed (the reference's decode never reads them); then
    teacher forcing with those adapters merged into W0
    (:func:`merged_kv_up`): the decode step against the training forward
    over prompt + 1, f32 within ``D_TOL`` with the argmax agreeing on every
    row whose top-2 margin exceeds twice that (bf16: held by
    :func:`mla_bf16`); the cache's bytes a token. Then the main path,
    ``serve()`` with the live adapter (f32: ``dtype`` float32 and an f32
    cache; bf16: the config's), the counters set to 0 just before and read
    just after. Returns (stats, main-path launches, bf16 launches,
    tensor-core launches, and for :func:`mla_bf16` what it compares)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    bsz, prompt, steps = (DS_SERVE[k] for k in ("batch", "prompt", "steps"))
    max_len, L, dt = prompt + steps, cfg.num_layers, cfg.dtype
    n_pre, n_dec = 6 * L, 4 * L  # MLA projections a prefill / decode layer
    mdt = torch.float32 if dt == "float32" else torch.bfloat16
    low = dt == "bfloat16"
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        with route_log() as pre_log:
            pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        calls, wide = pre_log.b3_calls(torch, cfg)
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", n_pre + calls,
                    L, dt, tc={"lora_matmul": n_pre + wide,
                               "lora_matmul_decode": calls - wide,
                               "flash_swa": L})
        ties = pre_log.counts()["ties"]
        k = cfg.num_experts_per_tok
        print(f"  [mla] {cfg.name} {dt} prefill: {ties} of "
              f"{bsz * prompt * (L - cfg.first_k_dense)} token-layers with "
              f"the router's {k}th and {k + 1}th probabilities exactly tied",
              flush=True)
        kernels.reset_launch_counts()
        with route_log() as dec_log:
            _, dec, cache = decode(params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        dcalls, dwide = dec_log.b3_calls(torch, cfg)
        _moe_expect(kernels, f"{cfg.name} {dt} one decode step",
                    n_dec + dcalls, 0, dt,
                    tc={"lora_matmul": dwide,
                        "lora_matmul_decode": n_dec + dcalls - dwide,
                        "flash_swa": 0})
        cache_bytes = mla_cache_bytes(cache, cfg)
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels), route_log(replay=pre_log.indices) as log:
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        plain_flips = _held_flips(log, dt, f"{dt} plain-path prefill")
        plain_own = log.own
        err_kp = float((pre - pre_plain).abs().max())
        if not low:
            lscale = float(pre_plain.abs().max())
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale).all())
            print(f"  [mla] f32 prefill last-position logits, kernel path vs "
                  f"plain path: max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}"
                  f", atol {MOE_P_TOL[1]} x logit scale {lscale:.3f}): "
                  f"within={ok}", flush=True)
            if not ok:
                raise AssertionError("mla f32 serve: the kernel path "
                                     "disagrees with the plain path")
        routes = _joined_routes(torch, pre_log.indices, dec_log.indices, bsz)
        with route_log(replay=routes):
            live = model.apply(params, {"tokens": full}, lora=lora,
                               lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        parting = float((dec[:, -1] - live).abs().max())
        print(f"  [mla] {cfg.name} {dt} k_up / v_up adapters live: the decode "
              f"step parts from the training forward by {parting:.4e} at a "
              f"logit scale of {float(live.abs().max()):.3f} (the absorbed "
              "decode reads the raw kernels, as the reference's)", flush=True)
        del dec, live
        mparams, mlora = merged_kv_up(torch, params, lora, lcfg.scale)
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        with route_log() as m_pre:
            _, cache = prefill(mparams, mlora, batch, cache)
        with route_log() as m_dec:
            _, dec, cache = decode(mparams, mlora, full[:, -1:], cache,
                                   prompt)
        del cache
        routes_m = _joined_routes(torch, m_pre.indices, m_dec.indices, bsz)
        with route_log(replay=routes_m) as log:
            train = model.apply(mparams, {"tokens": full}, lora=mlora,
                                lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        tf_flips = _held_flips(log, dt, f"{dt} training forward (merged)")
        got = dec[:, -1].clone()
        scale_tf = float(train.abs().max())
        err_tf = float((got - train).abs().max())
        if low:
            print(f"  [mla] {cfg.name} bf16 teacher-forced decode (k_up / v_up "
                  f"merged) vs the bf16 training forward: max |diff| "
                  f"{err_tf:.4e} = {err_tf / scale_tf:.3f} of the logit scale "
                  f"{scale_tf:.3f}", flush=True)
        else:
            ok, _ = _allclose(got, train, *D_TOL)
            margin_tol = D_TOL[1] + D_TOL[0] * scale_tf
            top2 = torch.topk(train, 2, dim=-1).values
            sure = top2[:, 0] - top2[:, 1] > 2 * margin_tol
            same = got.argmax(-1) == train.argmax(-1)
            agree = bool(same[sure].all())
            print(f"  [mla] {cfg.name} f32 teacher-forced decode (k_up / v_up "
                  f"merged) vs the training forward: max |diff| {err_tf:.4e} "
                  f"(rtol, atol {D_TOL}; logit scale {scale_tf:.3f}): "
                  f"within={ok}; argmax agrees on {int(same.sum())} of {bsz} "
                  f"rows, on the {int(sure.sum())} rows past 2 x tol: {agree}",
                  flush=True)
            if not (ok and agree):
                raise AssertionError("mla f32 serve: prefill + decode "
                                     "disagree with the training forward")
        cmp = {"pre": pre, "pre_plain": pre_plain, "routes": routes,
               "routes_tf": routes_m, "plain_own": plain_own, "decode": got,
               "train": train, "full": full, "merged": (mparams, mlora)}
        del dec
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    with route_log(light=True) as log:
        res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                    max_len=max_len, device=device, params=params, lora=lora,
                    **({} if low else {"dtype": torch.float32,
                                       "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    calls, wide = log.b3_calls(torch, cfg)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", n_pre + n_dec * steps + calls, L, dt,
                tc={"lora_matmul": n_pre + wide,
                    "lora_matmul_decode": n_dec * steps + calls - wide,
                    "flash_swa": L})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"mla serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             "kv_up_parting": parting, "router_ties": ties,
             "plain_flips": plain_flips["flips"],
             "tf_flips": tf_flips["flips"],
             "b3_expert_calls_serve": calls, "cache": cache_bytes,
             "seconds": time.perf_counter() - t0}
    print(f"  [mla] {cfg.name} {dt} batch {bsz}, prompt {prompt}, {steps} "
          f"decode steps, cache of {max_len}: prefill {res.prefill_ms:.1f} ms "
          f"({stats['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), "
          f"peak {stats['peak_gib']:.2f} GiB; B3 on expert groups {calls} of "
          f"{launches['lora_matmul']}; the cache "
          f"{cache_bytes['bytes_per_token']:.0f} B a token over {L} layers "
          f"against {cache_bytes['gqa_bytes_per_token']:.0f} for a 128-head "
          f"GQA cache at these dims ({cache_bytes['ratio']:.1f}x; "
          f"{cache_bytes['ref_ratio']:.1f}x against K and V of 128 a head); "
          f"{stats['seconds']:.1f} s; first row {toks[0, :8].tolist()}",
          flush=True)
    return stats, launches, bf16, tc, cmp


def mla_bf16(torch, kernels, device, scale):
    """The bf16 serve at the bf16 depth cut (1 dense + 4 MoE layers) from
    fresh draws (the port's own bf16 params, a rank-4 f32 adapter with
    per-expert adapters and b drawn N(0, 0.05²)) through
    :func:`mla_serve`, then two f32 answers over the same weights and
    prompt + 1 tokens (:func:`moe_f32_answer`, a layer widened at a time):
    over the live tree with the kernel path's routing replayed, for the
    prefill, and over the merged tree (:func:`merged_kv_up`) with the
    teacher-forcing run's routing, for the decode step. Held as
    :func:`moe_bf16` holds mixtral: the kernel path's prefill logits no
    further from the f32 answer than twice the bf16 plain path's plus one
    bf16 rounding at the logit scale, and from the plain path's no further
    than three times that distance plus the floor; the decode step no
    further from its f32 answer than twice the bf16 training forward's plus
    the floor, the argmax agreeing on every row whose f32 top-2 margin
    exceeds twice that bound; the kernel path's expert sets apart from the
    plain path's on no more than twice the token-layers the plain path's
    are apart from the f32 answer's. Returns (stats, launches, bf16
    launches, tensor-core launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(DS), num_layers=DS_DEPTH["bfloat16"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{DS}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale, lora_experts=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    print(f"  [mla] {cfg.name} bf16 at depth {cfg.num_layers} (a cut of "
          f"{get_config(DS).num_layers}): params and adapter on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats, launches, bf16, tc, cmp = mla_serve(torch, kernels, device, cfg,
                                               params, lora, lcfg)
    f32, log = moe_f32_answer(torch, cfg, params, lora, lcfg, cmp["full"],
                              cmp["routes"])
    torch.cuda.synchronize()
    f32_flips = _held_flips(log, "bfloat16", "f32 answer, live tree (bf16 "
                            "weights widened)")
    bsz = cmp["full"].shape[0]
    prompt_own = [x.view(bsz, -1, x.shape[-1])[:, :-1].flatten(0, 1)
                  for x in log.own]
    n_kp = _set_flips([x.view(bsz, -1, x.shape[-1])[:, :-1].flatten(0, 1)
                       for x in cmp["routes"]], cmp["plain_own"])
    n_pf = _set_flips(cmp["plain_own"], prompt_own)
    print(f"  [mla] bf16 prefill routing: the kernel path's expert sets "
          f"differ from the plain path's on {n_kp} token-layers, the plain "
          f"path's from the f32 answer's on {n_pf} (limit 2 x that): "
          f"ok={n_kp <= 2 * n_pf}", flush=True)
    if n_kp > 2 * n_pf:
        raise AssertionError("mla bf16 serve: the kernel path routes further "
                             "from the plain path than bf16 from f32")
    pre32 = f32[:, 0]
    del f32
    mparams, mlora = cmp.pop("merged")
    f32m, logm = moe_f32_answer(torch, cfg, mparams, mlora, lcfg, cmp["full"],
                                cmp["routes_tf"])
    torch.cuda.synchronize()
    _held_flips(logm, "bfloat16", "f32 answer, merged tree")
    next32 = f32m[:, 1]
    del f32m, mparams, mlora
    pre, pre_plain = cmp["pre"][:, -1], cmp["pre_plain"][:, -1]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [mla] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("mla bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [mla] bf16 teacher forcing (k_up / v_up merged): the decode "
          f"step vs the f32 answer {err_d:.4e}, the bf16 training forward vs "
          f"it {err_t:.4e} (bound 2 x that + {floor:.4e} = {bound:.4e}); "
          f"argmax agrees with f32 on {int(same.sum())} of {bsz} rows, on "
          f"the {int(sure.sum())} rows past 2 x bound: {agree}: ok={ok}",
          flush=True)
    if not ok:
        raise AssertionError("mla bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 f32_flips=f32_flips["flips"], flips_kernel_plain=n_kp,
                 flips_plain_f32=n_pf,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def mla_phase(torch, kernels, device):
    """Phase 11: deepseek-v2-236b at full width. The kernels at its shapes
    (:func:`mla_kernel_phase`); training at the f32 depth cut
    (:func:`moe_train`: fedex with per-expert adapters, after one MoE block
    against the dense oracle and one MLA + MoE layer's kernel path against
    its plain path) and the f32 serve of its folded W0 and global adapter
    (:func:`mla_serve`), then a 2-lane mesh round on them
    (:func:`family_mesh_run`); that state freed, the bf16 serve at the
    bf16 depth cut (:func:`mla_bf16`). Returns (max errors of the f32 cases, of
    the bf16 cases, timings, launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(DS), num_layers=DS_DEPTH["float32"],
                  dtype="float32")
    r, scale = 4, 2.0
    errs, bf16_errs, timings = mla_kernel_phase(torch, kernels, device, cfg,
                                                r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(torch, kernels, device, cfg,
                                             scale, tag="mla")
    for k, v in got.items():
        launches[k] += v
    # only the stats and launches: the rest holds the f32 tree
    lcfg = LoRAConfig(rank=r, alpha=8.0, lora_experts=True)
    served, got = mla_serve(
        torch, kernels, device, cfg, trainer.params, trainer.global_lora,
        lcfg)[:2]
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    stats["mesh"], got = family_mesh_run(torch, kernels, device, cfg,
                                         trainer, lcfg, "mla")
    for k, v in got.items():
        launches[k] += v
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = mla_bf16(torch, kernels, device, scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [mla] phase 11 in {stats['seconds']:.1f} s; peak memory: "
          f"kernels {stats['kernels_peak_gib']:.2f} GiB, f32 training "
          f"{stats['train']['train_peak_gib']:.2f} GiB, f32 serve "
          f"{stats['f32']['peak_gib']:.2f} GiB, mesh round "
          f"{stats['mesh']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats

# --------------------------------------------------------------------------
# phase 12: the hybrid family (zamba2-7b: Mamba2 layers + one shared block)
# --------------------------------------------------------------------------

ZB = "zamba2-7b"
# Full depth, no cut: 81 Mamba2 layers (13 periods of 6, each followed by
# the one parameter-shared attention + MLP block, then 3 trailing) of
# ≈ 77.6 M parameters each, the shared block ≈ 205 M, embed + lm_head
# ≈ 229 M: ≈ 6.72·10⁹ parameters, ≈ 26.9 GB in f32 and ≈ 13.4 GB in bf16,
# so one 80 GB card holds every layer. Training runs at full depth in f32
# too (reckoned: the weights' 27 GB, batch 8 × 64's activations through
# 81 Mamba2 layers and 13 shared applications, and the uniform close's
# temporaries of the 16.2 GB stacked in_proj leaf after them).
ZB_DEPTH = {"float32": 81, "bfloat16": 81}
ZB_SERVE = {"batch": 8, "prompt": 512, "steps": 32}  # cache prompt + steps


def hybrid_projections(cfg):
    """(name, K, N) of a Mamba2 layer's two adapted projections: in_proj
    (d → z, x, B, C, dt) and out_proj (d_inner → d)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return [("in_proj", cfg.d_model, 2 * d_inner + 2 * cfg.ssm_state + nheads),
            ("out_proj", d_inner, cfg.d_model)]


def hybrid_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At zamba2-7b's shapes: B1 at the stacked in_proj leaf (13 × 6
    matrices of 3584 × 14,576, ≈ 4.07·10⁹ elements), 2 live lanes of 4
    weighted, against its plain version in 8-matrix chunks and beside
    ``baddbmm``; B2 over a weighted close's 16 stacks (in_proj and out_proj
    of both Mamba2 stacks, the shared block's q/k/v/o with no layer axis),
    bitwise; B3 in f32 and bf16 at in_proj (K 3584 → N 14,576) and
    out_proj (K 7168 → N 3584) at the prefill rows (M 4096) and the decode
    rows (M 8) — the tiled, SIMT split-K, tensor-core and tensor-core
    split-K bodies — each bf16 call through its tensor-core body; B8 at
    the shared block's prefill (B 8, S 512, 32 heads MHA, head dim 112:
    the second 64-column box part real, part past d) in f32 and bf16 (the
    tensor-core body); then the exact-rounding probes at d 112 and at the
    two projections, bitwise. Returns (max errors of the f32 cases, of the
    bf16 cases, timings)."""
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    from repro_torch.models.transformer import hybrid_layout
    timer = Timer(torch, device)
    nper, trailing = hybrid_layout(cfg)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0,
            "flash_swa": 0.0}
    bf16_errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    proj = hybrid_projections(cfg)
    (_, d, n_in), (_, d_inner, _) = proj
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "zb", nper * cfg.attn_every, d, n_in,
        c, live, r, scale, seed=310, leaf="in_proj")
    leaves = [(f"{stack}/{name}", n_l, k, n)
              for stack, n_l in (("mamba_layers", nper * cfg.attn_every),
                                 ("mamba_trailing", trailing))
              for name, k, n in proj]
    leaves += [(f"shared_attn/{name}", 1, k, n)
               for name, k, n in serving_projections(cfg)]
    timings["factor_mean"] = group_mean_case(torch, kernels, timer, device,
                                             "zb", leaves, c, live, r, w,
                                             seed=320)
    low = torch.bfloat16
    bsz, prompt = ZB_SERVE["batch"], ZB_SERVE["prompt"]
    for key, dtype, m in (("zb", torch.float32, bsz * prompt),
                          ("zb_decode", torch.float32, bsz),
                          ("zb_bf16", low, bsz * prompt),
                          ("zb_bf16_decode", low, bsz)):
        bufs = [[t.to(dtype) for t in lora_inputs(torch, device, m, k, n, r,
                                                  seed=340 + i)]
                for i, (_, k, n) in enumerate(proj)]
        if dtype == low:
            tc_calls(torch, kernels, bufs, scale, f"{key} M={m}", len(bufs),
                     decode=m <= SKINNY_ROWS)
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{cfg.name} {key}: {'/'.join(s[0] for s in proj)} at M={m}",
            device_times=True)
        sink = bf16_errs if dtype == low else errs
        sink["lora_matmul"] = max(sink["lora_matmul"], err)
        del bufs
        torch.cuda.empty_cache()
    hd = cfg.resolved_head_dim
    for i, (key, dtype) in enumerate((("flash_zb", None),
                                      ("flash_zb_bf16", low))):
        err, timings[key] = flash_case(
            torch, kernels, timer, device, bsz, prompt, cfg.num_heads,
            cfg.num_kv_heads, hd, True, 0, seed=350 + i, device_times=True,
            dtype=dtype, tc=dtype == low)
        sink = bf16_errs if dtype == low else errs
        sink["flash_swa"] = max(sink["flash_swa"], err)
    torch.cuda.empty_cache()
    lora_probes(torch, kernels, device,
                [("zamba2-7b", m, k, n, 4) for _, k, n in proj
                 for m in (bsz, bsz * prompt)])
    flash_probes(torch, kernels, device,
                 [("zamba2-7b", bsz, prompt, cfg.num_heads, cfg.num_kv_heads,
                   hd, True),
                  ("d 112 non-causal", 2, 300, 4, 4, hd, False)])
    return errs, bf16_errs, timings


def hybrid_state_bytes(cache) -> dict:
    """The Mamba2 state's bytes a sequence (ssm and conv of every Mamba2
    layer; the ssm part apart) and the shared block's KV cache's bytes a
    token (K and V of its one cache a period)."""
    flat = _flat(cache)
    kv = [flat[f"shared_attn/{n}"] for n in ("k", "v")]
    bsz, length = kv[0].shape[1], kv[0].shape[2]

    def nbytes(keys):
        return sum(flat[k].numel() * flat[k].element_size() for k in keys)

    mamba = [k for k in flat if not k.startswith("shared_attn/")]
    return {"state_bytes_per_seq": nbytes(mamba) / bsz,
            "ssm_bytes_per_seq": nbytes([k for k in mamba
                                         if k.endswith("ssm")]) / bsz,
            "kv_bytes_per_token": nbytes([f"shared_attn/{n}"
                                          for n in ("k", "v")])
            / (bsz * length)}


def hybrid_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``ZB_SERVE``'s shape, its cache in the model's dtype. With the counters
    set to 0 just before each: one prefill (``lora_matmul`` two a Mamba2
    layer and four a shared application, 214 at full depth, ``flash_swa``
    one a period, 13; bf16: every one through the tensor-core bodies) and one decode step
    (``lora_matmul`` 214; bf16: the tensor-core split-K body); the kernel
    path's prefill logits against the plain path's; teacher forcing, the
    decode step against the port's training forward over prompt + 1, f32
    within ``D_TOL`` with the argmax agreeing on every row whose top-2
    margin exceeds twice that (bf16: held by :func:`hybrid_bf16`); the
    state's bytes (:func:`hybrid_state_bytes`). Then the main path,
    ``serve()`` (f32: ``dtype`` float32 and an f32 cache; bf16: the
    config's), the counters set to 0 just before and read just after.
    Returns (stats, main-path launches, bf16 launches, tensor-core
    launches, and for :func:`hybrid_bf16` what it compares)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import hybrid_layout

    bsz, prompt, steps = (ZB_SERVE[k] for k in ("batch", "prompt", "steps"))
    max_len, dt = prompt + steps, cfg.dtype
    nper, _ = hybrid_layout(cfg)
    # in_proj and out_proj of every Mamba2 layer, q/k/v/o of every
    # application of the shared block
    n_b3 = 2 * cfg.num_layers + 4 * nper
    low = dt == "bfloat16"
    mdt = torch.bfloat16 if low else torch.float32
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", n_b3, nper, dt,
                    tc={"lora_matmul": n_b3, "lora_matmul_decode": 0,
                        "flash_swa": nper})
        kernels.reset_launch_counts()
        _, dec, cache = decode(params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        _moe_expect(kernels, f"{cfg.name} {dt} one decode step", n_b3, 0, dt,
                    tc={"lora_matmul": 0, "lora_matmul_decode": n_b3,
                        "flash_swa": 0})
        state = hybrid_state_bytes(cache)
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        err_kp = float((pre - pre_plain).abs().max())
        if not low:
            lscale = float(pre_plain.abs().max())
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale).all())
            print(f"  [zb] f32 prefill last-position logits, kernel path vs "
                  f"plain path: max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}"
                  f", atol {MOE_P_TOL[1]} x logit scale {lscale:.3f}): "
                  f"within={ok}", flush=True)
            if not ok:
                raise AssertionError("zb f32 serve: the kernel path "
                                     "disagrees with the plain path")
        train = model.apply(params, {"tokens": full}, lora=lora,
                            lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        got = dec[:, -1].clone()
        scale_tf = float(train.abs().max())
        err_tf = float((got - train).abs().max())
        if low:
            print(f"  [zb] {cfg.name} bf16 teacher-forced decode vs the bf16 "
                  f"training forward: max |diff| {err_tf:.4e} = "
                  f"{err_tf / scale_tf:.3f} of the logit scale "
                  f"{scale_tf:.3f}", flush=True)
        else:
            ok, _ = _allclose(got, train, *D_TOL)
            margin_tol = D_TOL[1] + D_TOL[0] * scale_tf
            top2 = torch.topk(train, 2, dim=-1).values
            sure = top2[:, 0] - top2[:, 1] > 2 * margin_tol
            same = got.argmax(-1) == train.argmax(-1)
            agree = bool(same[sure].all())
            print(f"  [zb] {cfg.name} f32 teacher-forced decode vs the "
                  f"training forward: max |diff| {err_tf:.4e} (rtol, atol "
                  f"{D_TOL}; logit scale {scale_tf:.3f}): within={ok}; "
                  f"argmax agrees on {int(same.sum())} of {bsz} rows, on the "
                  f"{int(sure.sum())} rows past 2 x tol: {agree}", flush=True)
            if not (ok and agree):
                raise AssertionError("zb f32 serve: prefill + decode "
                                     "disagree with the training forward")
        cmp = {"pre": pre[:, -1], "pre_plain": pre_plain[:, -1],
               "decode": got, "train": train, "full": full}
        del dec, pre, pre_plain
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                **({} if low else {"dtype": torch.float32,
                                   "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", n_b3 * (1 + steps), nper, dt,
                tc={"lora_matmul": n_b3, "lora_matmul_decode": n_b3 * steps,
                    "flash_swa": nper})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"zb serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             "state": state, "seconds": time.perf_counter() - t0}
    print(f"  [zb] {cfg.name} {dt} batch {bsz}, prompt {prompt}, {steps} "
          f"decode steps, cache of {max_len}: prefill {res.prefill_ms:.1f} ms "
          f"({stats['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), "
          f"peak {stats['peak_gib']:.2f} GiB; the Mamba2 state "
          f"{state['state_bytes_per_seq'] / 1e6:.1f} MB a sequence over "
          f"{cfg.num_layers} layers (ssm {state['ssm_bytes_per_seq'] / 1e6:.1f}"
          f" MB), the shared block's KV cache "
          f"{state['kv_bytes_per_token'] / 1024:.1f} KiB a token over {nper} "
          f"applications; {stats['seconds']:.1f} s; first row "
          f"{toks[0, :8].tolist()}", flush=True)
    return stats, launches, bf16, tc, cmp


def hybrid_f32_answer(torch, cfg, params, lora, lcfg, tokens):
    """The f32 training forward of a hybrid config over ``tokens`` (B, S)
    from bf16 ``params``, widened one Mamba2 layer at a time (the shared
    block once): the logits at the last two positions (the prompt's last,
    for the prefill; the next token's, for the decode step)."""
    from dataclasses import replace

    from repro_torch.models import ssm, transformer
    from repro_torch.models.common import apply_norm, embed, unembed

    f32 = replace(cfg, dtype="float32")
    nper, trailing = transformer.hybrid_layout(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def wide(tree):
        return _unflat({k: v.float() for k, v in _flat(tree).items()})

    def mamba(x, key, idx):
        p = wide(transformer._layer_slice(params[key], *idx))
        lo = transformer._layer_slice(lora.get(key), *idx)
        h, _ = ssm.mamba2_block(f32, p["mamba"],
                                apply_norm(cfg.norm, p["norm"], x),
                                lora=None if lo is None else lo["mamba"],
                                lora_scale=lcfg.scale)
        return x + h

    with torch.inference_mode():
        x = embed(wide(params["embed"]), tokens)
        shared = wide(params["shared_attn"])
        for i in range(nper):
            for j in range(cfg.attn_every):
                x = mamba(x, "mamba_layers", (i, j))
            x, _ = transformer.decoder_layer(
                f32, shared, x, lora=lora.get("shared_attn"),
                lora_scale=lcfg.scale, positions=positions, window=0,
                cache=None, position=None)
        for i in range(trailing):
            x = mamba(x, "mamba_trailing", (i,))
        x = apply_norm(cfg.norm, wide(params["final_norm"]), x[:, -2:])
        return unembed(wide(params["lm_head"]), x)


def hybrid_bf16(torch, kernels, device, scale):
    """The bf16 serve at the bf16 depth from fresh draws (the port's own
    bf16 params, a rank-4 f32 adapter with b drawn N(0, 0.05²)) through
    :func:`hybrid_serve`, then the f32 answer over the same weights and
    prompt + 1 tokens (:func:`hybrid_f32_answer`). Held as phase 9 holds
    its bf16 serves: the kernel path's prefill logits no further from the
    f32 answer than twice the bf16 plain path's plus one bf16 rounding at
    the logit scale, and from the plain path's no further than three times
    that distance plus the floor; the decode step no further from its f32
    answer than twice the bf16 training forward's plus the floor, the
    argmax agreeing on every row whose f32 top-2 margin exceeds twice that
    bound. Returns (stats, launches, bf16 launches, tensor-core
    launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(ZB), num_layers=ZB_DEPTH["bfloat16"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{ZB}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    print(f"  [zb] {cfg.name} bf16 at depth {cfg.num_layers}: params and "
          f"adapter on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stats, launches, bf16, tc, cmp = hybrid_serve(torch, kernels, device, cfg,
                                                  params, lora, lcfg)
    f32 = hybrid_f32_answer(torch, cfg, params, lora, lcfg, cmp["full"])
    torch.cuda.synchronize()
    pre32, next32 = f32[:, 0], f32[:, 1]
    bsz = cmp["full"].shape[0]
    pre, pre_plain = cmp["pre"], cmp["pre_plain"]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [zb] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("zb bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [zb] bf16 teacher forcing: the decode step vs the f32 answer "
          f"{err_d:.4e}, the bf16 training forward vs it {err_t:.4e} (bound "
          f"2 x that + {floor:.4e} = {bound:.4e}); argmax agrees with f32 on "
          f"{int(same.sum())} of {bsz} rows, on the {int(sure.sum())} rows "
          f"past 2 x bound: {agree}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("zb bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp, f32
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def hybrid_phase(torch, kernels, device):
    """Phase 12: zamba2-7b at full width and depth. The kernels at its
    shapes (:func:`hybrid_kernel_phase`); training in f32
    (:func:`moe_train` with adapters on in_proj, out_proj and the shared
    block's q/k/v/o: fedex, a uniform round, then a weighted one at 50%)
    and the f32 serve of its folded W0 and global adapter
    (:func:`hybrid_serve`), then a 2-lane mesh round on them
    (:func:`family_mesh_run`); that state freed, the bf16 serve from fresh
    draws (:func:`hybrid_bf16`). Returns (max errors of the f32 cases, of
    the bf16 cases, timings, launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(ZB), num_layers=ZB_DEPTH["float32"],
                  dtype="float32")
    r, scale = 4, 2.0
    lcfg = LoRAConfig(rank=r, alpha=8.0)
    errs, bf16_errs, timings = hybrid_kernel_phase(torch, kernels, device,
                                                   cfg, r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(torch, kernels, device, cfg,
                                             scale, tag="zb", lcfg=lcfg)
    for k, v in got.items():
        launches[k] += v
    served, got = hybrid_serve(torch, kernels, device, cfg, trainer.params,
                               trainer.global_lora, lcfg)[:2]
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    stats["mesh"], got = family_mesh_run(torch, kernels, device, cfg,
                                         trainer, lcfg, "zb")
    for k, v in got.items():
        launches[k] += v
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = hybrid_bf16(torch, kernels, device, scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [zb] phase 12 in {stats['seconds']:.1f} s; peak memory: "
          f"kernels {stats['kernels_peak_gib']:.2f} GiB, f32 training "
          f"{stats['train']['train_peak_gib']:.2f} GiB, f32 serve "
          f"{stats['f32']['peak_gib']:.2f} GiB, mesh round "
          f"{stats['mesh']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats

# --------------------------------------------------------------------------
# phase 13: the ssm family (xlstm-1.3b: mLSTM and sLSTM blocks)
# --------------------------------------------------------------------------

XL = "xlstm-1.3b"
# Full depth, no cut: 48 blocks (6 periods of 7 mLSTM + 1 sLSTM). The
# reference's mLSTM has dense q/k/v (4096 × 4096 each): ≈ 75.5 M weights a
# block, an sLSTM block ≈ 37.7 M (w_gates, 4 × 4 heads of 512 × 512
# recurrent weights, the FFN of width 2730), the tied embedding ≈ 103 M:
# ≈ 3.50·10⁹ parameters, ≈ 14.0 GB in f32 and ≈ 7.0 GB in bf16, so one
# 80 GB card holds every block in both. Training runs at full depth in f32
# (reckoned: the weights' 14 GB, batch 8 × 64's activations through 48
# blocks, ≈ 0.2 GB a block, and the close's temporaries of the 2.8 GB
# stacked q/k/v leaves after them); serving at batch 8 holds 5.6 GB of
# f32 matrix memory (C) beside the weights.
XL_DEPTH = {"float32": 48, "bfloat16": 48}
XL_SERVE = {"batch": 8, "prompt": 512, "steps": 32}  # cache prompt + steps


def xlstm_projections(cfg):
    """(name, K, N) of the adapted projections: an mLSTM block's up_proj
    (d → x, z), q/k/v (d_inner → d_inner) and down_proj (d_inner → d), an
    sLSTM block's w_gates (d → z, i, f, o), then its FFN's up_proj and
    down_proj (K or N int(4·d / 3) = 2730, not a multiple of 8)."""
    d = cfg.d_model
    d_inner, ff = cfg.ssm_expand * d, int(d * 4 / 3)
    return ([("up_proj", d, 2 * d_inner), ("q_proj", d_inner, d_inner),
             ("k_proj", d_inner, d_inner), ("v_proj", d_inner, d_inner),
             ("down_proj", d_inner, d), ("w_gates", d, 4 * d)],
            [("ffn/up_proj", d, ff), ("ffn/down_proj", ff, d)])


def lora_dense_halves(kernels):
    """``lora_dense_plain`` summed over K in two halves: x₀W₀ +
    s(x₀a₀)b + x₁W₁ + s(x₁a₁)b, the same function as x W + s(x a) b,
    rounded in another order. A serving path through it is a second f32
    evaluation of the model; its distance from the plain path's is the
    model's own f32 spread."""
    def dense(x, w, a, b, scale):
        k = w.shape[0] // 2
        return (kernels.lora_dense_plain(x[..., :k], w[:k], a[:k], b, scale)
                + kernels.lora_dense_plain(x[..., k:], w[k:], a[k:], b,
                                           scale))
    return dense


def xlstm_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At xlstm-1.3b's shapes: B1 at the stacked q_proj leaf (6 × 7
    matrices of 4096 × 4096, ≈ 7.05·10⁸ elements), 2 live lanes of 4
    weighted, against its plain version in 8-matrix chunks and beside
    ``baddbmm``; B2 over a weighted close's 16 stacks (the 8 adapted
    leaves' a and b), bitwise; B3 in f32 and bf16 at the prefill rows (M
    4096) and the decode rows (M 8): ``xl``, an mLSTM block's five
    projections and the sLSTM's w_gates (each bf16 call through a
    tensor-core body), ``xl_ffn``, the FFN's up_proj and down_proj at K or
    N 2730 (each bf16 call through a SIMT body); then the exact-rounding
    probes at these projections, bitwise. Returns (max errors of the f32
    cases, of the bf16 cases, timings)."""
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    from repro_torch.models.transformer import xlstm_layout
    timer = Timer(torch, device)
    nper, period = xlstm_layout(cfg)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0}
    bf16_errs = {"lora_matmul": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    main, ffn = xlstm_projections(cfg)
    n_m = nper * (period - 1)
    d_inner = cfg.ssm_expand * cfg.d_model
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "xl", n_m, d_inner, d_inner, c, live,
        r, scale, seed=410, leaf="q_proj")
    leaves = [(f"periods/mlstm/{name}", n_m, k, n)
              for name, k, n in main[:5]]
    leaves += [(f"periods/slstm/{name}", nper, k, n)
               for name, k, n in main[5:] + ffn]
    timings["factor_mean"] = group_mean_case(torch, kernels, timer, device,
                                             "xl", leaves, c, live, r, w,
                                             seed=420)
    low = torch.bfloat16
    bsz, prompt = XL_SERVE["batch"], XL_SERVE["prompt"]
    for group, proj, tc in (("xl", main, len(main)), ("xl_ffn", ffn, 0)):
        for suffix, dtype, m in (("", torch.float32, bsz * prompt),
                                 ("_decode", torch.float32, bsz),
                                 ("_bf16", low, bsz * prompt),
                                 ("_bf16_decode", low, bsz)):
            key = group + suffix
            bufs = [[t.to(dtype) for t in lora_inputs(
                torch, device, m, k, n, r, seed=440 + i)]
                for i, (_, k, n) in enumerate(proj)]
            if dtype == low:
                tc_calls(torch, kernels, bufs, scale, f"{key} M={m}", tc,
                         decode=m <= SKINNY_ROWS)
            err, timings[key] = lora_case(
                torch, kernels, timer, bufs, scale,
                f"{cfg.name} {key}: {'/'.join(s[0] for s in proj)} at M={m}",
                device_times=True)
            sink = bf16_errs if dtype == low else errs
            sink["lora_matmul"] = max(sink["lora_matmul"], err)
            del bufs
            torch.cuda.empty_cache()
    shapes = sorted({(k, n) for _, k, n in main + ffn})
    lora_probes(torch, kernels, device,
                [("xlstm-1.3b", m, k, n, 4) for k, n in shapes
                 for m in (bsz, bsz * prompt)])
    return errs, bf16_errs, timings


def xlstm_state_bytes(cache) -> dict:
    """The recurrent state's bytes a sequence: the mLSTM's C, n, m and
    conv (C apart) over its blocks, the sLSTM's c, n, m and h over its."""
    flat = _flat(cache)
    bsz = flat["slstm/h"].shape[1]

    def nbytes(keys):
        return sum(flat[k].numel() * flat[k].element_size()
                   for k in keys) / bsz

    return {"mlstm_bytes_per_seq": nbytes([k for k in flat
                                           if k.startswith("mlstm/")]),
            "mlstm_C_bytes_per_seq": nbytes(["mlstm/C"]),
            "slstm_bytes_per_seq": nbytes([k for k in flat
                                           if k.startswith("slstm/")])}


def xlstm_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``XL_SERVE``'s shape (the prompt two mLSTM chunks of 256), its cache in
    the model's dtype. With the counters set to 0 just before each: one
    prefill and one decode step (``lora_matmul`` 228 each at full depth:
    five an mLSTM block, three an sLSTM block; bf16: all but the FFN's
    two an sLSTM block, which the SIMT bodies take, through the
    tensor-core bodies); the kernel path's prefill logits against the
    plain path's; teacher forcing, the decode step against the port's
    training forward over prompt + 1 (bf16: held by :func:`xlstm_bf16`).
    In f32 the model itself is ill-conditioned: a dot product of two
    random 1024-wide head vectors carries ≈ √1024 times its inputs'
    relative error, so every mLSTM block multiplies an f32 rounding
    difference by ≈ 30 (1.2e-7 of noise on the projections parts the
    logits by 4e-4 after 8 blocks, on the CPU). So f32 is held against
    the model's own spread, measured here: the plain path again with each
    projection summed over K in two halves (:func:`lora_dense_halves`);
    the kernel path within ``MOE_P_TOL`` of the plain path plus 3 times
    that spread, the decode step within ``D_TOL`` of the training forward
    plus 3 times the spread at the last position, its argmax agreeing on
    every row whose top-2 margin exceeds twice that; the state's bytes
    (:func:`xlstm_state_bytes`). Then the main path, ``serve()`` (f32:
    ``dtype`` float32 and an f32 cache; bf16: the config's), the counters
    set to 0 just before and read just after. Returns (stats, main-path
    launches, bf16 launches, tensor-core launches, and for
    :func:`xlstm_bf16` what it compares)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import xlstm_layout

    bsz, prompt, steps = (XL_SERVE[k] for k in ("batch", "prompt", "steps"))
    max_len, dt = prompt + steps, cfg.dtype
    nper, period = xlstm_layout(cfg)
    n_b3 = 5 * nper * (period - 1) + 3 * nper
    n_tc = n_b3 - 2 * nper
    low = dt == "bfloat16"
    mdt = torch.bfloat16 if low else torch.float32
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    batch = make_batch_for(cfg, bsz, prompt, seed=0, device=device)
    full = torch.cat([batch["tokens"], batch["targets"][:, -1:]], dim=1)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", n_b3, 0, dt,
                    tc={"lora_matmul": n_tc, "lora_matmul_decode": 0,
                        "flash_swa": 0})
        kernels.reset_launch_counts()
        _, dec, cache = decode(params, lora, full[:, -1:], cache, prompt)
        torch.cuda.synchronize()
        _moe_expect(kernels, f"{cfg.name} {dt} one decode step", n_b3, 0, dt,
                    tc={"lora_matmul": 0, "lora_matmul_decode": n_tc,
                        "flash_swa": 0})
        state = xlstm_state_bytes(cache)
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        err_kp = float((pre - pre_plain).abs().max())
        spread = spread_last = 0.0
        if not low:
            with plain_ops(kernels, dense=lora_dense_halves(kernels)):
                cache = model.init_cache(bsz, max_len, mdt, device=device)
                pre_alt, cache = prefill(params, lora, batch, cache)
                del cache
            torch.cuda.synchronize()
            diff = (pre_alt - pre_plain).abs()
            spread, spread_last = float(diff.max()), float(diff[:, -1].max())
            del pre_alt, diff
            lscale = float(pre_plain.abs().max())
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale
                       + 3 * spread).all())
            print(f"  [xl] f32 prefill logits, kernel path vs plain path: "
                  f"max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}, atol "
                  f"{MOE_P_TOL[1]} x logit scale {lscale:.3f} + 3 x the "
                  f"model's f32 spread {spread:.3e}, at the last position "
                  f"{spread_last:.3e}): within={ok}", flush=True)
            if not ok:
                raise AssertionError("xl f32 serve: the kernel path "
                                     "disagrees with the plain path")
        train = model.apply(params, {"tokens": full}, lora=lora,
                            lora_scale=lcfg.scale)[:, -1].clone()
        torch.cuda.synchronize()
        got = dec[:, -1].clone()
        scale_tf = float(train.abs().max())
        err_tf = float((got - train).abs().max())
        if low:
            print(f"  [xl] {cfg.name} bf16 teacher-forced decode vs the bf16 "
                  f"training forward: max |diff| {err_tf:.4e} = "
                  f"{err_tf / scale_tf:.3f} of the logit scale "
                  f"{scale_tf:.3f}", flush=True)
        else:
            atol = D_TOL[1] + 3 * spread_last
            ok, _ = _allclose(got, train, D_TOL[0], atol)
            margin_tol = atol + D_TOL[0] * scale_tf
            top2 = torch.topk(train, 2, dim=-1).values
            sure = top2[:, 0] - top2[:, 1] > 2 * margin_tol
            same = got.argmax(-1) == train.argmax(-1)
            agree = bool(same[sure].all())
            print(f"  [xl] {cfg.name} f32 teacher-forced decode vs the "
                  f"training forward: max |diff| {err_tf:.4e} (rtol "
                  f"{D_TOL[0]}, atol {D_TOL[1]} + 3 x {spread_last:.3e}; "
                  f"logit scale {scale_tf:.3f}): within={ok}; argmax agrees "
                  f"on {int(same.sum())} of {bsz} rows, on the "
                  f"{int(sure.sum())} rows past 2 x tol: {agree}", flush=True)
            if not (ok and agree):
                raise AssertionError("xl f32 serve: prefill + decode "
                                     "disagree with the training forward")
        cmp = {"pre": pre[:, -1], "pre_plain": pre_plain[:, -1],
               "decode": got, "train": train, "full": full}
        del dec, pre, pre_plain
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                **({} if low else {"dtype": torch.float32,
                                   "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", n_b3 * (1 + steps), 0, dt,
                tc={"lora_matmul": n_tc, "lora_matmul_decode": n_tc * steps,
                    "flash_swa": 0})
    if low:
        simt = bf16["lora_matmul"] - tc["lora_matmul"] - tc[
            "lora_matmul_decode"]
        print(f"  [xl] bf16 serve() B3 launches: {bf16['lora_matmul']}, "
              f"tensor-core {tc['lora_matmul']} (prefill) + "
              f"{tc['lora_matmul_decode']} (split-K decode), SIMT {simt} "
              "(the FFN's K or N 2730)", flush=True)
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"xl serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms, "first_prefill_ms": pre_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             "f32_spread": spread, "f32_spread_last": spread_last,
             "state": state, "seconds": time.perf_counter() - t0}
    state_mb = (state["mlstm_bytes_per_seq"]
                + state["slstm_bytes_per_seq"]) / 1e6
    print(f"  [xl] {cfg.name} {dt} batch {bsz}, prompt {prompt}, {steps} "
          f"decode steps: prefill {res.prefill_ms:.1f} ms "
          f"({stats['prefill_tokens_per_s']:.0f} tokens/s; the first, "
          f"counted, {pre_ms:.1f} ms), decode {res.ms_per_token:.2f} "
          f"ms/token ({stats['decode_tokens_per_s']:.1f} tokens/s over the "
          f"batch), peak {stats['peak_gib']:.2f} GiB; the recurrent state "
          f"{state_mb:.1f} MB a sequence (mLSTM "
          f"{state['mlstm_bytes_per_seq'] / 1e6:.1f} MB, its C "
          f"{state['mlstm_C_bytes_per_seq'] / 1e6:.1f} MB; sLSTM "
          f"{state['slstm_bytes_per_seq'] / 1e3:.1f} kB); "
          f"{stats['seconds']:.1f} s; first row {toks[0, :8].tolist()}",
          flush=True)
    return stats, launches, bf16, tc, cmp


def xlstm_f32_answer(torch, cfg, params, lora, lcfg, tokens):
    """The f32 training forward of an ssm config over ``tokens`` (B, S)
    from bf16 ``params``, widened one block at a time: the logits at the
    last two positions (the prompt's last, for the prefill; the next
    token's, for the decode step)."""
    from dataclasses import replace

    from repro_torch.models import transformer, xlstm
    from repro_torch.models.common import apply_norm, embed, unembed

    f32 = replace(cfg, dtype="float32")
    nper, period = transformer.xlstm_layout(cfg)
    per, per_lora = params["periods"], lora.get("periods") or {}

    def wide(tree):
        return _unflat({k: v.float() for k, v in _flat(tree).items()})

    def block(fn, x, kind, *idx):
        return fn(f32, wide(transformer._layer_slice(per[kind], *idx)), x,
                  lora=transformer._layer_slice(per_lora.get(kind), *idx),
                  lora_scale=lcfg.scale)[0]

    with torch.inference_mode():
        table = params["embed"]["embedding"].float()
        x = embed({"embedding": table}, tokens)
        for i in range(nper):
            for j in range(period - 1):
                x = block(xlstm.mlstm_block, x, "mlstm", i, j)
            x = block(xlstm.slstm_block, x, "slstm", i)
        x = apply_norm(cfg.norm, wide(params["final_norm"]), x[:, -2:])
        return unembed({}, x, tied_embedding=table)


def xlstm_block_check(torch, kernels, device, cfg, params, lora, lcfg,
                      tokens):
    """The bf16 serving prefill held a block at a time: over period 0
    (7 mLSTM blocks, then the sLSTM block), each block's prefill from a
    fresh bf16 cache through B3 (the kernel path) and through the plain
    versions, and its f32 answer (the block widened, from the same input,
    an f32 cache), the input of each block the kernel path's output of
    the one before (the embedded ``tokens`` for the first). A random
    xLSTM in bf16 parts from its f32 answer by ≈ 1–3% of the residual's
    scale a block, which compounds over 48 blocks to the logit scale
    itself, so the whole-model comparison of :func:`xlstm_bf16` holds
    little; a block's holds its kernels: each block's output no further
    from its f32 answer than twice the plain path's plus one bf16 rounding
    at its scale, and from the plain path's no further than three times
    that distance plus the floor. Returns the largest kernel-path error
    as a share of the block's scale."""
    from dataclasses import replace

    from repro_torch.models import transformer, xlstm
    from repro_torch.models.common import embed

    f32 = replace(cfg, dtype="float32")
    per, per_lora = params["periods"], lora.get("periods") or {}
    bsz = tokens.shape[0]
    blocks = [("mlstm", (0, j)) for j in range(cfg.slstm_every - 1)]
    blocks.append(("slstm", (0,)))
    worst = 0.0
    with torch.inference_mode():
        x = embed(params["embed"], tokens)
        for kind, idx in blocks:
            fn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
            init = (xlstm.init_mlstm_cache if kind == "mlstm"
                    else xlstm.init_slstm_cache)
            p = transformer._layer_slice(per[kind], *idx)
            lo = transformer._layer_slice(per_lora.get(kind), *idx)

            def run(c, pp, xx, dtype):
                return fn(c, pp, xx, lora=lo, lora_scale=lcfg.scale,
                          cache=init(bsz, c, dtype, device))[0]

            y = run(cfg, p, x, torch.bfloat16)
            with plain_ops(kernels):
                y_plain = run(cfg, p, x, torch.bfloat16)
                y32 = run(f32, _unflat({k: v.float() for k, v in
                                        _flat(p).items()}), x.float(),
                          torch.float32)
            torch.cuda.synchronize()
            scale = float(y32.abs().max())
            floor = 2.0 ** -8 * scale
            err_k = float((y.float() - y32).abs().max())
            err_p = float((y_plain.float() - y32).abs().max())
            err_kp = float((y.float() - y_plain.float()).abs().max())
            ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
            worst = max(worst, err_k / scale)
            print(f"  [xl] bf16 {kind} block {list(idx)} prefill: kernel "
                  f"path vs its f32 answer {err_k:.4e} ({err_k / scale:.2%}"
                  f" of the scale {scale:.3f}), plain path {err_p:.4e} "
                  f"(bound 2 x that + {floor:.4e}), kernel vs plain "
                  f"{err_kp:.4e}: ok={ok}", flush=True)
            if not ok:
                raise AssertionError(f"xl bf16 {kind} block {list(idx)}: "
                                     "the kernel path is further from the "
                                     "f32 answer than allowed")
            x = y
            del y_plain, y32
    return worst


def xlstm_bf16(torch, kernels, device, scale):
    """The bf16 serve at the bf16 depth from fresh draws (the port's own
    bf16 params, a rank-4 f32 adapter with b drawn N(0, 0.05²)) through
    :func:`xlstm_serve`, then the f32 answer over the same weights and
    prompt + 1 tokens (:func:`xlstm_f32_answer`); then period 0 a block
    at a time (:func:`xlstm_block_check`), where the comparison still
    holds the kernels (at full depth the bf16 model's logits part from
    the f32 answer by about the logit scale, the plain path's as much).
    Held as phase 12 holds its bf16 serve: the kernel path's prefill
    logits no further from the
    f32 answer than twice the bf16 plain path's plus one bf16 rounding at
    the logit scale, and from the plain path's no further than three times
    that distance plus the floor; the decode step no further from its f32
    answer than twice the bf16 training forward's plus the floor, the
    argmax agreeing on every row whose f32 top-2 margin exceeds twice that
    bound. Returns (stats, launches, bf16 launches, tensor-core
    launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(XL), num_layers=XL_DEPTH["bfloat16"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{XL}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    if params["periods"]["slstm"]["b_gates"].dtype != torch.float32:
        raise AssertionError("xl bf16: b_gates is not f32")
    print(f"  [xl] {cfg.name} bf16 at depth {cfg.num_layers}: params and "
          f"adapter on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stats, launches, bf16, tc, cmp = xlstm_serve(torch, kernels, device, cfg,
                                                 params, lora, lcfg)
    f32 = xlstm_f32_answer(torch, cfg, params, lora, lcfg, cmp["full"])
    torch.cuda.synchronize()
    pre32, next32 = f32[:, 0], f32[:, 1]
    bsz = cmp["full"].shape[0]
    pre, pre_plain = cmp["pre"], cmp["pre_plain"]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [xl] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("xl bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [xl] bf16 teacher forcing: the decode step vs the f32 answer "
          f"{err_d:.4e}, the bf16 training forward vs it {err_t:.4e} (bound "
          f"2 x that + {floor:.4e} = {bound:.4e}); argmax agrees with f32 on "
          f"{int(same.sum())} of {bsz} rows, on the {int(sure.sum())} rows "
          f"past 2 x bound: {agree}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("xl bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats["block_err_share"] = xlstm_block_check(
        torch, kernels, device, cfg, params, lora, lcfg,
        cmp["full"][:, :XL_SERVE["prompt"]])
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp, f32
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def xlstm_phase(torch, kernels, device):
    """Phase 13: xlstm-1.3b at full width and depth. The kernels at its
    shapes (:func:`xlstm_kernel_phase`); training in f32 (:func:`moe_train`
    with adapters on the 8 leaves: fedex, a uniform round, then a weighted
    one at 50%) and the f32 serve of its folded W0 and global adapter
    (:func:`xlstm_serve`), then a 2-lane mesh round on them
    (:func:`family_mesh_run`, its lanes held within 3 × the model's own
    f32 spread); that state freed, the bf16 serve from fresh draws
    (:func:`xlstm_bf16`). Returns (max errors of the f32 cases, of
    the bf16 cases, timings, launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(XL), num_layers=XL_DEPTH["float32"],
                  dtype="float32")
    r, scale = 4, 2.0
    lcfg = LoRAConfig(rank=r, alpha=8.0)
    errs, bf16_errs, timings = xlstm_kernel_phase(torch, kernels, device,
                                                  cfg, r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(torch, kernels, device, cfg,
                                             scale, tag="xl", lcfg=lcfg)
    for k, v in got.items():
        launches[k] += v
    served, got = xlstm_serve(torch, kernels, device, cfg, trainer.params,
                              trainer.global_lora, lcfg)[:2]
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    stats["mesh"], got = family_mesh_run(torch, kernels, device, cfg,
                                         trainer, lcfg, "xl", spread=True)
    for k, v in got.items():
        launches[k] += v
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = xlstm_bf16(torch, kernels, device, scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [xl] phase 13 in {stats['seconds']:.1f} s; peak memory: "
          f"kernels {stats['kernels_peak_gib']:.2f} GiB, f32 training "
          f"{stats['train']['train_peak_gib']:.2f} GiB, f32 serve "
          f"{stats['f32']['peak_gib']:.2f} GiB, mesh round "
          f"{stats['mesh']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats


WH = "whisper-medium"
# Full depth, no cut: 24 encoder + 24 decoder layers, d 1024, 16 heads of
# 64, MLP 4096, 1500 frames, the learned position table 32,768 × 1024, a
# tied vocabulary of 51,865: ≈ 7.94·10⁸ parameters, 3.17 GB in f32 and
# 1.59 GB in bf16. Training in f32 keeps the encoder's activations over
# 8 × 1500 frames for backward (≈ 1 GB a layer, no recomputation).
WH_TRAIN = {"clients": 4, "local_steps": 2, "batch": 8, "seq": 64,
            "data_vocab": 512}
WH_SERVE = {"batch": 8, "prompt": 64, "steps": 16, "max_len": 128}
# the cross-attention's query rows at which B8 is held with Sk = 1500 keys:
# the decoder's prompt, a tail of the 64-row tile, one row
WH_CROSS_ROWS = (64, 333, 1)


def whisper_leaves(cfg):
    """(name, L, m, n) of the 12 adapted q/k/v/o leaves (each 1024 ×
    1024)."""
    return [(f"{stack}/{name}", n_l, k, n)
            for stack, n_l in (("encoder/attn", cfg.enc_layers),
                               ("decoder/self_attn", cfg.num_layers),
                               ("decoder/cross_attn", cfg.num_layers))
            for name, k, n in serving_projections(cfg)]


def whisper_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At whisper-medium's shapes: B1 at one stacked q_proj leaf (24 × 1024
    × 1024), 2 live lanes of 4 weighted, against its plain version and
    beside ``baddbmm``; B2 over a weighted close's 24 stacks (the 12
    adapted leaves' a and b), bitwise; B3 in f32 and bf16 at an encoder
    layer's q/k/v/o over the frames (M 8·1500 = 12,000; the cross k/v's
    shape too), a decoder layer's at the prompt (M 512) and at a decode
    step (M 8), every bf16 call through a tensor-core body; B8 in f32 and
    bf16 at the encoder (non-causal, S 1500: a masked tail tile), the
    decoder's self-attention (causal, S 64) and its cross-attention
    (non-causal, Sq 64, 333 and 1 against Sk 1500), every bf16 call
    through the tensor-core body; then the exact-rounding probes at these
    projections and attentions, bitwise. Returns (max errors of the f32
    cases, of the bf16 cases, timings)."""
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    timer = Timer(torch, device)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0,
            "flash_swa": 0.0}
    bf16_errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    d, frames = cfg.d_model, cfg.enc_seq_len
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "wh", cfg.num_layers, d, d, c, live,
        r, scale, seed=510, leaf="q_proj")
    timings["factor_mean"] = group_mean_case(
        torch, kernels, timer, device, "wh", whisper_leaves(cfg), c, live, r,
        w, seed=520)
    low = torch.bfloat16
    bsz, prompt = WH_SERVE["batch"], WH_SERVE["prompt"]
    proj = serving_projections(cfg)
    for key, m in (("wh", bsz * frames), ("wh_dec", bsz * prompt),
                   ("wh_decode", bsz)):
        for dtype in (torch.float32, low):
            name = key if dtype == torch.float32 else (
                "wh_bf16_decode" if key == "wh_decode" else key + "_bf16")
            bufs = [[t.to(dtype) for t in lora_inputs(
                torch, device, m, k, n, r, seed=540 + i)]
                for i, (_, k, n) in enumerate(proj)]
            if dtype == low:
                tc_calls(torch, kernels, bufs, scale, f"{name} M={m}",
                         len(proj), decode=m <= SKINNY_ROWS)
            err, timings[name] = lora_case(
                torch, kernels, timer, bufs, scale,
                f"{cfg.name} {name}: q/k/v/o at M={m}", device_times=True)
            sink = bf16_errs if dtype == low else errs
            sink["lora_matmul"] = max(sink["lora_matmul"], err)
            del bufs
            torch.cuda.empty_cache()
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    cases = [("flash_wh_enc", frames, False, 0), ("flash_wh_self", prompt,
                                                  True, 0)]
    cases += [(f"flash_wh_cross{'' if sq == prompt else sq}", sq, False,
               frames) for sq in WH_CROSS_ROWS]
    for i, (key, s, causal, sk) in enumerate(cases):
        for dtype in (None, low):
            err, timings[key + ("_bf16" if dtype else "")] = flash_case(
                torch, kernels, timer, device, bsz, s, h, cfg.num_kv_heads,
                hd, causal, 0, seed=560 + i, device_times=True, dtype=dtype,
                tc=dtype is not None, sk=sk)
            sink = bf16_errs if dtype else errs
            sink["flash_swa"] = max(sink["flash_swa"], err)
            torch.cuda.empty_cache()
    lora_probes(torch, kernels, device,
                [(WH, m, d, d, r) for m in (bsz, bsz * prompt,
                                            bsz * frames)])
    flash_probes(torch, kernels, device,
                 [("whisper encoder", 2, frames, h, h, hd, False),
                  ("whisper self", 2, prompt, h, h, hd, True)]
                 + [(f"whisper cross Sq {sq}", 2, sq, h, h, hd, False,
                     frames) for sq in WH_CROSS_ROWS])
    return errs, bf16_errs, timings


def whisper_data(torch, device, cfg, seed=0):
    """``data`` for :func:`moe_train`: each client loader's batches, and
    each eval batch, with stub frames added — (B, enc_seq_len, d_model)
    f32, N(0, 0.02²), drawn on the card from one generator seeded with
    ``seed`` (the port's launcher refuses whisper for want of them)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def frames(n):
        return torch.randn(n, cfg.enc_seq_len, cfg.d_model, device=device,
                           generator=g) * 0.02

    class FramesLoader:
        def __init__(self, inner):
            self.inner, self.sequences = inner, inner.sequences

        def next_batch(self):
            batch = dict(self.inner.next_batch())
            batch["frames"] = frames(batch["tokens"].shape[0])
            return batch

    def data(loaders, evals):
        return ([FramesLoader(ld) for ld in loaders],
                [dict(b, frames=frames(b["tokens"].shape[0]))
                 for b in evals])

    return data


def whisper_cache_bytes(cache) -> dict:
    """The self cache's bytes a token of a sequence (K and V over the
    layers) and the cross cache's bytes a sequence."""
    k = cache["self"]["k"]
    per_token = 2 * k.shape[0] * k[0, 0, 0].numel() * k.element_size()
    ck = cache["cross"]["k"]
    per_seq = 2 * ck[:, 0].numel() * ck.element_size()
    return {"self_bytes_per_token": per_token,
            "cross_bytes_per_seq": per_seq}


def cross_read_ms(torch, timer, cache, cfg, bsz):
    """Host-inclusive ms of one decode step's cross-attention reads alone:
    ``decode_attention`` over every layer's cross cache (which widens the
    whole cache to f32 each call, as the reference's casts do)."""
    from repro_torch.models.attention import CROSS_POSITION, decode_attention
    from repro_torch.models.transformer import _layer_slice

    q = torch.randn(bsz, 1, cfg.num_heads, cfg.resolved_head_dim,
                    device=cache["cross"]["k"].device).to(
                        cache["cross"]["k"].dtype)
    layers = [_layer_slice(cache["cross"], i) for i in range(cfg.num_layers)]
    return timer(lambda: [decode_attention(q, c, CROSS_POSITION)
                          for c in layers])


def whisper_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``WH_SERVE``'s shape (batch 8, a prompt of 64 tokens over 1500 frames,
    16 decode steps, caches of 128 self slots and 1500 cross ones in the
    model's dtype). With the counters set to 0 just before each: one
    prefill (``lora_matmul`` 288: 4 an encoder layer, 8 a decoder layer;
    ``flash_swa`` 72: the encoder's, the self- and the cross-attention's;
    bf16: all of them through the tensor-core bodies) and one decode step
    (``lora_matmul`` 144: self q/k/v/o and cross q, o a layer; bf16: the
    tensor-core split-K body); the kernel path's prefill logits against
    the plain path's (``MOE_P_TOL`` of the logit scale); in f32, teacher
    forcing: all 16 decode steps fed the next prompt token, each step's
    logits against the training forward over prompt + 16 tokens at that
    position (``D_TOL``); the caches' bytes (:func:`whisper_cache_bytes`)
    and one step's cross reads alone (:func:`cross_read_ms`). Then the
    main path, ``serve()`` (f32: ``dtype`` float32 and an f32 cache;
    bf16: the config's), the counters set to 0 just before and read just
    after. Returns (stats, main-path launches, bf16 launches, tensor-core
    launches, and for :func:`whisper_bf16` what it compares)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    bsz, prompt, steps, max_len = (WH_SERVE[k] for k in (
        "batch", "prompt", "steps", "max_len"))
    dt = cfg.dtype
    n_enc, n_dec = cfg.enc_layers, cfg.num_layers
    n_pre, n_step, n_flash = 4 * n_enc + 8 * n_dec, 6 * n_dec, n_enc + 2 * n_dec
    low = dt == "bfloat16"
    mdt = torch.bfloat16 if low else torch.float32
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    long = make_batch_for(cfg, bsz, prompt + steps, seed=0, device=device)
    full = torch.cat([long["tokens"], long["targets"][:, -1:]], dim=1)
    batch = {"tokens": full[:, :prompt], "frames": long["frames"]}
    timer = Timer(torch, device)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", n_pre, n_flash,
                    dt, tc={"lora_matmul": n_pre, "lora_matmul_decode": 0,
                            "flash_swa": n_flash})
        rows = []
        for i in range(steps):
            kernels.reset_launch_counts()
            _, dec, cache = decode(params, lora,
                                   full[:, prompt + i:prompt + i + 1], cache,
                                   prompt + i)
            rows.append(dec[:, -1].clone())
            if i == 0:
                torch.cuda.synchronize()
                _moe_expect(kernels, f"{cfg.name} {dt} one decode step",
                            n_step, 0, dt,
                            tc={"lora_matmul": 0,
                                "lora_matmul_decode": n_step,
                                "flash_swa": 0})
        torch.cuda.synchronize()
        sizes = whisper_cache_bytes(cache)
        sizes["cross_read_ms"] = cross_read_ms(torch, timer, cache, cfg, bsz)
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        err_kp = float((pre - pre_plain).abs().max())
        lscale = float(pre_plain.abs().max())
        if not low:
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale).all())
            print(f"  [wh] f32 prefill logits, kernel path vs plain path: "
                  f"max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}, atol "
                  f"{MOE_P_TOL[1]} x logit scale {lscale:.3f}): within={ok}",
                  flush=True)
            if not ok:
                raise AssertionError("wh f32 serve: the kernel path "
                                     "disagrees with the plain path")
        train = model.apply(params, {"tokens": full[:, :prompt + steps],
                                     "frames": long["frames"]}, lora=lora,
                            lora_scale=lcfg.scale)[:, prompt - 1:]
        torch.cuda.synchronize()
        got = torch.stack([pre[:, -1]] + rows, dim=1)
        want = train
        scale_tf = float(want.abs().max())
        err_tf = float((got - want).abs().max())
        if low:
            print(f"  [wh] {cfg.name} bf16 teacher-forced prefill + "
                  f"{steps} decode steps vs the bf16 training forward: "
                  f"max |diff| {err_tf:.4e} = {err_tf / scale_tf:.3f} of the "
                  f"logit scale {scale_tf:.3f}", flush=True)
        else:
            ok, _ = _allclose(got, want, *D_TOL)
            same = got.argmax(-1) == want.argmax(-1)
            print(f"  [wh] {cfg.name} f32 teacher forcing, the prefill's "
                  f"last logits and {steps} decode steps (f32 caches) vs "
                  f"the training forward over {prompt + steps} tokens: "
                  f"max |diff| {err_tf:.4e} (rtol {D_TOL[0]}, atol "
                  f"{D_TOL[1]}; logit scale {scale_tf:.3f}): within={ok}; "
                  f"argmax agrees at {int(same.sum())} of {same.numel()}",
                  flush=True)
            if not ok:
                raise AssertionError("wh f32 serve: prefill + decode "
                                     "disagree with the training forward")
        cmp = {"pre": pre[:, -1], "pre_plain": pre_plain[:, -1],
               "decode": rows[0], "train": train[:, 1], "full": full,
               "frames": long["frames"]}
        del rows, pre, pre_plain, train, got, want
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                **({} if low else {"dtype": torch.float32,
                                   "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", n_pre + n_step * steps, n_flash, dt,
                tc={"lora_matmul": n_pre,
                    "lora_matmul_decode": n_step * steps,
                    "flash_swa": n_flash})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"wh serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms, "first_prefill_ms": pre_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             **sizes, "seconds": time.perf_counter() - t0}
    print(f"  [wh] {cfg.name} {dt} batch {bsz}, prompt {prompt} over "
          f"{cfg.enc_seq_len} frames, {steps} decode steps: prefill "
          f"{res.prefill_ms:.1f} ms (the first, counted, {pre_ms:.1f} ms), "
          f"decode {res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch), "
          f"of which the cross reads alone {sizes['cross_read_ms']:.2f} ms; "
          f"peak {stats['peak_gib']:.2f} GiB; self cache "
          f"{sizes['self_bytes_per_token']:,} B a token, cross cache "
          f"{sizes['cross_bytes_per_seq'] / 1e6:.1f} MB a sequence; "
          f"{stats['seconds']:.1f} s; first row {toks[0, :8].tolist()}",
          flush=True)
    return stats, launches, bf16, tc, cmp


def whisper_bf16(torch, kernels, device, scale):
    """The bf16 serve from fresh draws (the port's own bf16 params, a
    rank-4 f32 adapter with b drawn N(0, 0.05²)) through
    :func:`whisper_serve`, with bf16 caches; then its f32 answer (the
    params widened to f32, the training forward over the same frames and
    prompt + 1 tokens). Held as phase 9 holds its bf16 serve: the kernel
    path's prefill logits no further from the f32 answer than twice the
    bf16 plain path's plus one bf16 rounding at the logit scale, and from
    the plain path's no further than three times that distance plus the
    floor; the first decode step no further from its f32 answer than twice
    the bf16 training forward's plus the floor, the argmax agreeing on
    every row whose f32 top-2 margin exceeds twice that bound. Returns
    (stats, launches, bf16 launches, tensor-core launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WH)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{WH}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    stats, launches, bf16, tc, cmp = whisper_serve(torch, kernels, device,
                                                   cfg, params, lora, lcfg)
    f32 = replace(cfg, dtype="float32")
    prompt = WH_SERVE["prompt"]
    with torch.inference_mode():
        wide = _unflat({k: v.float() for k, v in _flat(params).items()})
        out = build_model(f32).apply(
            wide, {"tokens": cmp["full"][:, :prompt + 1],
                   "frames": cmp["frames"]}, lora=lora,
            lora_scale=lcfg.scale)[:, -2:]
        del wide
    torch.cuda.synchronize()
    pre32, next32 = out[:, 0], out[:, 1]
    bsz = cmp["full"].shape[0]
    pre, pre_plain = cmp["pre"], cmp["pre_plain"]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [wh] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("wh bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [wh] bf16 teacher forcing: the first decode step vs the f32 "
          f"answer {err_d:.4e}, the bf16 training forward vs it {err_t:.4e} "
          f"(bound 2 x that + {floor:.4e} = {bound:.4e}); argmax agrees "
          f"with f32 on {int(same.sum())} of {bsz} rows, on the "
          f"{int(sure.sum())} rows past 2 x bound: {agree}: ok={ok}",
          flush=True)
    if not ok:
        raise AssertionError("wh bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp, out
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def whisper_phase(torch, kernels, device):
    """Phase 14: whisper-medium at full width and depth (24 encoder + 24
    decoder layers). The kernels at its shapes
    (:func:`whisper_kernel_phase`); training in f32 (:func:`moe_train`
    with ``WH_TRAIN``, loaders that add frames (:func:`whisper_data`),
    adapters on the 12 q/k/v/o leaves: fedex, a uniform round, then a
    weighted one at 50% with example weights, ``factor_mean`` 1 and
    ``fedex_fold`` 12, the exact-residual identity on every matrix of the
    12 leaves) and the f32 serve of its folded W0 and global adapter
    (:func:`whisper_serve`), then a 2-lane mesh round on them over loaders
    that add frames (:func:`family_mesh_run`); that state freed, the bf16
    serve from fresh draws (:func:`whisper_bf16`). Returns (max errors of the f32 cases, of
    the bf16 cases, timings, launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(WH), dtype="float32")
    r, scale = 4, 2.0
    lcfg = LoRAConfig(rank=r, alpha=8.0)
    errs, bf16_errs, timings = whisper_kernel_phase(torch, kernels, device,
                                                    cfg, r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(
        torch, kernels, device, cfg, scale, tag="wh", lcfg=lcfg,
        run=WH_TRAIN, data=whisper_data(torch, device, cfg),
        full_identity=True)
    for k, v in got.items():
        launches[k] += v
    served, got = whisper_serve(torch, kernels, device, cfg, trainer.params,
                                trainer.global_lora, lcfg)[:2]
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    stats["mesh"], got = family_mesh_run(
        torch, kernels, device, cfg, trainer, lcfg, "wh",
        data=whisper_data(torch, device, cfg, seed=1))
    for k, v in got.items():
        launches[k] += v
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = whisper_bf16(torch, kernels, device,
                                                scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [wh] phase 14 in {stats['seconds']:.1f} s; peak memory: "
          f"kernels {stats['kernels_peak_gib']:.2f} GiB, f32 training "
          f"{stats['train']['train_peak_gib']:.2f} GiB, f32 serve "
          f"{stats['f32']['peak_gib']:.2f} GiB, mesh round "
          f"{stats['mesh']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats


# --------------------------------------------------------------------------
# phase 15: the vlm family (internvl2-76b)
# --------------------------------------------------------------------------

VL = "internvl2-76b"
# Depth cuts, stated as cuts: full depth is 80 layers of 8.56·10⁸
# parameters (3.42 GB in f32, 1.71 GB in bf16), beside 2.10·10⁹ in the
# embedding and the untied head and 6.7·10⁷ in vision_proj (8.66 GB in
# f32): 70.6·10⁹ parameters, 282 GB in f32 and 141 GB in bf16, which one
# 80 GB card cannot hold in either. At 12 layers in f32 and 24 in bf16
# the phase peaks at 64.4 GiB (the client step on a batch with vision
# embeddings: its 8 × 320 × 128,256 logits, their gradient and 12 layers'
# activations) and 49.8 GiB (the bf16 serve) on an H100 80GB HBM3; 8 and
# 16 peaked at 46.4 and 37.1 GiB.
VL_DEPTH = {"float32": 12, "bfloat16": 24}
VL_TRAIN = {"clients": 4, "local_steps": 2, "batch": 8, "seq": 64,
            "data_vocab": 512}
# a prompt of 512: the 256 vision tokens and 256 text tokens; the prefill
# fills 512 positions and decode runs from there
VL_SERVE = {"batch": 8, "prompt": 512, "steps": 16}


def vlm_kernel_phase(torch, kernels, device, cfg, *, r, scale):
    """At internvl2-76b's shapes: B1 at the stacked q_proj leaf of the f32
    depth (L × 8192 × 8192), 2 live lanes of 4 weighted, against its plain
    version in 8-matrix chunks and beside ``baddbmm``; B2 over a weighted
    close's 8 stacks (q/k/v/o's a and b), bitwise; B3 in f32 and bf16 at
    a layer's q/k/v/o (K 8192, N 8192 and 1024) at the prefill rows (M 8 ×
    512 = 4096: the vision prefix and the text) and the decode rows (M 8),
    every bf16 call through a tensor-core body; B8 in f32 and bf16 at the
    prefill (B 8, S 512, GQA 64/8, d 128, causal), every bf16 call through
    the tensor-core body; then the exact-rounding probes at these
    projections and the attention, bitwise. Returns (max errors of the f32
    cases, of the bf16 cases, timings)."""
    from repro_torch.kernels.lora_matmul import SKINNY_ROWS
    timer = Timer(torch, device)
    errs = {"fedex_fold": 0.0, "factor_mean": 0.0, "lora_matmul": 0.0,
            "flash_swa": 0.0}
    bf16_errs = {"lora_matmul": 0.0, "flash_swa": 0.0}
    timings = {}
    c, live = 4, (0, 1)
    d = cfg.d_model
    errs["fedex_fold"], timings["fedex_fold"], w = expert_fold_case(
        torch, kernels, timer, device, "vl", cfg.num_layers, d, d, c, live,
        r, scale, seed=610, leaf="q_proj")
    timings["factor_mean"] = group_mean_case(
        torch, kernels, timer, device, "vl", main_path_leaves(cfg), c, live,
        r, w, seed=620)
    low = torch.bfloat16
    bsz, prompt = VL_SERVE["batch"], VL_SERVE["prompt"]
    proj = serving_projections(cfg)
    for suffix, dtype, m in (("", torch.float32, bsz * prompt),
                             ("_decode", torch.float32, bsz),
                             ("_bf16", low, bsz * prompt),
                             ("_bf16_decode", low, bsz)):
        key = "vl" + suffix
        bufs = [[t.to(dtype) for t in lora_inputs(
            torch, device, m, k, n, r, seed=640 + i)]
            for i, (_, k, n) in enumerate(proj)]
        if dtype == low:
            tc_calls(torch, kernels, bufs, scale, f"{key} M={m}", len(proj),
                     decode=m <= SKINNY_ROWS)
        err, timings[key] = lora_case(
            torch, kernels, timer, bufs, scale,
            f"{cfg.name} {key}: q/k/v/o at M={m}", device_times=True)
        sink = bf16_errs if dtype == low else errs
        sink["lora_matmul"] = max(sink["lora_matmul"], err)
        del bufs
        torch.cuda.empty_cache()
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for dtype in (None, low):
        key = "flash_vl" + ("_bf16" if dtype else "")
        err, timings[key] = flash_case(
            torch, kernels, timer, device, bsz, prompt, h, kvh, hd, True, 0,
            seed=660, device_times=True, dtype=dtype, tc=dtype is not None)
        sink = bf16_errs if dtype else errs
        sink["flash_swa"] = max(sink["flash_swa"], err)
        torch.cuda.empty_cache()
    lora_probes(torch, kernels, device,
                [(VL, m, k, n, r) for _, k, n in proj[:2]
                 for m in (bsz, bsz * prompt)])
    flash_probes(torch, kernels, device,
                 [("internvl2 prefill", 2, prompt, h, kvh, hd, True)])
    return errs, bf16_errs, timings


def vlm_vision_step(torch, device, cfg, trainer, lcfg):
    """One client step (``make_local_step``: autograd, clipping, AdamW)
    from the trained W0 and global adapter on a batch that carries
    ``vision_embeds`` (``make_batch_for``: 256 vision tokens, 64 text
    tokens): its loss is the CE of the text positions' logits alone (the
    training forward's ``logits[:, 256:]``, within 1e-6 relative), and its
    gradient norm and updated adapter are finite. Returns its stats."""
    from repro_torch.core.federated import make_local_step
    from repro_torch.data import make_batch_for
    from repro_torch.models.common import cross_entropy
    from repro_torch.optim import init_adamw

    vt = cfg.vision_tokens
    batch = make_batch_for(cfg, VL_TRAIN["batch"], vt + VL_TRAIN["seq"],
                           seed=7, device=device)
    step = make_local_step(trainer.model, lcfg.scale,
                           trainer.train_cfg)
    lora = _unflat({k: v.clone() for k, v in
                    _flat(trainer.global_lora).items()})
    torch.cuda.synchronize()
    t = time.perf_counter()
    new, _, loss, gnorm = step(trainer.params, lora, init_adamw(lora), batch,
                               5e-3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    with torch.inference_mode():
        logits = trainer.model.apply(trainer.params, batch, lora=lora,
                                     lora_scale=lcfg.scale)
        text = float(cross_entropy(logits[:, vt:], batch["targets"],
                                   batch["loss_mask"])[0])
        shape = tuple(logits.shape)
        del logits
    loss, gnorm = float(loss), float(gnorm)
    finite = all(bool(torch.isfinite(v).all()) for v in _flat(new).values())
    ok = (shape == (VL_TRAIN["batch"], vt + VL_TRAIN["seq"], cfg.vocab_size)
          and abs(loss - text) <= 1e-6 * abs(text) and math.isfinite(gnorm)
          and finite)
    print(f"  [vl] one client step on a batch with vision_embeds ({vt} "
          f"vision + {VL_TRAIN['seq']} text tokens, batch "
          f"{VL_TRAIN['batch']}): loss {loss:.6f}, the text positions' CE "
          f"alone {text:.6f} (logits {shape}), grad norm {gnorm:.4e}, "
          f"adapter finite {finite}; {step_ms:.1f} ms: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("vl vision step: the loss is not the text-only "
                             "CE, or the step is not finite")
    del new, lora, batch
    return {"loss": loss, "text_ce": text, "grad_norm": gnorm,
            "step_ms": step_ms}


def vlm_serve(torch, kernels, device, cfg, params, lora, lcfg):
    """Serve ``cfg`` (f32 or bf16, its dtype) from ``params`` / ``lora`` at
    ``VL_SERVE``'s shape (batch 8, a prompt of 256 vision + 256 text
    tokens, 16 decode steps, a cache of 528 positions in the model's
    dtype). With the counters set to 0 just before each: one prefill
    (``lora_matmul`` 4·L at M 8 × 512, ``flash_swa`` L at S 512; bf16: all
    through the tensor-core bodies) and one decode step (``lora_matmul``
    4·L; bf16: the tensor-core split-K body); the kernel path's prefill
    logits against the plain path's (``MOE_P_TOL`` of the logit scale;
    bf16: held by :func:`vlm_bf16`); teacher forcing from the prefill's
    true length, 512: all 16 steps fed the next text token at positions
    512–527, the prefill's last logits and each step's against the
    training forward over the vision prefix and 256 + 16 text tokens (f32:
    ``D_TOL``); in f32 also the first step at the reference's launcher's
    position, 512 + 256 (a cache of 1024), its parting from the training
    forward printed, not held. Then the main path, ``serve()`` (f32:
    ``dtype`` float32 and an f32 cache; bf16: the config's), the counters
    set to 0 just before and read just after; bf16 also
    :func:`profile_serving`. Returns (stats, main-path launches, bf16
    launches, tensor-core launches, and for :func:`vlm_bf16` what it
    compares)."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import prefill_length, serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    bsz, prompt, steps = (VL_SERVE[k] for k in ("batch", "prompt", "steps"))
    vt, L, dt = cfg.vision_tokens, cfg.num_layers, cfg.dtype
    text = prompt - vt
    max_len = prefill_length(cfg, prompt) + steps
    if prefill_length(cfg, prompt) != prompt or text < 1:
        raise AssertionError(f"vl serve: a prompt of {prompt} must fill "
                             f"{prompt} positions")
    low = dt == "bfloat16"
    mdt = torch.bfloat16 if low else torch.float32
    model = build_model(cfg)
    prefill, decode = make_prefill_step(model, lcfg), make_decode_step(model,
                                                                       lcfg)
    long = make_batch_for(cfg, bsz, prompt + steps, seed=0, device=device)
    full = torch.cat([long["tokens"], long["targets"][:, -1:]], dim=1)
    vision = long["vision_embeds"]
    batch = {"tokens": full[:, :text], "vision_embeds": vision}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        cache = model.init_cache(bsz, max_len, mdt, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pre, cache = prefill(params, lora, batch, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        _moe_expect(kernels, f"{cfg.name} {dt} one prefill", 4 * L, L, dt,
                    tc={"lora_matmul": 4 * L, "lora_matmul_decode": 0,
                        "flash_swa": L})
        rows = []
        for i in range(steps):
            kernels.reset_launch_counts()
            _, dec, cache = decode(params, lora,
                                   full[:, text + i:text + i + 1], cache,
                                   prompt + i)
            rows.append(dec[:, -1].clone())
            if i == 0:
                torch.cuda.synchronize()
                _moe_expect(kernels, f"{cfg.name} {dt} one decode step",
                            4 * L, 0, dt,
                            tc={"lora_matmul": 0, "lora_matmul_decode": 4 * L,
                                "flash_swa": 0})
        torch.cuda.synchronize()
        del cache
        kernels.reset_launch_counts()
        with plain_ops(kernels):
            cache = model.init_cache(bsz, max_len, mdt, device=device)
            pre_plain, cache = prefill(params, lora, batch, cache)
            del cache
        torch.cuda.synchronize()
        _expect(kernels, f"{cfg.name} {dt} plain path", {})
        err_kp = float((pre - pre_plain).abs().max())
        lscale = float(pre_plain.abs().max())
        if not low:
            ok = bool(((pre - pre_plain).abs() <= MOE_P_TOL[0]
                       * pre_plain.abs() + MOE_P_TOL[1] * lscale).all())
            print(f"  [vl] f32 prefill logits, kernel path vs plain path: "
                  f"max |diff| {err_kp:.3e} (rtol {MOE_P_TOL[0]}, atol "
                  f"{MOE_P_TOL[1]} x logit scale {lscale:.3f}): within={ok}",
                  flush=True)
            if not ok:
                raise AssertionError("vl f32 serve: the kernel path "
                                     "disagrees with the plain path")
        train = model.apply(params, {"tokens": full[:, :text + steps],
                                     "vision_embeds": vision}, lora=lora,
                            lora_scale=lcfg.scale)[:, prompt - 1:]
        torch.cuda.synchronize()
        got = torch.stack([pre[:, -1]] + rows, dim=1)
        scale_tf = float(train.abs().max())
        err_tf = float((got - train).abs().max())
        parting = None
        if low:
            print(f"  [vl] {cfg.name} bf16 teacher-forced prefill + {steps} "
                  f"decode steps from position {prompt} vs the bf16 training "
                  f"forward: max |diff| {err_tf:.4e} = "
                  f"{err_tf / scale_tf:.3f} of the logit scale "
                  f"{scale_tf:.3f}", flush=True)
        else:
            ok, _ = _allclose(got, train, *D_TOL)
            same = got.argmax(-1) == train.argmax(-1)
            print(f"  [vl] {cfg.name} f32 teacher forcing from the prefill's "
                  f"true length {prompt} ({vt} vision + {text} text "
                  f"positions): the prefill's last logits and {steps} decode "
                  f"steps (f32 cache) vs the training forward over {vt} + "
                  f"{text + steps} positions: max |diff| {err_tf:.4e} (rtol "
                  f"{D_TOL[0]}, atol {D_TOL[1]}; logit scale "
                  f"{scale_tf:.3f}): within={ok}; argmax agrees at "
                  f"{int(same.sum())} of {same.numel()}", flush=True)
            if not ok:
                raise AssertionError("vl f32 serve: prefill + decode "
                                     "disagree with the training forward")
            # the reference's launcher decodes from prompt_len +
            # vision_tokens: printed, not held
            cache = model.init_cache(bsz, 2 * prompt, mdt, device=device)
            _, cache = prefill(params, lora, batch, cache)
            _, ref_dec, cache = decode(params, lora, full[:, text:text + 1],
                                       cache, prompt + vt)
            del cache
            parting = float((ref_dec[:, -1] - train[:, 1]).abs().max())
            true = float((got[:, 1] - train[:, 1]).abs().max())
            print(f"  [vl] the first decode step at the reference's serve "
                  f"position {prompt + vt} (prompt_len + vision_tokens) vs "
                  f"the training forward at {prompt}: max |diff| "
                  f"{parting:.4e} = {parting / scale_tf:.3f} of the logit "
                  f"scale, against {true:.4e} at the true length (not "
                  "held)", flush=True)
            del ref_dec
        cmp = {"pre": pre[:, -1], "pre_plain": pre_plain[:, -1],
               "decode": rows[0], "train": train[:, 1], "full": full,
               "vision": vision}
        del rows, pre, pre_plain, train, got
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    res = serve(cfg, batch_size=bsz, prompt_len=prompt, steps=steps,
                max_len=max_len, device=device, params=params, lora=lora,
                **({} if low else {"dtype": torch.float32,
                                   "cache_dtype": torch.float32}))
    launches = kernels.launch_counts()
    bf16 = kernels.bf16_launch_counts()
    tc = tc_launch_counts(kernels)
    _moe_expect(kernels, f"{cfg.name} {dt} serve() (1 prefill + {steps} "
                "decode steps)", 4 * L * (1 + steps), L, dt,
                tc={"lora_matmul": 4 * L,
                    "lora_matmul_decode": 4 * L * steps, "flash_swa": L})
    toks = res.tokens
    if toks.shape != (bsz, steps + 1) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"vl serve: bad tokens {toks.shape}")
    stats = {"prefill_ms": res.prefill_ms, "first_prefill_ms": pre_ms,
             "decode_ms_per_token": res.ms_per_token,
             "decode_tokens_per_s": bsz * steps / (res.decode_ms / 1e3),
             "prefill_tokens_per_s": bsz * prompt / (res.prefill_ms / 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "err_teacher_forced": err_tf, "err_kernel_vs_plain": err_kp,
             "parting_at_reference_position": parting,
             "seconds": time.perf_counter() - t0}
    if low:
        stats.update(profile_serving(
            torch, model, params, lora, prefill, decode,
            {"tokens": full[:, :text], "vision_embeds": vision}, bsz, prompt,
            max_len, res))
    print(f"  [vl] {cfg.name} {dt} at depth {L}, batch {bsz}, prompt {prompt}"
          f" ({vt} vision + {text} text), {steps} decode steps: prefill "
          f"{res.prefill_ms:.1f} ms (the first, counted, {pre_ms:.1f} ms; "
          f"{stats['prefill_tokens_per_s']:.0f} positions/s), decode "
          f"{res.ms_per_token:.2f} ms/token "
          f"({stats['decode_tokens_per_s']:.1f} tokens/s over the batch); "
          f"peak {stats['peak_gib']:.2f} GiB; {stats['seconds']:.1f} s; "
          f"first row {toks[0, :8].tolist()}", flush=True)
    return stats, launches, bf16, tc, cmp


def vlm_f32_answer(torch, cfg, params, lora, lcfg, tokens, vision):
    """The f32 training forward over ``vision`` and ``tokens`` with
    ``params`` (bf16) widened one layer at a time (the whole tree in f32
    would not fit beside it): the logits at the last two positions (the
    prompt's last, for the prefill; the next token's, for the decode
    step)."""
    from dataclasses import replace

    from repro_torch.models import transformer
    from repro_torch.models.common import apply_norm, dense, embed, unembed

    f32 = replace(cfg, dtype="float32")

    def wide(tree):
        return _unflat({k: v.float() for k, v in _flat(tree).items()})

    with torch.inference_mode():
        x = embed(wide(params["embed"]), tokens)
        x = torch.cat([dense(vision.float(), wide(params["vision_proj"])), x],
                      dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.num_layers):
            p = wide(transformer._layer_slice(params["layers"], i))
            x, _ = transformer.decoder_layer(
                f32, p, x, lora=transformer._layer_slice(lora["layers"], i),
                lora_scale=lcfg.scale, positions=positions, window=0,
                cache=None, position=None)
            del p
        x = apply_norm(cfg.norm, wide(params["final_norm"]), x[:, -2:])
        return unembed(wide(params["lm_head"]), x)


def vlm_bf16(torch, kernels, device, scale):
    """The bf16 serve at the bf16 depth cut from fresh draws (the port's own
    bf16 params, a rank-4 f32 adapter with b drawn N(0, 0.05²)) through
    :func:`vlm_serve`, with a bf16 cache; then its f32 answer over the same
    weights, vision tokens and prompt + 1 text tokens
    (:func:`vlm_f32_answer`). Held as phase 9 holds its bf16 serve: the
    kernel path's prefill logits no further from the f32 answer than twice
    the bf16 plain path's plus one bf16 rounding at the logit scale, and
    from the plain path's no further than three times that distance plus
    the floor; the first decode step no further from its f32 answer than
    twice the bf16 training forward's plus the floor, the argmax agreeing
    on every row whose f32 top-2 margin exceeds twice that bound. Returns
    (stats, launches, bf16 launches, tensor-core launches)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(VL), num_layers=VL_DEPTH["bfloat16"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{VL}: config dtype {cfg.dtype}")
    lcfg = LoRAConfig(rank=4, alpha=4 * scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.inference_mode():
        params = build_model(cfg).init(gen, device)
        lora = init_lora(gen, params, cfg, lcfg)
        for k, leaf in _flat(lora).items():
            if k.endswith("/b"):
                leaf.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    print(f"  [vl] {cfg.name} bf16 at depth {cfg.num_layers} (a cut of 80): "
          f"params and adapter on the card in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    stats, launches, bf16, tc, cmp = vlm_serve(torch, kernels, device, cfg,
                                               params, lora, lcfg)
    text = VL_SERVE["prompt"] - cfg.vision_tokens
    out = vlm_f32_answer(torch, cfg, params, lora, lcfg,
                         cmp["full"][:, :text + 1], cmp["vision"])
    torch.cuda.synchronize()
    pre32, next32 = out[:, 0], out[:, 1]
    bsz = cmp["full"].shape[0]
    pre, pre_plain = cmp["pre"], cmp["pre_plain"]
    floor = 2.0 ** -8 * float(pre32.abs().max())
    err_k = float((pre - pre32).abs().max())
    err_p = float((pre_plain - pre32).abs().max())
    err_kp = float((pre - pre_plain).abs().max())
    ok = err_k <= 2 * err_p + floor and err_kp <= 3 * err_p + floor
    print(f"  [vl] bf16 prefill last-position logits: kernel path vs f32 "
          f"{err_k:.4e}, bf16 plain path vs f32 {err_p:.4e} (bound 2 x that "
          f"+ {floor:.4e} = {2 * err_p + floor:.4e}), kernel vs plain path "
          f"{err_kp:.4e} (bound {3 * err_p + floor:.4e}); logit scale "
          f"{float(pre32.abs().max()):.3f}: ok={ok}", flush=True)
    if not ok:
        raise AssertionError("vl bf16 serve: the kernel path's logits are "
                             "further from the f32 answer than allowed")
    floor = 2.0 ** -8 * float(next32.abs().max())
    err_d = float((cmp["decode"] - next32).abs().max())
    err_t = float((cmp["train"] - next32).abs().max())
    bound = 2 * err_t + floor
    top2 = torch.topk(next32, 2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > 2 * bound
    same = cmp["decode"].argmax(-1) == next32.argmax(-1)
    agree = bool(same[sure].all())
    ok = err_d <= bound and agree
    print(f"  [vl] bf16 teacher forcing: the first decode step vs the f32 "
          f"answer {err_d:.4e}, the bf16 training forward vs it {err_t:.4e} "
          f"(bound 2 x that + {floor:.4e} = {bound:.4e}); argmax agrees "
          f"with f32 on {int(same.sum())} of {bsz} rows, on the "
          f"{int(sure.sum())} rows past 2 x bound: {agree}: ok={ok}",
          flush=True)
    if not ok:
        raise AssertionError("vl bf16 serve: the decode step is further from "
                             "the f32 answer than allowed")
    stats.update(err_vs_f32=err_k, err_plain_vs_f32=err_p,
                 err_decode_vs_f32=err_d, err_train_vs_f32=err_t,
                 seconds=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, lora, cmp, out
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches, bf16, tc


def vlm_phase(torch, kernels, device):
    """Phase 15: internvl2-76b at full width, cut in depth (``VL_DEPTH``).
    The kernels at its shapes (:func:`vlm_kernel_phase`); training in f32
    at the f32 depth as the reference's launchers train it, a text-only LM
    on the launcher's tokens-only loaders (:func:`moe_train` with
    ``VL_TRAIN``, adapters on q/k/v/o: fedex, both rounds at 50% with
    example weights, ``factor_mean`` 1 and ``fedex_fold`` 4 a close, each
    fold checked on the first and the last layer of each leaf); one client
    step on a batch with vision embeddings (:func:`vlm_vision_step`); the
    f32 serve of the folded W0 and global adapter (:func:`vlm_serve`);
    that state freed, the bf16 serve at the bf16 depth from fresh draws
    (:func:`vlm_bf16`). Returns (max errors of the f32 cases, of the bf16
    cases, timings, launches, bf16 launches, stats)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, get_config

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(VL), num_layers=VL_DEPTH["float32"],
                  dtype="float32")
    r, scale = 4, 2.0
    lcfg = LoRAConfig(rank=r, alpha=8.0)
    errs, bf16_errs, timings = vlm_kernel_phase(torch, kernels, device, cfg,
                                                r=r, scale=scale)
    stats = {"kernels_s": time.perf_counter() - t,
             "kernels_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "depth": dict(VL_DEPTH)}
    launches = {name: 0 for name in SOURCES}
    t1 = time.perf_counter()
    trainer, stats["train"], got = moe_train(
        torch, kernels, device, cfg, scale, tag="vl", lcfg=lcfg, run=VL_TRAIN,
        weighted_from=0)
    for k, v in got.items():
        launches[k] += v
    stats["vision_step"] = vlm_vision_step(torch, device, cfg, trainer, lcfg)
    stats["train"]["train_peak_gib"] = max(
        stats["train"]["train_peak_gib"],
        torch.cuda.max_memory_allocated() / 2 ** 30)
    served, got = vlm_serve(torch, kernels, device, cfg, trainer.params,
                            trainer.global_lora, lcfg)[:2]
    for k, v in got.items():
        launches[k] += v
    stats["f32"] = dict(served, seconds=time.perf_counter() - t1)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    stats["bf16"], got, bf16, tc = vlm_bf16(torch, kernels, device, scale)
    for k, v in got.items():
        launches[k] += v
    bf16 = dict(bf16, **{f"{k}_tc": v for k, v in tc.items()})
    stats["seconds"] = time.perf_counter() - t
    print(f"  [vl] phase 15 in {stats['seconds']:.1f} s at depth "
          f"{VL_DEPTH['float32']} (f32) and {VL_DEPTH['bfloat16']} (bf16) of "
          f"80; peak memory: kernels {stats['kernels_peak_gib']:.2f} GiB, "
          f"f32 training {stats['train']['train_peak_gib']:.2f} GiB, f32 "
          f"serve {stats['f32']['peak_gib']:.2f} GiB, bf16 serve "
          f"{stats['bf16']['peak_gib']:.2f} GiB", flush=True)
    return errs, bf16_errs, timings, launches, bf16, stats


# --------------------------------------------------------------------------

SOURCES = {  # kernel → (CUDA source, the TPU kernel it replaces)
    "fedex_fold": ("src/repro_torch/kernels/csrc/fedex_fold.cu",
                   "src/repro/kernels/fedex_residual.py:108"),
    "factor_mean": ("src/repro_torch/kernels/csrc/factor_mean.cu",
                    "src/repro/kernels/factor_mean.py:50"),
    "product_fold": ("src/repro_torch/kernels/csrc/product_fold.cu",
                     "src/repro/kernels/fedex_residual.py:183"),
    "perclient_fold": ("src/repro_torch/kernels/csrc/perclient_fold.cu",
                       "src/repro/kernels/fedex_residual.py:277"),
    "hetero_fold": ("src/repro_torch/kernels/csrc/hetero_fold.cu",
                    "src/repro/kernels/fedex_residual.py:349"),
    "product_accum": ("src/repro_torch/kernels/csrc/product_accum.cu",
                      "src/repro/kernels/fedex_residual.py:215"),
    "lora_matmul": ("src/repro_torch/kernels/csrc/lora_matmul.cu",
                    "src/repro/kernels/lora_matmul.py:46"),
    "flash_swa": ("src/repro_torch/kernels/csrc/flash_swa.cu",
                  "src/repro/kernels/flash_swa.py:80"),
}


def launch_cost(torch, kernels, device, cfg, calls=1000) -> dict:
    """The host's share of the two launch-bound calls, at the main path's
    shapes: ``factor_mean`` over one close's a and b stacks (4 leaves, 2
    live lanes of 4; one grouped call where the package has
    ``factor_mean_group``, else 8 calls) and ``lora_matmul`` over one decode
    layer's q/k/v/o (4 calls, M = 8), in f32 and in bf16
    (``lora_matmul_bf16``, the serving dtype). For each, µs a close or a
    layer:
    ``wall_us``, perf_counter over ``calls`` of them synchronised at the end
    (the device's time included), ``enqueue_us``, the median of 200
    perf_counter spans around one of them after a synchronise (the host's
    launch path alone), and ``device_ms`` (:meth:`Timer.device`)."""
    stacks = []
    for i, (_, L, m, n) in enumerate(main_path_leaves(cfg)):
        _, a, b, w = make_inputs(torch, device, 4, (L,), m, n, 4, (0, 1),
                                 seed=i)
        stacks += [a, b]
    bufs = [lora_inputs(torch, device, SERVE["batch"], k, n, 4, seed=30 + i)
            for i, (_, k, n) in enumerate(serving_projections(cfg))]

    def b2():
        if hasattr(kernels, "factor_mean_group"):
            kernels.factor_mean_group(stacks, w)
        else:
            for x in stacks:
                kernels.factor_mean(x, w)

    bufs16 = [[t.bfloat16() for t in buf] for buf in bufs]

    def b3():
        for buf in bufs:
            kernels.lora_matmul(*buf, 2.0)

    def b3_bf16():
        for buf in bufs16:
            kernels.lora_matmul(*buf, 2.0)

    out, timer = {}, Timer(torch, device)
    for name, fn in (("factor_mean", b2), ("lora_matmul", b3),
                     ("lora_matmul_bf16", b3_bf16)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / calls * 1e6
        spans = []
        for _ in range(200):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            spans.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        out[name] = {"wall_us": wall,
                     "enqueue_us": statistics.median(spans) * 1e6,
                     "device_ms": timer.device(fn)}
    return out


def decode_sweep(torch, kernels, device, cfg) -> list:
    """B3's SIMT split-K body in f32 at every plan (K chunks 1, 2, 4, 8 ×
    column blocks of 32, 64, 128) at M = 8 and r = 4, at one decode layer's
    two shapes (q/o_proj and k/v_proj) and at K = 64 (where the launch's
    fixed part shows): device time a launch (:meth:`Timer.device`), checked
    against the plain version within the error bound. The plan that
    ``_split_plan`` picks is marked. Then :func:`bf16_decode_sweep`.
    Returns the rows."""
    lm = importlib.import_module("repro_torch.kernels.lora_matmul")
    lib = kernels.build.load_library()
    timer, rows = Timer(torch, device), []
    d, nq = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    nkv = cfg.num_kv_heads * cfg.resolved_head_dim
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for k, n in ((d, nq), (d, nkv), (64, nkv)):
        x, w, a, b = lora_inputs(torch, device, SERVE["batch"], k, n, 4, 3)
        y = torch.empty(SERVE["batch"], n, device=device)
        want = kernels.lora_matmul_plain(x, w, a, b, 2.0)
        bound = kernels.lora_matmul_error_bound(x, w, a, b, 2.0)
        picked = lm._split_plan(n, k, sms)
        for splits in (1, 2, 4, 8):
            if splits > 1 and (splits - 1) * -(-k // splits) >= k:
                continue
            for bn in (32, 64, 128):
                plan = (splits, -(-k // splits), bn)

                def run():
                    code = lib.lora_matmul_launch(
                        x.data_ptr(), w.data_ptr(), a.data_ptr(),
                        b.data_ptr(), y.data_ptr(), None, x.shape[0], n, k,
                        4, 2.0, *plan, int(n % 4 == 0), 0,
                        torch.cuda.current_stream().cuda_stream)
                    kernels.build.check_launch("lora_matmul", code)

                run()
                torch.cuda.synchronize()
                if not bool(((y - want).abs() <= bound).all()):
                    raise AssertionError(f"decode sweep K={k} N={n} plan "
                                         f"{plan} disagrees")
                ms = timer.device(run)
                blocks = -(-n // bn) * splits
                rows.append({"K": k, "N": n, "splits": splits, "bn": bn,
                             "blocks": blocks, "device_ms": ms,
                             "picked": plan == picked})
                print(f"  decode sweep K={k} N={n} splits={splits} bn={bn} "
                      f"({blocks} blocks): "
                      + ("not measured" if ms is None else
                         f"{ms * 1e3:.2f} us")
                      + ("  <- _split_plan" if plan == picked else ""),
                      flush=True)
    return rows + bf16_decode_sweep(torch, kernels, device)


def bf16_decode_sweep(torch, kernels, device) -> list:
    """B3's bf16 decode bodies at each served model's decode rows
    (``BF16_SERVE``: batch 8, 8, 2) and r 4: the tensor-core split-K body
    at every plan (K chunks 1-8 × column blocks of 64 and 128, kc a
    multiple of 64; the one ``_tc_split_plan`` picks marked) at each
    distinct projection shape (q, k = v, o) and at K = 64 (the launch's
    fixed part), beside the SIMT split-K body at ``_split_plan``'s plan
    and ``torch.addmm(x @ w, x @ a, b, alpha=2)`` in bf16, with the bytes
    bound; then each model's whole decode layer (q/k/v/o), new body, old
    body and ``addmm`` bf16 in turns. Every case is held to the plain
    version within ``lora_matmul_error_bound``. Device ms
    (:meth:`Timer.device`). Returns the rows."""
    from repro_torch.configs import get_config
    lm = importlib.import_module("repro_torch.kernels.lora_matmul")
    lib = kernels.build.load_library()
    timer, rows = Timer(torch, device), []
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launch(x, w, a, b, y, plan, vec):
        m, k = x.shape
        n, r = w.shape[1], a.shape[1]
        code = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), None, m, n, k, r, 2.0, *plan, vec, 1, stream)
        kernels.build.check_launch("lora_matmul", code)

    def simt(bufs):
        """The SIMT split-K body's launches over ``bufs`` (its plan and
        copy widths as the wrapper picks them for bf16), run once and held
        to the plain version; returns a function that launches them."""
        calls = []
        for x, w, a, b in bufs:
            n, r = w.shape[1], a.shape[1]
            vec = int(n % 4 == 0) | (2 if r % 4 == 0 else 0)
            y = torch.empty(x.shape[0], n, device=device)
            calls.append((x, w, a, b, y, lm._split_plan(n, x.shape[1], sms),
                          vec))
            launch(*calls[-1])
            held(f"SIMT K={x.shape[1]} N={n}", x, w, a, b, y)
        return lambda: [launch(*c) for c in calls]

    def held(label, x, w, a, b, y):
        """y within the bound of the plain version."""
        torch.cuda.synchronize()
        bound = kernels.lora_matmul_error_bound(x, w, a, b, 2.0)
        if not bool(((y - kernels.lora_matmul_plain(
                x, w, a, b, 2.0)).abs() <= bound).all()):
            raise AssertionError(f"bf16 decode sweep {label} disagrees")

    for name, (bsz, *_) in BF16_SERVE.items():
        c = get_config(name)
        projs = serving_projections(c)
        shapes = list(dict.fromkeys((k, n) for _, k, n in projs))
        shapes.append((64, projs[1][2]))
        for k, n in shapes:
            x, w, a, b = (t.bfloat16() for t in lora_inputs(
                torch, device, bsz, k, n, 4, seed=k + n))
            y = torch.empty(bsz, n, device=device)
            nbytes, _ = lora_cost([(bsz, k, n)], 4, 2)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            picked = lm._tc_split_plan(n, k, sms)
            slices = -(-k // 64)
            before = kernels.lora_matmul.bf16_tc_decode_launches
            got = kernels.lora_matmul(x, w, a, b, 2.0)
            if kernels.lora_matmul.bf16_tc_decode_launches != before + 1:
                raise AssertionError(f"bf16 decode sweep {name} K={k} N={n}: "
                                     "not the tensor-core split-K body")
            held(f"{name} K={k} N={n}", x, w, a, b, got)
            old = simt([(x, w, a, b)])
            old_ms = timer.device(old, bound)
            lib_ms = timer.device(
                lambda: torch.addmm(x @ w, x @ a, b, alpha=2.0), bound)
            plans = {(-(-k // (64 * -(-slices // s))), 64 * -(-slices // s),
                      lm.DC_BN) for s in range(1, 9)}
            for plan in sorted(plans):
                launch(x, w, a, b, y, plan, 4)
                held(f"{name} K={k} N={n} plan {plan}", x, w, a, b, y)
                ms = timer.device(lambda: launch(x, w, a, b, y, plan, 4),
                                  bound)
                blocks = -(-n // plan[2]) * plan[0]
                rows.append({"model": name, "M": bsz, "K": k, "N": n,
                             "splits": plan[0], "kc": plan[1],
                             "bn": plan[2], "blocks": blocks,
                             "device_ms": ms, "picked": plan == picked,
                             "simt_device_ms": old_ms,
                             "addmm_bf16_device_ms": lib_ms,
                             "bound_ms": bound})
                print(f"  bf16 decode sweep {name} M={bsz} K={k} N={n} "
                      f"splits={plan[0]} kc={plan[1]} bn={plan[2]} "
                      f"({blocks} blocks): {fmt_ms(ms)}{share(bound, ms)}"
                      + ("  <- _tc_split_plan" if plan == picked else ""),
                      flush=True)
            print(f"  bf16 decode sweep {name} M={bsz} K={k} N={n}: SIMT "
                  f"split-K {fmt_ms(old_ms)}{share(bound, old_ms)}, addmm "
                  f"bf16 {fmt_ms(lib_ms)}; bound {bound:.4f} ms (bytes)",
                  flush=True)
            del x, w, a, b, y, got
        # the whole decode layer, the three ways in turns
        bufs = [[t.bfloat16() for t in lora_inputs(torch, device, bsz, k, n,
                                                   4, seed=50 + i)]
                for i, (_, k, n) in enumerate(projs)]
        nbytes, _ = lora_cost([(bsz, k, n) for _, k, n in projs], 4, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3

        def new():
            for buf in bufs:
                kernels.lora_matmul(*buf, 2.0)

        def library():
            for x, w, a, b in bufs:
                torch.addmm(x @ w, x @ a, b, alpha=2.0)
        old = simt(bufs)
        layer = {}
        for key, fn in (("simt", old), ("new", new), ("addmm", library),
                        ("new2", new), ("simt2", old)):
            layer[key] = timer.device(fn, bound)
        rows.append({"model": name, "M": bsz, "layer": True,
                     "device_ms": layer["new"], "device_ms_2": layer["new2"],
                     "simt_device_ms": layer["simt"],
                     "simt_device_ms_2": layer["simt2"],
                     "addmm_bf16_device_ms": layer["addmm"],
                     "bound_ms": bound})
        print(f"  bf16 decode layer {name} M={bsz} (q/k/v/o), in turns: "
              f"SIMT split-K {fmt_ms(layer['simt'])}, tensor-core split-K "
              f"{fmt_ms(layer['new'])}{share(bound, layer['new'])}, addmm "
              f"bf16 {fmt_ms(layer['addmm'])}, tensor-core split-K "
              f"{fmt_ms(layer['new2'])}, SIMT split-K "
              f"{fmt_ms(layer['simt2'])}; bound {bound:.4f} ms (bytes)",
              flush=True)
        del bufs
        torch.cuda.empty_cache()
    return rows


def prefill_sweep(torch, kernels, device) -> list:
    """B3's bf16 prefill body (the tensor-core body) one projection at a
    time, at each served model's prefill rows (``BF16_SERVE``) and q, k
    and o shapes (v's is k's), at r 0, 4, 16 and 64: device time a launch
    (:meth:`Timer.device`) and its TFLOP/s, beside the bare bf16 product
    ``torch.matmul(x, w)`` (cuBLAS, bf16 out, no adapter) at r 0 — what the
    adapter adds to x@W, and how far the body's x@W is from cuBLAS's. Each
    case is checked against the plain version within the error bound and
    must take the tensor-core body. Returns the rows."""
    from repro_torch.configs import get_config
    timer, rows = Timer(torch, device), []
    for name, (bsz, prompt, *_) in BF16_SERVE.items():
        m = bsz * prompt
        for proj, k, n in serving_projections(get_config(name)):
            if proj == "v_proj":
                continue
            for r in (0, 4, 16, 64):
                x, w, a, b = (t.bfloat16() for t in lora_inputs(
                    torch, device, m, k, n, r, seed=r + k))
                label = f"{name} {proj} M={m} K={k} N={n} r={r}"
                tc_calls(torch, kernels, [[x, w, a, b]], 2.0, label, 1)
                got = kernels.lora_matmul(x, w, a, b, 2.0)
                bound = kernels.lora_matmul_error_bound(x, w, a, b, 2.0)
                if not bool(((got - kernels.lora_matmul_plain(
                        x, w, a, b, 2.0)).abs() <= bound).all()):
                    raise AssertionError(f"prefill sweep {label} disagrees")
                del got, bound
                flops = 2 * m * n * k + 2 * m * r * (k + n)
                ms = timer.device(lambda: kernels.lora_matmul(x, w, a, b,
                                                              2.0))
                mm = timer.device(lambda: torch.matmul(x, w)) if r == 0 \
                    else None
                rows.append({"model": name, "proj": proj, "M": m, "K": k,
                             "N": n, "r": r, "device_ms": ms,
                             "matmul_device_ms": mm})
                print(f"  prefill sweep {label}: kernel {fmt_ms(ms)}"
                      + ("" if ms is None else
                         f" ({flops / ms / 1e9:.0f} TFLOP/s)")
                      + ("" if r else f", torch.matmul bf16 {fmt_ms(mm)}"
                         + ("" if mm is None else
                            f" ({2 * m * n * k / mm / 1e9:.0f} TFLOP/s)")),
                      flush=True)
                del x, w, a, b
    return rows


# (B, S, H, KVH, d, window), causal: B8's served bf16 prefills (paper-gpt2,
# paper-llama3.2-3b, gemma3-12b with and without its window) and S 4096 at
# batch 1, with and without a window of 1024, at each head dim
ATTENTION_SWEEP = [
    (8, 512, 12, 12, 64, 0), (1, 4096, 12, 12, 64, 0),
    (1, 4096, 12, 12, 64, 1024), (8, 512, 24, 8, 128, 0),
    (1, 4096, 24, 8, 128, 0), (1, 4096, 24, 8, 128, 1024),
    (2, 2048, 16, 8, 256, 0), (2, 2048, 16, 8, 256, 1024),
    (1, 4096, 16, 8, 256, 0), (1, 4096, 16, 8, 256, 1024)]


def attention_sweep(torch, kernels, device) -> list:
    """B8's bf16 tensor-core body at each shape of ``ATTENTION_SWEEP``
    (:func:`flash_case`: within ``swa_error_bound`` of the plain version,
    two runs bitwise equal, both through the tensor-core body), its device
    time (:meth:`Timer.device`) in TFLOP/s (4·d FLOPs a visible pair) and
    as a share of its bound, beside SDPA in bf16 (``enable_gqa``; an
    explicit boolean mask for a window). Returns the rows."""
    timer, rows = Timer(torch, device), []
    for i, (b, s, h, kvh, d, window) in enumerate(ATTENTION_SWEEP):
        _, t = flash_case(torch, kernels, timer, device, b, s, h, kvh, d,
                          True, window, seed=200 + i, device_times=True,
                          dtype=torch.bfloat16, tc=True)
        flops, _ = port_cost.attention_work(b, s, s, h, kvh, d, True,
                                            window, 2)
        _, _, _, (bms, by), dev, lib = t
        rows.append({"B": b, "S": s, "H": h, "KVH": kvh, "d": d,
                     "window": window, "device_ms": dev,
                     "sdpa_device_ms": lib, "bound_ms": bms, "bound_by": by,
                     "gflop": flops / 1e9})

        def rate(ms):
            return "" if ms is None else (
                f" ({flops / ms / 1e9:.0f} TFLOP/s, {bms / ms:.0%} of the "
                "bound)")
        print(f"  attention sweep B={b} S={s} H={h}/{kvh} d={d} "
              f"window={window}: kernel {fmt_ms(dev)}{rate(dev)}, SDPA bf16 "
              f"{fmt_ms(lib)}{rate(lib)}; bound {bms:.4f} ms ({by})",
              flush=True)
        torch.cuda.empty_cache()
    return rows


def launch_cost_main(src: str) -> int:
    """``--launch-cost SRC``: :func:`launch_cost` of the port found under
    ``SRC`` (this checkout's ``src`` or another tree's, to compare two
    trees in one call), printed as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(src).resolve()))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    cost = launch_cost(torch, kernels, torch.device("cuda", 0), cfg)
    print(smi_line(), flush=True)
    print(json.dumps({"src": src, "launch_cost": cost}), flush=True)
    return 0


def decode_sweep_main() -> int:
    """``--decode-sweep``: :func:`decode_sweep` on this checkout's port."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[decode-sweep]")
    rows = decode_sweep(torch, kernels, torch.device("cuda", 0), cfg)
    print(json.dumps({"decode_sweep": rows}), flush=True)
    return 0


def prefill_sweep_main() -> int:
    """``--prefill-sweep``: :func:`prefill_sweep` on this checkout's
    port."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    rows = prefill_sweep(torch, kernels, torch.device("cuda", 0))
    print(json.dumps({"prefill_sweep": rows}), flush=True)
    return 0


def obs_http_main() -> int:
    """``--obs-http``: phase 6 alone (:func:`obs_http_phase`) on this
    checkout's port, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    print(smi_line(), flush=True)
    kbuild.load_library()  # every kernel built before the phase
    t = time.perf_counter()
    launches, stats = obs_http_phase(torch, kernels, torch.device("cuda", 0),
                                     cfg)
    print(json.dumps({"obs_http": stats, "launches": launches,
                      "seconds": time.perf_counter() - t}), flush=True)
    return 0


def mesh_main() -> int:
    """``--mesh``: phase 7 alone (:func:`mesh_phase`) on this checkout's
    port, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    print(smi_line(), flush=True)
    kbuild.load_library()  # every kernel built before the phase
    t = time.perf_counter()
    launches, stats = mesh_phase(torch, kernels, torch.device("cuda", 0), cfg)
    print(json.dumps({"mesh": stats, "launches": launches,
                      "seconds": time.perf_counter() - t}), flush=True)
    return 0


def attention_sweep_main() -> int:
    """``--attention-sweep``: :func:`attention_sweep` on this checkout's
    port, after the build and its ptxas summaries."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[sweep]")
    rows = attention_sweep(torch, kernels, torch.device("cuda", 0))
    print(json.dumps({"attention_sweep": rows}), flush=True)
    return 0


PTXAS = []  # the ptxas summary lines of the last build_kernels


def build_kernels(kbuild, label):
    """Build every kernel library (one ``nvcc`` a source, in parallel) and
    load it; print the build and the ptxas summaries of the kernels that
    ``ptxas_summary`` reads (kept in ``PTXAS``)."""
    t = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        libs = kbuild.build(verbose=True)
    print(log.getvalue(), end="", flush=True)
    kbuild.load_library()
    print(f"{label} build: {len(libs)} libraries "
          f"({', '.join(p.name for p in libs)}) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for lib, prefixes in (("factor_mean", ("factor_mean_",)),
                          ("lora_matmul", ("lora_mm_",)),
                          ("flash_swa", ("flash_swa_tile", "flash_swa_tc"))):
        text = log.getvalue().split(f"nvcc lib{lib}")[-1].split("\nnvcc ")[0]
        report = [line for prefix in prefixes
                  for line in ptxas_summary(text, prefix)]
        for line in report or [f"{lib}: library already built, no ptxas "
                               "report"]:
            PTXAS.append(line)
            print(f"  ptxas {line}", flush=True)


def fold_check_main() -> int:
    """``--fold-check``: phase 3's main-shape ``fedex_fold`` checks alone,
    in this process (after the build, TF32 off): the 4 leaves of a
    weighted close at paper-llama3.2-3b's shapes under each body (2 and 4
    live lanes of 4 weighted, uniform), each against its plain version
    within ``fold_error_bound``. Prints one JSON line with the checks, the
    failures and what each failure saw (:func:`fold_disagreement`); exits
    1 if any failed. Run it in many fresh processes to count how often a
    check fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kbuild.load_library()
    device = torch.device("cuda", 0)
    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    c = 4
    failed, checks, worst = [], 0, 0.0
    for body, live in (("weighted-partial", (0, 1)),
                       ("weighted-full", tuple(range(c))),
                       ("uniform", tuple(range(c)))):
        for i, (name, L, m, n) in enumerate(main_path_leaves(cfg)):
            w0, a, b, w = make_inputs(torch, device, c, (L,), m, n, 4, live,
                                      seed=i)
            err, ok, seen = check_fold(torch, kernels, w0, a, b, 2.0,
                                       None if body == "uniform" else w)
            checks += 1
            worst = max(worst, err)
            if not ok:
                failed.append({"check": f"{body} {name}", "seen": seen})
            del w0, a, b, w
    print(json.dumps({"fold_checks": checks, "failed": failed,
                      "max_abs_err": worst}), flush=True)
    return 1 if failed else 0


def zoo_main() -> int:
    """``--zoo``: phase 8 alone (:func:`zoo_phase`) on this checkout's port,
    after the build and its ptxas summaries, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[zoo]")
    errs, _, launches, stats = zoo_phase(torch, kernels,
                                         torch.device("cuda", 0))
    print(json.dumps({"zoo": stats, "launches": launches,
                      "max_abs_err": errs}), flush=True)
    return 0


def bf16_main() -> int:
    """``--bf16``: phase 9 alone (:func:`bf16_phase`) on this checkout's
    port, after the build and its ptxas summaries, its stats as one JSON
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    print("bf16 reduced-precision reduction (cuBLAS): "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    build_kernels(kbuild, "[bf16]")
    errs, timings, launches, bf16, stats = bf16_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(json.dumps({"bf16": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "timings": fields}), flush=True)
    return 0


def moe_main() -> int:
    """``--moe``: phase 10 alone (:func:`moe_phase`) on this checkout's
    port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[moe]")
    errs, bf16_errs, timings, launches, bf16, stats = moe_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"moe": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


def mla_main() -> int:
    """``--mla``: phase 11 alone (:func:`mla_phase`) on this checkout's
    port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[mla]")
    errs, bf16_errs, timings, launches, bf16, stats = mla_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"mla": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


def hybrid_main() -> int:
    """``--hybrid``: phase 12 alone (:func:`hybrid_phase`) on this
    checkout's port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[hybrid]")
    errs, bf16_errs, timings, launches, bf16, stats = hybrid_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"hybrid": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


def xlstm_main() -> int:
    """``--xlstm``: phase 13 alone (:func:`xlstm_phase`) on this
    checkout's port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[xlstm]")
    errs, bf16_errs, timings, launches, bf16, stats = xlstm_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"xlstm": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


def whisper_main() -> int:
    """``--encdec``: phase 14 alone (:func:`whisper_phase`) on this
    checkout's port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[encdec]")
    errs, bf16_errs, timings, launches, bf16, stats = whisper_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"encdec": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


def vlm_main() -> int:
    """``--vlm``: phase 15 alone (:func:`vlm_phase`) on this checkout's
    port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[vlm]")
    errs, bf16_errs, timings, launches, bf16, stats = vlm_phase(
        torch, kernels, torch.device("cuda", 0))
    fields = {}
    for key, t in timings.items():
        fields.update(timing_fields(key, t))
    print(smi_line(), flush=True)
    print(json.dumps({"vlm": stats, "launches": launches,
                      "bf16_launches": bf16, "max_abs_err": errs,
                      "bf16_max_abs_err": bf16_errs, "timings": fields}),
          flush=True)
    return 0


# --------------------------------------------------------------------------
# phase 16: the dry run and the roofline on one H100
# --------------------------------------------------------------------------

DRY = "paper-llama3.2-3b"
DRY_CAP_GIB = 70  # a step's global batch: the largest of its candidates
# whose dry-run peak is under this; kind → (assigned shape, dtype, the
# candidate batches: train's split into its 2 microbatches)
DRY_STEPS = {
    "train": ("train_4k", "float32", (2, 4, 8)),
    "prefill": ("prefill_32k", "bfloat16", (1, 2, 4, 8)),
    "decode": ("decode_32k", "bfloat16", (1, 2, 4, 8)),
}
DRY_MICROBATCHES = 2
DRY_RUNS = 3            # timed runs of a step, after one warm-up
DRY_PEAK_TOL = 0.10     # the measured peak against the dry run's
DRY_TAIL = 512          # B8's last query rows held at S 32,768
DRY_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")  # B3's four a layer
DRY_B8 = (1, 32_768, 24, 8, 128)  # B, S, H, KVH, d: a Llama prefill layer


def dry_records(dryrun):
    """(a): the dry run's record of every assigned architecture × shape,
    a line each; raises on a record that is not ``ok`` or skipped."""
    from repro_torch.configs import ASSIGNED
    dryrun.logger.setLevel("WARNING")  # one line a record, ours
    recs = []
    for arch in ASSIGNED:
        for shape in dryrun.SHAPE_NAMES:
            rec = dryrun.run_one(arch, shape)
            recs.append(rec)
            if rec["status"] == "skipped":
                print(f"  [dry] {arch} × {shape}: skipped ({rec['reason']})",
                      flush=True)
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {arch} × {shape}: "
                                     f"{rec.get('error')}")
            roof, mem = rec["roofline"], rec["memory"]
            print(f"  [dry] {arch} × {shape}: ok ({rec['count_s']} s), "
                  f"{roof['flops']:.4e} FLOPs, {roof['hbm_bytes']:.4e} B, "
                  f"peak {mem['peak_bytes'] / 2 ** 30:.1f} GiB (fits "
                  f"{rec['fits']}); compute {roof['compute_s'] * 1e3:.1f} "
                  f"ms, memory {roof['memory_s'] * 1e3:.1f} ms "
                  f"({roof['dominant']}); MODEL_FLOPS "
                  f"{roof['model_flops_global']:.4e}, useful "
                  f"{roof['useful_flops_ratio']:.3f}", flush=True)
    return recs


def dry_pick(dryrun, cfg, kind):
    """The step's shape at the largest global batch whose dry-run peak is
    under ``DRY_CAP_GIB``, with its meta count."""
    from repro_torch.configs import ShapeConfig, get_shape
    name, _, batches = DRY_STEPS[kind]
    seq = get_shape(name).seq_len
    best = None
    for gb in batches:
        shape = ShapeConfig(name, seq, gb, kind)
        c = dryrun.count_step(cfg, shape, microbatches=DRY_MICROBATCHES)
        print(f"  [dry] {cfg.name} {kind} {cfg.dtype} batch {gb} × {seq}: "
              f"dry-run peak {c.peak_bytes / 2 ** 30:.2f} GiB", flush=True)
        if c.peak_bytes < DRY_CAP_GIB * 2 ** 30:
            best = (shape, c)
    if best is None:
        raise AssertionError(f"dry run {cfg.name} {kind}: no batch of "
                             f"{batches} under {DRY_CAP_GIB} GiB")
    return best


def dry_state(torch, steps, model, cfg, shape, lcfg, device):
    """The step's arguments on the card: seeded draws of the weights (the
    port's ``init`` and ``init_lora``, then b drawn non-zero), inputs from
    ``random_inputs``; decode's cache full: random K / V, every slot
    valid (positions 0 … S − 1), the step at position S − 1."""
    from repro_torch.util.tree import flatten_with_paths
    params, lora, opt = steps.abstract_state(model, cfg, lcfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for path, leaf in flatten_with_paths(lora).items():
        if path.endswith("/b"):
            leaf.normal_(0.0, 0.02, generator=gen)
    batch = steps.random_inputs(cfg, shape, device, seed=2)
    if shape.kind == "train":
        return (params, lora, opt, batch, 0)
    cache = steps.abstract_cache(model, shape.global_batch, shape.seq_len,
                                 device=device)
    if shape.kind == "prefill":
        return (params, lora, batch, cache)
    for key in ("k", "v"):
        cache["layers"][key].normal_(generator=gen)
    cache["layers"]["pos"].copy_(torch.arange(shape.seq_len, device=device))
    return (params, lora, batch["tokens"], cache, shape.seq_len - 1)


def dry_outputs(torch, kind, out, args, vocab):
    """What a step gives back is right in kind: finite values of the
    expected shapes — train's loss, gnorm and every updated LoRA leaf
    (shaped as the one it replaces); prefill's last-position logits
    (B, 1, V); decode's logits and next tokens, the tokens the logits'
    argmax. Raises otherwise."""
    from repro_torch.util.tree import flatten_with_paths
    bad = []
    if kind == "train":
        lora, _, loss, gnorm = out
        new, old = flatten_with_paths(lora), flatten_with_paths(args[1])
        if new.keys() != old.keys() or any(
                new[p].shape != old[p].shape for p in old):
            bad.append("the updated LoRA tree is not the one it replaces")
        bad += [f"LoRA leaf {p} not finite" for p, x in new.items()
                if not bool(torch.isfinite(x).all())]
        bad += [f"{name} {float(x)} not finite" for name, x
                in (("loss", loss), ("gnorm", gnorm))
                if not bool(torch.isfinite(x))]
        told = f"loss {float(loss):.4f}, gnorm {float(gnorm):.4e}"
    else:
        logits = out[0] if kind == "prefill" else out[1]
        b = args[2]["tokens"].shape[0] if kind == "prefill" else \
            args[2].shape[0]
        if tuple(logits.shape) != (b, 1, vocab) or \
                not bool(torch.isfinite(logits).all()):
            bad.append(f"logits {tuple(logits.shape)} not finite (B, 1, "
                       f"{vocab})")
        if kind == "decode":
            want = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            if not torch.equal(out[0], want[:, None]):
                bad.append("the next tokens are not the logits' argmax")
        told = f"logits {tuple(logits.shape)} finite"
    if bad:
        raise AssertionError(f"dry {kind}: " + "; ".join(bad))
    return told


def dry_projs(torch, args):
    """Layer 0's four attention projections as the serving step hands them
    to B3: (name, W0, a, b), the adapter cast to W0's dtype as
    ``common.project`` casts it; copies, so that the step's state can go."""
    params, lora = args[0]["layers"]["attn"], args[1]["layers"]["attn"]
    return [(name, params[name]["kernel"][0].clone(),
             lora[name]["a"][0].to(params[name]["kernel"].dtype).clone(),
             lora[name]["b"][0].to(params[name]["kernel"].dtype).clone())
            for name in DRY_PROJS]


def dry_b3(torch, kernels, device, kind, m, projs, scale):
    """B3 at a serving step's own shapes: x (M, K) seeded unit normals in
    bf16 (M = B·S for prefill, B for decode) through layer 0's four
    projections (:func:`dry_projs`, the step's weights and b draws), each
    call through the body the step took (the tensor-core body for prefill,
    the tensor-core split-K body for decode), held against the plain
    version within ``lora_matmul_error_bound``. Returns the max error."""
    key = "bf16_tc_launches" if kind == "prefill" else \
        "bf16_tc_decode_launches"
    g = torch.Generator(device=device)
    g.manual_seed(17)
    xs, err, worst = {}, 0.0, 0.0
    for name, w, a, b in projs:
        k = w.shape[0]
        if k not in xs:
            xs[k] = torch.randn(m, k, device=device, generator=g).to(w.dtype)
        x = xs[k]
        before = getattr(kernels.lora_matmul, key)
        got = kernels.lora_matmul(x, w, a, b, scale)
        torch.cuda.synchronize()
        if getattr(kernels.lora_matmul, key) != before + 1:
            raise AssertionError(f"dry B3 {kind} {name}: not the body the "
                                 f"step took ({key})")
        want = kernels.lora_matmul_plain(x, w, a, b, scale)
        bound = kernels.lora_matmul_error_bound(x, w, a, b, scale)
        e = (got - want).abs()
        err = max(err, float(e.max()))
        worst = max(worst, float((e / bound.clamp_min(
            torch.finfo(torch.float32).tiny)).max()))
        if not bool((e <= bound).all()):
            raise AssertionError(
                f"dry B3 {kind} {name} M={m} K={k} N={w.shape[1]} "
                f"r={a.shape[1]}: off the plain version by {err:.3e} "
                f"({worst:.3f} of lora_matmul_error_bound)")
        del got, want, bound, e
    shapes = ", ".join(f"{name} {w.shape[0]}×{w.shape[1]}"
                       for name, w, _, _ in projs)
    print(f"  [dry] lora_matmul[{kind}: M={m}, {shapes}, r="
          f"{projs[0][2].shape[1]}, bf16] max_abs_err={err:.3e} within "
          f"lora_matmul_error_bound ({worst:.3f} of it), the step's body",
          flush=True)
    del xs
    _free(torch, device)
    return err


def dry_step(torch, kernels, device, dryrun, cost, roofline, steps, kind):
    """(b) for one of Llama's steps: pick its batch by the dry run, build
    its state on the card, count it there (FLOPs and bytes equal to the
    meta count), measure its peak over the state's baseline and its median
    ms of ``DRY_RUNS`` after a warm-up, check the last run's outputs
    (:func:`dry_outputs`); returns its stats and, for the serving steps,
    (B3's M, layer 0's projections (:func:`dry_projs`), the scale)."""
    from dataclasses import replace

    from repro_torch.configs import LoRAConfig, TrainConfig, get_config
    from repro_torch.models.model import build_model
    name, dtype, _ = DRY_STEPS[kind]
    cfg = replace(get_config(DRY), dtype=dtype)
    shape, meta = dry_pick(dryrun, cfg, kind)
    lcfg = LoRAConfig(rank=16, alpha=32)
    model = build_model(cfg)
    if kind == "train":
        step = steps.make_train_step(model, lcfg, TrainConfig(total_steps=1000),
                                     num_microbatches=DRY_MICROBATCHES)
    elif kind == "prefill":
        step = steps.make_prefill_step(model, lcfg)
    else:
        step = steps.make_decode_step(model, lcfg)
    mode = (contextlib.nullcontext() if kind == "train"
            else torch.inference_mode())
    _free(torch, device)
    base = torch.cuda.memory_allocated(device)
    args = dry_state(torch, steps, model, cfg, shape, lcfg, device)
    torch.cuda.synchronize()
    with mode:
        card = cost.count(step, *args)
    if (card.flops, card.bytes_accessed) != (meta.flops, meta.bytes_accessed):
        raise AssertionError(
            f"dry {kind}: the card counts {card.flops} FLOPs, "
            f"{card.bytes_accessed} B; the meta device {meta.flops}, "
            f"{meta.bytes_accessed}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with mode:
        step(*args)  # the warm-up, its peak measured
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        times = []
        for _ in range(DRY_RUNS):
            out = None  # the previous run's outputs go before this one
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        told = dry_outputs(torch, kind, out, args, cfg.vocab_size)
        del out
    ms = statistics.median(times)
    if abs(peak - meta.peak_bytes) > DRY_PEAK_TOL * meta.peak_bytes:
        raise AssertionError(f"dry {kind}: measured peak {peak} B against "
                             f"the dry run's {meta.peak_bytes} B")
    mflops = roofline.model_flops_per_step(cfg, shape)
    peak_rate = roofline.peak_flops(cfg.dtype)
    bound_s = max(meta.flops / peak_rate,
                  meta.bytes_accessed / roofline.HBM_BYTES_PER_S)
    row = {"step": kind, "dtype": dtype, "batch": shape.global_batch,
           "seq": shape.seq_len, "flops": meta.flops,
           "bytes": meta.bytes_accessed, "dry_peak_gib": meta.peak_bytes / 2 ** 30,
           "card_peak_count_gib": card.peak_bytes / 2 ** 30,
           "measured_peak_gib": peak / 2 ** 30, "ms": ms, "runs_ms": times,
           "model_flops": mflops,
           "model_tflops_per_s": mflops / (ms / 1e3) / 1e12,
           "mfu": mflops / (ms / 1e3) / peak_rate,
           "bound_ms": bound_s * 1e3,
           "bound_by": ("operations" if meta.flops / peak_rate
                        >= meta.bytes_accessed / roofline.HBM_BYTES_PER_S
                        else "bytes"),
           "share_of_bound": bound_s * 1e3 / ms}
    print(f"  [dry] {DRY} {kind} ({dtype}, batch {shape.global_batch} × "
          f"{shape.seq_len}): dry run {meta.flops:.4e} FLOPs, "
          f"{meta.bytes_accessed:.4e} B, peak {row['dry_peak_gib']:.2f} GiB; "
          f"the card's count equal; step {ms:.2f} ms (median of "
          f"{DRY_RUNS}: {', '.join(f'{t:.2f}' for t in times)}); measured "
          f"peak {row['measured_peak_gib']:.2f} GiB "
          f"({peak / meta.peak_bytes - 1:+.2%}); MODEL_FLOPS {mflops:.4e}, "
          f"{row['model_tflops_per_s']:.1f} TFLOP/s, MFU {row['mfu']:.2%} of "
          f"{peak_rate / 1e12:.0f}; bound {row['bound_ms']:.2f} ms "
          f"({row['bound_by']}), {row['share_of_bound']:.1%} of it; "
          f"{told}", flush=True)
    projs = None
    if kind != "train":
        projs = (shape.global_batch
                 * (shape.seq_len if kind == "prefill" else 1),
                 dry_projs(torch, args), lcfg.scale)
    del args
    _free(torch, device)
    return row, projs


def dry_b8(torch, kernels, timer, device):
    """(c): B8 at S 32,768 over a Llama prefill layer's shape (seeded
    unit-scale inputs, bf16): the last ``DRY_TAIL`` query rows of one
    launch against the plain version over all the keys (the plain
    version's and the bound's mask shifted to those rows' positions),
    within ``swa_error_bound``; timed beside SDPA bf16 (causal, over K and
    V repeated to the 24 query heads: its GQA path may take the math
    backend, whose scores would be 103 GB here). Returns (max error,
    timing tuple)."""
    import torch.nn.functional as F
    fs = importlib.import_module("repro_torch.kernels.flash_swa")
    b, s, h, kvh, d = DRY_B8
    g = torch.Generator(device=device)
    g.manual_seed(16)
    q = torch.randn(b, s, h, d, device=device, generator=g).bfloat16()
    k = torch.randn(b, s, kvh, d, device=device, generator=g).bfloat16()
    v = torch.randn(b, s, kvh, d, device=device, generator=g).bfloat16()
    before = kernels.flash_swa.bf16_tc_launches
    got = kernels.swa_attention(q, k, v, True, 0)[:, -DRY_TAIL:]
    torch.cuda.synchronize()
    if kernels.flash_swa.bf16_tc_launches != before + 1:
        raise AssertionError("dry B8 S 32768: not the tensor-core body")
    q0 = s - DRY_TAIL
    mask = fs._mask
    fs._mask = lambda sq, sk, causal, window, dev: visible_mask(
        torch, dev, sq, sk, causal, window, q0=q0)
    try:
        tail = q[:, q0:]
        want = kernels.swa_attention_plain(tail, k, v, True, 0)
        bound = kernels.swa_error_bound(tail, k, v, True, 0)
    finally:
        fs._mask = mask
    e = (got.float() - want.float()).abs()
    err, worst = float(e.max()), float((e / bound).max())
    if not bool((e <= bound).all()):
        raise AssertionError(f"dry B8 S 32768: last {DRY_TAIL} rows off the "
                             f"plain version by {err:.3e} ({worst:.3f} of "
                             "the bound)")
    del got, want, bound, e, tail
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
              for t in (k, v))

    def kernel():
        kernels.swa_attention(q, k, v, True, 0)

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    flops, nbytes = port_cost.attention_work(b, s, s, h, kvh, d, True, 0, 2)
    bound = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    t = (timer(kernel), None, timer(library), bound,
         timer.device(kernel, bound[0]), timer.device(library, bound[0]))
    ms, _, lib, (bms, by), dev, dev_lib = t
    print(f"  [dry] flash_swa[B={b} S={s} H={h}/{kvh} d={d} causal bf16] "
          f"last {DRY_TAIL} rows max_abs_err={err:.3e} within "
          f"swa_error_bound ({worst:.3f} of it); time kernel {ms:.3f} ms, "
          f"SDPA {lib:.3f} ms, bound {bms:.3f} ms ({by}); device kernel "
          f"{fmt_ms(dev)}{share(bms, dev)}, SDPA {fmt_ms(dev_lib)}; "
          f"{flops / (ms / 1e3) / 1e12:.0f} TFLOP/s", flush=True)
    del q, k, v, qt, kt, vt
    _free(torch, device)
    return err, t


def dryrun_phase(torch, kernels, device):
    """Phase 16: (a) the dry run of every assigned architecture × shape,
    (b) Llama's three steps measured against it, the launch counters set
    to 0 before them and read after (B3 4·L a prefill or decode run, B8 L
    a prefill run, 5 runs a step: the count, the warm-up and 3 timed),
    (c) B8 at S 32,768. Returns (launches, B8's max error, B8's timing,
    stats)."""
    from repro_torch.launch import cost, dryrun, roofline, steps
    t0 = time.perf_counter()
    recs = dry_records(dryrun)
    t_dry = time.perf_counter() - t0
    ok = sum(r["status"] == "ok" for r in recs)
    print(f"  [dry] {ok} ok, {len(recs) - ok} skipped of {len(recs)} in "
          f"{t_dry:.1f} s", flush=True)
    from repro_torch.configs import get_config
    layers = get_config(DRY).num_layers
    kernels.reset_launch_counts()
    done = {kind: dry_step(torch, kernels, device, dryrun, cost, roofline,
                           steps, kind) for kind in DRY_STEPS}
    runs = DRY_RUNS + 2
    counts = check_launches(kernels, "dry", {
        "lora_matmul": 2 * runs * 4 * layers, "flash_swa": runs * layers},
        " (B3 4·L and B8 L a prefill run, B3 4·L a decode run; 5 runs "
        "each)")
    tc = {"lora_matmul": runs * 4 * layers,
          "lora_matmul_decode": runs * 4 * layers, "flash_swa": runs * layers}
    if tc_launch_counts(kernels) != tc:
        raise AssertionError(f"dry: tensor-core launches "
                             f"{tc_launch_counts(kernels)} != {tc}")
    rows = {kind: row for kind, (row, _) in done.items()}
    b3_err = {kind: dry_b3(torch, kernels, device, kind, *held)
              for kind, (_, held) in done.items() if held is not None}
    del done
    timer = Timer(torch, device)
    err, b8 = dry_b8(torch, kernels, timer, device)
    del timer
    _free(torch, device)
    stats = {"records": len(recs), "ok": ok, "dry_run_s": t_dry,
             "steps": rows, "b3_max_abs_err": b3_err,
             "phase_s": time.perf_counter() - t0}
    print(f"  [dry] phase 16 in {stats['phase_s']:.1f} s", flush=True)
    return ({k: counts[k] for k in ("lora_matmul", "flash_swa")}, err, b8,
            stats)


def dryrun_main() -> int:
    """``--dryrun``: phase 16 alone (:func:`dryrun_phase`) on this
    checkout's port, after the build, its stats as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import build as kbuild
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi_line(), flush=True)
    build_kernels(kbuild, "[dry]")
    launches, err, b8, stats = dryrun_phase(torch, kernels,
                                            torch.device("cuda", 0))
    print(smi_line(), flush=True)
    print(json.dumps({"dryrun": stats, "launches": launches,
                      "b8_max_abs_err": err,
                      "b8_S32768": timing_fields("S32768", b8)}), flush=True)
    return 0



def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--launch-cost":
        return launch_cost_main(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--decode-sweep":
        return decode_sweep_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--prefill-sweep":
        return prefill_sweep_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--attention-sweep":
        return attention_sweep_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--obs-http":
        return obs_http_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--mesh":
        return mesh_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--zoo":
        return zoo_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--bf16":
        return bf16_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--moe":
        return moe_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--mla":
        return mla_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--hybrid":
        return hybrid_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--xlstm":
        return xlstm_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--encdec":
        return whisper_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--vlm":
        return vlm_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--dryrun":
        return dryrun_main()
    if len(sys.argv) == 2 and sys.argv[1] == "--fold-check":
        return fold_check_main()
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
    print(f"[1/17] environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, f32 matmul precision "
          f"{torch.get_float32_matmul_precision()}, bf16 reduced-precision "
          "reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    print(smi, flush=True)

    build_kernels(kbuild, "[2/17]")

    cfg = replace(get_config("paper-llama3.2-3b"), dtype="float32")
    c, r, scale = 4, 4, 8.0 / 4
    print(f"[3/17] kernels vs plain versions (C={c}, r={r}, scale={scale})",
          flush=True)
    errs, timings = kernel_phase(torch, kernels, device, cfg, c=c, r=r,
                                 scale=scale)
    lane_errs, lane_timings, lane_prior = lane_kernel_phase(
        torch, kernels, device, cfg, c=c, r=r, scale=scale)
    errs.update(lane_errs)
    serve_errs, serve_timings = serving_kernel_phase(
        torch, kernels, device, cfg, batch=SERVE["batch"],
        prompt=SERVE["prompt"], r=r, scale=scale)
    errs.update(serve_errs)
    gcfg = replace(get_config("paper-gpt2"), dtype="float32")
    gpt2_fold_errs, gpt2_fold = kernel_phase(
        torch, kernels, device, gcfg, c=c, r=r, scale=scale,
        bodies=("weighted-partial",), edges=False)
    gpt2_errs, gpt2_timings = gpt2_kernel_phase(
        torch, kernels, device, cfg, gcfg, batch=SERVE["batch"],
        prompt=SERVE["prompt"], r=r, scale=scale)
    for k, v in (*gpt2_fold_errs.items(), *gpt2_errs.items()):
        errs[k] = max(errs[k], v)
    cost = launch_cost(torch, kernels, device, cfg)
    print(f"  launch path: {json.dumps(cost)}", flush=True)
    torch.cuda.empty_cache()

    print(f"[4/17] main paths: FederatedTrainer at {cfg.name} full width "
          f"({cfg.num_layers} layers, d={cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}); {', '.join(GPT2_PATHS)} at "
          f"{gcfg.name} ({gcfg.num_layers} layers, d={gcfg.d_model}, vocab "
          f"{gcfg.vocab_size})", flush=True)
    launches, all_rows, identities, peaks = train_paths(
        torch, kernels, device, cfg, gcfg, PATHS)
    resume_launches, resume = resume_paths(torch, kernels, device, cfg, gcfg)
    for k, v in resume_launches.items():
        launches[k] += v
    acc_gib = sum(4 * L * m * n for _, L, m, n in main_path_leaves(cfg)
                  ) / 2 ** 30
    print("  peak memory of training and closes (the snapshots for the "
          "identity checks included, their temporaries not), stacked "
          "against chunked (GiB): "
          + ", ".join(f"{m} {peaks[m]:.2f} / {peaks[m + '[chunked]']:.2f}"
                      for m in ("fedex", "reinit", "keep_local", "fedex_svd",
                                "hetero"))
          + f"; the chunked product accumulator is {acc_gib:.2f} GiB",
          flush=True)
    closes = {row["path"]: row["close_ms"] for row in all_rows}
    print("  close ms of the last weighted round, 2 of 4 clients: fedex "
          f"kernel close {closes['fedex']:.2f}, fedex eager close "
          f"{closes['fedex[eager]']:.2f} (its §6 divergence included), "
          f"fedex+dp kernel close {closes['fedex+dp']:.2f}, fedit "
          f"{closes['fedit']:.2f}, ffa {closes['ffa']:.2f}; "
          f"{gcfg.name} fedex kernel close {closes['gpt2-fedex']:.2f}",
          flush=True)
    serve_stats = {}
    for scfg in (cfg, gcfg):
        print(f"[5/17] serving: {scfg.name} at full width, prefill + KV-cache "
              "greedy decode with a LoRA adapter", flush=True)
        serve_stats[scfg.name], serve_launches = serve_phase(
            torch, kernels, device, scfg)
        for k in ("lora_matmul", "flash_swa"):
            launches[k] += serve_launches[k]
    print(f"[6/17] obs and the HTTP federation service at {cfg.name} full "
          "width: fedex+obs, serve-http, pull-serve, serve-http-hetero",
          flush=True)
    obs_launches, obs_stats = obs_http_phase(torch, kernels, device, cfg)
    for k, v in obs_launches.items():
        launches[k] += v
    print(f"[7/17] mesh mode at {cfg.name} full width: "
          f"{', '.join(MESH_PATHS)}", flush=True)
    mesh_launches, mesh_stats = mesh_phase(torch, kernels, device, cfg)
    for k, v in mesh_launches.items():
        launches[k] += v
    print(f"[8/17] the rest of the dense zoo at full width: "
          f"{', '.join(ZOO)}, each trained and served", flush=True)
    zoo_errs, zoo_timings, zoo_launches, zoo_stats = zoo_phase(
        torch, kernels, device)
    for k, v in zoo_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in zoo_launches.items():
        launches[k] += v
    print(f"[9/17] serving in bf16, the reference's default dtype: B3 and B8 "
          f"in bf16, then {', '.join(BF16_SERVE)} served at full width and "
          "depth", flush=True)
    bf16_errs, bf16_timings, bf16_main_launches, bf16_launches, bf16_stats = \
        bf16_phase(torch, kernels, device)
    for k, v in bf16_main_launches.items():
        launches[k] += v
    print(f"[10/17] the MoE family: {MOE} at full width, trained (host, then "
          f"a 2-lane mesh round) and served in f32 at depth "
          f"{MOE_DEPTH['float32']} and served in bf16 at depth "
          f"{MOE_DEPTH['bfloat16']} (cuts of 56)", flush=True)
    (moe_errs, moe_bf16_errs, moe_timings, moe_launches, moe_bf16,
     moe_stats) = moe_phase(torch, kernels, device)
    for k, v in moe_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in moe_launches.items():
        launches[k] += v
    print(f"[11/17] Multi-head Latent Attention on the MoE stack: {DS} at "
          f"full width, trained (host, then a 2-lane mesh round) and "
          f"served in f32 at depth {DS_DEPTH['float32']} and served in "
          f"bf16 at depth "
          f"{DS_DEPTH['bfloat16']} (1 dense + MoE layers, cuts of 60)",
          flush=True)
    (mla_errs, mla_bf16_errs, mla_timings, mla_launches, mla_bf16,
     mla_stats) = mla_phase(torch, kernels, device)
    for k, v in mla_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in mla_launches.items():
        launches[k] += v
    print(f"[12/17] the hybrid family: {ZB} at full width and depth "
          f"({ZB_DEPTH['float32']} Mamba2 layers, the shared block every "
          "6), trained (host, then a 2-lane mesh round) and served in f32, "
          "served in bf16", flush=True)
    (zb_errs, zb_bf16_errs, zb_timings, zb_launches, zb_bf16,
     zb_stats) = hybrid_phase(torch, kernels, device)
    for k, v in zb_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in zb_launches.items():
        launches[k] += v
    print(f"[13/17] the ssm family: {XL} at full width and depth "
          f"({XL_DEPTH['float32']} blocks, 6 periods of 7 mLSTM + 1 sLSTM), "
          "trained (host, then a 2-lane mesh round) and served in f32, "
          "served in bf16", flush=True)
    (xl_errs, xl_bf16_errs, xl_timings, xl_launches, xl_bf16,
     xl_stats) = xlstm_phase(torch, kernels, device)
    for k, v in xl_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in xl_launches.items():
        launches[k] += v
    print(f"[14/17] the encdec family: {WH} at full width and depth "
          "(24 encoder + 24 decoder layers over 1500 frames), trained "
          "(host, then a 2-lane mesh round) and served in f32, served in "
          "bf16", flush=True)
    (wh_errs, wh_bf16_errs, wh_timings, wh_launches, wh_bf16,
     wh_stats) = whisper_phase(torch, kernels, device)
    for k, v in wh_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in wh_launches.items():
        launches[k] += v
    print(f"[15/17] the vlm family: {VL} at full width, trained and served "
          f"in f32 at depth {VL_DEPTH['float32']} and served in bf16 at "
          f"depth {VL_DEPTH['bfloat16']} (cuts of 80), prompts of "
          f"{VL_SERVE['prompt']} = 256 vision + 256 text tokens", flush=True)
    (vl_errs, vl_bf16_errs, vl_timings, vl_launches, vl_bf16,
     vl_stats) = vlm_phase(torch, kernels, device)
    for k, v in vl_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in vl_launches.items():
        launches[k] += v
    print(f"[16/17] the dry run and the roofline on one H100: every "
          f"assigned architecture × shape on the meta device, then {DRY}'s "
          "train, prefill and decode steps at full width and depth measured "
          "against it, and B8 at S 32,768", flush=True)
    dry_launches, dry_err, dry_b8_t, dry_stats = dryrun_phase(
        torch, kernels, device)
    for k, v in dry_launches.items():
        launches[k] += v
    mesh_fields = {"factor_mean": {}, "fedex_fold": {}}
    # the mesh round of phases 10–14: each close's B2 and B1 launches and
    # device ms (CUDA events around each launch)
    for key, st in (("mixtral", moe_stats), ("ds", mla_stats),
                    ("zb", zb_stats), ("xl", xl_stats), ("wh", wh_stats)):
        mesh_row = st["mesh"]
        for name in ("factor_mean", "fedex_fold"):
            mesh_fields[name].update({
                f"{key}_mesh_launches": mesh_row["launches"].get(name, 0),
                f"{key}_mesh_device_ms": mesh_row["device_ms"][name]})
    main_body = {**timings["weighted-partial"], **lane_timings,
                 "lora_matmul": serve_timings["lora_matmul[prefill]"],
                 "flash_swa": serve_timings["flash_swa[prefill]"]}
    out = []
    for name, (source, replaces) in SOURCES.items():
        ms, plain, lib_ms, (bms, by), dev, dev_lib = main_body[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                    "device_ms": dev, "library_device_ms": dev_lib})
    for name, fields in mesh_fields.items():
        out[list(SOURCES).index(name)].update(fields)
    # B2's launch path: one close's means (µs, host clock)
    out[list(SOURCES).index("factor_mean")].update({
        "close_wall_us": cost["factor_mean"]["wall_us"],
        "close_enqueue_us": cost["factor_mean"]["enqueue_us"]})
    # B3's decode body (split-K) at one decode layer's q/k/v/o
    ms, _, lib_ms, (bms, _), dev, dev_lib = serve_timings[
        "lora_matmul[decode]"]
    out[list(SOURCES).index("lora_matmul")].update({
        "decode_ms": ms, "decode_library_ms": lib_ms,
        "decode_bound_ms": bms, "decode_device_ms": dev,
        "decode_library_device_ms": dev_lib,
        "decode_wall_us": cost["lora_matmul"]["wall_us"],
        "decode_enqueue_us": cost["lora_matmul"]["enqueue_us"],
        "bf16_decode_wall_us": cost["lora_matmul_bf16"]["wall_us"],
        "bf16_decode_enqueue_us": cost["lora_matmul_bf16"]["enqueue_us"]})
    # B8 at S 4096 (batch 1), causal and with a window of 1024
    for label, key in (("S4096", "S4096"), ("S4096-window1024", "W1024")):
        out[list(SOURCES).index("flash_swa")].update(timing_fields(
            key, serve_timings[f"flash_swa[{label}]"]))
    # paper-gpt2's shapes: B1 and B2 over a weighted close's 4 leaves, B3 at
    # one prefill and one decode layer, B8 at one prefill launch; B3 at the
    # serve launcher's default prompt (M 64) for both models
    for name, key, t in (("fedex_fold", "gpt2", gpt2_fold[
                              "weighted-partial"]["fedex_fold"]),
                         ("factor_mean", "gpt2", gpt2_fold[
                             "weighted-partial"]["factor_mean"]),
                         *(("lora_matmul", key, gpt2_timings[key])
                           for key in ("gpt2", "gpt2_decode", "gpt2_M64",
                                       "M64")),
                         ("flash_swa", "gpt2", gpt2_timings["flash_gpt2"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    # gemma3-12b's shapes (phase 8): B8 at head dim 256 without and with
    # its window of 1024, B3 at one prefill and one decode layer, B1 and B2
    # over a weighted close's 8 leaves
    for name, key, t in (("flash_swa", "gemma3", zoo_timings["flash_gemma3"]),
                         ("flash_swa", "gemma3_W1024",
                          zoo_timings["flash_gemma3_W1024"]),
                         ("lora_matmul", "gemma3", zoo_timings["gemma3"]),
                         ("lora_matmul", "gemma3_decode",
                          zoo_timings["gemma3_decode"]),
                         ("fedex_fold", "gemma3", zoo_timings["fedex_fold"]),
                         ("factor_mean", "gemma3",
                          zoo_timings["factor_mean"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    # bf16 (phase 9): B3 at one prefill and one decode layer of each served
    # model and at the serve launcher's M 64; B8 at d 128 (Llama),
    # 64 (GPT-2) and 256 (gemma3, no window and window 1024); the bf16
    # launches of phase 9's serve() runs and the largest bf16
    # kernel-vs-plain error
    for name, key, t in (
            *(("lora_matmul", key, bf16_timings[key]) for key in (
                "bf16", "bf16_decode", "bf16_M64", "gpt2_bf16",
                "gpt2_bf16_decode", "gpt2_bf16_M64", "gemma3_bf16",
                "gemma3_bf16_decode", "gemma3_bf16_M64")),
            ("flash_swa", "bf16", bf16_timings["flash_bf16"]),
            ("flash_swa", "bf16_gpt2", bf16_timings["flash_bf16_gpt2"]),
            ("flash_swa", "bf16_gemma3", bf16_timings["flash_bf16_gemma3"]),
            ("flash_swa", "bf16_gemma3_W1024",
             bf16_timings["flash_bf16_gemma3_W1024"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "bf16_launches": bf16_launches[name],
            "bf16_max_abs_err": bf16_errs[name]})
    # B3's and B8's tensor-core bodies (bf16 prefill; B3's decode apart):
    # their launches in phase 9's serve() runs
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)]["bf16_tc_launches"] = \
            bf16_launches[f"{name}_tc"]
    out[list(SOURCES).index("lora_matmul")]["bf16_tc_decode_launches"] = \
        bf16_launches["lora_matmul_decode_tc"]
    # mixtral-8x22b's shapes (phase 10): B1 at the up-proj expert leaf, B2
    # over a close's 14 stacks, B3 at one layer's q/k/v/o in bf16 (prefill
    # and decode) and at the expert projections, B8 at the prefill in f32
    # and bf16; the bf16 and tensor-core launches of its bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "mixtral", moe_timings["fedex_fold"]),
            ("factor_mean", "mixtral", moe_timings["factor_mean"]),
            *(("lora_matmul", key, moe_timings[key]) for key in (
                "mixtral_bf16", "mixtral_bf16_decode", "mixtral_expert",
                "mixtral_expert_bf16", "mixtral_expert_bf16_decode")),
            ("flash_swa", "mixtral", moe_timings["flash_mixtral"]),
            ("flash_swa", "mixtral_bf16", moe_timings["flash_mixtral_bf16"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "mixtral_bf16_launches": moe_bf16[name],
            "mixtral_bf16_tc_launches": moe_bf16[f"{name}_tc"],
            "mixtral_bf16_max_abs_err": moe_bf16_errs[name]})
    out[list(SOURCES).index("lora_matmul")][
        "mixtral_bf16_tc_decode_launches"] = moe_bf16["lora_matmul_decode_tc"]
    # deepseek-v2-236b's shapes (phase 11): B1 at the up-proj expert leaf,
    # B2 over a close's 30 stacks, B3 at one layer's six MLA projections
    # (prefill; decode's four) in f32 and bf16 and at the expert
    # projections, B8 at the MLA prefill (d 192, v padded) in f32 and bf16;
    # the bf16 and tensor-core launches of its bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "ds", mla_timings["fedex_fold"]),
            ("factor_mean", "ds", mla_timings["factor_mean"]),
            *(("lora_matmul", key, mla_timings[key]) for key in (
                "ds", "ds_decode", "ds_bf16", "ds_bf16_decode", "ds_expert",
                "ds_expert_bf16", "ds_expert_bf16_decode")),
            ("flash_swa", "ds", mla_timings["flash_ds"]),
            ("flash_swa", "ds_bf16", mla_timings["flash_ds_bf16"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "ds_bf16_launches": mla_bf16[name],
            "ds_bf16_tc_launches": mla_bf16[f"{name}_tc"],
            "ds_bf16_max_abs_err": mla_bf16_errs[name]})
    out[list(SOURCES).index("lora_matmul")][
        "ds_bf16_tc_decode_launches"] = mla_bf16["lora_matmul_decode_tc"]
    # zamba2-7b's shapes (phase 12): B1 at the stacked in_proj leaf, B2 over
    # a close's 16 stacks, B3 at in_proj and out_proj in f32 and bf16
    # (prefill and decode), B8 at the shared block's prefill (d 112) in f32
    # and bf16; the bf16 and tensor-core launches of its bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "zb", zb_timings["fedex_fold"]),
            ("factor_mean", "zb", zb_timings["factor_mean"]),
            *(("lora_matmul", key, zb_timings[key]) for key in (
                "zb", "zb_decode", "zb_bf16", "zb_bf16_decode")),
            ("flash_swa", "zb", zb_timings["flash_zb"]),
            ("flash_swa", "zb_bf16", zb_timings["flash_zb_bf16"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "zb_bf16_launches": zb_bf16[name],
            "zb_bf16_tc_launches": zb_bf16[f"{name}_tc"],
            "zb_bf16_max_abs_err": zb_bf16_errs[name]})
    out[list(SOURCES).index("lora_matmul")][
        "zb_bf16_tc_decode_launches"] = zb_bf16["lora_matmul_decode_tc"]
    # xlstm-1.3b's shapes (phase 13): B1 at the stacked q_proj leaf, B2
    # over a close's 16 stacks, B3 in f32 and bf16 (prefill and decode) at
    # an mLSTM block's five projections and the sLSTM's w_gates (xl) and
    # at the FFN's two at K or N 2730 (xl_ffn); the bf16 and tensor-core
    # launches of its bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "xl", xl_timings["fedex_fold"]),
            ("factor_mean", "xl", xl_timings["factor_mean"]),
            *(("lora_matmul", key, xl_timings[key]) for key in (
                "xl", "xl_decode", "xl_bf16", "xl_bf16_decode", "xl_ffn",
                "xl_ffn_decode", "xl_ffn_bf16", "xl_ffn_bf16_decode"))):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    out[list(SOURCES).index("lora_matmul")].update({
        "xl_bf16_launches": xl_bf16["lora_matmul"],
        "xl_bf16_tc_launches": xl_bf16["lora_matmul_tc"],
        "xl_bf16_tc_decode_launches": xl_bf16["lora_matmul_decode_tc"],
        "xl_bf16_max_abs_err": xl_bf16_errs["lora_matmul"]})
    # whisper-medium's shapes (phase 14): B1 at a stacked q_proj leaf, B2
    # over a close's 24 stacks, B3 at an attention's q/k/v/o in f32 and
    # bf16 over the frames (M 12,000), the prompt (M 512) and a decode step
    # (M 8), B8 at the encoder (S 1500, non-causal), the decoder's
    # self-attention (S 64) and its cross-attention (Sq 64, 333 and 1
    # against Sk 1500) in f32 and bf16; the bf16 and tensor-core launches
    # of its bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "wh", wh_timings["fedex_fold"]),
            ("factor_mean", "wh", wh_timings["factor_mean"]),
            *(("lora_matmul", key, wh_timings[key]) for key in (
                "wh", "wh_dec", "wh_decode", "wh_bf16", "wh_dec_bf16",
                "wh_bf16_decode")),
            *(("flash_swa", key[len("flash_"):], wh_timings[key])
              for key in wh_timings if key.startswith("flash_wh"))):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "wh_bf16_launches": wh_bf16[name],
            "wh_bf16_tc_launches": wh_bf16[f"{name}_tc"],
            "wh_bf16_max_abs_err": wh_bf16_errs[name]})
    out[list(SOURCES).index("lora_matmul")][
        "wh_bf16_tc_decode_launches"] = wh_bf16["lora_matmul_decode_tc"]
    # internvl2-76b's shapes (phase 15): B1 at the stacked q_proj leaf of
    # the f32 depth, B2 over a close's 8 stacks, B3 at a layer's q/k/v/o in
    # f32 and bf16 at the prefill (M 4096: 256 vision + 256 text rows of 8)
    # and a decode step (M 8), B8 at the prefill (S 512, GQA 64/8) in f32
    # and bf16; the launches of phase 15's main paths (training, the f32
    # and the bf16 serve()) and the bf16 and tensor-core launches of its
    # bf16 serve() run
    for name, key, t in (
            ("fedex_fold", "vl", vl_timings["fedex_fold"]),
            ("factor_mean", "vl", vl_timings["factor_mean"]),
            *(("lora_matmul", key, vl_timings[key]) for key in (
                "vl", "vl_decode", "vl_bf16", "vl_bf16_decode")),
            ("flash_swa", "vl", vl_timings["flash_vl"]),
            ("flash_swa", "vl_bf16", vl_timings["flash_vl_bf16"])):
        out[list(SOURCES).index(name)].update(timing_fields(key, t))
    for name in ("fedex_fold", "factor_mean", "lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)]["vl_launches"] = vl_launches[name]
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)].update({
            "vl_bf16_launches": vl_bf16[name],
            "vl_bf16_tc_launches": vl_bf16[f"{name}_tc"],
            "vl_bf16_max_abs_err": vl_bf16_errs[name]})
    out[list(SOURCES).index("lora_matmul")][
        "vl_bf16_tc_decode_launches"] = vl_bf16["lora_matmul_decode_tc"]
    # phase 16: B3's and B8's launches in Llama's measured steps; B8 at
    # S 32,768 (bf16, batch 1), its last 512 rows held to the plain version
    for name in ("lora_matmul", "flash_swa"):
        out[list(SOURCES).index(name)]["dry_launches"] = dry_launches[name]
    out[list(SOURCES).index("lora_matmul")].update({
        f"dry_{kind}_max_abs_err": e
        for kind, e in dry_stats["b3_max_abs_err"].items()})
    out[list(SOURCES).index("flash_swa")].update({
        **timing_fields("S32768", dry_b8_t), "S32768_max_abs_err": dry_err})
    # B5 beside its old body (product_fold in place), and at the chunk of
    # 64 uplinks at r = 8 that docs/benchmarks.md documents
    ms, _, lib_ms, (bms, by), *_ = lane_timings["product_accum[C64r8]"]
    out[list(SOURCES).index("product_accum")].update({
        "prior_ms": lane_prior["product_accum"], "C64r8_ms": ms,
        "C64r8_prior_ms": lane_prior["product_accum[C64r8]"],
        "C64r8_library_ms": lib_ms, "C64r8_bound_ms": bms,
        "C64r8_bound_by": by})
    print(f"[17/17] done in {time.perf_counter() - t_start:.1f} s; identity "
          "max "
          f"err per path {json.dumps(identities)}; resume "
          f"{json.dumps(resume)}; serving "
          f"{json.dumps(serve_stats)}; obs and http "
          f"{json.dumps(obs_stats)}; mesh {json.dumps(mesh_stats)}; zoo "
          f"{json.dumps(zoo_stats)}; bf16 {json.dumps(bf16_stats)}; moe "
          f"{json.dumps(moe_stats)}; mla {json.dumps(mla_stats)}; hybrid "
          f"{json.dumps(zb_stats)}; xlstm {json.dumps(xl_stats)}; encdec "
          f"{json.dumps(wh_stats)}; vlm {json.dumps(vl_stats)}; dryrun "
          f"{json.dumps(dry_stats)}; rounds "
          + json.dumps([{k: v for k, v in row.items()
                         if k != "client_losses"} for row in all_rows]),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
