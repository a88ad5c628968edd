#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``dynamo_tpu_torch``.

    python3 chip_smoke.py        # from the root of a checkout, on one H100

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels and the host hot loops from
   ``dynamo_tpu_torch/csrc`` (one ``nvcc`` per ``.cu`` source and the host
   compiler for ``dynamo_native.cpp``, all started together; ``[build]``
   gives each one's seconds) and print the card's name and power limit;
2. hold the paged-attention kernel against its plain PyTorch version on the
   card, in bf16 at Llama-3.2-1B attention shapes with block 0 poisoned with
   NaN, on both faces, and its quantized-KV branch (int8 and fp8 pages with
   per-(slot, head) f32 scales, NaN trash scales and NaN fp8 trash pages) at
   the main path's shapes and on a mixed ragged batch, and the ragged face
   at the spec engine's verify shape (16 rows x 5 queries over ~560 keys)
   in bf16, int8 and fp8; time the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention``
   over pre-gathered (dequantized) K/V (the ``library_ms`` yardstick; only
   this script calls it); hold the kernel at non-default launch parameters
   (``LAUNCH_CASES``: a q_tile below the default, the other kv_chunk,
   n_split 1 and the span count) against the plain version, and launch
   parameters of 0 bitwise against a call without them;
3. serve 16 concurrent greedy requests (ISL 512, OSL 64) through the port's
   engine at full Llama-3.2-1B width with random weights from a fixed seed,
   through the same API ``python -m dynamo_tpu_torch.run in=batch`` uses,
   three times: bf16, int8 weights + int8 KV, fp8 weights + fp8 KV. Each
   engine captures its decode windows as CUDA graphs at construction and
   serves the traffic at run-ahead depths 2 (the default), 1 and 2 again
   (TTFT, ITL, throughput, steady decode step, fetch syncs and the flight
   recorder's MFU and goodput for each); every decode window must be a
   graph replay and the stall watchdog's einsum rebuild must not fire. Each
   run shows that decode and prefill went through its kernel build and
   checks a probe step's logits against the einsum attention path; the
   quantized runs print their probe's divergence from the bf16 logits.
   ``[graph]`` lines hold each decode graph phase 3 replays (buckets 8 and
   16, greedy and stochastic) against the eager window on identical clones
   of cache and ctl: samples and ctl must be bitwise equal. Then a bf16
   ``spec_mode="ngram"`` engine (k=4, n-gram 1..3, the same weights) serves
   16 greedy requests whose prompts repeat a seeded 64-token segment 8
   times (ISL 512, OSL 64), and the bf16 engine serves them at depths 1 and
   2: a spec stream may part from a non-spec one only where the non-spec
   model's top-2 logit margin is under 1e-3 x |top logit| (each parting's
   margin is printed), every spec window must be a graph replay whose
   verify forward ran the ragged face, and ``[spec]`` lines give
   acceptance, tokens per seat per window, windows per request, TTFT, ITL,
   tok/s and the steady window against the non-spec runs; ``[graph]``
   lines hold each spec graph against the eager spec window (packed output
   and ctl with the history bitwise equal);
4. profile one decode window, eager and as the engine's graph replay, and
   one prefill chunk at the main path's shapes (wall time, device busy time
   and idle share, host kernel and graph launches, kernels on the device,
   attention share), for the bf16 and the int8 engine, and measure what
   quantized serving adds to a decode step: the bf16 copies of the 1-byte
   weights and the ``kv_quantize`` launches;
5. serve the bf16 engine of phase 3 over HTTP through ``run.run_http``
   (what ``python -m dynamo_tpu_torch.run in=http`` runs) with a seeded
   synthetic byte-level BPE tokenizer at Llama-3's layout (128,000 regular
   and 256 special tokens, written under ``build/``): completions served one
   at a time must give the text of ``decode`` of the engine's own ids, chat
   goes through the default template, 16 concurrent streams of phase 3's
   traffic end in ``[DONE]``, ``/metrics`` counts every request, a client
   that leaves mid-stream frees its sequence and KV blocks within a second,
   and both attention faces launch; ``[http]`` lines print HTTP vs direct
   TTFT, ITL and throughput and the encode time of a prompt;
6. serve the same weights through the distributed path, each entry point a
   process of its own: ``python -m dynamo_tpu_torch.runtime.store``, worker
   A (``python -m dynamo_tpu_torch.worker --model 1b``, seed 0) and
   ``python -m dynamo_tpu_torch.frontend --port 0 --grpc-port 0``.
   Completions served one at a time must give phase 5's texts, and the
   same prompts as text must give over KServe gRPC (``ModelInfer`` and
   ``ModelStreamInfer``, the port's own HTTP/2 client) the text
   ``/v1/completions`` gives; only the worker may hold the GPU; phase 3's
   traffic goes through the three processes (``[dist]`` lines: TTFT, ITL
   and throughput beside phases 3 and 5, CPU time per token of each
   process, the codec's µs per streamed token), then as text through 16
   gRPC streams beside 16 SSE streams (``[grpc]``: TTFT, ITL, tok/s);
   ``[hash]`` lines time a prompt's block hashes, ``content_token`` of
   phase 16's image and, after the KV part below, a router match over the
   index the KV frontend holds, each in C++ (``csrc/dynamo_native.cpp``)
   and in Python (any difference fails); then worker B joins,
   both publish load metrics and serve under round robin. Worker B runs
   ``--spec-mode ngram`` with the control plane on (system server, a canary
   every second, the degradation watcher) and the frontends with their
   system servers: ``[control]`` lines show B's ``/health`` naming its
   canary, ``/live``, the ``engine_*`` gauges on B's ``/metrics`` after the
   traffic (decode MFU > 0, the ``spec_reject`` waste series), a
   degradation order written to ``planner/dynamo/degradation`` making the
   KV frontend answer tier 0 with 429 and tier 3 with 200 (and B's watcher
   meeting the ``spec_k`` clamp), and ``NO_DEGRADATION`` admitting tier 0
   again; then a second
   frontend, ``--router-mode kv``, joins the same store: of 4 groups of
   prompts sharing a 448-token prefix (28 blocks), each group's second
   request, sent one at a time, must land on the worker that served its
   first with >= 28 blocks matched (read from the frontend's
   ``router.select`` spans, ``build/dist/kv_spans.jsonl``), and 16
   concurrent shared-prefix streams go through each frontend (``[dist]``
   lines: TTFT and ITL under each sink, requests and cached prompt tokens
   per worker); worker A is SIGKILLed, once 8 in-process token streams
   have 64 tokens each, under 8 streams of 512 tokens, 4 through each
   frontend, that must all complete through migration (on the spec
   worker) while A's keys leave the store within the lease TTL + 1 s (the
   KV frontend's re-issues and A's breaker are printed); worker B leaves by
   ``POST /drain`` (exit 0, its keys gone) and both frontends exit 0 on
   SIGTERM. Both attention faces must have launched in worker A, the
   ragged face in worker B; their counts are the ``launches_dist`` of the
   ``kernels`` line.
   A ``[hash]`` line times the block hashes of one 512-token prompt. Child
   logs go to ``build/dist/``.

7. move KV (``[kvmove]`` lines), at Llama-3.2-1B width, bf16 unless said:
   (a) ``make_kv_ops`` gathers 32 random blocks of a random cache to pinned
   host memory and scatters them in place into 32 others, for bf16, int8
   and fp8 pages with their scales: bitwise equal to a plain host copy, the
   cache tensors keep their storage, and the decode face over the injected
   blocks agrees with its plain version; the bf16 gather + copy is timed;
   (b) a prefill engine and a decode engine on the card, joined by the
   device plane (``DevicePlane``, ``PrefillHandler``, ``DecodeHandler``),
   serve phase 3's traffic: every handoff moves one prompt's 16 MiB, every
   decode window is a graph replay over injected KV, both faces launch,
   and the streams meet ``check_parity`` against phase 3's engine (an
   eager rerun with its logits recorded); TTFT and ITL beside phase 3's,
   the plane's and the engine's extract times for one prompt; (e) a
   system server's ``POST /preempt`` makes the preemption coordinator
   evacuate 16 mid-stream seats to a co-resident peer engine (their
   streams go on there) and then 16 to the host tier (their re-admission
   prefills onboard the spilled blocks), each spliced stream held to
   ``check_parity``, with the report's counts and the kill-to-next-token
   time; then, after phase 6, across processes: the relay frame's host
   cost for one prompt, the ragged face at the shape of a prefill over an
   onboarded prompt against its plain version, (c) a ``--disagg-mode
   prefill --disagg-queue`` worker with a ``--disagg-mode decode`` worker,
   then one with ``--disagg-queue``, behind a frontend (TTFT and ITL beside
   phase 6's aggregated worker, the relay's spans), (d) a worker with
   ``--kvbm-host-blocks`` and a G3 directory serves phase 6's shared-prefix
   groups, its G1 is cleared and the second pass onboards from the host
   tier (onboarded blocks, prefix hit tokens, ragged launches over the
   onboarded prefix, both passes' TTFT), and (e) ``POST /preempt`` on that
   worker spills 8 mid-stream seats to its host tier and it drains and
   exits 0.

8. serve Mixtral-8x7B at full width, 16 of its 32 layers (``[moe]``
   lines): bf16 random weights from seed 0 drawn one expert matrix at a
   time, ``EngineConfig()``, phase 3's traffic at depth 2 (TTFT, ITL,
   tok/s, ``mfu_decode``/``mfu_prefill``, both faces' launches at head dim
   128), the probe (argmax agreement only: the two paths can route a token
   to different experts), each decode graph phase 3 replays against its
   eager window bit for bit, phase 4's profile of its decode window and
   prefill chunk, and one layer's ``moe_ffn`` against a plain f32
   reference at N=16 and N=512 with its share of each step; the kernel
   cases of phase 2 include both faces at this model's serving shapes;

9. load a checkpoint (``[load]`` lines): phase 3's bf16 weights written as
   an HF checkpoint (``config.json`` + two ``*.safetensors`` shards, HF
   names, ``[out, in]``) by the port's writer under ``build/``, loaded back
   in this process at bf16 and int8 (leaves bitwise equal to the engine's,
   and for int8 to ``quantize_params`` of the checkpoint), then served by
   ``python -m dynamo_tpu_torch.run in=batch:... out=engine --weights DIR``
   at bf16 and at int8 weights + KV in a process of its own: read rate,
   peak host RSS, time to ready, both faces' launches there, and its
   streams held to ``check_parity`` against phase 3's engine of the same
   dtype (an eager rerun with its logits recorded). The bf16 part runs
   after phase 7's in-process part, the int8 part after phase 4's int8
   profile, phase 8 last.

10. profile the engine for the SLA planner (``[profile]`` lines): what
   ``python -m dynamo_tpu_torch.planner.profiler --model 1b`` runs, in this
   process, at ISLs 128, 512 and 1024, batches 1, 8 and 16 and contexts 128
   and 512 (TTFT per ISL, ITL per batch and context, KV usage), written to
   ``build/profile_llama_3_2_1b.json``, which both interpolators load; the
   sweep's prefills launch the ragged face, its decode windows (graph
   replays) the decode face;

11. replay a trace (``[replay]`` lines): the ``bursty`` scenario at ISL 512
   / OSL 64 with half of each prompt shared within a tenant's pool (32
   requests, two tenants, two deadline tiers, an abort storm and a
   maintenance preemption) through ``run_cluster_replay`` against two port
   engines at Llama-3.2-1B width on the card behind the SimCluster front
   (KV router, Migration, the store, its snapshot in a temporary
   directory): per-tier TTFT/ITL p50/p99, goodput, the prefix-hit rate,
   the outcome digest, chip-seconds per 1M output tokens on the one card
   beside the scoreboard's (which counts each engine as a chip) and the
   roofline's ideal, and every scoreboard cross-check (TTFT against spans,
   tokens against the flight recorder, prefix hits against the radix
   index, token loss, fault attribution), each of which must pass; then
   (``[planner]`` lines) the planner builds both interpolators from phase
   10's profile, observes the replay as one window (request count, mean
   ISL/OSL, TTFT/ITL p99) and writes its replica targets through a
   ``VirtualConnector`` to a store, read back. Phases 10 and 11 run after
   the int8 and fp8 engines are freed, before phase 8.

12. tune attention (``[autotune]`` lines): engines with
   ``attention_impl="auto"`` and spec on, at bf16 and int8 KV, with
   ``DYNTPU_AUTOTUNE_CACHE`` in a temporary directory under ``build/``:
   the probe's kernel and einsum ms per class, every candidate's gate
   error and ms at both table widths, the winners and the build time;
   each engine is built twice, and the second build must hit the cache,
   sweep nothing and tune faster (``tune_s``, the tuning step's own
   time, not the whole build's, whose weight init is as noisy as the
   sweep is long); a non-spec engine on the bf16 winners
   serves phase 3's traffic at depth 2 (TTFT, ITL, tok/s beside phase 3's;
   streams held to the parity rule against phase 3's, partings printed
   with their margins), and each winner is held against the plain version
   and timed at the main path's shape;

13. adapt the decode buckets (``[ladder]`` lines): an engine with
   ``adaptive_buckets=True``, ``ladder_compile_budget=2``, decode buckets
   (32,) and 32 seats serves waves of 8 concurrent greedy requests (ISL
   512, OSL 64) until the decode ladder has split 32 at 8 and converged;
   the capture watch must count exactly one graph captured after warm-up
   (``decode_window:B=8:stochastic=0``), one more wave must capture
   nothing, and its streams are held to the parity rule against a
   static-grid engine's (padding waste of each, and the decode window's
   device ms at B=32 and B=8 with 8 live rows, printed);

14. take a profile under load (``[profile]`` lines): a system server
   beside phase 3's engine while it serves phase 3's traffic;
   ``GET /debug/profile?ms=500`` (which stops while the traffic still
   runs) must answer 200 with a Chrome trace that names both faces'
   kernels, and a second request during the capture 409. Phases 12–14
   run after phase 3's spec check.

15. embed (``[embed]`` lines), after phase 14, on phase 3's bf16 engine:
   ``engine.embed`` (the encode-only step behind ``/v1/embeddings``) on 16
   inputs of 17..2,000 tokens from seed 0: unit norms, two calls bitwise
   equal, each input alone against the same input in its batch and the
   batch against the plain f32 ``encode_forward`` on f32 copies of the
   parameters (1 - cos within 1e-3 and 1.5e-4), two planted faults on
   the f32 reference (pad rows pooled, last token dropped) read above
   1.5e-4; time per call, prompt tokens/s, the device's busy share; then 8 embed calls interleaved with
   phase 3's traffic (their vectors within 1e-3 of quiet calls', streams
   held to the parity rule against phase 3's, no graph captured after
   warm-up);

16. serve images (``[mm]`` lines), after phase 15, on phase 3's engine
   with the JAX package's vision encoder config at 224 px / 14 px patches
   (256 placeholders x 2,048): the encoder on the card against its f32
   plain version on the CPU (1e-4); prompts of 400 text tokens, one image
   and 20 more, spliced by ``MultimodalProcessor`` (content-addressed hash
   ids): image A (across the 512-token chunk boundary: 2 mm prefill
   chunks) and A again held to the parity rule against the same prompt
   prefilled in one chunk (budget 1,024, an engine sharing the weights,
   built while images encode on another thread); A again hits every full
   block, image B and the text-only prompt only the 400 text tokens; B's
   stream differs from A's; TTFT with the image against text-only at 676
   tokens; images encoded on their own thread while phase 3's traffic
   runs (streams against phase 3's); encode and ``content_token`` ms per
   image. Then, after phase 5, through processes: the store, ``python -m
   dynamo_tpu_torch.multimodal --model-dim 2048 --image-size 224
   --patch-size 14``, a worker with ``--model 1b --mm-encode-component
   encoder`` and the frontend: ``POST /v1/embeddings`` with a string and
   with token arrays (200, ``usage.prompt_tokens``, vectors against phase
   3's engine within 1e-3), after a warm-up chat with a third image,
   chats carrying ``.npy`` data URLs (image A, A again, B) and a
   text-only chat stream to ``[DONE]`` with their TTFTs and the texts
   phase 3's engine gives for the same bodies in this process, the
   frontend holds no GPU, and each process exits 0 on SIGTERM (the
   encoder after 4 images, the worker having launched both faces and run
   as many mm prefill chunks and prefix-hit blocks as phase 3's engine on
   the same bodies). Child logs in ``build/dist/epd_*.log``.

17. tensor- and expert-parallel serving (``[tp]`` lines), two ranks on
   the one card over gloo (``DYNTPU_DIST_BACKEND=gloo``; NCCL takes one
   device per rank): after phase 9, a ``--mesh 1,2`` worker (rank 0 starts
   rank 1 itself) loads phase 9's Llama-3.2-1B checkpoint through
   ``load_hf_params_sharded`` behind the store and the frontend; phase 3's
   traffic through the frontend over HTTP (TTFT, ITL, tok/s of a
   correctness run, not a tensor-parallel speed) and through the
   ``generate`` endpoint (streams held to the parity rule against phase
   3's one-rank engine on the same weights); each rank's launches of both
   faces, the follower's plans (equal to the leader's) and the
   all_reduce calls and bytes per step from the ranks' exit lines. After
   phase 8, Mixtral-8x7B at full width cut to 4 of 32 layers: each
   rank's ``moe_ffn`` at its 4 experts timed and its partials summed
   against the one-rank output, a checkpoint written (free disk checked),
   served one-rank in this process and by a ``--mesh 1,2`` worker with
   the experts over tp, both on the synchronous loop, one request at a
   time, streams held to the parity rule. Phase 2 holds both faces at one
   rank's shard shapes (16 query / 4 KV heads at head dim 64 and 128)
   against their plain versions. Child logs in ``build/dist/tp_*.log``.

18. sequence-parallel (ring) prefill (``[sp]`` lines), ranks spawned by
   the script itself on the one card over gloo, after phase 17: (a)
   Llama-3.2-1B at full width and depth, bf16, random weights from seed
   0, mesh (2, 1), ``sp_prefill_threshold`` 2,048: 4 prompts of ISL 8,128
   (each one 8,192-token sp chunk: T split over the two dp rows, exact
   ring attention over them) with OSL 64, one at a time, then phase 3's
   traffic (which stays on the chunked path, replicated over dp); streams
   under the parity rule against a one-rank engine with chunked prefill on
   the same weights; sp prefills per rank (4 each), the followers' plans
   (``rsp`` among them) equal to the leader's, ring hops, bytes and
   host-staged bytes per sp prefill, each rank's peak device memory in its
   sp prefills beside the one-rank engine's in one 8,192-token chunk, TTFT
   beside the chunked one (a correctness run), and both faces launched on
   both ranks. (c) ``ring_attention`` and ``ulysses_attention`` on the two
   ranks at one 1B layer's attention (32 / 8 heads, hd 64, T 8,192, bf16
   in, causal) against the plain ``_full_attention``, with their times and
   one ring hop's, each output within two bf16 ulps of the plain one
   (``SP_ATTN_RTOL``); then which gloo collectives take CUDA tensors: the
   script fails if one that ``parallel/comm.py`` hands CUDA tensors
   (``GLOO_CUDA_OPS``) refuses them, and reports send/recv, which
   ``comm.ppermute`` stages through the host. (b) mesh (2, 2): four ranks
   at full width cut to 4 of 16 layers, one prompt of ISL 8,128 against
   its one-rank run. (d) beside (b): mesh (1, 2) at full depth, one prompt
   of ISL 8,128 (OSL 16) as one sp chunk on both tp ranks: each rank's
   peak rise in the sp prefill beside the one-rank chunk's, and the
   stream under the parity rule.
   Child logs in ``build/dist/sp_*.log``.

19. pipeline-parallel serving (``[pp]`` lines), two stages on the one
   card over gloo, after phase 17: a ``--pp 2`` worker (rank 0 starts
   rank 1 itself) serves phase 9's Llama-3.2-1B checkpoint at full width
   and depth, 8 layers a stage (each rank reads only its layers), behind
   the store and the frontend. 8 concurrent greedy requests of ISL 512,
   OSL 32 over HTTP (TTFT, ITL, tok/s of a correctness run, not a
   pipeline speed) and through the ``generate`` endpoint (streams held to
   the parity rule against phase 3's one-rank engine, cut to 32 tokens);
   from the stages' exit lines: both faces launched on each stage, the
   follower's ``p``/``d`` plans equal to the leader's, ``ppermute`` hops
   (one per microbatch: one per prefill chunk, 4 per decode step; stage 0
   sends, stage 1 receives), bytes and host-staged bytes per step, and
   each stage's parameter and cache bytes against the
   one-rank engine's (about 0.61 and exactly 0.5). Child logs in
   ``build/dist/pp_*.log``.

20. the single-rank paths on multi-rank workers (``[mesh]`` lines), after
   phase 19, on phase 9's checkpoint, two ranks on the one card over gloo:
   (a) a ``--mesh 1,2 --disagg-mode prefill`` worker hands its KV (every
   head, joined on the leader by ``kv_gather``) over the host relay to a
   one-rank ``--disagg-mode decode`` worker: 8 concurrent greedy requests
   of ISL 512, OSL 32 over HTTP (TTFT, ITL, tok/s), the same through the
   ``generate`` endpoint under the parity rule against phase 3's one-rank
   engine, handoffs, MB per handoff, the head gather's calls, bytes and ms
   on each rank; (b) 16 ``/v1/embeddings`` inputs through a ``--mesh 1,2
   --mm-encoder --kvbm-host-blocks`` worker against phase 3's engine's
   vectors (1 - cos), ms per call, ``emb`` plans; (c) two image prompts
   through its ``generate`` endpoint under the parity rule against phase
   3's engine (``mesh_reference``, taken before phase 17) and two image
   chats over HTTP through its colocated encoder: ``mrp`` plans on each
   rank, MB of embeddings delivered per plan, TTFT; (d) its KVBM host
   tier: 4 prompts, G1 cleared, again: second-pass onboarded blocks,
   prefix hits, TTFT; (e) a ``--pp 2`` worker's embeddings of the same
   inputs. Each rank's exit line: the follower's plans equal to the
   leader's, the same collectives, both faces launched on each rank of
   the mesh workers. Child logs in ``build/dist/mesh_*.log``.

21. the 3-D ``(dp, fsdp, tp)`` mesh and ``--mesh`` on the launchers
   (``[fsdp]`` lines), after phase 18, ranks on the one card over gloo,
   random weights from seed 0: (a) mesh (1, 2, 1), Llama-3.2-1B at full
   width and depth, bf16: 4 of phase 3's prompts concurrently (OSL 8),
   then one of ISL 4,096 (OSL 8) as one sp chunk over the fsdp pair;
   parameter bytes stored per rank against one rank's (0.500–0.505), the
   streams under the parity rule against a one-rank engine, the bytes each
   rank sends through gloo per step (``fsdp_gather``) and the host ms
   blocked in it, ITL p50, the peak rise over the run, both faces launched
   on both ranks. (b) mesh (1, 2, 2), four ranks at 2 of 16 layers,
   against mesh (1, 2) at that depth, both on the synchronous loop: every
   stream identical (the gathered weights are (1, 2)'s slices). (c) beside
   (b): ``python -m dynamo_tpu_torch.run in=batch out=engine --model 1b
   --mesh 1,2`` on (a)'s prompts against ``--mesh 1,1`` and the parity
   rule, each rank's exit line. (d) beside (b) and (c): ``python -m
   dynamo_tpu_torch.planner.profiler --model 1b --mesh 1,2`` (ISL 512,
   batch 8 at ctx 512): the profile's keys, ``meta.mesh`` [1, 2], tok/s
   per chip over 2. Child logs in ``build/dist/fsdp_*.log`` and
   ``build/dist/sp_{fsdp,1x2,1x2x2}_rank*.log``.

``[time]`` lines give each phase's time. The line before the last is the
card's ``nvidia-smi`` name and power limit, the line before that the
``kernels`` JSON object (launches include those that graph replays made;
after the kernel builds come the ragged face at the spec-verify shape,
launched by the spec run's verify windows, and both faces at Mixtral's
head dim 128, launched by phase 8's run; each kernel build's row also
carries ``launches_profile``, ``launches_replay``, ``launches_embed`` and
``launches_mm``, the counts of phases 10, 11, 15 (the traffic with embed
calls interleaved) and 16 (the image prompts A, A again, B and text-only);
rows named ``...@tuned_<class>`` are phase 12's winning launch parameters,
each with its ``launch``; rows named ``...@tp2_shard_hd<64|128>`` are
both faces at phase 17's shard shapes, with ``launches_per_rank`` of the
2-rank Llama-3.2-1B and Mixtral runs; every kernel build's row carries
``launches_sp`` and ``launches_sp_2x2``, phase 18's (a) and (b) summed
over their ranks — the ring is plain PyTorch, not a kernel, and has no
row — and ``launches_pp``, phase 19's summed over its two stages; the
row ``paged_attention_decode@pp2_stage`` is the decode face at a pp
stage's microbatch shape, with phase 19's ``launches_per_rank``; every
kernel build's row carries ``launches_mesh``, phase 20's two mesh workers
summed over their ranks, and the rows ``...@mesh_tp2_b8`` (decode) and
``...@mesh_tp2_chunks`` (ragged) hold both faces at the tp-2 shapes
phase 20 adds to phase 17's, with its ``launches_per_rank``; every
kernel build's row carries ``launches_sp_1x2``, phase 18 (d)'s, and
``launches_fsdp``, phase 21's (a) and (b) summed over their ranks, and
the rows ``...@fsdp_b8`` and ``...@fsdp_chunks`` (phase 21 (a), one
rank's heads), ``...@fsdp_tp2_b8`` and ``...@fsdp_tp2_chunks`` ((b), a
tp-2 rank's) and ``paged_attention_decode@sp_1x2_b8`` (phase 18 (d)) hold
the faces at the shapes those parts give them, each with its
``launches_per_rank`` and ``held_cases``, the phase-2 cases of those
shapes);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, published
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# kernel vs plain, (atol, rtol) per dtype. bf16: the ragged face rounds P
# to bf16 before PV (as the einsum path and the JAX package's bf16 path do),
# so each term of PV carries a relative error <= 2^-9 while the sums stay in
# f32; the output then rounds once to bf16, in another summation order than
# the plain version's, and may land on the neighbouring bf16 value: 2^-7
# relative (~0.008 at |o| ~ 1, ~0.016 at 2 <= |o| < 4). The decode face
# keeps p in f32. f32: only the summation order differs.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 0.0)}
SEED = 0
DEV = "cuda"
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DECODE_CASE = "main path decode B=16 ctx 513..576 W=512"
PREFILL_CASE = "main path prefill R=1 T=512 q_len=512 ctx 512 W=32"
# the spec engine's verify window: 16 rows of k + 1 = 5 queries over ~560
# keys, the ragged face at a shape the decode graphs never give it
SPEC_CASE = "spec verify R=16 q_len=5 ctx 518..581 W=512"
SPEC_ROWS = [(5, 518 + (37 * i) % 64, 5) for i in range(16)]
# the [moe] phase's serving shapes: Mixtral's attention (32 query / 8 KV
# heads at head dim 128) at the decode window's and prefill chunk's shapes
MOE_DECODE_CASE = "mixtral decode hd=128 B=16 ctx 513..576 W=512"
MOE_PREFILL_CASE = "mixtral prefill hd=128 R=1 T=512 ctx 512 W=32"
# phase 17's shapes: one rank's heads at tp 2 (16 query / 4 KV heads) of
# Llama-3.2-1B (hd 64) and Mixtral-8x7B (hd 128)
TP_CASES = {
    ("decode", 64): "tp2 shard decode 16/4 heads hd=64 B=16 ctx 513..576 "
                    "W=512",
    ("ragged", 64): "tp2 shard prefill 16/4 heads hd=64 R=1 T=512 W=32",
    ("decode", 128): "tp2 shard decode 16/4 heads hd=128 B=16 ctx 513..576 "
                     "W=512",
    ("ragged", 128): "tp2 shard prefill 16/4 heads hd=128 R=1 T=512 W=32",
}
# phase 19's decode shape: one microbatch of a --pp 2 stage (a decode
# bucket of 8 over pp_microbatches 4) at ISL 512 + OSL 32, a table
# bucketed to 64 blocks; its prefill chunk is PREFILL_CASE's shape
PP_DECODE_CASE = "pp2 stage decode B=2 ctx 513..544 W=64"
# phase 20's shapes on a tp-2 rank (16 query / 4 KV heads, hd 64) that
# phase 17's do not give: the aggregated --mesh 1,2 worker decodes at most
# 4 live rows (the KVBM passes), in the smallest decode bucket, 8; its
# first image prompt (300 text tokens, 256 image placeholders, 20 more)
# continues with a 64-token chunk after 512 keys, its second (200 + 256 +
# 20) is one chunk of 476 in a bucket of 512, and the KVBM second pass
# prefills the 16 tokens after 496 onboarded keys
MESH_DECODE_CASE = "tp2 shard decode 16/4 heads hd=64 B=8 ctx 513..604 W=512"
MESH_RAGGED_CASES = (
    ("tp2 shard prefill 16/4 heads hd=64 q_len=64 after 512 keys W=64",
     [(64, 576, 64)], 64),
    ("tp2 shard prefill 16/4 heads hd=64 q_len=476 of T=512 W=32",
     [(476, 476, 512)], 32),
    ("tp2 shard prefill 16/4 heads hd=64 q_len=16 after 496 keys W=32",
     [(16, 512, 16)], 32),
)
# phase 21's shapes, and phase 18 (d)'s, that no case above gives. (a) (one
# rank's 32 / 8 heads) and (b) (a tp-2 rank's 16 / 4) serve 4 prompts of
# ISL 512 at once, so each decode window holds 1 to 4 live rows of the
# bucket of 8 at ctx 513..519 (2 apart), and each prefill chunk is a
# prompt's first 509..512 tokens (the chunk's budget less the live decode
# rows, one row of a 512-token chunk) or its last 1..3 (one row of a
# 16-token chunk after 509..511 keys); (a)'s 4,096-token prompt then
# decodes alone at ctx 4,097..4,103, and phase 18 (d)'s 8,128-token prompt
# on a tp-2 rank at ctx 8,129..8,143 (their sp prefills are the ring, no
# kernel). Each decode case holds the widest context of its range.
# prefix -> KV heads of (a)'s and (b)'s ranks
FSDP_HEADS = {"fsdp": 8, "fsdp tp2 shard 16/4 heads": 4}
FSDP_DECODE = ("decode B=8 ctx 513..519, 4 dead rows W=512",
               [(1, 519 - 2 * i, 1) for i in range(4)] + [(0, 0, 1)] * 4)
FSDP_RAGGED = (("prefill R=1 q_len=509 of T=512 W=32", [(509, 509, 512)]),
               ("prefill R=1 q_len=3 after 509 keys T=16 W=32",
                [(3, 512, 16)]))
FSDP_LONG_DECODE_CASE = "fsdp decode B=8 ctx 4103, 7 dead rows W=512"
SP_1X2_DECODE_CASE = ("tp2 shard decode 16/4 heads hd=64 B=8 ctx 8143, 7 "
                      "dead rows W=512")
# the kernels line's rows at the shapes one part of a multi-rank phase
# gives a kernel: tag -> (kernel, the phase-2 cases of those shapes); each
# row carries that part's launches per rank
HELD_ROWS = {
    # phase 20: every decode in the bucket of 8, and the image prompts'
    # and the KVBM pass's chunks (the face's phase-20 launches also
    # include the 512-token chunks of the @tp2_shard_hd64 ragged row)
    "mesh_tp2_b8": ("paged_attention_decode",
                    (MESH_DECODE_CASE, f"{MESH_DECODE_CASE}, 4 dead rows")),
    "mesh_tp2_chunks": ("paged_attention_ragged",
                        tuple(case for case, _, _ in MESH_RAGGED_CASES)),
    # phase 21 (a), (b) and phase 18 (d)
    "fsdp_b8": ("paged_attention_decode",
                (f"fsdp {FSDP_DECODE[0]}", FSDP_LONG_DECODE_CASE)),
    "fsdp_chunks": ("paged_attention_ragged",
                    (PREFILL_CASE, *(f"fsdp {n}" for n, _ in FSDP_RAGGED))),
    "fsdp_tp2_b8": ("paged_attention_decode",
                    (f"fsdp tp2 shard 16/4 heads {FSDP_DECODE[0]}",)),
    "fsdp_tp2_chunks": ("paged_attention_ragged",
                        (TP_CASES[("ragged", 64)],
                         *(f"fsdp tp2 shard 16/4 heads {n}"
                           for n, _ in FSDP_RAGGED))),
    "sp_1x2_b8": ("paged_attention_decode", (SP_1X2_DECODE_CASE,)),
}


# ------------------------------ phase 1 ----------------------------------


def phase_build() -> None:
    from dynamo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"[build] {len(took)} source(s) in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in took.items()), flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")


# ------------------------------ phase 2 ----------------------------------


def make_case(name, rows, *, W, face, bs=16, KV=8, G=4, hd=64, seed=SEED,
              dtype="bfloat16", kv_dtype=None):
    """A case on the card (bf16 unless ``dtype`` says otherwise).
    ``rows`` = [(q_len, ctx_len, allotment)].
    Each row's blocks are distinct and drawn at random from the pool; block
    0 (trash) and every table entry past a row's context are NaN-filled
    pages, so a key read past ctx_len would poison the output. With
    ``kv_dtype`` ("int8" | "fp8") the pages are quantized per (slot, head)
    by the port's ``kv_quantize``, and the poisoned slots get NaN scales
    (and, for fp8, NaN pages: int8 has no NaN)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    H = KV * G
    q_start = [0]
    for _, _, alloc in rows:
        q_start.append(q_start[-1] + alloc)
    Tq = q_start[-1]
    need = [-(-cl // bs) for _, cl, _ in rows]
    nb = 2 + sum(need)
    perm = torch.randperm(nb - 2, generator=gen, device=DEV) + 1
    nan_block = nb - 1
    tables = torch.full((len(rows), W), nan_block, dtype=torch.int32,
                        device=DEV)
    off = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[off:off + n].to(torch.int32)
        off += n
        if n < W:
            tables[r, -1] = 0  # a stale tail on the trash block itself
    kw = dict(generator=gen, device=DEV, dtype=torch.float32)
    dt = getattr(torch, dtype)
    q = torch.randn(Tq, H, hd, **kw).to(dt)
    k = torch.randn(nb, KV, bs, hd, **kw).to(dt)
    v = torch.randn(nb, KV, bs, hd, **kw).to(dt)
    scales = {}
    if kv_dtype is not None:
        from dynamo_tpu_torch.engine import quant

        for key, cache in (("k", k), ("v", v)):
            pages, sc = quant.kv_quantize(cache.reshape(-1, 1, hd), kv_dtype)
            scales[key] = sc.reshape(nb, KV, bs).contiguous()
            if key == "k":
                k = pages.reshape(nb, KV, bs, hd)
            else:
                v = pages.reshape(nb, KV, bs, hd)
    for key, cache in (("k", k), ("v", v)):
        # poisoned slots: [block] or [block, :, offset:]
        poison = [(0,), (nan_block,)] + [
            (tables[r, cl // bs].item(), slice(None), slice(cl % bs, None))
            for r, (_, cl, _) in enumerate(rows) if cl % bs]
        for idx in poison:
            if kv_dtype is None:
                cache[idx] = float("nan")
                continue
            scales[key][idx] = float("nan")
            if kv_dtype == "fp8":
                cache.view(torch.uint8)[idx] = 0x7F  # e4m3fn NaN
    i32 = dict(dtype=torch.int32, device=DEV)
    lib_kv = {}
    if kv_dtype is not None:  # the library call's dequantized bf16 pages
        from dynamo_tpu_torch.engine import quant

        lib_kv = {key: quant.kv_dequantize(pages, scales[key], dt)
                  for key, pages in (("k", k), ("v", v))}
    return dict(
        name=name, face=face, bs=bs, W=W, H=H, KV=KV, hd=hd, dtype=dtype,
        kv_dtype=kv_dtype, k_scale=scales.get("k"), v_scale=scales.get("v"),
        lib_k=lib_kv.get("k", k), lib_v=lib_kv.get("v", v),
        q=q, k=k, v=v, tables=tables,
        q_start=torch.tensor(q_start, **i32),
        q_len=torch.tensor([r[0] for r in rows], **i32),
        ctx_len=torch.tensor([r[1] for r in rows], **i32),
        rows=rows, max_q_len=max(r[2] for r in rows),
    )


def case_bound(c):
    """Least time on an H100 for this call's work, counting what its data
    needs: live queries read once, each row's visible K/V pages once per KV
    head (quantized: 1 byte per element plus a 4-byte scale per slot and
    head), the output written once; 4 flops per (query head, visible key,
    dim) (QK^T and PV) at the card's peak for the query's type."""
    H, KV, hd = c["H"], c["KV"], c["hd"]
    es = c["q"].element_size()
    # bytes per (slot, KV head) of one of K or V
    slot_bytes = hd * c["k"].element_size() + (
        4 if c["kv_dtype"] is not None else 0)
    nbytes = c["q"].shape[0] * H * hd * es  # the output
    flops = 0
    for ql, cl, _ in c["rows"]:
        if ql == 0:
            continue
        nbytes += ql * H * hd * es + cl * KV * slot_bytes * 2
        # query i sees cl - ql + i + 1 keys
        seen = ql * (cl - ql) + ql * (ql + 1) // 2
        flops += 4 * seen * H * hd
    nbytes += c["tables"].numel() * 4 + 3 * len(c["rows"]) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if c["dtype"] == "bfloat16" else F32_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def run_face(c, plain: bool):
    from dynamo_tpu_torch.ops import paged_attention as pa

    sc = dict(k_scale=c["k_scale"], v_scale=c["v_scale"])
    if c["face"] == "decode":
        if plain:
            return pa.paged_attention_ragged_plain(
                c["q"], c["k"], c["v"], c["tables"], c["q_start"],
                c["q_len"], c["ctx_len"], block_size=c["bs"], max_q_len=1,
                **sc)
        return pa.paged_attention_decode(
            c["q"], c["k"], c["v"], c["tables"], c["ctx_len"],
            block_size=c["bs"], **sc, **c.get("launch", {}))
    if plain:
        return pa.paged_attention_ragged_plain(
            c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
            c["ctx_len"], block_size=c["bs"], max_q_len=c["max_q_len"], **sc)
    return pa.paged_attention_ragged(
        c["q"], c["k"], c["v"], c["tables"], c["q_start"], c["q_len"],
        c["ctx_len"], block_size=c["bs"], max_q_len=c["max_q_len"], **sc,
        **c.get("launch", {}))


def library_call(c):
    """``scaled_dot_product_attention`` over K/V gathered (and, for
    quantized pages, dequantized to bf16) beforehand, for a batch whose
    rows share one query count (None otherwise)."""
    import torch
    import torch.nn.functional as F

    qls = {ql for ql, _, _ in c["rows"]}
    if len(qls) != 1 and c["face"] != "decode":
        return None
    ql = 1 if c["face"] == "decode" else qls.pop()
    R = len(c["rows"])
    bs, KV, hd, H = c["bs"], c["KV"], c["hd"], c["H"]
    S = max(cl for _, cl, _ in c["rows"])
    nblk = -(-S // bs)
    tab = c["tables"][:, :nblk].long()
    k = c["lib_k"][tab].permute(0, 2, 1, 3, 4).reshape(R, KV, nblk * bs, hd)
    v = c["lib_v"][tab].permute(0, 2, 1, 3, 4).reshape(R, KV, nblk * bs, hd)
    k = torch.nan_to_num(k[:, :, :S]).contiguous()
    v = torch.nan_to_num(v[:, :, :S]).contiguous()
    q = torch.stack([
        c["q"][int(c["q_start"][r]):int(c["q_start"][r]) + ql]
        for r in range(R)
    ]).transpose(1, 2).contiguous()                      # [R, H, ql, hd]
    ctx = c["ctx_len"].long()
    kpos = torch.arange(S, device=DEV)
    qpos = (ctx[:, None] - ql) + torch.arange(ql, device=DEV)[None, :]
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < ctx[:, None, None])
    mask = mask[:, None]                                 # [R, 1, ql, S]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return call


def device_ms(fn, reps: int = 20) -> float:
    """Summed device time of the kernels one call of ``fn`` launches, mean
    over ``reps`` calls, from ``torch.profiler``. Before each call a 256 MB
    device-to-device copy evicts the 50 MB L2, as in serving, where a
    layer's K/V is cold; the copies are not counted."""
    import torch
    from torch.autograd import DeviceType

    src = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()

    def body():
        dst.copy_(src)
        fn()
    events = profile_calls(body, reps, cpu=False)
    if events is None:  # CUDA events around each call, after its copy
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in marks:
            dst.copy_(src)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in marks) / reps
    return sum(_device_us(e) for e in events
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))) / reps / 1e3


def profile_calls(body, reps: int, cpu: bool = True):
    """``key_averages()`` of ``torch.profiler`` around ``reps`` calls of
    ``body``. A profile now and then comes back without device events:
    the first of three that has them is taken. If none has, None: the
    caller then times by CUDA events or reports the figure as not
    measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(_device_us(e) > 0 for e in events
               if e.device_type == DeviceType.CUDA):
            return events
    print("[profiler] torch.profiler recorded no device time in three "
          "profiles", flush=True)
    return None


def main_cases(kv_dtype=None):
    """The shapes the engine phase gives the kernel: decode bucket 16 over
    the full autopilot table (max_model_len 8192 / bs 16), one 512-token
    prefill chunk of a fresh prompt, and the spec engine's verify window."""
    sfx = "" if kv_dtype is None else f" {kv_dtype}"
    return [
        make_case(DECODE_CASE + sfx,
                  [(1, 513 + (37 * i) % 64, 1) for i in range(16)],
                  W=512, face="decode", kv_dtype=kv_dtype),
        make_case(PREFILL_CASE + sfx, [(512, 512, 512)], W=32,
                  face="ragged", kv_dtype=kv_dtype),
        make_case(SPEC_CASE + sfx, SPEC_ROWS, W=512, face="ragged",
                  kv_dtype=kv_dtype),
    ]


def kernel_cases():
    import torch

    gen = torch.Generator().manual_seed(SEED)
    lens = torch.randint(1, 1025, (64,), generator=gen).tolist()
    for dead in (3, 17, 40, 63):
        lens[dead] = 0
    # long contexts: 16 rows over 4,000-8,192 keys, one row at ctx 1 and
    # one dead row (many splits, empty splits, a one-key split)
    long_lens = [4000 + (4192 * i) // 15 for i in range(16)]
    long_lens[5], long_lens[11] = 1, 0
    long_rows = [(1 if n else 0, n, 1) for n in long_lens]
    cases = [
        make_case("decode B=64 ctx 1..1024, 4 dead rows",
                  [(1 if n else 0, n, 1) for n in lens], W=66,
                  face="decode"),
        make_case("ragged R=1 T=512 q_len=300 prior ctx 0",
                  [(300, 300, 512)], W=64, face="ragged"),
        make_case("ragged R=1 T=512 q_len=300 prior ctx 512",
                  [(300, 812, 512)], W=64, face="ragged"),
        make_case("ragged mixed R=6",
                  [(1, 577, 1), (5, 40, 8), (64, 64, 64), (0, 0, 8),
                   (130, 1000, 136), (17, 17, 24)], W=66, face="ragged"),
        *main_cases(),
        make_case(MOE_DECODE_CASE,
                  [(1, 513 + (37 * i) % 64, 1) for i in range(16)],
                  W=512, face="decode", hd=128),
        make_case(MOE_PREFILL_CASE, [(512, 512, 512)], W=32, face="ragged",
                  hd=128),
        *(make_case(name, [(1, 513 + (37 * i) % 64, 1) for i in range(16)],
                    W=512, face="decode", KV=4, hd=hd)
          if face == "decode" else
          make_case(name, [(512, 512, 512)], W=32, face="ragged", KV=4,
                    hd=hd)
          for (face, hd), name in TP_CASES.items()),
        make_case(MESH_DECODE_CASE, [(1, 513 + 13 * i, 1) for i in range(8)],
                  W=512, face="decode", KV=4),
        # the KVBM passes' batch: 4 live rows, 4 dead
        make_case(f"{MESH_DECODE_CASE}, 4 dead rows",
                  [(1, 513 + 29 * i, 1) for i in range(4)] + [(0, 0, 1)] * 4,
                  W=512, face="decode", KV=4),
        *(make_case(name, rows, W=W, face="ragged", KV=4)
          for name, rows, W in MESH_RAGGED_CASES),
        *(make_case(f"{prefix} {FSDP_DECODE[0]}", FSDP_DECODE[1], W=512,
                    face="decode", KV=KV)
          for prefix, KV in FSDP_HEADS.items()),
        *(make_case(f"{prefix} {name}", rows, W=32, face="ragged", KV=KV)
          for prefix, KV in FSDP_HEADS.items()
          for name, rows in FSDP_RAGGED),
        make_case(FSDP_LONG_DECODE_CASE, [(1, 4103, 1)] + [(0, 0, 1)] * 7,
                  W=512, face="decode"),
        make_case(SP_1X2_DECODE_CASE, [(1, 8143, 1)] + [(0, 0, 1)] * 7,
                  W=512, face="decode", KV=4),
        make_case(PP_DECODE_CASE, [(1, 513, 1), (1, 544, 1)], W=64,
                  face="decode"),
        # a microbatch with a pad row (position -1: a dead row)
        make_case(f"{PP_DECODE_CASE}, 1 dead row", [(1, 530, 1), (0, 0, 1)],
                  W=64, face="decode"),
        # the kernels' other builds: head dim 128 (Llama-3-8B heads) and f32
        make_case("ragged mixed hd=128 R=3",
                  [(1, 300, 1), (40, 240, 48), (0, 0, 8)], W=20,
                  face="ragged", hd=128),
        make_case("decode hd=128 B=4 ctx 1..300, 1 dead row",
                  [(1, 300, 1), (1, 1, 1), (0, 0, 1), (1, 129, 1)], W=20,
                  face="decode", hd=128),
        make_case("ragged mixed f32 R=3",
                  [(1, 300, 1), (40, 240, 48), (0, 0, 8)], W=20,
                  face="ragged", dtype="float32"),
        make_case("decode f32 B=4 ctx 1..300, 1 dead row",
                  [(1, 300, 1), (1, 1, 1), (0, 0, 1), (1, 129, 1)], W=20,
                  face="decode", dtype="float32"),
    ]
    for kv in (None, "int8"):
        sfx = "" if kv is None else f" {kv}"
        cases += [
            make_case(f"decode B=16 ctx 4000..8192, ctx 1 + dead row, "
                      f"W=512{sfx}", long_rows, W=512, face="decode",
                      kv_dtype=kv),
            # a 512-token chunk of a long prompt
            make_case(f"ragged R=1 q_len=512 after 3584 keys, W=256{sfx}",
                      [(512, 4096, 512)], W=256, face="ragged",
                      kv_dtype=kv),
        ]
    # the quantized-KV branch: the main path's two shapes and a mixed
    # ragged batch (stale tails, dead rows, NaN trash scales and pages)
    for kv in ("int8", "fp8"):
        cases += main_cases(kv) + [
            make_case(f"ragged mixed R=6 {kv}",
                      [(1, 577, 1), (5, 40, 8), (64, 64, 64), (0, 0, 8),
                       (130, 1000, 136), (17, 17, 24)], W=66,
                      face="ragged", kv_dtype=kv),
        ]
    by_name = {c["name"]: c for c in cases}
    return cases + [launched(by_name[base], launch)
                    for base, launch in LAUNCH_CASES]


# non-default launch parameters (engine/autotune.py's candidates) on the
# main path's cases: a q_tile below the default (16 query slots of G = 4
# at T = 512, 5 at the spec shape), the kv_chunk the page dtype does not
# take by default, and the decode face's extreme split counts (1, and the
# 128 spans of a 512-block table)
LAUNCH_CASES = [
    (PREFILL_CASE, {"q_tile": 8}), (PREFILL_CASE, {"kv_chunk": 128}),
    (SPEC_CASE, {"q_tile": 1}), (SPEC_CASE, {"kv_chunk": 128}),
    (DECODE_CASE, {"n_split": 1}), (DECODE_CASE, {"n_split": 128}),
    ("ragged mixed R=6", {"q_tile": 4, "kv_chunk": 128}),
    (MOE_PREFILL_CASE, {"kv_chunk": 128}),
    (MOE_DECODE_CASE, {"n_split": 1}),
    ("ragged mixed f32 R=3", {"q_tile": 2}),
    ("decode f32 B=4 ctx 1..300, 1 dead row", {"n_split": 5}),
]
for _kv in ("int8", "fp8"):
    LAUNCH_CASES += [
        (f"{PREFILL_CASE} {_kv}", {"q_tile": 8, "kv_chunk": 64}),
        (f"{SPEC_CASE} {_kv}", {"q_tile": 1}),
        (f"{DECODE_CASE} {_kv}", {"n_split": 1}),
        (f"{DECODE_CASE} {_kv}", {"n_split": 128}),
        (f"ragged mixed R=6 {_kv}", {"kv_chunk": 64}),
    ]


def launched(c, launch: dict):
    """Case ``c`` (same tensors) at non-default launch parameters."""
    desc = " ".join(f"{k}={v}" for k, v in launch.items())
    return dict(c, name=f"{c['name']} [{desc}]", launch=launch)


def check_default_launch(cases) -> None:
    """Launch parameters of 0 must launch exactly what a call without them
    launches: bitwise the same output, on every base case."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa

    n = 0
    for c in cases:
        if "launch" in c:
            continue
        zeros = {"n_split": 0} if c["face"] == "decode" else \
            {"q_tile": 0, "kv_chunk": 0}
        want = run_face(c, plain=False)
        got = run_face(dict(c, launch=zeros), plain=False)
        torch.cuda.synchronize()
        if not torch.equal(want.view(torch.uint8), got.view(torch.uint8)):
            fail(f"{c['name']}: launch parameters (0, 0) do not launch what "
                 "a call without them launches")
        n += 1
    dev = torch.device(DEV)
    n_split, _ = pa._decode_grid(16, 8, 512, 16, pa._sm_count(dev),
                                 pa._blocks_per_sm(dev, 32, 8, 64, 1, 0))
    print(f"[kernel] launch parameters (0, 0) bitwise equal to the call "
          f"without them on {n} cases; the decode face's default n_split "
          f"at the main path's B=16, W=512 (bf16): {n_split}", flush=True)


def check_case(c):
    """Kernel vs plain on the card: finite, within TOL, exact zeros past
    q_len and on dead rows. Returns max |kernel - plain|."""
    import torch

    got = run_face(c, plain=False)
    torch.cuda.synchronize()
    want = run_face(c, plain=True)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{c['name']}: kernel output not finite (trash leak)")
    atol, rtol = TOL[c["dtype"]]
    err = (got.float() - want.float()).abs()
    excess = (err - rtol * want.float().abs()).max().item()
    max_err = err.max().item()
    if excess > atol:
        fail(f"{c['name']}: max |kernel - plain| {max_err} "
             f"(atol {atol} + rtol {rtol})")
    # rows and slots with no valid query must be exact zeros
    q_start = c["q_start"].tolist()
    for r, (ql, _, alloc) in enumerate(c["rows"]):
        tail = got[q_start[r] + ql:q_start[r] + alloc]
        if tail.numel() and not torch.all(tail == 0):
            fail(f"{c['name']}: row {r} slots past q_len not zero")
    return max_err


def phase_kernels(cases):
    results = {}
    for c in cases:
        max_err = check_case(c)
        ms = device_ms(lambda: run_face(c, plain=False))
        wall_ms = cuda_ms(lambda: run_face(c, plain=False), iters=50)
        plain_ms = cuda_ms(lambda: run_face(c, plain=True), iters=5,
                           warmup=1)
        lib = library_call(c)
        lib_ms = device_ms(lib) if lib is not None else None
        lib_wall = cuda_ms(lib, iters=50) if lib is not None else None
        bound_ms, bound_by = case_bound(c)
        results[c["name"]] = dict(
            face=c["face"], dtype=c["dtype"], kv_dtype=c["kv_dtype"],
            launch=c.get("launch"),
            max_abs_err=max_err, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_wall_ms=lib_wall, bound_ms=bound_ms,
            bound_by=bound_by,
        )
        sdpa = ("n/a" if lib_ms is None else
                f"{lib_ms:.4f} ms (wall per call {lib_wall:.4f} ms)")
        print(f"[kernel] {c['name']}: max_abs_err {max_err:.3e} kernel "
              f"{ms:.4f} ms (wall per call {wall_ms:.4f} ms) plain "
              f"{plain_ms:.4f} ms sdpa {sdpa} bound {bound_ms:.5f} ms "
              f"({bound_by})", flush=True)
    return results


# ------------------------------ phase 3 ----------------------------------

N_REQUESTS, ISL, OSL = 16, 512, 64
# kernel path vs einsum path logits on one probe prompt, both bf16: both
# round softmax probabilities to bf16 before P@V (as the JAX reference
# does), but sum in other orders and the kernel rounds after scaling by the
# running max, so the two drift by bf16 rounding through 16 layers; random-weight logits are ~N(0, 1) and the
# top two of 128256 sit ~0.2 apart
PROBE_MAX_DIFF, PROBE_MIN_ARGMAX_AGREE = 0.5, 0.75
# The MoE model's probe: the two paths' bf16 differences move a router logit
# by ~1e-2, and where a token's 2nd and 3rd experts sit closer than that the
# paths route it to different experts, which changes its hidden state by a
# whole expert's output (O(1) logits). So no |diff| bound holds; a kernel
# that computed garbage would agree on ~1/32000 of the argmaxes, a right one
# on most.
PROBE_MOE_MIN_ARGMAX_AGREE = 0.5
# run-ahead depths phase 3 serves at, in turns: the default (whose first
# run is the main path the kernels line counts), the synchronous loop, the
# default again
DEPTHS = (2, 1, 2)


def depth_stats(tag: str, cfg, outs, stamps, wall: float, obs: dict,
                n: dict) -> dict:
    """Check one phase-3 run's streams; print and return its TTFT, ITL,
    throughput, steady decode step, fetch syncs and flight-recorder
    gauges."""
    for i, out in enumerate(outs):
        if len(out) != OSL:
            fail(f"request {i} returned {len(out)} tokens, expected {OSL}")
        if not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"request {i} returned an out-of-range token id")
    ttft = sorted(times[0] - t_sub for t_sub, times in stamps)
    itl = [(times[-1] - times[0]) / (len(times) - 1)
           for _, times in stamps]
    last_first = max(times[0] for _, times in stamps)
    steady = sorted(b - a for _, times in stamps
                    for a, b in zip(times, times[1:]) if a >= last_first)
    n_out = sum(len(o) for o in outs)
    stats = dict(ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                 itl_p50=sorted(itl)[len(itl) // 2], tok_s=n_out / wall,
                 outs=outs)
    print(f"{tag} {N_REQUESTS} requests ISL {ISL} OSL {OSL} "
          f"in {wall:.3f} s: output {n_out / wall:.1f} tok/s, TTFT mean "
          f"{sum(ttft) / len(ttft) * 1e3:.1f} ms p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms, "
          f"ITL mean {sum(itl) / len(itl) * 1e3:.2f} ms p50 "
          f"{stats['itl_p50'] * 1e3:.2f} ms, decode step once every "
          f"prompt is in (p50) {steady[len(steady) // 2] * 1e3:.2f} ms, "
          f"{n['windows']} decode windows ({n['replays']} graph replays), "
          f"{n['prefills']} prefill dispatches, {n['syncs']} fetch syncs "
          f"for {n['steps']} landed batches "
          f"({n['syncs'] / max(1, n['steps']):.2f} per batch); flight "
          f"recorder: mfu_decode {obs['mfu_decode']:.5f} mfu_prefill "
          f"{obs['mfu_prefill']:.5f} mfu {obs['mfu']:.5f} goodput "
          f"{obs['goodput_tok_s']:.1f} tok/s over "
          f"{obs['window_s']:.2f} s", flush=True)
    return stats


def main_prompts(vocab: int):
    """Phase 3's traffic: N_REQUESTS random prompts of ISL tokens."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    return [torch.randint(1, vocab, (ISL,), generator=gen).tolist()
            for _ in range(N_REQUESTS)]


def phase_engine(card: str, dtype: str = "bf16", ref_logits=None,
                 cfg=None, depths=DEPTHS, label: str = "Llama-3.2-1B"):
    """Serve N_REQUESTS concurrent greedy requests through the engine API
    ``run.py in=batch`` uses, at full width of ``cfg`` (Llama-3.2-1B by
    default), with weights and KV in ``dtype`` ("bf16" | "int8" | "fp8"),
    at each run-ahead depth of ``depths``. Returns the kernel launch counts
    of the first run, the engine, the probe's kernel-path logits and the
    first run's TTFT/ITL/throughput; ``ref_logits`` (the bf16 run's) are
    compared with a quantized run's."""
    import asyncio

    import torch
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime.context import Context

    cfg = cfg or ModelConfig.llama3_1b()
    quant = dict(weight_dtype=dtype, kv_dtype=dtype)
    if cfg.is_moe:
        tag = "[moe]"
    else:
        tag = "[engine]" if dtype == "bf16" else f"[engine {dtype}/{dtype}]"
    t0 = time.perf_counter()
    # cuda by default; quantized weights are quantized from the same random
    # bf16 weights as the bf16 run's (same seed)
    engine = InferenceEngine(cfg, EngineConfig(**quant), seed=SEED)
    torch.cuda.synchronize()
    print(f"{tag} {label} random weights (seed {SEED}), weights and "
          f"KV {dtype}, on {engine.device} in "
          f"{time.perf_counter() - t0:.2f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    prompts = main_prompts(cfg.vocab_size)

    async def one(token_ids, max_tokens, stamps):
        req = {"token_ids": token_ids, "max_tokens": max_tokens,
               "temperature": 0.0}
        t_sub = time.perf_counter()
        out, times = [], []
        async for o in engine.generate(req, Context()):
            out.extend(o["token_ids"])
            times.append(time.perf_counter())
        stamps.append((t_sub, times))
        return out

    async def serve(depth):
        """One run of the traffic at run-ahead ``depth``, prefix cache
        cleared, recorder reset after a warm-up request."""
        engine.pipeline_depth = depth
        engine.clear_kv_blocks()
        await engine.start()
        warm = []  # first launches, cuBLAS handles: not measured
        await one(prompts[0][:32], 4, warm)
        torch.cuda.synchronize()
        engine.clear_kv_blocks()
        engine.mark_obs_warmup_done()
        pa.reset_launches()
        before = counters()
        stamps = []
        t_start = time.perf_counter()
        outs = await asyncio.gather(*(one(p, OSL, stamps) for p in prompts))
        wall = time.perf_counter() - t_start
        launches = dict(pa.LAUNCHES)
        obs = engine.obs_snapshot()
        await engine.stop()
        after = counters()
        return (outs, stamps, wall, launches, obs,
                {k: after[k] - before[k] for k in after})

    def counters():
        return dict(windows=engine.num_windows,
                    replays=engine._ap_window_fn.replays,
                    syncs=engine.num_fetch_syncs, steps=engine.num_steps,
                    prefills=engine.num_prefill_dispatches)

    graphs = engine._ap_window_fn
    print(f"{tag} {len(graphs.capture_s)} decode graphs captured at "
          f"construction (buckets {engine.config.decode_buckets} x "
          f"greedy/stochastic): {sum(graphs.capture_s.values()):.2f} s",
          flush=True)
    for i, depth in enumerate(depths):
        outs, stamps, wall, launches, obs, n = asyncio.run(serve(depth))
        stats = depth_stats(f"{tag} {card}: pipeline_depth={depth}:",
                            cfg, outs, stamps, wall, obs, n)
        if n["replays"] != n["windows"]:
            fail(f"{n['windows'] - n['replays']} decode windows ran "
                 f"eagerly on the card (depth {depth})")
        if engine.num_einsum_rebuilds:
            fail("the stall watchdog rebuilt the decode window on einsum")
        if i == 0:
            # the default depth's first run is the main path
            main_launches, main_stats = launches, stats
    launches, stats = main_launches, main_stats
    # the counters of this run's kernel build (quantized pages count apart)
    suffix = "" if dtype == "bf16" else f"_{dtype}"
    launches = {name: launches[name] for name in (
        f"paged_attention_decode{suffix}", f"paged_attention_ragged{suffix}")}
    for name, n in launches.items():
        print(f"{tag} {name} launches in the served run (depth "
              f"{depths[0]}, graph replays counted): {n}")
        if n == 0:
            fail(f"{name} was never launched on the main path")

    # probe: logits of one prompt chunk through both attention impls
    probe_eng = EngineConfig(num_blocks=8, **quant)
    dev = engine.device
    toks = torch.tensor([prompts[1][:64]], dtype=torch.int32, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
    tables = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
    logits = {}
    for impl in ("kernel", "einsum"):
        e = dataclasses.replace(probe_eng, attention_impl=impl)
        cache = model_lib.init_cache(cfg, e, engine.device)
        _, h = model_lib.forward(cfg, e, engine.params, cache, toks, pos,
                                 tables)
        logits[impl] = model_lib.logits_fn(cfg, engine.params, h)[0]
    torch.cuda.synchronize()
    for impl, lg in logits.items():
        if lg.shape != (64, cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"probe logits ({impl}) not finite or misshapen")
    diff = (logits["kernel"] - logits["einsum"]).abs().max().item()
    agree = (logits["kernel"].argmax(-1) == logits["einsum"].argmax(-1)) \
        .float().mean().item()
    print(f"{tag} probe logits finite; kernel vs einsum path max |diff| "
          f"{diff:.4f}, argmax agreement {agree:.3f}", flush=True)
    if cfg.is_moe:
        if agree < PROBE_MOE_MIN_ARGMAX_AGREE:
            fail(f"probe (MoE): kernel path disagrees with the einsum path "
                 f"(argmax agreement {agree} < "
                 f"{PROBE_MOE_MIN_ARGMAX_AGREE})")
    elif diff > PROBE_MAX_DIFF or agree < PROBE_MIN_ARGMAX_AGREE:
        fail(f"probe ({dtype}): kernel path disagrees with the einsum path "
             f"({diff} > {PROBE_MAX_DIFF} or {agree} < "
             f"{PROBE_MIN_ARGMAX_AGREE})")
    if ref_logits is not None:
        qdiff = (logits["kernel"] - ref_logits).abs()
        qagree = (logits["kernel"].argmax(-1) == ref_logits.argmax(-1)) \
            .float().mean().item()
        print(f"{tag} probe logits vs the bf16 run's: max |diff| "
              f"{qdiff.max().item():.4f}, mean |diff| "
              f"{qdiff.mean().item():.4f}, argmax agreement {qagree:.3f}",
              flush=True)
    return launches, engine, logits["kernel"], stats


GRAPH_BUCKETS = (8, 16)   # the decode buckets phase 3 runs (16 requests)


def seat(ctl, B: int, ctx0: int, max_len: int, sampled: bool = False):
    """Put B live seats into ``ctl`` in place: seat s decodes at position
    ctx0 + s over its own 40 blocks; with ``sampled`` the odd seats sample
    (temperature 0.8, top-k 40 or top-p 0.9, seeded or on the engine's
    key), the even ones stay greedy."""
    import torch

    for s in range(B):
        ctl["pos"][s] = ctx0 + s
        ctl["vu"][s] = max_len
        ctl["tables"][s, :40] = torch.arange(1 + 40 * s, 1 + 40 * (s + 1))
        odd = sampled and s % 2 == 1
        ctl["temp"][s] = 0.8 if odd else 0.0
        ctl["tk"][s] = 40 if odd and s % 4 == 1 else 0
        ctl["tp"][s] = 0.9 if odd and s % 4 == 3 else 1.0
        ctl["seed"][s] = 1000 + s if s % 3 else -1


def phase_graph(engine, card: str) -> None:
    """[graph]: each decode graph phase 3 replays (buckets 8 and 16,
    greedy and stochastic) against the eager window on identical clones of
    cache and ctl. Samples and ctl must be equal bit for bit; the cache's
    largest difference is printed (the same kernels run in the same order,
    so it should be 0). Prints each graph's capture time and the graphs'
    pool. The engine's cache and ctl are put back afterwards."""
    import torch

    window = engine._ap_window_fn
    eng = engine.config

    def clone(tree):
        return {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in tree.items()}

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    saved_ctl, saved_cache = clone(engine._ctl), clone(engine.cache)
    for B in GRAPH_BUCKETS:
        for stochastic in (False, True):
            for k, v in saved_ctl.items():
                engine._ctl[k].copy_(v)
            seat(engine._ctl, B, 560, eng.max_model_len, sampled=stochastic)
            ctl_e, cache_e = clone(engine._ctl), clone(engine.cache)
            cols = list(range(B))
            _, _, want = window.raw(
                engine.params, cache_e, ctl_e,
                torch.tensor(cols, dtype=torch.int32, device=engine.device),
                stochastic)
            _, _, got = window(engine.params, engine.cache, engine._ctl,
                               window.load_rows(cols), stochastic)
            got = got.clone()
            torch.cuda.synchronize()
            same_samples = torch.equal(want, got)
            same_ctl = all(torch.equal(bits(ctl_e[k]), bits(engine._ctl[k]))
                           for k in ctl_e)
            diff = max((a.float() - b.float()).abs().max().item()
                       for key in cache_e
                       for a, b in zip(cache_e[key], engine.cache[key]))
            bitwise = all(torch.equal(bits(a), bits(b)) for key in cache_e
                          for a, b in zip(cache_e[key], engine.cache[key]))
            print(f"[graph] {card}: B={B} stochastic={stochastic} weights "
                  f"{eng.weight_dtype} KV {eng.kv_dtype}: replay vs eager "
                  f"samples equal {same_samples}, ctl bitwise equal "
                  f"{same_ctl}, cache max |diff| {diff:.3e} (bitwise "
                  f"{bitwise}); captured in "
                  f"{window.capture_s['decode', B, stochastic] * 1e3:.1f} "
                  f"ms",
                  flush=True)
            if not (same_samples and same_ctl):
                fail(f"decode graph B={B} stochastic={stochastic} "
                     "disagrees with the eager window")
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    for key, layers in saved_cache.items():
        for dst, src in zip(engine.cache[key], layers):
            dst.copy_(src)
    torch.cuda.synchronize()
    print(f"[graph] {card}: {len(window.capture_s)} graphs in one pool of "
          f"{window.pool_bytes() / 2**20:.1f} MiB; device memory reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)


# ------------------------- phase 3: spec decode ---------------------------

SPEC_K, SPEC_NGRAM = 4, (1, 3)
SPEC_SEGMENT = 64          # a seeded segment, repeated ISL / 64 times
# Parity of the spec engine's bf16 streams with the non-spec engine's: a
# spec stream may part from the non-spec one only at a near-tie of the
# non-spec run's own logits (read from a rerun whose decode windows run
# eagerly, bitwise the graphs). The limit is 2^-5 x |top logit|, eight
# bf16 steps of the top logit: the two paths round differently (the spec
# window's GEMMs see M=80 rows, the decode window's 16; the ragged face
# rounds P to bf16, the decode face keeps it in f32), and the hidden state
# is rounded to bf16 after each of the 32 residual adds, so their logits
# differ by about a percent of the top one. A wrong acceptance lands a
# token whose logit sits far below the top (random logits have unit
# scale, the top ~4.5). Each parting also shows whether it meets 1e-3 x
# |top logit|, a bound under bf16's own step (2^-8).
PARITY_MARGIN = 2.0 ** -5
PARITY_FINE = 1e-3
PARITY_TOPK = 8
# An MoE row's routing near-tie (check_parity's router_gaps): router logits
# have unit scale with random weights (x is RMS-normed, w_router ~
# N(0, 1/D)), and the two paths' bf16 differences move them by ~1e-2 (the
# [moe] probe's comment), so a gap under 2^-5 between the last expert
# picked and the first left out can flip.
ROUTER_MARGIN = 2.0 ** -5


def spec_prompts(vocab: int):
    """Phase 3's spec traffic: per request a seeded 64-token segment
    repeated to ISL tokens, the copy-heavy input of editing and summarising
    traffic."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 8)
    return [torch.randint(1, vocab, (SPEC_SEGMENT,), generator=gen).tolist()
            * (ISL // SPEC_SEGMENT) for _ in range(N_REQUESTS)]


def prompt_ids(p):
    """The token ids of a prompt: a list of ids, or a request body with
    ``token_ids`` (and, for an image prompt, its ``mm`` field)."""
    return p["token_ids"] if isinstance(p, dict) else p


def serve_batch(engine, prompts, max_tokens, after_warmup=None,
                warm_up: bool = True, alongside=None):
    """Serve ``prompts`` (lists of ids, or request bodies that may carry
    ``mm``) concurrently (greedy) through ``engine.generate`` after a short
    text warm-up request (then the recorder's and the capture watch's
    warm-up mark, then ``after_warmup()``; ``warm_up=False`` skips all
    three); ``alongside``, an async callable, runs concurrently with the
    traffic on the same event loop. Returns (streams, per-request (submit,
    token times), wall s, decode-only batch times s of the synchronous
    loop)."""
    import asyncio

    from dynamo_tpu_torch.runtime.context import Context

    batch_s = []
    orig = engine._execute_batch

    def timed(batch):
        t0 = time.perf_counter()
        out = orig(batch)
        if not batch.prefills:
            batch_s.append(time.perf_counter() - t0)
        return out

    async def one(prompt, stamps, n=max_tokens):
        body = dict(prompt) if isinstance(prompt, dict) else {
            "token_ids": prompt}
        body.update(max_tokens=n, temperature=0.0)
        t_sub = time.perf_counter()
        out, times = [], []
        async for o in engine.generate(body, Context()):
            out.extend(o["token_ids"])
            times.append(time.perf_counter())
        stamps.append((t_sub, times))
        return out

    async def run():
        await engine.start()
        if warm_up:
            # warm-up, not measured
            await one(prompt_ids(prompts[0])[:32], [], 4)
            engine.clear_kv_blocks()
            engine.mark_obs_warmup_done()
            if after_warmup is not None:
                after_warmup()
        engine._execute_batch = timed
        stamps = []
        t0 = time.perf_counter()
        try:
            side = [alongside()] if alongside is not None else []
            outs = (await asyncio.gather(
                *(one(p, stamps) for p in prompts), *side))[:len(prompts)]
        finally:
            engine._execute_batch = orig
        wall = time.perf_counter() - t0
        await engine.stop()
        return outs, stamps, wall
    engine.clear_kv_blocks()
    outs, stamps, wall = asyncio.run(run())
    return outs, stamps, wall, batch_s


def tapped_run(engine, prompts, osl: int = OSL, router_gaps=None):
    """Serve ``prompts`` through the non-spec ``engine`` at depth 1 with its
    decode windows run eagerly (bitwise their graphs, as ``[graph]``
    checks), recording the top-PARITY_TOPK logits of each request's final
    prefill chunk (output index 0) and of each decode window per seat.
    Returns (streams, {(request, output index): (token ids, logits)}).
    With a dict ``router_gaps`` (an MoE engine) it also records, under the
    same keys, the smallest gap over the layers between the router logits
    of the last expert a row picks and the first it does not (the row whose
    hidden state gives that output)."""
    import torch

    from dynamo_tpu_torch.engine import model as model_lib

    index = {tuple(prompt_ids(p)[:SPEC_SEGMENT]): r
             for r, p in enumerate(prompts)}
    taps, rec, gaps = [], {}, []
    logits_fn = model_lib.logits_fn
    moe_ffn = model_lib.moe_ffn
    unpack = engine._unpack_results
    cur = {}

    def tap(cfg, params, h, mesh=None, specs=None):
        out = logits_fn(cfg, params, h, mesh, specs)
        taps.append(torch.topk(out, PARITY_TOPK))
        gaps.append(cur.pop("gap", None))
        return out

    def moe_tap(x, w_router, *args, top_k, **kw):
        top = torch.topk(x.float() @ w_router.float(), top_k + 1).values
        gap = top[:, top_k - 1] - top[:, top_k]
        cur["gap"] = gap if "gap" not in cur else torch.minimum(
            cur["gap"], gap)
        return moe_ffn(x, w_router, *args, top_k=top_k, **kw)

    def unpack_tapped(batch, landing):
        # one logits call per prefill chunk (dispatched first), then the
        # decode window's; a final chunk samples output index 0
        for i, chunk in enumerate(batch.prefills):
            r = index.get(tuple(chunk.seq.prompt_ids[:SPEC_SEGMENT]))
            if chunk.final and r is not None:
                vals, ids = (t.cpu().tolist() for t in taps[i])
                rec[r, 0] = (ids[0], vals[0])
                if router_gaps is not None:
                    router_gaps[r, 0] = gaps[i][chunk.length - 1].item()
        if landing.decode_shape is not None:
            vals, ids = (t.cpu().tolist() for t in taps[-1])
            col_of = {}
            for col, slot in enumerate(landing.cols):
                col_of.setdefault(slot, col)
            for row in batch.decode_rows:
                r = index.get(tuple(row.seq.prompt_ids[:SPEC_SEGMENT]))
                if r is not None:
                    c = col_of[row.slot]
                    rec[r, len(row.seq.output_ids)] = (ids[c], vals[c])
                    if router_gaps is not None:
                        router_gaps[r, len(row.seq.output_ids)] = \
                            gaps[-1][c].item()
        taps.clear()
        gaps.clear()
        return unpack(batch, landing)

    engine.pipeline_depth = 1
    engine._ap_window_fn.graphed = False
    model_lib.logits_fn = tap
    if router_gaps is not None:
        model_lib.moe_ffn = moe_tap
    engine._unpack_results = unpack_tapped
    try:
        outs = serve_batch(engine, prompts, osl)[0]
    finally:
        model_lib.logits_fn = logits_fn
        model_lib.moe_ffn = moe_ffn
        del engine._unpack_results
        engine._ap_window_fn.graphed = True
        engine.pipeline_depth = DEPTHS[0]
    return outs, rec


def check_parity(want, rec, got, what: str, tag: str = "[spec]",
                 router_gaps=None):
    """The parity rule: ``got`` (spec, or another path such as phase 7's
    disaggregated or evacuated streams) equals ``want`` (the non-spec run
    whose logits ``rec`` holds) token for token, but may part where the
    other token sits under PARITY_MARGIN x |top logit| below the non-spec
    run's top logit; prints each parting under ``tag``. Returns the
    partings.

    With ``router_gaps`` (an MoE model, ``tapped_run``'s) a parting may
    instead sit at a near-tie of the routing: at a row whose router logits
    of the last expert picked and the first one left out, in some layer,
    were under ROUTER_MARGIN apart. Rounding there hands the row another
    expert, which moves its hidden state by that expert's whole output, so
    the other token need not be a near-tie of the logits (finding d)."""
    partings = []
    for r, (a, b) in enumerate(zip(want, got)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        if (r, j) not in rec:
            fail(f"{tag} stream {r} parts at token {j}, where no decode "
                 f"window's logits were recorded")
        ids, vals = rec[r, j]
        top = vals[0]
        margin = vals[0] - vals[1]
        gap = vals[0] - vals[ids.index(b[j])] if b[j] in ids else None
        limit = PARITY_MARGIN * abs(top)
        partings.append((r, j, margin, gap))
        print(f"{tag} parity vs {what}: request {r} parts at output token "
              f"{j}: non-spec {a[j]} (its run's top {ids[0]}, logit "
              f"{top:.4f}), spec {b[j]}: the non-spec run's top-2 margin "
              f"{margin:.5f}, spec token "
              + (f"{gap:.5f}" if gap is not None else
                 f"not in its top {PARITY_TOPK}")
              + f" under the top (limit {limit:.5f}; 1e-3 x |top| = "
              f"{PARITY_FINE * abs(top):.5f}: "
              + ("met" if margin < PARITY_FINE * abs(top) else "not met")
              + ")", flush=True)
        if ids[0] != a[j] or gap is None or gap >= limit:
            rgap = (router_gaps or {}).get((r, j))
            if ids[0] == a[j] and rgap is not None and rgap < ROUTER_MARGIN:
                print(f"{tag} parity vs {what}: request {r} token {j} sits "
                      f"at a routing near-tie: router logit gap {rgap:.5f} "
                      f"at the top-k boundary (limit {ROUTER_MARGIN:.5f})",
                      flush=True)
                continue
            fail(f"{tag} stream {r} parts from the non-spec one ({what}) at "
                 f"token {j} away from a near-tie: gap {gap}, limit {limit}"
                 + ("" if rgap is None else
                    f", router logit gap {rgap:.5f} (limit "
                    f"{ROUTER_MARGIN:.5f})"))
    return partings


def phase_spec(card: str, base):
    """[spec]: a bf16 ``spec_mode="ngram"`` engine (k=4, n-gram 1..3) with
    phase 3's weights serves 16 greedy requests of repeated 64-token
    segments (ISL 512, OSL 64); the phase 3 engine ``base`` serves the same
    prompts at depths 1 and 2. Streams must meet the parity rule, every
    spec window must be a graph replay, and the ragged face must have run
    the verify windows. Returns the spec engine and its run's
    paged-attention launches (graph replays counted, verify windows
    apart)."""
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = base.model_config
    prompts = spec_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    spec_cfg = EngineConfig(spec_mode="ngram", spec_k=SPEC_K,
                            spec_ngram_min=SPEC_NGRAM[0],
                            spec_ngram_max=SPEC_NGRAM[1])
    engine = InferenceEngine(cfg, spec_cfg, seed=SEED)
    torch.cuda.synchronize()
    graphs = engine._ap_window_fn
    n_spec = sum(1 for key in graphs.capture_s if key[0] == "spec")
    print(f"[spec] engine spec_mode=ngram k={SPEC_K} n-gram {SPEC_NGRAM}, "
          f"same weights (seed {SEED}), pipeline_depth "
          f"{engine.pipeline_depth}, built in "
          f"{time.perf_counter() - t0:.2f} s; {n_spec} spec + "
          f"{len(graphs.capture_s) - n_spec} decode graphs captured "
          f"({sum(graphs.capture_s.values()):.2f} s)", flush=True)
    if engine.pipeline_depth != 1 or n_spec != 2 * len(
            spec_cfg.decode_buckets):
        fail("the spec engine did not force depth 1 or capture its graphs")
    if not all(torch.equal(a, b) for a, b in zip(
            engine.params["layers"]["wq"], base.params["layers"]["wq"])):
        fail("the spec engine's weights differ from phase 3's")

    runs = {}
    for depth in (1, 2):
        base.pipeline_depth = depth
        runs[depth] = serve_batch(base, prompts, OSL)
    base.pipeline_depth = DEPTHS[0]
    seat_windows = [0]
    unpack = engine._unpack_spec

    def counting(batch, out, col_of):
        seat_windows[0] += len(batch.decode_rows)
        return unpack(batch, out, col_of)
    engine._unpack_spec = counting
    before = {}

    def mark():
        seat_windows[0] = 0
        before.update(windows=engine.num_windows, replays=graphs.replays,
                      spec=graphs.spec_replays,
                      prefills=engine.num_prefill_dispatches,
                      stats=engine.spec_stats.to_dict())
        pa.reset_launches()
    outs, stamps, wall, batch_s = serve_batch(engine, prompts, OSL, mark)
    launches = dict(pa.LAUNCHES)
    obs = engine.obs_snapshot()
    engine._unpack_spec = unpack
    st = engine.spec_stats.to_dict()
    n = {k: st[k] - before["stats"][k]
         for k in ("drafted", "accepted", "emitted", "windows")}
    windows = engine.num_windows - before["windows"]
    replays = graphs.replays - before["replays"]
    spec_replays = graphs.spec_replays - before["spec"]
    prefills = engine.num_prefill_dispatches - before["prefills"]
    for i, out in enumerate(outs):
        if len(out) != OSL or not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"spec request {i}: {len(out)} tokens or an id out of range")
    if replays != windows or spec_replays != n["windows"] \
            or spec_replays != windows:
        fail(f"spec windows not all graph replays: {windows} windows, "
             f"{replays} replays, {spec_replays} spec replays, "
             f"{n['windows']} verify windows")
    L = cfg.num_layers
    verify_launches = launches["paged_attention_ragged"] - L * prefills
    if verify_launches != L * spec_replays \
            or launches["paged_attention_decode"] != 0:
        fail(f"verify windows did not run the ragged face: {launches}, "
             f"{prefills} prefills, {spec_replays} spec replays")

    def stats(tag, outs_, stamps_, wall_, batch_):
        ttft = sorted(times[0] - t for t, times in stamps_)
        itl = sorted((times[-1] - times[0]) / (len(times) - 1)
                     for _, times in stamps_)
        steady = sorted(batch_)
        out = dict(ttft=ttft[len(ttft) // 2], itl=itl[len(itl) // 2],
                   tok_s=sum(map(len, outs_)) / wall_,
                   step=steady[len(steady) // 2] if steady else 0.0)
        print(f"[spec] {card}: {tag}: TTFT p50 {out['ttft'] * 1e3:.1f} ms, "
              f"ITL p50 {out['itl'] * 1e3:.2f} ms, output "
              f"{out['tok_s']:.1f} tok/s, steady decode-only window p50 "
              f"{out['step'] * 1e3:.2f} ms over {len(steady)} windows",
              flush=True)
        return out
    summary = {f"depth {d}": stats(f"non-spec engine, depth {d}", *runs[d])
               for d in (1, 2)}
    summary["spec"] = stats("spec engine (depth 1)", outs, stamps, wall,
                            batch_s)
    rate = n["accepted"] / max(1, n["drafted"])
    print(f"[spec] {card}: acceptance {n['accepted']}/{n['drafted']} = "
          f"{rate:.3f}; {n['emitted']} tokens landed by {n['windows']} "
          f"verify windows ({seat_windows[0]} seat-windows): "
          f"{n['emitted'] / max(1, seat_windows[0]):.2f} tokens per seat "
          f"per window, {seat_windows[0] / N_REQUESTS:.1f} windows per "
          f"request; flight recorder mfu_decode {obs['mfu_decode']:.5f}, "
          f"spec_reject waste {obs['spec_reject_waste_ratio']:.3f}; "
          f"ragged-face launches in verify windows {verify_launches}",
          flush=True)
    t_tap = time.perf_counter()
    tapped, rec = tapped_run(base, prompts)
    same = sum(x == y for x, y in zip(tapped, runs[1][0]))
    print(f"[spec] the non-spec depth-1 run again, decode windows eager "
          f"with their logits recorded ({time.perf_counter() - t_tap:.1f} "
          f"s): {same} of {N_REQUESTS} streams equal the graphed run's",
          flush=True)
    if same != N_REQUESTS:
        fail("the eager rerun of the non-spec depth-1 traffic differs from "
             "its graphed run")
    partings = check_parity(tapped, rec, outs, "non-spec depth 1")
    for what, ref in (("non-spec depth 1", runs[1][0]),
                      ("non-spec depth 2", runs[2][0])):
        print(f"[spec] {sum(x == y for x, y in zip(outs, ref))} of "
              f"{N_REQUESTS} spec streams equal the {what} run's", flush=True)
    print(f"[spec] parity: {len(partings)} of {N_REQUESTS} spec streams part "
          f"from the non-spec depth-1 run, each at a near-tie of its logits "
          f"(output token, top-2 margin, spec-token gap): " + ", ".join(
              f"({j}, {m:.4f}, {g:.4f})" for _, j, m, g in partings)
          + f"; depth 2 equals depth 1 in "
          f"{sum(x == y for x, y in zip(runs[1][0], runs[2][0]))} streams",
          flush=True)
    return engine, dict(launches=verify_launches, summary=summary,
                        acceptance=rate, partings=partings)


def spec_seat(ctl, B: int, ctx0: int, max_len: int, sampled: bool) -> None:
    """``seat`` plus each seat's history: a periodic 12-token pattern up to
    its position, so the drafter proposes."""
    import torch

    seat(ctl, B, ctx0, max_len, sampled)
    pattern = torch.arange(100, 112, dtype=torch.int32,
                           device=ctl["hist"].device)
    for s in range(B):
        n = ctx0 + s + 1
        ctl["hist"][s].fill_(-1)
        ctl["hist"][s, :n] = pattern.repeat(-(-n // 12))[:n] + s
        ctl["last_tok"][s] = ctl["hist"][s, n - 1]


def phase_spec_graph(engine, card: str) -> None:
    """[graph] for the spec windows: each spec graph phase 3 replays
    (buckets 8 and 16, greedy and stochastic) against the eager spec window
    on identical clones of cache and ctl (history included): packed output
    and ctl bitwise equal."""
    import torch

    window = engine._ap_window_fn
    eng = engine.config

    def clone(tree):
        return {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in tree.items()}

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    saved_ctl = clone(engine._ctl)
    for B in GRAPH_BUCKETS:
        for stochastic in (False, True):
            for k, v in saved_ctl.items():
                engine._ctl[k].copy_(v)
            spec_seat(engine._ctl, B, 560, eng.max_model_len, stochastic)
            ctl_e, cache_e = clone(engine._ctl), clone(engine.cache)
            cols = list(range(B))
            _, _, want = window.raw_spec(
                engine.params, cache_e, ctl_e,
                torch.tensor(cols, dtype=torch.int32, device=engine.device),
                stochastic)
            _, _, got = window(engine.params, engine.cache, engine._ctl,
                               window.load_rows(cols), stochastic, spec=True)
            got = got.clone()
            torch.cuda.synchronize()
            same = torch.equal(want, got)
            differ = [k for k in ctl_e
                      if not torch.equal(bits(ctl_e[k]), bits(engine._ctl[k]))]
            same_ctl = not differ
            bitwise = all(torch.equal(bits(a), bits(b)) for key in cache_e
                          for a, b in zip(cache_e[key], engine.cache[key]))
            landed = int(got[SPEC_K + 1].sum())
            drafted = int(got[SPEC_K + 2].sum())
            print(f"[graph] {card}: spec B={B} stochastic={stochastic}: "
                  f"replay vs eager packed output equal {same}, ctl (hist "
                  f"included) bitwise equal {same_ctl} {differ or ''}, cache "
                  f"bitwise "
                  f"{bitwise}; {landed} tokens landed, {drafted} drafted; "
                  f"captured in "
                  f"{window.capture_s['spec', B, stochastic] * 1e3:.1f} ms",
                  flush=True)
            if not (same and same_ctl):
                fail(f"spec graph B={B} stochastic={stochastic} disagrees "
                     "with the eager spec window")
            if drafted == 0 or landed < B:
                fail(f"spec graph B={B}: {drafted} drafts on periodic "
                     f"histories, {landed} tokens for {B} live seats")
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    torch.cuda.synchronize()


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _profiled(fn, reps: int = 5):
    """(kernel launches, device busy ms) of one call of ``fn``, from
    ``torch.profiler``; (None, None) if it recorded no device time."""
    from torch.autograd import DeviceType

    fn()
    events = profile_calls(fn, reps)
    if events is None:
        return None, None
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx")) / reps
    busy = sum(_device_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / reps / 1e3
    return launches, busy


def _or_not_measured(x, spec: str, unit: str = "") -> str:
    return "not measured" if x is None else f"{x:{spec}}{unit}"


def phase_quant_costs(engine, card: str) -> None:
    """The two costs quantized serving adds to a decode step of the eager
    port, at the main path's shapes (B=16): the bf16 copy that every
    quantized matmul makes of its 1-byte weight (device time and bytes of
    all of one step's casts), and ``kv_quantize`` plus the scale scatter of
    K and V in every layer (launches, device busy time from the profiler,
    and host wall time by CUDA events around back-to-back calls, which
    host launches bound)."""
    import torch

    from dynamo_tpu_torch.engine import quant

    cfg, eng = engine.model_config, engine.config
    leaves = [w for w in engine.params["layers"].values()
              if isinstance(w, dict)]
    if isinstance(engine.params.get("lm_head"), dict):
        leaves.append(engine.params["lm_head"])
    if leaves:
        def casts():
            for w in leaves:
                w["q"].to(torch.bfloat16)
        n = sum(w["q"].numel() for w in leaves)
        ms = cuda_ms(casts, iters=10)
        print(f"[quant] {card}: weight {eng.weight_dtype}: bf16 copies of "
              f"one step's {len(leaves)} stacked weights ({n / 1e9:.3f} G "
              f"elements, {3 * n / 1e9:.2f} GB read + written): {ms:.3f} "
              f"ms, {3 * n / ms / 1e9:.2f} TB/s; launches "
              f"{_or_not_measured(_profiled(casts)[0], '.0f')}", flush=True)
    if quant.is_quantized(eng.kv_dtype):
        B, KV, hd = 16, cfg.num_kv_heads, cfg.head_dim_
        x = torch.randn(B, KV, hd, device=engine.device,
                        dtype=torch.bfloat16)
        ks = engine.cache["ks"][0]
        idx = (torch.arange(1, B + 1, device=engine.device)[:, None],
               torch.arange(KV, device=engine.device)[None, :],
               torch.zeros(B, 1, dtype=torch.long, device=engine.device))

        def quantize_one():  # K or V of one layer, with its scale scatter
            _, sc = quant.kv_quantize(x, eng.kv_dtype)
            ks.index_put_(idx, sc)
        wall = cuda_ms(quantize_one, iters=50)
        n, busy = _profiled(quantize_one)
        L = cfg.num_layers
        step_n, step_busy = ((None, None) if n is None else
                             (2 * L * n, 2 * L * busy))
        print(f"[quant] {card}: kv {eng.kv_dtype}: kv_quantize + scale "
              f"scatter of K or V, B={B}: launches "
              f"{_or_not_measured(n, '.0f')}, device busy "
              f"{_or_not_measured(busy, '.4f', ' ms')}, back-to-back wall "
              f"{wall:.4f} ms; per decode step (x2 x {L} layers): launches "
              f"{_or_not_measured(step_n, '.0f')}, device busy "
              f"{_or_not_measured(step_busy, '.3f', ' ms')}, "
              f"{2 * L * wall:.3f} ms wall", flush=True)


def phase_profile(engine, card: str) -> None:
    """Where a step's time goes, at the main path's shapes: wall time of
    the engine's step functions (host clock around synchronised calls), the
    host time to enqueue one (back-to-back calls, no sync) and,
    from ``torch.profiler`` over a few calls, the device busy time and idle
    share, the host's kernel and graph launches, the kernels that ran on
    the device and the attention kernel's share. The decode window runs
    eagerly and as the engine's replayed graph, on the same seats. Returns
    each step's device busy ms ("decode_eager", "decode_graph",
    "prefill"), None where the profiler recorded no device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg, eng = engine.model_config, engine.config
    dev = engine.device
    B, ctx0 = 16, 560
    ctl = model_lib.init_ctl(eng, eng.max_num_seqs, eng.max_blocks_per_seq,
                             dev)
    seat(ctl, B, ctx0, eng.max_model_len)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    window = model_lib.raw_autopilot_window_fn(cfg, eng, 1)
    graphed = engine._ap_window_fn
    if engine._window_K != 1:
        fail("phase 4 profiles 1-token decode windows")
    saved_ctl = {k: v.clone() for k, v in engine._ctl.items()}
    for k, v in ctl.items():
        engine._ctl[k].copy_(v)
    graph_rows = graphed.load_rows(list(range(B)))
    T, W = 512, 32
    prefill = model_lib.raw_packed_prefill_fn(cfg, eng, T, W)
    pint = np.zeros((1, T + W + model_lib.PP_SCALARS), np.int32)
    pint[0, :T] = np.arange(T) % (cfg.vocab_size - 1) + 1
    pint[0, T:T + W] = np.arange(1 + 40 * B, 1 + 40 * B + W)
    pint[0, T + W:] = (T, 0, B, 1, 0, -1, 0, int(model_lib.PP_QUANT))
    pint = torch.from_numpy(pint).to(dev)
    key = torch.tensor(1, device=dev)
    steps = {  # each enqueues one step and returns its sampled tokens
        "decode_eager": (
            f"decode window B={B} ctx ~{ctx0}, eager", lambda: window(
                engine.params, engine.cache, ctl, rows, False)[2]),
        "decode_graph": (
            f"decode window B={B} ctx ~{ctx0}, graph replay",
            lambda: graphed(engine.params, engine.cache, engine._ctl,
                            graph_rows, False)[2]),
        "prefill": (f"prefill chunk T={T} W={W}", lambda: prefill(
            engine.params, engine.cache, ctl["last_tok"], pint, key,
            False)[2]),
    }
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
    busy_of = {}
    for step, (name, enqueue) in steps.items():
        def fn():
            return enqueue().cpu()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            enqueue()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        reps = 3
        events = profile_calls(fn, reps)
        if events is None:
            before = sum(pa.LAUNCHES.values())
            fn()
            if sum(pa.LAUNCHES.values()) == before:
                fail(f"{name}: the attention kernel was not launched")
            busy_of[step] = None
            print(f"[profile] {card}: {name}, weights {eng.weight_dtype} KV "
                  f"{eng.kv_dtype}: wall {wall_ms:.2f} ms (host enqueue "
                  f"{host_ms:.3f} ms), device busy, launches and kernels "
                  f"not measured (the profiler recorded no device time); "
                  f"the attention kernel launched", flush=True)
            continue
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))]
        busy = sum(_device_us(e) for e in kernels) / reps / 1e3
        # both faces: the ragged kernel and the decode split-KV kernel
        attn = sum(_device_us(e) for e in kernels
                   if "paged_attention" in e.key) / reps / 1e3
        launches = sum(e.count for e in events
                       if e.key in launch_keys) / reps
        graph_launches = sum(e.count for e in events
                             if e.key == "cudaGraphLaunch") / reps
        on_device = sum(e.count for e in kernels) / reps
        if attn <= 0:
            fail(f"{name}: no device time in the attention kernels")
        busy_of[step] = busy
        top = sorted(kernels, key=_device_us, reverse=True)[:4]
        print(f"[profile] {card}: {name}, weights {eng.weight_dtype} KV "
              f"{eng.kv_dtype}: wall {wall_ms:.2f} ms (host enqueue "
              f"{host_ms:.3f} ms), device "
              f"busy {busy:.2f} ms ({busy / wall_ms:.0%} of wall, idle "
              f"{1 - busy / wall_ms:.0%}), attention kernel {attn:.3f} ms, "
              f"{launches:.0f} kernel launches and {graph_launches:.0f} "
              f"cudaGraphLaunch from the host, {on_device:.0f} kernels on "
              f"the device; top: " + "; ".join(
                  f"{e.key[:40]} {_device_us(e) / reps / 1e3:.2f} ms"
                  for e in top), flush=True)
    for k, v in saved_ctl.items():
        engine._ctl[k].copy_(v)
    torch.cuda.synchronize()
    return busy_of


# ------------------------------ phase 5 ----------------------------------

# Llama-3's pre-tokenizer regex (its tokenizer.json: Split, Isolated)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
LLAMA3_SPECIAL = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                  6: "<|start_header_id|>", 7: "<|end_header_id|>",
                  9: "<|eot_id|>"}
N_REGULAR = 128_000


def synthetic_tokenizer_json(n_merges: int = N_REGULAR - 256,
                             n_special: int = 256, seed: int = SEED) -> str:
    """A byte-level BPE ``tokenizer.json`` at Llama-3's layout, made from a
    seed: the 256 byte tokens, then ``n_merges`` merges, each joining two
    existing tokens of at most 16 bytes between them, then ``n_special``
    special tokens (Llama-3's names where it has them, reserved ones
    elsewhere); Llama-3's ``Split`` regex before ``ByteLevel``,
    ``ignore_merges``, and a ``TemplateProcessing`` that puts
    ``<|begin_of_text|>`` first. Every merged token is whole UTF-8 text
    (ASCII, then Latin, Greek, Cyrillic, Arabic-Indic and Devanagari
    digits and CJK characters, each built up from its bytes, then joins of
    whole tokens), so text decoded from them splits where they do."""
    import random

    from dynamo_tpu_torch.llm.tokenizer_json import bytes_to_unicode

    table = bytes_to_unicode()
    rng = random.Random(seed)
    vocab = {table[b]: b for b in range(256)}
    merges = []

    def show(bs: bytes) -> str:
        return "".join(table[x] for x in bs)

    by_len = [[] for _ in range(17)]   # whole-text tokens by byte length

    def add(a: bytes, b: bytes, whole: bool) -> None:
        key = show(a + b)
        if key in vocab or len(merges) >= n_merges:
            return
        vocab[key] = len(vocab)
        merges.append([show(a), show(b)])
        if whole:
            by_len[len(a + b)].append(a + b)

    for b in [9, 10, *range(0x20, 0x7F)]:
        by_len[1].append(bytes([b]))
    for cp in [*range(0xC0, 0x180), *range(0x391, 0x3CA),
               *range(0x410, 0x450), *range(0x660, 0x66A),
               *range(0x966, 0x970), *range(0x4E00, 0x4E00 + 512)]:
        bs = chr(cp).encode()
        for i in range(1, len(bs)):
            add(bs[:i], bs[i:i + 1], whole=i + 1 == len(bs))
    while len(merges) < n_merges:
        la = rng.randrange(1, 16)
        if not by_len[la]:
            continue
        a = rng.choice(by_len[la])
        room = [len(by_len[n]) for n in range(1, 17 - la)]
        r = rng.randrange(sum(room))
        lb = 1
        while r >= room[lb - 1]:
            r -= room[lb - 1]
            lb += 1
        add(a, by_len[lb][r], whole=True)
    n_regular = len(vocab)
    added = []
    for i in range(n_special):
        name = LLAMA3_SPECIAL.get(i, f"<|reserved_special_token_{i}|>")
        added.append({"id": n_regular + i, "content": name,
                      "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False,
                      "special": True})
    bos = LLAMA3_SPECIAL[0]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": {"type": "Sequence", "processors": [
            byte_level,
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_regular],
                                      "tokens": [bos]}}}]},
        "decoder": dict(byte_level, use_regex=True),
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }, ensure_ascii=False)


async def _http_request(port: int, method: str, path: str, body=None,
                        leave_after=None, headers=None):
    """One request on its own connection: (status, t_sent, frames, done,
    body). A streamed (chunked) answer gives ``frames``, each parsed
    ``data:`` payload stamped on arrival with the shared monotonic clock,
    and ``done`` when ``data: [DONE]`` came; with ``leave_after`` the
    client closes its socket after that many frames, mid-stream. A whole
    answer gives ``body`` (parsed JSON, else text). ``headers`` adds
    request headers."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    t_sent = time.perf_counter()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 f"Content-Type: application/json\r\nContent-Length: "
                 f"{len(payload)}\r\n{extra}Connection: close\r\n\r\n"
                 .encode() + payload)
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
    status = int(head.split(" ", 2)[1])
    headers = dict(ln.lower().split(": ", 1)
                   for ln in head.split("\r\n")[1:] if ": " in ln)
    frames, done, out = [], False, None
    try:
        if headers.get("transfer-encoding") == "chunked":
            buf = b""
            while not done:
                size = int((await reader.readline()).strip(), 16)
                if size == 0:
                    break
                data = await reader.readexactly(size + 2)
                t = time.perf_counter()
                buf += data[:-2]
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    if frame == b"data: [DONE]":
                        done = True
                    elif frame.startswith(b"data: "):
                        frames.append((t, json.loads(frame[6:])))
                if leave_after is not None and len(frames) >= leave_after:
                    break
        else:
            raw = await reader.readexactly(int(headers["content-length"]))
            out = json.loads(raw) if "json" in headers.get(
                "content-type", "") else raw.decode()
    finally:
        writer.close()
    return status, t_sent, frames, done, out


def http_client(port: int, jobs):
    """Run ``jobs`` (dicts of ``_http_request``'s arguments; a job's own
    ``port`` overrides ``port``) concurrently and return their results.
    Phases 5 and 6 call this in a client process of their own, so parsing
    the answers takes no time from the server's interpreter."""
    import asyncio

    async def run():
        return await asyncio.gather(*(_http_request(**{"port": port, **job})
                                      for job in jobs))
    return asyncio.run(run())


def traffic_stats(runs, wall: float) -> dict:
    """TTFT p50/max, per-stream ITL p50 and output tok/s of a concurrent
    run; ``runs`` holds (t_sent, t_first_token, t_last_token, tokens)."""
    ttft = sorted(first - sent for sent, first, _, _ in runs)
    itl = sorted((last - first) / (n - 1) for _, first, last, n in runs)
    return dict(ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                itl_p50=itl[len(itl) // 2],
                tok_s=sum(n for *_, n in runs) / wall)


def stats_line(s) -> str:
    return (f"TTFT p50 {s['ttft_p50'] * 1e3:.1f} ms max "
            f"{s['ttft_max'] * 1e3:.1f} ms, ITL p50 "
            f"{s['itl_p50'] * 1e3:.2f} ms, output {s['tok_s']:.1f} tok/s")


def frontend_us_per_token(tok, prompts, n_tokens: int) -> float:
    """Host time the frontend spends per generated token and stream, with
    no socket and no device: ``build_local_pipeline`` (preprocessor,
    detokenizer, stop-string holdback) over an engine that streams
    scripted ids, folded into completion chunks and SSE frames, for all
    ``prompts`` at once on one event loop."""
    import asyncio

    from dynamo_tpu_torch.llm import openai as oai
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.engine import FnEngine

    async def scripted(request, context):
        ids = request["token_ids"]
        for i in range(n_tokens):
            await asyncio.sleep(0)
            yield {"token_ids": [ids[i % len(ids)]], "index": i,
                   "finished": i == n_tokens - 1,
                   "finish_reason": "length" if i == n_tokens - 1 else None,
                   "num_prompt_tokens": len(ids)}

    pipeline = build_local_pipeline(FnEngine(scripted), tok, HTTP_MODEL)

    async def one(p):
        body = {"model": HTTP_MODEL, "prompt": p, "max_tokens": n_tokens}
        chunks = oai.completion_stream(pipeline.generate(body, Context()),
                                       "cmpl-x", HTTP_MODEL)
        return sum([len(oai.sse_frame(c).encode()) async for c in chunks])

    async def run():
        await asyncio.gather(*(one(p) for p in prompts))   # warm
        t0 = time.perf_counter()
        await asyncio.gather(*(one(p) for p in prompts))
        return time.perf_counter() - t0
    return asyncio.run(run()) / (len(prompts) * n_tokens) * 1e6


HTTP_MODEL = "llama-3.2-1b-random"


def phase_http(engine, card: str, direct: dict) -> None:
    """Serve the bf16 engine over HTTP through ``run.run_http`` (what
    ``python -m dynamo_tpu_torch.run in=http`` runs) with the synthetic
    128,256-token tokenizer, and check it: texts served one at a time equal
    ``decode`` of the engine's own ids; chat through the default template;
    16 concurrent streams of phase 3's traffic; ``/metrics`` and
    ``/health``; a client that leaves mid-stream frees its sequence and KV
    blocks within a second; both attention faces launched. Prints HTTP vs
    direct TTFT, ITL and throughput on ``[http]`` lines."""
    import asyncio
    import multiprocessing
    import statistics
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from dynamo_tpu_torch import run as trun
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime.context import Context

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "synthetic_tokenizer.json")
    t0 = time.perf_counter()
    data = synthetic_tokenizer_json()
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)
    t1 = time.perf_counter()
    tok = trun.load_tokenizer(path)
    t2 = time.perf_counter()
    cfg = engine.model_config
    if tok.vocab_size != cfg.vocab_size:
        fail(f"tokenizer has {tok.vocab_size} tokens, the model "
             f"{cfg.vocab_size}")
    print(f"[http] synthetic tokenizer: {tok.vocab_size} tokens, "
          f"{len(data.encode()) / 1e6:.1f} MB, made in {t1 - t0:.2f} s, "
          f"loaded in {t2 - t1:.2f} s", flush=True)
    # prompts of whole-text tokens, so their text splits where they do
    gen = torch.Generator().manual_seed(SEED + 5)
    whole = [i for i in torch.randint(256, N_REGULAR, (40_000,),
                                      generator=gen).tolist()
             if "�" not in tok.decode([i])]
    prompts = [whole[i * ISL:(i + 1) * ISL] for i in range(N_REQUESTS)]
    if len(prompts[-1]) != ISL:
        fail("not enough whole-text tokens for the prompts")
    encode_s = []
    for p in prompts:
        text = tok.decode(p)
        ts = time.perf_counter()
        tok.encode(text)
        encode_s.append(time.perf_counter() - ts)
    encode_ms = statistics.median(encode_s) * 1e3

    args = trun.parse_args([
        "in=http", "out=engine", "--model", "1b", "--tokenizer", path,
        "--model-name", HTTP_MODEL, "--host", "127.0.0.1", "--port", "0"])
    cmpl = "/v1/completions"

    def completion(p, stream: bool, max_tokens: int = OSL) -> dict:
        return {"model": HTTP_MODEL, "prompt": p, "max_tokens": max_tokens,
                "temperature": 0, "ignore_eos": True, "stream": stream}

    async def serve():
        loop = asyncio.get_running_loop()
        # the client runs in a process of its own: parsing 16 streams must
        # not share the server's interpreter lock
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))

        async def client(*jobs):
            return await loop.run_in_executor(procs, http_client, port,
                                              list(jobs))

        def job(path, body=None, method="POST", **kw):
            return dict(method=method, path=path, body=body, **kw)

        stop = asyncio.Event()
        ready = loop.create_future()
        server = asyncio.create_task(
            trun.run_http(engine, tok, args, stop=stop, ready=ready))
        try:
            port = (await ready).port
            await client(job("/health", method="GET"))   # client warm-up
            pa.reset_launches()
            # every run below starts with no prefix hits, as phase 3's do:
            # a hit changes the prefill's chunk shape, and bf16 rounding
            # with it (a near-tie of random weights can flip a token)
            cold = engine.scheduler.pool.clear
            # 1. served one at a time: HTTP text == decode(engine ids)
            wants = []
            for i, p in enumerate(prompts[:4]):
                req = {"token_ids": p, "max_tokens": OSL, "ignore_eos": True,
                       "temperature": 0.0}
                cold()
                ids = [t async for o in engine.generate(req, Context())
                       for t in o["token_ids"]]
                want = tok.decode(ids)
                wants.append(want)
                cold()
                (status, _, frames, done, body), = await client(
                    job(cmpl, completion(p, stream=i % 2 == 0)))
                if status != 200:
                    fail(f"{cmpl}: HTTP {status}: {body}")
                if i % 2:
                    got = body["choices"][0]["text"]
                    n = body["usage"]["completion_tokens"]
                else:
                    if not done:
                        fail("a streamed completion did not end in [DONE]")
                    got = "".join(f["choices"][0]["text"] for _, f in frames)
                    n = frames[-1][1]["usage"]["completion_tokens"]
                if n != OSL:
                    fail(f"usage.completion_tokens {n} != {OSL}")
                if len(ids) != OSL or got != want:
                    at = next((j for j, (a, b) in enumerate(zip(got, want))
                               if a != b), min(len(got), len(want)))
                    fail(f"served-alone request {i}: HTTP text differs from "
                         f"decode of the engine's {len(ids)} ids at char "
                         f"{at} of {len(got)} / {len(want)}: "
                         f"{got[at:at + 40]!r} vs {want[at:at + 40]!r}")
            print(f"[http] 4 completions served one at a time (2 streamed): "
                  f"text equals decode of the engine's own ids", flush=True)
            # 2. chat through the default template, streamed and not
            msgs = [{"role": "system", "content": "You are terse."},
                    {"role": "user", "content": "Name three prime numbers."}]
            chat = {"model": HTTP_MODEL, "messages": msgs, "max_tokens": 16}
            (status, _, _, _, body), (_, _, frames, done, _) = await client(
                job("/v1/chat/completions", chat),
                job("/v1/chat/completions", dict(chat, stream=True)))
            if status != 200 or not body["choices"][0]["finish_reason"] \
                    or body["usage"]["completion_tokens"] < 1:
                fail(f"chat: HTTP {status}: {body}")
            if not done or not frames \
                    or not frames[-1][1]["choices"][0]["finish_reason"]:
                fail("streamed chat did not finish with a reason and [DONE]")
            print(f"[http] chat x2 (template -> "
                  f"{body['usage']['prompt_tokens']} prompt tokens): 200, "
                  f"finish {body['choices'][0]['finish_reason']}", flush=True)
            # 3. phase 3's traffic, 16 concurrent streams, over HTTP and
            # straight into the engine on this same loop, at the default
            # interpreter switch interval (5 ms) and at 0.5 ms: the event
            # loop and the device-step thread take turns at one GIL
            async def over_http():
                cold()
                t_start = time.perf_counter()
                results = await client(*(job(cmpl, completion(p, True))
                                         for p in prompts))
                wall = time.perf_counter() - t_start
                runs = []
                for status, t_sent, frames, done, _ in results:
                    content = [t for t, f in frames
                               if f["choices"][0]["text"]]
                    n = frames[-1][1]["usage"]["completion_tokens"] \
                        if frames else 0
                    if status != 200 or not done or n != OSL \
                            or len(content) < 2 \
                            or not content[0] < content[-1]:
                        fail(f"concurrent stream: HTTP {status}, [DONE] "
                             f"{done}, {n} tokens, {len(content)} content "
                             f"frames")
                    runs.append((t_sent, content[0], content[-1], n))
                return traffic_stats(runs, wall)

            async def direct():
                cold()

                async def one(p):
                    t_sent, times = time.perf_counter(), []
                    req = {"token_ids": p, "max_tokens": OSL,
                           "ignore_eos": True, "temperature": 0.0}
                    async for o in engine.generate(req, Context()):
                        times += [time.perf_counter()] * len(o["token_ids"])
                    if len(times) != OSL:
                        fail(f"direct run: {len(times)} tokens")
                    return t_sent, times[0], times[-1], len(times)
                t_start = time.perf_counter()
                runs = await asyncio.gather(*(one(p) for p in prompts))
                return traffic_stats(runs, time.perf_counter() - t_start)

            # each step's dispatch (start, end) in the device-step thread
            # (the run-ahead loop waits for tokens on the fetch thread): is
            # the dispatch slower under HTTP, or the gap before the next?
            spans = []
            execute = engine._dispatch_batch

            def timed(batch):
                t0 = time.perf_counter()
                try:
                    return execute(batch)
                finally:
                    spans.append((t0, time.perf_counter()))
            engine._dispatch_batch = timed

            async def measured(run):
                spans.clear()
                stats = await run()
                busy = sorted(e - b for b, e in spans)
                gaps = sorted(b2 - e1 for (_, e1), (b2, _) in
                              zip(spans, spans[1:]))
                return dict(stats, steps=len(spans),
                            step_p50=busy[len(busy) // 2],
                            gap_p50=gaps[len(gaps) // 2],
                            gap_sum=sum(gaps))

            rows = {}
            try:
                for interval in (None, 0.0005):
                    old = sys.getswitchinterval()
                    if interval is not None:
                        sys.setswitchinterval(interval)
                    try:
                        rows["http", interval] = await measured(over_http)
                        rows["direct", interval] = await measured(direct)
                    finally:
                        sys.setswitchinterval(old)
            finally:
                del engine._dispatch_batch
            # 4. /metrics and /health
            served = 4 + 2 + 2 * N_REQUESTS
            (status, _, _, _, text), (h_status, *_) = await client(
                job("/metrics", method="GET"), job("/health", method="GET"))
            m = re.search(r'^dynamo_frontend_ttft_seconds_count\{model="'
                          + HTTP_MODEL + r'"\} (\S+)$', text, re.M)
            if status != 200 or m is None or float(m.group(1)) != served:
                fail(f"/metrics ttft_seconds_count "
                     f"{m and m.group(1)} != {served} requests served")
            if h_status != 200:
                fail(f"/health: HTTP {h_status}")
            # 5. a client that leaves mid-stream frees its seat and blocks
            pool_free = engine.scheduler.pool.num_free
            (_, _, frames, _, _), = await client(job(
                cmpl, completion(prompts[0], True, 4000), leave_after=5))
            t_left = time.perf_counter()
            sched = engine.scheduler
            # a finished sequence with a window in flight waits as a zombie
            # until the window lands, then releases its blocks
            while sched.running or sched.waiting or sched.zombies \
                    or sched.pool.num_free != pool_free:
                if time.perf_counter() - t_left > 1.0:
                    fail(f"1 s after its client left: {len(sched.running)} "
                         f"running, {len(sched.zombies)} zombie sequences, "
                         f"{sched.pool.num_free} of {pool_free} blocks free")
                await asyncio.sleep(0.005)
            freed = time.perf_counter() - t_left
            print(f"[http] client left after {len(frames)} frames: sequence"
                  f" gone and its KV blocks free {freed * 1e3:.1f} ms later",
                  flush=True)
            launches = {name: pa.LAUNCHES[name] for name in (
                "paged_attention_decode", "paged_attention_ragged")}
        finally:
            stop.set()
            await server
            procs.shutdown(wait=True)
        return rows, launches, wants

    rows, launches, wants = asyncio.run(serve())
    for name, n in launches.items():
        print(f"[http] {name} launches in phase 5: {n}")
        if n == 0:
            fail(f"{name} was never launched in the HTTP phase")

    line = stats_line
    print(f"[http] {card}: {N_REQUESTS} streams ISL {ISL} OSL {OSL} over "
          f"HTTP (client-side, client in its own process): "
          f"{line(rows['http', None])}; median encode of a {ISL}-token "
          f"prompt's text {encode_ms:.2f} ms", flush=True)
    print(f"[http] {card}: the same traffic straight into the engine, "
          f"phase 3: {line(direct)}; phase 5, same loop and prompts: "
          f"{line(rows['direct', None])}", flush=True)
    print(f"[http] {card}: switch interval 0.5 ms (default 5 ms): HTTP "
          f"{line(rows['http', 0.0005])}; direct "
          f"{line(rows['direct', 0.0005])}", flush=True)
    for (how, interval), r in rows.items():
        print(f"[http] {card}: {how}, switch interval "
              f"{(interval or sys.getswitchinterval()) * 1e3:.1f} ms: "
              f"{r['steps']} steps, dispatch in the device-step thread p50 "
              f"{r['step_p50'] * 1e3:.2f} ms, gap before the next p50 "
              f"{r['gap_p50'] * 1e3:.3f} ms (sum {r['gap_sum'] * 1e3:.1f} "
              f"ms)", flush=True)
    us = frontend_us_per_token(tok, prompts, OSL)
    print(f"[http] {card}: frontend host work per generated token and "
          f"stream (pipeline + SSE framing, {N_REQUESTS} streams on one "
          f"loop, no socket, no device): {us:.1f} us; x {N_REQUESTS} streams "
          f"= {us * N_REQUESTS / 1e3:.2f} ms per decode step", flush=True)
    return dict(tokenizer=path, prompts=prompts, wants=wants,
                texts=[tok.decode(p) for p in prompts],
                http=rows["http", None])

# ------------------------------ phase 6 ----------------------------------

DIST_LEASE_TTL_S = 2.0
# A SIGKILLed worker stays listed until its lease expires (at most the TTL
# plus the store's 0.25 s sweep after its last keepalive), and a migrated
# stream's retry may be routed to it meanwhile and spend an attempt on a
# refused connection (the JAX package does the same). 8 attempts, with
# Migration's doubling backoff from 0.05 s, outlast that window.
DIST_MIGRATION_LIMIT = 8
DIST_OSL_MIGRATE = 512
# the kill lands once every in-process token stream has this many of its
# 512 tokens, then at A's next load snapshot (<= 1 s later): with decode
# windows replayed as graphs a stream makes ~120 tokens a second, so a
# fixed delay could land after the streams end
DIST_KILL_AFTER_TOKENS = 64
DIST_LOGS = os.path.join("build", "dist")
# worker B's canary period (JAX default 10 s): the first canary lands
# within a second of B's start
DIST_CANARY_S = 1.0
# the control plane's settings on worker B (spec worker) and the frontends
DIST_CONTROL_ENV = dict(DYNTPU_SYSTEM_ENABLED="1",
                        DYNTPU_HEALTH_CHECK_ENABLED="1",
                        DYNTPU_HEALTH_CHECK_PERIOD_S=str(DIST_CANARY_S),
                        DYNTPU_PLANNER_APPLY_DEGRADATION="1")
# the KV frontend's router.select spans (worker_id, overlap_blocks)
KV_SPANS = os.path.join(DIST_LOGS, "kv_spans.jsonl")
KV_GROUPS = 4
KV_PREFIX_TOKENS = 448      # 28 blocks of 16, shared within a group


def kv_group_prompts():
    """Phase 6's shared-prefix traffic, as token ids: per group, a prefix of
    ``KV_PREFIX_TOKENS`` and six prompts of ISL tokens that continue it
    with tokens of their own (a warm-up, a check, 4 for the concurrent
    runs)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 6)

    def ids(n):
        return torch.randint(256, N_REGULAR, (n,), generator=gen).tolist()
    groups = []
    for _ in range(KV_GROUPS):
        prefix = ids(KV_PREFIX_TOKENS)
        groups.append([prefix + ids(ISL - KV_PREFIX_TOKENS)
                       for _ in range(6)])
    return groups


def read_jsonl(path):
    """The complete lines of a JSONL file another process appends to."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().split("\n")[:-1]]


def log_records(text: str):
    """The records of a log written with ``DYNTPU_JSONL_LOGGING=1``."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
    return out


def hash_us_per_prompt(n: int = 200):
    """Host µs to hash one ISL-token prompt into its chained block hashes
    at block size 16 (``compute_block_hashes_for_seq``, what the KV router
    runs per request): the C++ library's chain, the same chain in pure
    Python (``plain_block_hashes_for_seq``) and the blake2b chain the
    port's xxh3 replaced. Checks the reference's hashes of tokens 0..31
    first, and that the C++ and Python chains agree."""
    import hashlib
    import random
    import struct

    from dynamo_tpu_torch.tokens import (
        compute_block_hashes_for_seq, plain_block_hashes_for_seq,
    )

    want = [15310707395893867146, 7844343420941177057]
    for fn in (compute_block_hashes_for_seq, plain_block_hashes_for_seq):
        if fn(list(range(32)), 16) != want:
            fail(f"{fn.__name__}: block hashes of tokens 0..31 differ from "
                 "the JAX package's")
    key = struct.pack("<Q", 1337)

    def blake2b_chain(tokens, bs):
        out, parent = [], None
        for start in range(0, len(tokens) - bs + 1, bs):
            payload = struct.pack(f"<{bs}I", *tokens[start:start + bs])
            if parent is not None:
                payload = struct.pack("<Q", parent) + payload
            parent = int.from_bytes(hashlib.blake2b(
                payload, digest_size=8, key=key).digest(), "little")
            out.append(parent)
        return out
    rng = random.Random(SEED)
    tokens = [rng.randrange(N_REGULAR) for _ in range(ISL)]
    if compute_block_hashes_for_seq(tokens, 16) \
            != plain_block_hashes_for_seq(tokens, 16):
        fail("the C++ and Python block-hash chains differ")
    out = []
    for fn in (compute_block_hashes_for_seq, plain_block_hashes_for_seq,
               blake2b_chain):
        fn(tokens, 16)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(tokens, 16)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


def content_token_us():
    """Host µs of ``content_token`` over phase 16's two images: the C++
    XXH3 the processor runs, and the same hash in pure Python
    (``utils/xxh3.py``); checks they agree."""
    import numpy as np

    from dynamo_tpu_torch.multimodal.processor import content_token
    from dynamo_tpu_torch.utils.xxh3 import xxh3_64

    def plain(image, index):
        h = xxh3_64(np.ascontiguousarray(image, np.float32).tobytes(),
                    seed=index)
        return int(h & 0x7FFFFFFF) | 0x80000000
    images = mm_images()
    for i, img in enumerate(images):
        if content_token(img, i) != plain(img, i):
            fail(f"content_token of image {i}: C++ and Python differ")
    out = []
    for fn, reps in ((content_token, 50), (plain, 2)):
        t0 = time.perf_counter()
        for _ in range(reps):
            for i, img in enumerate(images):
                fn(img, i)
        out.append((time.perf_counter() - t0) / (reps * len(images)) * 1e6)
    return out, images[0].nbytes


def match_us(stored: dict, prompts, n: int = 200):
    """Host µs of one ``KvIndexer.find_matches`` over the index phase 6's
    KV router holds (the sequence hashes each worker's ``kv_events``
    stored), C++ beside the Python maps, for each of ``prompts``; checks
    both give the same scores."""
    from dynamo_tpu_torch.router.indexer import KvIndexer, RouterEvent
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_seq

    ixs = (KvIndexer(16), KvIndexer(16, use_native=False))
    for ix in ixs:
        for w, hashes in stored.items():
            ix.apply_event(RouterEvent(w, "stored", tuple(sorted(hashes))))
    queries = [compute_block_hashes_for_seq(p, 16) for p in prompts]
    for q in queries:
        if ixs[0].find_matches(q).scores != ixs[1].find_matches(q).scores:
            fail("find_matches: the C++ and Python indexers differ")
    out = []
    for ix in ixs:
        t0 = time.perf_counter()
        for _ in range(n):
            for q in queries:
                ix.find_matches(q)
        out.append((time.perf_counter() - t0) / (n * len(queries)) * 1e6)
    return out, ixs[1].num_blocks(), len(queries[0])


def grpc_client(port: int, jobs):
    """Run KServe jobs (dicts: ``method`` "infer" or "stream", ``text``,
    ``max_tokens``) concurrently over one channel of the port's own gRPC
    client. Returns, per job, (text, t_sent, arrival times of the
    responses that carried text, finish reason, error or None). Phase 6
    runs this in a client process of its own, as ``http_client``."""
    import asyncio

    from dynamo_tpu_torch.kserve import grpc as kgrpc
    from dynamo_tpu_torch.kserve import make_stub
    from dynamo_tpu_torch.kserve import messages as pb

    def request(job, i):
        return pb.ModelInferRequest(
            model_name=HTTP_MODEL, id=f"grpc-{i}",
            parameters={
                "max_tokens": pb.InferParameter(
                    int64_param=job["max_tokens"]),
                "temperature": pb.InferParameter(double_param=0.0),
                "ignore_eos": pb.InferParameter(bool_param=True)},
            inputs=[pb.ModelInferRequest.InferInputTensor(
                name="text_input", datatype="BYTES", shape=[1],
                contents=pb.InferTensorContents(
                    bytes_contents=[job["text"].encode()]))])

    async def one(stub, job, i):
        t_sent = time.perf_counter()
        try:
            if job["method"] == "infer":
                resp = await stub.ModelInfer(request(job, i), timeout=600)
                return (resp.outputs[0].contents.bytes_contents[0].decode(),
                        t_sent, [], resp.parameters["finish_reason"]
                        .string_param, None)
            call = stub.ModelStreamInfer(timeout=600)
            await call.write(request(job, i))
            await call.done_writing()
            parts, stamps, reason = [], [], None
            async for r in call:
                if r.error_message:
                    return ("".join(parts), t_sent, stamps, reason,
                            r.error_message)
                text = r.infer_response.outputs[0].contents \
                    .bytes_contents[0].decode()
                if text:
                    parts.append(text)
                    stamps.append(time.perf_counter())
                fr = r.infer_response.parameters.get("finish_reason")
                if fr is not None:
                    reason = fr.string_param
            return "".join(parts), t_sent, stamps, reason, None
        except kgrpc.RpcError as e:
            return "", t_sent, [], None, f"{e.code().name}: {e.details()}"

    async def run():
        chan = kgrpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            stub = make_stub(chan)
            return await asyncio.gather(*(one(stub, j, i)
                                          for i, j in enumerate(jobs)))
        finally:
            await chan.close()
    return asyncio.run(run())


class Child:
    """One entry point run as ``python -m MODULE ARGS`` in a process of its
    own, its output in ``build/dist/NAME.log``."""

    def __init__(self, name: str, module: str, args, env):
        os.makedirs(DIST_LOGS, exist_ok=True)
        self.name = name
        self.log_path = os.path.join(DIST_LOGS, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], stdout=self._log,
            stderr=subprocess.STDOUT, env=env)
        self.pid = self.proc.pid

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.text().splitlines()[-n:])

    async def wait_for(self, pattern: str, timeout: float):
        import asyncio

        deadline = time.monotonic() + timeout
        while True:
            m = re.search(pattern, self.text())
            if m:
                return m
            if self.proc.poll() is not None:
                fail(f"{self.name} exited ({self.proc.returncode}) before "
                     f"{pattern!r}:\n{self.tail()}")
            if time.monotonic() > deadline:
                fail(f"{self.name}: no {pattern!r} in {timeout} s:\n"
                     f"{self.tail()}")
            await asyncio.sleep(0.1)

    def cpu_s(self) -> float:
        """User + system CPU seconds so far (stat(5) fields 14 and 15)."""
        with open(f"/proc/{self.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) \
            / os.sysconf("SC_CLK_TCK")

    def opens_gpu(self) -> bool:
        """Whether the process holds a GPU device file open (a CUDA
        context does)."""
        for fd in os.listdir(f"/proc/{self.pid}/fd"):
            try:
                target = os.readlink(f"/proc/{self.pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                return True
        return False

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._log.close()


def smi_compute_pids() -> set:
    """PIDs that ``nvidia-smi`` lists as holding a CUDA context."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {int(x) for x in smi.stdout.split() if x.isdigit()}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def codec_us_per_token(n: int = 20000):
    """Host µs per streamed token of the transport's codec: what a worker
    packs (the output dict, then the data frame that carries it as its
    payload) and what the frontend unpacks (the frame, then the payload)."""
    from dynamo_tpu_torch.runtime import codec

    item = {"token_ids": [91234], "index": 17, "finished": False,
            "finish_reason": None, "num_prompt_tokens": ISL}
    rid = "0123456789abcdef0123456789abcdef-17"

    def pack():
        return codec.packb({"t": "data", "rid": rid,
                            "payload": codec.packb(item)})
    frame = pack()

    def unpack():
        return codec.unpackb(codec.unpackb(frame)["payload"])
    if unpack() != item:
        fail("codec round trip of a token frame changed it")
    out = []
    for fn in (pack, unpack):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


# phase 6's aggregated worker's numbers, which phase 7 compares with
DIST_STATS: dict = {}


def phase_dist(card: str, served: dict, direct: dict) -> dict:
    """The distributed path, three processes: the store, worker A and the
    frontend (``python -m dynamo_tpu_torch.runtime.store|worker|frontend``),
    then worker B. Checks: texts served one at a time equal phase 5's
    (decode of phase 3's engine ids), only the worker holds the GPU, 16
    concurrent streams end in ``[DONE]``, both workers publish load metrics
    and serve under round robin, a ``--router-mode kv`` frontend on the
    same store sends each prefix group's second request to the group's
    holder with >= 28 blocks matched, every stream through either frontend
    survives a SIGKILL of worker A mid-stream with its full token count, a
    migrated stream goes on at the join as worker B goes on from the
    prompt plus the tokens carried over, A's keys leave the store within
    the lease TTL + 1 s, worker B drains on SIGTERM and exits 0, both
    frontends exit 0, and both attention faces launched in every worker
    that served. Returns the workers' summed kernel launches, the
    KV-routed traffic's included."""
    import asyncio
    import importlib.util
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.llm.entrypoint import PushSink
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_seq
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    if os.path.exists(KV_SPANS):
        os.remove(KV_SPANS)
    env = dict(os.environ, DYNTPU_LEASE_TTL_S=str(DIST_LEASE_TTL_S),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{_free_port()}"
    worker_args = ["--model", "1b", "--model-name", HTTP_MODEL,
                   "--tokenizer", os.path.abspath(served["tokenizer"]),
                   "--store-addr", addr,
                   "--migration-limit", str(DIST_MIGRATION_LIMIT)]
    children = []
    faces = ("paged_attention_decode", "paged_attention_ragged")

    def start(name, module, args, **extra_env):
        child = Child(name, module, args, dict(env, **extra_env))
        children.append(child)
        return child

    def job(prompt, max_tokens, stream=True, port=None):
        out = dict(method="POST", path="/v1/completions", body={
            "model": HTTP_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": stream})
        if port is not None:
            out["port"] = port
        return out

    def greedy(ids, max_tokens):
        return {"token_ids": list(ids), "max_tokens": max_tokens,
                "temperature": 0.0, "ignore_eos": True}

    def check_streams(results, n_tokens, what):
        runs = []
        for status, t_sent, frames, done, _ in results:
            content = [t for t, f in frames if f["choices"][0]["text"]]
            n = frames[-1][1]["usage"]["completion_tokens"] if frames else 0
            if status != 200 or not done or n != n_tokens \
                    or len(content) < 2:
                fail(f"{what}: HTTP {status}, [DONE] {done}, {n} of "
                     f"{n_tokens} tokens, {len(content)} content frames")
            runs.append((t_sent, content[0], content[-1], n))
        return runs

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        rt = None
        collectors = []
        clients = []
        try:
            t0 = time.perf_counter()
            store = start("store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]])
            await store.wait_for(r"store listening", 60)
            worker_a = start("worker_a", "dynamo_tpu_torch.worker",
                             worker_args)
            f_sys = _free_port()
            front = start("frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr, "--grpc-port", "0"],
                          DYNTPU_SYSTEM_ENABLED="1",
                          DYNTPU_SYSTEM_PORT=str(f_sys))
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            grpc_port = int((await front.wait_for(
                r"kserve grpc on [\d.]+:(\d+)", 10)).group(1))
            await worker_a.wait_for(r"registered model", 300)

            async def client(*jobs):
                return await loop.run_in_executor(procs, http_client, port,
                                                  list(jobs))

            async def admin(sys_port, method, path):
                (status, _, _, _, body), = await client(dict(
                    method=method, path=path, port=sys_port))
                return status, body
            while True:
                (status, _, _, _, body), = await client(
                    dict(method="GET", path="/v1/models"))
                if status == 200 and any(m["id"] == HTTP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f"/v1/models never listed {HTTP_MODEL}: {body}")
                await asyncio.sleep(0.2)
            print(f"[dist] store, worker A (Llama-3.2-1B width, seed 0) "
                  f"and frontend up, /v1/models lists the model, in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            # only the worker holds the GPU
            smi_pids = smi_compute_pids()
            ours = {c.pid for c in (store, worker_a, front)}
            holds = {c.name: (c.pid in smi_pids or c.opens_gpu())
                     for c in (store, worker_a, front)}
            print(f"[dist] GPU holders: nvidia-smi compute apps "
                  f"{sorted(smi_pids)} (ours {sorted(smi_pids & ours)}); "
                  f"store {holds['store']}, worker A {holds['worker_a']}, "
                  f"frontend {holds['frontend']}", flush=True)
            if not holds["worker_a"] or holds["store"] or holds["frontend"]:
                fail(f"only worker A may hold the GPU: {holds}")

            rt = await DistributedRuntime.from_settings(RuntimeConfig(
                store_addr=addr, lease_ttl_s=DIST_LEASE_TTL_S))
            backend = rt.namespace().component("backend")
            gen_client = await backend.endpoint("generate").client()
            clear_client = await backend.endpoint("clear_kv_blocks").client()
            clients += [gen_client, clear_client]
            await gen_client.wait_for_instances(1, 30)
            await clear_client.wait_for_instances(1, 30)
            a_id, = gen_client.instance_ids()

            async def clear_all():
                # no prefix hit may change a prefill's shape (phase 5)
                for iid in clear_client.instance_ids():
                    async for _ in clear_client.direct(iid, {}, Context()):
                        pass

            # 1. served one at a time: the texts of phase 5
            for i, (p, want) in enumerate(zip(served["prompts"],
                                              served["wants"])):
                await clear_all()
                (status, _, frames, done, body), = await client(
                    job(p, OSL, stream=i % 2 == 0))
                if status != 200:
                    fail(f"distributed completion: HTTP {status}: {body}")
                if i % 2:
                    got = body["choices"][0]["text"]
                else:
                    if not done:
                        fail("a streamed completion did not end in [DONE]")
                    got = "".join(f["choices"][0]["text"] for _, f in frames)
                if got != want:
                    at = next((j for j, (a, b) in enumerate(zip(got, want))
                               if a != b), min(len(got), len(want)))
                    fail(f"distributed request {i}: text differs from phase "
                         f"5's at char {at}: {got[at:at + 40]!r} vs "
                         f"{want[at:at + 40]!r}")
            print(f"[dist] {len(served['wants'])} completions served one at "
                  f"a time (2 streamed): text equals decode of phase 3's "
                  f"engine ids", flush=True)

            # 1b. the same prompts as text, one at a time: the KServe gRPC
            # entry point (unary and streamed) gives /v1/completions' text
            for i, text in enumerate(served["texts"][:len(served["wants"])]):
                await clear_all()
                (status, _, _, _, body), = await client(dict(
                    method="POST", path="/v1/completions", body={
                        "model": HTTP_MODEL, "prompt": text,
                        "max_tokens": OSL, "temperature": 0,
                        "ignore_eos": True}))
                if status != 200:
                    fail(f"text completion {i}: HTTP {status}: {body}")
                want = body["choices"][0]["text"]
                for method in ("infer", "stream"):
                    await clear_all()
                    (got, _, _, reason, err), = \
                        await loop.run_in_executor(procs, grpc_client,
                                                   grpc_port, [dict(
                                                       method=method,
                                                       text=text,
                                                       max_tokens=OSL)])
                    if err or got != want or reason != "length":
                        at = next((j for j, (a, b) in enumerate(
                            zip(got, want)) if a != b),
                            min(len(got), len(want)))
                        fail(f"gRPC {method} of prompt {i}: error {err}, "
                             f"finish {reason}; text differs from HTTP's at "
                             f"char {at}: {got[at:at + 40]!r} vs "
                             f"{want[at:at + 40]!r}")
            print(f"[grpc] {len(served['wants'])} text prompts one at a time "
                  f"through the frontend's KServe gRPC port (the port's "
                  f"HTTP/2 client): ModelInfer and ModelStreamInfer text "
                  f"equals /v1/completions' on the same frontend and worker "
                  f"(greedy, {OSL} tokens, Llama-3.2-1B width)", flush=True)

            # 2. phase 3's traffic through the three processes
            prompts = served["prompts"]
            await clear_all()
            cpu0 = {c.name: c.cpu_s() for c in (store, worker_a, front)}
            t_start = time.perf_counter()
            results = await client(*(job(p, OSL) for p in prompts))
            wall = time.perf_counter() - t_start
            cpu = {c.name: c.cpu_s() - cpu0[c.name]
                   for c in (store, worker_a, front)}
            stats = traffic_stats(check_streams(results, OSL, "stream"),
                                  wall)
            DIST_STATS["aggregated"] = stats
            n_tok = N_REQUESTS * OSL
            print(f"[dist] {card}: {N_REQUESTS} streams ISL {ISL} OSL {OSL} "
                  f"through store + worker A + frontend (client in its own "
                  f"process): {stats_line(stats)}", flush=True)
            print(f"[dist] {card}: the same traffic, phase 3 (straight into "
                  f"the engine): {stats_line(direct)}; phase 5 (in-process "
                  f"HTTP): {stats_line(served['http'])}", flush=True)
            print(f"[dist] {card}: CPU time per generated token over the run "
                  f"({n_tok} tokens, {wall:.3f} s): worker A "
                  f"{cpu['worker_a'] / n_tok * 1e3:.3f} ms, frontend "
                  f"{cpu['frontend'] / n_tok * 1e3:.3f} ms, store "
                  f"{cpu['store'] / n_tok * 1e3:.4f} ms", flush=True)

            # the same traffic as text prompts, over HTTP SSE and then
            # over gRPC streams: TTFT / ITL side by side
            texts = served["texts"]
            await clear_all()
            t_start = time.perf_counter()
            results = await client(*(dict(
                method="POST", path="/v1/completions", body={
                    "model": HTTP_MODEL, "prompt": t, "max_tokens": OSL,
                    "temperature": 0, "ignore_eos": True, "stream": True})
                for t in texts))
            sse = traffic_stats(check_streams(results, OSL, "text stream"),
                                time.perf_counter() - t_start)
            await clear_all()
            t_start = time.perf_counter()
            results = await loop.run_in_executor(
                procs, grpc_client, grpc_port,
                [dict(method="stream", text=t, max_tokens=OSL)
                 for t in texts])
            wall = time.perf_counter() - t_start
            runs = []
            for text, t_sent, stamps, reason, err in results:
                if err or reason != "length" or len(stamps) < 2:
                    fail(f"gRPC stream: error {err}, finish {reason}, "
                         f"{len(stamps)} text responses")
                runs.append((t_sent, stamps[0], stamps[-1], OSL))
            over_grpc = traffic_stats(runs, wall)
            print(f"[grpc] {card}: {N_REQUESTS} streams of phase 5's "
                  f"prompts as text, OSL {OSL}, through store + worker A + "
                  f"frontend (client in its own process): gRPC "
                  f"ModelStreamInfer {stats_line(over_grpc)}; HTTP SSE "
                  f"/v1/completions, same traffic: {stats_line(sse)}",
                  flush=True)

            cpp_us, py_us, blake2b_us = hash_us_per_prompt()
            has_xxhash = importlib.util.find_spec("xxhash") is not None
            print(f"[hash] {card}: block hashes of one {ISL}-token prompt "
                  f"at block size 16 ({ISL // 16} blocks) on this host: "
                  f"C++ (csrc/dynamo_native.cpp) {cpp_us:.1f} us, the same "
                  f"chain in pure Python {py_us:.1f} us, the blake2b chain "
                  f"the port's xxh3 replaced {blake2b_us:.1f} us; xxhash is "
                  + ("installed here, not timed (this script imports none "
                     "of it)" if has_xxhash else "not installed here"),
                  flush=True)
            (ct_cpp, ct_py), nbytes = content_token_us()
            print(f"[hash] {card}: content_token of phase 16's image "
                  f"({nbytes} bytes of float32) on this host: C++ "
                  f"{ct_cpp:.1f} us, pure Python {ct_py:.1f} us", flush=True)
            pack_us, unpack_us = codec_us_per_token()
            print(f"[dist] {card}: codec per streamed token on this host: "
                  f"worker packs payload + frame {pack_us:.2f} us, frontend "
                  f"unpacks frame + payload {unpack_us:.2f} us; x "
                  f"{N_REQUESTS} streams = {pack_us * N_REQUESTS / 1e3:.3f} "
                  f"ms of worker loop per decode step", flush=True)

            # 3. two workers: load metrics, round robin, migration
            snaps = {}
            sub = await rt.store.subscribe(
                backend.event_subject("load_metrics"))

            async def collect():
                async for ev in sub:
                    if ev.get("event") != "msg":
                        continue
                    snap = codec.unpackb(ev["value"])
                    # a worker's first snapshot may leave before its
                    # launch counts are attached
                    if "kernel_launches" in snap:
                        snaps.setdefault(int(snap["worker_id"]),
                                         []).append((time.perf_counter(), snap))
            # the sequence hashes each worker's kv_events say it holds: the
            # KV frontend's router reads the same messages
            stored = {}
            kv_sub = await rt.store.subscribe(
                backend.event_subject("kv_events"))

            async def collect_kv():
                async for ev in kv_sub:
                    if ev.get("event") != "msg":
                        continue
                    msg = codec.unpackb(ev["value"])
                    held = stored.setdefault(int(msg["worker_id"]), set())
                    kind = msg["event"]["kind"]
                    blocks = msg["event"].get("blocks", ())
                    if kind == "stored":
                        held.update(b["seq_hash"] for b in blocks)
                    elif kind == "removed":
                        held.difference_update(blocks)
                    else:
                        held.clear()
            collectors += [asyncio.create_task(collect()),
                           asyncio.create_task(collect_kv())]
            t_b = time.perf_counter()
            b_sys = _free_port()
            worker_b = start("worker_b", "dynamo_tpu_torch.worker",
                             [*worker_args, "--spec-mode", "ngram",
                              "--spec-k", str(SPEC_K)],
                             DYNTPU_SYSTEM_PORT=str(b_sys),
                             **DIST_CONTROL_ENV)
            await gen_client.wait_for_instances(2, 300)
            await clear_client.wait_for_instances(2, 30)
            b_id, = [i for i in gen_client.instance_ids() if i != a_id]
            print(f"[dist] worker B up in {time.perf_counter() - t_b:.1f} s",
                  flush=True)
            while not (snaps.get(a_id) and snaps.get(b_id)):
                if time.perf_counter() - t_b > 330:
                    fail(f"load metrics from {sorted(snaps)}, want both "
                         f"{a_id} and {b_id}")
                await asyncio.sleep(0.1)

            # the control plane on B: the canary probe on /health, /live,
            # and the frontend's own system server
            t_cp = time.perf_counter()
            while True:
                status, health = await admin(b_sys, "GET", "/health")
                canary = (health.get("probes", {}).get("backend/generate",
                                                       {})
                          if isinstance(health, dict) else {})
                if canary.get("probes", 0) >= 1:
                    break
                if time.perf_counter() - t_cp > 30:
                    fail(f"worker B's /health never ran its canary: "
                         f"{status} {health}")
                await asyncio.sleep(0.2)
            live = await admin(b_sys, "GET", "/live")
            f_health = await admin(f_sys, "GET", "/health")
            f_live = await admin(f_sys, "GET", "/live")
            print(f"[control] worker B (--spec-mode ngram) /health: HTTP "
                  f"{status} {json.dumps(health)}; /live {live}; frontend "
                  f"/health {f_health}, /live {f_live}; B's load snapshot "
                  f"spec {snaps[b_id][-1][1].get('spec')}, obs keys "
                  f"{len(snaps[b_id][-1][1].get('obs', {}))} (in "
                  f"{time.perf_counter() - t_cp:.1f} s)", flush=True)
            if status != 200 or canary.get("healthy") is not True \
                    or live != (200, {"live": True}) \
                    or f_health[0] != 200 or f_live != (200, {"live": True}) \
                    or "spec" not in snaps[b_id][-1][1] \
                    or "obs" not in snaps[b_id][-1][1]:
                fail("worker B's or the frontend's control plane did not "
                     "answer as expected")

            def decode_launches(wid):
                return snaps[wid][-1][1]["kernel_launches"][faces[0]]
            before = {w: decode_launches(w) for w in (a_id, b_id)}
            before_r = {w: snaps[w][-1][1]["kernel_launches"][faces[1]]
                        for w in (a_id, b_id)}
            await clear_all()
            t_rr = time.perf_counter()
            results = await client(*(job(p, OSL) for p in prompts))
            check_streams(results, OSL, "round-robin stream")
            await asyncio.sleep(1.5)   # one more snapshot from each
            for w, name in ((a_id, "A"), (b_id, "B")):
                running = max((s["num_requests_running"]
                               for t, s in snaps[w] if t >= t_rr), default=0)
                grew = decode_launches(w) - before[w]
                grew_r = (snaps[w][-1][1]["kernel_launches"][faces[1]]
                          - before_r[w])
                print(f"[dist] worker {name} under {N_REQUESTS} round-robin "
                      f"streams: load metrics show up to {running} running "
                      f"requests, {grew} more decode-face and {grew_r} more "
                      f"ragged-face launches", flush=True)
                # worker B's verify windows run the ragged face
                if (grew if name == "A" else grew_r) <= 0:
                    fail(f"worker {name} served nothing under round robin")
            # B's engine gauges after the traffic (refreshed at each load
            # snapshot, over the recorder's trailing 10 s)
            status, text = await admin(b_sys, "GET", "/metrics")
            m = re.search(r'^dynamo_engine_mfu_by_class\{step="decode"\} '
                          r'(\S+)$', text or "", re.M)
            waste = re.search(r'^dynamo_engine_wasted_flops_ratio\{cause='
                              r'"spec_reject"\} (\S+)$', text or "", re.M)
            print(f"[control] worker B /metrics after the traffic: HTTP "
                  f"{status}, engine_mfu_by_class{{step=\"decode\"}} "
                  f"{m.group(1) if m else None}, engine_wasted_flops_ratio"
                  f"{{cause=\"spec_reject\"}} "
                  f"{waste.group(1) if waste else None}", flush=True)
            if status != 200 or not m or float(m.group(1)) <= 0 or not waste:
                fail("worker B's /metrics lacks the decode MFU or the "
                     "spec_reject waste gauge")

            # 4. the KV-aware router: a second frontend on the same store
            name_of = {a_id: "A", b_id: "B"}
            t_kv = time.perf_counter()
            kv_sys = _free_port()
            kv_front = start(
                "frontend_kv", "dynamo_tpu_torch.frontend",
                ["--host", "127.0.0.1", "--port", "0", "--store-addr", addr,
                 "--router-mode", "kv", "--max-concurrent-requests", "64"],
                DYNTPU_SYSTEM_ENABLED="1", DYNTPU_SYSTEM_PORT=str(kv_sys),
                DYNTPU_TRACE_SAMPLE_RATIO="1",
                DYNTPU_TRACE_EXPORT_PATH=os.path.abspath(KV_SPANS),
                DYNTPU_JSONL_LOGGING="1")
            kv_port = int((await kv_front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            while True:
                (status, _, _, _, body), = await client(dict(
                    method="GET", path="/v1/models", port=kv_port))
                if status == 200 and any(m["id"] == HTTP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t_kv > 60:
                    fail(f"the KV frontend never listed {HTTP_MODEL}: {body}")
                await asyncio.sleep(0.2)
            print(f"[dist] KV frontend (--router-mode kv) up on the same "
                  f"store in {time.perf_counter() - t_kv:.1f} s", flush=True)
            groups = kv_group_prompts()

            def selections():
                return [s for s in read_jsonl(KV_SPANS)
                        if s["name"] == "router.select"]

            async def one_by_one(ps, port):
                sels = []
                for p in ps:
                    n = len(selections())
                    results = await client(job(p, OSL, port=port))
                    check_streams(results, OSL, "shared-prefix stream")
                    new = selections()[n:]
                    sels.append(new[-1]["attrs"] if new else None)
                return sels

            def cached_tokens():
                # prefix-cache hits are counted in blocks of 16 tokens
                return {w: snaps[w][-1][1]["prefix_cache_hits"] * 16
                        for w in (a_id, b_id)}

            await clear_all()
            sels = await one_by_one([g[0] for g in groups], kv_port)
            if None in sels:
                fail(f"the KV frontend exported no router.select span for "
                     f"a request: {sels}")
            holders = [s["worker_id"] for s in sels]
            prefixes = [set(compute_block_hashes_for_seq(
                g[0][:KV_PREFIX_TOKENS], 16)) for g in groups]
            t_ix = time.perf_counter()
            while not all(p <= stored.get(h, set())
                          for p, h in zip(prefixes, holders)):
                if time.perf_counter() - t_ix > 30:
                    fail("the holders' kv_events never carried every "
                         "prefix block of the first requests")
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.5)   # the KV frontend applies the same
            checks = await one_by_one([g[1] for g in groups], kv_port)
            if None in checks:
                fail(f"the KV frontend exported no router.select span for "
                     f"a request: {checks}")
            print(f"[dist] KV router, {KV_GROUPS} prefix groups of "
                  f"{KV_PREFIX_TOKENS} tokens ({KV_PREFIX_TOKENS // 16} "
                  f"blocks) + {ISL - KV_PREFIX_TOKENS} own, one request at "
                  f"a time: first requests on "
                  + ", ".join(name_of[w] for w in holders)
                  + "; second requests on " + ", ".join(
                      f"{name_of.get(s['worker_id'])} with "
                      f"{s['overlap_blocks']} blocks" for s in checks),
                  flush=True)
            for g, (h, s) in enumerate(zip(holders, checks)):
                if s["worker_id"] != h \
                        or s["overlap_blocks"] < KV_PREFIX_TOKENS // 16:
                    fail(f"group {g}'s second request went to "
                         f"{name_of.get(s['worker_id'])} with "
                         f"{s['overlap_blocks']} blocks, not to its holder "
                         f"{name_of[h]} with >= {KV_PREFIX_TOKENS // 16}")

            # the same 16 shared-prefix requests through each frontend
            concurrent = [p for g in groups for p in g[2:]]
            for mode, fport in (("kv", kv_port), ("round robin", port)):
                if mode != "kv":
                    await clear_all()
                    await one_by_one([g[0] for g in groups], fport)
                await asyncio.sleep(1.2)   # a snapshot after the warm-up
                hits0 = cached_tokens()
                n = len(selections())
                t_run = time.perf_counter()
                results = await client(*(job(p, OSL, port=fport)
                                         for p in concurrent))
                wall = time.perf_counter() - t_run
                stats = traffic_stats(check_streams(
                    results, OSL, f"{mode} shared-prefix stream"), wall)
                await asyncio.sleep(1.5)   # one more snapshot from each
                hits = {w: c - hits0[w] for w, c in cached_tokens().items()}
                served_by = [s["attrs"]["worker_id"]
                             for s in selections()[n:]]
                print(f"[dist] {card}: {len(concurrent)} concurrent "
                      f"shared-prefix streams (4 per group) through the "
                      f"{mode} frontend: {stats_line(stats)}; " + ", ".join(
                          f"worker {name_of[w]} "
                          + (f"served {served_by.count(w)} requests, "
                             if mode == "kv" else "")
                          + f"{hits[w]} prompt tokens from cache"
                          for w in (a_id, b_id)), flush=True)
            select_ms = sorted(s["duration_s"] * 1e3 for s in selections())
            print(f"[dist] KV router: {len(select_ms)} selections, "
                  f"router.select span p50 "
                  f"{select_ms[len(select_ms) // 2]:.3f} ms max "
                  f"{select_ms[-1]:.3f} ms (hash of the prompt, index "
                  f"match, cost function)", flush=True)
            (m_cpp, m_py), n_blocks, depth = match_us(
                stored, [p for g in groups for p in g[:2]])
            print(f"[hash] {card}: KvIndexer.find_matches of a {depth}-block "
                  f"prompt over phase 6's index ({n_blocks} blocks on "
                  f"{len(stored)} workers, from their kv_events) on this "
                  f"host: C++ {m_cpp:.2f} us, Python maps {m_py:.2f} us",
                  flush=True)

            # 5. a degradation order in the store (what the planner writes):
            # the KV frontend, which has an admission controller, sheds tier
            # 0 and admits tier 3; B's watcher gets the spec_k clamp; then
            # NO_DEGRADATION admits tier 0 again
            from dynamo_tpu_torch.planner.degradation import (
                NO_DEGRADATION, DegradationLadder,
            )
            t_deg = time.perf_counter()
            ladder = DegradationLadder()
            while "clamp_spec_k" not in ladder.engaged:
                ladder.update(2.0)
            order = ladder.actions()
            deg_key = f"planner/{rt.namespace().name}/degradation"

            async def tiers():
                results = await client(*(dict(
                    method="POST", path="/v1/completions", port=kv_port,
                    headers={"X-Request-Tier": tier},
                    body={"model": HTTP_MODEL, "prompt": prompts[0],
                          "max_tokens": 4, "temperature": 0,
                          "ignore_eos": True}) for tier in ("0", "3")))
                return [r[0] for r in results]

            async def order_until(actions, want):
                await rt.store.put(deg_key, json.dumps(
                    dict(actions, ts=time.time())).encode())
                t_put = time.perf_counter()
                while True:
                    got = await tiers()
                    if got == want:
                        return time.perf_counter() - t_put
                    if time.perf_counter() - t_put > 15:
                        fail(f"degradation order {actions}: tiers 0 and 3 "
                             f"answer {got}, want {want}")
                    await asyncio.sleep(0.1)
            if await tiers() != [200, 200]:
                fail("tier 0 or 3 refused before any degradation order")
            shed_s = await order_until(order, [429, 200])
            clamp = await worker_b.wait_for(
                r"degradation orders applied to engine: .*"
                r"|degradation on_change failed[\s\S]*?\n([\w.]*Error: [^\n]*)",
                10)
            reopen_s = await order_until(dict(NO_DEGRADATION), [200, 200])
            print(f"[control] degradation order {json.dumps(order)} in "
                  f"{deg_key}: the KV frontend answered tier 0 with 429 and "
                  f"tier 3 with 200 {shed_s * 1e3:.0f} ms after the write; "
                  f"worker B: {clamp.group(1) or clamp.group(0)!r}; "
                  f"NO_DEGRADATION admitted tier 0 again {reopen_s * 1e3:.0f}"
                  f" ms after its write ({time.perf_counter() - t_deg:.1f} s "
                  f"in all)", flush=True)

            class Recorder(PushSink):
                """The frontend's routing sink, noting how many tokens its
                stream had yielded when each attempt was issued."""

                def __init__(self, got):
                    super().__init__(gen_client)
                    self.got, self.joins = got, []

                def generate(self, request, context):
                    self.joins.append(len(self.got))
                    return super().generate(request, context)

            progress = []

            async def token_stream(prompt):
                # the frontend's Migration over the generate endpoint, seen
                # as token ids
                got = []
                progress.append(got)
                sink = Recorder(got)
                async for item in Migration(sink, DIST_MIGRATION_LIMIT) \
                        .generate(greedy(prompt, DIST_OSL_MIGRATE), Context()):
                    got.extend(item.get("token_ids", []))
                return prompt, got, sink.joins

            # 4 streams through each frontend, so that both sinks are held
            # across the kill
            await clear_all()
            fut = asyncio.ensure_future(client(
                *(job(p, DIST_OSL_MIGRATE) for p in prompts[:4]),
                *(job(p, DIST_OSL_MIGRATE, port=kv_port)
                  for p in prompts[4:8])))
            token_futs = [asyncio.ensure_future(token_stream(p))
                          for p in prompts[8:16]]
            t_wait = time.perf_counter()
            while (len(progress) < len(token_futs)
                   or min(map(len, progress)) < DIST_KILL_AFTER_TOKENS):
                if time.perf_counter() - t_wait > 60:
                    fail("token streams did not reach "
                         f"{DIST_KILL_AFTER_TOKENS} tokens within 60 s")
                await asyncio.sleep(0.002)
            # kill right after A's next load snapshot, so the launch counts
            # it carries miss only the last milliseconds of A's work
            n_snaps = len(snaps[a_id])
            while len(snaps[a_id]) == n_snaps:
                await asyncio.sleep(0.002)
            a_launches = dict(snaps[a_id][-1][1]["kernel_launches"])
            n_sel = len(selections())
            t_kill, t_kill_unix = time.perf_counter(), time.time()
            worker_a.kill()
            while True:
                keys = [k for root_ in ("v1/instances/", "v1/models/")
                        for k, _ in await rt.store.get_prefix(root_)]
                if not any(k.endswith(f"/{a_id}") for k in keys):
                    break
                if time.perf_counter() - t_kill > DIST_LEASE_TTL_S + 1:
                    fail(f"worker A's keys still in the store "
                         f"{DIST_LEASE_TTL_S + 1} s after SIGKILL: {keys}")
                await asyncio.sleep(0.05)
            t_gone = time.perf_counter() - t_kill
            results = await fut
            check_streams(results, DIST_OSL_MIGRATE, "stream across SIGKILL")
            gaps = [sorted(min(t for t, f in frames
                               if t > t_kill and f["choices"][0]["text"])
                           - t_kill for _, _, frames, _, _ in part)
                    for part in (results[:4], results[4:])]
            # one log line per re-issue; a re-issue routed to A before its
            # lease expired (or, under the KV router, before A's breaker
            # opened) is refused and re-issued again
            reissued = [front.text().count("migrating with"),
                        kv_front.text().count("migrating with")]
            print(f"[dist] SIGKILL of worker A mid-stream: all 8 streams "
                  f"(4 per frontend) ended in [DONE] with "
                  f"{DIST_OSL_MIGRATE} tokens; A's instance and model keys "
                  f"left the store {t_gone * 1e3:.0f} ms after the kill "
                  f"(TTL {DIST_LEASE_TTL_S} s)", flush=True)
            # the KV frontend's re-issues are router.select spans of the
            # killed streams' traces
            killed = {s["trace_id"] for s in selections()[:n_sel]
                      if s["attrs"]["worker_id"] == a_id}
            reissues = [(s["start_unix"] - t_kill_unix,
                         name_of.get(s["attrs"]["worker_id"]),
                         s["attrs"]["overlap_blocks"])
                        for s in selections()[n_sel:]
                        if s["trace_id"] in killed]
            opened = [rec["ts"] - t_kill_unix
                      for rec in log_records(kv_front.text())
                      if "circuit OPEN" in rec.get("message", "")]
            for mode, part, n in zip(("round robin", "kv"), gaps, reissued):
                print(f"[dist] {mode} frontend across the kill: {n} "
                      f"re-issues by Migration (limit {DIST_MIGRATION_LIMIT} "
                      f"per stream); kill to each stream's next token: "
                      + ", ".join(f"{g * 1e3:.0f}" for g in part) + " ms",
                      flush=True)
            print(f"[dist] KV frontend re-issues (ms after the kill, "
                  f"instance, overlap blocks): " + ", ".join(
                      f"({t * 1e3:.0f}, {w}, {o})" for t, w, o in reissues)
                  + "; A's breaker opened " + (", ".join(
                      f"{t * 1e3:.0f}" for t in opened) + " ms after the kill"
                      if opened else "never"), flush=True)
            if not reissued[0] or not reissued[1] or not reissues:
                fail(f"a frontend migrated no stream off the killed worker: "
                     f"{reissued} re-issues, KV spans {reissues}")

            # The join, token by token: a migrated stream's next token must
            # be the one B makes of the prompt plus the carried tokens,
            # served alone. A Migration that loses the carried tokens, or
            # repeats or skips one at the join, departs there in every
            # migrated stream; bf16 near-ties (another batch, another
            # split-KV split) part streams one by one, within 16 tokens in
            # 7 of 12 migrated streams on an H100, the first token in none.
            joins = []
            for prompt, got, tried in await asyncio.gather(*token_futs):
                if len(got) != DIST_OSL_MIGRATE:
                    fail(f"token stream across SIGKILL: {len(got)} of "
                         f"{DIST_OSL_MIGRATE} tokens")
                if len(tried) < 2:
                    continue
                k = tried[-1]
                await clear_all()
                want = [t async for item in gen_client.direct(
                    b_id, greedy([*prompt, *got[:k]], 16), Context())
                        for t in item.get("token_ids", [])]
                agree = next((i for i, (a, b) in
                              enumerate(zip(got[k:], want)) if a != b),
                             len(want))
                joins.append((k, len(tried) - 1, agree))
            departed = sum(1 for _, _, agree in joins if agree == 0)
            print(f"[dist] {len(joins)} of 8 token-level streams migrated "
                  f"(carried tokens, re-issues, tokens after the join equal "
                  f"to B's alone, of 16): " + ", ".join(
                      f"({k}, {n}, {a})" for k, n, a in joins), flush=True)
            if len(joins) < 2 or departed == len(joins):
                fail(f"migrated streams depart from B's continuation at the "
                     f"join: {joins}")

            # worker B leaves by its system server's POST /drain
            t_drain = time.perf_counter()
            drain = await admin(b_sys, "POST", "/drain")
            rc = await loop.run_in_executor(None, worker_b.proc.wait, 120)
            drain_s = time.perf_counter() - t_drain
            log_b = worker_b.text()
            # B revokes its lease as it closes; if the revoke is lost, the
            # lease expires within its TTL
            while True:
                keys = [k for root_ in ("v1/instances/", "v1/models/")
                        for k, _ in await rt.store.get_prefix(root_)
                        if k.endswith(f"/{b_id}")]
                if not keys or time.perf_counter() - t_drain > \
                        drain_s + DIST_LEASE_TTL_S + 1:
                    break
                await asyncio.sleep(0.05)
            print(f"[control] POST /drain to worker B: {drain}; B exited "
                  f"{rc} after {drain_s:.2f} s, its keys left in the store: "
                  f"{keys}", flush=True)
            if drain != (202, {"draining": ["dynamo/backend/generate"]}) \
                    or rc != 0 or "drain requested" not in log_b or keys:
                fail(f"worker B on POST /drain: {drain}, exit {rc}, keys "
                     f"{keys}\n{worker_b.tail()}")
            m = re.search(r"worker exiting: kernel launches (.*)", log_b)
            b_launches = {k: int(v) for k, v in
                          (kv.split("=") for kv in m.group(1).split())}
            for f in (front, kv_front):
                f.proc.send_signal(signal.SIGTERM)
                rc = await loop.run_in_executor(None, f.proc.wait, 60)
                if rc != 0:
                    fail(f"{f.name} on SIGTERM: exit {rc}\n{f.tail()}")
            launches = {}
            # B decodes through spec windows, which run the ragged face
            for name, counts, need in (("A", a_launches, faces),
                                       ("B", b_launches, faces[1:])):
                print(f"[dist] worker {name} kernel launches: " + ", ".join(
                    f"{f} {counts[f]}" for f in faces), flush=True)
                for f in need:
                    if counts[f] == 0:
                        fail(f"{f} was never launched in worker {name}")
            for name in KERNELS:
                launches[name] = a_launches[name] + b_launches[name]
            print(f"[dist] phase 6 in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return launches
        finally:
            for task in collectors:
                task.cancel()
            for c in clients:
                await c.stop()
            if rt is not None:
                await rt.shutdown()
            procs.shutdown(wait=True)
            for child in children:
                child.kill()

    return asyncio.run(run())


# ------------------------- phase 7: KV movement ---------------------------

KV_BLOCKS = ISL // 16          # one 512-token prompt: 32 blocks of 16
KV_LOGS = os.path.join(DIST_LOGS, "kvmove")
# a stream is evacuated once every seat has emitted this many tokens
EVAC_AFTER_TOKENS = 16


def same_bytes(a, b) -> bool:
    """Bitwise equality of two tensors of one shape and dtype."""
    import torch

    a, b = a.contiguous(), b.contiguous()
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def kv_round_trip(card: str) -> None:
    """(a) ``make_kv_ops`` on the card at Llama-3.2-1B width (16 layers, 8
    KV heads, hd 64, block 16): gather 32 random blocks of a random cache
    to pinned host memory and scatter them into 32 other blocks in place,
    for bf16, int8 and fp8 pages (scales too); the host payload must equal
    a plain host copy of the cache bit for bit, the scattered blocks too,
    the cache tensors must keep their storage, and the decode face over the
    injected blocks must agree with its plain version. Prints the bf16
    gather + copy to pinned memory (ms, GB/s) for one 512-token prompt
    (16 MiB)."""
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = ModelConfig.llama3_1b()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    perm = torch.randperm(159, generator=torch.Generator().manual_seed(
        SEED)) + 1
    src, dst = perm[:KV_BLOCKS], perm[KV_BLOCKS:2 * KV_BLOCKS]
    for kv in ("bf16", "int8", "fp8"):
        eng = EngineConfig(num_blocks=160, kv_dtype=kv)
        cache = model_lib.init_cache(cfg, eng, torch.device(DEV))
        for key, layers in cache.items():
            for t in layers:
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          device=DEV, dtype=torch.int8))
                elif key in ("ks", "vs"):
                    t.copy_(torch.rand(t.shape, generator=gen, device=DEV)
                            * 0.05 + 1e-3)
                else:
                    t.copy_(torch.randn(t.shape, generator=gen, device=DEV)
                            .to(t.dtype))
        host = {key: [t.cpu() for t in layers]
                for key, layers in cache.items()}
        want = {key: torch.stack([t[src] for t in layers])
                for key, layers in host.items()}
        ptrs = {key: [t.data_ptr() for t in layers]
                for key, layers in cache.items()}
        extract, inject = model_lib.make_kv_ops(eng)
        src_d = src.to(DEV, torch.int32)
        dst_d = dst.to(DEV, torch.int32)

        def gather_to_host():
            data = extract(cache, src_d)
            out = {}
            for key, a in data.items():
                out[key] = torch.empty(a.shape, dtype=a.dtype,
                                       pin_memory=True)
                out[key].copy_(a, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            return data, out
        data, got = gather_to_host()
        for key in want:
            if not same_bytes(got[key], want[key]):
                fail(f"[kvmove] {kv}: extracted {key} differs from the "
                     f"plain host copy")
        inject(cache, dst_d, data)
        torch.cuda.synchronize()
        for key, layers in cache.items():
            for li, t in enumerate(layers):
                if t.data_ptr() != ptrs[key][li]:
                    fail(f"[kvmove] {kv}: inject rebound cache[{key}][{li}]")
                if not same_bytes(t[dst_d].cpu(), want[key][li]):
                    fail(f"[kvmove] {kv}: injected {key} layer {li} differs "
                         f"from the source blocks")
                other = perm[2 * KV_BLOCKS:].to(DEV)
                if not same_bytes(t[other].cpu(), host[key][li][
                        perm[2 * KV_BLOCKS:]]):
                    fail(f"[kvmove] {kv}: inject wrote outside its blocks")
        # the decode face over the injected blocks, every layer's pages
        q = torch.randn(2, cfg.num_heads, cfg.head_dim_, generator=gen,
                        device=DEV).to(torch.bfloat16)
        i32 = dict(dtype=torch.int32, device=DEV)
        tables = torch.stack([dst_d, dst_d.flip(0)])
        lens = torch.tensor([ISL, ISL - 37], **i32)
        worst = 0.0
        for li in range(cfg.num_layers):
            sc = {}
            if kv != "bf16":
                sc = dict(k_scale=cache["ks"][li], v_scale=cache["vs"][li])
            o = pa.paged_attention_decode(
                q, cache["k"][li], cache["v"][li], tables, lens,
                block_size=16, **sc)
            p = pa.paged_attention_ragged_plain(
                q, cache["k"][li], cache["v"][li], tables,
                torch.tensor([0, 1, 2], **i32), torch.ones(2, **i32), lens,
                block_size=16, max_q_len=1, **sc)
            atol, rtol = TOL["bfloat16"]
            err = (o.float() - p.float()).abs()
            if not torch.isfinite(o).all() or \
                    (err - rtol * p.float().abs()).max().item() > atol:
                fail(f"[kvmove] {kv}: decode face over injected KV "
                     f"disagrees with its plain version (layer {li})")
            worst = max(worst, err.max().item())
        nbytes = sum(a.numel() * a.element_size() for a in data.values())
        line = (f"[kvmove] {card}: round trip {kv}: {KV_BLOCKS} blocks "
                f"({nbytes / 2**20:.2f} MiB with "
                f"{'scales' if kv != 'bf16' else 'no scales'}) gathered to "
                f"pinned host memory and scattered in place: bitwise equal "
                f"to the plain host copy; decode face over the injected "
                f"blocks vs plain, 16 layers, max |diff| {worst:.2e}")
        if kv == "bf16":
            times = []
            for _ in range(12):
                t0 = time.perf_counter()
                gather_to_host()
                times.append(time.perf_counter() - t0)
            ms = sorted(times[2:])[len(times[2:]) // 2] * 1e3
            line += (f"; gather + copy to pinned host p50 {ms:.3f} ms = "
                     f"{nbytes / ms / 1e6:.1f} GB/s")
        print(line, flush=True)
        del cache, host, data, got
    torch.cuda.empty_cache()


class LocalPrefillClient:
    """The decode handler's prefill client for engines in one process: its
    requests go straight to the prefill handler (the completion signal
    still rides the transport to the decode side's ``kv_inject``)."""

    def __init__(self, handler):
        self.handler = handler

    def instance_ids(self):
        return [1]

    def round_robin(self, request, context):
        from dynamo_tpu_torch.runtime.context import Context

        return self.handler.generate(request, Context())


def phase_kvmove_local(card: str, base, direct: dict) -> dict:
    """Phase 7 in this process: (a) the round trip; (b) a prefill engine
    and a decode engine on the card, joined by ``DevicePlane``, serve phase
    3's traffic through ``DecodeHandler``/``PrefillHandler``; (e) the
    preemption coordinator, triggered by ``POST /preempt`` on a system
    server, evacuates 16 mid-stream seats of one engine to the other (the
    co-resident peer), then 16 to the host tier, whose re-admission
    prefills onboard the spilled blocks. Streams are held against phase
    3's (``base``'s eager rerun, with the parity rule of ``check_parity``).
    Returns the launch counts of (b)."""
    import asyncio

    import torch

    from dynamo_tpu_torch.disagg import (
        DecodeHandler, DevicePlane, DisaggConfig, PrefillHandler,
    )
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.engine.engine import Request
    from dynamo_tpu_torch.kvbm.manager import KvbmConfig
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.runtime import preemption
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.system_server import SystemServer
    from dynamo_tpu_torch.runtime.transport import IngressServer

    kv_round_trip(card)
    cfg = ModelConfig.llama3_1b()
    prompts = main_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    want, rec = tapped_run(base, prompts)
    print(f"[kvmove] phase 3's traffic rerun on the phase 3 engine (depth "
          f"1, eager windows, logits recorded) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pre = InferenceEngine(cfg, EngineConfig(), seed=SEED)
    dec = InferenceEngine(cfg, EngineConfig(), seed=SEED)
    torch.cuda.synchronize()
    print(f"[kvmove] prefill and decode engines (seed {SEED}, bf16, "
          f"EngineConfig()) on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    plane = DevicePlane()
    ph = PrefillHandler(pre, plane=plane)
    dh = DecodeHandler(dec, LocalPrefillClient(ph),
                       DisaggConfig(min_remote_prefill_tokens=32),
                       plane=plane)
    moved = []
    transfer = plane.transfer

    async def counted(*a, **kw):
        n = await transfer(*a, **kw)
        moved.append(n)
        return n
    plane.transfer = counted
    out = {}

    async def one(handler, ids, n, stamps=None):
        t_sub = time.perf_counter()
        toks, times = [], []
        async for o in handler.generate(
                {"token_ids": ids, "max_tokens": n, "temperature": 0.0},
                Context()):
            toks.extend(o["token_ids"])
            times.append(time.perf_counter())
        if stamps is not None:
            stamps.append((t_sub, times))
        return toks

    async def disagg():
        server = IngressServer(dh.inject_handler(), host="127.0.0.1",
                               port=0)
        await server.start()
        dh.kv_inject_addr = f"127.0.0.1:{server.port}"
        try:
            await one(dh, prompts[0][:64], 4)       # warm-up
            for e in (pre, dec):
                e.clear_kv_blocks()
            moved.clear()
            n0 = dict(windows=dec.num_windows,
                      replays=dec._ap_window_fn.replays)
            remote0 = dh.num_remote_prefills
            pa.reset_launches()
            stamps = []
            t_start = time.perf_counter()
            outs = await asyncio.gather(*(one(dh, p, OSL, stamps)
                                          for p in prompts))
            wall = time.perf_counter() - t_start
            out["launches"] = dict(pa.LAUNCHES)
            out["stats"] = traffic_stats(
                [(t_sub, times[0], times[-1], len(times))
                 for t_sub, times in stamps], wall)
            out["remote"] = dh.num_remote_prefills - remote0
            out["windows"] = (dec.num_windows - n0["windows"],
                              dec._ap_window_fn.replays - n0["replays"])
            out["moved"] = list(moved)
            # the device plane and the engine's extract alone, one prompt
            # (16 MiB)
            seq, _ = await pre.prefill_held(Request("t-pre", prompts[1], 1))
            dseq = dec.reserve_sequence(Request("t-dec", prompts[1], 2))
            times = []
            for _ in range(12):
                t = time.perf_counter()
                await transfer(pre, seq.block_table, dec, dseq.block_table,
                               dst_seq_id=dseq.seq_id,
                               dst_epoch=dseq.kv_epoch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            out["plane_ms"] = sorted(times[2:])[5] * 1e3
            times = []
            for _ in range(12):
                t = time.perf_counter()
                data = await pre.extract_kv(seq)
                times.append(time.perf_counter() - t)
            out["extract_ms"] = sorted(times[2:])[5] * 1e3
            out["extract_bytes"] = sum(a.numel() * a.element_size()
                                       for a in data.values())
            pre.release_held(seq)
            dec.cancel_reservation(dseq)
            return outs
        finally:
            if hasattr(ph, "_transport"):
                await ph._transport.close()
            await server.stop()
            await pre.stop()
            await dec.stop()

    outs = asyncio.run(disagg())
    for i, o in enumerate(outs):
        if len(o) != OSL or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"[kvmove] disaggregated request {i}: {len(o)} tokens or "
                 f"an id out of range")
    if out["remote"] != N_REQUESTS or len(out["moved"]) != N_REQUESTS:
        fail(f"[kvmove] {out['remote']} remote prefills and "
             f"{len(out['moved'])} device-plane handoffs for {N_REQUESTS} "
             f"requests")
    windows, replays = out["windows"]
    if windows != replays or windows == 0:
        fail(f"[kvmove] the decode engine ran {windows} windows, "
             f"{replays} of them graph replays")
    for name in ("paged_attention_decode", "paged_attention_ragged"):
        if out["launches"].get(name, 0) == 0:
            fail(f"[kvmove] {name} never launched in the disaggregated run")
    partings = check_parity(want, rec, outs,
                            "phase 3's engine (eager rerun, aggregated)",
                            tag="[kvmove]")
    s = out["stats"]
    per = out["moved"][0]
    print(f"[kvmove] {card}: disaggregated in one process (device plane): "
          f"{N_REQUESTS} requests ISL {ISL} OSL {OSL}: {stats_line(s)}; "
          f"phase 3 aggregated: {stats_line(direct)}; {per / 2**20:.2f} MiB "
          f"per handoff ({KV_BLOCKS} blocks); {windows} decode windows, all "
          f"graph replays over injected KV; {len(partings)} of {N_REQUESTS} "
          f"streams part from phase 3's at near-ties; kernel launches "
          + ", ".join(f"{k}={v}" for k, v in out["launches"].items()
                      if v), flush=True)
    pb = out["extract_bytes"]
    print(f"[kvmove] {card}: one {ISL}-token prompt ({pb / 2**20:.2f} MiB "
          f"bf16): DevicePlane.transfer p50 {out['plane_ms']:.3f} ms = "
          f"{per / out['plane_ms'] / 1e6:.1f} GB/s (gather on the prefill "
          f"engine's step thread, in-place scatter on the decode engine's); "
          f"engine.extract_kv (to pinned host) p50 {out['extract_ms']:.3f} "
          f"ms = {pb / out['extract_ms'] / 1e6:.1f} GB/s", flush=True)

    # (e) preemption in this process: POST /preempt, peer then host tier
    def evacuate(src, peer, mode, tiered: bool):
        # the host-tier drill gives the coordinator no peer: it spills
        coord = preemption.PreemptionCoordinator(
            src, peer=peer if mode == preemption.PEER else None,
            notice_grace_s=0.0)

        async def run():
            tasks = []
            server = SystemServer(host="127.0.0.1", port=0)
            server.register_preempt("kvmove", lambda: tasks.append(
                asyncio.ensure_future(coord.notice("admin"))))
            await server.start()
            progress = [0] * N_REQUESTS

            async def stream(i):
                toks = {}
                reason = None
                async for o in src.submit(Request(
                        f"ev-{mode}-{i}", prompts[i], OSL)):
                    if o.token_id >= 0:
                        toks[o.index] = o.token_id
                    progress[i] = len(toks)
                    if o.finished:
                        reason = o.finish_reason
                return [toks[j] for j in sorted(toks)], reason
            try:
                jobs = [asyncio.ensure_future(stream(i))
                        for i in range(N_REQUESTS)]
                while min(progress) < EVAC_AFTER_TOKENS:
                    if any(j.done() for j in jobs):
                        fail(f"[kvmove] a stream ended before the notice "
                             f"({mode})")
                    await asyncio.sleep(0.001)
                t_notice = time.perf_counter()
                status, _, _, _, body = await _http_request(
                    server.port, "POST", "/preempt")
                if status != 202 or body != {"evacuating": ["kvmove"]}:
                    fail(f"[kvmove] POST /preempt: {status} {body}")
                report = await tasks[0]
                t_done = time.perf_counter()
                heads = await asyncio.gather(*jobs)
            finally:
                await server.stop()
            index = {f"ev-{mode}-{i}": i for i in range(N_REQUESTS)}
            spliced = [None] * N_REQUESTS
            next_tok = []

            async def resume(res):
                i = index[res.record.seq_id]
                head, reason = heads[i]
                if res.mode == preemption.FINISHED:
                    # the seat's last token landed before it was parked
                    if reason != "length":
                        fail(f"[kvmove] finished seat {i} ended {reason!r}")
                    spliced[i] = head
                    return
                if res.mode != mode or reason != "evacuated":
                    fail(f"[kvmove] stream {i}: {res.mode}, ended "
                         f"{reason!r} ({mode})")
                toks, times = [], []
                if res.mode == preemption.PEER:
                    it = peer.resume_prefilled(res.dst_seq,
                                               res.record.first_token())
                else:
                    it = peer.submit(res.record.resume_request())
                async for o in it:
                    toks.append(o.token_id)
                    times.append(time.perf_counter())
                if res.mode == preemption.PEER:
                    # index 0 re-emits the frontier token
                    spliced[i] = head + toks[1:]
                    next_tok.append(times[1] - t_notice)
                else:
                    spliced[i] = head + toks
                    next_tok.append(times[0] - t_notice)
            await asyncio.gather(*(resume(r) for r in report.results))
            await src.stop()
            await peer.stop()
            return report, spliced, sorted(next_tok), t_done - t_notice

        pa.reset_launches()
        report, spliced, next_tok, evac_s = asyncio.run(run())
        launches = {k: v for k, v in pa.LAUNCHES.items() if v}
        for name in ("paged_attention_decode", "paged_attention_ragged"):
            if not launches.get(name):
                fail(f"[kvmove] {name} never launched in the evacuation "
                     f"drill ({mode})")
        counts = {m: report.count(m) for m in (
            preemption.PEER, preemption.SPILL, preemption.FALLBACK,
            preemption.FINISHED)}
        # seats whose stream ends while earlier ones are moved finish in
        # place (FINISHED), as the coordinator intends
        if (counts[mode] == 0
                or counts[mode] + counts[preemption.FINISHED] != N_REQUESTS):
            fail(f"[kvmove] preemption ({mode}): report {counts}")
        for i, o in enumerate(spliced):
            if o is None or len(o) != OSL:
                fail(f"[kvmove] evacuated stream {i} resumed to "
                     f"{None if o is None else len(o)} of {OSL} tokens")
        parts = check_parity(want, rec, spliced,
                             f"phase 3's engine (evacuated: {mode})",
                             tag="[kvmove]")
        moved_b = [r.bytes_moved for r in report.results
                   if r.mode == mode]
        extra = ""
        if tiered:
            extra = (f"; the resuming engine onboarded "
                     f"{peer.kvbm.stats.onboarded_blocks} blocks from the "
                     f"host tier (prefix hit tokens "
                     f"{peer.scheduler.stats.prefix_cache_hits * 16})")
            if peer.kvbm.stats.onboarded_blocks == 0:
                fail("[kvmove] the resumed prefills onboarded nothing from "
                     "the host tier")
        print(f"[kvmove] {card}: POST /preempt with {N_REQUESTS} seats "
              f"{EVAC_AFTER_TOKENS}+ tokens in, evacuation to "
              + ("a co-resident peer engine" if mode == preemption.PEER
                 else "the host tier") +
              f": PreemptionReport {counts}, deadline_blown "
              f"{report.deadline_blown}; notice to report {evac_s * 1e3:.1f} "
              f"ms; {sum(moved_b) / len(moved_b) / 2**20:.2f} MiB moved per "
              f"seat; kill to next token p50 "
              f"{next_tok[len(next_tok) // 2] * 1e3:.1f} ms max "
              f"{next_tok[-1] * 1e3:.1f} ms; {len(parts)} of {N_REQUESTS} "
              f"spliced streams part from phase 3's at near-ties{extra}; "
              f"kernel launches (both engines) "
              + ", ".join(f"{k}={v}" for k, v in launches.items()),
              flush=True)

    evacuate(dec, pre, preemption.PEER, tiered=False)
    dec.attach_kvbm(KvbmConfig(host_blocks=4096))
    pre.attach_kvbm(KvbmConfig(host_blocks=4096))
    pre.kvbm.host_pool = dec.kvbm.host_pool
    dec.clear_kv_blocks()
    pre.clear_kv_blocks()
    evacuate(dec, pre, preemption.SPILL, tiered=True)
    del pre, dec
    torch.cuda.empty_cache()
    return out["launches"]


ONBOARD_CASE = "ragged R=1 q_len=16 after 496 onboarded keys, W=32"


def codec_ms_per_prompt(reps: int = 5):
    """Host ms of the relay's frame work for one 512-token bf16 prompt
    (16 MiB) at Llama-3.2-1B width: ``kv_to_wire`` (bytes + CRC32), the
    codec's pack, its unpack and ``kv_from_wire`` (size and CRC checks,
    tensors)."""
    import torch

    from dynamo_tpu_torch.disagg.protocol import kv_from_wire, kv_to_wire
    from dynamo_tpu_torch.runtime import codec

    gen = torch.Generator().manual_seed(SEED)
    shape = (16, KV_BLOCKS, 8, 16, 64)
    data = {k: torch.randn(shape, generator=gen).to(torch.bfloat16)
            for k in ("k", "v")}
    steps = {"kv_to_wire": 0.0, "pack": 0.0, "unpack": 0.0,
             "kv_from_wire": 0.0}
    for _ in range(reps):
        t0 = time.perf_counter()
        wire = kv_to_wire(data)
        t1 = time.perf_counter()
        raw = codec.packb(wire)
        t2 = time.perf_counter()
        back = codec.unpackb(raw)
        t3 = time.perf_counter()
        got = kv_from_wire(back)
        t4 = time.perf_counter()
        for k, (a, b) in zip(steps, ((t0, t1), (t1, t2), (t2, t3),
                                     (t3, t4))):
            steps[k] += (b - a) / reps * 1e3
    if not all(same_bytes(got[k], data[k]) for k in data):
        fail("[kvmove] the relay frame changed the payload")
    return steps, len(raw)


def phase_kvmove_procs(card: str, served: dict) -> dict:
    """Phase 7 across processes, on phase 6's store/frontend/worker entry
    points: (c) a ``--disagg-mode prefill --disagg-queue`` worker and a
    ``--disagg-mode decode`` worker serve phase 3's traffic through the
    frontend over the host relay, then a decode worker with
    ``--disagg-queue`` (the store's pull queue) does; (d) a worker with
    ``--kvbm-host-blocks`` and a G3 directory serves phase 6's shared-prefix
    groups, its G1 is cleared (``clear_kv_blocks``) and it serves them
    again: the second pass onboards from the host tier and its prefills run
    the ragged face over the onboarded prefix; (e) ``POST /preempt`` on that
    worker mid-stream spills every seat to its host tier and drains it.
    Returns the workers' kernel launches per part."""
    import asyncio
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    steps, nraw = codec_ms_per_prompt()
    print(f"[kvmove] {card}: relay frame of one {ISL}-token bf16 prompt "
          f"({nraw / 2**20:.2f} MiB packed) on this host: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in steps.items()), flush=True)
    c = make_case(ONBOARD_CASE, [(16, 512, 16)], W=32, face="ragged")
    err = check_case(c)
    print(f"[kvmove] {ONBOARD_CASE} (the shape of a prefill over an "
          f"onboarded {ISL}-token prompt): kernel vs plain max |diff| "
          f"{err:.3e}", flush=True)
    del c

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DYNTPU_LEASE_TTL_S=str(DIST_LEASE_TTL_S),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{_free_port()}"
    common = ["--model", "1b", "--model-name", HTTP_MODEL,
              "--tokenizer", os.path.abspath(served["tokenizer"]),
              "--store-addr", addr]
    g3 = os.path.abspath(os.path.join(DIST_LOGS, "kvmove_g3"))
    if os.path.isdir(g3):
        for f in os.listdir(g3):
            os.remove(os.path.join(g3, f))
    children = []
    spans = {}

    def start(name, module, args, **extra_env):
        child = Child(name, module, args, dict(env, **extra_env))
        children.append(child)
        return child

    def traced(name):
        path = os.path.abspath(os.path.join(DIST_LOGS, f"{name}_spans.jsonl"))
        if os.path.exists(path):
            os.remove(path)
        spans[name] = path
        return dict(DYNTPU_TRACE_SAMPLE_RATIO="1",
                    DYNTPU_TRACE_EXPORT_PATH=path)

    def job(prompt, max_tokens):
        return dict(method="POST", path="/v1/completions", body={
            "model": HTTP_MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": True})

    def streams(results, what):
        runs = []
        for status, t_sent, frames, done, _ in results:
            content = [t for t, f in frames if f["choices"][0]["text"]]
            n = frames[-1][1]["usage"]["completion_tokens"] if frames else 0
            if status != 200 or not done or n != OSL or len(content) < 2:
                fail(f"[kvmove] {what}: HTTP {status}, [DONE] {done}, {n} "
                     f"of {OSL} tokens")
            runs.append((t_sent, content[0], content[-1], n))
        return runs

    def launches_of(child):
        m = re.search(r"worker exiting: kernel launches (.*)", child.text())
        if m is None:
            fail(f"[kvmove] {child.name} left no launch counts:\n"
                 f"{child.tail()}")
        return {k: int(v) for k, v in
                (kv.split("=") for kv in m.group(1).split())}

    def durations(name, span):
        return sorted(s["duration_s"] for s in read_jsonl(spans[name])
                      if s["name"] == span)

    out = {}

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        rt = None
        try:
            t0 = time.perf_counter()
            store = start("kv_store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]])
            await store.wait_for(r"store listening", 60)
            front = start("kv_frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr])
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))

            async def client(*jobs):
                return await loop.run_in_executor(procs, http_client, port,
                                                  list(jobs))

            async def stop(child):
                child.proc.send_signal(signal.SIGTERM)
                rc = await loop.run_in_executor(None, child.proc.wait, 120)
                if rc != 0:
                    fail(f"[kvmove] {child.name} exited {rc} on SIGTERM:\n"
                         f"{child.tail()}")

            async def serve(decode, what):
                """Wait for ``decode`` to register, warm up, then phase 3's
                traffic through the frontend."""
                await decode.wait_for(r"registered model", 300)
                t_w = time.perf_counter()
                while True:
                    (status, *_), = await client(job(
                        served["prompts"][0], 4))
                    if status == 200:
                        break
                    if time.perf_counter() - t_w > 120:
                        fail(f"[kvmove] {what}: the frontend never served")
                    await asyncio.sleep(0.2)
                t_start = time.perf_counter()
                results = await client(*(job(p, OSL)
                                         for p in served["prompts"]))
                wall = time.perf_counter() - t_start
                return traffic_stats(streams(results, what), wall)

            # (c) disaggregated across processes, the host relay
            pre = start("kv_prefill", "dynamo_tpu_torch.worker",
                        [*common, "--disagg-mode", "prefill",
                         "--disagg-queue"], **traced("kv_prefill"))
            dec = start("kv_decode", "dynamo_tpu_torch.worker",
                        [*common, "--disagg-mode", "decode"],
                        **traced("kv_decode"))
            await pre.wait_for(r"worker ready", 300)
            agg = DIST_STATS.get("aggregated")
            for mode, flags in (("push", []), ("queue", ["--disagg-queue"])):
                if mode == "queue":
                    dec = start("kv_decode_q", "dynamo_tpu_torch.worker",
                                [*common, "--disagg-mode", "decode",
                                 *flags], **traced("kv_decode_q"))
                stats = await serve(dec, f"disaggregated ({mode})")
                await stop(dec)
                n_remote = len(durations(dec.name, "disagg.handoff"))
                inject = durations(dec.name, "disagg.inject")
                if n_remote < N_REQUESTS or len(inject) < N_REQUESTS:
                    fail(f"[kvmove] {mode}: {n_remote} handoffs and "
                         f"{len(inject)} relay injects for {N_REQUESTS} "
                         f"requests:\n{dec.tail()}")
                handoff = durations(dec.name, "disagg.handoff")
                out[f"decode_{mode}"] = launches_of(dec)
                print(f"[kvmove] {card}: disaggregated across processes "
                      f"({mode} mode, host relay): {N_REQUESTS} streams ISL "
                      f"{ISL} OSL {OSL}: {stats_line(stats)}; phase 6's "
                      f"aggregated worker: "
                      + (stats_line(agg) if agg else "not run")
                      + f"; handoff (reserve to inject done) p50 "
                      f"{handoff[len(handoff) // 2] * 1e3:.1f} ms; relay "
                      f"inject on the decode side (frame checks + scatter) "
                      f"p50 {inject[len(inject) // 2] * 1e3:.1f} ms",
                      flush=True)
            await stop(pre)
            push = durations("kv_prefill", "disagg.transfer")
            if len(push) < 2 * N_REQUESTS:
                fail(f"[kvmove] the prefill worker pushed {len(push)} "
                     f"frames for {2 * N_REQUESTS} requests")
            print(f"[kvmove] {card}: relay push per handoff on the prefill "
                  f"worker (extract done; frame, send, decode-side inject "
                  f"and ack) p50 {push[len(push) // 2] * 1e3:.1f} ms max "
                  f"{push[-1] * 1e3:.1f} ms over {len(push)} pushes",
                  flush=True)
            out["prefill"] = launches_of(pre)
            # prefills run on the prefill worker, decode windows on the
            # decode workers
            for who, name in (("prefill", "paged_attention_ragged"),
                              ("decode_push", "paged_attention_decode"),
                              ("decode_queue", "paged_attention_decode")):
                if out[who].get(name, 0) == 0:
                    fail(f"[kvmove] {name} never launched in the {who} "
                         f"worker")
            print(f"[kvmove] kernel launches: prefill worker {out['prefill']}"
                  f"; decode worker (push) {out['decode_push']}; decode "
                  f"worker (queue) {out['decode_queue']}", flush=True)

            # (d) KVBM + prefix cache on one worker
            k_sys = _free_port()
            # a short notice grace: the drill's seats must still be
            # decoding when the evacuation starts
            kw = start("kv_kvbm", "dynamo_tpu_torch.worker",
                       [*common, "--kvbm-host-blocks", "4096",
                        "--kvbm-disk-dir", g3, "--kvbm-disk-blocks", "4096"],
                       DYNTPU_SYSTEM_ENABLED="1",
                       DYNTPU_SYSTEM_PORT=str(k_sys),
                       DYNTPU_PREEMPT_NOTICE_GRACE_S="0.2")
            await kw.wait_for(r"registered model", 300)
            rt = await DistributedRuntime.from_settings(RuntimeConfig(
                store_addr=addr, lease_ttl_s=DIST_LEASE_TTL_S))
            backend = rt.namespace().component("backend")
            gen = await backend.endpoint("generate").client()
            clear = await backend.endpoint("clear_kv_blocks").client()
            await gen.wait_for_instances(1, 60)
            await clear.wait_for_instances(1, 60)
            snaps = []
            sub = await rt.store.subscribe(
                backend.event_subject("load_metrics"))

            async def collect():
                async for ev in sub:
                    if ev.get("event") == "msg":
                        snap = codec.unpackb(ev["value"])
                        if "kernel_launches" in snap and "kvbm" in snap:
                            snaps.append((time.perf_counter(), snap))
            collector = asyncio.create_task(collect())

            async def fresh_snapshot():
                t = time.perf_counter()
                while not snaps or snaps[-1][0] <= t:
                    if time.perf_counter() - t > 30:
                        fail("[kvmove] the KVBM worker published no load "
                             "metrics")
                    await asyncio.sleep(0.05)
                return snaps[-1][1]

            async def drained():
                # the idle drain offloads every sealed block
                last = None
                for _ in range(200):
                    snap = await fresh_snapshot()
                    n = snap["kvbm"]["offloaded_total"]
                    if n == last and n > 0:
                        return snap
                    last = n
                fail("[kvmove] the offload backlog never drained")
            groups = kv_group_prompts()
            ps = [p for g in groups for p in g[2:6]]
            await serve(kw, "KVBM worker")        # warm-up + phase 3 traffic
            passes = []
            for i in range(2):
                if i:
                    async for _ in clear.direct(clear.instance_ids()[0], {},
                                                Context()):
                        pass
                before = await drained()
                t_start = time.perf_counter()
                results = await client(*(job(p, OSL) for p in ps))
                wall = time.perf_counter() - t_start
                stats = traffic_stats(streams(results, "shared prefix"),
                                      wall)
                after = await drained()
                passes.append((stats, before, after))
            (s1, b1, a1), (s2, b2, a2) = passes

            def delta(b, a, *path):
                x, y = b, a
                for k in path:
                    x, y = x.get(k, 0), y.get(k, 0)
                return y - x
            onboarded = delta(b2, a2, "kvbm", "onboarded_total")
            hits = delta(b2, a2, "kvbm", "prefix_hit_tokens_total")
            ragged = delta(b2, a2, "kernel_launches", "paged_attention_ragged")
            decode = delta(b2, a2, "kernel_launches", "paged_attention_decode")
            out["kvbm_second_pass"] = {"paged_attention_ragged": ragged,
                                       "paged_attention_decode": decode}
            if onboarded <= 0 or hits <= 0 or ragged <= 0 or decode <= 0:
                fail(f"[kvmove] second pass: onboarded {onboarded}, prefix "
                     f"hit tokens {hits}, ragged {ragged}, decode {decode}")
            print(f"[kvmove] {card}: KVBM worker (G2 4096 blocks, G3 on "
                  f"disk, prefix cache on): {len(ps)} shared-prefix streams "
                  f"(4 groups of a {KV_PREFIX_TOKENS}-token prefix); pass 1 "
                  f"{stats_line(s1)}; G1 cleared; pass 2 {stats_line(s2)}; "
                  f"pass 2 onboarded {onboarded} blocks from the host tier, "
                  f"prefix hit tokens {hits}, ragged launches {ragged} "
                  f"(over the onboarded prefix), decode {decode}; host "
                  f"pool {a2['kvbm']['host_pool_blocks']} blocks, "
                  f"offloaded {a2['kvbm']['offloaded_total']}", flush=True)

            # (e) POST /preempt mid-stream: seats spill to the host tier
            progress = [0] * 8
            reasons = [None] * 8
            prompts = main_prompts(128256)[:8]

            async def stream(i):
                req = {"token_ids": prompts[i], "max_tokens": 512,
                       "temperature": 0.0, "ignore_eos": True}
                async for o in gen.round_robin(req, Context()):
                    progress[i] += len(o.get("token_ids", ()))
                    if o.get("finished"):
                        reasons[i] = o.get("finish_reason")
            jobs = [asyncio.create_task(stream(i)) for i in range(8)]
            t_w = time.perf_counter()
            while min(progress) < EVAC_AFTER_TOKENS:
                if time.perf_counter() - t_w > 120:
                    fail(f"[kvmove] streams never reached "
                         f"{EVAC_AFTER_TOKENS} tokens: {progress}")
                await asyncio.sleep(0.01)
            (status, _, _, _, body), = await loop.run_in_executor(
                procs, http_client, k_sys,
                [dict(method="POST", path="/preempt")])
            t_post = time.perf_counter()
            await asyncio.wait_for(asyncio.gather(*jobs), 120)
            rc = await loop.run_in_executor(None, kw.proc.wait, 120)
            text = kw.text()
            m = re.search(r"evacuation done: (\d+) peer, (\d+) spill, "
                          r"(\d+) fallback, (\d+) finished", text)
            if (status != 202 or not body.get("evacuating") or rc != 0
                    or m is None or int(m.group(2)) != 8
                    or any(r != "evacuated" for r in reasons)):
                fail(f"[kvmove] POST /preempt on the KVBM worker: {status} "
                     f"{body}, exit {rc}, report {m and m.groups()}, "
                     f"reasons {reasons}\n{kw.tail()}")
            out["kvbm"] = launches_of(kw)
            print(f"[kvmove] {card}: POST /preempt on the KVBM worker with 8 "
                  f"streams {EVAC_AFTER_TOKENS}+ tokens in: 202 {body}; "
                  f"PreemptionReport peer {m.group(1)}, spill {m.group(2)}, "
                  f"fallback {m.group(3)}, finished {m.group(4)}; every "
                  f"stream ended 'evacuated'; the worker drained and exited "
                  f"0 {time.perf_counter() - t_post:.1f} s after the POST",
                  flush=True)
            collector.cancel()
            await sub.cancel()
            for cl in (gen, clear):
                await cl.stop()
            await stop(front)
            print(f"[kvmove] processes part in {time.perf_counter() - t0:.1f}"
                  f" s", flush=True)
        finally:
            if rt is not None:
                await rt.shutdown()
            procs.shutdown(wait=False, cancel_futures=True)
            for ch in children:
                ch.kill()
    asyncio.run(run())
    return out


# --------------------------- phase 8: MoE ---------------------------------

MOE_LAYERS = 16   # of Mixtral-8x7B's 32: the bf16 weights of 16 layers
                  # (~47 GB) and 2 GiB of KV fit one 80 GB card


def moe_reference(x, wr, wg, wu, wd, k: int, C: int):
    """Plain f32 reference of one MoE layer: each token's top-``k``
    experts (softmax of f32 router logits, ties to the lower index, gates
    renormalised), routed token by token in token-major, slot-minor order;
    a pick beyond an expert's ``C`` slots is dropped (GShard). Returns
    (out [N, D] f32, dropped picks)."""
    import torch
    import torch.nn.functional as F

    xf = x.float()
    probs = torch.softmax(xf @ wr.float(), dim=-1).cpu()
    load = [0] * wr.shape[1]
    picks = {}                          # expert -> [(token, gate)]
    dropped = 0
    for n in range(x.shape[0]):
        row = probs[n].tolist()
        top = sorted(range(len(row)), key=lambda e: -row[e])[:k]
        total = sum(row[e] for e in top)
        for e in top:
            if load[e] < C:
                picks.setdefault(e, []).append((n, row[e] / total))
            else:
                dropped += 1
            load[e] += 1
    out = torch.zeros_like(xf)
    for e, got in picks.items():
        idx = torch.tensor([n for n, _ in got], device=x.device)
        g = torch.tensor([w for _, w in got], device=x.device)[:, None]
        xe = xf[idx]
        h = F.silu(xe @ wg[e].float()) * (xe @ wu[e].float())
        out.index_add_(0, idx, g * (h @ wd[e].float()))
    return out, dropped


def check_moe_ffn(engine, card: str, busy: dict) -> dict:
    """[moe] ``moe_ffn`` with layer 0's weights on seeded bf16 inputs at the
    decode window's N=16 and the prefill chunk's N=512, against
    :func:`moe_reference` (TOL bf16); its device time and its share of the
    step (times the layers) beside the step's device busy time from
    phase 4's profile of the MoE engine."""
    import torch

    from dynamo_tpu_torch.parallel.moe import moe_capacity, moe_ffn

    cfg = engine.model_config
    lay = engine.params["layers"]
    w = [lay[k][0] for k in ("w_router", "w_gate", "w_up", "w_down")]
    k, cf = cfg.num_experts_per_token, cfg.moe_capacity_factor
    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)
    atol, rtol = TOL["bfloat16"]
    out = {}
    for N, step in ((16, "decode_graph"), (512, "prefill")):
        x = torch.randn(N, cfg.hidden_size, generator=gen, device=DEV,
                        dtype=torch.float32).to(torch.bfloat16)
        C = moe_capacity(N, cfg.num_experts, k, cf)
        got = moe_ffn(x, *w, top_k=k, capacity_factor=cf)
        want, dropped = moe_reference(x, *w, k, C)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"[moe] moe_ffn N={N}: not finite or misshapen")
        err = (got.float() - want).abs()
        excess = (err - rtol * want.abs()).max().item()
        ms = device_ms(lambda: moe_ffn(x, *w, top_k=k, capacity_factor=cf))
        share = (None if busy[step] is None else
                 cfg.num_layers * ms / busy[step])
        print(f"[moe] {card}: moe_ffn N={N} (C={C}, {dropped} of {N * k} "
              f"picks past capacity) vs the plain f32 reference: max "
              f"|diff| {err.max().item():.3e} (atol {atol} + rtol {rtol}); "
              f"device {ms:.4f} ms per layer, x {cfg.num_layers} layers = "
              f"{cfg.num_layers * ms:.3f} ms of the {step} step's "
              f"{_or_not_measured(busy[step], '.3f', ' ms')} device busy "
              f"({_or_not_measured(share, '.0%')})", flush=True)
        if excess > atol:
            fail(f"[moe] moe_ffn N={N} disagrees with the reference: "
                 f"{err.max().item()}")
        out[N] = dict(ms=ms, share=share, max_abs_err=err.max().item())
    return out


def phase_moe(card: str):
    """[moe]: Mixtral-8x7B at full width (D 4096, F 14336, 8 experts top-2,
    32 / 8 heads at head dim 128, vocab 32,000, untied, theta 1e6), 16 of
    its 32 layers, bf16, random weights from seed 0, ``EngineConfig()``:
    phase 3's traffic at depth 2 (TTFT, ITL, tok/s, the flight recorder's
    ``mfu_decode``/``mfu_prefill``), the probe, each decode graph phase 3
    replays against its eager window bit for bit, phase 4's profile of a
    decode window and a prefill chunk, and one layer's ``moe_ffn`` against
    its plain reference with its share of each step. Returns the launch
    counts of the served run."""
    import torch

    from dynamo_tpu_torch.engine import ModelConfig

    cfg = dataclasses.replace(ModelConfig.mixtral_8x7b(),
                              num_layers=MOE_LAYERS)
    launches, engine, _, stats = phase_engine(
        card, cfg=cfg, depths=(DEPTHS[0],),
        label=f"Mixtral-8x7B ({MOE_LAYERS} of 32 layers)")
    phase_graph(engine, card)
    busy = phase_profile(engine, card)
    check_moe_ffn(engine, card, busy)
    print(f"[moe] {card}: device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------- phase 9: the loader --------------------------

LOAD_DIR = os.path.join("build", "ckpt_llama_3_2_1b")
LOAD_LINE = re.compile(r"loaded (\d+) tensors \(([\d.]+) GB\) .* in "
                       r"([\d.]+) s: ([\d.]+) GB/s, peak host RSS "
                       r"(not measured|[\d.]+ GiB \([\d.]+ GiB before\))")
READY_LINE = re.compile(r"engine ready ([\d.]+) s after the launcher "
                        r"started")
LAUNCH_LINE = re.compile(r"run exiting: kernel launches (.*)")


def same_tree(a, b) -> bool:
    """Two parameter trees hold the same leaves, bit for bit."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(same_tree(a[k], b[k]) for k in a))
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def phase_load(card: str, engine, dtype: str) -> None:
    """[load]: the checkpoint loader on phase 3's ``dtype`` engine. For
    bf16, the engine's parameters are written as an HF checkpoint
    (``config.json`` + two ``*.safetensors`` shards, HF names, ``[out,
    in]``, bf16) by the port's writer under ``build/``. Loaded in this
    process, the leaves must equal the engine's bit for bit (for int8:
    ``quantize_params`` of the bf16 checkpoint, ``q`` and ``s``, and the
    int8 engine's own leaves). Then ``python -m dynamo_tpu_torch.run
    in=batch:... out=engine --weights DIR`` (``--weight-dtype`` and
    ``--kv-dtype`` ``dtype``) serves phase 3's traffic in a process of its
    own: its streams must meet ``check_parity`` against the engine's
    tapped rerun, both faces must launch there, and its read rate, peak
    host RSS and time to ready are printed. Returns the rerun's streams,
    its recorded logits and the prompts (phase 17's reference)."""
    import shutil

    import torch

    from dynamo_tpu_torch.engine import quant, weights

    cfg = engine.model_config
    files = sorted(os.path.join(LOAD_DIR, f) for f in (
        os.listdir(LOAD_DIR) if os.path.isdir(LOAD_DIR) else [])
        if f.endswith(".safetensors"))
    if dtype == "bf16":
        shutil.rmtree(LOAD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        weights.save_hf_params(LOAD_DIR, engine.params, cfg, n_shards=2)
        files = sorted(os.path.join(LOAD_DIR, f)
                       for f in os.listdir(LOAD_DIR)
                       if f.endswith(".safetensors"))
        print(f"[load] {card}: wrote {len(files)} shards, "
              f"{sum(os.path.getsize(f) for f in files) / 1e9:.3f} GB, in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    if len(files) != 2:
        fail(f"[load] expected 2 checkpoint shards under {LOAD_DIR}")
    loaded = weights.load_hf_params(LOAD_DIR, cfg, dtype)
    st = dict(weights.last_load_stats)
    same = same_tree(loaded, engine.params)
    what = "the engine's"
    if dtype != "bf16":
        src = weights.load_hf_params(LOAD_DIR, cfg, "bf16")
        same = same and same_tree(loaded, quant.quantize_params(src, dtype))
        what = "quantize_params of the bf16 checkpoint and the engine's"
        del src
    del loaded
    torch.cuda.empty_cache()
    print(f"[load] {card}: in process, {st['n_tensors']} tensors "
          f"({st['bytes'] / 1e9:.3f} GB) onto the card at {dtype} in "
          f"{st['seconds']:.2f} s, {st['gb_s']:.2f} GB/s; leaves equal "
          f"{what} bit for bit: {same}", flush=True)
    if not same:
        fail(f"[load] {dtype} leaves differ from {what}")

    prompts = main_prompts(cfg.vocab_size)
    batch = os.path.join("build", f"load_batch_{dtype}.jsonl")
    with open(batch, "w") as f:
        for p in prompts:
            f.write(json.dumps({"token_ids": p, "max_tokens": OSL}) + "\n")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.run", f"in=batch:{batch}",
         "out=engine", "--weights", LOAD_DIR, "--weight-dtype", dtype,
         "--kv-dtype", dtype, "--max-tokens", str(OSL)],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    with open(os.path.join("build", f"load_run_{dtype}.log"), "w") as f:
        f.write(out.stderr)
    if out.returncode != 0:
        fail(f"[load] run.py --weights ({dtype}) exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    load = LOAD_LINE.search(out.stderr)
    ready = READY_LINE.search(out.stderr)
    counts = LAUNCH_LINE.search(out.stderr)
    if not (load and ready and counts):
        fail(f"[load] run.py --weights ({dtype}) logged no load, ready or "
             f"launch line")
    launches = dict(kv.split("=") for kv in counts.group(1).split())
    suffix = "" if dtype == "bf16" else f"_{dtype}"
    for face in ("decode", "ragged"):
        if int(launches.get(f"paged_attention_{face}{suffix}", 0)) == 0:
            fail(f"[load] the {face} face never launched in run.py")
    rows = sorted((json.loads(line) for line in out.stdout.splitlines()
                   if line.strip()), key=lambda r: r["index"])
    got = [r["token_ids"] for r in rows]
    if [len(g) for g in got] != [OSL] * len(prompts):
        fail(f"[load] run.py --weights ({dtype}) returned short streams")
    print(f"[load] {card}: run.py --weights {dtype}: loaded "
          f"{load.group(1)} tensors ({load.group(2)} GB) in "
          f"{load.group(3)} s at {load.group(4)} GB/s, peak host RSS "
          f"during the load {load.group(5)}; engine ready "
          f"{ready.group(1)} s after the launcher started; process wall "
          f"{wall:.1f} s; kernel launches "
          f"{counts.group(1)}", flush=True)
    want, rec = tapped_run(engine, prompts)
    partings = check_parity(want, rec, got, f"phase 3's {dtype} engine",
                            tag="[load]")
    print(f"[load] {card}: {dtype} streams served from the checkpoint "
          f"vs phase 3's {dtype} engine (eager rerun): "
          f"{len(prompts) - len(partings)} of {len(prompts)} identical, "
          f"{len(partings)} part at near-ties", flush=True)
    return want, rec, prompts


# ---------------------------------------------------------------------------
# phases 10 and 11: the SLA profiler, the trace replay, the planner's targets

PROFILE_ARGS = ["--model", "1b", "--isls", "128,512,1024",
                "--batches", "1,8,16", "--contexts", "128,512"]
PROFILE_PATH = os.path.join("build", "profile_llama_3_2_1b.json")
PROFILE_KEYS = ("prefill_isl", "prefill_ttft_s", "prefill_thpt_per_chip",
                "decode_kv_usage", "decode_context_length", "decode_itl_s",
                "decode_thpt_per_chip")
# the replay's traffic: the bursty scenario at ISL 512 / OSL 64, half of
# every prompt shared within a tenant's pool (multi-tenant system prompts)
REPLAY_TRACE = dict(isl=512, osl=64, vocab_size=32000, prefix_ratio=0.5)
REPLAY_TIME_SCALE = 1.0
# the planner reads the replay as one window against the limits PERF.md
# proposes for 512-token prompts
PLANNER_TTFT_SLA_S = 1.0
PLANNER_ITL_SLA_S = 0.05


def phase_sla_profile(card: str):
    """Phase 10: ``python -m dynamo_tpu_torch.planner.profiler --model 1b``
    (ISLs 128/512/1024, batches 1/8/16, contexts 128/512) in this process,
    on the card: the prefill sweep runs the ragged face, the decode sweep
    the decode face (graph replays). Writes the profile JSON under
    ``build/``; both interpolators must load it. Returns (profile, the
    sweep's launches)."""
    import asyncio

    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.planner import profiler
    from dynamo_tpu_torch.planner.interpolation import (
        DecodeInterpolator, PrefillInterpolator,
    )

    args = profiler.parse_args(PROFILE_ARGS + ["--out", PROFILE_PATH])
    t0 = time.perf_counter()
    engine = profiler.build_engine(args)
    torch.cuda.synchronize()
    print(f"[profile] Llama-3.2-1B engine (seed {SEED}, bf16, the "
          f"profiler's EngineConfig) built in {time.perf_counter() - t0:.1f}"
          " s", flush=True)

    async def sweep():
        pa.reset_launches()
        try:
            prof = await profiler.run_profile(args, engine)
            return prof, dict(pa.LAUNCHES)
        finally:
            await engine.stop()

    t0 = time.perf_counter()
    profile, launches = asyncio.run(sweep())
    wall = time.perf_counter() - t0
    os.makedirs("build", exist_ok=True)
    with open(PROFILE_PATH, "w") as f:
        json.dump(profile, f, indent=2)
    missing = [k for k in PROFILE_KEYS if k not in profile]
    if missing:
        fail(f"[profile] keys missing from the profile: {missing}")
    vals = [v for k in PROFILE_KEYS for v in profile[k]]
    if not all(isinstance(v, (int, float)) and v == v and v >= 0
               for v in vals):
        fail(f"[profile] a value is not a finite number >= 0: {profile}")
    if not (all(v > 0 for v in profile["prefill_ttft_s"]
                + profile["decode_itl_s"] + profile["decode_thpt_per_chip"])
            and len(profile["decode_itl_s"]) == 6):
        fail(f"[profile] empty or zero measurements: {profile}")
    pre = PrefillInterpolator.from_profile(profile)
    dec = DecodeInterpolator.from_profile(profile)
    for isl, ttft, thpt in zip(profile["prefill_isl"],
                               profile["prefill_ttft_s"],
                               profile["prefill_thpt_per_chip"]):
        print(f"[profile] {card}: prefill ISL {isl}: TTFT "
              f"{ttft * 1e3:.2f} ms, {thpt:.0f} prompt tok/s "
              f"(interpolated {pre.interpolate_ttft(isl) * 1e3:.2f} ms)",
              flush=True)
    batches = [int(b) for b in args.batches.split(",")
               for _ in args.contexts.split(",")]
    for b, kv, ctx, itl, thpt in zip(
            batches, profile["decode_kv_usage"],
            profile["decode_context_length"], profile["decode_itl_s"],
            profile["decode_thpt_per_chip"]):
        print(f"[profile] {card}: decode batch {b} context {ctx}: ITL p50 "
              f"{itl * 1e3:.2f} ms, {thpt:.1f} tok/s, KV usage {kv:.4f}",
              flush=True)
    best = dec.find_best_throughput_per_chip(PLANNER_ITL_SLA_S, 512 + 32)
    print(f"[profile] best decode point under ITL "
          f"{PLANNER_ITL_SLA_S * 1e3:.0f} ms at context 544: "
          f"{best[0]:.1f} tok/s at KV usage {best[1]:.3f} (ITL "
          f"{best[2] * 1e3:.2f} ms); sweep {wall:.1f} s; launches {launches}",
          flush=True)
    for name in ("paged_attention_decode", "paged_attention_ragged"):
        if launches[name] <= 0:
            fail(f"[profile] {name} never launched in the sweep")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return profile, launches


def replay_trace():
    from dynamo_tpu_torch.replay.__main__ import scenario_config
    from dynamo_tpu_torch.replay.trace import generate_trace

    return generate_trace(dataclasses.replace(
        scenario_config("bursty", SEED), **REPLAY_TRACE))


def replay_settings():
    """What ``python -m dynamo_tpu_torch.replay --model 1b`` runs."""
    from dynamo_tpu_torch.replay.__main__ import replay_settings

    return replay_settings("1b", time_scale=REPLAY_TIME_SCALE, n_workers=2,
                           engine_seed=SEED)


def phase_replay(card: str):
    """Phase 11: ``run_cluster_replay`` of the bursty trace (32 requests,
    ISL 512 / OSL 64, two tenants' shared-prefix pools, an abort storm, a
    maintenance preemption) against two port engines at Llama-3.2-1B width
    on the card behind the SimCluster front (KV router, Migration, the
    store). Every scoreboard cross-check must pass. Returns (scoreboard,
    run, the replay's launches)."""
    import asyncio
    import tempfile

    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.replay.driver import run_cluster_replay
    from dynamo_tpu_torch.replay.scoreboard import build_scoreboard

    trace = replay_trace()
    settings = replay_settings()
    pa.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="replay-") as work:
        run = asyncio.run(run_cluster_replay(trace, settings, workdir=work))
    launches = dict(pa.LAUNCHES)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    rep = build_scoreboard(trace, run)
    print(f"[replay] {card}: bursty seed {SEED}, {rep['requests']} requests "
          f"(ISL {REPLAY_TRACE['isl']}, OSL {REPLAY_TRACE['osl']}, time "
          f"scale {REPLAY_TIME_SCALE}) on 2 engines: {rep['completed']} "
          f"completed, {rep['aborted']} aborted, {rep['errors']} errors, "
          f"{rep['evacuation_resumes']} evacuation resumes; replay "
          f"{rep['elapsed_s']} s (phase {wall:.1f} s with engine builds); "
          f"digest {rep['outcome_digest']}", flush=True)
    for tier, row in sorted(rep["tiers"].items()):
        print(f"[replay] tier {tier}: {row['completed']} scored, TTFT p50 / "
              f"p99 {row['ttft_p50_ms']} / {row['ttft_p99_ms']} ms, ITL p50 "
              f"/ p99 {row['itl_p50_ms']} / {row['itl_p99_ms']} ms, goodput "
              f"{row['goodput_tok_s']} tok/s, SLO violations "
              f"{row['slo_violation_rate']} (SLO {row['slo']})", flush=True)
    out_tokens = rep["output_tokens"]
    per_card = (run.elapsed_s / (out_tokens / 1e6)) if out_tokens else None
    print(f"[replay] output {out_tokens} tokens, {rep['output_tok_s']} tok/s;"
          f" prefix hits {rep['prefix_hit_tokens']:.0f} of "
          f"{rep['prefix_hit_potential_tokens']:.0f} potential tokens (rate "
          f"{rep['prefix_hit_rate']}); preempt {rep['preempt']}", flush=True)
    print(f"[replay] chip-seconds per 1M output tokens: {per_card:.2f} on "
          f"the one card (elapsed x 1); the scoreboard's "
          f"{rep['chip_seconds_per_1m_output_tokens']} counts each engine "
          f"as a chip ({rep['chips']}, as the reference counts each "
          f"engine's mesh) though both share this card; roofline ideal "
          f"{rep['ideal_chip_seconds_per_1m_output_tokens']} (Llama-3.2-1B "
          f"FLOPs at {rep['device_kind']}'s bf16 peak)", flush=True)
    for name, chk in rep["checks"].items():
        detail = {k: chk[k] for k in (
            "samples", "median_overhead_s", "min_overhead_s",
            "max_overhead_s", "client_expected_tokens", "recorder_tokens",
            "bounds", "scheduler_hit_tokens", "index_hit_tokens",
            "completed_full", "resumed", "aborted", "silent_losses",
            "fired") if k in chk}
        print(f"[replay] check {name}: "
              f"{'ok' if chk.get('ok') else 'FAIL: ' + str(chk.get('reason'))}"
              f" {json.dumps(detail, sort_keys=True)}", flush=True)
    print(f"[replay] launches {launches}", flush=True)
    if not rep["ok"]:
        fail("[replay] a scoreboard cross-check failed")
    if rep["errors"] or rep["completed"] + rep["aborted"] != rep["requests"]:
        fail("[replay] requests ended in error or unaccounted")
    if rep["preempt"]["notices"] != 1:
        fail(f"[replay] the preemption event did not fire: {rep['preempt']}")
    if rep["device_kind"] != torch.cuda.get_device_name(0):
        fail(f"[replay] engines ran on {rep['device_kind']}, not the card")
    for name in ("paged_attention_decode", "paged_attention_ragged"):
        if launches[name] <= 0:
            fail(f"[replay] {name} never launched in the replay")
    gc.collect()
    torch.cuda.empty_cache()
    return rep, run, launches


def phase_planner(card: str, profile: dict, rep: dict, run) -> None:
    """The planner over the card's numbers: both interpolators from phase
    10's profile, one ``WindowMetrics`` from phase 11's measured window,
    targets emitted through a ``VirtualConnector`` on a store in this
    process and read back from it."""
    import asyncio

    from dynamo_tpu_torch.planner import (
        DecodeInterpolator, Planner, PlannerConfig, PrefillInterpolator,
        VirtualConnector, WindowMetrics,
    )
    from dynamo_tpu_torch.replay.datagen import percentile
    from dynamo_tpu_torch.runtime.store import StoreClient, StoreServer

    done = [o for o in run.outcomes if o.error is None and not o.aborted
            and o.finish_reason is not None]
    ttfts = [o.ttft_s for o in done if o.ttft_s is not None]
    itls = [x for o in done for x in o.itls]
    window = WindowMetrics(
        num_requests=float(len(run.outcomes)),
        isl_avg=sum(o.isl for o in run.outcomes) / len(run.outcomes),
        osl_avg=sum(o.osl for o in run.outcomes) / len(run.outcomes),
        ttft_p50_s=percentile(ttfts, 50), ttft_p99_s=percentile(ttfts, 99),
        itl_p50_s=percentile(itls, 50), itl_p99_s=percentile(itls, 99),
        ttft_avg_s=sum(ttfts) / len(ttfts), itl_avg_s=sum(itls) / len(itls),
    )

    async def plan():
        server = StoreServer(host="127.0.0.1", port=0)
        await server.start()
        client = await StoreClient.connect(f"127.0.0.1:{server.port}")
        try:
            conn = VirtualConnector(client, namespace="smoke")
            planner = Planner(
                PlannerConfig(ttft_sla_s=PLANNER_TTFT_SLA_S,
                              itl_sla_s=PLANNER_ITL_SLA_S,
                              adjustment_interval_s=run.elapsed_s),
                PrefillInterpolator.from_profile(profile),
                DecodeInterpolator.from_profile(profile), conn)
            planner.observe(window)
            targets = await planner.make_adjustments()
            stored = (await conn.read_target("prefill"),
                      await conn.read_target("backend"))
            return (targets, stored, planner.p_correction,
                    planner.d_correction, planner.pressure(),
                    await conn.read_degradation())
        finally:
            await client.close()
            await server.stop()

    targets, stored, pcorr, dcorr, pressure, order = asyncio.run(plan())
    if targets is None or tuple(targets) != stored or min(targets) < 1:
        fail(f"[planner] targets {targets} vs store {stored}")
    print(f"[planner] {card}: window {window.num_requests:.0f} requests in "
          f"{run.elapsed_s:.2f} s, ISL {window.isl_avg:.0f}, OSL "
          f"{window.osl_avg:.0f}, TTFT p99 {window.ttft_p99_s * 1e3:.1f} ms, "
          f"ITL p99 {window.itl_p99_s * 1e3:.2f} ms against SLAs "
          f"{PLANNER_TTFT_SLA_S * 1e3:.0f} / {PLANNER_ITL_SLA_S * 1e3:.0f} "
          f"ms; corrections prefill {pcorr:.3f} decode {dcorr:.3f}, "
          f"pressure {pressure:.3f}", flush=True)
    print(f"[planner] targets: prefill {targets[0]}, decode {targets[1]} "
          f"(store: {stored[0]}, {stored[1]}); degradation order "
          f"{json.dumps(order, sort_keys=True)}", flush=True)


# ------------------------- phase 12: autotune -----------------------------


def run_stats(outs, stamps, wall: float) -> dict:
    """TTFT/ITL/tok/s of a ``serve_batch`` run (``traffic_stats``' keys)."""
    return traffic_stats([(t_sub, times[0], times[-1], max(2, len(times)))
                          for t_sub, times in stamps], wall) | dict(
        tok_s=sum(len(o) for o in outs) / wall)


def print_autotune(tag: str, choice: dict, build_s: float) -> None:
    for cls, info in choice.get("classes", {}).items():
        print(f"{tag} probe {cls} (B={info['B']}, T={info['T']}): kernel "
              f"{info['kernel_ms']:.4f} ms, einsum {info['einsum_ms']:.4f} "
              f"ms -> {info['impl']} (einsum / kernel {info['ratio']})",
              flush=True)
    if not choice["autotune_cache_hit"]:
        for cls, res in choice.get("sweep", {}).items():
            for cand in res["candidates"]:
                gate = ", ".join(f"{w} {e:.2e}"
                                 for w, e in cand["max_err"].items())
                ms = ", ".join(f"{w} {t:.5f}" for w, t in cand["ms"].items())
                print(f"{tag} sweep {cls} (B={res['B']}, T={res['T']}) "
                      f"tile {cand['tile']}: gate max err {gate} (tol "
                      f"{res['tol']}); ms {ms}; total {cand['total_ms']:.5f}"
                      + ("" if cand["eligible"] else
                         f"; ineligible: {cand['reason']}"), flush=True)
            print(f"{tag} sweep {cls}: winner {res['winner']} of "
                  f"{len(res['candidates'])} candidates at widths "
                  f"{res['widths']} blocks", flush=True)
    print(f"{tag} engine built in {build_s:.2f} s (tuning "
          f"{choice['tune_s']:.3f} s): tiles {choice['tiles']}, "
          f"cache hit {choice['autotune_cache_hit']}, probe launches "
          f"{choice['probe_launches']}, sweep launches "
          f"{choice['sweep_launches']} (key {choice['config_hash']})",
          flush=True)


def tuned_launch(face: str, tile) -> dict:
    """A class tile as the wrapper's launch keywords."""
    if face == "decode":
        return {"n_split": tile[1]}
    return {"q_tile": tile[0], "kv_chunk": tile[1]}


def phase_autotune(card: str, base, direct: dict):
    """[autotune]: engines with ``attention_impl="auto"`` and spec on (all
    three classes probed and swept), at bf16 and int8 KV, with
    ``DYNTPU_AUTOTUNE_CACHE`` in a temporary directory under ``build/``;
    each is built twice, and the second build must hit the cache, sweep
    nothing and build faster. Then a non-spec engine on the bf16 winners
    serves phase 3's traffic at depth 2; its streams are held to the parity
    rule against phase 3's (``base``). The winners at the main path's
    shapes are held against the plain version and timed. Returns the
    ``kernels`` line's rows of the tuned launches."""
    import tempfile

    import torch
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.engine import autotune
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = ModelConfig.llama3_1b()
    os.makedirs("build", exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="autotune-", dir="build")
    os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir, "tune.json")
    choices = {}
    try:
        for kv in ("bf16", "int8"):
            tag = f"[autotune {kv} KV]"
            auto_cfg = EngineConfig(attention_impl="auto", spec_mode="ngram",
                                    spec_k=SPEC_K, kv_dtype=kv)
            builds = []
            for _ in range(2):
                t0 = time.perf_counter()
                engine = InferenceEngine(cfg, auto_cfg, seed=SEED)
                torch.cuda.synchronize()
                builds.append((time.perf_counter() - t0,
                               engine.attention_impl_choice,
                               engine.config))
                del engine
                torch.cuda.empty_cache()
            (first_s, first, resolved), (second_s, second, _) = builds
            if set(first.get("classes", {})) != {"decode", "spec",
                                                 "prefill"}:
                fail(f"{tag} the probe did not time all three classes")
            swept = {cls for cls in ("decode", "spec", "prefill")
                     if model_lib.resolve_attention_impl(resolved, cls)
                     == "kernel"}
            if set(first.get("sweep", {})) != swept or (
                    swept and not first["sweep_launches"]):
                fail(f"{tag} the sweep did not run every kernel class")
            for cls in sorted({"decode", "spec", "prefill"} - swept):
                # einsum won the probe (a finding): the engine serves the
                # class on einsum, and the kernel's candidates are still
                # swept and gated here
                B, T = autotune.class_shapes(cfg, resolved)[cls]
                first.setdefault("sweep", {})[cls] = autotune.sweep_class(
                    cfg, resolved, cls, B, T, torch.device(DEV))
                print(f"{tag} einsum won the {cls} probe; its kernel "
                      f"candidates are swept here", flush=True)
            print_autotune(tag, first, first_s)
            print_autotune(tag, second, second_s)
            if not (second["autotune_cache_hit"]
                    and second["sweep_launches"] == 0
                    and second["tiles"] == first["tiles"]):
                fail(f"{tag} the second build did not take the cached "
                     f"winners without a sweep: {second}")
            # the tuning step's own time: the whole build's also holds
            # random weights' init, whose host noise (~1 s) is as large as
            # the sweep
            if second["tune_s"] >= first["tune_s"]:
                fail(f"{tag} the cached build tuned in "
                     f"{second['tune_s']:.3f} s, the sweeping one in "
                     f"{first['tune_s']:.3f} s")
            choices[kv] = (first, resolved)
    finally:
        os.environ.pop(autotune.CACHE_ENV, None)

    # the bf16 winners, served (spec off, so the run-ahead loop serves)
    first, resolved = choices["bf16"]
    tiles = {cls: tuple(t) for cls, t in first["tiles"].items()}
    tuned_cfg = EngineConfig(
        attention_impl_decode=resolved.attention_impl_decode,
        attention_impl_prefill=resolved.attention_impl_prefill,
        attention_tile_decode=tiles["decode"],
        attention_tile_prefill=tiles["prefill"])
    engine = InferenceEngine(cfg, tuned_cfg, seed=SEED)
    prompts = main_prompts(cfg.vocab_size)
    outs, stamps, wall, _ = serve_batch(engine, prompts, OSL,
                                        after_warmup=pa.reset_launches)
    launches = {name: pa.LAUNCHES[name] for name in (
        "paged_attention_decode", "paged_attention_ragged")}
    tuned = run_stats(outs, stamps, wall)
    print(f"[autotune] {card}: phase 3's traffic on the bf16 winners "
          f"(decode {tiles['decode']}, prefill {tiles['prefill']}) at depth "
          f"{engine.pipeline_depth}: {stats_line(tuned)}; phase 3 (default "
          f"launches): {stats_line(direct)}; launches {launches}",
          flush=True)
    del engine
    torch.cuda.empty_cache()
    for face, n in launches.items():
        kernel_class = "decode" if face.endswith("decode") else "prefill"
        if n == 0 and model_lib.resolve_attention_impl(
                resolved, kernel_class) == "kernel":
            fail(f"[autotune] {face} never launched on the winners")
    want = direct["outs"]
    parted = [r for r, (a, b) in enumerate(zip(want, outs)) if a != b]
    if parted:
        # the margins of phase 3's run at each parting, from an eager rerun
        # with its logits recorded
        rerun, rec = tapped_run(base, prompts)
        if rerun != want:
            fail("[autotune] phase 3's eager rerun differs from its run")
        check_parity(want, rec, outs, "phase 3 (default launches)",
                     tag="[autotune]")
    print(f"[autotune] streams on the winners: {len(prompts) - len(parted)} "
          f"of {len(prompts)} equal to phase 3's", flush=True)

    # each class's winner at the main path's shape, against the plain
    # version, timed as phase 2 times it
    rows = []
    for kv, (choice, _) in choices.items():
        tiles = choice["tiles"]
        for c in main_cases(None if kv == "bf16" else kv):
            kernel_class = ("decode" if c["face"] == "decode" else
                            "spec" if c["name"].startswith(SPEC_CASE)
                            else "prefill")
            if tiles[kernel_class] == [0, 0]:
                continue
            tc = launched(c, tuned_launch(c["face"], tiles[kernel_class]))
            r = phase_kernels([tc])[tc["name"]]
            del tc
            if kv != "bf16" or kernel_class == "spec":
                continue  # swept and timed, not served: not in the line
            name = f"paged_attention_{c['face']}"
            rows.append({
                "name": f"{name}@tuned_{kernel_class}", "route": "cuda",
                "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
                "replaces": KERNELS[name][3],
                "launch": tuned_launch(c["face"], tiles[kernel_class]),
                "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
        torch.cuda.empty_cache()
    return rows


# --------------------------- phase 13: ladder -----------------------------

LADDER_WAVE = 8            # concurrent requests per wave
LADDER_BUCKETS = (32,)     # one rung, 24 rows over the wave
LADDER_ENV = {"DYNTPU_LADDER_MIN_DISPATCHES": "6",
              "DYNTPU_LADDER_HYSTERESIS": "1"}
LADDER_MAX_WAVES = 6


def wave_prompts(vocab: int, wave: int):
    import torch

    gen = torch.Generator().manual_seed(SEED + 100 + wave)
    return [torch.randint(1, vocab, (ISL,), generator=gen).tolist()
            for _ in range(LADDER_WAVE)]


def window_ms(engine, B: int, live: int, reps: int = 20) -> float:
    """Device ms of one greedy decode window of bucket B with ``live``
    seated rows (the rest padding), graph replays timed with CUDA events."""
    import torch

    window = engine._ap_window_fn
    seat(engine._ctl, live, 560, engine.config.max_model_len)
    rows = window.load_rows(list(range(live)) +
                            [engine.config.max_num_seqs] * (B - live))
    call = lambda: window(engine.params, engine.cache, engine._ctl,  # noqa
                          rows, False)
    return cuda_ms(call, iters=reps)


def phase_ladder(card: str):
    """[ladder]: the twin of ``tests/test_ladder.py``'s engine test at
    Llama-3.2-1B width. An engine with ``adaptive_buckets=True``,
    ``ladder_compile_budget=2``, decode buckets (32,) and 32 seats serves
    waves of 8 concurrent greedy requests (ISL 512, OSL 64): every window
    pads 8 rows to 32, so the decode ladder must split at 8 (one graph
    captured after warm-up, counted by the capture watch) and converge;
    then one more wave must capture nothing. A static-grid engine (same
    weights, ladder off) serves the waves too: its padding waste is the
    before, the ladder engine's the after, and its streams (from an eager
    rerun with the logits recorded) hold the ladder's to the parity rule.
    Prints the splits, retires and rungs, and the decode window's device
    ms at B=32 and B=8 with 8 live rows."""
    import torch
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.observability import compilewatch

    cfg = ModelConfig.llama3_1b()
    eng = dict(decode_buckets=LADDER_BUCKETS, max_num_seqs=32,
               ladder_compile_budget=2)
    saved = {k: os.environ.get(k) for k in LADDER_ENV}
    os.environ.update(LADDER_ENV)
    try:
        engine = InferenceEngine(cfg, EngineConfig(adaptive_buckets=True,
                                                   **eng), seed=SEED)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    static = InferenceEngine(cfg, EngineConfig(**eng), seed=SEED)
    dec = engine._ladders["decode"]
    # the JAX test's order: one short warm-up request, then steady state
    serve_batch(engine, [main_prompts(cfg.vocab_size)[0][:32]], 4,
                warm_up=False)
    compilewatch.get_watch().reset()
    engine.mark_obs_warmup_done()
    for wave in range(LADDER_MAX_WAVES):
        prompts = wave_prompts(cfg.vocab_size, wave)
        outs, stamps, wall, _ = serve_batch(engine, prompts, OSL,
                                            warm_up=False)
        snap = engine.obs_snapshot()
        print(f"[ladder] {card}: wave {wave}: "
              f"{stats_line(run_stats(outs, stamps, wall))}; rungs "
              f"{snap['ladder_decode_rungs']}, splits "
              f"{snap['ladder_decode_splits_total']}, retires "
              f"{snap['ladder_decode_retires_total']}, budget left "
              f"{snap['ladder_decode_budget_remaining']}, converged "
              f"{bool(snap['ladder_decode_converged'])}; padding_waste_ratio "
              f"{snap['padding_waste_ratio']:.4f}; graph captures after "
              f"warm-up {snap['recompiles_by_fn']}", flush=True)
        if dec.snapshot()["splits_total"] and dec.converged:
            break
    for ev in dec._events:
        print(f"[ladder] event {ev}", flush=True)
    steady = compilewatch.steady_by_label()
    if dec.buckets() != (8, 32) or dec.snapshot()["splits_total"] != 1:
        fail(f"[ladder] the decode ladder did not split 32 at 8: "
             f"{dec.snapshot()}")
    if not dec.converged or steady != {"decode_window:B=8:stochastic=0": 1}:
        fail(f"[ladder] not converged on one new capture: {steady}")

    prompts = wave_prompts(cfg.vocab_size, LADDER_MAX_WAVES)
    engine.obs.mark_warmup_done()   # the recorder's window: this wave only
    with compilewatch.assert_no_recompiles():
        got = serve_batch(engine, prompts, OSL, warm_up=False)[0]
    after = engine.obs_snapshot()["padding_waste_ratio"]
    print(f"[ladder] the wave after convergence captured nothing "
          f"(captures after warm-up: {compilewatch.steady_by_label()})",
          flush=True)
    outs = serve_batch(static, prompts, OSL)[0]
    before = static.obs_snapshot()["padding_waste_ratio"]
    want, rec = tapped_run(static, prompts)
    if want != outs:
        fail("[ladder] the static engine's eager rerun differs from its run")
    partings = check_parity(want, rec, got, "the static grid (32)",
                            tag="[ladder]")
    print(f"[ladder] streams after convergence: {len(prompts) - len(partings)}"
          f" of {len(prompts)} equal to the static grid's; padding_waste_ratio"
          f" of the wave: static grid {before:.4f}, ladder {after:.4f}",
          flush=True)
    ms32 = window_ms(engine, 32, LADDER_WAVE)
    ms8 = window_ms(engine, 8, LADDER_WAVE)
    print(f"[ladder] {card}: decode window device ms with {LADDER_WAVE} live "
          f"rows: B=32 (before the split) {ms32:.3f} ms, B=8 (after) "
          f"{ms8:.3f} ms", flush=True)
    del engine, static
    torch.cuda.empty_cache()


# --------------------------- phase 14: profile ----------------------------

# shorter than phase 3's traffic (~0.9 s): the profiler stops while the
# engine serves
PROFILE_MS = 500
# phase 14's own time limit: on a hang every thread's stack goes to
# stderr and the script exits non-zero (faulthandler)
PROFILE_WATCHDOG_S = 240
FACE_KERNELS = ("ragged_paged_attention_mma_kernel",
                "paged_attention_decode_split_kernel")


def phase_debug_profile(card: str, engine) -> None:
    """[profile]: a system server (``runtime/system_server.py``, what a
    worker runs with ``DYNTPU_SYSTEM_ENABLED``) beside phase 3's engine
    while it serves phase 3's traffic: ``GET /debug/profile?ms=500``, sent
    0.1 s before the traffic starts, must answer 200 with a Chrome trace
    that names both faces' kernels, and a second request during the
    capture 409."""
    import asyncio
    import urllib.error
    import urllib.request

    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.system_server import SystemServer

    prompts = main_prompts(engine.model_config.vocab_size)
    trace_dir = os.path.join("build", "profiles")

    def get(port, ms):
        url = (f"http://127.0.0.1:{port}/debug/profile?ms={ms}"
               f"&dir={trace_dir}")
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    async def one(p):
        out = []
        async for o in engine.generate({"token_ids": p, "max_tokens": OSL,
                                        "temperature": 0.0}, Context()):
            out.extend(o["token_ids"])
        return out

    async def run():
        server = SystemServer(host="127.0.0.1", port=0)
        await server.start()
        await engine.start()
        try:
            # the capture starts on an idle loop, then the traffic comes:
            # a loaded loop answers a request only between the prefills'
            # host work, which may leave none of them inside the capture
            first = asyncio.ensure_future(
                asyncio.to_thread(get, server.port, PROFILE_MS))
            await asyncio.sleep(0.1)
            traffic = asyncio.gather(*(one(p) for p in prompts))
            await asyncio.sleep(0.1)
            second = await asyncio.to_thread(get, server.port, 50)
            return await first, second, await traffic
        finally:
            await engine.stop()
            await server.stop()

    engine.clear_kv_blocks()
    t0 = time.perf_counter()
    with watchdog(PROFILE_WATCHDOG_S):
        (s1, body), (s2, busy), outs = asyncio.run(run())
    if s1 != 200 or s2 != 409:
        fail(f"[profile] /debug/profile answered {s1} then {s2} "
             f"(want 200, then 409 during the capture): {body} {busy}")
    with open(body["trace_file"]) as f:
        text = f.read()
    found = {k: text.count(k) for k in FACE_KERNELS}
    print(f"[profile] {card}: /debug/profile?ms={PROFILE_MS} during phase "
          f"3's traffic: 200 in {time.perf_counter() - t0:.2f} s (captured "
          f"{body['captured_ms']} ms, activities {body['activities']}), "
          f"{os.path.getsize(body['trace_file']) / 2**20:.1f} MiB trace "
          f"{body['trace_file']}; a second request during it: {s2} "
          f"({busy['error']}); kernel names in the trace: {found}",
          flush=True)
    if not all(found.values()):
        fail(f"[profile] the trace does not name both faces: {found}")
    if any(len(o) != OSL for o in outs):
        fail("[profile] a stream served during the capture came up short")


# --------------------------- phase 15: embeddings --------------------------

EMBED_N = 16                 # inputs of one embed call, lengths 17..2000
EMBED_MIN, EMBED_MAX = 17, 2000
# 1 - cos budgets. An input alone against the same input in its batch: the
# same bf16 model, only the GEMMs' row counts differ (and with them
# cuBLAS's summation order), so the pooled vectors part at bf16's last bits:
# 1e-3, the budget the CPU tests pin for bf16 against the JAX package. The
# bf16 engine against the plain f32 ``encode_forward`` on f32 copies of the
# same parameters read 3.4e-5 on an H100; mean-pooled states of a random
# decoder share a large common direction, so a fault moves the vector
# less than an unrelated one would: on the same card the planted faults
# read 9.1e-2 (pad rows pooled) and 6.6e-4 (last token dropped). 1.5e-4
# sits between, ~4x from each, and every run re-reads the faults against
# it.
EMBED_BATCH_COS = 1e-3
EMBED_F32_COS = 1.5e-4
EMBED_REPS = 3
EMBED_SIDE_CALLS = 8         # embed calls interleaved with phase 3's traffic
EMBED_TEXT = ("Embeddings are mean-pooled, normalised final hidden states of "
              "the decoder, computed on the worker's encode-only step.")


def embed_inputs(vocab: int):
    """EMBED_N random prompts of lengths spread evenly over EMBED_MIN..
    EMBED_MAX, in a seeded order (so each batch mixes buckets)."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    lengths = [EMBED_MIN + round(i * (EMBED_MAX - EMBED_MIN) / (EMBED_N - 1))
               for i in range(EMBED_N)]
    order = torch.randperm(EMBED_N, generator=gen).tolist()
    return [torch.randint(1, vocab, (lengths[i],), generator=gen).tolist()
            for i in order]


def one_minus_cos(a, b) -> list:
    """1 - cos of each row pair of two lists of vectors."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                            * np.linalg.norm(b, axis=-1))
    return (1.0 - cos).tolist()


def phase_embed(card: str, engine, direct: dict) -> dict:
    """[embed]: ``engine.embed`` (the encode-only step behind
    ``/v1/embeddings``) on phase 3's bf16 engine at Llama-3.2-1B width: 16
    inputs of 17..2,000 tokens from seed 0. Unit norms, two calls bitwise
    equal, each input alone against the same input in its batch and the
    batch against the plain f32 ``encode_forward`` on f32 copies of the
    parameters (1 - cos within EMBED_BATCH_COS and EMBED_F32_COS); time
    per call, prompt tokens/s and the device's busy share. Then embed calls
    interleaved with phase 3's traffic: their vectors equal the quiet
    call's bit for bit, the streams meet the parity rule against phase 3's,
    and the capture watch counts no capture after warm-up. Returns the
    interleaved run's kernel launches."""
    import asyncio

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.observability import compilewatch
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = engine.model_config
    inputs = embed_inputs(cfg.vocab_size)
    n_tok = sum(map(len, inputs))

    def embed(batch):
        return asyncio.run(engine.embed(batch))

    first = embed(inputs)          # first shapes, cuBLAS handles: not timed
    walls = []
    for _ in range(EMBED_REPS):
        t0 = time.perf_counter()
        again = embed(inputs)
        walls.append(time.perf_counter() - t0)
        if again != first:
            fail("[embed] two embed calls on the same inputs differ")
    vecs = np.asarray(first)
    if vecs.shape != (EMBED_N, cfg.hidden_size) or not np.isfinite(
            vecs).all():
        fail(f"[embed] vectors misshapen or not finite: {vecs.shape}")
    norms = np.linalg.norm(vecs, axis=-1)
    if np.abs(norms - 1.0).max() > 1e-4:
        fail(f"[embed] vectors are not unit norm: {norms}")
    alone = [embed([ids])[0] for ids in inputs]
    d_alone = one_minus_cos(alone, first)
    # the plain f32 reference, one input at a time
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = engine.params
    p32 = {"embed": p["embed"].float(), "final_norm": p["final_norm"].float(),
           "layers": {k: v.float() for k, v in p["layers"].items()}}
    encode32 = model_lib.make_encode_fn(cfg32)
    ref = []
    for ids in inputs:
        t = torch.tensor([ids], dtype=torch.int32, device=engine.device)
        pos = torch.arange(len(ids), dtype=torch.int32,
                           device=engine.device)[None]
        ref.append(encode32(p32, t, pos)[0].cpu().tolist())
    d_f32 = one_minus_cos(first, ref)

    # planted faults on the same f32 reference, each of which the limit
    # must see on some input: the pad rows of each input's power-of-two
    # bucket (embed's padding) pooled as if they were tokens, and the last
    # token dropped from the pool
    def faulted(ids, n_pad):
        t = torch.tensor([ids + [0] * n_pad], dtype=torch.int32,
                         device=engine.device)
        pos = torch.arange(len(ids) + n_pad, dtype=torch.int32,
                           device=engine.device)[None]
        return encode32(p32, t, pos)[0].cpu().tolist()
    planted = {
        "pad rows pooled": [
            faulted(ids, (1 << (len(ids) - 1).bit_length()) - len(ids))
            for ids in inputs],
        "last token dropped": [faulted(ids[:-1], 0) for ids in inputs]}
    planted = {k: max(one_minus_cos(v, ref)) for k, v in planted.items()}
    del p32
    torch.cuda.empty_cache()
    wall = sorted(walls)[len(walls) // 2]
    events = profile_calls(lambda: embed(inputs), 1, cpu=False)
    cuda = sorted((e for e in events or ()
                   if e.device_type == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    busy_ms = None if events is None else sum(map(_device_us, cuda)) / 1e3
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.1f} ms of the call "
            f"({busy_ms / (wall * 1e3):.3f} busy share, profiled call)")
    top = "; ".join(f"{e.key[:60]} {_device_us(e) / 1e3:.1f} ms"
                    for e in cuda[:5])
    lens = sorted(map(len, inputs))
    print(f"[embed] {card}: Llama-3.2-1B bf16, {EMBED_N} inputs of "
          f"{lens[0]}..{lens[-1]} tokens ({n_tok} in all): {wall * 1e3:.1f} "
          f"ms per call (median of {EMBED_REPS}: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
          f"{n_tok / wall:.0f} prompt tokens/s, device busy {busy}; "
          f"norms within {np.abs(norms - 1).max():.2e} of "
          f"1; two calls bitwise equal", flush=True)
    print(f"[embed] device time by kernel, top 5 of {len(cuda)}: {top}",
          flush=True)
    print(f"[embed] 1 - cos: each input alone vs in its batch max "
          f"{max(d_alone):.2e} (limit {EMBED_BATCH_COS}); the bf16 engine vs "
          f"plain f32 encode_forward max {max(d_f32):.2e} mean "
          f"{sum(d_f32) / len(d_f32):.2e} (limit {EMBED_F32_COS}); "
          f"planted faults vs the f32 reference, max over the inputs: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in planted.items())}",
          flush=True)
    if max(d_alone) > EMBED_BATCH_COS:
        fail(f"[embed] an input alone differs from its batch: {d_alone}")
    if max(d_f32) > EMBED_F32_COS:
        fail(f"[embed] the bf16 engine disagrees with f32 encode_forward: "
             f"{d_f32}")
    if min(planted.values()) <= EMBED_F32_COS:
        fail(f"[embed] a planted fault reads within the limit "
             f"{EMBED_F32_COS}: {planted}")

    # interleaved with phase 3's traffic
    prompts = main_prompts(cfg.vocab_size)
    side_out = []

    async def side():
        for i in range(EMBED_SIDE_CALLS):
            part = [inputs[(4 * i + j) % EMBED_N] for j in range(4)]
            side_out.append((part, await engine.embed(part)))
            await asyncio.sleep(0.05)

    compilewatch.get_watch().reset()
    pa.reset_launches()
    outs, stamps, wall, _ = serve_batch(engine, prompts, OSL,
                                        alongside=side)
    launches = dict(pa.LAUNCHES)
    steady = compilewatch.steady_by_label()
    quiet = {tuple(ids): v for ids, v in zip(inputs, alone)}
    batched = {tuple(ids): v for ids, v in zip(inputs, first)}
    n_same = 0
    for part, got in side_out:
        # a 4-input call groups like an input alone or like the full batch
        # only where its buckets coincide; hold it to the budget and count
        # the bitwise ones
        want = [quiet[tuple(ids)] for ids in part]
        if max(one_minus_cos(got, want)) > EMBED_BATCH_COS:
            fail("[embed] an embed call during the traffic disagrees")
        n_same += sum(g == batched[tuple(ids)] or g == quiet[tuple(ids)]
                      for ids, g in zip(part, got))
    print(f"[embed] {EMBED_SIDE_CALLS} embed calls of 4 inputs interleaved "
          f"with phase 3's traffic: {stats_line(run_stats(outs, stamps, wall))}"
          f"; phase 3: {stats_line(direct)}; {n_same} of "
          f"{4 * EMBED_SIDE_CALLS} vectors bitwise equal to a quiet call's; "
          f"graph captures after warm-up {steady}; launches {launches}",
          flush=True)
    if len(side_out) != EMBED_SIDE_CALLS:
        fail("[embed] not every interleaved embed call returned")
    if steady:
        fail(f"[embed] graphs captured after warm-up: {steady}")
    for face in ("paged_attention_decode", "paged_attention_ragged"):
        if launches[face] == 0:
            fail(f"[embed] {face} never launched in the interleaved run")
    want = direct["outs"]
    parted = [r for r, (a, b) in enumerate(zip(want, outs)) if a != b]
    if parted:
        rerun, rec = tapped_run(engine, prompts)
        if rerun != want:
            fail("[embed] phase 3's eager rerun differs from its run")
        check_parity(want, rec, outs, "phase 3", tag="[embed]")
    print(f"[embed] streams with embed calls interleaved: "
          f"{len(prompts) - len(parted)} of {len(prompts)} equal to phase "
          f"3's", flush=True)
    return launches


# ------------------------ phase 16: multimodal EPD ------------------------

MM_IMAGE, MM_PATCH = 224, 14  # 256 placeholder tokens per image
MM_TEXT = 400                 # text before the image: 25 blocks of 16, so
MM_TAIL = 20                  # the image spans rows 400..655, across the
                              # first chunk's end (512) under the default
                              # budget
MM_ENCODE_TOL = 1e-4          # the encoder on the card vs its f32 plain
                              # version on the CPU (TF32 off)
MM_TTFT_REPS = 3
MM_OSL = 32                   # tokens per chat request over HTTP


class IdsTokenizer:
    """Text of space-separated ids → the ids: lets ``splice`` run on
    prompts made of random ids."""

    bos_token_id = None
    eos_token_ids = ()

    def encode(self, text):
        return [int(t) for t in text.split()]


def mm_images():
    import numpy as np

    return [np.random.RandomState(SEED + 16 + i).rand(
        MM_IMAGE, MM_IMAGE, 3).astype(np.float32) for i in range(2)]


def serve_one(engine, body, max_tokens):
    """One greedy request through ``engine.generate`` (no cache clearing):
    (tokens, TTFT s)."""
    import asyncio

    from dynamo_tpu_torch.runtime.context import Context

    async def run():
        await engine.start()
        out, t0, first = [], time.perf_counter(), None
        async for o in engine.generate(
                dict(body, max_tokens=max_tokens, temperature=0.0),
                Context()):
            first = first or time.perf_counter()
            out.extend(o["token_ids"])
        await engine.stop()
        return out, first - t0
    return asyncio.run(run())


class EncodeLoop:
    """Encodes an image over and over on a thread of its own (as an encode
    handler does) while the main thread works; counts the images and keeps
    the first error."""

    def __init__(self, encoder, image):
        import threading

        self.n, self.error = 0, None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(encoder, image), name="mm-encode")

    def _run(self, encoder, image):
        try:
            while not self._stop.is_set():
                encoder.encode(image)
                self.n += 1
        except Exception as e:     # reported by stop()
            self.error = e

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            fail(f"[mm] encoding on its own thread failed: {self.error!r}")


def phase_mm(card: str, engine, direct: dict) -> dict:
    """[mm] in one process, at Llama-3.2-1B width (phase 3's bf16 engine)
    with the JAX package's vision encoder config (width 64, 2 layers, 4
    heads) at 224 px / 14 px patches projecting to 2,048: the encoder on
    the card against its plain f32 version on the CPU (MM_ENCODE_TOL);
    prompts of 400 text tokens, one image (256 placeholders) and 20 more,
    spliced by the ``MultimodalProcessor`` (content-addressed hash ids);
    image A's stream (its image across two prefill chunks) held to the
    parity rule against the same prompt prefilled in one chunk (budget
    1,024); A again hits every full block (the image's included) and meets
    the rule; image B hits the text prefix only and streams differently;
    the text-only prompt hits the text prefix only; TTFT with the image
    against text-only at the same length; images encoded on a thread of
    their own while an engine captures its graphs and while phase 3's
    traffic runs (no capture error, streams against phase 3's). Returns
    the phase's kernel launches and what the process phase needs."""
    import asyncio

    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.multimodal import encoder as mm_enc
    from dynamo_tpu_torch.multimodal.processor import (
        MM_MARKER, MultimodalProcessor, content_token,
    )
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = engine.model_config
    vcfg = mm_enc.VisionEncoderConfig(image_size=MM_IMAGE,
                                      patch_size=MM_PATCH,
                                      model_dim=cfg.hidden_size)
    encoder = mm_enc.VisionEncoder(vcfg, seed=SEED)
    images = mm_images()
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else
                      {kk: vv.cpu() for kk, vv in v.items()})
                  for k, v in encoder.params.items()}
    errs = []
    for img in images:
        got = encoder.encode(img)
        want = mm_enc.encode_image(vcfg, cpu_params,
                                   torch.from_numpy(img)).numpy()
        if got.shape != (vcfg.tokens_per_image, cfg.hidden_size):
            fail(f"[mm] encoder output {got.shape}")
        errs.append(float(np.abs(got - want).max()))
    if max(errs) > MM_ENCODE_TOL:
        fail(f"[mm] the encoder on the card disagrees with its f32 plain "
             f"version: {errs}")
    t0 = time.perf_counter()
    for i in range(10):
        encoder.encode(images[i % 2])
    enc_ms = (time.perf_counter() - t0) / 10 * 1e3
    t0 = time.perf_counter()
    for i in range(4):
        content_token(images[i % 2], 0)
    ct_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(f"[mm] {card}: vision encoder (width {vcfg.width}, "
          f"{vcfg.num_layers} layers, {vcfg.num_heads} heads) at "
          f"{MM_IMAGE} px / {MM_PATCH} px patches -> "
          f"{vcfg.tokens_per_image} x {vcfg.model_dim}: max |card - f32 "
          f"CPU plain| {max(errs):.2e} (limit {MM_ENCODE_TOL}); encode "
          f"{enc_ms:.2f} ms per image (host clock, copies in and out "
          f"included); content_token (pure-Python XXH3 over "
          f"{images[0].nbytes} bytes) {ct_ms:.1f} ms per image on the host",
          flush=True)

    gen = torch.Generator().manual_seed(SEED + 9)
    text = torch.randint(1, cfg.vocab_size, (MM_TEXT,), generator=gen)
    tail = torch.randint(1, cfg.vocab_size, (MM_TAIL,), generator=gen)
    proc = MultimodalProcessor(IdsTokenizer(), vcfg.tokens_per_image,
                               local_encoder=encoder)
    rendered = (" ".join(map(str, text.tolist())) + MM_MARKER
                + " ".join(map(str, tail.tolist())))
    bodies = []
    for img in images:
        ids, mm = asyncio.run(proc.process(rendered, [img]))
        bodies.append({"token_ids": ids, "mm": mm, "ignore_eos": True})
    a, b = bodies
    plain = {"token_ids": a["token_ids"], "ignore_eos": True}
    n_prompt = len(a["token_ids"])
    img_end = MM_TEXT + vcfg.tokens_per_image
    if a["mm"]["positions"] != list(range(MM_TEXT, img_end)):
        fail("[mm] placeholder positions misplaced")

    # the reference: the same prompt prefilled in one chunk, on an engine
    # sharing the weights, built while images encode on another thread
    with EncodeLoop(encoder, images[0]) as loop_build:
        one_chunk = InferenceEngine(cfg, EngineConfig(
            max_num_batched_tokens=1024, decode_buckets=(8,),
            max_num_seqs=8,
            prefill_buckets=EngineConfig().prefill_buckets + (1024,)),
            params=engine.params, seed=SEED)
        torch.cuda.synchronize()
    want, rec = tapped_run(one_chunk, [a])
    if one_chunk.num_mm_prefills != 1:
        fail(f"[mm] the one-chunk engine ran {one_chunk.num_mm_prefills} "
             f"mm prefill chunks for one image prompt")
    del one_chunk
    torch.cuda.empty_cache()

    engine.clear_kv_blocks()
    pa.reset_launches()
    bs = engine.config.block_size

    def served(body):
        hits0, mm0 = engine.stats.prefix_cache_hits, engine.num_mm_prefills
        out, ttft = serve_one(engine, body, OSL)
        return (out, ttft, (engine.stats.prefix_cache_hits - hits0) * bs,
                engine.num_mm_prefills - mm0)

    out_a, _, hit_a, mm_a = served(a)
    out_a2, _, hit_a2, mm_a2 = served(a)
    out_b, _, hit_b, mm_b = served(b)
    out_t, _, hit_t, mm_t = served(plain)
    launches = dict(pa.LAUNCHES)
    print(f"[mm] prompts of {n_prompt} tokens (image rows {MM_TEXT}.."
          f"{img_end - 1}, chunk budget {engine.config.max_num_batched_tokens}"
          f"): A cold {mm_a} mm prefill chunks, {hit_a} prefix-hit tokens; A "
          f"again {hit_a2} hit tokens, {mm_a2} mm chunks, bitwise A: "
          f"{out_a2 == out_a}; B {hit_b} hit tokens, {mm_b} mm chunks, "
          f"equal to A: {out_b == out_a}; text-only {hit_t} hit tokens, "
          f"equal to A: {out_t == out_a}; num_mm_prefills "
          f"{engine.num_mm_prefills}; launches {launches}", flush=True)
    n_parted = sum(len(check_parity(want, rec, [out], what, tag="[mm]"))
                   for out, what in (
                       (out_a, "the one-chunk prefill (A across two chunks)"),
                       (out_a2, "the one-chunk prefill (A again)")))
    print(f"[mm] A across two chunks and A again: {2 - n_parted} of 2 "
          f"streams equal to the one-chunk prefill's", flush=True)
    if mm_a != 2:
        fail(f"[mm] the image across the chunk boundary took {mm_a} mm "
             f"prefill chunks, not 2")
    if hit_a != 0 or hit_a2 < img_end // bs * bs:
        fail(f"[mm] A again hit {hit_a2} tokens, short of the image's end "
             f"{img_end}")
    if hit_b != MM_TEXT // bs * bs or hit_t != MM_TEXT // bs * bs:
        fail(f"[mm] B or text-only hit past the text prefix: {hit_b}, "
             f"{hit_t}")
    if out_b == out_a:
        fail("[mm] images A and B gave the same stream")
    for face in ("paged_attention_decode", "paged_attention_ragged"):
        if launches[face] == 0:
            fail(f"[mm] {face} never launched in the mm run")

    ttfts = {"image": [], "text": []}
    for _ in range(MM_TTFT_REPS):
        for kind, body in (("image", a), ("text", plain)):
            engine.clear_kv_blocks()
            ttfts[kind].append(serve_one(engine, body, 1)[1])
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in ttfts.items()}
    print(f"[mm] {card}: TTFT at {n_prompt} prompt tokens, cold cache, "
          f"one request (median of {MM_TTFT_REPS}): with the image "
          f"{med['image']:.1f} ms, text-only {med['text']:.1f} ms "
          f"(image: {', '.join(f'{t * 1e3:.1f}' for t in ttfts['image'])}; "
          f"text: {', '.join(f'{t * 1e3:.1f}' for t in ttfts['text'])})",
          flush=True)

    # images encoded while phase 3's traffic runs
    prompts = main_prompts(cfg.vocab_size)
    with EncodeLoop(encoder, images[1]) as loop_serve:
        outs, stamps, wall, _ = serve_batch(engine, prompts, OSL)
    parted = [r for r, (x, y) in enumerate(zip(direct["outs"], outs))
              if x != y]
    if parted:
        rerun, rec3 = tapped_run(engine, prompts)
        if rerun != direct["outs"]:
            fail("[mm] phase 3's eager rerun differs from its run")
        check_parity(direct["outs"], rec3, outs, "phase 3", tag="[mm]")
    print(f"[mm] images encoded on their own thread: {loop_build.n} while an "
          f"engine captured its decode graphs, {loop_serve.n} while phase "
          f"3's traffic ran ({stats_line(run_stats(outs, stamps, wall))}; "
          f"{len(prompts) - len(parted)} of {len(prompts)} streams equal to "
          f"phase 3's)", flush=True)
    if loop_build.n == 0 or loop_serve.n == 0:
        fail("[mm] no image encoded alongside the engine")
    return {"launches": launches, "images": images, "encoder": encoder}


def npy_data_url(img) -> str:
    import base64
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, img)
    return ("data:application/x-npy;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def phase_epd_procs(card: str, served: dict, engine, mm: dict) -> None:
    """[embed] and [mm] over processes: the store, the encode worker
    (``python -m dynamo_tpu_torch.multimodal --model-dim 2048 --image-size
    224 --patch-size 14``), a worker (``--model 1b --mm-encode-component
    encoder``, phase 5's tokenizer) and the frontend. ``POST
    /v1/embeddings`` with a string and with a list of token arrays: 200,
    ``usage.prompt_tokens`` right, vectors equal to phase 3's engine's
    in this process (EMBED_BATCH_COS); after a warm-up chat with a third
    image, chat requests carrying ``.npy`` data URLs (image A, A again, B)
    and a text-only chat stream to ``[DONE]`` with the texts that phase
    3's engine gives for the same bodies in this process (the same
    multimodal preprocessor on phase 16's encoder, the same order of
    prefix hits), the frontend holds no GPU, and each process exits 0 on
    SIGTERM: the encoder having encoded 4 images, the worker having
    launched both faces and run as many mm prefill chunks and prefix-hit
    blocks as phase 3's engine on the same bodies (in which every image
    chat runs an mm chunk, A again hits every block up to the image's end
    and B none past its start)."""
    import asyncio
    import signal

    import numpy as np

    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import Preprocessor
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer
    from dynamo_tpu_torch.multimodal.processor import (
        MultimodalPreprocessor, MultimodalProcessor,
    )
    from dynamo_tpu_torch.runtime.context import Context

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{_free_port()}"
    children = []

    def start(name, module, args):
        child = Child(name, module, args, env)
        children.append(child)
        return child

    tok = Tokenizer.from_file(served["tokenizer"])
    ids = tok.encode(EMBED_TEXT)
    arrays = [x[:300] for x in embed_inputs(engine.model_config.vocab_size)
              [:3]]
    want = asyncio.run(engine.embed([ids])) + asyncio.run(
        engine.embed(arrays))

    question = "Describe this picture in a few words: "
    img_a, img_b = mm["images"]
    warm = np.random.RandomState(SEED + 18).rand(
        MM_IMAGE, MM_IMAGE, 3).astype(np.float32)

    def chat_body(img):
        content = question if img is None else [
            {"type": "text", "text": question},
            {"type": "image_url", "image_url": {"url": npy_data_url(img)}}]
        return {"model": HTTP_MODEL, "max_tokens": MM_OSL, "temperature": 0,
                "ignore_eos": True,
                "messages": [{"role": "user", "content": content}]}

    chats = [chat_body(img) for img in (warm, img_a, img_a, img_b, None)]
    # what phase 3's engine gives for the same bodies, in the same order
    # from a cold cache (so the same prefix hits and chunk shapes), with
    # each body's mm prefill chunks and prefix-hit blocks
    pre = MultimodalPreprocessor(
        Preprocessor(tok, model_name=HTTP_MODEL),
        MultimodalProcessor(tok, (MM_IMAGE // MM_PATCH) ** 2,
                            local_encoder=mm["encoder"]))
    back = Backend(tok)

    async def expected():
        engine.clear_kv_blocks()
        out, counts, wires = [], [], []
        for body in chats:
            wire = await back.forward(await pre.forward(body, Context()),
                                      Context())
            wires.append(wire)
            mm0 = engine.num_mm_prefills
            hits0 = engine.stats.prefix_cache_hits
            out.append(tok.decode([t async for o in engine.generate(
                wire, Context()) for t in o["token_ids"]]))
            counts.append((engine.num_mm_prefills - mm0,
                           engine.stats.prefix_cache_hits - hits0))
        await engine.stop()
        return out[1:], counts, wires[1]["mm"]["positions"]
    want_texts, want_counts, pos = asyncio.run(expected())
    bs = engine.config.block_size
    # A again hits every full block up to the image's end; B only those
    # before the image
    print(f"[mm] phase 3's engine on the chat bodies (warm-up image, A, A "
          f"again, B, text-only; image rows {pos[0]}..{pos[-1]}): (mm "
          f"prefill chunks, prefix-hit blocks) {want_counts}", flush=True)
    if (min(c[0] for c in want_counts[:2] + want_counts[3:4]) < 1
            or want_counts[2][1] < (pos[-1] + 1) // bs
            or want_counts[3][1] > pos[0] // bs):
        fail(f"[mm] in process, an image chat ran no mm chunk, A again "
             f"stopped short of the image's end or B hit past its start: "
             f"{want_counts}")

    async def run():
        try:
            t0 = time.perf_counter()
            store = start("epd_store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]])
            await store.wait_for(r"store listening", 60)
            enc = start("epd_encoder", "dynamo_tpu_torch.multimodal",
                        ["--store-addr", addr, "--model-dim",
                         str(engine.model_config.hidden_size),
                         "--image-size", str(MM_IMAGE),
                         "--patch-size", str(MM_PATCH)])
            worker = start("epd_worker", "dynamo_tpu_torch.worker",
                           ["--model", "1b", "--model-name", HTTP_MODEL,
                            "--tokenizer", os.path.abspath(
                                served["tokenizer"]),
                            "--store-addr", addr,
                            "--mm-encode-component", "encoder",
                            "--mm-image-size", str(MM_IMAGE),
                            "--mm-patch-size", str(MM_PATCH)])
            front = start("epd_frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr])
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            ready = await enc.wait_for(
                rf"encode worker ready: {MM_IMAGE}x{MM_IMAGE} px -> "
                rf"{(MM_IMAGE // MM_PATCH) ** 2} tokens x "
                rf"{engine.model_config.hidden_size} dim on (\S+)", 120)
            if not ready.group(1).startswith(DEV):
                fail(f"[mm] the encode worker runs on {ready.group(1)}")
            await worker.wait_for(r"registered model", 300)
            for _ in range(100):
                status, _, _, _, body = await _http_request(
                    port, "GET", "/v1/models")
                if status == 200 and body["data"]:
                    break
                await asyncio.sleep(0.1)
            print(f"[mm] store, encode worker, worker and frontend up in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if front.opens_gpu():
                fail("[mm] the frontend holds the GPU")

            got = []
            for inputs, n_want in ((EMBED_TEXT, len(ids)),
                                   (arrays, sum(map(len, arrays)))):
                status, _, _, _, body = await _http_request(
                    port, "POST", "/v1/embeddings",
                    {"model": HTTP_MODEL, "input": inputs})
                if status != 200 or body["usage"]["prompt_tokens"] != n_want:
                    fail(f"[embed] /v1/embeddings: HTTP {status}, {body!r}"
                         [:400])
                got += [d["embedding"] for d in body["data"]]
            d = one_minus_cos(got, want)
            diff = max(abs(x - y) for g, w in zip(got, want)
                       for x, y in zip(g, w))
            print(f"[embed] POST /v1/embeddings through store, worker and "
                  f"frontend: 200 for a string ({len(ids)} tokens) and for "
                  f"{len(arrays)} token arrays ({sum(map(len, arrays))} "
                  f"tokens), usage.prompt_tokens right; vs phase 3's engine "
                  f"in this process: max 1 - cos {max(d):.2e} (limit "
                  f"{EMBED_BATCH_COS}), max |diff| {diff:.2e}", flush=True)
            if max(d) > EMBED_BATCH_COS:
                fail("[embed] the worker's vectors differ from the "
                     "in-process engine's")

            texts, ttft, n_prompt = [], [], []
            for body in chats:
                status, t_sent, frames, done, _ = await _http_request(
                    port, "POST", "/v1/chat/completions",
                    dict(body, stream=True))
                text = "".join(f["choices"][0]["delta"].get("content") or ""
                               for _, f in frames if f.get("choices"))
                n = frames[-1][1]["usage"]["completion_tokens"] \
                    if frames else 0
                if status != 200 or not done or n != MM_OSL:
                    fail(f"[mm] chat with an image: HTTP {status}, [DONE] "
                         f"{done}, {n} of {MM_OSL} tokens")
                firsts = [t for t, f in frames if f.get("choices") and
                          f["choices"][0]["delta"].get("content")]
                texts.append(text)
                ttft.append((firsts[0] - t_sent) * 1e3)
                n_prompt.append(frames[-1][1]["usage"]["prompt_tokens"])
            texts = texts[1:]
            same = [g == w for g, w in zip(texts, want_texts)]
            print(f"[mm] chat over HTTP with .npy data URLs "
                  f"({len(npy_data_url(img_a))} bytes each): a warm-up "
                  f"image, then A, A again, B, text-only, {MM_OSL} tokens "
                  f"each; prompt tokens {n_prompt}; TTFT "
                  f"{', '.join(f'{t:.1f}' for t in ttft)} ms (warm-up, A "
                  f"cold, A hitting the cache, B, text-only); texts equal "
                  f"to phase 3's engine in this process: {same}; A again "
                  f"same text as A: {texts[1] == texts[0]}; B's text "
                  f"differs from A's: {texts[2] != texts[0]}", flush=True)
            if not all(same):
                fail(f"[mm] chat texts over HTTP differ from the in-process "
                     f"ones: {texts} vs {want_texts}")
            for child in (front, worker, enc):
                child.proc.send_signal(signal.SIGTERM)
                rc = child.proc.wait(timeout=60)
                if rc != 0:
                    fail(f"[mm] {child.name} exited {rc}:\n{child.tail()}")
            if "encode worker exiting: 4 images encoded" not in enc.text():
                fail(f"[mm] the encode worker did not encode 4 images:\n"
                     f"{enc.tail()}")
            m = re.search(r"worker exiting: kernel launches (.*)",
                          worker.text())
            counts = dict(kv.split("=") for kv in m.group(1).split()) \
                if m else {}
            m = re.search(r"worker exiting: engine counts mm_prefills=(\d+) "
                          r"prefix_hit_blocks=(\d+)", worker.text())
            got_counts = tuple(map(int, m.groups())) if m else None
            want_total = tuple(map(sum, zip(*want_counts)))
            print(f"[mm] every process exited 0 on SIGTERM; the worker's "
                  f"launches: {counts}; its (mm prefill chunks, prefix-hit "
                  f"blocks) {got_counts}, phase 3's engine on the same "
                  f"bodies {want_total}", flush=True)
            for face in ("paged_attention_decode", "paged_attention_ragged"):
                if int(counts.get(face, 0)) == 0:
                    fail(f"[mm] {face} never launched in the EPD worker")
            # a worker that dropped or zeroed the images splices nothing;
            # one that hashed the placeholders lets B hit A's image blocks
            if got_counts != want_total:
                fail(f"[mm] the EPD worker's mm prefill chunks and prefix "
                     f"hits {got_counts} differ from the in-process "
                     f"engine's {want_total}")
        finally:
            for child in children:
                child.kill()
    asyncio.run(run())


# ---------------------------------------------------------------------------
# phase 17: tensor- and expert-parallel serving, two ranks on one card

TP = 2
# NCCL refuses two ranks on one device: the two ranks run over gloo, each
# collective staged through the host
TP_ENV = {"DYNTPU_DIST_BACKEND": "gloo"}
TP_MODEL = "llama-3.2-1b-tp2"
TP_LINE = re.compile(r"worker exiting: tp rank=(\d+) world=(\d+) "
                     r"backend=(\w+) (.*?) plans=(\S*) launches=(\S*)")
# [tp] Mixtral-8x7B at full width, cut to 4 of its 32 layers (two ranks'
# weight loads and the gloo steps of 32 layers would not fit the run's
# time); 4 sequential requests (alone, a seat's MoE capacity is never
# shared with another live row: its routing cannot depend on when the
# other requests arrived), OSL 32
TP_MOE_LAYERS = 4
TP_MOE_DIR = os.path.join("build", "ckpt_mixtral_tp")
TP_MOE_REQUESTS = 4
TP_MOE_OSL = 32


def tp_rank_lines(text: str) -> dict:
    """rank -> {"backend", "stats" (comm counters), "plans" (per kind),
    "launches" (per kernel)} from a tensor-parallel worker's exit lines
    (every rank writes to the worker's log)."""
    def kv(field, sep):
        return {k: int(v) for k, v in (
            item.split(sep) for item in field.replace(",", " ").split()
            if sep in item)}
    out = {}
    for m in TP_LINE.finditer(text):
        out[int(m.group(1))] = dict(
            world=int(m.group(2)), backend=m.group(3),
            stats=kv(m.group(4), "="), plans=kv(m.group(5), ":"),
            launches=kv(m.group(6), ":"))
    return out


def tp_check_ranks(text: str, tag: str, kv: str = "") -> dict:
    """The phase's checks on a tensor-parallel worker's exit lines: both
    ranks logged, over gloo, both faces launched on each rank, the
    follower replayed exactly the plans the leader emitted, and both made
    the same all_reduce calls and bytes. Prints the collectives per step.
    Returns face -> [launches per rank]."""
    ranks = tp_rank_lines(text)
    if sorted(ranks) != list(range(TP)):
        fail(f"{tag} exit lines of ranks {sorted(ranks)}, want "
             f"{list(range(TP))}")
    lead, fol = ranks[0], ranks[1]
    if {r["backend"] for r in ranks.values()} != {"gloo"}:
        fail(f"{tag} ranks ran over {[r['backend'] for r in ranks.values()]}")
    if fol["plans"] != lead["plans"]:
        fail(f"{tag} the follower replayed {fol['plans']}, the leader "
             f"emitted {lead['plans']}")
    for key in ("all_reduce_calls", "all_reduce_bytes"):
        if fol["stats"][key] != lead["stats"][key]:
            fail(f"{tag} {key}: leader {lead['stats'][key]}, follower "
                 f"{fol['stats'][key]}")
    faces = {}
    for face in ("decode", "ragged"):
        name = f"paged_attention_{face}{kv}"
        per_rank = [ranks[r]["launches"].get(name, 0) for r in range(TP)]
        if min(per_rank) == 0:
            fail(f"{tag} {name} launches per rank {per_rank}: a face did "
                 f"not launch on a rank")
        faces[f"paged_attention_{face}"] = per_rank
    steps = sum(lead["plans"].get(k, 0) for k in ("pp", "w", "sw"))
    calls = lead["stats"]["all_reduce_calls"]
    nbytes = lead["stats"]["all_reduce_bytes"]
    host_ms = [ranks[r]["stats"]["all_reduce_us"] / 1e3 / steps
               for r in range(TP)]
    print(f"{tag} plans per kind {lead['plans']} (leader emitted = follower "
          f"replayed); {steps} device steps; all_reduce per rank {calls} "
          f"calls, {nbytes / 1e6:.1f} MB: {calls / steps:.1f} calls and "
          f"{nbytes / steps / 1e6:.3f} MB per step, host time blocked in "
          f"them per step rank 0 {host_ms[0]:.2f} ms, rank 1 "
          f"{host_ms[1]:.2f} ms; broadcast "
          f"{lead['stats']['broadcast_calls']} (the leader's attention "
          f"choice); launches per rank {faces}", flush=True)
    return faces


async def tp_generate(addr: str, component: str, prompts, max_tokens: int,
                      concurrent: bool):
    """Greedy token streams of ``prompts`` through a worker's ``generate``
    endpoint (the path the frontend's router takes), concurrently or one
    at a time."""
    import asyncio

    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        store_addr=addr))
    try:
        client = await (rt.namespace().component(component)
                        .endpoint("generate").client())
        await client.wait_for_instances(1, 60)

        async def one(ids):
            out = []
            async for o in client.round_robin(
                    {"token_ids": list(ids), "max_tokens": max_tokens,
                     "temperature": 0.0, "ignore_eos": True}, Context()):
                out.extend(o["token_ids"])
            return out
        if concurrent:
            return await asyncio.gather(*(one(p) for p in prompts))
        return [await one(p) for p in prompts]
    finally:
        await rt.shutdown()


def tp_start(name: str, addr: str, args, env):
    """A ``--mesh 1,2`` worker process (it starts rank 1 itself, on the
    same card, over gloo)."""
    return Child(name, "dynamo_tpu_torch.worker",
                 ["--mesh", f"1,{TP}", "--store-addr", addr, *args],
                 dict(env, **TP_ENV))


def tp_env():
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))


def phase_tp(card: str, served: dict, ref) -> dict:
    """[tp] (a): Llama-3.2-1B at full width and depth, bf16, served by a
    ``--mesh 1,2`` worker (rank 0 leads; it starts rank 1 itself on the
    same card; both over gloo) from phase 9's checkpoint through
    ``load_hf_params_sharded``, behind the store and the frontend. Phase
    3's traffic (16 concurrent greedy requests, ISL 512, OSL 64) through
    the frontend over HTTP gives TTFT, ITL and tok/s — a correctness run of
    two ranks on one card over host-staged gloo, not a tensor-parallel
    speed; the same traffic through the worker's ``generate`` endpoint
    gives token streams that must meet the parity rule against phase 3's
    one-rank engine on the same weights (``ref``: phase 9's eager rerun).
    Each rank's launches of both faces (> 0), the follower's plans
    (= the leader's) and the all_reduce calls and bytes per step come from
    the ranks' exit lines. Returns face -> launches per rank."""
    import asyncio
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    want, rec, prompts = ref
    env = tp_env()
    addr = f"127.0.0.1:{_free_port()}"
    children = []

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        try:
            t0 = time.perf_counter()
            store = Child("tp_store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]], env)
            children.append(store)
            await store.wait_for(r"store listening", 60)
            worker = tp_start("tp_worker", addr, [
                "--weights", os.path.abspath(LOAD_DIR),
                "--model-name", TP_MODEL,
                "--tokenizer", os.path.abspath(served["tokenizer"])], env)
            children.append(worker)
            front = Child("tp_frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr], env)
            children.append(front)
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            await worker.wait_for(r"registered model", 300)
            text = worker.text()
            loads = re.findall(r"loaded (\d+) tensors \(([\d.]+) GB\) .*"
                               r"shard (\d)/2, .* in ([\d.]+) s", text)
            print(f"[tp] {card}: store, a --mesh 1,2 worker (rank 1 started "
                  f"by rank 0, both on cuda:0 over gloo) and the frontend "
                  f"up in {time.perf_counter() - t0:.1f} s; sharded loads "
                  + "; ".join(f"rank {r}: {n} tensors, {gb} GB in {s} s"
                              for n, gb, r, s in loads), flush=True)
            if len(loads) != TP:
                fail(f"[tp] {len(loads)} sharded loads logged, want {TP}")

            def job(ids):
                return dict(method="POST", path="/v1/completions", body={
                    "model": TP_MODEL, "prompt": list(ids),
                    "max_tokens": OSL, "temperature": 0,
                    "ignore_eos": True, "stream": True})
            while True:
                (status, _, _, _, body), = await loop.run_in_executor(
                    procs, http_client, port,
                    [dict(method="GET", path="/v1/models")])
                if status == 200 and any(m["id"] == TP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f"[tp] /v1/models never listed {TP_MODEL}")
                await asyncio.sleep(0.2)
            t_start = time.perf_counter()
            results = await loop.run_in_executor(
                procs, http_client, port, [job(p) for p in prompts])
            wall = time.perf_counter() - t_start
            runs = []
            for status, t_sent, frames, done, body in results:
                content = [t for t, f in frames if f["choices"][0]["text"]]
                n = (frames[-1][1]["usage"]["completion_tokens"]
                     if frames else 0)
                if status != 200 or not done or n != OSL or len(content) < 2:
                    fail(f"[tp] HTTP stream: {status}, [DONE] {done}, {n} of "
                         f"{OSL} tokens: {body or frames[-2:]}")
                runs.append((t_sent, content[0], content[-1], n))
            stats = traffic_stats(runs, wall)
            print(f"[tp] {card}: {N_REQUESTS} streams ISL {ISL} OSL {OSL} "
                  f"through store + the 2-rank worker + frontend: "
                  f"{stats_line(stats)} — a correctness run of two ranks on "
                  f"one card over host-staged gloo, not a tensor-parallel "
                  f"speed", flush=True)
            got = await tp_generate(addr, "backend", prompts, OSL,
                                    concurrent=True)
            if [len(g) for g in got] != [OSL] * len(prompts):
                fail("[tp] short streams from the generate endpoint")
            partings = check_parity(want, rec, got,
                                    "phase 3's one-rank bf16 engine",
                                    tag="[tp]")
            print(f"[tp] {card}: streams of the 2-rank worker vs phase 3's "
                  f"one-rank engine on the same weights: "
                  f"{len(prompts) - len(partings)} of {len(prompts)} "
                  f"identical, {len(partings)} part at near-ties",
                  flush=True)
            worker.proc.send_signal(signal.SIGTERM)
            rc = await loop.run_in_executor(None, worker.proc.wait, 90)
            if rc != 0:
                fail(f"[tp] the worker exited {rc}:\n{worker.tail()}")
            return tp_check_ranks(worker.text(), "[tp]")
        finally:
            procs.shutdown(wait=True)

    try:
        return asyncio.run(run())
    finally:
        for c in reversed(children):
            c.kill()


def phase_tp_moe(card: str, served: dict) -> dict:
    """[tp] (c): Mixtral-8x7B at full width (TP_MOE_LAYERS of 32 layers),
    bf16, random weights from seed 0: written as an HF checkpoint (free
    disk checked first), served one-rank in this process and by a
    ``--mesh 1,2`` worker with the experts over tp (4 of 8 per rank,
    ``load_hf_params_sharded`` reads each rank's experts only), both on
    the synchronous loop, requests one at a time; the 2-rank streams must
    meet the parity rule against the one-rank run's. Each rank's
    ``moe_ffn`` at its own 4 experts is timed on the card (N = 16, the
    decode window, and 512, a prefill chunk) and the two ranks' partial
    outputs must sum to the one-rank ``moe_ffn``'s. Returns face ->
    launches per rank."""
    import asyncio
    import shutil

    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine import ModelConfig, weights
    from dynamo_tpu_torch.engine.model import torch_dtype
    from dynamo_tpu_torch.parallel.moe import moe_ffn

    cfg = dataclasses.replace(ModelConfig.mixtral_8x7b(),
                              num_layers=TP_MOE_LAYERS)
    engine = InferenceEngine(cfg, EngineConfig(pipeline_depth=1),
                             seed=SEED, device=DEV)
    # each rank's moe_ffn: layer 0's router and its half of the experts
    lay = engine.params["layers"]
    w = [lay[k][0] for k in ("w_router", "w_gate", "w_up", "w_down")]
    k, cf = cfg.num_experts_per_token, cfg.moe_capacity_factor
    El = cfg.num_experts // TP
    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    for N in (16, 512):
        x = torch.randn(N, cfg.hidden_size, generator=gen, device=DEV,
                        dtype=torch.float32).to(torch_dtype(cfg))
        full = moe_ffn(x, *w, top_k=k, capacity_factor=cf).float()
        parts, ms = [], []
        for r in range(TP):
            ws = [w[0]] + [t[r * El:(r + 1) * El] for t in w[1:]]

            def call(ws=ws, r=r):
                return moe_ffn(x, *ws, top_k=k, capacity_factor=cf,
                               expert_offset=r * El)
            parts.append(call())
            ms.append(device_ms(call))
        one_ms = device_ms(lambda: moe_ffn(x, *w, top_k=k,
                                           capacity_factor=cf))
        err = (sum(parts) - full).abs().max().item()
        atol, rtol = TOL[cfg.dtype]
        print(f"[tp] {card}: moe_ffn N={N} per rank (4 of 8 experts, "
              f"expert_offset 0 / 4): rank 0 {ms[0]:.4f} ms, rank 1 "
              f"{ms[1]:.4f} ms device, vs {one_ms:.4f} ms one-rank (all 8); "
              f"sum of the partials vs the one-rank output max |diff| "
              f"{err:.3e}", flush=True)
        if not err <= atol + rtol * full.abs().max().item():
            fail(f"[tp] moe_ffn partials disagree with the one-rank output "
                 f"at N={N}: {err}")

    nbytes = sum(t.numel() * t.element_size()
                 for _, t in weights.hf_tensors(engine.params, cfg))
    free = shutil.disk_usage(os.path.abspath("build")).free
    print(f"[tp] {card}: Mixtral-8x7B at {TP_MOE_LAYERS} of 32 layers: "
          f"{nbytes / 1e9:.2f} GB of bf16 weights; free disk under build/ "
          f"{free / 1e9:.1f} GB", flush=True)
    if free < 1.2 * nbytes:
        fail(f"[tp] {free / 1e9:.1f} GB free on disk, the checkpoint "
             f"needs {nbytes / 1e9:.2f} GB")
    shutil.rmtree(TP_MOE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    weights.save_hf_params(TP_MOE_DIR, engine.params, cfg, n_shards=4)
    print(f"[tp] {card}: wrote the checkpoint in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = main_prompts(cfg.vocab_size)[:TP_MOE_REQUESTS]
    want, rec, rgaps = [], {}, {}
    for i, p in enumerate(prompts):
        # one request at a time, as the worker will be served
        g1 = {}
        w1, r1 = tapped_run(engine, [p], osl=TP_MOE_OSL, router_gaps=g1)
        want += w1
        rec.update({(i, j): v for (_, j), v in r1.items()})
        rgaps.update({(i, j): v for (_, j), v in g1.items()})
    near = sum(g < ROUTER_MARGIN for g in rgaps.values())
    print(f"[tp] {card}: one-rank Mixtral reference: {near} of "
          f"{len(rgaps)} output rows sit at a routing near-tie (router "
          f"logit gap at the top-k boundary under {ROUTER_MARGIN}); "
          f"smallest gap {min(rgaps.values()):.5f}", flush=True)
    del engine, lay, w
    gc.collect()
    torch.cuda.empty_cache()

    env = tp_env()
    addr = f"127.0.0.1:{_free_port()}"
    children = []

    async def run():
        import signal

        store = Child("tp_moe_store", "dynamo_tpu_torch.runtime.store",
                      ["--host", "127.0.0.1",
                       "--port", addr.rsplit(":", 1)[1]], env)
        children.append(store)
        await store.wait_for(r"store listening", 60)
        t0 = time.perf_counter()
        worker = tp_start("tp_moe_worker", addr, [
            "--weights", os.path.abspath(TP_MOE_DIR),
            "--model-name", "mixtral-tp2", "--pipeline-depth", "1",
            "--tokenizer", os.path.abspath(served["tokenizer"])], env)
        children.append(worker)
        await worker.wait_for(r"registered model", 400)
        print(f"[tp] {card}: the Mixtral --mesh 1,2 worker (experts over "
              f"tp) up in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        got = await tp_generate(addr, "backend", prompts, TP_MOE_OSL,
                                concurrent=False)
        wall = time.perf_counter() - t0
        partings = check_parity(want, rec, got,
                                "the one-rank Mixtral engine", tag="[tp]",
                                router_gaps=rgaps)
        print(f"[tp] {card}: Mixtral streams, 2 ranks (experts over tp) vs "
              f"one rank, {TP_MOE_REQUESTS} requests one at a time on the "
              f"synchronous loop: {len(prompts) - len(partings)} of "
              f"{len(prompts)} identical, {len(partings)} part at "
              f"near-ties; {wall:.1f} s for "
              f"{TP_MOE_REQUESTS * TP_MOE_OSL} tokens", flush=True)
        worker.proc.send_signal(signal.SIGTERM)
        loop = asyncio.get_running_loop()
        rc = await loop.run_in_executor(None, worker.proc.wait, 90)
        if rc != 0:
            fail(f"[tp] the Mixtral worker exited {rc}:\n{worker.tail()}")
        return tp_check_ranks(worker.text(), "[tp] Mixtral")

    try:
        return asyncio.run(run())
    finally:
        for c in reversed(children):
            c.kill()
        shutil.rmtree(TP_MOE_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: sequence-parallel (ring) prefill on a (dp, tp) mesh, ranks
# sharing one card

SP_THRESHOLD = 2048        # a fresh prompt this long prefills as one chunk
SP_ISL = 8128              # bucketed to an 8,192-token sp chunk
SP_OSL = 64
SP_REQUESTS = 4            # one at a time
SP_MESH = (2, 1)
# (b): four ranks at full width, cut to 4 of Llama-3.2-1B's 16 layers: four
# CUDA contexts, four copies of the weights and four ranks' eager steps
# over host-staged gloo on one card would not fit the script's time at
# full depth
SP_MESH_B = (2, 2)
SP_LAYERS_B = 4
# (d): mesh (1, 2) at full depth, one long prompt: the sp chunk is the whole
# prompt on both tp ranks (a seq column of one rank), its per-rank peak
# memory the figure ROADMAP item 6.3 weighs the composite sequence axis by
SP_MESH_D = (1, 2)
SP_OSL_D = 16
# (c): ring and Ulysses at one Llama-3.2-1B layer's attention shape
SP_ATTN = dict(T=8192, H=32, KV=8, hd=64)
SP_ATTN_REPS = 3
# ring and Ulysses against the plain _full_attention, both rounded to
# bf16 from f32: |err| <= SP_ATTN_ATOL + SP_ATTN_RTOL * |want|, two bf16
# ulps of the plain value (an ulp is at most 2**-7 of it) above a floor
# for f32 summation order near zero. A dropped or misordered hop moves a
# row by about its own size, far above two ulps
SP_ATTN_RTOL = 2.0 ** -6
SP_ATTN_ATOL = 1e-5
# the gloo collectives that parallel/comm.py hands CUDA tensors directly;
# its ring hop (send/recv) stages through the host instead
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather", "gather",
                 "all_to_all")
SP_RANK_TIMEOUT_S = 300.0  # every collective of a rank, and every job


def sp_prompts(vocab: int):
    """Phase 18's long prompts: SP_REQUESTS random prompts of SP_ISL
    tokens."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 31)
    return [torch.randint(1, vocab, (SP_ISL,), generator=gen).tolist()
            for _ in range(SP_REQUESTS)]


def sp_rank_main(rank: int, n: int, port: int, tag: str, dev: str, cmd,
                 res, plans) -> None:
    """A rank of phase 18's world: its output in
    ``build/dist/sp_<tag>_rank<r>.log``, gloo on ``dev`` (cuda:0), then
    the jobs the script sends (``fn(rank, plans, *args)``) until it sends
    ``None``."""
    import traceback

    os.makedirs(DIST_LOGS, exist_ok=True)
    log = open(os.path.join(DIST_LOGS, f"sp_{tag}_rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    try:
        import torch

        from dynamo_tpu_torch.parallel import comm

        torch.cuda.set_device(torch.device(dev).index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init(rank, n, f"tcp://127.0.0.1:{port}", "gloo",
                  SP_RANK_TIMEOUT_S)
        res.put((rank, "ready", None))
    except BaseException:  # noqa: BLE001 — reported to the script
        res.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = cmd.get()
        if job is None:
            break
        fn, args = job
        try:
            res.put((rank, "ok", fn(rank, plans, *args)))
        except BaseException:  # noqa: BLE001
            res.put((rank, "error", traceback.format_exc()))
    comm.destroy()


class SpWorld:
    """N rank processes on the card, joined over gloo (the script's own
    copy of the tests' plan-queue world: the leader's plans reach each
    follower's queue)."""

    def __init__(self, n: int, tag: str):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.n, self.tag = n, tag
        self._cmd = [ctx.Queue() for _ in range(n)]
        self._res = ctx.Queue()
        plans = [ctx.Queue() for _ in range(n)]
        port = _free_port()
        self.procs = [ctx.Process(target=sp_rank_main, args=(
            r, n, port, tag, DEV, self._cmd[r], self._res, plans),
            daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()
        self.collect(120.0)

    def collect(self, timeout_s: float = SP_RANK_TIMEOUT_S,
                must: bool = True):
        """Every rank's answer; with ``must`` a rank's error or silence
        fails the script, without it (a probe that may end a rank) each
        rank's answer is ``(status, value)``, a silent rank's
        ``("exit", its exit code)``."""
        import queue

        out, errors = [None] * self.n, []
        pending = set(range(self.n))
        deadline = time.monotonic() + timeout_s
        while pending:
            try:
                rank, status, val = self._res.get(timeout=1.0)
            except queue.Empty:
                # a rank that ended without answering never will: wait no
                # longer once every silent rank has ended (one more look
                # for an answer sent just before its rank ended)
                ended = all(self.procs[r].exitcode is not None
                            for r in pending)
                if not ended and time.monotonic() < deadline:
                    continue
                try:
                    rank, status, val = self._res.get(timeout=1.0)
                except queue.Empty:
                    codes = [p.exitcode for p in self.procs]
                    if not must:
                        return [o if o is not None else ("exit", codes[r])
                                for r, o in enumerate(out)]
                    self.close()
                    fail(f"[sp] a rank of the {self.tag} world ended or "
                         f"did not answer in {timeout_s:.0f} s (exit codes "
                         f"{codes}; logs "
                         f"{DIST_LOGS}/sp_{self.tag}_rank*.log)")
            pending.discard(rank)
            if status == "error":
                errors.append(f"rank {rank}:\n{val}")
            out[rank] = val if must else (status, val)
        if errors and must:
            self.close()
            fail("[sp] " + "\n".join(errors))
        return out

    def run(self, fn, *args, timeout_s: float = SP_RANK_TIMEOUT_S,
            must: bool = True):
        self.start(fn, *args)
        return self.collect(timeout_s, must)

    def start(self, fn, *args) -> None:
        """Send every rank ``fn(rank, plans, *args)`` without waiting (two
        worlds then run side by side on the card); :meth:`collect` takes
        the answers."""
        for q in self._cmd:
            q.put((fn, args))

    def close(self) -> None:
        for q in self._cmd:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def sp_lead(engine, plans, n: int) -> dict:
    """Rank 0's plan sink: each plan, encoded as the wire carries it, to
    every follower's queue before the leader launches the step."""
    from dynamo_tpu_torch.parallel.multihost import encode_plan

    emitted = {}

    def sink(kind, arrays):
        emitted[kind] = emitted.get(kind, 0) + 1
        plan = encode_plan(kind, arrays)
        for r in range(1, n):
            plans[r].put(plan)

    engine.step_sink = sink
    return emitted


def sp_follow(engine, plans, rank: int) -> dict:
    """A follower of a phase-18 or phase-21 leader: replays its plans; at
    ``reset`` (the leader's counts start here) zeroes its counts and peak
    device memory and keeps the allocation then (``base``), at ``mark``
    keeps its collectives and the peak since (``stats``, ``peak``).
    Returns what it kept."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.multihost import decode_plan, replay_plan

    kept = {}
    while True:
        plan = plans[rank].get(timeout=SP_RANK_TIMEOUT_S)
        if plan is None:
            return kept
        if plan == "reset":
            pa.reset_launches()
            comm.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kept["base"] = torch.cuda.memory_allocated()
            continue
        if plan == "mark":
            torch.cuda.synchronize()
            kept.update(peak=torch.cuda.max_memory_allocated(),
                        stats=dict(comm.STATS))
            continue
        replay_plan(engine, *decode_plan(plan))


def sp_watch_peaks(engine) -> list:
    """Wrap the engine's sp prefill so each call records this rank's
    device memory: (allocated before, peak during) in bytes, the peak
    counter reset just before the call (a measurement hook: it
    synchronises the card around each sp prefill)."""
    import torch

    peaks = []
    make = engine._sp_prefill_fn

    def for_shape(T, W):
        fn = make(T, W)

        def measured(*args):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args)
            torch.cuda.synchronize()
            peaks.append((base, torch.cuda.max_memory_allocated()))
            return out
        return measured

    engine._sp_prefill_fn = for_shape
    return peaks


def sp_serve_job(rank, plans, dev, cfg, mesh, threshold, long_prompts,
                 short_prompts, long_osl=SP_OSL):
    """One rank of an sp engine on ``mesh`` with sp threshold
    ``threshold`` (``cfg``: Llama-3.2-1B, bf16, random weights from SEED
    on every rank, on ``dev``): rank 0 leads and
    serves the long prompts one at a time (TTFT and stream of each), then
    the short ones concurrently; the others replay its plans. Every rank
    returns its sp prefills, plans, collectives, kernel launches and the
    device memory of each sp prefill."""
    import asyncio

    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, EngineConfig(
        mesh_shape=mesh, sp_prefill_threshold=threshold), seed=SEED,
        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    peaks = sp_watch_peaks(engine)
    n = comm.world_size()
    out = {"build_s": build_s, "resident": resident,
           "graphed": engine._ap_window_fn.graphed}

    async def one(ids, max_tokens):
        t_sub = time.perf_counter()
        toks, times = [], []
        async for o in engine.generate({"token_ids": ids,
                                        "max_tokens": max_tokens,
                                        "temperature": 0.0}, Context()):
            toks.extend(o["token_ids"])
            times.append(time.perf_counter())
        return toks, times[0] - t_sub, (t_sub, times[0], times[-1],
                                        len(toks))

    async def lead():
        await engine.start()
        try:
            # warm-up on the chunked path (cuBLAS handles, first launches)
            await one(long_prompts[0][:32], 4)
            engine.clear_kv_blocks()
            pa.reset_launches()
            comm.reset_stats()
            for r in range(1, n):       # the followers reset here too
                plans[r].put("reset")
            longs = [await one(p, long_osl) for p in long_prompts]
            t_short = time.perf_counter()
            shorts = await asyncio.gather(*(one(p, OSL)
                                            for p in short_prompts))
            return longs, shorts, time.perf_counter() - t_short
        finally:
            await engine.stop()

    if rank != 0:
        sp_follow(engine, plans, rank)
    else:
        emitted = sp_lead(engine, plans, n)
        try:
            longs, shorts, short_wall = asyncio.run(lead())
        finally:
            for r in range(1, n):
                plans[r].put(None)
        out.update(
            long_streams=[t for t, _, _ in longs],
            long_ttft=[f for _, f, _ in longs],
            long_itl=[(last - first) / max(1, k - 1)
                      for _, _, (_, first, last, k) in longs],
            short_streams=[t for t, _, _ in shorts],
            short_runs=[run for _, _, run in shorts],
            short_wall=short_wall, emitted=dict(emitted))
    out.update(replayed=dict(engine.num_replayed),
               sp_prefills=engine.num_sp_prefills, stats=dict(comm.STATS),
               launches=dict(pa.LAUNCHES), peaks=peaks)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_attention_job(rank, plans, dev, T, H, KV, hd):
    """(c): ``ring_attention`` and ``ulysses_attention`` on this rank's
    slice of one Llama-3.2-1B layer's attention (causal, bf16 in, the
    f32 online softmax inside) against the plain ``_full_attention`` over
    the whole sequence (on this rank, its rows compared); the time of each
    call (host clock around a synchronised call: the gloo hops block the
    host) and of one ring hop of a K chunk."""
    import torch

    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.layout import make_mesh
    from dynamo_tpu_torch.parallel.ring_attention import ring_attention
    from dynamo_tpu_torch.parallel.ulysses import (
        _full_attention, ulysses_attention,
    )

    n = comm.world_size()
    dpg = make_mesh((n, 1)).dp_group
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    q, k, v = (torch.randn(1, T, x, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for x in (H, KV, KV))
    C = T // n
    mine = slice(rank * C, (rank + 1) * C)
    want = _full_attention(q, k, v, True)[:, mine].float()
    torch.cuda.synchronize()
    plain_ms = []
    for _ in range(SP_ATTN_REPS):
        t0 = time.perf_counter()
        _full_attention(q, k, v, True)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"plain_ms": min(plain_ms)}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        ms = []
        for _ in range(SP_ATTN_REPS):
            comm.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(q[:, mine], k[:, mine], v[:, mine], dpg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        err = (got.float() - want).abs()
        out[name] = {"ms": min(ms), "stats": dict(comm.STATS),
                     "max_abs_err": err.max().item(),
                     # the worst excess over the relative part of the limit
                     "excess": (err - SP_ATTN_RTOL * want.abs()).max().item(),
                     "finite": bool(torch.isfinite(got).all())}
    chunk = k[:, mine].contiguous()
    hop = []
    for _ in range(SP_ATTN_REPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.ppermute(chunk, dpg)
        torch.cuda.synchronize()
        hop.append((time.perf_counter() - t0) * 1e3)
    out["hop_ms"] = min(hop)
    out["hop_bytes"] = chunk.numel() * chunk.element_size()
    return out


def sp_probe_job(rank, plans, dev, ops):
    """Hand each gloo collective of ``ops`` (``GLOO_CUDA_OPS`` and
    ``"ppermute"``, send/recv) a CUDA tensor directly over the world and
    check its result: op -> "yes" or the error. Point-to-point runs last:
    a transport that reads a device pointer on the host may raise, or
    abort the process, so the script probes it in a world of its own."""
    import datetime

    import torch
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel import comm

    g = comm.world_group()
    n, i = g.size, g.index
    device = torch.device(dev)
    out = {}

    def attempt(op, fn, want):
        if op not in ops:
            return
        try:
            ok = torch.equal(fn().cpu(), want)
            out[op] = "yes" if ok else "wrong result"
        except Exception as e:  # noqa: BLE001 — the answer is the probe's
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"

    def mine(k=4):
        return torch.arange(k, dtype=torch.float32, device=device) + 10 * i

    def plain(k=4, j=i):
        return torch.arange(k, dtype=torch.float32) + 10 * j

    def reduce():
        t = mine()
        dist.all_reduce(t, group=g.pg)
        return t
    attempt("all_reduce", reduce, sum(plain(j=j) for j in range(n)))

    def bcast():
        t = mine()
        dist.broadcast(t, src=g.ranks[0], group=g.pg)
        return t
    attempt("broadcast", bcast, plain(j=0))

    def gather():
        parts = [torch.empty(4, device=device) for _ in range(n)]
        dist.all_gather(parts, mine(), group=g.pg)
        return torch.cat(parts)
    attempt("all_gather", gather, torch.cat([plain(j=j) for j in range(n)]))

    def gather_first():
        t = mine()
        parts = ([torch.empty(4, device=device) for _ in range(n)]
                 if i == 0 else None)
        dist.gather(t, parts, dst=g.ranks[0], group=g.pg)
        return torch.cat(parts) if i == 0 else t
    attempt("gather", gather_first,
            torch.cat([plain(j=j) for j in range(n)]) if i == 0 else plain())

    def a2a():
        src = mine(2 * n)
        dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src, group=g.pg)
        return dst
    attempt("all_to_all", a2a, torch.cat([
        plain(2 * n, j)[2 * i:2 * i + 2] for j in range(n)]))

    def p2p():
        recv = torch.empty(4, device=device)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, mine(), g.ranks[(i + 1) % n], g.pg),
            dist.P2POp(dist.irecv, recv, g.ranks[(i - 1) % n], g.pg)])
        for w in works:
            w.wait(datetime.timedelta(seconds=SP_RANK_TIMEOUT_S))
        return recv
    attempt("ppermute", p2p, plain(j=(i - 1) % n))
    return out


def sp_check_ranks(got, tag: str, n_sp: int, layers: int, dp: int,
                   faces_run=("decode",)) -> dict:
    """Phase 18's checks on one world's ranks: ``n_sp`` sp prefills on
    every rank, the followers replayed exactly the plans the leader
    emitted (``rsp`` among them), both faces launched on every rank whose
    run had short traffic, and each sp prefill made ``2 (dp - 1)`` ring
    hops per layer. Prints the collectives per sp prefill; returns face ->
    launches per rank."""
    lead = got[0]
    if lead["emitted"].get("rsp", 0) != n_sp:
        fail(f"{tag} the leader emitted {lead['emitted'].get('rsp', 0)} "
             f"rsp plans, want {n_sp}")
    for r, g in enumerate(got):
        if g["sp_prefills"] != n_sp:
            fail(f"{tag} rank {r} ran {g['sp_prefills']} sp prefills, "
                 f"want {n_sp}")
        if g["graphed"]:
            fail(f"{tag} rank {r} captured decode graphs on a multi-rank "
                 "mesh")
    for r, g in enumerate(got[1:], 1):
        if g["replayed"] != lead["emitted"]:
            fail(f"{tag} rank {r} replayed {g['replayed']}, the leader "
                 f"emitted {lead['emitted']}")
    faces = {}
    for face in ("decode", "ragged"):
        name = f"paged_attention_{face}"
        faces[name] = [g["launches"].get(name, 0) for g in got]
    for face in faces_run:
        name = f"paged_attention_{face}"
        if min(faces[name]) == 0:
            fail(f"{tag} the {face} face did not launch on every rank: "
                 f"{faces[name]}")
    hops = [g["stats"]["ppermute_calls"] / n_sp for g in got]
    if any(h != 2 * (dp - 1) * layers for h in hops):
        fail(f"{tag} ring hops per sp prefill {hops}, want "
             f"{2 * (dp - 1) * layers} (K and V, dp - 1 each, per layer)")
    st = lead["stats"]
    per = {k: st[k] / n_sp for k in (
        "ppermute_bytes", "ppermute_us", "staged_bytes", "all_gather_calls",
        "all_gather_bytes", "all_gather_us", "all_reduce_calls",
        "all_reduce_bytes")}
    print(f"{tag} plans per kind {lead['emitted']} (leader emitted = every "
          f"follower replayed); sp prefills per rank "
          f"{[g['sp_prefills'] for g in got]}; per sp prefill on rank 0: "
          f"{hops[0]:.0f} ring hops, {per['ppermute_bytes'] / 1e6:.2f} MB "
          f"sent, {per['ppermute_us'] / 1e3:.1f} ms of host blocked in "
          f"them, {per['staged_bytes'] / 1e6:.2f} MB staged through the "
          f"host (the hops: gloo send/recv takes no CUDA tensor), "
          f"{per['all_gather_calls']:.0f} all_gathers of "
          f"{per['all_gather_bytes'] / 1e6:.2f} MB "
          f"({per['all_gather_us'] / 1e3:.1f} ms), "
          f"{per['all_reduce_calls']:.0f} all_reduces of "
          f"{per['all_reduce_bytes'] / 1e6:.2f} MB; launches per rank "
          f"{faces}", flush=True)
    return faces


def phase_sp(card: str) -> dict:
    """[sp] Sequence-parallel (ring) prefill, ranks sharing cuda:0 over
    gloo. (a) Llama-3.2-1B at full width and depth, bf16, random weights
    from SEED, mesh (2, 1), threshold 2,048: 4 prompts of ISL 8,128 (each
    one 8,192-token sp chunk) with OSL 64, one at a time, then phase 3's
    traffic on the chunked path; streams under the parity rule against a
    one-rank engine with chunked prefill on the same weights; sp prefills
    and ``rsp`` replays per rank, ring hops and bytes per sp prefill, each
    rank's peak device memory in an sp prefill beside the one-rank
    engine's in one 8,192-token chunk, and TTFT beside the chunked one
    (a correctness run: two ranks on one card over host-staged gloo).
    (c) ring and Ulysses at one 1B layer's attention shape against the
    plain ``_full_attention``, then the gloo probe. (b) mesh (2, 2), four
    ranks at full width cut to 4 of 16 layers, one long prompt against its
    one-rank run. (d) mesh (1, 2) at full depth, one long prompt (OSL
    SP_OSL_D), side by side with (b): each rank's peak rise in its sp
    prefill beside the one-rank chunk's, and the stream under the parity
    rule. Returns the launch counts of (a),
    (b) and (d), summed over ranks, for the kernels line."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine import ModelConfig
    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.parallel import comm

    cfg = ModelConfig.llama3_1b()
    longs = sp_prompts(cfg.vocab_size)
    shorts = main_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    ref = InferenceEngine(cfg, EngineConfig(), seed=SEED, device=DEV)
    want_long, rec_long, ttft_ref = [], {}, []
    for i, p in enumerate(longs):
        w, r = tapped_run(ref, [p], osl=SP_OSL)
        want_long += w
        rec_long.update({(i, j): v for (_, j), v in r.items()})
        _, stamps, _, _ = serve_batch(ref, [p], 1)
        ttft_ref.append(stamps[0][1][0] - stamps[0][0])
    want_short, rec_short = tapped_run(ref, shorts)
    # the one-rank engine's device memory in ONE 8,192-token chunk
    T = 1 << (SP_ISL - 1).bit_length()        # the sp chunk's bucket
    W = ref.config.max_blocks_per_seq
    fn = model_lib.raw_packed_prefill_fn(cfg, ref.config, T, W)
    pint = np.zeros((1, T + W + model_lib.PP_SCALARS), np.int32)
    pint[0, :SP_ISL] = longs[0]
    pint[0, T:T + W] = np.arange(1, W + 1)
    pint[0, T + W:] = (SP_ISL, 0, ref.config.max_num_seqs, 0, 0, -1, 0,
                       int(model_lib.PP_QUANT))
    torch.cuda.synchronize()
    one_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(ref.params, ref.cache, ref._ctl["last_tok"],
       torch.from_numpy(pint).to(DEV), ref._next_key(), False)
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated()
    ref_s = time.perf_counter() - t0
    del ref, fn
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sp] {card}: one-rank reference (chunked prefill, 512-token "
          f"chunks) for {SP_REQUESTS} prompts of ISL {SP_ISL} OSL {SP_OSL} "
          f"and phase 3's traffic in {ref_s:.1f} s; its TTFT per long "
          f"prompt {[round(t * 1e3, 1) for t in ttft_ref]} ms; one "
          f"8,192-token chunk on one rank: {one_base / 2**30:.3f} GiB "
          f"resident, peak {one_peak / 2**30:.3f} GiB "
          f"(+{(one_peak - one_base) / 2**30:.3f} GiB)", flush=True)

    t0 = time.perf_counter()
    world = SpWorld(SP_MESH[0] * SP_MESH[1], "dp2")
    try:
        up_s = time.perf_counter() - t0
        got = world.run(sp_serve_job, DEV, cfg, SP_MESH, SP_THRESHOLD,
                        longs, shorts)
        lead = got[0]
        print(f"[sp] {card}: mesh {SP_MESH}, two ranks on cuda:0 over "
              f"gloo (up in {up_s:.1f} s, engines built in "
              f"{[round(g['build_s'], 1) for g in got]} s, decode windows "
              f"eager on every rank: no graph is captured on a multi-rank "
              f"mesh)", flush=True)
        partings = check_parity(want_long, rec_long, lead["long_streams"],
                                "the one-rank chunked engine", tag="[sp]")
        print(f"[sp] {card}: long streams (one 8,192-token sp chunk each) "
              f"vs the one-rank chunked engine: "
              f"{SP_REQUESTS - len(partings)} of {SP_REQUESTS} identical, "
              f"{len(partings)} part at near-ties", flush=True)
        partings = check_parity(want_short, rec_short, lead["short_streams"],
                                "the one-rank chunked engine", tag="[sp]")
        print(f"[sp] {card}: phase 3's traffic on the (2, 1) engine (the "
              f"chunked path, replicated over dp): "
              f"{N_REQUESTS - len(partings)} of {N_REQUESTS} identical, "
              f"{len(partings)} part at near-ties; "
              + stats_line(traffic_stats(lead["short_runs"],
                                         lead["short_wall"])), flush=True)
        faces_a = sp_check_ranks(got, "[sp] (2, 1)", SP_REQUESTS,
                                 cfg.num_layers, SP_MESH[0],
                                 ("decode", "ragged"))
        for r, g in enumerate(got):
            rise = [(p - b) / 2**30 for b, p in g["peaks"]]
            print(f"[sp] {card}: rank {r} device memory in its sp "
                  f"prefills: {g['resident'] / 2**30:.3f} GiB resident "
                  f"after the engine, peak "
                  f"{max(p for _, p in g['peaks']) / 2**30:.3f} GiB "
                  f"(+{max(rise):.3f} GiB over the allocation before the "
                  f"prefill); the one-rank engine's one 8,192-token chunk "
                  f"+{(one_peak - one_base) / 2**30:.3f} GiB", flush=True)
        print(f"[sp] {card}: TTFT of the sp prefill per long prompt "
              f"{[round(t * 1e3, 1) for t in lead['long_ttft']]} ms vs the "
              f"one-rank chunked {[round(t * 1e3, 1) for t in ttft_ref]} ms"
              f"; ITL {[round(t * 1e3, 2) for t in lead['long_itl']]} ms — "
              f"a correctness run (two ranks on one card, ring hops staged "
              f"through the host), not a sequence-parallel speed",
              flush=True)

        a = SP_ATTN
        attn = world.run(sp_attention_job, DEV, a["T"], a["H"], a["KV"],
                         a["hd"])
        for r, res in enumerate(attn):
            for name in ("ring", "ulysses"):
                x = res[name]
                if not x["finite"] or x["excess"] > SP_ATTN_ATOL:
                    fail(f"[sp] {name} attention on rank {r} disagrees "
                         f"with the plain version: max |err| "
                         f"{x['max_abs_err']}, {x['excess']} above "
                         f"{SP_ATTN_RTOL} * |want| (limit {SP_ATTN_ATOL})")
        r0 = attn[0]
        print(f"[sp] {card}: attention at T {a['T']}, {a['H']} / {a['KV']} "
              f"heads, hd {a['hd']}, bf16 in, causal, on 2 ranks vs the "
              f"plain _full_attention (limit |err| <= {SP_ATTN_ATOL} + "
              f"{SP_ATTN_RTOL} * |want|; worst excess ring "
              f"{max(x['ring']['excess'] for x in attn):.3e}, Ulysses "
              f"{max(x['ulysses']['excess'] for x in attn):.3e}): ring "
              f"max |err| "
              f"{max(x['ring']['max_abs_err'] for x in attn):.3e} in "
              f"{r0['ring']['ms']:.2f} ms (rank 0; "
              f"{r0['ring']['stats']['ppermute_calls']} hops of "
              f"{r0['hop_bytes'] / 1e6:.2f} MB, one hop "
              f"{r0['hop_ms']:.3f} ms), Ulysses max |err| "
              f"{max(x['ulysses']['max_abs_err'] for x in attn):.3e} in "
              f"{r0['ulysses']['ms']:.2f} ms "
              f"({r0['ulysses']['stats']['all_to_all_calls']} all_to_alls "
              f"of {r0['ulysses']['stats']['all_to_all_bytes'] / 1e6:.1f} "
              f"MB), the plain version on one rank {r0['plain_ms']:.2f} ms "
              f"(host clock around synchronised calls)", flush=True)
        probe = world.run(sp_probe_job, DEV, GLOO_CUDA_OPS)
    finally:
        world.close()
    # send/recv handed a CUDA pointer may raise or abort a rank: in a world
    # of its own, whose end is the answer too
    world = SpWorld(2, "probe")
    try:
        p2p = world.run(sp_probe_job, DEV, ["ppermute"], timeout_s=60.0,
                        must=False)
    finally:
        world.close()
    answer = "; ".join(
        f"rank {r}: " + (val["ppermute"] if status == "ok" else
                         f"ended, exit code {val}" if status == "exit"
                         else val.strip().splitlines()[-1])
        for r, (status, val) in enumerate(p2p))
    print(f"[sp] {card}: gloo handed CUDA tensors directly: {probe[0]}; "
          f"send/recv (the ring hop, staged by comm.ppermute): {answer}",
          flush=True)
    for r, res in enumerate(probe):
        for op, ans in res.items():
            if ans != "yes":
                fail(f"[sp] parallel/comm.py hands gloo's {op} CUDA "
                     f"tensors; the probe on rank {r} says {ans}")

    cfg_b = dataclasses.replace(cfg, num_layers=SP_LAYERS_B)
    ref = InferenceEngine(cfg_b, EngineConfig(), seed=SEED, device=DEV)
    want_b, rec_b = tapped_run(ref, longs[:1], osl=SP_OSL)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # (b) and (d) side by side on the card (their figures are per process:
    # streams, plans, hops, each rank's own peak memory)
    t0 = time.perf_counter()
    world = SpWorld(SP_MESH_B[0] * SP_MESH_B[1], "dp2tp2")
    world_d = SpWorld(SP_MESH_D[0] * SP_MESH_D[1], "tp2")
    try:
        world.start(sp_serve_job, DEV, cfg_b, SP_MESH_B, SP_THRESHOLD,
                    longs[:1], [])
        world_d.start(sp_serve_job, DEV, cfg, SP_MESH_D, SP_THRESHOLD,
                      longs[:1], [], SP_OSL_D)
        got_b = world.collect()
        got_d = world_d.collect()
    finally:
        world.close()
        world_d.close()
    partings = check_parity(want_b, rec_b, got_b[0]["long_streams"],
                            "its one-rank chunked run", tag="[sp]")
    print(f"[sp] {card}: mesh {SP_MESH_B}, four ranks on cuda:0 at "
          f"{SP_LAYERS_B} of 16 layers, one prompt of ISL {SP_ISL}: "
          f"{1 - len(partings)} of 1 streams identical to its one-rank "
          f"run; TTFT {got_b[0]['long_ttft'][0] * 1e3:.1f} ms (beside (d)); "
          f"{time.perf_counter() - t0:.1f} s with the worlds of (b) and (d)",
          flush=True)
    faces_b = sp_check_ranks(got_b, "[sp] (2, 2)", 1, SP_LAYERS_B,
                             SP_MESH_B[0])
    if min(got_b[0]["stats"]["all_reduce_calls"],
           got_b[1]["stats"]["all_reduce_calls"]) == 0:
        fail("[sp] (2, 2) made no tp all_reduce")

    partings = check_parity(want_long[:1], {
        k: v for k, v in rec_long.items() if k[0] == 0},
        got_d[0]["long_streams"], "the one-rank chunked engine", tag="[sp]")
    faces_d = sp_check_ranks(got_d, "[sp] (1, 2)", 1, cfg.num_layers, 1)
    if any(faces_d["paged_attention_ragged"]):
        fail(f"[sp] (1, 2) launched the ragged face "
             f"{faces_d['paged_attention_ragged']}: its one prompt is the "
             "sp chunk, and no phase-2 case holds a ragged shape of (d)")
    for r, g in enumerate(got_d):
        rise = max(p - b for b, p in g["peaks"])
        print(f"[sp] {card}: mesh {SP_MESH_D} rank {r}, one prompt of ISL "
              f"{SP_ISL} as one 8,192-token sp chunk (the whole prompt on "
              f"each tp rank, H/2 heads, the ring's f32 einsum): "
              f"{g['resident'] / 2**30:.3f} GiB resident, peak rise "
              f"+{rise / 2**30:.3f} GiB in the sp prefill; the one-rank "
              f"engine's one 8,192-token chunk +"
              f"{(one_peak - one_base) / 2**30:.3f} GiB", flush=True)
    print(f"[sp] {card}: mesh {SP_MESH_D} at full depth, OSL {SP_OSL_D}: "
          f"{1 - len(partings)} of 1 streams identical to the one-rank "
          f"chunked run (the rest at near-ties); TTFT "
          f"{got_d[0]['long_ttft'][0] * 1e3:.1f} ms (beside (b))",
          flush=True)
    return {"launches_sp": {k: sum(v) for k, v in faces_a.items()},
            "launches_sp_2x2": {k: sum(v) for k, v in faces_b.items()},
            "launches_sp_1x2": {k: sum(v) for k, v in faces_d.items()},
            "launches_sp_per_rank": faces_a,
            "held": {"sp_1x2_b8": faces_d["paged_attention_decode"]}}


# ---------------------------------------------------------------------------
# phase 21: the 3-D (dp, fsdp, tp) serving mesh, parameters stored over
# fsdp, and --mesh on run.py and the SLA profiler; ranks sharing one card

FSDP_MESH = (1, 2, 1)
FSDP_REQUESTS = 4          # of phase 3's prompts, concurrent, greedy
# each step of (a) gathers ~1.24 GB per rank through gloo on the host
# (2.3 s of host on an H100 machine), so (a) serves OSL 8, not 16, to keep
# the phase near 150 s
FSDP_OSL = 8
FSDP_THRESHOLD = 2048      # the sp threshold of (a)'s engine
FSDP_LONG_ISL = 4096       # (a)'s long prompt: one sp chunk over the fsdp pair
FSDP_LONG_OSL = 8
# (b): four ranks at full width, cut to 2 of Llama-3.2-1B's 16 layers (4
# took 48 s with both worlds one after the other)
FSDP_MESH_B = (1, 2, 2)
FSDP_LAYERS_B = 2
# (a): a rank stores half of every column and row leaf and of the tied
# embedding, the norms whole: just over half of one rank's bytes
FSDP_PARAMS_SHARE = (0.500, 0.505)
FSDP_BATCH = os.path.join("build", "fsdp_batch.jsonl")
FSDP_PROFILE = os.path.join("build", "profile_llama_3_2_1b_mesh_1x2.json")
FSDP_PROFILE_ARGS = ["--model", "1b", "--isls", "512", "--batches", "8",
                     "--contexts", "512"]
FSDP_RUN_LINE = re.compile(r"run exiting: tp rank=(\d) world=(\d) "
                           r"backend=(\w+) .* plans=(\S+) launches=(\S+)")
FSDP_CHILD_TIMEOUT_S = 240


def fsdp_prompts(vocab: int):
    """(a)'s traffic: FSDP_REQUESTS of phase 3's prompts, and one long
    prompt of FSDP_LONG_ISL tokens."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 41)
    return (main_prompts(vocab)[:FSDP_REQUESTS],
            torch.randint(1, vocab, (FSDP_LONG_ISL,), generator=gen).tolist())


def fsdp_serve_job(rank, plans, dev, cfg, mesh, prompts, osl, long_prompt,
                   long_osl, threshold, depth=None):
    """One rank of a phase-21 engine on ``mesh`` (``cfg`` at bf16, random
    weights from SEED on every rank, sp threshold ``threshold``): rank 0
    leads and serves ``prompts`` concurrently (greedy, ``osl`` tokens),
    then ``long_prompt`` (if any) alone (``long_osl`` tokens); the others
    replay its plans.
    Every rank returns its stored parameter bytes and wq shape, its
    collectives and peak device memory over the concurrent run, its kernel
    launches and sp prefills."""
    import asyncio

    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.worker import tree_bytes

    t0 = time.perf_counter()
    kw = {} if depth is None else {"pipeline_depth": depth}
    engine = InferenceEngine(cfg, EngineConfig(
        mesh_shape=mesh, sp_prefill_threshold=threshold, **kw),
        seed=SEED, device=dev)
    torch.cuda.synchronize()
    wq = engine.params["layers"]["wq"]
    out = {"build_s": time.perf_counter() - t0,
           "params_bytes": tree_bytes(engine.params),
           "wq": tuple(wq.shape), "graphed": engine._ap_window_fn.graphed}
    n = comm.world_size()

    async def one(ids, max_tokens):
        t_sub = time.perf_counter()
        toks, times = [], []
        async for o in engine.generate({"token_ids": ids,
                                        "max_tokens": max_tokens,
                                        "temperature": 0.0}, Context()):
            toks.extend(o["token_ids"])
            times.append(time.perf_counter())
        return toks, (t_sub, times)

    async def lead():
        await engine.start()
        try:
            await one(prompts[0][:32], 1)      # warm-up, not measured
            engine.clear_kv_blocks()
            for r in range(1, n):
                plans[r].put("reset")
            pa.reset_launches()
            comm.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            w0, p0 = engine.num_windows, engine.num_prefill_dispatches
            t_run = time.perf_counter()
            runs = await asyncio.gather(*(one(p, osl) for p in prompts))
            wall = time.perf_counter() - t_run
            torch.cuda.synchronize()
            for r in range(1, n):
                plans[r].put("mark")
            kept = {"base": base, "peak": torch.cuda.max_memory_allocated(),
                    "stats": dict(comm.STATS),
                    "windows": engine.num_windows - w0,
                    "prefills": engine.num_prefill_dispatches - p0}
            kept["steps"] = kept["windows"] + kept["prefills"]
            longs = None
            if long_prompt is not None:
                longs = await one(long_prompt, long_osl)
            return runs, wall, kept, longs
        finally:
            await engine.stop()

    if rank != 0:
        out.update(sp_follow(engine, plans, rank))
    else:
        emitted = sp_lead(engine, plans, n)
        try:
            runs, wall, kept, longs = asyncio.run(lead())
        finally:
            for r in range(1, n):
                plans[r].put(None)
        out.update(kept, streams=[t for t, _ in runs],
                   runs=[s for _, s in runs], wall=wall,
                   long_stream=None if longs is None else longs[0],
                   emitted=dict(emitted))
    out.update(replayed=dict(engine.num_replayed),
               sp_prefills=engine.num_sp_prefills,
               launches=dict(pa.LAUNCHES),
               gathered_total=comm.STATS["fsdp_gather_bytes"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_check_ranks(got, tag: str, faces_run=("decode", "ragged")) -> dict:
    """Phase 21's checks on one world: the followers replayed exactly the
    leader's plans, no rank captured decode graphs, both faces launched on
    every rank. Returns face -> launches per rank."""
    lead = got[0]
    for r, g in enumerate(got[1:], 1):
        if g["replayed"] != lead["emitted"]:
            fail(f"{tag} rank {r} replayed {g['replayed']}, the leader "
                 f"emitted {lead['emitted']}")
    faces = {}
    for face in ("decode", "ragged"):
        name = f"paged_attention_{face}"
        faces[name] = [g["launches"].get(name, 0) for g in got]
        if face in faces_run and min(faces[name]) == 0:
            fail(f"{tag} the {face} face did not launch on every rank: "
                 f"{faces[name]}")
    if any(g["graphed"] for g in got):
        fail(f"{tag} a rank captured decode graphs on a multi-rank mesh")
    return faces


def itl_p50(runs) -> float:
    gaps = sorted(b - a for _, times in runs
                  for a, b in zip(times, times[1:]))
    return gaps[len(gaps) // 2] if gaps else float("nan")


def fsdp_start(cmds, env=None):
    """``python -m`` each of ``cmds`` (the port's launchers, with their
    arguments) as child processes, side by side; :func:`fsdp_wait` takes
    their output."""
    return [subprocess.Popen([sys.executable, "-m", *args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=dict(os.environ, **(env or {})))
            for args in cmds]


def fsdp_wait(cmds, procs, timeout_s=FSDP_CHILD_TIMEOUT_S):
    """The (stdout, stderr) of :func:`fsdp_start`'s children, each also in
    ``build/dist/fsdp_<module>_<mesh>.log``; fails the script if one does
    not exit 0 in ``timeout_s``, and leaves none running."""
    os.makedirs(DIST_LOGS, exist_ok=True)
    outs = []
    try:
        for args, proc in zip(cmds, procs):
            try:
                out, err = proc.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            name = args[0].rsplit(".", 1)[-1] + "_" + "_".join(
                a.replace(",", "x") for a in args
                if "," in a and "=" not in a)
            with open(os.path.join(DIST_LOGS, f"fsdp_{name}.log"), "w") as f:
                f.write(out + "\n--- stderr ---\n" + err)
            if proc.returncode != 0:
                fail(f"[fsdp] python -m {' '.join(args)} exited "
                     f"{proc.returncode}: {err[-2000:]}")
            outs.append((out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def phase_fsdp(card: str) -> dict:
    """[fsdp] The 3-D serving mesh, ranks sharing cuda:0 over gloo, random
    weights from SEED. (a) mesh (1, 2, 1), Llama-3.2-1B at full width and
    depth, bf16: FSDP_REQUESTS of phase 3's prompts concurrently (OSL
    FSDP_OSL), then one FSDP_LONG_ISL-token prompt over the sp threshold
    (the sp column is the two fsdp ranks): parameter bytes per rank
    against one rank's, the streams under the parity rule against a
    one-rank engine, the bytes each rank sends through gloo per step
    (``fsdp_gather``), ITL p50 and the peak rise over the run. (b) mesh
    (1, 2, 2), four ranks cut to FSDP_LAYERS_B layers: streams against
    mesh (1, 2) at that depth, which the fsdp mesh must repeat exactly
    (both on the synchronous loop, side by side). (c) ``run.py --mesh
    1,2`` on (a)'s prompts against ``--mesh 1,1`` and the parity rule.
    (d) the SLA profiler with ``--mesh 1,2`` (ISL 512, batch 8 at ctx
    512): per-chip figures over two chips. (c) and (d) run beside (b)'s
    worlds. Returns (a) and (b)'s launches summed over ranks, and each
    one's per rank under its ``HELD_ROWS`` tag, for the kernels line."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine
    from dynamo_tpu_torch.engine import ModelConfig
    from dynamo_tpu_torch.worker import tree_bytes

    cfg = ModelConfig.llama3_1b()
    prompts, long_prompt = fsdp_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    ref = InferenceEngine(cfg, EngineConfig(), seed=SEED, device=DEV)
    one_bytes = tree_bytes(ref.params)
    want, rec = tapped_run(ref, prompts, osl=FSDP_OSL)
    want_long, rec_long = tapped_run(ref, [long_prompt], osl=FSDP_LONG_OSL)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    world = SpWorld(FSDP_MESH[0] * FSDP_MESH[1] * FSDP_MESH[2], "fsdp")
    try:
        got = world.run(fsdp_serve_job, DEV, cfg, FSDP_MESH, prompts,
                        FSDP_OSL, long_prompt, FSDP_LONG_OSL, FSDP_THRESHOLD)
    finally:
        world.close()
    lead = got[0]
    faces_a = fsdp_check_ranks(got, "[fsdp] (a)")
    shares = [g["params_bytes"] / one_bytes for g in got]
    if not all(FSDP_PARAMS_SHARE[0] <= s <= FSDP_PARAMS_SHARE[1]
               for s in shares):
        fail(f"[fsdp] (a) a rank stores {shares} of one rank's parameter "
             f"bytes, outside {FSDP_PARAMS_SHARE}")
    if any(g["wq"][1] != cfg.hidden_size // 2 for g in got):
        fail(f"[fsdp] (a) wq after the run is {[g['wq'] for g in got]}: "
             "a rank kept a gathered layer")
    if [g["sp_prefills"] for g in got] != [1, 1]:
        fail(f"[fsdp] (a) sp prefills per rank "
             f"{[g['sp_prefills'] for g in got]}, want [1, 1]")
    partings = check_parity(want, rec, lead["streams"],
                            "the one-rank engine", tag="[fsdp]")
    long_part = check_parity(want_long, rec_long, [lead["long_stream"]],
                             "the one-rank chunked engine", tag="[fsdp]")
    per_step = [g["stats"]["fsdp_gather_bytes"] / lead["steps"]
                for g in got]
    us_step = [g["stats"]["fsdp_gather_us"] / lead["steps"] for g in got]
    rise = [(g["peak"] - g["base"]) / 2**30 for g in got]
    print(f"[fsdp] {card}: one-rank reference ({FSDP_REQUESTS} prompts of "
          f"ISL {ISL} OSL {FSDP_OSL}, one of ISL {FSDP_LONG_ISL} OSL "
          f"{FSDP_LONG_OSL}) in {ref_s:.1f} s; mesh {FSDP_MESH}, two ranks "
          f"on cuda:0 over gloo, engines built in "
          f"{[round(g['build_s'], 1) for g in got]} s", flush=True)
    print(f"[fsdp] {card}: (a) parameters stored per rank "
          f"{[g['params_bytes'] for g in got]} B = "
          f"{[round(s, 4) for s in shares]} of one rank's {one_bytes} B "
          f"(limits {FSDP_PARAMS_SHARE}); wq stored {got[0]['wq']} after "
          f"the run", flush=True)
    print(f"[fsdp] {card}: (a) {FSDP_REQUESTS - len(partings)} of "
          f"{FSDP_REQUESTS} streams identical to the one-rank engine's (the "
          f"rest at near-ties); the {FSDP_LONG_ISL}-token prompt as one sp "
          f"chunk over the fsdp pair: {1 - len(long_part)} of 1 identical "
          f"to its one-rank chunked stream; sp prefills per rank "
          f"{[g['sp_prefills'] for g in got]}", flush=True)
    print(f"[fsdp] {card}: (a) {lead['steps']} steps ({lead['windows']} "
          f"decode windows of one step, {lead['prefills']} prefill chunks): "
          f"fsdp_gather per step and rank "
          f"{[round(b / 1e9, 4) for b in per_step]} GB sent, {[round(u / 1e3, 1) for u in us_step]} ms of host "
          f"blocked in it; ITL p50 {itl_p50(lead['runs']) * 1e3:.1f} ms; "
          f"wall {lead['wall']:.2f} s; peak rise over the run "
          f"{[round(x, 3) for x in rise]} GiB over "
          f"{[round(g['base'] / 2**30, 3) for g in got]} GiB allocated "
          f"before it; launches per rank {faces_a}; "
          f"{time.perf_counter() - t0:.1f} s with the world", flush=True)

    # (c)'s two launchers and (d)'s profiler start first and run beside
    # (b)'s two worlds ((b) and (c) report no time but their whole; (d)'s
    # figures are a shared card's)
    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    with open(FSDP_BATCH, "w") as f:
        for p in prompts:
            f.write(json.dumps({"token_ids": p, "max_tokens": FSDP_OSL})
                    + "\n")
    meshes = ("1,1", "1,2")
    cmds = [["dynamo_tpu_torch.run", f"in=batch:{FSDP_BATCH}", "out=engine",
             "--model", "1b", "--mesh", mesh] for mesh in meshes] + [
        ["dynamo_tpu_torch.planner.profiler", *FSDP_PROFILE_ARGS, "--mesh",
         "1,2", "--out", FSDP_PROFILE]]
    procs = fsdp_start(cmds, env=TP_ENV)
    try:
        cfg_b = dataclasses.replace(cfg, num_layers=FSDP_LAYERS_B)
        # both worlds side by side on the card (streams and counts are per
        # rank), each on the synchronous loop
        worlds = {mesh: SpWorld(int(np.prod(mesh)), "x".join(map(str, mesh)))
                  for mesh in ((1, 2), FSDP_MESH_B)}
        try:
            for mesh, world in worlds.items():
                world.start(fsdp_serve_job, DEV, cfg_b, mesh, prompts,
                            FSDP_OSL, None, 0, FSDP_THRESHOLD, 1)
            got_bs = {mesh: world.collect()
                      for mesh, world in worlds.items()}
        finally:
            for world in worlds.values():
                world.close()
    finally:
        outs = fsdp_wait(cmds, procs)
    streams_b = {mesh: g[0]["streams"] for mesh, g in got_bs.items()}
    got_b = got_bs[FSDP_MESH_B]
    faces_b = fsdp_check_ranks(got_b, "[fsdp] (b)")
    same = sum(a == b for a, b in zip(streams_b[(1, 2)],
                                      streams_b[FSDP_MESH_B]))
    steps_b = got_b[0]["steps"]
    print(f"[fsdp] {card}: (b) mesh {FSDP_MESH_B}, four ranks at "
          f"{FSDP_LAYERS_B} of 16 layers: {same} of {FSDP_REQUESTS} streams "
          f"identical to mesh (1, 2)'s at that depth; fsdp_gather per step "
          f"and rank "
          f"{[round(g['stats']['fsdp_gather_bytes'] / steps_b / 1e6, 2) for g in got_b]}"
          f" MB, wq stored {[g['wq'] for g in got_b]}; launches per rank "
          f"{faces_b}", flush=True)
    if same != FSDP_REQUESTS:
        fail(f"[fsdp] (b) mesh {FSDP_MESH_B} parts from mesh (1, 2): the "
             "gathered weights are (1, 2)'s slices, so its arithmetic must "
             "be the same")
    runs = {}
    for mesh, (stdout, stderr) in zip(meshes, outs[:len(meshes)]):
        rows = [json.loads(x) for x in stdout.splitlines() if x.strip()]
        runs[mesh] = ([r["token_ids"] for r in rows],
                      FSDP_RUN_LINE.findall(stderr))
    ranks = runs["1,2"][1]
    if sorted(int(r[0]) for r in ranks) != [0, 1] or ranks[0][3] != ranks[1][3]:
        fail(f"[fsdp] (c) run.py --mesh 1,2 rank lines {ranks}: want ranks "
             "0 and 1 with equal plans")
    part_c = check_parity(want, rec, runs["1,2"][0], "the one-rank engine",
                          tag="[fsdp]")
    check_parity(want, rec, runs["1,1"][0], "the one-rank engine",
                 tag="[fsdp]")
    same_c = sum(a == b for a, b in zip(runs["1,1"][0], runs["1,2"][0]))
    print(f"[fsdp] {card}: (c) python -m dynamo_tpu_torch.run "
          f"in=batch out=engine --model 1b --mesh 1,2 (rank 1 started by "
          f"rank 0, both on cuda:0 over gloo): {same_c} of "
          f"{FSDP_REQUESTS} streams identical to --mesh 1,1's, "
          f"{FSDP_REQUESTS - len(part_c)} to the one-rank engine's (the rest "
          f"at near-ties of tp-2 bf16 sums); ranks (rank, backend, plans) "
          f"{[(r[0], r[2], r[3]) for r in ranks]}, launches "
          f"{[r[4].split(',')[:2] for r in ranks]}; "
          f"{time.perf_counter() - t0:.1f} s for (b), (c) and (d), side by "
          f"side", flush=True)

    with open(FSDP_PROFILE) as f:
        prof = json.load(f)
    if prof["meta"]["mesh"] != [1, 2] or set(prof) != set(PROFILE_KEYS) | {
            "meta"}:
        fail(f"[fsdp] (d) the profile's keys {sorted(prof)} / meta "
             f"{prof['meta']}")
    isl, ttft = prof["prefill_isl"][0], prof["prefill_ttft_s"][0]
    if abs(prof["prefill_thpt_per_chip"][0] - isl / ttft / 2) > 1e-6 * (
            isl / ttft):
        fail(f"[fsdp] (d) prefill tok/s per chip "
             f"{prof['prefill_thpt_per_chip'][0]} is not ISL / TTFT / 2")
    print(f"[fsdp] {card}: (d) python -m dynamo_tpu_torch.planner.profiler "
          f"{' '.join(FSDP_PROFILE_ARGS)} --mesh 1,2: TTFT "
          f"{ttft * 1e3:.1f} ms, prefill {prof['prefill_thpt_per_chip'][0]:.1f}"
          f" tok/s per chip (of 2), ITL p50 "
          f"{prof['decode_itl_s'][0] * 1e3:.1f} ms, decode "
          f"{prof['decode_thpt_per_chip'][0]:.2f} tok/s per chip, KV usage "
          f"{prof['decode_kv_usage'][0]}; meta {prof['meta']} (beside (b) "
          f"and (c) on the card)", flush=True)
    return {"launches": {k: sum(faces_a[k]) + sum(faces_b[k])
                         for k in faces_a},
            "held": {"fsdp_b8": faces_a["paged_attention_decode"],
                     "fsdp_chunks": faces_a["paged_attention_ragged"],
                     "fsdp_tp2_b8": faces_b["paged_attention_decode"],
                     "fsdp_tp2_chunks": faces_b["paged_attention_ragged"]}}


# ---------------------------------------------------------------------------
# phase 19: pipeline-parallel serving, two stages on one card

PP = 2
PP_MODEL = "llama-3.2-1b-pp2"
PP_REQUESTS = 8            # concurrent greedy requests, ISL 512
PP_OSL = 32
PP_LINE = re.compile(
    r"worker exiting: pp rank=(\d+) world=(\d+) backend=(\w+) stage "
    r"layers=(\d+)\.\.(\d+) plans=(\S*) ppermute_calls=(\d+) bytes=(\d+) "
    r"staged=(\d+) us=(\d+) broadcast_calls=(\d+) params_bytes=(\d+) "
    r"cache_bytes=(\d+) launches=(\S*)")
# a stage holds half the layers and the replicated 128,256-row embedding:
# (0.525 + 8 x 0.1216) / 2.47 GB ~ 0.61 of one rank's parameters; its
# cache is exactly half of one rank's
PP_PARAMS_SHARE = (0.55, 0.67)


def pp_rank_lines(text: str) -> dict:
    """rank -> the fields of a pipeline worker's exit line."""
    out = {}
    for m in PP_LINE.finditer(text):
        (rank, world, backend, lo, hi, plans, calls, nbytes, staged, us,
         bcast, params, cache, launches) = m.groups()
        out[int(rank)] = dict(
            world=int(world), backend=backend, layers=(int(lo), int(hi)),
            plans={k: int(v) for k, v in (
                kv.split(":") for kv in plans.split(",") if kv)},
            calls=int(calls), bytes=int(nbytes), staged=int(staged),
            us=int(us), broadcasts=int(bcast), params=int(params),
            cache=int(cache), launches={k: int(v) for k, v in (
                kv.split(":") for kv in launches.split(",") if kv)})
    return out


def pp_stages(num_layers: int) -> list:
    """Each stage's (first, last) layer."""
    per = num_layers // PP
    return [(s * per, (s + 1) * per - 1) for s in range(PP)]


def pp_check_ranks(text: str, card: str, one_rank: tuple,
                   num_layers: int) -> dict:
    """The phase's checks on the ``--pp 2`` worker's exit lines: both
    stages logged over gloo, holding layers 0..7 and 8..15 of 16; the follower
    replayed exactly the plans the leader emitted (``p`` and ``d`` only)
    and made as many hops; one hop per microbatch, so one per prefill chunk
    (M = 1) and 4 per decode step of 8 rows (M = 4), stage 0 sending what
    stage 1 receives (each copy staged through the host once, as gloo's
    send/recv takes no CUDA tensor); both faces launched on each stage; each
    stage's parameter bytes within ``PP_PARAMS_SHARE`` of the one-rank
    engine's and its cache bytes half of it. Prints the hops, bytes and
    staged bytes per step. Returns face -> [launches per rank]."""
    ranks = pp_rank_lines(text)
    if sorted(ranks) != list(range(PP)):
        fail(f"[pp] exit lines of ranks {sorted(ranks)}, want "
             f"{list(range(PP))}")
    lead, fol = ranks[0], ranks[1]
    if {r["backend"] for r in ranks.values()} != {"gloo"}:
        fail(f"[pp] ranks ran over {[r['backend'] for r in ranks.values()]}")
    if [ranks[r]["layers"] for r in range(PP)] != pp_stages(num_layers):
        fail(f"[pp] stage layers {[ranks[r]['layers'] for r in range(PP)]}")
    if fol["plans"] != lead["plans"] or set(lead["plans"]) != {"p", "d"}:
        fail(f"[pp] the follower replayed {fol['plans']}, the leader "
             f"emitted {lead['plans']}")
    n_p, n_d = lead["plans"]["p"], lead["plans"]["d"]
    for r in ranks.values():
        if r["calls"] != n_p + 4 * n_d:
            fail(f"[pp] {r['calls']} hops on a rank, want {n_p} + "
                 f"4 x {n_d}")
    if not lead["bytes"] > 0 == fol["bytes"] or \
            lead["staged"] != lead["bytes"] or fol["staged"] != lead["bytes"]:
        fail(f"[pp] bytes sent {lead['bytes']} / {fol['bytes']} and staged "
             f"{lead['staged']} / {fol['staged']} by rank 0 / 1: stage 0 "
             f"sends, stage 1 receives, each copy staged once")
    faces = {}
    for face in ("decode", "ragged"):
        name = f"paged_attention_{face}"
        per_rank = [ranks[r]["launches"].get(name, 0) for r in range(PP)]
        if min(per_rank) == 0:
            fail(f"[pp] {name} launches per rank {per_rank}: a face did "
                 f"not launch on a stage")
        faces[name] = per_rank
    one_params, one_cache = one_rank
    shares = [(ranks[r]["params"] / one_params, ranks[r]["cache"] / one_cache)
              for r in range(PP)]
    for p_share, c_share in shares:
        if not PP_PARAMS_SHARE[0] <= p_share <= PP_PARAMS_SHARE[1]:
            fail(f"[pp] a stage holds {p_share:.3f} of one rank's "
                 f"parameter bytes, outside {PP_PARAMS_SHARE}")
        if c_share != 0.5:
            fail(f"[pp] a stage holds {c_share:.4f} of one rank's cache")
    steps = n_p + n_d
    print(f"[pp] {card}: plans per kind {lead['plans']} (leader emitted = "
          f"follower replayed); ppermute per rank {lead['calls']} hops; "
          f"stage 0 sent {lead['bytes'] / 1e6:.3f} MB, each stage staged "
          f"{lead['staged'] / 1e6:.3f} MB through the host: "
          f"{lead['calls'] / steps:.2f} hops and "
          f"{lead['bytes'] / steps / 1e6:.4f} MB sent per step; host "
          f"time blocked in hops per step rank 0 "
          f"{lead['us'] / 1e3 / steps:.2f} ms, rank 1 "
          f"{fol['us'] / 1e3 / steps:.2f} ms; sampled-token broadcasts "
          f"{lead['broadcasts']} (one per step, and the leader's attention "
          f"choice); launches per rank {faces}", flush=True)
    print(f"[pp] {card}: per-rank device bytes vs the one-rank engine: "
          + "; ".join(
              f"rank {r} parameters {ranks[r]['params'] / 1e9:.3f} GB "
              f"({shares[r][0]:.3f}), cache {ranks[r]['cache'] / 1e9:.3f} GB"
              f" ({shares[r][1]:.3f})" for r in range(PP))
          + f"; one rank {one_params / 1e9:.3f} GB / "
          f"{one_cache / 1e9:.3f} GB", flush=True)
    return faces


def phase_pp(card: str, served: dict, ref, one_rank: tuple) -> dict:
    """[pp] Llama-3.2-1B at full width and depth (16 layers, 8 per stage),
    bf16, from phase 9's checkpoint, served by a ``--pp 2`` worker (rank 0
    leads and starts rank 1 itself on the same card; both over gloo, as
    NCCL takes one device per rank; each reads only its stage's layers)
    behind the store and the frontend. 8 concurrent greedy requests at ISL
    512, OSL 32 through the frontend over HTTP give TTFT, ITL and tok/s —
    a correctness run of two stages on one card over host-staged gloo, not
    a pipeline speed; the same prompts through the worker's ``generate``
    endpoint give streams held to the parity rule against phase 3's
    one-rank engine (``ref``: phase 9's eager rerun, cut to its first
    PP_OSL tokens). The stages' exit lines give their launches of both
    faces, plans, hops and bytes (``pp_check_ranks``); ``one_rank`` is the
    one-rank engine's (parameter, cache) bytes. Returns face -> launches
    per rank."""
    import asyncio
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.engine.weights import model_config_from_hf

    num_layers = model_config_from_hf(LOAD_DIR).num_layers
    want, rec, prompts = ref
    prompts = prompts[:PP_REQUESTS]
    want = [w[:PP_OSL] for w in want[:PP_REQUESTS]]
    env = dict(tp_env(), **TP_ENV)
    addr = f"127.0.0.1:{_free_port()}"
    children = []

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        try:
            t0 = time.perf_counter()
            store = Child("pp_store", "dynamo_tpu_torch.runtime.store",
                          ["--host", "127.0.0.1",
                           "--port", addr.rsplit(":", 1)[1]], env)
            children.append(store)
            await store.wait_for(r"store listening", 60)
            worker = Child("pp_worker", "dynamo_tpu_torch.worker", [
                "--pp", str(PP), "--store-addr", addr,
                "--weights", os.path.abspath(LOAD_DIR),
                "--model-name", PP_MODEL,
                "--tokenizer", os.path.abspath(served["tokenizer"])], env)
            children.append(worker)
            front = Child("pp_frontend", "dynamo_tpu_torch.frontend",
                          ["--host", "127.0.0.1", "--port", "0",
                           "--store-addr", addr], env)
            children.append(front)
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))
            await worker.wait_for(r"registered model", 300)
            loads = re.findall(r"loaded (\d+) tensors \(([\d.]+) GB\) .*"
                               r"layers (\d+)\.\.(\d+)\) .* in ([\d.]+) s",
                               worker.text())
            print(f"[pp] {card}: store, a --pp 2 worker (rank 1 started by "
                  f"rank 0, both on cuda:0 over gloo) and the frontend up in "
                  f"{time.perf_counter() - t0:.1f} s; stage loads "
                  + "; ".join(f"layers {lo}..{hi}: {n} tensors, {gb} GB in "
                              f"{sec} s" for n, gb, lo, hi, sec in loads),
                  flush=True)
            if sorted((int(lo), int(hi)) for _, _, lo, hi, _ in loads) != \
                    pp_stages(num_layers):
                fail(f"[pp] stage loads {loads}, want layers "
                     f"{pp_stages(num_layers)}")

            def job(ids, n=PP_OSL):
                return dict(method="POST", path="/v1/completions", body={
                    "model": PP_MODEL, "prompt": list(ids),
                    "max_tokens": n, "temperature": 0,
                    "ignore_eos": True, "stream": True})
            while True:
                (status, _, _, _, body), = await loop.run_in_executor(
                    procs, http_client, port,
                    [dict(method="GET", path="/v1/models")])
                if status == 200 and any(m["id"] == PP_MODEL
                                         for m in body["data"]):
                    break
                if time.perf_counter() - t0 > 300:
                    fail(f"[pp] /v1/models never listed {PP_MODEL}")
                await asyncio.sleep(0.2)
            # the stages' first traffic (each process's first GEMMs,
            # kernel calls and hops), timed apart from the run; a prompt
            # that shares no block with the run's
            t_warm = time.perf_counter()
            (status, _, _, done, _), = await loop.run_in_executor(
                procs, http_client, port, [job(prompts[0][::-1], 2)])
            if status != 200 or not done:
                fail(f"[pp] the warm-up request answered {status}")
            print(f"[pp] {card}: warm-up request (ISL {ISL}, 2 tokens, the "
                  f"stages' first traffic): "
                  f"{(time.perf_counter() - t_warm) * 1e3:.1f} ms",
                  flush=True)
            t_start = time.perf_counter()
            results = await loop.run_in_executor(
                procs, http_client, port, [job(p) for p in prompts])
            wall = time.perf_counter() - t_start
            runs = []
            for status, t_sent, frames, done, body in results:
                content = [t for t, f in frames if f["choices"][0]["text"]]
                n = (frames[-1][1]["usage"]["completion_tokens"]
                     if frames else 0)
                if (status != 200 or not done or n != PP_OSL
                        or len(content) < 2):
                    fail(f"[pp] HTTP stream: {status}, [DONE] {done}, {n} of "
                         f"{PP_OSL} tokens: {body or frames[-2:]}")
                runs.append((t_sent, content[0], content[-1], n))
            print(f"[pp] {card}: {PP_REQUESTS} streams ISL {ISL} OSL "
                  f"{PP_OSL} through store + the 2-stage worker + frontend: "
                  f"{stats_line(traffic_stats(runs, wall))} — a correctness "
                  f"run of two stages on one card over host-staged gloo, "
                  f"not a pipeline speed", flush=True)
            got = await tp_generate(addr, "backend", prompts, PP_OSL,
                                    concurrent=True)
            if [len(g) for g in got] != [PP_OSL] * len(prompts):
                fail("[pp] short streams from the generate endpoint")
            partings = check_parity(want, rec, got,
                                    "phase 3's one-rank bf16 engine",
                                    tag="[pp]")
            print(f"[pp] {card}: streams of the 2-stage worker vs phase 3's "
                  f"one-rank engine on the same weights: "
                  f"{len(prompts) - len(partings)} of {len(prompts)} "
                  f"identical, {len(partings)} part at near-ties",
                  flush=True)
            worker.proc.send_signal(signal.SIGTERM)
            rc = await loop.run_in_executor(None, worker.proc.wait, 90)
            if rc != 0:
                fail(f"[pp] the worker exited {rc}:\n{worker.tail()}")
            return pp_check_ranks(worker.text(), card, one_rank, num_layers)
        finally:
            procs.shutdown(wait=True)

    try:
        return asyncio.run(run())
    finally:
        for c in reversed(children):
            c.kill()


# ---------------------------------------------------------------------------
# phase 20: the single-rank paths on a multi-rank worker, on one card

MESH = "1,2"
MESH_PREFILL_MODEL = "llama-3.2-1b-mesh-disagg"
MESH_MODEL = "llama-3.2-1b-mesh"
MESH_PP_MODEL = "llama-3.2-1b-pp2-embed"
MESH_REQUESTS = 8          # concurrent greedy requests, ISL 512
MESH_OSL = 32
MESH_EMBED_TOKENS = 512    # phase 15's 16 inputs, each cut to this
MESH_EMBED_REPS = 3
MESH_KVBM_PROMPTS = 4      # ISL 512 each, served twice around a G1 clear
MESH_KVBM_BLOCKS = 4096
MESH_MM_TEXT = (300, 200)  # text before each generate-endpoint image
MESH_QUESTIONS = ("Describe this picture in a few words: ",
                  "What do you see here? ")


def mesh_mm_bodies(cfg, encoder, images):
    """Two image prompts (phase 16's layout, other text per image: 300
    and 200 text tokens, the image's 256 placeholders, 20 more), as the
    wire bodies a worker's ``generate`` endpoint takes."""
    import asyncio

    import torch

    from dynamo_tpu_torch.multimodal.processor import (
        MM_MARKER, MultimodalProcessor,
    )

    gen = torch.Generator().manual_seed(SEED + 20)
    proc = MultimodalProcessor(IdsTokenizer(), (MM_IMAGE // MM_PATCH) ** 2,
                               local_encoder=encoder)
    bodies = []
    for n_text, img in zip(MESH_MM_TEXT, images):
        text = torch.randint(1, cfg.vocab_size, (n_text,), generator=gen)
        tail = torch.randint(1, cfg.vocab_size, (MM_TAIL,), generator=gen)
        rendered = (" ".join(map(str, text.tolist())) + MM_MARKER
                    + " ".join(map(str, tail.tolist())))
        ids, mm = asyncio.run(proc.process(rendered, [img]))
        bodies.append({"token_ids": ids, "mm": mm, "ignore_eos": True})
    return bodies


def mesh_reference(engine, mm: dict) -> dict:
    """What phase 20 holds the multi-rank workers against, from phase 3's
    one-rank bf16 engine (the weights of phase 9's checkpoint): the
    vectors of the embedding inputs, and the greedy streams of two image
    prompts with their top logits (``tapped_run``, for the parity
    rule)."""
    import asyncio

    cfg = engine.model_config
    inputs = [x[:MESH_EMBED_TOKENS] for x in embed_inputs(cfg.vocab_size)]
    vecs = asyncio.run(engine.embed(inputs))
    bodies = mesh_mm_bodies(cfg, mm["encoder"], mm["images"])
    engine.clear_kv_blocks()
    want, rec = tapped_run(engine, bodies, MESH_OSL)
    engine.clear_kv_blocks()
    return {"embed_inputs": inputs, "embed": vecs, "mm_bodies": bodies,
            "mm_want": want, "mm_rec": rec}


def mesh_check_ranks(text: str, tag: str) -> dict:
    """A ``--mesh 1,2`` worker's exit lines: both ranks over gloo, the
    follower replayed exactly the plans the leader emitted, and both made
    the same collectives. Returns rank -> its line's fields."""
    ranks = tp_rank_lines(text)
    if sorted(ranks) != list(range(TP)):
        fail(f"{tag} exit lines of ranks {sorted(ranks)}, want "
             f"{list(range(TP))}")
    lead, fol = ranks[0], ranks[1]
    if {r["backend"] for r in ranks.values()} != {"gloo"}:
        fail(f"{tag} ranks ran over {[r['backend'] for r in ranks.values()]}")
    if fol["plans"] != lead["plans"]:
        fail(f"{tag} the follower replayed {fol['plans']}, the leader "
             f"emitted {lead['plans']}")
    for key in ("all_reduce_calls", "kv_gather_calls", "kv_deliver_calls",
                "mm_deliver_calls", "mm_deliver_bytes"):
        if fol["stats"].get(key, 0) != lead["stats"].get(key, 0):
            fail(f"{tag} {key}: leader {lead['stats'].get(key, 0)}, "
                 f"follower {fol['stats'].get(key, 0)}")
    return ranks


def mesh_collective(ranks, op: str) -> str:
    """Calls, MB and host ms of a collective on each rank."""
    return "; ".join(
        f"rank {r} {ranks[r]['stats'].get(op + '_calls', 0)} calls, "
        f"{ranks[r]['stats'].get(op + '_bytes', 0) / 1e6:.3f} MB, "
        f"{ranks[r]['stats'].get(op + '_us', 0) / 1e3:.1f} ms"
        for r in sorted(ranks))


async def mesh_embed_http(port: int, model: str, inputs):
    """``/v1/embeddings`` of token arrays: (vectors, ms per call), the
    call repeated MESH_EMBED_REPS times after one untimed call."""
    times, got = [], None
    for i in range(MESH_EMBED_REPS + 1):
        t0 = time.perf_counter()
        status, _, _, _, body = await _http_request(
            port, "POST", "/v1/embeddings", {"model": model,
                                             "input": inputs})
        if status != 200 or len(body.get("data", ())) != len(inputs):
            fail(f"[mesh] /v1/embeddings on {model}: HTTP {status}, "
                 f"{body!r}"[:400])
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        got = [d["embedding"] for d in body["data"]]
    return got, sorted(times)[len(times) // 2]


def phase_mesh(card: str, served: dict, ref, mref: dict) -> dict:
    """[mesh] the single-rank paths on multi-rank workers: Llama-3.2-1B at
    full width and depth, bf16, from phase 9's checkpoint, two ranks on
    cuda:0 over gloo (as phases 17 and 19), behind one store and one
    frontend.

    (a) A ``--mesh 1,2 --disagg-mode prefill`` worker hands each prompt's
    KV over the host relay to a one-rank ``--disagg-mode decode`` worker
    (which registers the model): one warm-up request, then
    MESH_REQUESTS concurrent greedy requests at ISL 512, OSL MESH_OSL over
    HTTP (TTFT, ITL, tok/s), then the same prompts through the decode
    worker's ``generate`` endpoint, held to the parity rule against phase
    3's one-rank engine (``ref``). The prefill worker's exit lines give
    the handoffs (``kx`` plans), the payload per handoff and each rank's
    head gather (``kv_gather``).

    (b)-(d) on a ``--mesh 1,2 --mm-encoder --kvbm-host-blocks`` worker:
    (b) 16 ``/v1/embeddings`` inputs (phase 15's, cut to
    MESH_EMBED_TOKENS) against phase 3's engine's vectors
    (EMBED_BATCH_COS), ms per call, ``emb`` plans; (c) two image prompts
    through its ``generate`` endpoint, held to the parity rule against
    the one-rank engine (``mref``), and two image chats over HTTP with
    ``.npy`` data URLs through its colocated encoder (TTFT); ``mrp`` plans
    on each rank, the image embeddings delivered per plan; (d) the KVBM
    host tier: MESH_KVBM_PROMPTS prompts, G1 cleared, the same again: the
    second pass onboards from the host tier (``ki`` plans) and hits the
    prefix; TTFT of both passes.

    (e) a ``--pp 2`` worker answers the same embeddings (the stages encode
    together), against the same vectors.

    Every rank's exit line: the follower replayed the leader's plans and
    made the same collectives. Returns face -> launches per rank of the
    two mesh workers together (each > 0)."""
    import asyncio
    import multiprocessing
    import signal
    from concurrent.futures import ProcessPoolExecutor

    from dynamo_tpu_torch.engine.engine import _pow2_bucket
    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    want, rec, prompts = ref
    prompts = prompts[:MESH_REQUESTS]
    want = [w[:MESH_OSL] for w in want[:MESH_REQUESTS]]
    env = dict(tp_env(), **TP_ENV)
    addr = f"127.0.0.1:{_free_port()}"
    tok = os.path.abspath(served["tokenizer"])
    weights = ["--weights", os.path.abspath(LOAD_DIR), "--tokenizer", tok,
               "--store-addr", addr]
    children = []

    def start(name, args, module="dynamo_tpu_torch.worker"):
        child = Child(name, module, args, env)
        children.append(child)
        return child

    def completion(model, ids, n):
        return dict(method="POST", path="/v1/completions", body={
            "model": model, "prompt": list(ids), "max_tokens": n,
            "temperature": 0, "ignore_eos": True, "stream": True})

    def streamed(results, n, what):
        runs = []
        for status, t_sent, frames, done, body in results:
            content = [t for t, f in frames if f.get("choices")
                       and (f["choices"][0].get("text")
                            or f["choices"][0].get("delta", {}).get(
                                "content"))]
            got = (frames[-1][1]["usage"]["completion_tokens"]
                   if frames else 0)
            if status != 200 or not done or got != n or len(content) < 2:
                fail(f"[mesh] {what}: HTTP {status}, [DONE] {done}, {got} "
                     f"of {n} tokens: {body or frames[-2:]}")
            runs.append((t_sent, content[0], content[-1], got))
        return runs

    def warmed(result, what):
        status, _, _, done, body = result
        if status != 200 or not done:
            fail(f"[mesh] {what} answered {status}: {body}")

    async def stop(child, tag):
        child.proc.send_signal(signal.SIGTERM)
        rc = await asyncio.get_running_loop().run_in_executor(
            None, child.proc.wait, 90)
        if rc != 0:
            fail(f"{tag} {child.name} exited {rc}:\n{child.tail()}")

    async def listed(loop, procs, port, model, t0):
        while True:
            (status, _, _, _, body), = await loop.run_in_executor(
                procs, http_client, port,
                [dict(method="GET", path="/v1/models")])
            if status == 200 and any(m["id"] == model for m in body["data"]):
                return
            if time.perf_counter() - t0 > 300:
                fail(f"[mesh] /v1/models never listed {model}")
            await asyncio.sleep(0.2)

    async def generate(component, bodies, n):
        rt = await DistributedRuntime.from_settings(RuntimeConfig(
            store_addr=addr))
        try:
            client = await (rt.namespace().component(component)
                            .endpoint("generate").client())
            await client.wait_for_instances(1, 60)

            async def one(body):
                out = []
                async for o in client.round_robin(
                        dict(body, max_tokens=n, temperature=0.0,
                             ignore_eos=True), Context()):
                    out.extend(o["token_ids"])
                return out
            return await asyncio.gather(*(one(b) for b in bodies))
        finally:
            await rt.shutdown()

    async def run():
        loop = asyncio.get_running_loop()
        procs = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        faces = {}
        try:
            t0 = time.perf_counter()
            store = start("mesh_store", ["--host", "127.0.0.1", "--port",
                                         addr.rsplit(":", 1)[1]],
                          "dynamo_tpu_torch.runtime.store")
            await store.wait_for(r"store listening", 60)
            front = start("mesh_frontend", ["--host", "127.0.0.1", "--port",
                                            "0", "--store-addr", addr],
                          "dynamo_tpu_torch.frontend")
            port = int((await front.wait_for(
                r"frontend ready on [\d.]+:(\d+)", 60)).group(1))

            # (a) disaggregated: a 2-rank prefill worker, a one-rank decode
            pre = start("mesh_prefill", [
                "--mesh", MESH, *weights, "--model-name",
                MESH_PREFILL_MODEL, "--disagg-mode", "prefill"])
            dec = start("mesh_decode", [
                *weights, "--model-name", MESH_PREFILL_MODEL,
                "--disagg-mode", "decode"])
            await pre.wait_for(r"worker ready: model=\S+ mode=prefill", 300)
            await dec.wait_for(r"registered model", 300)
            await listed(loop, procs, port, MESH_PREFILL_MODEL, t0)
            print(f"[mesh] {card}: (a) store, frontend, a --mesh {MESH} "
                  f"--disagg-mode prefill worker (rank 1 started by rank 0, "
                  f"both on cuda:0 over gloo) and a one-rank --disagg-mode "
                  f"decode worker up in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t_warm = time.perf_counter()
            (warm,) = await loop.run_in_executor(
                procs, http_client, port,
                [completion(MESH_PREFILL_MODEL, prompts[0][::-1], 2)])
            warmed(warm, "the disagg warm-up")
            warm_ms = (time.perf_counter() - t_warm) * 1e3
            t_start = time.perf_counter()
            results = await loop.run_in_executor(
                procs, http_client, port,
                [completion(MESH_PREFILL_MODEL, p, MESH_OSL)
                 for p in prompts])
            wall = time.perf_counter() - t_start
            stats_a = traffic_stats(
                streamed(results, MESH_OSL, "disagg stream"), wall)
            got = await generate("backend", [{"token_ids": p}
                                             for p in prompts], MESH_OSL)
            partings = check_parity(want, rec, got,
                                    "phase 3's one-rank bf16 engine",
                                    tag="[mesh]")
            await stop(pre, "[mesh]")
            await stop(dec, "[mesh]")
            ranks_a = mesh_check_ranks(pre.text(), "[mesh] (a)")
            lead = ranks_a[0]
            handoffs = lead["plans"].get("kx", 0)
            # both passes' prefills handed off (the warm-up too, unless the
            # decode worker had not yet seen the prefill worker)
            if handoffs not in (2 * MESH_REQUESTS, 2 * MESH_REQUESTS + 1) \
                    or lead["plans"].get("ki", 0):
                fail(f"[mesh] (a) the prefill worker's plans "
                     f"{lead['plans']}: want a kx per prefill of both "
                     f"passes ({2 * MESH_REQUESTS}, and the warm-up's) and "
                     f"no ki")
            # each rank sends its half of the heads per K and per V
            payload = (sum(r["stats"]["kv_gather_bytes"]
                           for r in ranks_a.values()) / handoffs)
            print(f"[mesh] {card}: (a) {MESH_REQUESTS} streams ISL {ISL} "
                  f"OSL {MESH_OSL} through the frontend, the one-rank decode "
                  f"worker and the 2-rank prefill worker over the host "
                  f"relay: {stats_line(stats_a)} (warm-up request "
                  f"{warm_ms:.1f} ms) — a correctness run of two ranks on "
                  f"one card over host-staged gloo; {handoffs} handoffs "
                  f"(kx plans: the warm-up and both passes), "
                  f"{payload / 1e6:.3f} MB of K and V per handoff (every "
                  f"head, padded to a power of two of blocks); head gather "
                  f"{mesh_collective(ranks_a, 'kv_gather')}; streams vs "
                  f"phase 3's one-rank engine: "
                  f"{len(prompts) - len(partings)} of {len(prompts)} "
                  f"identical, {len(partings)} part at near-ties; plans "
                  f"{lead['plans']}", flush=True)

            # (b)-(d) an aggregated 2-rank worker; (e) a 2-stage one
            t1 = time.perf_counter()
            agg = start("mesh_agg", [
                "--mesh", MESH, *weights, "--model-name", MESH_MODEL,
                "--mm-encoder", "--mm-image-size", str(MM_IMAGE),
                "--mm-patch-size", str(MM_PATCH),
                "--kvbm-host-blocks", str(MESH_KVBM_BLOCKS)])
            # a component of its own: two multi-rank workers on one
            # component would share its step_stream endpoint, and a
            # follower could join the other worker's leader
            ppw = start("mesh_pp", ["--pp", str(PP), *weights,
                                    "--model-name", MESH_PP_MODEL,
                                    "--component", "backend_pp"])
            await agg.wait_for(r"registered model", 300)
            await ppw.wait_for(r"registered model", 300)
            await listed(loop, procs, port, MESH_MODEL, t1)
            await listed(loop, procs, port, MESH_PP_MODEL, t1)
            print(f"[mesh] {card}: (b)-(e) a --mesh {MESH} --mm-encoder "
                  f"--kvbm-host-blocks {MESH_KVBM_BLOCKS} worker and a --pp "
                  f"{PP} worker up in {time.perf_counter() - t1:.1f} s",
                  flush=True)
            (warm,) = await loop.run_in_executor(
                procs, http_client, port,
                [completion(MESH_MODEL, prompts[0][:32], 2)])
            warmed(warm, "the mesh warm-up")

            # (b) embeddings through the 2-rank worker
            vecs, emb_ms = await mesh_embed_http(port, MESH_MODEL,
                                                 mref["embed_inputs"])
            d_b = one_minus_cos(vecs, mref["embed"])

            # (c) image prompts: parity through generate, chats over HTTP
            got_mm = await generate("backend", mref["mm_bodies"], MESH_OSL)
            part_mm = check_parity(mref["mm_want"], mref["mm_rec"], got_mm,
                                   "phase 3's one-rank bf16 engine",
                                   tag="[mesh]")
            chats = []
            for q, img in zip(MESH_QUESTIONS, mm_images()):
                chats.append(dict(method="POST", path="/v1/chat/completions",
                                  body={"model": MESH_MODEL,
                                        "max_tokens": MESH_OSL,
                                        "temperature": 0,
                                        "ignore_eos": True, "stream": True,
                                        "messages": [{"role": "user",
                                                      "content": [
                    {"type": "text", "text": q},
                    {"type": "image_url",
                     "image_url": {"url": npy_data_url(img)}}]}]}))
            mm_ttft = []
            for job in chats:
                (res,) = await loop.run_in_executor(procs, http_client, port,
                                                    [job])
                (t_sent, first, _, _), = streamed([res], MESH_OSL,
                                                  "image chat")
                mm_ttft.append((first - t_sent) * 1e3)

            # (d) the KVBM host tier: two passes around a G1 clear
            rt = await DistributedRuntime.from_settings(RuntimeConfig(
                store_addr=addr))
            backend = rt.namespace().component("backend")
            clear = await backend.endpoint("clear_kv_blocks").client()
            await clear.wait_for_instances(1, 60)
            snaps = []
            sub = await rt.store.subscribe(
                backend.event_subject("load_metrics"))

            async def collect():
                async for ev in sub:
                    if ev.get("event") == "msg":
                        snap = codec.unpackb(ev["value"])
                        if "kvbm" in snap:
                            snaps.append((time.perf_counter(), snap))
            collector = asyncio.create_task(collect())

            async def drained():
                last = None
                for _ in range(300):
                    t = time.perf_counter()
                    while not snaps or snaps[-1][0] <= t:
                        if time.perf_counter() - t > 30:
                            fail("[mesh] the mesh worker published no "
                                 "load metrics")
                        await asyncio.sleep(0.05)
                    n = snaps[-1][1]["kvbm"]["offloaded_total"]
                    if n == last and n > 0:
                        return snaps[-1][1]["kvbm"]
                    last = n
                fail("[mesh] the offload backlog never drained")
            kv_prompts = [p[::-1][:ISL] for p in
                          prompts[:MESH_KVBM_PROMPTS]]
            passes = []
            for i in range(2):
                if i:
                    async for _ in clear.direct(clear.instance_ids()[0], {},
                                                Context()):
                        pass
                before = await drained()
                t_start = time.perf_counter()
                results = await loop.run_in_executor(
                    procs, http_client, port,
                    [completion(MESH_MODEL, p, MESH_OSL)
                     for p in kv_prompts])
                wall = time.perf_counter() - t_start
                st = traffic_stats(streamed(results, MESH_OSL, "kvbm pass"),
                                   wall)
                passes.append((st, before, await drained()))
            collector.cancel()
            await rt.shutdown()
            (s1, _, a1), (s2, b2, a2) = passes
            onboarded = a2["onboarded_total"] - b2["onboarded_total"]
            hits = (a2["prefix_hit_tokens_total"]
                    - b2["prefix_hit_tokens_total"])
            if onboarded <= 0 or hits <= 0:
                fail(f"[mesh] (d) second pass onboarded {onboarded} blocks, "
                     f"hit {hits} prefix tokens")

            # (e) embeddings through the 2-stage worker
            vecs_pp, emb_pp_ms = await mesh_embed_http(
                port, MESH_PP_MODEL, mref["embed_inputs"])
            d_e = one_minus_cos(vecs_pp, mref["embed"])

            await stop(agg, "[mesh]")
            await stop(ppw, "[mesh]")
            ranks = mesh_check_ranks(agg.text(), "[mesh] (b)-(d)")
            lead = ranks[0]
            pp_ranks = pp_rank_lines(ppw.text())
            n_groups = len({_pow2_bucket(len(x))
                            for x in mref["embed_inputs"]})
            emb_plans = [lead["plans"].get("emb", 0)] + [
                pp_ranks.get(r, {}).get("plans", {}).get("emb", 0)
                for r in range(PP)]
            if lead["plans"].get("emb", 0) != (MESH_EMBED_REPS + 1) * \
                    n_groups or min(emb_plans) == 0:
                fail(f"[mesh] (b)/(e) emb plans {emb_plans}, want "
                     f"{(MESH_EMBED_REPS + 1) * n_groups} on the mesh "
                     f"worker ({n_groups} (B, T) groups per call)")
            if (pp_ranks.get(1, {}).get("plans")
                    != pp_ranks.get(0, {}).get("plans")):
                fail(f"[mesh] (e) the pp follower replayed "
                     f"{pp_ranks.get(1)}, the leader emitted "
                     f"{pp_ranks.get(0)}")
            mrp = lead["plans"].get("mrp", 0)
            m = re.search(r"worker exiting: engine counts mm_prefills=(\d+)",
                          agg.text())
            mm_prefills = int(m.group(1)) if m else -1
            if mrp == 0 or mrp != mm_prefills:
                fail(f"[mesh] (c) {mrp} mrp plans, {mm_prefills} mm prefill "
                     f"chunks on the leader")
            mm_mb = lead["stats"].get("mm_deliver_bytes", 0) / mrp / 1e6
            if lead["plans"].get("ki", 0) == 0 or \
                    lead["plans"].get("kx", 0) == 0:
                fail(f"[mesh] (d) plans {lead['plans']}: the KVBM tier "
                     f"neither offloaded (kx) nor onboarded (ki)")
            print(f"[mesh] {card}: (b) /v1/embeddings of "
                  f"{len(vecs)} inputs (phase 15's, <= {MESH_EMBED_TOKENS} "
                  f"tokens) through the 2-rank worker: max 1 - cos vs phase "
                  f"3's one-rank engine {max(d_b):.2e} (limit "
                  f"{EMBED_BATCH_COS}), {emb_ms:.1f} ms per call (median of "
                  f"{MESH_EMBED_REPS}, HTTP included); emb plans "
                  f"{lead['plans'].get('emb', 0)} on each rank", flush=True)
            print(f"[mesh] {card}: (c) image prompts on the 2-rank worker: "
                  f"{len(got_mm) - len(part_mm)} of {len(got_mm)} generate "
                  f"streams identical to the one-rank engine, "
                  f"{len(part_mm)} part at near-ties; image chats over "
                  f"HTTP through the colocated encoder: TTFT "
                  f"{', '.join(f'{t:.1f}' for t in mm_ttft)} ms; {mrp} mrp "
                  f"plans on each rank (= the leader's mm prefill chunks), "
                  f"{mm_mb:.3f} MB of embeddings delivered per plan; "
                  f"mm_deliver {mesh_collective(ranks, 'mm_deliver')}",
                  flush=True)
            print(f"[mesh] {card}: (d) KVBM host tier on the 2-rank worker: "
                  f"{MESH_KVBM_PROMPTS} prompts ISL {ISL} OSL {MESH_OSL}; "
                  f"pass 1 {stats_line(s1)}; G1 cleared; pass 2 "
                  f"{stats_line(s2)}; pass 2 onboarded {onboarded} blocks, "
                  f"{hits} prefix-hit tokens; offloaded "
                  f"{a2['offloaded_total']} blocks in all; kx (offload "
                  f"extracts) {lead['plans'].get('kx', 0)}, ki (onboard "
                  f"injects) {lead['plans'].get('ki', 0)}; head gather "
                  f"{mesh_collective(ranks, 'kv_gather')}; delivery "
                  f"{mesh_collective(ranks, 'kv_deliver')}", flush=True)
            print(f"[mesh] {card}: (e) /v1/embeddings of the same inputs "
                  f"through the --pp {PP} worker: max 1 - cos vs the "
                  f"one-rank engine {max(d_e):.2e} (limit "
                  f"{EMBED_BATCH_COS}), {emb_pp_ms:.1f} ms per call; emb "
                  f"plans per stage {emb_plans[1:]}", flush=True)
            if max(d_b) > EMBED_BATCH_COS or max(d_e) > EMBED_BATCH_COS:
                fail("[mesh] the multi-rank workers' vectors differ from "
                     "the one-rank engine's")
            for face in ("decode", "ragged"):
                name = f"paged_attention_{face}"
                per_rank = [ranks_a[r]["launches"].get(name, 0)
                            + ranks[r]["launches"].get(name, 0)
                            for r in range(TP)]
                if min(per_rank) == 0:
                    fail(f"[mesh] {name} launches per rank {per_rank}")
                faces[name] = per_rank
            print(f"[mesh] {card}: launches per rank of both mesh workers "
                  f"{faces}", flush=True)
            return faces
        finally:
            procs.shutdown(wait=True)

    try:
        return asyncio.run(run())
    finally:
        for c in reversed(children):
            c.kill()


KERNELS = {
    # name: (face, kv dtype, main-path case, replaced TPU function)
    "paged_attention_decode": (
        "decode", None, DECODE_CASE, "dynamo_tpu/ops/paged_attention.py:311"),
    "paged_attention_ragged": (
        "ragged", None, PREFILL_CASE,
        "dynamo_tpu/ops/paged_attention.py:175"),
}
for _kv in ("int8", "fp8"):
    # the quantized-KV branch (:73-76, :109-115, :265-281): the in-kernel
    # dequant sits at :109
    KERNELS[f"paged_attention_decode_{_kv}"] = (
        "decode", _kv, f"{DECODE_CASE} {_kv}",
        "dynamo_tpu/ops/paged_attention.py:109")
    KERNELS[f"paged_attention_ragged_{_kv}"] = (
        "ragged", _kv, f"{PREFILL_CASE} {_kv}",
        "dynamo_tpu/ops/paged_attention.py:109")


def launch_configs(results, case: str):
    """Phase 2's non-default launch parameters on ``case``: each with its
    device ms and its error against the plain version."""
    return [{"launch": v["launch"], "ms": v["ms"],
             "max_abs_err": v["max_abs_err"]}
            for k, v in results.items()
            if v["launch"] and k.startswith(f"{case} [")]


def kernels_line(results, launches, dist_launches, spec_launches,
                 moe_launches, slice_launches, tp_launches, pp_launches,
                 held_launches, tuned_rows=()) -> str:
    """The ``kernels`` JSON line: one row per kernel build (with
    ``launch_configs``, the non-default launch parameters phase 2 held on
    that build's main-path case), plus the
    ragged face at the spec engine's verify shape (its launches: the verify
    windows of phase 3's spec run) and both faces at Mixtral's head dim 128
    (their launches: the [moe] phase's served run). ``slice_launches``
    maps a key (``launches_profile``, ``launches_replay``,
    ``launches_embed``, ``launches_mm``) to the counts of the path it
    names, added to every kernel build's row. ``tuned_rows``
    (phase 12) are the autotune's winning launches, each with its
    ``launch`` parameters (the bf16 decode and prefill winners that differ
    from the defaults; their launches are those of the run served on
    them). Phase 21 adds ``launches_fsdp`` (both faces on its (1, 2, 1)
    ranks, at the one-rank shapes, and its (1, 2, 2) ranks, at the tp-2
    shard shapes) and phase 18 ``launches_sp_1x2`` (its (1, 2) case) to
    ``slice_launches``. Phase 17 adds both faces at one rank's shard shapes of tp 2,
    head dim 64 (Llama-3.2-1B) and 128 (Mixtral-8x7B): ``tp_launches[hd]``
    maps each face to its launches per rank in the served runs. Phase 19
    adds the decode face at a pp stage's microbatch shape
    (``PP_DECODE_CASE``; its prefill chunk is ``PREFILL_CASE``'s):
    ``pp_launches`` maps each face to its launches per stage. Phases 20,
    21 and 18 (d) run the kernels at shapes of their own:
    ``held_launches`` maps a tag of ``HELD_ROWS`` to that part's launches
    per rank, carried by the row ``<kernel>@<tag>``, whose ``held_cases``
    names the phase-2 cases of those shapes, behind ``max_abs_err`` (the
    largest of them) and the times (the first's). Their sums are
    ``launches_mesh``, ``launches_fsdp`` and ``launches_sp_1x2`` in
    ``slice_launches``."""
    rows = []
    for name, (face, kv, case, replaces) in KERNELS.items():
        r = results[case]
        rows.append({
            "name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_dist": dist_launches[name],
            **{key: counts.get(name, 0)
               for key, counts in slice_launches.items()},
            "max_abs_err": max(v["max_abs_err"] for v in results.values()
                               if v["face"] == face and v["kv_dtype"] == kv
                               and v["dtype"] == "bfloat16"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "launch_configs": launch_configs(results, case),
        })
    r = results[SPEC_CASE]
    rows.append({
        "name": "paged_attention_ragged@spec_verify", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNELS["paged_attention_ragged"][3],
        "launches": spec_launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "launch_configs": launch_configs(results, SPEC_CASE),
    })
    for name, case in (("paged_attention_decode", MOE_DECODE_CASE),
                       ("paged_attention_ragged", MOE_PREFILL_CASE)):
        r = results[case]
        rows.append({
            "name": f"{name}@mixtral_hd128", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": KERNELS[name][3], "launches": moe_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    for (face, hd), case in TP_CASES.items():
        name = f"paged_attention_{face}"
        per_rank = tp_launches[hd][name]
        r = results[case]
        rows.append({
            "name": f"{name}@tp2_shard_hd{hd}", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": KERNELS[name][3], "launches": sum(per_rank),
            "launches_per_rank": per_rank,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    per_rank = pp_launches["paged_attention_decode"]
    r = results[PP_DECODE_CASE]
    rows.append({
        "name": "paged_attention_decode@pp2_stage", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNELS["paged_attention_decode"][3],
        "launches": sum(per_rank), "launches_per_rank": per_rank,
        "max_abs_err": max(r["max_abs_err"],
                           results[f"{PP_DECODE_CASE}, 1 dead row"]
                           ["max_abs_err"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    for tag, per_rank in held_launches.items():
        name, cases = HELD_ROWS[tag]
        r = results[cases[0]]
        rows.append({
            "name": f"{name}@{tag}", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": KERNELS[name][3], "launches": sum(per_rank),
            "launches_per_rank": per_rank,
            "max_abs_err": max(results[c]["max_abs_err"] for c in cases),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "held_cases": list(cases),
        })
    rows.extend(tuned_rows)
    return json.dumps({"kernels": rows})


SCRIPT_LIMIT_S = 1150   # the whole script, under the run's 1200 s


@contextmanager
def watchdog(seconds: float):
    """Arm ``faulthandler`` to dump every thread's stack and exit
    non-zero after ``seconds``; on leaving, re-arm the whole script's
    limit (SCRIPT_LIMIT_S from the start)."""
    import faulthandler

    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.dump_traceback_later(
            max(1.0, SCRIPT_LIMIT_S - (time.perf_counter() - T_START)),
            exit=True)


class PhaseTimer:
    """Prints each phase's time (``[time]`` lines) as the phases end."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - self.t:.1f} s", flush=True)
        self.t = now


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import dynamo_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"dynamo_tpu_torch not importable (run from a checkout): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    import faulthandler
    faulthandler.dump_traceback_later(SCRIPT_LIMIT_S, exit=True)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    timer = PhaseTimer()
    phase_build()
    timer("1 build")
    cases = kernel_cases()
    check_default_launch(cases)
    results = phase_kernels(cases)
    del cases
    timer("2 kernels")
    launches, engine, ref_logits, direct = phase_engine(card)
    phase_graph(engine, card)
    timer("3 engine bf16 + graph check")
    spec_engine, spec = phase_spec(card, engine)
    phase_spec_graph(spec_engine, card)
    del spec_engine
    torch.cuda.empty_cache()
    timer("3 spec engine + graph check")
    tuned_rows = phase_autotune(card, engine, direct)
    timer("12 autotune")
    phase_ladder(card)
    timer("13 ladder")
    phase_debug_profile(card, engine)
    timer("14 profile")
    embed_launches = phase_embed(card, engine, direct)
    timer("15 embeddings")
    mm = phase_mm(card, engine, direct)
    timer("16 multimodal in one process")
    phase_profile(engine, card)
    timer("4 profile bf16")
    served = phase_http(engine, card, direct)
    timer("5 http")
    phase_epd_procs(card, served, engine, mm)
    timer("15-16 embeddings and EPD across processes")
    phase_kvmove_local(card, engine, direct)
    timer("7 kv movement in one process")
    tp_ref = phase_load(card, engine, "bf16")
    timer("9 loader bf16")
    mesh_ref = mesh_reference(engine, mm)
    timer("20 one-rank reference")
    from dynamo_tpu_torch.worker import tree_bytes
    one_rank = (tree_bytes(engine.params), tree_bytes(engine.cache))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = {64: phase_tp(card, served, tp_ref)}
    timer("17 tensor parallel, Llama-3.2-1B")
    pp_launches = phase_pp(card, served, tp_ref, one_rank)
    timer("19 pipeline parallel")
    mesh_launches = phase_mesh(card, served, tp_ref, mesh_ref)
    del tp_ref, mesh_ref
    timer("20 single-rank paths on multi-rank workers")
    sp = phase_sp(card)
    timer("18 sequence parallel")
    fsdp = phase_fsdp(card)
    timer("21 fsdp mesh, run.py and profiler --mesh")
    dist_launches = phase_dist(card, served, direct)
    timer("6 distributed")
    phase_kvmove_procs(card, served)
    timer("7 kv movement across processes")
    for dtype in ("int8", "fp8"):
        torch.cuda.empty_cache()
        run_launches, engine, _, _ = phase_engine(card, dtype, ref_logits)
        launches.update(run_launches)
        phase_graph(engine, card)
        timer(f"3 engine {dtype} + graph check")
        if dtype == "int8":
            phase_profile(engine, card)
        phase_quant_costs(engine, card)
        timer(f"4 profile {dtype}")
        if dtype == "int8":
            phase_load(card, engine, "int8")
            timer("9 loader int8")
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    profile, profile_launches = phase_sla_profile(card)
    timer("10 SLA profile")
    rep, run, replay_launches = phase_replay(card)
    timer("11 replay")
    phase_planner(card, profile, rep, run)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    timer("11 planner")
    moe_launches = phase_moe(card)
    timer("8 moe")
    tp_launches[128] = phase_tp_moe(card, served)
    timer("17 expert parallel, Mixtral-8x7B")
    faulthandler.cancel_dump_traceback_later()
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(kernels_line(results, launches, dist_launches, spec["launches"],
                       moe_launches, {"launches_profile": profile_launches,
                                      "launches_replay": replay_launches,
                                      "launches_embed": embed_launches,
                                      "launches_mm": mm["launches"],
                                      "launches_sp": sp["launches_sp"],
                                      "launches_sp_2x2":
                                      sp["launches_sp_2x2"],
                                      "launches_sp_1x2":
                                      sp["launches_sp_1x2"],
                                      "launches_fsdp": fsdp["launches"],
                                      "launches_pp": {
                                          k: sum(v) for k, v in
                                          pp_launches.items()},
                                      "launches_mesh": {
                                          k: sum(v) for k, v in
                                          mesh_launches.items()}},
                       tp_launches, pp_launches, {
                           "mesh_tp2_b8":
                           mesh_launches["paged_attention_decode"],
                           "mesh_tp2_chunks":
                           mesh_launches["paged_attention_ragged"],
                           **fsdp["held"], **sp["held"]}, tuned_rows))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
