#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``repro_torch`` end to end on the card and fails (non-zero exit)
on any fault; it imports nothing of the JAX package.  Phases:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for convolutions and matmuls, and
   so is the reduced-precision reduction of bf16 matmuls.
2. build: compiles ``csrc/fedavg.cu``, the four flash sources
   (``csrc/flash_attention_sm90.cu``, ``csrc/flash_attention_tf32x3.cu``,
   ``csrc/flash_attention_mma.cu``, ``csrc/flash_attention.cu``) and
   ``csrc/quantize.cu`` with ``nvcc``,
   one process each, at once, into ``build/repro_torch/`` and times it;
   measures the card's device-to-device copy bandwidth, the practical
   ceiling of a fold.
3. kernels: each fedavg CUDA kernel against its plain PyTorch version
   at the ResNet-18 update size (N = 11,199,486), one JSON line per
   case: errors, kernel / plain / library times (CUDA events around a
   run of back-to-back calls, median of the runs) and the bound at the
   nominal and the measured bandwidth.  The eager fold must be bit-equal
   to its plain version, also on views that start off 16 bytes
   (``acc[1:]``, ``u[3:]``), and is timed beside its first design
   (``previous_ms``).
4. engine: the port's ``Aggregator`` on ``TorchEngine(cuda)`` folds six
   ResNet-18-sized updates, eager and lazy, against ``fedavg_oracle``.
5. round: ``repro_torch.api.Session`` on full-width ResNet-18 (random
   weights from a seed) and synthetic FEMNIST: two eager rounds, then
   one lazy round; the launch counts are zeroed just before and read
   just after, and both accumulate kernels must have run.  Then the
   same path at reduced width on the card and on the CPU (the kernels'
   plain versions) must give the same params within ``PARITY_ATOL``,
   and a run with one update planted twice must not.
6. flash: the flash-attention kernels against their plain version
   (``attention_ref``): ``flash_variant`` sends 16-bit inputs that TMA
   takes to the wgmma kernel, every other 16-bit input to the mma.sync
   one and every fp32 input to the 3xTF32 one, and each call must move
   that kernel's count.  At the serve path's shape (B = 4, S = 2000, 24
   query heads over 8 KV heads, D = 128) in bf16, fp16 and fp32, and
   again off 16 bytes in fp16 (mma.sync) and fp32 (the 3xTF32 kernel's
   4-byte copies); at gemma3's (K 4, G 2, D 256, window 1024),
   h2o-danube-3-4b's (K 8, G 4, D 120, window 4096) and hymba-1.5b's (K
   5, G 5, D 64, window 1024 and global) in bf16, and h2o-danube-3-4b's
   again on pointers off 16 bytes (mma.sync); at the four shapes of the
   JAX package's kernel test in all three, and at an odd head dim (1,
   300, 2, 3, 15) in all three; and without a causal mask at
   seamless-m4t-large-v2's encoder shape (B 4, S 512, 16 heads, D 64)
   in bf16 (wgmma), fp32 (3xTF32) and bf16 off 16 bytes (mma.sync),
   where the plain version run causal must land outside the tolerance
   that the kernel meets.  One ``flash_case`` JSON line
   each, with the library call (``scaled_dot_product_attention``) as the
   yardstick, the bound at the bf16 peak or, in fp32, at three TF32
   products (``bound_simt_ms``: fp32 FMA on the CUDA cores) and the
   first design, the CUDA-core kernel named on the same inputs, timed
   in turns (``previous_ms``) and held against the plain version too.
   At the path shape in fp32, aligned and not, the plain version once
   more with TF32 matmuls (one TF32 pass) must land outside the
   tolerance that the kernel meets; on the mma.sync kernel's views off
   16 bytes, the plain version on the views moved back one element
   must too.
7. serve: full-width llama3.2-3b (random bf16 weights from seed 0)
   through ``repro_torch.models``: prefill of 4 prompts of 2000 tokens
   with ``attn_impl="pallas"``, then 32 greedy decode steps on the ring
   KV cache (``examples/serve_decode.py``'s loop).  The flash counts are
   zeroed just before the prefill and must read 28 (one per layer) for
   the wgmma kernel and 0 for the CUDA-core one just after; the logits
   must be finite; q, k and v of the first and last
   layers are captured and the kernel is held against its plain version
   on them.  Two more prefills give the warm time; one prefill and one
   decode step under ``torch.profiler`` split the device time into the
   attention kernel, matmuls and the rest, and give the device's idle
   share; a decode step is set beside the time to read every weight
   once at the measured copy rate.  Then one more warm prefill with the
   mma.sync kernel named in the wgmma kernel's place (``flash_calls``,
   ``variant="mma"``): 28 launches of it and none of the others, timed,
   its logits within ``MMA_PREFILL_TOL`` of the wgmma prefill's.
7b. fp32 prefill: the same llama3.2-3b in fp32 (12.8 GB of random
   weights from seed 0, once phase 7's bf16 model is freed), the same
   4 prompts of 2000 tokens with ``attn_impl="pallas"``.  The flash
   counts are zeroed just before a cold prefill and must read 28 for
   the 3xTF32 kernel and 0 for the other two just after; the logits
   must be finite.  A warm prefill, its device split under
   ``torch.profiler`` (the kernel's share), then the same prefill with
   the CUDA-core kernel named in the kernel's place (``flash_calls``,
   ``variant="simt"``: 28 launches of it), timed, and its logits against
   the kernel's.
8. lm checks (reduced llama3.2-3b, fp32): on the card, prefill of S
   tokens against prefill of S - 1 plus ``decode_step`` (the JAX
   package's 2e-3); then the serve loop on the card (the kernel) against
   the CPU (the plain version): greedy tokens equal and logits within
   ``LM_PARITY_ATOL``, and the same loop with the KV heads rolled by one
   before the kernel in the first layer must land above it.  In fp32
   the loop runs the 3xTF32 flash kernel (head dim 16): the counts are
   zeroed just before the card's loop and read just after.
9. summary, printed last: a ``{"kernels": [...]}`` line (phase 3's
   rows at the main path's shapes, the burst timed again at the lazy
   round's K, the wgmma flash row on the serve path's captured
   first-layer inputs, the 3xTF32 flash row at the serve shape in fp32
   with its launches by path (phases 7, 7b, 8, 11), the mma.sync flash
   row on the 16-bit inputs TMA cannot take (phase 6's h2o-danube-3-4b
   shape off 16 bytes, the CUDA-core kernel's time beside it as
   ``previous_ms``, and seamless's encoder off 16 bytes) with its
   launches in phase 7's named prefill, and phase 10's
   quantize rows at the fused round's largest leaf), the device line,
   and the last line
   ``{"ok": true, "device": {...}}``.
10. quant: the int8 quantize and dequantize CUDA kernels against their
   plain versions, bit for bit (q, scales, dequantized fp32 and bf16)
   and within half a scale of the input, at the JAX package's
   kernel-test sizes, an all-zero input, bf16 input, row widths 64,
   200 and 16 (an SSM's ``A_log``, phase 23) and leaves of 3200 and 8192
   (``D`` and ``dt_bias``); then at the fused round's largest leaf, the (128256, 3072)
   fp32 embedding delta, timed against the plain versions and, for
   dequantize, one ``torch.mul``.
11. fused round: full-width llama3.2-3b (bf16, random params from seed
   0) through ``FusedFLTrainer``: one hierarchical int8 round on a
   2-pod mesh (each pod 4 sequences of 512 tokens in 2 microbatches,
   ``attn_impl="chunked"``, ``remat=True``) with every launch count
   zeroed just before and read just after (quantize and dequantize once
   per leaf and pod), one ``compress="none"`` round from the same params
   (the int8 params within 5 % relative of these), a warm int8 round,
   and one under ``torch.profiler`` for the device split.
12. round parity (reduced llama3.2-3b, fp32): one int8 round on the
   card against the CPU within the two-part limit (at most 0.1 % of
   elements over 1e-5, none over one quantization step of its block),
   and the card with one pod's delta counted twice above it
   (``phase_round_parity``; phase 19 runs it on reduced
   deepseek-v2-lite-16b).
13. shmproc: phase 5's workload through ``Session.open(...,
   runtime="shmproc")``: forked numpy workers fold the mids on the host
   (as in the JAX package), the card trains the clients and folds the
   top.  ``df -h /dev/shm``; a cold and two warm rounds, then a busy
   worker SIGKILLed mid-round (``WorkerCrashed``, a fresh fork after the
   parent's CUDA work, the full goal folded); every round's params
   against phase 5's inproc session from the same seed within
   ``PARITY_ATOL``; worker stats (forks, cold / warm dispatch latency),
   each round's trace breakdown; no segment left in ``/dev/shm``.
   Phases 13 and 14 train with cuDNN's deterministic algorithms, so
   what separates two sessions is the runtime's arithmetic alone.
14. multi-node: two ``netd`` daemons on the card (``spawn_local_daemon``,
   each its own CUDA context; the kernels were built in phase 2), then
   ``Session.open(..., nodes=[a, b])`` node-top with locality placement:
   three rounds and one with ``wire_compress=6``, params against an
   inproc session over nodes of the same names within ``PARITY_ATOL``,
   the controller's bytes on the wire each round (raw and compressed);
   a driven round of six model-size updates across both daemons
   (daemon-to-daemon ship, root on nodeA) bit-equal to the blocked
   numpy engine; each daemon's ``stats_reply``: its device (must be
   ``cuda``) and its own fold kernel launches (eager folds above 0 on
   every daemon that took updates).
15. serve: ``Session.serve()`` behind ``admission=AdmissionPolicy(
   max_queue=2)``; a client process (the port alone) pushes three
   full-size updates with ``push_update``: two queued, one ``busy``
   with ``retry_after_s``; the round that follows folds the two on the
   card (eager launches above 0).
16. service: one ``AggregationService`` on the card with two jobs of
   phase 5's full-width ResNet-18 (seed-0 params, fair-share weights
   2:1) over phase 5's fleet.  Each job is sent its clients' real
   deltas (phase 5's eight clients, one local epoch from the seed-0
   params) through admission, one of them pushed over the wire as bf16
   (raw words named ``bfloat16``; the port decodes them without
   ``ml_dtypes``); three rolling rounds a job (``MinCohortIdleGap``),
   fold launch counts zeroed just before and read just after.  Each
   job's params against its recorded cohorts replayed in order through
   a sequential ``RoundDriver`` on the card (bit-exact, or within
   ``PARITY_ATOL``: the line says which), and the same replay with one
   update folded twice above the limit; ``pipeline_overlap()``, each
   job's round walls, the publishes' device-to-host copies (one a
   publish) and their ms, ``health()`` through ``summary_line``.  Then
   the engines' fold speedup over the naive engine (``engine_speedup``:
   ``DataPlaneCosts.agg_engine_speedup["torch"]``).
17. checkpoint: job a's trainer checkpoints its params through
   ``AsyncCheckpointer`` at its last round's end (in ``build/``,
   removed after); restored and held against the params bit for bit;
   the submit's ms (what the round pays: the snapshot into pinned host
   memory), the write's ms on its thread, the restore's ms and the
   file's size.
18. MoE / MLA serve, run after phase 8 (phase 7b's model is freed):
   (a) full-width deepseek-v2-lite-16b (27 layers, MLA, 64 experts
   top-6 + 2 shared, bf16, random params from seed 0 drawn on the card)
   with ``moe_impl="ep"`` on ``make_host_mesh()``: the tree's params
   against ``param_count()`` plus the MLA norm scales it leaves out,
   the init's seconds and peak (at most 1.2x the params' bytes);
   phase 7's prompts (4 x 2000 tokens) and 32 greedy decode steps with
   the flash counts zeroed just before and 0 for all three kernels just
   after (MLA runs the plain blockwise attention, as in the JAX
   package), finite logits; cold and warm prefill, decode p50 / p99,
   the MLA cache's bytes and the peak; two warm prefills bit-equal;
   the loop again with each MoE block watched (``moe_watch``): ep's
   capacity and dropped assignments per layer at prefill and over the
   decode steps, the router's smallest top-k margin, and logits
   bit-equal to the unwatched loop; a warm prefill and a decode step
   under ``torch.profiler`` split into attention, the experts'
   products, MoE routing / gather / scatter, other matrix products and
   the rest (``moe_split``), with
   the idle share, and the step beside the time to read every weight
   once at phase 2's copy rate.  (b) the same prompts with
   ``moe_impl="dense"`` against ep at capacity factor E / k (no drops):
   router indices equal in every MoE layer and the last logits within
   ``MOE_DENSE_EP_TOL``.  (c) reduced deepseek-v2-lite-16b in fp32
   (150-token prompts): decode against the full forward on the card
   under dense dispatch (2e-3), the ep serve loop on the card against
   the CPU within ``LM_PARITY_ATOL`` with the same greedy tokens, and
   the loop with every token's expert indices rolled by one in the
   first MoE layer above it, on the card and on the CPU alike.
19. MoE / MLA fused round, run after phase 12 (phase 18's model is
   freed): deepseek-v2-lite-16b at full width and 6 layers (the dense
   first layer and 5 MoE layers; bf16, random params from seed 0)
   through phase 11's round with the JAX package's ``build_train_step``
   options (ep, ``chunked_sp``, remat): the tree's params against
   ``param_count()`` plus the MLA norm scales; one int8 round with
   every launch count zeroed just before and read just after
   (quantize and dequantize once per leaf and pod) and each MoE
   layer's forward watched (``round_watch``: ep capacity, dropped
   assignments, the router's smallest top-k margin; a recompute under
   remat routes as its forward did and is not counted); one
   ``compress="none"`` round from the same params (the int8 params
   within 5 % relative of these); a warm int8 round, bit-equal to the
   first; one under ``torch.profiler`` split into attention, the
   experts' products, MoE dispatch, quantize, other matrix products and
   the rest, a backward kernel under its forward op's range
   (``moe_split``), with the idle share; the quantize kernels against
   their plain versions at the largest leaf (the experts' gate delta,
   (5, 64, 2048, 1408) fp32 padded to whole blocks: 3,932,160 rows);
   then reduced deepseek-v2-lite-16b's int8 round on the card against
   the CPU within the two-part limit, and above it with one pod counted
   twice and with every token's experts rolled by one in the first MoE
   layer (``moe_round_parity``).
20. SSM / hybrid serve, run after phase 19 (its model is freed):
   falcon-mamba-7b (64 Mamba layers) and hymba-1.5b (32 hybrid layers:
   attention with a window of 1024 but in layers 0, 15 and 31, beside an
   SSM branch), each at full width and depth in bf16 with random params
   from seed 0 drawn on the card and ``attn_impl="pallas"``: the tree's
   params against ``param_count()`` (plus hymba's branch norms, which it
   leaves out), the init's seconds and peak; phase 7's prompts (4 x 2000
   tokens) and 32 greedy decode steps with every kernel count zeroed
   just before and read just after (falcon-mamba-7b launches none,
   hymba-1.5b the wgmma flash kernel once a layer), finite logits; cold
   and warm prefill, decode p50 / p99, the decode state's bytes, the
   peak; two warm prefills bit-equal; a warm prefill and a decode step
   split into the flash kernel, the scan, the causal conv, matrix
   products and the rest (``ssm_split``) with the idle share, the step
   beside the time to read every weight once; hymba's layer 0 (global)
   and layer 1 (window 1024) q, k and v captured and the kernel held
   against its plain version on them.  Then both reduced in fp32
   (150-token prompts): decode against the full forward on the card
   (2e-3), the serve loop on the card against the CPU within
   ``LM_PARITY_ATOL`` with the same greedy tokens, and planted faults
   above it (layer 0's SSM state zeroed after prefill; hymba's first
   layer's KV heads rolled), within it of the same fault on the CPU.
21. frontend and encoder-decoder serve, run after phase 20 (its models
   are freed): internvl2-26b (48 layers; 256 stub patch embeddings
   projected and put in front of the text) and seamless-m4t-large-v2
   (24 encoder layers over 512 stub audio frames, 24 decoder layers
   with cross-attention), each at full width and depth in bf16 with
   random params from seed 0 drawn on the card and
   ``attn_impl="pallas"``, freed before the next: the tree's params
   against ``param_count()`` (plus seamless's encoder norm, which it
   leaves out), the init's seconds and peak; 4 sequences (frontend
   ``normal(0, 0.02)`` from a seed; internvl 2000 prompt tokens,
   seamless a 256-token target-side prefix) and 32 greedy decode steps
   at ``offset + S + i`` (internvl's offset is its 256 patches) with
   every kernel count zeroed just before and read just after (the wgmma
   kernel once a layer: 48 causal for internvl, 24 non-causal and 24
   causal for seamless, whose cross-attention over 512 rows is plain
   attention), finite logits; cold and warm prefill, decode p50 / p99,
   the KV and cross caches' bytes, the peak; two warm prefills
   bit-equal and the cross cache untouched by decode; a warm prefill
   and a decode step split into flash, cross-attention, the encoder's
   other work, matrix products and the rest (``front_split``) with the
   idle share, the step beside the time to read every weight once; the
   first and last layers' q, k and v of each stack captured and the
   kernel held against its plain version on them.  Then each at full
   width cut to 2 (+ 2 encoder) layers in fp32: prefill of S - 1 plus
   a decode step at the offset against the full forward within 2e-3
   with the same greedy token, and planted faults above it (internvl
   decoded without its offset; seamless's encoder run causal); and the
   reduced configs' serve loop on the card against the CPU within
   ``LM_PARITY_ATOL`` with the same greedy tokens.
22. frontend and encoder-decoder fused round, run after phase 21 (its
   models are freed): internvl2-26b at full width cut to 6 of 48 layers
   (3.52 B params; 8 would reckon at about 61 GB) and
   seamless-m4t-large-v2 at full width cut to 6 + 6 of its 24 + 24
   layers, each in bf16
   with random params from seed 0, through phase 11's round with
   ``build_train_step``'s options (``chunked_sp``: the plain flash VJP,
   non-causal in the encoder; cross-attention over 512 rows plain;
   remat), a 2-pod mesh, each pod 4 sequences in 2 microbatches: 256
   stub patches and 512 tokens for internvl, 512 stub frames into the
   encoder and 512 target tokens for seamless (frontend ``normal(0,
   0.02)`` from a seed, added to the batch by the caller); each freed
   before the next (``phase_train_cell``): the tree's params against
   ``param_count()`` (plus the norms it leaves out) and the peak
   reckoned at phase 11's bytes a param in the same run; one int8
   round with every launch count zeroed just before and read just after
   (quantize and dequantize once per leaf and pod, no other kernel); one
   ``compress="none"`` round from the same params (the int8 params
   within 5 % relative of these); a warm int8 round, bit-equal to the
   first; one under ``torch.profiler`` split into the flash VJP, the
   SSM scan, the quantize pair, other matrix products and the rest
   (``train_split``) with the kernel count and the idle share.  Then
   each reduced int8 round on the card against the CPU within the
   two-part limit, and above it with one pod counted twice and with
   internvl's CE taken one position early (the last patch and the text
   but its last token) or seamless's memory detached from the encoder's
   gradient.
23. SSM and hybrid fused round, run after phase 22: falcon-mamba-7b and
   hymba-1.5b at full width cut to 1 and 2 layers (hymba's layer 0
   global, layer 1 a window of 1024), in bf16, through the same round
   and checks as phase 22 with the sharded scan (``ssm_scan_sharded``,
   the sequential in-chunk form under a checkpointed chunk body: about
   124 k dispatched ops a layer a round, host-bound, hence the depth);
   then each reduced round (chunks of 16, 4 a sequence) on the card
   against the CPU, and above the limit with one pod counted twice and
   with the scan's state reset to zero at every chunk boundary.
24. the fused round across processes, run after phase 17: one process a
   coordinate of the mesh (``launch/dist.py``'s ``spawn_ranks``), the
   ranks time-sharing this card and talking over gloo, every wire tensor
   staged through pinned host memory.  World 2 on (2,1,1):
   full-width llama3.2-3b cut to 2 layers (bf16, seed-0 params, phase
   11's batch), an int8 round, a second one (warm) and a ``none`` round,
   each rank's params bit-equal (sha256) to the one-process round of the
   same params and batch run here first.  World 4 on (2,2,1): two int8 rounds with every rank's params
   bit-identical after them, the first round's update norm within 1e-2
   (relative) and its loss within 1e-3 of the one-process round's, and
   a round with data rank 1's accumulator counted twice above that
   limit; then reduced fp32 llama3.2-3b, ``none`` within atol 5e-5 and
   int8 within the two-part limit of the one-process round on the card,
   and a ring one hop short above it.  Each world prints a
   ``dist_round`` line: cold and warm wall (the slowest rank), each
   rank's peak, bytes and seconds a rank spent per pod hop and per data
   all-reduce, quantize and dequantize launches a rank.
25. the model axis across ranks, in phase 24's rank processes after
   their phase-24 rounds (one spawn a world serves both; a world's start
   and first touch count in phase 24): one process a coordinate of a
   mesh whose ``model`` axis is 2 or 4, the ranks time-sharing this card
   over gloo (``phase_model_axis``).  World 2 on
   (1,1,2): full-width llama3.2-3b and deepseek-v2-lite-16b cut to 2
   layers (bf16, seed-0 params, phase 11's batch; deepseek's layer 1 MoE,
   32 experts a rank), reduced fp32 llama3.2-3b and deepseek-v2-lite-16b;
   world 4: full-width llama3.2-3b on (2,1,2) and reduced fp32 gemma3-4b
   on (1,1,4) with 32 tokens a sequence (the ring of ppermutes).  Each
   run against the one-process round of the same params and batch run
   here first: every rank's params bit-identical (sha256) after each
   round; at full width the update norm within 1e-2 (relative) and the
   loss within 1e-3, reduced ``none`` within atol 5e-5 and int8 within
   the two-part limit; and a round with model rank 1's gradient part
   counted twice outside those limits.  One ``model_round`` line a run:
   cold walls (the slowest rank), each rank's peak, the model
   group's calls, bytes and seconds and the (data, model) all-reduce's,
   quantize and dequantize launches a rank.
26. the rest of the model axis, in the same rank processes after phase
   25's runs (``phase_model_axis_26``).  World 2 on (1,1,2), full width
   in bf16 from seed-0 params on phase 11's batch: falcon-mamba-7b at 1
   layer (the SSM scan's d_inner split over the model ranks, one psum
   of the ``x_proj`` product, y and the state gathered), hymba-1.5b at 2
   layers, internvl2-26b at 1 layer with 256 stub patches a sequence,
   seamless-m4t-large-v2 at 1 encoder and 1 decoder layer with 512 stub
   frames (the encoder's non-causal layers through the context-parallel
   flash, the cross-attention replicated); each a cold and a warm int8
   round against the one-process round, as phase 25's full-width runs.
   Reduced fp32 falcon-mamba-7b and seamless-m4t-large-v2 with model
   rank 1's part counted twice and each family's fault (the ``x_proj``
   product unsummed; the encoder run causal); then hymba-1.5b (fp32, 2
   layers) served through ``fl/round.py``'s ``build_prefill_step`` and
   ``build_decode_step`` (4 prompts of 2000 tokens, 8 greedy steps):
   every rank's logits bit-identical, the greedy tokens and, within
   ``LM_PARITY_ATOL``, the logits of the one-process serve, no kernel
   launched.  World 4 on (1,1,4): reduced hymba-1.5b at 32 tokens (the
   ring) and internvl2-26b, each with a part counted twice.  One
   ``model_round`` line a run (with ``param_count`` and the reckoned
   fp32 part a rank), one ``model_serve`` line; ``phases_24_26`` splits
   the three phases' time (and phase 27's rounds in world 4's ranks).
   ``phase_seconds`` gives each phase group's wall.
27. sharded storage and the dry run, in world 4's rank processes after
   phase 26 (``fsdp_rank``), from seed-0 params and phase 11's batch as
   one microbatch: full-width llama3.2-3b cut to 2 layers (bf16) with
   each rank holding only its blocks of ``train_shardings``' specs.
   (a) (2,2,1), hierarchical, FSDP over ``data``: the replicated
   ``none`` and int8 rounds first, then the sharded ``none`` round, the
   int8 round, again from the same blocks (warm), and int8 with data
   rank 1's part of every data-gathered gradient counted twice.  Each
   sharded delta (as the server optimizer takes it) against the
   replicated delta's block of the same rank: ``none`` within
   ``FSDP_NONE_RTOL`` of each leaf's largest element (the bf16
   arithmetic moves); int8 element by element within the ``none``
   round's measured difference plus Σ_p (s_p + s'_p) / 2P, the two
   rounds' int8 rounding (the share of elements over 1e-5 reported);
   the fault above; every rank's resident param and state bytes the sum
   reckoned from the specs, below a replica's; each round's peak below
   the replicated round's; ranks that hold the same block, and the two
   int8 rounds, bit-identical; quantize once a leaf and dequantize once
   a leaf and pod a rank in an int8 round, no other kernel.  (b)
   (1,2,2), flat ``none``: storage split over ``model`` and, FSDP, over
   (pod, data), the same checks against (a)'s replicated ``none`` round
   (a flat round's mean is the hierarchical one's).  One
   ``fsdp_round`` line a run.  (c) ``launch/dryrun.py``'s dry run of
   (a)'s cell, rank 0 under fake tensors on the CPU, must predict rank
   0's resident bytes and its wire's calls and bytes by kind exactly
   (``fsdp_dryrun``).  (d) the card's bf16 matmul rate (8192³
   ``torch.mm``, CUDA events) beside (c)'s FLOPs (``bf16_matmul``); a
   production cell's dry run (llama3.2-3b × train_4k × multi, 512
   ranks) is CPU work of a minute or two, run by
   ``python -m repro_torch.launch.dryrun``, not here.
The ``kernels`` line gives each fedavg kernel its launches by path:
phase 5, phase 13's controller (0: the workers fold with numpy),
phase 14 in netd and at the controller, phase 15, phase 16, phase 19,
phase 20, phase 21, each arch's round in phases 22 and 23; each flash
kernel its launches on every path that runs attention, phases 20's to
23's models included, and its non-causal case (phase 6, seamless's
encoder shape); each quantize kernel its launches in phases 11 and 19
to 23, and on each rank of phases 24 to 27.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.api import Session  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    restore_checkpoint)
from repro_torch.configs import ARCHS, ShapeConfig  # noqa: E402
from repro_torch.configs.resnet import RESNET18  # noqa: E402
from repro_torch.convert import (flatten_jax_layout,  # noqa: E402
                               unflatten_jax_layout)
from repro_torch.core import (Aggregator, ClientInfo, EngineConfig,  # noqa: E402
                              InProcObjectStore, NodeState, RoundConfig,
                              TorchEngine, UpdateEnvelope, fedavg_oracle)
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.placement import build_fold_plan  # noqa: E402
from repro_torch.data import (ClientShard, build_client_datasets,  # noqa: E402
                              dirichlet_partition, synthetic_femnist)
from repro_torch.data.loader import CohortTokenLoader  # noqa: E402
from repro_torch.data.synthetic import TokenTaskStream  # noqa: E402
from repro_torch.fl import compression  # noqa: E402
from repro_torch.fl import round as fl_round  # noqa: E402
from repro_torch.fl.round import (AggregationConfig,  # noqa: E402
                                  abstract_params, accumulate_updates,
                                  build_decode_step, build_prefill_step,
                                  build_train_step, serve_options,
                                  train_options, train_shardings)
from repro_torch.fl.server import (apply_server_opt,  # noqa: E402
                                  init_server_state)
from repro_torch.kernels.fedavg import fedavg as fed  # noqa: E402
from repro_torch.kernels.fedavg import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    BY_VARIANT as FA_BY_VARIANT, FLASH_MMA, FLASH_SIMT, FLASH_TF32X3,
    FLASH_WGMMA,
    GLOBAL, KERNELS as FA_KERNELS, LIBS as FA_LIBS, flash_attention_fwd_cuda,
    flash_variant)
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref  # noqa: E402
# the package's name ``quantize`` is the op; the wrappers' module by path
from repro_torch.kernels.quantize.quantize import (  # noqa: E402
    DEQUANTIZE, KERNELS as Q_KERNELS, LIB as Q_LIB, QUANTIZE,
    dequantize_cuda, quantize_cuda)
from repro_torch.launch.dist import spawn_ranks  # noqa: E402
from repro_torch.launch.dryrun import dry_run_cell  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_host_mesh, stand_in_mesh)
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.registry import LM  # noqa: E402
from repro_torch.models.resnet import build_resnet  # noqa: E402
from repro_torch.runtime import (ClientRuntime, FusedFLTrainer,  # noqa: E402
                                 PartialReady, UpdateArrived, WorkerCrashed)
from repro_torch.runtime.driver import InProcRuntime, RoundDriver  # noqa: E402
from repro_torch.runtime.netrt import (RemoteRuntime, connect,  # noqa: E402
                                       reap_local_daemon, spawn_local_daemon)
from repro_torch.obs import summary_line  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, AggregationService,  # noqa: E402
                               MinCohortIdleGap)
from repro_torch.sharding.rules import (block_bytes,  # noqa: E402
                                        shard_leaf, shard_tree, split_over)
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,  # noqa: E402
                              tree_unflatten)

SCRIPT_T0 = time.perf_counter()   # the script's start, after its imports
N_RESNET18 = 11_199_486      # fp32 parameters of RESNET18
NOMINAL_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 494.7e12        # H100 SXM TF32 dense tensor cores
BF16_FLOPS = 989e12          # H100 SXM bf16 dense tensor cores
RTOL = {"eager_accumulate": 1e-6, "fedavg_accumulate_k": 1e-5,
        "fedavg_reduce": 1e-5}
PARITY_ATOL = 3e-4           # card vs CPU params, phase 5
CLIENT_LR = 0.01             # the paper's client SGD (§6.2: lr 0.01, batch 32)
#: flash kernel vs its plain version, rtol = atol: the JAX package's
#: kernel test (tests/test_kernels.py:134), at every shape
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2,
             torch.float16: 2e-2}
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "llama3.2-3b", 4, 2000, 32
LM_PARITY_ATOL = 2e-3        # card vs CPU logits, phase 8
#: the mma.sync prefill against the wgmma one (phase 7), last-position
#: bf16 logits, |diff| <= tol (1 + max |logits|): the bf16 logit
#: tolerance of tests/test_torch_lm.py, as phase 18's dense vs ep
MMA_PREFILL_TOL = 6e-2
FUSED_SEQ = 512              # tokens a sequence in the fused round, phase 11


def log(*args) -> None:
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 10) -> float:
    """Device ms a call: CUDA events around ``inner`` back-to-back calls
    (so the host's launch cost hides behind the queue, as on the path),
    median over ``reps`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def copy_bandwidth() -> float:
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=20)
    return 2 * src.numel() * 4 / (ms * 1e-3)


def errors(got, want):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / want.double().abs().clamp_min(1e-30)).max())


def limit_share(got, want, rtol) -> float:
    """max |got - ref| / (rtol + rtol·|ref|): above 1 is outside."""
    return float(((got.double() - want.double()).abs()
                  / (rtol + rtol * want.double().abs())).max())


def check_close(name, got, want, rtol) -> None:
    """|got - ref| <= rtol + rtol·|ref| elementwise (atol = rtol, as the
    JAX package's kernel tests state)."""
    bad = (got - want).abs() > rtol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"rtol=atol={rtol}")


def kernel_case(name, dtype, k, copy_bps, n=N_RESNET18, view=(0, 0)):
    """One kernel at one dtype and K against its plain version; the
    eager fold on views ``acc_buf[view[0]:]`` and ``u_buf[view[1]:]``,
    bit-equal, and timed beside its first design too."""
    g = torch.Generator(device="cuda").manual_seed(0)
    acc0 = torch.randn(n, generator=g, device="cuda")
    esz = torch.tensor([], dtype=dtype).element_size()
    previous = None
    if name == "eager_accumulate":
        a_off, u_off = view
        u = torch.randn(n + u_off, generator=g,
                        device="cuda").to(dtype)[u_off:]
        w = 1.75
        acc = torch.empty(n + a_off, device="cuda")[a_off:].copy_(acc0)
        ptr = acc.data_ptr()
        want = ref.eager_accumulate_ref(acc0, u, w)
        got = ops.eager_accumulate(acc, u, w, impl="cuda").clone()
        torch.cuda.synchronize()
        if acc.data_ptr() != ptr or not torch.equal(got, want):
            raise AssertionError(f"eager_accumulate[{dtype}, view {view}]: "
                                 "not bit-equal in place")
        run = lambda: ops.eager_accumulate(acc, u, w, impl="cuda")
        previous = lambda: fed.eager_accumulate_cuda(
            acc, u, w, kernel=fed.EAGER_PREVIOUS)
        plain = lambda: ref.eager_accumulate_ref(acc, u, w)
        library = lambda: torch.add(acc, u, alpha=w, out=acc)
        nbytes = (8 + esz) * n
        flops = 2 * n
    else:
        U = torch.randn(k, n, generator=g, device="cuda").to(dtype)
        w = torch.rand(k, generator=g, device="cuda") * 3.5 + 0.5
        if name == "fedavg_accumulate_k":
            got = ops.fedavg_accumulate_k(acc0.clone(), U, w, impl="cuda")
            want = ref.fedavg_accumulate_k_ref(acc0, U, w)
            acc = acc0.clone()
            run = lambda: ops.fedavg_accumulate_k(acc, U, w, impl="cuda")
            plain = lambda: ref.fedavg_accumulate_k_ref(acc, U, w)
            library = (lambda: acc.addmv_(U.t(), w)) \
                if dtype == torch.float32 else None
            nbytes = (8 + k * esz) * n + 4 * k
            flops = (2 * k + 1) * n
        else:
            wn = w / w.sum()
            got = fed.fedavg_reduce_cuda(U, wn)
            want = ref.fedavg_reduce_ref(U, wn)
            run = lambda: fed.fedavg_reduce_cuda(U, wn)
            plain = lambda: ref.fedavg_reduce_ref(U, wn)
            library = (lambda: torch.mv(U.t(), wn)) \
                if dtype == torch.float32 else None
            nbytes = (4 + k * esz) * n + 4 * k
            flops = 2 * k * n
    torch.cuda.synchronize()
    check_close(f"{name}[{dtype}, K={k}]", got, want, RTOL[name])
    max_abs, max_rel = errors(got, want)
    del got, want
    # the eager fold's two designs in turns (new, first, first, new),
    # the better median of each
    ms = time_ms(run)
    prev_ms = None
    if previous:
        prev_ms = min(time_ms(previous), time_ms(previous))
    row = {
        "name": name, "dtype": str(dtype).replace("torch.", ""), "K": k,
        "N": n, "view": list(view), "max_abs_err": max_abs,
        "max_rel_err": max_rel, "ms": min(ms, time_ms(run)),
        "previous_ms": prev_ms, "plain_ms": time_ms(plain),
        "library_ms": time_ms(library) if library else None,
        "bytes": nbytes, "flops": flops,
        # the larger of moving the bytes once and doing the operations
        "bound_ms": max(nbytes / NOMINAL_BPS, flops / FP32_FLOPS) * 1e3,
        "bound_copy_ms": nbytes / copy_bps * 1e3,
        "bound_by": ("bytes" if nbytes / NOMINAL_BPS >= flops / FP32_FLOPS
                     else "operations"),
    }
    return row


def phase_kernels(copy_bps):
    rows = []
    cases = [("eager_accumulate", torch.float32, 1, (0, 0)),
             ("eager_accumulate", torch.float32, 1, (1, 3)),
             ("eager_accumulate", torch.bfloat16, 1, (0, 0)),
             ("eager_accumulate", torch.bfloat16, 1, (1, 3)),
             ("eager_accumulate", torch.float16, 1, (0, 0)),
             ("fedavg_accumulate_k", torch.float32, 8, (0, 0)),
             ("fedavg_accumulate_k", torch.bfloat16, 8, (0, 0)),
             ("fedavg_reduce", torch.float32, 8, (0, 0))]
    for name, dtype, k, view in cases:
        row = kernel_case(name, dtype, k, copy_bps, view=view)
        log("kernel_case " + json.dumps(row))
        rows.append(row)
    return rows


def phase_engine():
    rng = np.random.default_rng(0)
    us = [rng.standard_normal(N_RESNET18).astype(np.float32)
          for _ in range(6)]
    ws = [float(w) for w in rng.uniform(0.5, 8.0, size=6)]
    want = fedavg_oracle(us, ws)
    eng = TorchEngine("cuda")
    for eager in (True, False):
        store = InProcObjectStore()
        agg = Aggregator("smoke", store, goal=len(us), eager=eager,
                         engine=eng, batch_k=8)
        for u, w in zip(us, ws):
            agg.recv(UpdateEnvelope(store.put(u), 0, "c", w,
                                    enqueue_ts=time.perf_counter()))
        if not eager:
            agg.flush()
        if not agg.done:
            raise AssertionError("aggregator did not reach its goal")
        got, weight = agg.result
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        log(f"engine eager={eager}: folded {len(us)} x {N_RESNET18} "
            f"in {agg.agg_exec_s:.4f} s, max_abs_err "
            f"{float(np.abs(got - want).max()):.3e}")
        eng.recycle()
        store.close()
    # one fold's host-side staging: pinned copy plus host-to-device
    st = eng._staging_for("f32", 1, N_RESNET18)
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        st.fill([us[0]])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stage_s = sorted(times)[len(times) // 2]
    log(f"engine staging: {N_RESNET18 * 4 / 1e6:.1f} MB host->device in "
        f"{stage_s * 1e3:.3f} ms (median of 7)")
    return stage_s


def engine_speedup(n=N_RESNET18, reps=15):
    """Fold throughput of the engines against the naive one's: one
    ResNet-18-sized fp32 update folded from the host, each fold timed
    to its end (the torch engine's pinned staging, host-to-device copy
    and eager kernel, synchronised); the engines take turns, ``reps``
    folds each after a warm one, median.  The ``torch`` ratio is
    ``DataPlaneCosts.agg_engine_speedup``'s entry
    (``core/simulation.py``)."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n).astype(np.float32)
    names = ("naive", "blocked", "torch")
    engs = {k: make_engine(EngineConfig(name=k, device="cuda"))
            for k in names}
    accs = {k: e.begin(n) for k, e in engs.items()}
    times = {k: [] for k in names}
    for r in range(reps + 1):
        for k, eng in engs.items():
            t0 = time.perf_counter()
            accs[k] = eng.fold(accs[k], u, 1.5)
            eng.sync(accs[k])
            if r:                       # the first fold warms the buffers
                times[k].append(time.perf_counter() - t0)
    s = {k: sorted(t)[reps // 2] for k, t in times.items()}
    return {"fold_s": s, "speedup": {k: s["naive"] / v for k, v in s.items()}}


def fold_launches():
    return {k.name: k.launches for k in fed.KERNELS}


def zero_fold_launches() -> None:
    for k in fed.KERNELS:
        k.launches = 0


def check_fold_launches(label, launches, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by {label}")


def resnet_fleet(cfg=RESNET18, n_images=512, classes=62, device="cuda"):
    """Phase 5's workload: ResNet-18 (random weights from seed 0),
    ``synthetic_femnist(512, 62)``, 8 clients (Dirichlet α 0.5), 3 nodes
    of capacity 20.  ``clients()`` and ``nodes()`` make a fresh fleet
    for each session."""
    model = build_resnet(cfg)
    params = model.init(seed=0, device=device)
    imgs, labels = synthetic_femnist(n_images, num_classes=classes, seed=0)
    shards = dirichlet_partition(labels, 8, alpha=0.5)
    clients = lambda: [  # noqa: E731
        ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
        for d in build_client_datasets(imgs, labels, shards)]
    nodes = lambda: {f"node{i}": NodeState(node=f"node{i}",  # noqa: E731
                                           max_capacity=20)
                     for i in range(3)}
    test = {"images": imgs[:256], "labels": labels[:256]}
    return model, params, clients, nodes, test


def phase_round():
    model, params, clients, nodes, test = resnet_fleet()
    clients = clients()
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != N_RESNET18:
        raise AssertionError(f"RESNET18 has {n_params} params")
    before = [l.clone() for l in tree_leaves(params)]
    lazy_counts = []

    def agg_exec(s) -> float:
        return sum(v for k, v in s.metrics()["sidecar"].items()
                   if k.endswith("/agg_exec_s"))

    def one_round(s, label):
        e0 = agg_exec(s)
        torch.cuda.synchronize()
        rec = s.run_round(client_lr=CLIENT_LR, client_batch_size=32)
        torch.cuda.synchronize()
        bd = s.trace().breakdown()
        row = {"round": label, "updates": rec["updates"],
               "nodes_used": rec["nodes_used"], "wall_s": rec["wall_s"],
               "agg_exec_s": agg_exec(s) - e0,
               "eval_loss": s.evaluate(test)["loss"]}
        row.update({f"trace_{k}": v for k, v in bd.items()})
        log("round " + json.dumps(row))
        return row

    zero_fold_launches()
    rows = []
    with Session.open(model, params, clients, nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=6),
                      seed=0) as s:
        log(f"round: before eval_loss {s.evaluate(test)['loss']:.6f}")
        rows.append(one_round(s, "eager-0"))
        rows.append(one_round(s, "eager-1"))
        params = s.params
    with Session.open(model, params, clients, nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=6, eager=False),
                      seed=1) as s:
        s.on(PartialReady, lambda ev: lazy_counts.append(ev.count))
        rows.append(one_round(s, "lazy-2"))
        params = s.params
    torch.cuda.synchronize()
    launches = fold_launches()
    log("round launches " + json.dumps(launches))
    after = tree_leaves(params)
    if not all(bool(torch.isfinite(l).all()) for l in after):
        raise AssertionError("non-finite params after the rounds")
    if not any(bool((a != b).any()) for a, b in zip(after, before)):
        raise AssertionError("params did not change")
    check_fold_launches("the rounds", launches,
                        ("eager_accumulate", "fedavg_accumulate_k"))
    return rows, launches, max(lazy_counts)


@contextlib.contextmanager
def planted_fault():
    """A misweighted update, planted for the parity check to catch: the
    first single fold counts its update twice (w -> 2w) while the
    aggregator's weight sum keeps w."""
    orig = TorchEngine.fold
    left = [1]

    def fold(self, acc, update, w):
        if left[0]:
            left[0] -= 1
            w = 2.0 * w
        return orig(self, acc, update, w)

    TorchEngine.fold = fold
    try:
        yield
    finally:
        TorchEngine.fold = orig
    if left[0]:
        raise AssertionError("the planted fault never fired")


def small_rounds(device):
    """Reduced ResNet-18, six clients of eight samples: one eager and one
    lazy round from params made from seed 0; the leaves on the host."""
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(48, num_classes=62, seed=0)
    shards = [ClientShard(f"client{i}", np.arange(8 * i, 8 * i + 8))
              for i in range(6)]
    params = model.init(seed=0, device=device)
    for eager, seed in ((True, 0), (False, 1)):
        clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
                   for d in build_client_datasets(imgs, labels, shards)]
        with Session.open(
                model, params, clients, device=device, seed=seed,
                nodes={f"node{i}": NodeState(node=f"node{i}", max_capacity=3)
                       for i in range(2)},
                round_cfg=RoundConfig(aggregation_goal=4, eager=eager)) as s:
            s.run_round(client_lr=0.05, client_batch_size=8)
            params = s.params
    return [l.detach().cpu() for l in tree_leaves(params)]


def phase_parity():
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions), on a small input.  cuDNN and the CPU sum
    convolutions and GroupNorm statistics in different orders (cuDNN
    not the same way on every run), and two rounds of SGD carry those
    fp32 differences into the params, so the two agree within
    ``PARITY_ATOL`` and not bit for bit.  The same path with one update
    counted twice (``planted_fault``) must land outside it: the check
    has a reading on each side of its limit in every run."""
    # oneDNN's CPU conv backward has crashed at odd batch sizes; the
    # CPU side of this check does not need it
    torch.backends.mkldnn.enabled = False
    cpu = small_rounds("cpu")
    torch.backends.mkldnn.enabled = True
    card = small_rounds("cuda")
    with planted_fault():
        faulted = small_rounds("cuda")
    diff = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
    sound, planted = diff(card, cpu), diff(faulted, cpu)
    log("parity " + json.dumps({"max_abs_diff": sound,
                                "planted_fault_max_abs_diff": planted,
                                "atol": PARITY_ATOL}))
    if not sound <= PARITY_ATOL:
        raise AssertionError(f"card vs CPU: {sound:.3e} > {PARITY_ATOL}")
    if not planted > PARITY_ATOL:
        raise AssertionError(f"a misweighted update moved the params by "
                             f"{planted:.3e}, inside {PARITY_ATOL}")


def visible_pairs(S: int, window: int, causal: bool = True) -> int:
    """(i, j) pairs an attention of length S computes (j <= i when
    ``causal``, i - j < window under a window): what the kernel must do,
    whatever tiles it visits."""
    if window == GLOBAL:
        return S * (S + 1) // 2 if causal else S * S
    w = min(window, S)
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    # every later key, and the w - 1 earlier ones within the window
    return S * S - (S - w) * (S - w + 1) // 2


def flash_row(label, q, k, v, window, planted=False, causal=True,
              previous=True):
    """The flash kernel that ``flash_variant`` picks for (q, k, v) against
    its plain version, timed beside the library's attention on the same
    inputs and, with ``previous``, beside the first design, the CUDA-core
    kernel named (``previous_ms``), whose output is held against the
    plain version too.  ``planted``: the plain version once more with
    TF32 matmuls (one TF32 pass) must land outside the tolerance.  A
    non-causal row (``causal=False``) holds its planted fault always: the
    plain version run causal must land outside it; so does a row of the
    mma.sync kernel on views into their buffers: the plain version on the
    views moved back one element must land outside it."""
    B, S, K, G, D = q.shape
    Dv = v.shape[-1]
    H = K * G
    scale = D ** -0.5
    kw = dict(window=window, causal=causal, scale=scale)
    run = lambda: fa_ops.flash_attention(q, k, v, impl="cuda", **kw)
    plain = lambda: fa_ops.flash_attention(q, k, v, impl="torch", **kw)
    simt = lambda: flash_attention_fwd_cuda(q, k, v, variant="simt", **kw)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    kern = FA_BY_VARIANT[flash_variant(q.dtype, D, Dv, aligned)]
    n0 = [kn.launches for kn in FA_KERNELS]
    got, want = run(), plain()
    torch.cuda.synchronize()
    moved = [kn.launches - c for kn, c in zip(FA_KERNELS, n0)]
    if moved != [int(kn is kern) for kn in FA_KERNELS]:
        raise AssertionError(f"flash[{label}]: launches {moved}, not one of "
                             f"{kern.name}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash[{label}]: non-finite output")
    tol = FLASH_TOL[q.dtype]
    check_close(f"flash[{label}]", got.float(), want.float(), tol)
    max_abs, max_rel = errors(got.float(), want.float())
    share = limit_share(got.float(), want.float(), tol)
    one_pass = None
    if planted:
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = True
        try:
            one = plain().float()
        finally:
            matmul.allow_tf32 = False
        one_pass = {"max_abs_err": errors(one, want.float())[0],
                    "limit_share": limit_share(one, want.float(), tol)}
        if not one_pass["limit_share"] > 1.0:
            raise AssertionError(f"flash[{label}]: one TF32 pass lands "
                                 f"inside rtol=atol={tol}: {one_pass}")
        del one
    moved_back = None
    if kern is FLASH_MMA and min(t.storage_offset() for t in (q, k, v)):
        back = [t.as_strided(t.shape, t.stride(), t.storage_offset() - 1)
                for t in (q, k, v)]
        wrong = fa_ops.flash_attention(*back, impl="torch", **kw).float()
        moved_back = {"max_abs_err": errors(got.float(), wrong)[0],
                      "limit_share": limit_share(got.float(), wrong, tol)}
        if not moved_back["limit_share"] > 1.0:
            raise AssertionError(f"flash[{label}]: the kernel lands inside "
                                 f"rtol=atol={tol} of the views moved back "
                                 f"one element: {moved_back}")
        del back, wrong
    causal_plain = None
    if not causal:
        wrong = fa_ops.flash_attention(q, k, v, impl="torch",
                                       **{**kw, "causal": True}).float()
        causal_plain = {"max_abs_err": errors(wrong, got.float())[0],
                        "limit_share": limit_share(got.float(), wrong, tol)}
        if not causal_plain["limit_share"] > 1.0:
            raise AssertionError(f"flash[{label}]: the kernel lands inside "
                                 f"rtol=atol={tol} of causal attention: "
                                 f"{causal_plain}")
        del wrong
    del got, want
    qh = q.reshape(B, S, H, D).transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    if window == GLOBAL:
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True, scale=scale)
    else:
        i = torch.arange(S, device=q.device)
        band = i[:, None] - i[None, :] < window
        if causal:
            band &= i[:, None] >= i[None, :]
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band, enable_gqa=True, scale=scale)
    esz = q.element_size()
    nbytes = esz * (q.numel() + k.numel() + v.numel() + B * S * H * Dv)
    flops = 2 * B * H * visible_pairs(S, window, causal) * (D + Dv)
    b_bytes = nbytes / NOMINAL_BPS
    if q.dtype == torch.float32:
        # fp32-accurate work: three TF32 products on the tensor cores
        b_ops = 3 * flops / TF32_FLOPS
    else:
        b_ops = flops / BF16_FLOPS
    reps = 25 if S <= 256 else 10
    # the two designs in turns (tensor cores, CUDA cores, CUDA cores,
    # tensor cores), the first held against the plain version as well
    ms = time_ms(run, reps=reps)
    prev_ms = prev_err = None
    if previous:
        first = simt().float()
        torch.cuda.synchronize()
        want = plain().float()
        check_close(f"flash[{label}], CUDA cores", first, want, tol)
        prev_err = {"max_abs_err": errors(first, want)[0],
                    "limit_share": limit_share(first, want, tol)}
        del first, want
        prev_ms = min(time_ms(simt, reps=reps), time_ms(simt, reps=reps))
    row = {
        "case": label, "dtype": str(q.dtype).replace("torch.", ""),
        "kernel": kern.name, "aligned": aligned,
        "shape": [B, S, K, G, D, Dv], "window": window, "causal": causal,
        "tol": tol,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "limit_share": share,
        "ms": min(ms, time_ms(run, reps=reps)), "previous_ms": prev_ms,
        "previous_err": prev_err, "plain_ms": time_ms(plain, reps=reps),
        "library_ms": time_ms(library, reps=reps),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(b_bytes, b_ops) * 1e3,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
    }
    if q.dtype == torch.float32:
        row["bound_simt_ms"] = max(b_bytes, flops / FP32_FLOPS) * 1e3
    if one_pass is not None:
        row["one_tf32_pass"] = one_pass
    if causal_plain is not None:
        row["causal_plain_vs_kernel"] = causal_plain
    if moved_back is not None:
        row["moved_back_plain_vs_kernel"] = moved_back
    return row


def randn_on_card(shape, dtype, g, offset=0):
    """Normal values in ``dtype``, starting ``offset`` elements into their
    buffer (1 puts a 16-bit tensor off 16 bytes)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=g, device="cuda").to(dtype)
    return buf[offset:].view(shape)


def phase_flash():
    """The flash kernels on random inputs: the serve path's shape,
    gemma3's and h2o-danube-3-4b's, and the JAX package's four
    kernel-test shapes.  -> the rows by (case, dtype)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    every = (torch.bfloat16, torch.float16, torch.float32)
    bf16 = (torch.bfloat16,)
    # (label, B, S, K, G, D, window, dtypes, element offset[, causal])
    cases = [("path", 4, 2000, 8, 3, 128, GLOBAL, every, 0),
             ("gemma3", 4, 2000, 4, 2, 256, 1024, bf16, 0),
             ("h2o_danube3", 4, 2000, 8, 4, 120, 4096, bf16, 0),
             ("h2o_danube3_unaligned", 4, 2000, 8, 4, 120, 4096, bf16, 1),
             # the serve path off 16 bytes: mma.sync in fp16, the 3xTF32
             # kernel's 4-byte copies in fp32; and an odd head dim
             ("path_unaligned", 4, 2000, 8, 3, 128, GLOBAL,
              (torch.float16, torch.float32), 1),
             ("odd_dim", 1, 300, 2, 3, 15, GLOBAL, every, 0),
             ("hymba", 4, 2000, 5, 5, 64, 1024, bf16, 0),
             ("hymba_global", 4, 2000, 5, 5, 64, GLOBAL, bf16, 0),
             ("test0", 1, 128, 1, 1, 32, GLOBAL, every, 0),
             ("test1", 2, 256, 2, 3, 64, GLOBAL, every, 0),
             ("test2", 1, 256, 4, 1, 64, 64, every, 0),
             ("test3", 2, 192, 2, 2, 32, 16, every, 0),
             # seamless-m4t-large-v2's encoder: 16 heads (MHA), D 64, its
             # 512 frames, no causal mask; each kernel's inputs
             ("seamless_encoder", 4, 512, 16, 1, 64, GLOBAL,
              (torch.bfloat16, torch.float32), 0, False),
             ("seamless_encoder_unaligned", 4, 512, 16, 1, 64, GLOBAL, bf16,
              1, False)]
    rows = {}
    for label, B, S, K, G, D, window, dtypes, off, *causal in cases:
        for dtype in dtypes:
            mk = lambda *shape: randn_on_card(shape, dtype, g, off)
            row = flash_row(label, mk(B, S, K, G, D), mk(B, S, K, D),
                            mk(B, S, K, D), window,
                            planted=(dtype == torch.float32
                                     and label in ("path", "path_unaligned")),
                            causal=causal[0] if causal else True)
            log("flash_case " + json.dumps(row))
            rows[label, row["dtype"]] = row
    return rows


@contextlib.contextmanager
def flash_calls(fn):
    """Route the model's calls of ``ops.flash_attention`` through
    ``fn(i, q, k, v, **kw)`` (i counts the calls from 0)."""
    orig = fa_ops.flash_attention
    n = [0]

    def wrapped(q, k, v, *args, **kw):
        i = n[0]
        n[0] += 1
        return fn(i, orig, q, k, v, *args, **kw)

    fa_ops.flash_attention = wrapped
    try:
        yield n
    finally:
        fa_ops.flash_attention = orig


def serve(model, params, prompts, steps, device, frontend=None, offset=0):
    """``examples/serve_decode.py``'s loop: prefill, then greedy decode
    on the ring cache.  ``frontend``: the stub's embeddings, in the
    prefill's batch; ``offset``: the positions ahead of the prompt (a
    decoder-only model's patches), so step i decodes at ``offset + S +
    i``.  -> (logits of every step (B, 1 + steps, V), tokens (B, 1 +
    steps), prefill s, per-step s, caches)."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    S = offset + prompts.shape[1]
    batch = {"tokens": prompts}
    if frontend is not None:
        batch["frontend"] = frontend
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    out, toks, lat = [logits], [logits[:, -1].argmax(-1)[:, None]], []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, toks[-1], caches, S + i)
        sync()
        lat.append(time.perf_counter() - t0)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    return torch.cat(out, 1), torch.cat(toks, 1), prefill_s, lat, caches


def device_time_split(fn):
    """``fn()`` once under torch.profiler: device time (ms) of the flash
    kernel, of matrix products and of everything else, the kernel count,
    the wall time and the device's idle share of it."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"flash_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    top, kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "flash_fwd" in name:        # either flash kernel
            split["flash_ms"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
        kernels += e.count
        top.append((ms, e.key[:80], e.count))
    busy = sum(split.values())
    split.update(kernels=kernels, wall_ms=wall * 1e3, busy_ms=busy,
                 idle_share=1.0 - busy / (wall * 1e3),
                 top=sorted(top, reverse=True)[:6])
    return split


def phase_serve(copy_bps):
    """Full-width llama3.2-3b: prefill 4 x 2000 tokens through the flash
    kernel, then 32 greedy decode steps on the ring cache."""
    cfg = ARCHS[LM_ARCH]
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=LM_PROMPT + LM_STEPS + 8))
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{LM_ARCH} has {n_params} params, the config "
                             f"counts {cfg.param_count()}")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    last = cfg.num_layers - 1
    captured = {}

    def capture(i, orig, q, k, v, *args, **kw):
        if i in (0, last):
            captured[i] = (q.clone(), k.clone(), v.clone())
        return orig(q, k, v, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    with flash_calls(capture):
        for kern in FA_KERNELS:
            kern.launches = 0
        logits, toks, prefill_s, lat, caches = serve(
            model, params, prompts, LM_STEPS, torch.device("cuda"))
        launches = {kern.name: kern.launches for kern in FA_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {kern.name: cfg.num_layers * int(kern is FLASH_WGMMA)
            for kern in FA_KERNELS}
    if launches != want:
        raise AssertionError(f"the bf16 prefill launched {launches}, not "
                             f"{want}")
    if tuple(logits.shape) != (LM_BATCH, 1 + LM_STEPS, cfg.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    lat_ms = sorted(x * 1e3 for x in lat)
    warm = [serve(model, params, prompts, 0, torch.device("cuda"))
            for _ in range(2)]
    warm_s = min(w[2] for w in warm)
    mma = phase_serve_mma(model, params, prompts, warm[-1][0])
    del warm
    row = {
        "arch": LM_ARCH, "params": n_params, "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS,
        "init_s": init_s, "prefill_cold_ms": prefill_s * 1e3,
        "prefill_ms": warm_s * 1e3,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / warm_s,
        "decode_first_ms": lat[0] * 1e3,
        "decode_p50_ms": float(np.percentile(lat_ms, 50)),
        "decode_p99_ms": float(np.percentile(lat_ms, 99)),
        "decode_tok_s": LM_BATCH * LM_STEPS / sum(lat),
        "peak_mem_gb": peak / 1e9, "flash_launches": launches,
        "tokens_0": toks[0, :8].tolist(), **mma}
    log("serve " + json.dumps(row))
    log("serve_prefill_device " + json.dumps(device_time_split(
        lambda: model.prefill(params, {"tokens": prompts}))))
    tok = toks[:, -1:]
    split = device_time_split(lambda: model.decode_step(
        params, tok, caches, LM_PROMPT + LM_STEPS))
    # the least a decode step can take: every weight read once
    split["weight_read_ms"] = 2 * n_params / copy_bps * 1e3
    log("serve_decode_device " + json.dumps(split))
    rows = [flash_row(f"serve_layer{i}", q, k, v, GLOBAL)
            for i, (q, k, v) in sorted(captured.items())]
    for r in rows:
        log("flash_case " + json.dumps(r))
    del params, logits, caches
    torch.cuda.empty_cache()
    return row, launches[FLASH_WGMMA.name], rows[0]


def phase_serve_mma(model, params, prompts, wgmma_logits):
    """One more warm bf16 prefill of phase 7 with the mma.sync kernel
    named in the wgmma kernel's place: 28 launches of it and none of the
    others, timed, its last-position logits within ``MMA_PREFILL_TOL``
    of the wgmma prefill's (``wgmma_logits``)."""
    def named(i, orig, q, k, v, *args, **kw):
        return flash_attention_fwd_cuda(
            q, k, v, scale=kw["scale"], window=kw["window"],
            causal=kw["causal"], variant="mma")

    with flash_calls(named):
        for kern in FA_KERNELS:
            kern.launches = 0
        logits, _, prefill_s, _, _ = serve(model, params, prompts, 0,
                                           torch.device("cuda"))
        launches = {kern.name: kern.launches for kern in FA_KERNELS}
    n_layers = model.cfg.num_layers
    want = {kern.name: n_layers * int(kern is FLASH_MMA)
            for kern in FA_KERNELS}
    if launches != want:
        raise AssertionError(f"the bf16 prefill with the mma.sync kernel "
                             f"named launched {launches}, not {want}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits with the mma.sync kernel")
    diff = float((logits.float() - wgmma_logits.float()).abs().max())
    scale = float(wgmma_logits.float().abs().max())
    out = {"prefill_mma_ms": prefill_s * 1e3, "launches_mma": launches,
           "mma_vs_wgmma_logits_max_abs": diff,
           "wgmma_logits_max_abs": scale,
           "mma_same_greedy_tokens": bool(torch.equal(
               logits[:, -1].argmax(-1), wgmma_logits[:, -1].argmax(-1)))}
    if not diff <= MMA_PREFILL_TOL * (1 + scale):
        raise AssertionError(f"mma.sync vs wgmma prefill logits: {diff:.3e}"
                             f" > {MMA_PREFILL_TOL} (1 + {scale:.3e})")
    return out


def phase_fp32_prefill():
    """Phase 7's llama3.2-3b at full width and depth in fp32 (random
    weights from seed 0): prefill of 4 prompts of 2000 tokens through the
    3xTF32 flash kernel, cold and warm, its device split, then the same
    prefill with the CUDA-core kernel named in its place."""
    cfg = dataclasses.replace(ARCHS[LM_ARCH], dtype="float32")
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=LM_PROMPT + 8))
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).cuda()}

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t0) * 1e3

    def counted(fn):
        for kern in FA_KERNELS:
            kern.launches = 0
        out = fn()
        return out, {kern.name: kern.launches for kern in FA_KERNELS}

    torch.cuda.reset_peak_memory_stats()
    (logits, cold_ms), launches = counted(prefill)
    peak = torch.cuda.max_memory_allocated()
    want = {kern.name: cfg.num_layers * int(kern is FLASH_TF32X3)
            for kern in FA_KERNELS}
    if launches != want:
        raise AssertionError(f"the fp32 prefill launched {launches}, not "
                             f"{want}")
    if (logits.dtype != torch.float32 or logits.shape[0] != LM_BATCH
            or logits.shape[-1] != cfg.vocab_size):
        raise AssertionError(f"logits {logits.dtype} {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite fp32 logits")
    _, warm_ms = prefill()
    split = device_time_split(lambda: model.prefill(params, batch))
    split["flash_share"] = split["flash_ms"] / split["busy_ms"]

    def cuda_cores(i, orig, q, k, v, *args, **kw):
        return flash_attention_fwd_cuda(
            q, k, v, scale=kw["scale"], window=kw["window"],
            causal=kw["causal"], variant="simt")

    with flash_calls(cuda_cores):
        (simt_logits, simt_ms), simt_launches = counted(prefill)
    want = {kern.name: cfg.num_layers * int(kern is FLASH_SIMT)
            for kern in FA_KERNELS}
    if simt_launches != want:
        raise AssertionError(f"the fp32 prefill with the CUDA-core kernel "
                             f"named launched {simt_launches}, not {want}")
    row = {
        "arch": LM_ARCH, "params": cfg.param_count(), "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "init_s": init_s,
        "prefill_cold_ms": cold_ms, "prefill_ms": warm_ms,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / (warm_ms / 1e3),
        "prefill_cuda_core_ms": simt_ms, "peak_mem_gb": peak / 1e9,
        "launches": launches, "launches_cuda_core": simt_launches,
        "logits_max_abs": float(logits.abs().max()),
        "cuda_core_vs_tf32x3_logits_max_abs": float(
            (simt_logits - logits).abs().max())}
    log("fp32_prefill " + json.dumps(row))
    log("fp32_prefill_device " + json.dumps(split))
    del params, logits, simt_logits, model
    torch.cuda.empty_cache()
    return row, split


def small_lm(steps):
    cfg = ARCHS[LM_ARCH].reduced(dtype="float32")
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=150 + steps + 8))
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, 150, seed=1).batch(LM_BATCH)["tokens"])
    return model, model.init(seed=0, device="cpu"), prompts


def phase_lm_checks():
    """Reduced llama3.2-3b in fp32 (150-token prompts: three query tiles,
    the last one ragged).  Decode against the full forward on the card,
    then the serve loop on the card against the CPU, and against the
    card with a planted GQA fault."""
    steps = 8
    model, params, prompts = small_lm(steps)
    cuda = torch.device("cuda")
    p_card = tree_map(lambda t: t.to(cuda), params)
    full, _ = model.prefill(p_card, {"tokens": prompts.to(cuda)})
    _, caches = model.prefill(p_card, {"tokens": prompts[:, :-1].to(cuda)})
    dec, _ = model.decode_step(p_card, prompts[:, -1:].to(cuda), caches,
                               prompts.shape[1] - 1)
    torch.cuda.synchronize()
    check_close("decode_step vs prefill", dec, full, 2e-3)
    dec_err = float((dec - full).abs().max())

    cpu_logits, cpu_toks, *_ = serve(model, params, prompts, steps,
                                     torch.device("cpu"))
    for kern in FA_KERNELS:
        kern.launches = 0
    card_logits, card_toks, *_ = serve(model, p_card, prompts.to(cuda),
                                       steps, cuda)
    tf32_launches = FLASH_TF32X3.launches
    if (tf32_launches != model.cfg.num_layers
            or sum(kern.launches for kern in FA_KERNELS) != tf32_launches):
        raise AssertionError(
            f"the fp32 serve loop launched "
            f"{ {kern.name: kern.launches for kern in FA_KERNELS} }, not "
            f"{model.cfg.num_layers} of the 3xTF32 flash kernel alone")

    def roll_first(i, orig, q, k, v, *args, **kw):
        if i == 0:      # the KV heads of the first layer, one head off
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        return orig(q, k, v, *args, **kw)

    with flash_calls(roll_first) as n:
        bad_logits, bad_toks, *_ = serve(model, p_card, prompts.to(cuda),
                                         steps, cuda)
    if n[0] == 0:
        raise AssertionError("the planted fault never fired")
    with flash_calls(roll_first):     # the same fault in the plain version
        bad_cpu, bad_cpu_toks, *_ = serve(model, params, prompts, steps,
                                          torch.device("cpu"))
    sound = float((card_logits.cpu() - cpu_logits).abs().max())
    planted = float((bad_logits.cpu() - cpu_logits).abs().max())
    both_planted = float((bad_logits.cpu() - bad_cpu).abs().max())
    same_tokens = bool((card_toks.cpu() == cpu_toks).all())
    log("lm_parity " + json.dumps({
        "decode_vs_prefill_max_abs": dec_err, "max_abs_diff": sound,
        "planted_fault_max_abs_diff": planted,
        "planted_card_vs_planted_cpu": both_planted,
        "planted_same_tokens": bool((bad_toks.cpu() == bad_cpu_toks).all()),
        "atol": LM_PARITY_ATOL, "same_greedy_tokens": same_tokens,
        "steps": steps, "flash_tf32x3_launches": tf32_launches}))
    if not both_planted <= LM_PARITY_ATOL:
        raise AssertionError(f"with the planted fault, card vs CPU logits: "
                             f"{both_planted:.3e} > {LM_PARITY_ATOL}")
    if not same_tokens:
        raise AssertionError("card and CPU chose different greedy tokens")
    if not sound <= LM_PARITY_ATOL:
        raise AssertionError(f"card vs CPU logits: {sound:.3e} > "
                             f"{LM_PARITY_ATOL}")
    if not planted > LM_PARITY_ATOL:
        raise AssertionError(f"rolled KV heads moved the logits by "
                             f"{planted:.3e}, inside {LM_PARITY_ATOL}")
    return tf32_launches


# ---------------------------------------------------------------------------
# phase 18: MoE / MLA serving (deepseek-v2-lite-16b)
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v2-lite-16b"
#: dense against no-drop ep at full width in bf16, last-position logits,
#: rtol = atol: the bf16 logit tolerance of tests/test_torch_lm.py (the
#: two dispatches combine alike and are expected to agree bit for bit)
MOE_DENSE_EP_TOL = 6e-2
INIT_PEAK_LIMIT = 1.2        # init peak over the params' bytes


def mla_norm_params(cfg) -> int:
    """Params of the MLA norm scales (kv_a_norm, q_a_norm), which the
    tree holds and ``ArchConfig.param_count`` leaves out, as in the JAX
    package."""
    return cfg.num_layers * (cfg.mla.kv_lora_rank + cfg.mla.q_lora_rank)


@contextlib.contextmanager
def moe_watch(plant=None):
    """Record each MoE block's router indices, smallest top-k margin and
    tokens tied across the top-k boundary and, under ep, its capacity
    and dropped assignments (tensors, read after the run).  ``plant(i, idx)`` may replace the router's indices
    of the i-th block called."""
    orig_router, orig_route = moe_mod.router_probs, moe_mod.ep_route
    rec = {"idx": [], "margin": [], "ties": [], "cap": [], "dropped": []}

    def router(w, x, k):
        gates, idx, probs = orig_router(w, x, k)
        top = torch.topk(probs, k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        rec["margin"].append(gap.min())
        rec["ties"].append((gap == 0).sum())
        if plant is not None:
            idx = plant(len(rec["idx"]), idx)
        rec["idx"].append(idx)
        return gates, idx, probs

    def route(moe, gates, idx):
        sel, sel_gate, rows = orig_route(moe, gates, idx)
        rec["cap"].append(sel.shape[1])
        rec["dropped"].append((rows < 0).sum())
        return sel, sel_gate, rows

    moe_mod.router_probs, moe_mod.ep_route = router, route
    try:
        yield rec
    finally:
        moe_mod.router_probs, moe_mod.ep_route = orig_router, orig_route


def drop_counts(dropped, n_moe):
    """Per MoE layer: the assignments dropped over whole passes of the
    model (a pass calls every MoE layer once, in order), and the
    total."""
    dropped = [int(d) for d in dropped]
    per_layer = [sum(dropped[i::n_moe]) for i in range(n_moe)]
    return per_layer, sum(per_layer)


def min_margin(rec) -> float:
    return float(torch.stack([m.float() for m in rec["margin"]]).min())


def boundary_ties(rec) -> int:
    return int(sum(int(t) for t in rec["ties"]))


@contextlib.contextmanager
def labelled(module, names):
    """Run ``module``'s functions ``names`` (name -> label) inside
    ``torch.profiler`` ranges of those labels."""
    from torch.profiler import record_function

    orig = {n: getattr(module, n) for n in names}

    def wrap(fn, label):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    for n, label in names.items():
        setattr(module, n, wrap(orig[n], label))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(module, n, fn)


GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def is_gemm(name: str) -> bool:
    name = name.lower()
    return any(t in name for t in GEMM_NAMES)


def innermost(intervals, queries):
    """One thread's call stack: ``intervals`` (start, end, value), nested
    as calls nest; ``queries`` (t, key).  -> {key: the value of the
    innermost interval around t, or None}, in one sweep."""
    intervals.sort(key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries):
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def kernel_ranges(events, ranges):
    """The profiler's raw (kineto) events and ``ranges`` (range label ->
    key) -> [(kernel name, device us, its range's key or None, whether
    its launch is in the trace)] for each
    device event but the ranges' own spans on the device.  A kernel takes
    the innermost range around the host op that launched it (linked
    through the CUDA call's correlation id); failing that, a kernel
    launched by an autograd node takes the range of the forward op the
    node differentiates (its sequence number and forward thread), and a
    recompute under a checkpoint, inside a backward node, takes the
    range of its own call.  Reading the raw events, not
    ``prof.events()``, keeps the profiler's tree of Python objects out:
    a round of 150 k kernels spent tens of seconds building it."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    from torch.profiler import DeviceType

    ops, links, kernels = {}, {}, []
    spans = collections.defaultdict(list)     # thread -> range intervals
    nodes = collections.defaultdict(list)     # thread -> autograd nodes
    fwd_ops = collections.defaultdict(list)   # thread -> (t, seq) queries
    for e in events:
        name = e.name()
        if _filter_name(name) or e.is_hidden_event():
            continue
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation() and name not in ranges:
                kernels.append((_rewrite_name(name, with_wildcard=True),
                                (e.end_ns() - e.start_ns()) / 1e3,
                                e.correlation_id()))
            continue
        th, t0, t1 = e.start_thread_id(), e.start_ns(), e.end_ns()
        if name.startswith("cu"):     # a CUDA call: on its op's thread
            links[e.correlation_id()] = (e.linked_correlation_id(), th, t0)
            continue
        ops[e.correlation_id()] = th
        if name in ranges:
            spans[th].append((t0, t1, ranges[name]))
        elif name.startswith("autograd::engine::evaluate_function"):
            nodes[th].append((t0, t1, (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0 and not name.startswith("autograd::"):
            fwd_ops[th].append((t0, (th, e.sequence_nr())))
    # the range of each forward op an autograd node may differentiate
    forward = {}
    for th, queries in fwd_ops.items():
        for op, key in innermost(spans[th], queries).items():
            if key is not None:
                forward[op] = key
    # each CUDA call on the thread of the op it serves
    calls = collections.defaultdict(list)
    for corr, (op, th, t) in links.items():
        calls[ops.get(op, th)].append((t, corr))
    key = {}
    for th, queries in calls.items():
        in_range = innermost(spans[th], queries)
        node = innermost(nodes[th], queries)
        for _, corr in queries:
            key[corr] = in_range[corr] or forward.get(node[corr])
    return [(name, us, key.get(corr), corr in links)
            for name, us, corr in kernels]


def range_split(fn, keys, patches, ranges, override, fallback):
    """``fn()`` once under torch.profiler, its device ms split into
    ``keys``.  ``patches``: (module or class, {function: range label})
    pairs whose functions run inside ``torch.profiler`` ranges of those
    labels; ``ranges``: range label -> key.  Each device event (a range's
    own span on the device excepted) is counted once: under
    ``override(name)`` where that names a key, else under its range
    (``kernel_ranges``: the innermost range around the CUDA call that
    launched it, or for a backward kernel the range of the forward op it
    differentiates), else under ``fallback(name)`` (so is a kernel whose
    call is not in the trace, ``unlinked_kernels``).  The events' own
    kernel lists are not used: the profiler hands a kernel to every host
    event that shares its op's id, CUPTI's "Command Buffer Full" among
    them, which counted the kernels of a host that runs ahead twice.
    -> the split with the kernel count, wall time, the device's idle
    share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for module, names in patches:
            stack.enter_context(labelled(module, names))
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = dict.fromkeys(keys, 0.0)
    by_name, kernels, unlinked = collections.Counter(), 0, 0
    for name, us, key, linked in kernel_ranges(
            prof.profiler.kineto_results.events(), ranges):
        by_name[name] += us
        kernels += 1
        unlinked += not linked
        split[override(name) or key or fallback(name)] += us / 1e3
    busy = sum(split.values())
    top = [(us / 1e3, name[:80]) for name, us in by_name.most_common(8)]
    split.update(kernels=kernels, unlinked_kernels=unlinked,
                 wall_ms=wall * 1e3, busy_ms=busy,
                 idle_share=1.0 - busy / (wall * 1e3), top=top)
    return split


def moe_split(fn):
    """``fn()`` once under torch.profiler (``range_split``): device ms of
    the attention core (the blockwise scan, ``flash_vjp.*``; the
    absorbed scores, softmax and latent output of a decode step), of the
    experts' products, of the MoE routing, gather and scatter (the
    block's dispatch but the experts), of the quantize and dequantize
    kernels, of the other matrix products (projections, shared experts,
    unembedding) and of the rest; kernel count, wall time and the
    device's idle share."""
    ranges = {"flash_vjp.forward": "attention_ms",
              "flash_vjp.backward": "attention_ms",
              "mla.attend": "attention_ms", "moe.experts": "experts_ms",
              "moe.route": "moe_dispatch_ms",
              "moe.dispatch": "moe_dispatch_ms"}
    return range_split(
        fn, ("attention_ms", "experts_ms", "moe_dispatch_ms", "quantize_ms",
             "matmul_ms", "other_ms"),
        [(moe_mod, {"router_probs": "moe.route", "_moe_ep": "moe.dispatch",
                    "_moe_dense": "moe.dispatch", "_experts": "moe.experts"}),
         (moe_mod.Route, {"choose": "moe.route"}),
         (mla_mod, {"_attend_latent": "mla.attend"})],
        ranges,
        override=lambda n: ("quantize_ms" if "quantize_kernel" in n.lower()
                            else None),
        fallback=lambda n: "matmul_ms" if is_gemm(n) else "other_ms")


def moe_model(cfg, impl="ep", cap=LM_PROMPT + LM_STEPS + 8, **moe_over):
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return build_model(cfg, ModelOptions(
        attn_impl="pallas", moe_impl=impl, mesh=make_host_mesh(),
        remat=False, prefill_cache_capacity=cap))


def bits_equal_trees(a, b) -> bool:
    return all(bits_equal(x, y) for x, y in zip(tree_leaves(a),
                                                tree_leaves(b)))


def phase_moe_serve(copy_bps):
    """Full-width deepseek-v2-lite-16b (bf16, random params from seed 0
    drawn on the card): ep serving (prefill 4 x 2000, 32 greedy decode
    steps) with its drops, device split and memory; then dense against
    no-drop ep at full width; then the reduced config in fp32 on the
    card against the CPU, with a planted routing fault."""
    cfg = ARCHS[MOE_ARCH]
    n_moe = sum(cfg.moe_layer_flags())
    model = moe_model(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    leaves = tree_leaves(params)
    n_params = sum(l.numel() for l in leaves)
    param_bytes = sum(l.numel() * l.element_size() for l in leaves)
    if n_params != cfg.param_count() + mla_norm_params(cfg):
        raise AssertionError(
            f"{MOE_ARCH} has {n_params} params, the config counts "
            f"{cfg.param_count()} + {mla_norm_params(cfg)} MLA norm scales")
    if init_peak > INIT_PEAK_LIMIT * param_bytes:
        raise AssertionError(f"init peaked at {init_peak / 1e9:.2f} GB for "
                             f"{param_bytes / 1e9:.2f} GB of params")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    cuda = torch.device("cuda")

    # (a) the production dispatch: the flash counts around the cold loop
    torch.cuda.reset_peak_memory_stats()
    for kern in FA_KERNELS:
        kern.launches = 0
    logits, toks, prefill_s, lat, caches = serve(model, params, prompts,
                                                 LM_STEPS, cuda)
    launches = {kern.name: kern.launches for kern in FA_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"MLA launched flash kernels: {launches}")
    if tuple(logits.shape) != (LM_BATCH, 1 + LM_STEPS, cfg.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    warm, warm_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.append(model.prefill(params, {"tokens": prompts}))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    warm_s = min(warm_s)
    twice = bits_equal(warm[0][0], warm[1][0]) and bits_equal_trees(
        warm[0][1], warm[1][1])
    if not twice:
        raise AssertionError("two ep prefills differ")
    del warm
    with moe_watch() as rec:
        w_logits, w_toks, *_ = serve(model, params, prompts, LM_STEPS, cuda)
    pre_layers, pre_total = drop_counts(rec["dropped"][:n_moe], n_moe)
    dec_layers, dec_total = drop_counts(rec["dropped"][n_moe:], n_moe)
    lat_ms = sorted(x * 1e3 for x in lat)
    row = {
        "arch": MOE_ARCH, "params": n_params, "param_bytes": param_bytes,
        "config_param_count": cfg.param_count(), "dtype": cfg.dtype,
        "moe_impl": "ep", "batch": LM_BATCH, "prompt": LM_PROMPT,
        "steps": LM_STEPS, "init_s": init_s, "init_peak_gb": init_peak / 1e9,
        "init_peak_over_params": init_peak / param_bytes,
        "prefill_cold_ms": prefill_s * 1e3, "prefill_ms": warm_s * 1e3,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / warm_s,
        "decode_first_ms": lat[0] * 1e3,
        "decode_p50_ms": float(np.percentile(lat_ms, 50)),
        "decode_p99_ms": float(np.percentile(lat_ms, 99)),
        "decode_tok_s": LM_BATCH * LM_STEPS / sum(lat),
        "mla_cache_bytes": cache_bytes, "peak_mem_gb": peak / 1e9,
        "flash_launches": launches, "two_prefills_bit_equal": twice,
        "watched_run_bit_equal": bits_equal(w_logits, logits),
        "ep_prefill": {"cap": rec["cap"][0], "assignments":
                       LM_BATCH * LM_PROMPT * cfg.moe.top_k * n_moe,
                       "dropped": pre_layers, "total": pre_total},
        "ep_decode": {"cap": rec["cap"][n_moe], "assignments":
                      LM_BATCH * cfg.moe.top_k * n_moe * LM_STEPS,
                      "dropped": dec_layers, "total": dec_total},
        "router_min_margin": min_margin(rec),
        "router_boundary_ties": boundary_ties(rec),
        "tokens_0": toks[0, :8].tolist()}
    del rec, w_logits
    if not row["watched_run_bit_equal"] or not bool((w_toks == toks).all()):
        raise AssertionError("the ep serve loop is not deterministic")
    log("moe_serve " + json.dumps(row))
    log("moe_serve_prefill_device " + json.dumps(moe_split(
        lambda: model.prefill(params, {"tokens": prompts}))))
    tok = toks[:, -1:]
    split = moe_split(lambda: model.decode_step(
        params, tok, caches, LM_PROMPT + LM_STEPS))
    # the least a decode step can take: every weight read once
    split["weight_read_ms"] = param_bytes / copy_bps * 1e3
    log("moe_serve_decode_device " + json.dumps(split))
    del logits, caches

    # (b) dense against ep at capacity factor E / k (no drops)
    batch = {"tokens": prompts}
    with moe_watch() as dense_rec:
        dense_logits, _ = moe_model(cfg, "dense").prefill(params, batch)
    no_drop = cfg.moe.num_experts / cfg.moe.top_k
    with moe_watch() as ep_rec:
        ep_logits, _ = moe_model(cfg, capacity_factor=no_drop).prefill(
            params, batch)
    same_idx = [bool(torch.equal(a, b)) for a, b in
                zip(dense_rec["idx"], ep_rec["idx"])]
    oracle = {
        "capacity_factor": no_drop, "cap": ep_rec["cap"][0],
        "dropped": drop_counts(ep_rec["dropped"], n_moe)[1],
        "logits_max_abs_diff": float((dense_logits - ep_logits).abs().max()),
        "logits_max_abs": float(dense_logits.abs().max()),
        "tol": MOE_DENSE_EP_TOL, "router_idx_equal_layers": sum(same_idx),
        "moe_layers": n_moe, "bit_equal": bits_equal(dense_logits, ep_logits),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("moe_oracle " + json.dumps(oracle))
    del dense_rec, ep_rec, params
    torch.cuda.empty_cache()
    if oracle["dropped"]:
        raise AssertionError(f"ep at capacity factor {no_drop} dropped "
                             f"{oracle['dropped']} assignments")
    if not all(same_idx):
        raise AssertionError(f"dense and no-drop ep routed differently in "
                             f"{n_moe - sum(same_idx)} of {n_moe} layers")
    if not oracle["logits_max_abs_diff"] <= MOE_DENSE_EP_TOL * (
            1 + oracle["logits_max_abs"]):
        raise AssertionError(f"dense vs no-drop ep logits "
                             f"{oracle['logits_max_abs_diff']:.3e}")
    phase_moe_parity()
    return row


def phase_moe_parity():
    """Reduced deepseek-v2-lite-16b in fp32 (150-token prompts): decode
    against the full forward on the card under dense dispatch (the JAX
    package's 2e-3); the ep serve loop on the card against the CPU
    within ``LM_PARITY_ATOL`` with the same greedy tokens; and the loop
    with every token's expert index rolled by one in the first MoE layer,
    which must land above it on both sides and agree across them."""
    steps = 8
    cfg = ARCHS[MOE_ARCH].reduced(dtype="float32")
    n_moe = sum(cfg.moe_layer_flags())
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, 150, seed=1).batch(LM_BATCH)["tokens"])
    cap = 150 + steps + 8
    dense, ep = moe_model(cfg, "dense", cap), moe_model(cfg, "ep", cap)
    params = ep.init(seed=0, device="cpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    p_card = tree_map(lambda t: t.to(cuda), params)
    full, _ = dense.prefill(p_card, {"tokens": prompts.to(cuda)})
    _, caches = dense.prefill(p_card, {"tokens": prompts[:, :-1].to(cuda)})
    dec, _ = dense.decode_step(p_card, prompts[:, -1:].to(cuda), caches,
                               prompts.shape[1] - 1)
    torch.cuda.synchronize()
    check_close("MoE decode_step vs prefill", dec, full, 2e-3)

    with moe_watch() as cpu_rec:
        cpu_logits, cpu_toks, *_ = serve(ep, params, prompts, steps, cpu)
    with moe_watch() as card_rec:
        card_logits, card_toks, *_ = serve(ep, p_card, prompts.to(cuda),
                                           steps, cuda)

    def roll_first(i, idx):
        return (idx + 1) % cfg.moe.num_experts if i % n_moe == 0 else idx

    with moe_watch(roll_first) as bad_rec:
        bad_logits, bad_toks, *_ = serve(ep, p_card, prompts.to(cuda), steps,
                                         cuda)
    with moe_watch(roll_first):
        bad_cpu, bad_cpu_toks, *_ = serve(ep, params, prompts, steps, cpu)
    sound = float((card_logits.cpu() - cpu_logits).abs().max())
    planted = float((bad_logits.cpu() - cpu_logits).abs().max())
    both_planted = float((bad_logits.cpu() - bad_cpu).abs().max())
    same_tokens = bool((card_toks.cpu() == cpu_toks).all())
    log("moe_parity " + json.dumps({
        "decode_vs_prefill_max_abs": float((dec - full).abs().max()),
        "max_abs_diff": sound, "planted_fault_max_abs_diff": planted,
        "planted_card_vs_planted_cpu": both_planted,
        "planted_calls": len(bad_rec["idx"]),
        "planted_same_tokens": bool((bad_toks.cpu() == bad_cpu_toks).all()),
        "atol": LM_PARITY_ATOL, "same_greedy_tokens": same_tokens,
        "steps": steps, "router_min_margin_card": min_margin(card_rec),
        "router_min_margin_cpu": min_margin(cpu_rec),
        "router_boundary_ties_card": boundary_ties(card_rec),
        "ep_dropped_card": drop_counts(card_rec["dropped"], n_moe)[1],
        "ep_dropped_cpu": drop_counts(cpu_rec["dropped"], n_moe)[1]}))
    if not both_planted <= LM_PARITY_ATOL:
        raise AssertionError(f"with the planted fault, card vs CPU logits: "
                             f"{both_planted:.3e} > {LM_PARITY_ATOL}")
    if not same_tokens:
        raise AssertionError("card and CPU chose different greedy tokens")
    if not sound <= LM_PARITY_ATOL:
        raise AssertionError(f"card vs CPU logits: {sound:.3e} > "
                             f"{LM_PARITY_ATOL}")
    if not planted > LM_PARITY_ATOL:
        raise AssertionError(f"rolled expert indices moved the logits by "
                             f"{planted:.3e}, inside {LM_PARITY_ATOL}")


# ---------------------------------------------------------------------------
# phases 10-12: the int8 quantize kernels and the fused round
# ---------------------------------------------------------------------------


def bits_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


def quant_case(label, x, block):
    """The quantize and dequantize kernels on ``x`` (flat) against their
    plain versions: q, scales and the dequantized values (fp32 and bf16)
    bit-equal, and |x - deq| <= s/2."""
    n = x.numel()
    n0 = (QUANTIZE.launches, DEQUANTIZE.launches)
    q, s = q_ops.quantize(x, block=block, impl="cuda")
    qr, sr = q_ops.quantize(x, block=block, impl="torch")
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        outs[dt] = (q_ops.dequantize(q, s, n, out_dtype=dt, impl="cuda"),
                    q_ops.dequantize(q, s, n, out_dtype=dt, impl="torch"))
    torch.cuda.synchronize()
    if (QUANTIZE.launches, DEQUANTIZE.launches) != (n0[0] + 1, n0[1] + 2):
        raise AssertionError(f"quant[{label}]: the kernels did not launch")
    err = (outs[torch.float32][0] - x.float()).abs()
    bound = s.repeat_interleave(block)[:n] / 2
    row = {"case": label, "N": n, "block": block,
           "dtype": str(x.dtype).replace("torch.", ""),
           "q_equal": bits_equal(q, qr), "scales_equal": bits_equal(s, sr),
           "deq_f32_equal": bits_equal(*outs[torch.float32]),
           "deq_bf16_equal": bits_equal(*outs[torch.bfloat16]),
           "max_err_over_half_scale": float((err - bound).max()),
           "zero_rows": int((s == 1.0).sum())}
    if not (row["q_equal"] and row["scales_equal"] and row["deq_f32_equal"]
            and row["deq_bf16_equal"]):
        raise AssertionError(f"quant[{label}]: kernel and plain version "
                             f"differ: {row}")
    if not row["max_err_over_half_scale"] <= 1e-7:
        raise AssertionError(f"quant[{label}]: |x - deq| > s/2: {row}")
    return row


def phase_quant():
    """The quantize kernels at the JAX package's kernel-test sizes, an
    all-zero input, bf16 input, row widths 64, 200 and 16 (an SSM's
    ``A_log``) and leaves of 3200 and 8192 (``D``, ``dt_bias``); then at the
    fused round's largest delta leaf, the (128256, 3072) fp32 embedding
    (1,539,072 rows of 256), timed against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda") * 3
    cases = [("n256", rnd(256), 256), ("n773", rnd(3 * 256 + 5), 256),
             ("n100", rnd(100), 256), ("n70000", rnd(70000), 256),
             ("zeros", torch.zeros(512, device="cuda"), 256),
             ("bf16", rnd(3 * 256 + 5).to(torch.bfloat16), 256),
             ("b64", rnd(64 * 37 + 9), 64), ("b200", rnd(200 * 11), 200),
             # the SSM rounds' leaves (phase 23): A_log's rows of N = 16
             # (falcon-mamba-7b's 8192 a layer), and D and dt_bias, rows
             # of d_inner (hymba-1.5b 3200, falcon-mamba-7b 8192)
             ("b16_a_log", rnd(2 * 8192 * 16), 16),
             ("n3200", rnd(3200), 256), ("n8192", rnd(8192), 256)]
    for label, x, block in cases:
        log("quant_case " + json.dumps(quant_case(label, x, block)))

    cfg = ARCHS[LM_ARCH]
    x = torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                    device="cuda") * 1e-3
    row = quant_case("path_embedding", x.reshape(-1), 256)
    blocks = x.view(-1, 256)
    rows, n = blocks.shape[0], x.numel()
    q, s = quantize_cuda(blocks)
    deq = dequantize_cuda(q, s)
    torch.cuda.synchronize()
    deq_err = float((deq - q_ref.dequantize_ref(q, s)).abs().max())
    q_err = float((q.float() - q_ref.quantize_ref(blocks)[0].float())
                  .abs().max())
    nbytes = 5 * n + 4 * rows          # fp32 in, int8 + scales out (or back)
    out = {}
    for name, run, plain, library, ops_n, err in (
            ("quantize", lambda: quantize_cuda(blocks),
             lambda: q_ref.quantize_ref(blocks), None, 5 * n, q_err),
            ("dequantize", lambda: dequantize_cuda(q, s),
             lambda: q_ref.dequantize_ref(q, s),
             lambda: torch.mul(q, s[:, None]), n, deq_err)):
        b_s, o_s = nbytes / NOMINAL_BPS, ops_n / FP32_FLOPS
        out[name] = {
            "shape": [cfg.vocab_size, cfg.d_model], "rows": rows,
            "block": 256, "max_abs_err": err,
            "ms": time_ms(run, reps=15), "plain_ms": time_ms(plain, reps=5),
            "library_ms": time_ms(library, reps=15) if library else None,
            "bytes": nbytes, "ops": ops_n,
            "bound_ms": max(b_s, o_s) * 1e3,
            "bound_by": "bytes" if b_s >= o_s else "operations"}
        log(f"quant_path_{name} " + json.dumps(out[name]))
    del x, blocks, q, s, deq
    torch.cuda.empty_cache()
    return row, out


def all_kernels():
    return (*fed.KERNELS, *FA_KERNELS, *Q_KERNELS)


def fused_split(fn):
    """``fn()`` once under torch.profiler: device ms of the quantize and
    dequantize kernels, of matrix products and of the rest (by kernel
    name, each kernel counted once); the flash VJP's device ms (the
    ``flash_vjp.*`` ranges, whose kernels are also among the matmuls and
    the rest); the kernel count, the wall time and the idle share."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"quantize_ms": 0.0, "dequantize_ms": 0.0, "matmul_ms": 0.0,
             "other_ms": 0.0}
    flash_vjp, kernels, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.key.startswith("flash_vjp."):
            if e.device_type == DeviceType.CPU:
                flash_vjp += e.device_time_total / 1e3
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "dequantize_kernel" in name:
            split["dequantize_ms"] += ms
        elif "quantize_kernel" in name:
            split["quantize_ms"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
        kernels += e.count
        top.append((ms, e.key[:80], e.count))
    busy = sum(split.values())
    split.update(flash_vjp_ms=flash_vjp, kernels=kernels, wall_ms=wall * 1e3,
                 busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3),
                 top=sorted(top, reverse=True)[:8])
    return split


ROUND_MESH = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))


def round_agg(compress="int8"):
    return AggregationConfig(hierarchy="hierarchical", timing="eager",
                             compress=compress, num_microbatches=2,
                             server_opt="fedavg")


def round_setup(cfg, seq_len, device, compress="int8", opts=None):
    """A trainer on the 2-pod mesh and the round's batch: 8 sequences of
    ``seq_len`` tokens and, for a frontend config, the stub's embeddings
    ``normal(0, 0.02)`` from seed 2 under ``"frontend"``, as a caller
    hands them over."""
    trainer = FusedFLTrainer(cfg, ROUND_MESH, round_agg(compress),
                             opts=opts, device=device)
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=seq_len,
                              n_cohorts=4).round_batch(8, 0)
    if cfg.frontend:
        batch["frontend"] = front_embeddings(cfg, 8, 2, "cpu").numpy()
    return trainer, batch


def timed_round(trainer, params, batch):
    """One round from ``params``: -> (metrics record, wall s)."""
    trainer.params = params
    trainer.server_state = init_server_state("fedavg", params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = trainer.train_round(batch)
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def driven_round(trainer, params, batch):
    """One round from ``params`` with every launch count zeroed just
    before and read just after: -> (metrics record, wall s, launches,
    peak device bytes)."""
    for k in all_kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec, wall = timed_round(trainer, params, batch)
    launches = {k.name: k.launches for k in all_kernels()}
    return rec, wall, launches, torch.cuda.max_memory_allocated()


def check_int8_round(arch, leaves, int8, none):
    """The checks of an int8 round and a ``compress="none"`` round from
    the params ``leaves``, each given as (metrics record, params,
    launches): quantize and dequantize once per leaf and pod in the int8
    round and never in the other, finite metrics, params moved and
    finite, the int8 params within 5 % (relative) of the others.  -> that
    relative difference."""
    (rec8, p8, launches8), (recn, pn, launchesn) = int8, none
    want = 2 * len(leaves)
    for name in (QUANTIZE.name, DEQUANTIZE.name):
        if launches8[name] != want:
            raise AssertionError(f"{arch}: the int8 round launched {name} "
                                 f"{launches8[name]} times, not {want} "
                                 f"({len(leaves)} leaves x 2 pods)")
        if launchesn[name] != 0:
            raise AssertionError(f"{arch}: the uncompressed round launched "
                                 f"{name}")
    for tag, rec in (("int8", rec8), ("none", recn)):
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{arch}: {tag} round: non-finite metrics "
                                 f"{rec}")
    p8 = tree_leaves(p8)
    rel = max(float((a.float() - b.float()).abs().max()
                    / (b.float().abs().max() + 1e-9))
              for a, b in zip(p8, tree_leaves(pn)))
    moved = any(bool((a != b).any()) for a, b in zip(p8, leaves))
    if not (moved and all(bool(torch.isfinite(l).all()) for l in p8)):
        raise AssertionError(f"{arch}: the int8 round left non-finite or "
                             "unchanged params")
    if not rel < 0.05:
        raise AssertionError(f"{arch}: int8 vs none params: relative "
                             f"{rel:.3e} >= 0.05")
    return rel


def phase_fused_round():
    """Full-width llama3.2-3b (bf16, random params from seed 0): one
    hierarchical int8 round on a 2-pod mesh, each pod 4 sequences of 512
    tokens in 2 microbatches, then one ``compress="none"`` round from the
    same params; the int8 params must lie within 5 % (relative) of the
    uncompressed ones.  A second int8 round gives the warm time and a
    third the device split."""
    cfg = ARCHS[LM_ARCH]
    opts = ModelOptions(attn_impl="chunked", remat=True)
    t8, batch = round_setup(cfg, FUSED_SEQ, None, "int8", opts)
    tn, _ = round_setup(cfg, FUSED_SEQ, None, "none", opts)
    t0 = time.perf_counter()
    t8.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p0 = t8.params
    leaves = tree_leaves(p0)
    if sum(l.numel() for l in leaves) != cfg.param_count():
        raise AssertionError(f"{LM_ARCH}: {sum(l.numel() for l in leaves)} "
                             f"params, the config counts {cfg.param_count()}")

    rec8, cold_s, launches8, peak8 = driven_round(t8, p0, batch)
    p8 = t8.params
    recn, none_s, launchesn, peakn = driven_round(tn, p0, batch)
    pn = tn.params
    rel = check_int8_round(LM_ARCH, leaves, (rec8, p8, launches8),
                           (recn, pn, launchesn))
    del p8, pn
    tn.params = None
    warm8, warm_s, _, _ = driven_round(t8, p0, batch)
    t8.params = p0
    split = fused_split(lambda: timed_round(t8, p0, batch))
    row = {
        "arch": LM_ARCH, "params": sum(l.numel() for l in leaves),
        "leaves": len(leaves), "dtype": cfg.dtype, "pods": 2,
        "microbatches_per_pod": 2, "seqs_per_pod": 4, "seq_len": FUSED_SEQ,
        "init_s": init_s, "int8_cold_s": cold_s, "int8_warm_s": warm_s,
        "none_s": none_s, "peak_mem_gb_int8": peak8 / 1e9,
        "peak_mem_gb_none": peakn / 1e9,
        "int8": rec8, "none": recn, "int8_warm": warm8,
        "int8_vs_none_rel": rel, "launches_int8": launches8,
        "launches_none": launchesn}
    log("fused_round " + json.dumps(row))
    log("fused_round_device " + json.dumps(split))
    del p0, leaves
    t8.params = t8.server_state = None
    torch.cuda.empty_cache()
    return row, split


def pod_steps(trainer, batch):
    """Per element, the largest quantization step of its block over the
    pods' deltas of the round about to run: ``s / n_pods × server_lr``."""
    n_pods, agg = trainer.mesh.shape["pod"], trainer.agg
    steps = None
    for i in range(n_pods):
        b = {k: torch.as_tensor(v[i * len(v) // n_pods:
                                  (i + 1) * len(v) // n_pods],
                                device=trainer.device)
             for k, v in batch.items()}
        d, _, _ = accumulate_updates(trainer.model, trainer.params, b, agg)
        per = []
        for leaf in tree_leaves(d):
            _, safe, last = compression._quantize_blocks_last_axis(leaf, 256)
            st = safe.repeat_interleave(min(256, last), dim=-1)[..., :last]
            per.append(st.reshape(leaf.shape) / n_pods * agg.server_lr)
        steps = per if steps is None else [torch.maximum(a, c)
                                           for a, c in zip(steps, per)]
    return steps


def int8_limit(got, want, steps):
    """The two-part limit of an int8 round: (a) at most 0.1 % of
    elements differ by more than 1e-5; (b) none by more than one
    quantization step of its block (plus the 1e-5 of part a).  -> (share
    over 1e-5, largest difference in steps, whether both hold)."""
    d = torch.cat([(g.cpu().double() - w.cpu().double()).abs().reshape(-1)
                   for g, w in zip(got, want)])
    st = torch.cat([s.cpu().double().reshape(-1) for s in steps])
    share = float((d > 1e-5).double().mean())
    worst = float(((d - 1e-5) / st).max())
    return share, worst, share <= 1e-3 and worst <= 1.0


@contextlib.contextmanager
def pod_counted_twice():
    """A planted fault for the round check: the second pod's delta is
    counted twice in the cross-pod sum."""
    orig = compression.fake_quantize_tree
    calls = [0]

    def faulted(delta):
        calls[0] += 1
        leaves, treedef = tree_flatten(orig(delta))
        k = 2 if calls[0] == 2 else 1
        return tree_unflatten(treedef, [k * t for t in leaves])

    compression.fake_quantize_tree = faulted
    try:
        yield
    finally:
        compression.fake_quantize_tree = orig
    if calls[0] < 2:
        raise AssertionError("the planted fault never fired")


def phase_round_parity(arch=LM_ARCH, faults=(("pod_counted_twice",
                                               pod_counted_twice),),
                       label="round_parity", **opts_over):
    """Reduced ``arch`` in fp32: one hierarchical int8 round on the card
    (the kernels) against the same round on the CPU (the plain
    versions), from the same params; and on the card with each planted
    fault (a context manager), which must land above the limit.
    ``opts_over``: changes to ``build_train_step``'s options."""
    t_start = time.perf_counter()
    cfg = ARCHS[arch].reduced(dtype="float32")
    opts = dataclasses.replace(train_options(cfg, ROUND_MESH, round_agg()),
                               **opts_over) if opts_over else None
    cpu, batch = round_setup(cfg, 64, "cpu", opts=opts)
    cpu.init(seed=0)
    p_cpu = cpu.params
    steps = pod_steps(cpu, batch)
    card, _ = round_setup(cfg, 64, "cuda", opts=opts)
    p_card = tree_map(lambda t: t.to("cuda"), p_cpu)
    n0 = QUANTIZE.launches
    card_rec = timed_round(card, p_card, batch)[0]
    if QUANTIZE.launches == n0:
        raise AssertionError("the card's round did not launch the kernel")
    sound_params = tree_leaves(card.params)
    planted = {}
    for name, fault in faults:
        with fault():
            timed_round(card, p_card, batch)
        planted[name] = tree_leaves(card.params)
    cpu_rec = cpu.train_round(batch)
    want = tree_leaves(cpu.params)
    share, worst, ok = int8_limit(sound_params, want, steps)
    row = {"arch": arch, "loss_card": card_rec["loss"],
           "loss_cpu": cpu_rec["loss"], "share_over_1e-5": share,
           "worst_in_steps": worst,
           "limit": "share <= 1e-3 and worst <= 1 step",
           "wall_s": time.perf_counter() - t_start}
    inside = []
    for name, got in planted.items():
        f_share, f_worst, f_ok = int8_limit(got, want, steps)
        row[name] = {"share_over_1e-5": f_share, "worst_in_steps": f_worst}
        if f_ok:
            inside.append(name)
    log(f"{label} " + json.dumps(row))
    if not ok:
        raise AssertionError(f"card vs CPU int8 round outside its limit: "
                             f"{row}")
    if inside:
        raise AssertionError(f"planted faults stayed inside the limit: "
                             f"{inside}: {row}")
    if not abs(card_rec["loss"] - cpu_rec["loss"]) < 1e-5:
        raise AssertionError(f"card vs CPU loss: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 19: the MoE / MLA fused round (deepseek-v2-lite-16b)
# ---------------------------------------------------------------------------

#: the dense first layer and five MoE layers: training at full depth
#: (about 286 GB at the llama round's bytes a param) waits for
#: distribution (ROADMAP A.8)
MOE_ROUND_LAYERS = 6


@contextlib.contextmanager
def round_watch(plant=None):
    """Each MoE layer's forward in a round (a recompute under remat
    takes its forward's experts, ``moe.Route``, and is not counted): the
    router's smallest top-k margin, ep's capacity and dropped
    assignments (tensors, read after the run).  ``plant(i, idx)`` may
    replace the experts of the i-th forward of a layer."""
    choose, route = moe_mod.Route.choose, moe_mod.ep_route
    rec = {"forwards": 0, "margin": [], "cap": [], "dropped": []}
    state = {"forward": False}

    def watched_choose(self, idx, probs):
        state["forward"] = self.idx is None
        if state["forward"]:
            k = idx.shape[1]
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            rec["margin"].append((top[:, k - 1] - top[:, k]).min())
            if plant is not None:
                idx = plant(rec["forwards"], idx)
            rec["forwards"] += 1
        return choose(self, idx, probs)

    def watched_route(moe, gates, idx):
        sel, sel_gate, rows = route(moe, gates, idx)
        if state["forward"]:
            rec["cap"].append(sel.shape[1])
            rec["dropped"].append((rows < 0).sum())
        return sel, sel_gate, rows

    moe_mod.Route.choose, moe_mod.ep_route = watched_choose, watched_route
    try:
        yield rec
    finally:
        moe_mod.Route.choose, moe_mod.ep_route = choose, route


def experts_rolled(cfg):
    """A planted fault for the MoE round check: every token's experts
    rolled by one in the first MoE layer of each forward."""
    n_moe = sum(cfg.moe_layer_flags())

    def roll_first(i, idx):
        return (idx + 1) % cfg.moe.num_experts if i % n_moe == 0 else idx

    @contextlib.contextmanager
    def fault():
        with round_watch(roll_first) as rec:
            yield
        if not rec["forwards"]:
            raise AssertionError("the planted fault never fired")
    return fault


def phase_moe_round():
    """deepseek-v2-lite-16b at full width and 6 layers (bf16, random
    params from seed 0) through phase 11's round: the JAX package's
    ``build_train_step`` options (ep, ``chunked_sp``, remat), a 2-pod
    mesh, each pod 4 sequences of 512 tokens in 2 microbatches.  One int8
    round (launch counts zeroed just before and read just after; each
    MoE layer watched), one ``compress="none"`` round from the same
    params (the int8 params within 5 % relative of these), a warm int8
    round (bit-equal to the first), one under torch.profiler for the
    device split; then the quantize kernels at the largest expert leaf
    and the reduced round on the card against the CPU with two planted
    faults."""
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], num_layers=MOE_ROUND_LAYERS)
    n_moe = sum(cfg.moe_layer_flags())
    t8, batch = round_setup(cfg, FUSED_SEQ, None, "int8")
    tn, _ = round_setup(cfg, FUSED_SEQ, None, "none")
    t0 = time.perf_counter()
    t8.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p0 = t8.params
    leaves = tree_leaves(p0)
    n_params = sum(l.numel() for l in leaves)
    if n_params != cfg.param_count() + mla_norm_params(cfg):
        raise AssertionError(
            f"{MOE_ARCH} ({MOE_ROUND_LAYERS} layers): {n_params} params, "
            f"the config counts {cfg.param_count()} + "
            f"{mla_norm_params(cfg)} MLA norm scales")
    with round_watch() as watch8:
        rec8, cold_s, launches8, peak8 = driven_round(t8, p0, batch)
    p8 = t8.params
    recn, none_s, launchesn, peakn = driven_round(tn, p0, batch)
    pn = tn.params
    tn.params = None
    rel = check_int8_round(MOE_ARCH, leaves, (rec8, p8, launches8),
                           (recn, pn, launchesn))
    del pn
    warm8, warm_s, _, _ = driven_round(t8, p0, batch)
    twice = bits_equal_trees(p8, t8.params)
    del p8
    t8.params = None
    if not twice:
        raise AssertionError("two MoE int8 rounds from the same params "
                             "differ")
    split = moe_split(lambda: timed_round(t8, p0, batch))
    dropped = drop_counts(watch8["dropped"], n_moe)
    row = {
        "arch": MOE_ARCH, "layers": MOE_ROUND_LAYERS, "moe_layers": n_moe,
        "params": n_params, "config_param_count": cfg.param_count(),
        "leaves": len(leaves), "dtype": cfg.dtype, "pods": 2,
        "microbatches_per_pod": 2, "seqs_per_pod": 4, "seq_len": FUSED_SEQ,
        "opts": {k: getattr(t8.model.opts, k) for k in (
            "attn_impl", "moe_impl", "remat", "loss_chunk", "block_kv")},
        "init_s": init_s, "int8_cold_s": cold_s, "int8_warm_s": warm_s,
        "none_s": none_s, "peak_mem_gb_int8": peak8 / 1e9,
        "peak_mem_gb_none": peakn / 1e9, "int8": rec8, "none": recn,
        "int8_warm": warm8, "int8_vs_none_rel": rel,
        "two_int8_rounds_bit_equal": twice,
        "ep_cap": sorted(set(watch8["cap"])),
        "ep_forwards": watch8["forwards"],
        "ep_assignments": batch["tokens"].size * cfg.moe.top_k * n_moe,
        "ep_dropped_per_layer": dropped[0], "ep_dropped": dropped[1],
        "router_min_margin": min_margin(watch8),
        "launches_int8": launches8, "launches_none": launchesn}
    log("moe_round " + json.dumps(row))
    log("moe_round_device " + json.dumps(split))
    del p0, leaves, watch8
    t8.params = t8.server_state = tn.server_state = None
    torch.cuda.empty_cache()

    # the quantize kernels at the largest leaf: the experts' gate delta
    # of the round, (moe layers, E, d, f) fp32, its last axis padded to
    # whole blocks of 256 as fake_quantize_tree pads it
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n_moe, cfg.moe.num_experts, cfg.d_model,
                    cfg.moe.expert_d_ff, generator=g, device="cuda") * 1e-3
    last = x.shape[-1]
    x = F.pad(x, (0, -(-last // 256) * 256 - last))
    quant = quant_case("moe_expert_gate_delta", x.reshape(-1), 256)
    quant["shape"] = list(x.shape)
    log("quant_case " + json.dumps(quant))
    del x
    torch.cuda.empty_cache()
    parity = phase_round_parity(
        MOE_ARCH, (("pod_counted_twice", pod_counted_twice),
                   ("experts_rolled", experts_rolled(
                       ARCHS[MOE_ARCH].reduced()))),
        label="moe_round_parity")
    return row, split, parity


# ---------------------------------------------------------------------------
# phase 20: SSM / hybrid serving (falcon-mamba-7b, hymba-1.5b)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


def branch_norm_params(cfg) -> int:
    """Params of a hybrid layer's two branch norms, which the tree holds
    and ``ArchConfig.param_count`` leaves out, as in the JAX package."""
    return 2 * cfg.d_model * cfg.num_layers if cfg.hybrid_parallel_ssm else 0


def ssm_split(fn):
    """``fn()`` once under torch.profiler (``range_split``): device ms of
    the flash kernel and of matrix products (by kernel name), of the
    scan (``ssm_scan_chunked`` in a prefill; ``ssm_decode``, the state
    update, in a decode step), of the causal conv and of the rest;
    kernel count, wall time and the device's idle share."""
    def override(name):
        if "flash_fwd" in name.lower():
            return "flash_ms"
        return "matmul_ms" if is_gemm(name) else None

    return range_split(
        fn, ("flash_ms", "scan_ms", "conv_ms", "matmul_ms", "other_ms"),
        [(ssm_mod, {"ssm_scan_chunked": "ssm.scan", "ssm_decode": "ssm.scan",
                    "_causal_conv": "ssm.conv"})],
        {"ssm.scan": "scan_ms", "ssm.conv": "conv_ms"},
        override=override, fallback=lambda name: "other_ms")


def ssm_model(cfg, cap=LM_PROMPT + LM_STEPS + 8):
    return build_model(cfg, ModelOptions(attn_impl="pallas", remat=False,
                                         prefill_cache_capacity=cap))


def ssm_state(caches):
    """Each segment's SSM decode state: an SSM segment's cache, or a
    hybrid segment's ``ssm`` entry."""
    return [c.get("ssm", c) for c in caches]


def phase_ssm_cell(arch, copy_bps):
    """One full-width SSM or hybrid config (bf16, random params from seed
    0 drawn on the card): phase 7's prompts (4 x 2000 tokens) and 32
    greedy decode steps with every kernel count zeroed just before and
    read just after (a hybrid prefill launches the wgmma flash kernel
    once a layer, an SSM one no kernel); cold and warm prefill, decode
    p50 / p99, the decode state's bytes, the peak; two warm prefills
    bit-equal; a warm prefill and a decode step split by ``ssm_split``,
    the step beside the time to read every weight once; a hybrid's
    layer 0 (global) and layer 1 (windowed) q, k and v captured and the
    flash kernel held against its plain version on them.  -> (row,
    launches, flash rows)."""
    cfg = ARCHS[arch]
    model = ssm_model(cfg)
    cuda = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    leaves = tree_leaves(params)
    n_params = sum(l.numel() for l in leaves)
    param_bytes = sum(l.numel() * l.element_size() for l in leaves)
    if n_params != cfg.param_count() + branch_norm_params(cfg):
        raise AssertionError(
            f"{arch} has {n_params} params, the config counts "
            f"{cfg.param_count()} + {branch_norm_params(cfg)} branch norms")
    if init_peak > INIT_PEAK_LIMIT * param_bytes:
        raise AssertionError(f"init peaked at {init_peak / 1e9:.2f} GB for "
                             f"{param_bytes / 1e9:.2f} GB of params")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    captured = {}

    def capture(i, orig, q, k, v, *args, **kw):
        if i in (0, 1):
            captured[i] = (q.clone(), k.clone(), v.clone())
        return orig(q, k, v, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    with flash_calls(capture):
        for kern in all_kernels():
            kern.launches = 0
        logits, toks, prefill_s, lat, caches = serve(model, params, prompts,
                                                     LM_STEPS, cuda)
        launches = {kern.name: kern.launches for kern in all_kernels()}
    peak = torch.cuda.max_memory_allocated()
    attn_layers = 0 if cfg.attention_free else cfg.num_layers
    want = {kern.name: attn_layers * int(kern is FLASH_WGMMA)
            for kern in all_kernels()}
    if launches != want:
        raise AssertionError(f"{arch} launched {launches}, not {want}")
    if tuple(logits.shape) != (LM_BATCH, 1 + LM_STEPS, cfg.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    state = ssm_state(caches)
    state_bytes = {key: sum(s[key].numel() * s[key].element_size()
                            for s in state) for key in ("h", "conv")}
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    warm, warm_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.append(model.prefill(params, {"tokens": prompts}))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    warm_s = min(warm_s)
    twice = bits_equal(warm[0][0], warm[1][0]) and bits_equal_trees(
        warm[0][1], warm[1][1])
    del warm
    if not twice:
        raise AssertionError(f"{arch}: two warm prefills differ")
    lat_ms = sorted(x * 1e3 for x in lat)
    row = {
        "arch": arch, "params": n_params, "param_bytes": param_bytes,
        "config_param_count": cfg.param_count(), "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS,
        "scan_chunk": ssm_mod.scan_chunk(LM_PROMPT, model.opts.ssm_chunk),
        "init_s": init_s, "init_peak_gb": init_peak / 1e9,
        "prefill_cold_ms": prefill_s * 1e3, "prefill_ms": warm_s * 1e3,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / warm_s,
        "decode_first_ms": lat[0] * 1e3,
        "decode_p50_ms": float(np.percentile(lat_ms, 50)),
        "decode_p99_ms": float(np.percentile(lat_ms, 99)),
        "decode_tok_s": LM_BATCH * LM_STEPS / sum(lat),
        "ssm_state_bytes": state_bytes, "cache_bytes": cache_bytes,
        "peak_mem_gb": peak / 1e9,
        "launches": {k: n for k, n in launches.items() if n},
        "two_prefills_bit_equal": twice, "tokens_0": toks[0, :8].tolist()}
    log("ssm_serve " + json.dumps(row))
    log("ssm_serve_prefill_device " + json.dumps({"arch": arch, **ssm_split(
        lambda: model.prefill(params, {"tokens": prompts}))}))
    tok = toks[:, -1:]
    split = ssm_split(lambda: model.decode_step(params, tok, caches,
                                                LM_PROMPT + LM_STEPS))
    # the least a decode step can take: every weight read once
    split["weight_read_ms"] = param_bytes / copy_bps * 1e3
    log("ssm_serve_decode_device " + json.dumps({"arch": arch, **split}))
    del params, logits, caches, state
    windows = cfg.layer_windows()
    rows = [flash_row(f"{arch}_layer{i}", q, k, v, windows[i])
            for i, (q, k, v) in sorted(captured.items())]
    for r in rows:
        log("flash_case " + json.dumps(r))
    del captured
    torch.cuda.empty_cache()
    return row, launches, rows


class StateZeroed:
    """``model`` with layer 0's SSM state ``h`` zeroed after each prefill:
    a planted fault of the decode state."""

    def __init__(self, model):
        self.model = model

    def prefill(self, params, batch):
        logits, caches = self.model.prefill(params, batch)
        ssm_state(caches)[0]["h"][0].zero_()
        return logits, caches

    def decode_step(self, *args):
        return self.model.decode_step(*args)


def roll_first_kv(i, orig, q, k, v, *args, **kw):
    """A planted GQA fault: the first flash call's KV heads one head off."""
    if i == 0:
        k, v = k.roll(1, dims=2), v.roll(1, dims=2)
    return orig(q, k, v, *args, **kw)


def phase_ssm_parity(arch):
    """Reduced ``arch`` in fp32 (150-token prompts): on the card, prefill
    of S tokens against prefill of S - 1 plus ``decode_step`` (the JAX
    package's 2e-3); the serve loop on the card against the CPU within
    ``LM_PARITY_ATOL`` with the same greedy tokens; and the planted
    faults, layer 0's state zeroed after prefill and, for a hybrid, the
    first layer's KV heads rolled, each above the limit on the card and
    within it of the same fault on the CPU."""
    steps = 8
    cfg = ARCHS[arch].reduced(dtype="float32")
    model = ssm_model(cfg, cap=150 + steps + 8)
    params = model.init(seed=0, device="cpu")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, 150, seed=1).batch(LM_BATCH)["tokens"])
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    p_card = tree_map(lambda t: t.to(cuda), params)
    full, _ = model.prefill(p_card, {"tokens": prompts.to(cuda)})
    _, caches = model.prefill(p_card, {"tokens": prompts[:, :-1].to(cuda)})
    dec, _ = model.decode_step(p_card, prompts[:, -1:].to(cuda), caches,
                               prompts.shape[1] - 1)
    torch.cuda.synchronize()
    check_close(f"{arch} decode_step vs prefill", dec, full, 2e-3)
    cpu_logits, cpu_toks, *_ = serve(model, params, prompts, steps, cpu)
    for kern in FA_KERNELS:
        kern.launches = 0
    card_logits, card_toks, *_ = serve(model, p_card, prompts.to(cuda),
                                       steps, cuda)
    flash = {kern.name: kern.launches for kern in FA_KERNELS}
    faults = {"state_zeroed": (StateZeroed(model), contextlib.nullcontext)}
    if cfg.hybrid_parallel_ssm:
        faults["kv_heads_rolled"] = (model,
                                     lambda: flash_calls(roll_first_kv))
    planted = {}
    for name, (m, ctx) in faults.items():
        with ctx():
            bad, _, *_ = serve(m, p_card, prompts.to(cuda), steps, cuda)
        with ctx():
            bad_cpu, _, *_ = serve(m, params, prompts, steps, cpu)
        planted[name] = {
            "max_abs_diff": float((bad.cpu() - cpu_logits).abs().max()),
            "card_vs_cpu": float((bad.cpu() - bad_cpu).abs().max())}
    sound = float((card_logits.cpu() - cpu_logits).abs().max())
    same_tokens = bool((card_toks.cpu() == cpu_toks).all())
    log("ssm_parity " + json.dumps({
        "arch": arch, "decode_vs_prefill_max_abs": float(
            (dec - full).abs().max()),
        "max_abs_diff": sound, "atol": LM_PARITY_ATOL,
        "same_greedy_tokens": same_tokens, "steps": steps,
        "flash_launches": flash, "planted": planted}))
    if not same_tokens:
        raise AssertionError(f"{arch}: card and CPU chose different greedy "
                             "tokens")
    if not sound <= LM_PARITY_ATOL:
        raise AssertionError(f"{arch}: card vs CPU logits {sound:.3e} > "
                             f"{LM_PARITY_ATOL}")
    for name, p in planted.items():
        if not p["card_vs_cpu"] <= LM_PARITY_ATOL:
            raise AssertionError(f"{arch} with {name}: card vs CPU logits "
                                 f"{p['card_vs_cpu']:.3e}")
        if not p["max_abs_diff"] > LM_PARITY_ATOL:
            raise AssertionError(f"{arch}: {name} moved the logits by "
                                 f"{p['max_abs_diff']:.3e}, inside "
                                 f"{LM_PARITY_ATOL}")


def phase_ssm_serve(copy_bps):
    """Phase 20: falcon-mamba-7b, then hymba-1.5b, each at full width and
    depth, then both reduced against the CPU.  -> {arch: (row,
    launches)}, the flash rows on hymba's captured inputs."""
    cells, flash_rows = {}, []
    for arch in SSM_ARCHS:
        row, launches, rows = phase_ssm_cell(arch, copy_bps)
        cells[arch] = (row, launches)
        flash_rows += rows
    for arch in SSM_ARCHS:
        phase_ssm_parity(arch)
    return cells, flash_rows

# ---------------------------------------------------------------------------
# phase 21: frontend and encoder-decoder serving (internvl2-26b,
# seamless-m4t-large-v2)
# ---------------------------------------------------------------------------

FRONT_ARCHS = ("internvl2-26b", "seamless-m4t-large-v2")
#: text tokens a prompt: phase 7's 2000 behind internvl's 256 patches; a
#: 256-token target-side prefix, which a speech translator decodes
#: against its 512 source frames
FRONT_PROMPT = {"internvl2-26b": LM_PROMPT, "seamless-m4t-large-v2": 256}
FRONT_DECODE_TOL = 2e-3      # decode vs full forward, tests/test_smoke_archs.py
FRONT_PARITY_PROMPT = 64     # text tokens of the depth-cut fp32 copies


def front_offset(cfg) -> int:
    """Positions ahead of the text: a decoder-only model's patches; an
    encoder's frames take none (``tests/test_smoke_archs.py:76``)."""
    return cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers \
        else 0


def front_embeddings(cfg, batch, seed, device):
    """The stub's precomputed embeddings (batch, F, d_model) in fp32,
    drawn with numpy ``normal(0, 0.02)`` from ``seed``."""
    x = np.random.default_rng(seed).normal(
        0, 0.02, size=(batch, cfg.frontend_tokens, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def encoder_norm_params(cfg) -> int:
    """The encoder's final norm, which the tree holds and
    ``ArchConfig.param_count`` leaves out, as in the JAX package."""
    return cfg.d_model if cfg.encoder_layers else 0


def front_model(cfg, prompt, steps):
    return build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=front_offset(cfg) + prompt + steps + 8))


def front_split(fn):
    """``fn()`` once under torch.profiler (``range_split``): device ms of
    the flash kernel and of matrix products (by kernel name), of the
    cross-attention core (plain attention over the memory in a prefill,
    ``cross_attention_decode`` in a decode step), of the encoder's other
    work and of the rest; kernel count, wall time and the device's idle
    share."""
    def override(name):
        if "flash_fwd" in name.lower():
            return "flash_ms"
        return "matmul_ms" if is_gemm(name) else None

    return range_split(
        fn, ("flash_ms", "cross_ms", "encoder_ms", "matmul_ms", "other_ms"),
        [(attn_mod, {"_attend_naive": "attn.cross",
                     "cross_attention_decode": "attn.cross"}),
         (LM, {"_encode": "lm.encode"})],
        {"attn.cross": "cross_ms", "lm.encode": "encoder_ms"},
        override=override, fallback=lambda name: "other_ms")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_front_cell(arch, copy_bps):
    """One full-width frontend config (bf16, random params from seed 0
    drawn on the card, ``attn_impl="pallas"``): 4 prompts with the stub's
    embeddings and 32 greedy decode steps at ``offset + S + i``, every
    kernel count zeroed just before and read just after (the wgmma flash
    kernel once a layer: internvl's 48 causal over 2256 positions,
    seamless's 24 encoder layers non-causal over 512 frames and 24
    decoder layers causal over 256 tokens; its cross-attention over a
    memory of 512 <= 1024 rows is plain attention and launches nothing);
    finite logits; cold and warm prefill, decode p50 / p99, the KV and
    cross caches' bytes, the peak; two warm prefills bit-equal, and the
    cross cache after 32 decode steps bit-equal to a fresh prefill's;
    a warm prefill and a decode step split by ``front_split``, the step
    beside the time to read every weight once; the q, k and v of the
    first and last layers of each stack captured.  -> (row, launches,
    captured inputs {label: (q, k, v, window, causal)})."""
    cfg = ARCHS[arch]
    prompt, off = FRONT_PROMPT[arch], front_offset(cfg)
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    model = front_model(cfg, prompt, LM_STEPS)
    cuda = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    leaves = tree_leaves(params)
    n_params = sum(l.numel() for l in leaves)
    param_bytes = nbytes(leaves)
    del leaves
    if n_params != cfg.param_count() + encoder_norm_params(cfg):
        raise AssertionError(
            f"{arch} has {n_params} params, the config counts "
            f"{cfg.param_count()} + {encoder_norm_params(cfg)} encoder norm")
    if init_peak > INIT_PEAK_LIMIT * param_bytes:
        raise AssertionError(f"init peaked at {init_peak / 1e9:.2f} GB for "
                             f"{param_bytes / 1e9:.2f} GB of params")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, prompt, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    frontend = front_embeddings(cfg, LM_BATCH, 2, cuda)
    # a prefill's flash calls in order: the encoder's layers, then the
    # decoder's
    keep = {n_enc + n_dec - 1: f"layer{n_dec - 1}"}
    if n_enc:
        keep.update({0: "encoder_layer0",
                     n_enc - 1: f"encoder_layer{n_enc - 1}",
                     n_enc: "decoder_layer0",
                     n_enc + n_dec - 1: f"decoder_layer{n_dec - 1}"})
    else:
        keep[0] = "layer0"
    captured, calls = {}, collections.Counter()

    def capture(i, orig, q, k, v, *args, **kw):
        calls["causal" if kw["causal"] else "noncausal"] += 1
        if i in keep:
            captured[keep[i]] = (q.clone(), k.clone(), v.clone(),
                                 kw["window"], kw["causal"])
        return orig(q, k, v, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    with flash_calls(capture):
        for kern in all_kernels():
            kern.launches = 0
        logits, toks, prefill_s, lat, caches = serve(
            model, params, prompts, LM_STEPS, cuda, frontend, off)
        launches = {kern.name: kern.launches for kern in all_kernels()}
    peak = torch.cuda.max_memory_allocated()
    want = {kern.name: (n_enc + n_dec) * int(kern is FLASH_WGMMA)
            for kern in all_kernels()}
    if launches != want:
        raise AssertionError(f"{arch} launched {launches}, not {want}")
    want_calls = {"causal": n_dec, **({"noncausal": n_enc} if n_enc else {})}
    if dict(calls) != want_calls:
        raise AssertionError(f"{arch}: flash calls {dict(calls)}, not "
                             f"{want_calls}")
    if tuple(logits.shape) != (LM_BATCH, 1 + LM_STEPS, cfg.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    kv_bytes = nbytes(c[key] for c in caches for key in ("k", "v"))
    cross = [c["cross"] for c in caches if "cross" in c]
    cross_bytes = nbytes(tree_leaves(cross))
    batch = {"tokens": prompts, "frontend": frontend}
    warm, warm_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.append(model.prefill(params, batch))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    warm_s = min(warm_s)
    twice = bits_equal(warm[0][0], warm[1][0]) and bits_equal_trees(
        warm[0][1], warm[1][1])
    # decode reads the cross cache and never writes it
    cross_kept = bits_equal_trees(
        cross, [c["cross"] for c in warm[0][1] if "cross" in c])
    del warm
    if not twice:
        raise AssertionError(f"{arch}: two warm prefills differ")
    if not cross_kept:
        raise AssertionError(f"{arch}: decode wrote the cross cache")
    lat_ms = sorted(x * 1e3 for x in lat)
    positions = LM_BATCH * (cfg.frontend_tokens + prompt)
    row = {
        "arch": arch, "card": device_line(), "params": n_params,
        "param_bytes": param_bytes, "config_param_count": cfg.param_count(),
        "params_over_config": n_params - cfg.param_count(),
        "dtype": cfg.dtype, "batch": LM_BATCH,
        "frontend_tokens": cfg.frontend_tokens, "prompt": prompt,
        "decode_offset": off, "steps": LM_STEPS, "init_s": init_s,
        "init_peak_gb": init_peak / 1e9,
        "prefill_cold_ms": prefill_s * 1e3, "prefill_ms": warm_s * 1e3,
        "prefill_tok_s": LM_BATCH * prompt / warm_s,
        "prefill_positions_s": positions / warm_s,
        "decode_first_ms": lat[0] * 1e3,
        "decode_p50_ms": float(np.percentile(lat_ms, 50)),
        "decode_p99_ms": float(np.percentile(lat_ms, 99)),
        "decode_tok_s": LM_BATCH * LM_STEPS / sum(lat),
        "kv_cache_bytes": kv_bytes, "cross_cache_bytes": cross_bytes,
        "peak_mem_gb": peak / 1e9,
        "launches": {k: n for k, n in launches.items() if n},
        "flash_calls": dict(calls), "two_prefills_bit_equal": twice,
        "cross_cache_kept_by_decode": cross_kept,
        "tokens_0": toks[0, :8].tolist()}
    log("front_serve " + json.dumps(row))
    log("front_serve_prefill_device " + json.dumps({
        "arch": arch, **front_split(lambda: model.prefill(params, batch))}))
    tok = toks[:, -1:]
    split = front_split(lambda: model.decode_step(
        params, tok, caches, off + prompt + LM_STEPS))
    # the least a decode step can take: every weight read once
    split["weight_read_ms"] = param_bytes / copy_bps * 1e3
    log("front_serve_decode_device " + json.dumps({"arch": arch, **split}))
    del params, logits, caches, cross, batch, frontend, model
    torch.cuda.empty_cache()
    return row, launches, captured


def causal_encoder(i, orig, q, k, v, *args, **kw):
    """A planted fault: the encoder's self-attention run causal."""
    return orig(q, k, v, *args, **{**kw, "causal": True})


def phase_front_checks(arch):
    """(a) ``arch`` at full width, cut to 2 decoder layers (and 2 encoder
    layers), in fp32 on the card: prefill of S text tokens against
    prefill of S - 1 plus one ``decode_step`` at ``offset + S - 1``,
    within ``FRONT_DECODE_TOL`` with the same greedy token, and a planted
    fault outside it (internvl decoded without its patches' offset;
    seamless's encoder run causal in the shorter prefill).  (b) The
    reduced config in fp32 (150-token prompts): the serve loop on the
    card against the CPU within ``LM_PARITY_ATOL`` with the same greedy
    tokens."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    full_cfg = ARCHS[arch]
    cfg = dataclasses.replace(
        full_cfg, dtype="float32", num_layers=2,
        encoder_layers=min(full_cfg.encoder_layers, 2))
    S, off = FRONT_PARITY_PROMPT, front_offset(cfg)
    model = front_model(cfg, S, 0)
    params = model.init(seed=0)
    t = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, S, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    fe = front_embeddings(cfg, LM_BATCH, 3, cuda)
    full, _ = model.prefill(params, {"tokens": t, "frontend": fe})

    def decoded(pos, plant=None):
        with (flash_calls(plant) if plant else contextlib.nullcontext()):
            _, caches = model.prefill(params, {"tokens": t[:, :-1],
                                               "frontend": fe})
        return model.decode_step(params, t[:, -1:], caches, pos)[0]

    def versus(dec):
        return {"max_abs_diff": float((dec - full).abs().max()),
                "same_greedy_token": bool(
                    (dec[:, -1].argmax(-1) == full[:, -1].argmax(-1)).all())}

    sound = versus(decoded(off + S - 1))
    if cfg.encoder_layers:
        fault = ("encoder_causal", versus(decoded(off + S - 1,
                                                  causal_encoder)))
    else:
        fault = ("no_patch_offset", versus(decoded(S - 1)))
    torch.cuda.synchronize()
    del params, full, model
    torch.cuda.empty_cache()

    small = ARCHS[arch].reduced(dtype="float32")
    steps, off = 8, front_offset(small)
    model = front_model(small, 150, steps)
    p_cpu = model.init(seed=0, device="cpu")
    prompts = torch.from_numpy(TokenTaskStream(
        small.vocab_size, 150, seed=1).batch(LM_BATCH)["tokens"])
    fe = front_embeddings(small, LM_BATCH, 3, cpu)
    cpu_logits, cpu_toks, *_ = serve(model, p_cpu, prompts, steps, cpu, fe,
                                     off)
    card_logits, card_toks, *_ = serve(
        model, tree_map(lambda x: x.to(cuda), p_cpu), prompts.to(cuda),
        steps, cuda, fe.to(cuda), off)
    parity = float((card_logits.cpu() - cpu_logits).abs().max())
    same = bool((card_toks.cpu() == cpu_toks).all())
    log("front_parity " + json.dumps({
        "arch": arch, "depth_cut_layers": [cfg.encoder_layers,
                                           cfg.num_layers],
        "prompt": S, "decode_offset": front_offset(cfg),
        "decode_vs_forward": sound, "tol": FRONT_DECODE_TOL,
        "planted": {fault[0]: fault[1]},
        "reduced_card_vs_cpu_max_abs": parity, "atol": LM_PARITY_ATOL,
        "reduced_same_greedy_tokens": same, "steps": steps}))
    if not (sound["max_abs_diff"] <= FRONT_DECODE_TOL
            and sound["same_greedy_token"]):
        raise AssertionError(f"{arch}: decode vs the full forward {sound}")
    if not fault[1]["max_abs_diff"] > FRONT_DECODE_TOL:
        raise AssertionError(f"{arch}: {fault[0]} moved the logits by "
                             f"{fault[1]['max_abs_diff']:.3e}, inside "
                             f"{FRONT_DECODE_TOL}")
    if not same:
        raise AssertionError(f"{arch}: card and CPU chose different greedy "
                             "tokens")
    if not parity <= LM_PARITY_ATOL:
        raise AssertionError(f"{arch}: card vs CPU logits {parity:.3e} > "
                             f"{LM_PARITY_ATOL}")


def phase_front_serve(copy_bps):
    """Phase 21: internvl2-26b, then seamless-m4t-large-v2, each at full
    width and depth (each freed before the next), the flash kernel held
    against its plain version on the captured inputs, then the checks.
    -> ({arch: (row, launches)}, flash rows)."""
    cells, flash_rows = {}, []
    for arch in FRONT_ARCHS:
        row, launches, captured = phase_front_cell(arch, copy_bps)
        cells[arch] = (row, launches)
        for label in sorted(captured):
            q, k, v, window, causal = captured.pop(label)
            r = flash_row(f"{arch}_{label}", q, k, v, window, causal=causal,
                          previous=False)
            log("flash_case " + json.dumps(r))
            flash_rows.append(r)
            del q, k, v
        torch.cuda.empty_cache()
    for arch in FRONT_ARCHS:
        phase_front_checks(arch)
    return cells, flash_rows


# ---------------------------------------------------------------------------
# phases 22-23: the fused round of the frontend, encoder-decoder, SSM and
# hybrid configs
# ---------------------------------------------------------------------------

#: decoder layers in each arch's round (an encoder–decoder's encoder as
#: deep), at full width.  The
#: peaks are reckoned at the bytes a param of phase 11's round in the
#: same run (about 14.2 on an H100: 45.76 GB for 3.21 B):
#: internvl2-26b's 390 M a layer beside 1.14 B of untied embedding and
#: head make 6 layers (3.52 B) about 50 GB and 8 about 61 GB;
#: seamless-m4t-large-v2 (1.77 B) about 25 GB whole, cut to 6 + 6
#: layers to keep the script within half its limit.  The SSM
#: rounds are host-bound, not memory-bound: the sequential in-chunk scan
#: dispatches about 124 k ops a layer a round (2 pods x 2 microbatches
#: x 2 x 512 positions; forward, two recomputes, backward;
#: ``tools/count_round_ops.py``), about 3 s
#: of the host a layer-round on the card, so falcon-mamba-7b takes 1
#: layer and hymba-1.5b 2 (layer 0 global, layer 1 a window of 1024).
TRAIN_LAYERS = {"internvl2-26b": 6, "seamless-m4t-large-v2": 6,
                "falcon-mamba-7b": 1, "hymba-1.5b": 2}
#: the reduced SSM rounds' chunk: 4 chunks a 64-token sequence, so a
#: carry crosses three chunk boundaries
PARITY_SSM_CHUNK = 16


def train_split(fn):
    """``fn()`` once under torch.profiler (``range_split``): device ms of
    the flash VJP (the ``flash_vjp.*`` ranges, its products included), of
    the SSM scan (``ssm_scan_sharded`` and its chunk bodies: their input
    projections, recomputes and backward), of the quantize and
    dequantize kernels, of the other matrix products and of the rest;
    kernel count, wall time and the device's idle share."""
    scan = {"ssm_scan_sharded": "ssm.scan", "_chunk_seq": "ssm.scan",
            "_chunk_assoc": "ssm.scan"}
    return range_split(
        fn, ("flash_vjp_ms", "scan_ms", "quantize_ms", "matmul_ms",
             "other_ms"),
        [(ssm_mod, scan)],
        {"flash_vjp.forward": "flash_vjp_ms",
         "flash_vjp.backward": "flash_vjp_ms", "ssm.scan": "scan_ms"},
        override=lambda n: ("quantize_ms" if "quantize_kernel" in n.lower()
                            else None),
        fallback=lambda n: "matmul_ms" if is_gemm(n) else "other_ms")


def train_cfg(arch):
    """``TRAIN_LAYERS`` decoder layers (an encoder–decoder as many
    encoder layers)."""
    cfg = ARCHS[arch]
    layers = TRAIN_LAYERS[arch]
    return dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
        layers if cfg.encoder_layers else 0))


def phase_train_cell(arch, bytes_a_param):
    """One config at full width (``TRAIN_LAYERS`` deep; bf16, random
    params from seed 0) through phase 11's round with
    ``build_train_step``'s options (``chunked_sp``, the sharded SSM scan,
    remat): a 2-pod mesh, each pod 4 sequences of 512 tokens (behind
    internvl's 256 stub patches; seamless's encoder over 512 stub frames)
    in 2 microbatches.  One int8 round with every launch count zeroed
    just before and read just after (quantize and dequantize once per
    leaf and pod, no other kernel), one ``compress="none"`` round from
    the same params (the int8 params within 5 % relative of these), a
    warm int8 round bit-equal to the first, one under torch.profiler
    (``train_split``).  ``bytes_a_param``: phase 11's peak over its
    params, the reckoning of the peak.  -> (row, split)."""
    cfg = train_cfg(arch)
    t8, batch = round_setup(cfg, FUSED_SEQ, None, "int8")
    tn, _ = round_setup(cfg, FUSED_SEQ, None, "none")
    t0 = time.perf_counter()
    t8.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p0 = t8.params
    leaves = tree_leaves(p0)
    n_params = sum(l.numel() for l in leaves)
    extra = branch_norm_params(cfg) + encoder_norm_params(cfg)
    if n_params != cfg.param_count() + extra:
        raise AssertionError(f"{arch}: {n_params} params, the config counts "
                             f"{cfg.param_count()} + {extra} norm scales")
    rec8, cold_s, launches8, peak8 = driven_round(t8, p0, batch)
    p8 = t8.params
    recn, none_s, launchesn, peakn = driven_round(tn, p0, batch)
    pn = tn.params
    tn.params = None
    rel = check_int8_round(arch, leaves, (rec8, p8, launches8),
                           (recn, pn, launchesn))
    del pn
    others = {k: n for k, n in launches8.items()
              if n and k not in (QUANTIZE.name, DEQUANTIZE.name)}
    if others:
        raise AssertionError(f"{arch}: the round launched {others}")
    warm8, warm_s, _, _ = driven_round(t8, p0, batch)
    twice = bits_equal_trees(p8, t8.params)
    del p8
    t8.params = None
    if not twice:
        raise AssertionError(f"{arch}: two int8 rounds from the same params "
                             "differ")
    split = train_split(lambda: timed_round(t8, p0, batch))
    opts = t8.model.opts
    row = {
        "arch": arch, "card": device_line(), "layers": cfg.num_layers,
        "full_depth_layers": ARCHS[arch].num_layers,
        "encoder_layers": cfg.encoder_layers, "params": n_params,
        "config_param_count": cfg.param_count(), "leaves": len(leaves),
        "param_bytes": nbytes(leaves), "dtype": cfg.dtype,
        "reckoned_peak_gb": n_params * bytes_a_param / 1e9, "pods": 2,
        "microbatches_per_pod": 2, "seqs_per_pod": 4, "seq_len": FUSED_SEQ,
        "frontend_tokens": cfg.frontend_tokens,
        "opts": {k: getattr(opts, k) for k in (
            "attn_impl", "ssm_impl", "ssm_chunk", "remat", "loss_chunk",
            "block_kv")},
        "init_s": init_s, "int8_cold_s": cold_s, "int8_warm_s": warm_s,
        "none_s": none_s, "peak_mem_gb_int8": peak8 / 1e9,
        "peak_mem_gb_none": peakn / 1e9, "int8": rec8, "none": recn,
        "int8_warm": warm8, "int8_vs_none_rel": rel,
        "two_int8_rounds_bit_equal": twice,
        "kernels_a_round": split["kernels"],
        "launches_int8": launches8, "launches_none": launchesn}
    if cfg.ssm is not None:
        row["scan_chunk"] = ssm_mod.scan_chunk(FUSED_SEQ, opts.ssm_chunk)
    log("train_round " + json.dumps(row))
    log("train_round_device " + json.dumps({"arch": arch, **split}))
    del p0, leaves
    t8.params = t8.server_state = tn.server_state = None
    torch.cuda.empty_cache()
    return row, split


@contextlib.contextmanager
def replaced(owner, name, make):
    """A planted fault: ``owner.name`` replaced by ``make(original)``
    inside the block, which must call it."""
    orig = getattr(owner, name)
    fault, calls = make(orig), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fault(*args, **kw)

    setattr(owner, name, counted)
    try:
        yield
    finally:
        setattr(owner, name, orig)
    if not calls[0]:
        raise AssertionError(f"the planted fault on {name} never fired")


def ce_one_position_early():
    """internvl's CE taken on the wrong positions: one early, the last
    patch and the text but its last token."""
    def make(forward):
        def faulted(self, *args, **kw):
            hidden, aux, caches, n_front = forward(self, *args, **kw)
            return hidden[:, :-1], aux, caches, n_front - 1
        return faulted
    return replaced(LM, "_forward", make)


def memory_detached():
    """seamless's memory cut from the encoder: the same values, no
    gradient into the encoder (it stays in the graph, as
    ``autograd.grad`` wants every leaf used)."""
    def make(encode):
        def faulted(self, *args, **kw):
            memory = encode(self, *args, **kw)
            return memory.detach() + 0.0 * memory
        return faulted
    return replaced(LM, "_encode", make)


def chunk_carry_reset():
    """The SSM scan's state reset to zero at every chunk boundary."""
    return replaced(ssm_mod, "_chunk_seq", lambda body: (
        lambda h, *args: body(torch.zeros_like(h), *args)))


#: the planted faults of each arch's reduced round, beside a pod counted
#: twice
TRAIN_FAULTS = {"internvl2-26b": ("ce_one_position_early",
                                  ce_one_position_early),
                "seamless-m4t-large-v2": ("memory_detached",
                                          memory_detached),
                "falcon-mamba-7b": ("chunk_carry_reset", chunk_carry_reset),
                "hymba-1.5b": ("chunk_carry_reset", chunk_carry_reset)}


def phase_train_rounds(archs, label, bytes_a_param, **opts_over):
    """Phases 22 and 23: each arch's round at full width
    (``phase_train_cell``, its model freed before the next), then each
    reduced round on the card against the CPU with a pod counted twice
    and the arch's own planted fault (``opts_over``: the reduced rounds'
    options).  -> {arch: (row, split)}."""
    cells = {arch: phase_train_cell(arch, bytes_a_param) for arch in archs}
    for arch in archs:
        phase_round_parity(arch, (("pod_counted_twice", pod_counted_twice),
                                  TRAIN_FAULTS[arch]), label=label,
                           **opts_over)
    return cells


# ---------------------------------------------------------------------------
# phases 13-15: the multi-process and multi-node runtimes, serve mode
# ---------------------------------------------------------------------------

RT_GOAL = 6                  # phase 5's aggregation goal
ROUND_KEYS = ("updates", "nodes_used", "cold_starts", "reused", "workers",
              "crashes", "redispatched", "wall_s")


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms for a runtime comparison: two
    sessions then train their clients to the same bits, and what is
    left between them is the runtime's own arithmetic."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def synced(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def leaves_cpu(params):
    return [l.detach().float().cpu() for l in tree_leaves(params)]


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def logged_round(s, label, device):
    """One round of phase 5's client step: its record and its trace
    breakdown."""
    synced(device)
    rec = s.run_round(client_lr=CLIENT_LR, client_batch_size=32)
    synced(device)
    row = {"round": label, **{k: rec[k] for k in ROUND_KEYS}}
    row.update({f"trace_{k}": v for k, v in s.trace().breakdown().items()})
    return row


def inproc_reference(fleet, rounds, device, round_cfg, nodes=None):
    """Phase 5's in-process session from the same seed: the params after
    each round, and each round's row."""
    model, params, clients, mk_nodes, _ = fleet
    snaps, rows = [], []
    with Session.open(model, params, clients(), seed=0, device=device,
                      nodes=nodes if nodes is not None else mk_nodes(),
                      round_cfg=round_cfg) as s:
        for r in range(rounds):
            rows.append(logged_round(s, f"inproc-{r}", device))
            snaps.append(leaves_cpu(s.params))
    return snaps, rows


def phase_shmproc(fleet, device="cuda"):
    """Phase 5's rounds on ``runtime="shmproc"``: forked numpy workers
    fold the mids on the host, the controller folds the top on the
    card.  A cold round, two warm ones, then a busy worker SIGKILLed
    after the round's third update: the crash must surface as
    ``WorkerCrashed``, a fresh fork (after the parent's CUDA work) must
    take the subtree's updates, and the round must fold its full goal.
    Every round's params against phase 5's in-process session from the
    same seed within ``PARITY_ATOL``; no segment left under the
    runtime's ``/dev/shm`` prefix."""
    shm_df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                            text=True, timeout=30).stdout.strip()
    log("shm_df " + json.dumps(shm_df.splitlines()[-1]))
    model, params, clients, nodes, _ = fleet
    cfg = lambda: RoundConfig(aggregation_goal=RT_GOAL)  # noqa: E731
    ref, ref_rows = inproc_reference(fleet, 4, device, cfg())
    for row in ref_rows:
        log("shm_ref_round " + json.dumps(row))
    zero_fold_launches()
    rows, diffs, crashes, arrived = [], [], [], []
    with Session.open(model, params, clients(), runtime="shmproc",
                      nodes=nodes(), round_cfg=cfg(), seed=0,
                      device=device) as s:
        shm = s.trainer._ensure_runtime()._rt     # attaches lazily
        for r, label in enumerate(("cold", "warm-1", "warm-2")):
            rows.append(logged_round(s, f"shmproc-{label}", device))
            diffs.append(max_diff(leaves_cpu(s.params), ref[r]))
            log("shm_round " + json.dumps(
                {**rows[-1], "max_abs_diff_vs_inproc": diffs[-1]}))
        stats = {k: shm.stats[k] for k in (
            "forked", "cold_starts", "warm_starts", "cold_latency_s",
            "warm_latency_s")}

        def kill(ev):
            arrived.append(ev)
            if len(arrived) == 3:
                busy = [w for w in shm._workers if w.state == "busy"]
                os.kill(busy[0].proc.pid, signal.SIGKILL)

        s.on(UpdateArrived, kill)
        s.on(WorkerCrashed, crashes.append)
        rows.append(logged_round(s, "shmproc-sigkill", device))
        diffs.append(max_diff(leaves_cpu(s.params), ref[3]))
        log("shm_round " + json.dumps(
            {**rows[-1], "max_abs_diff_vs_inproc": diffs[-1]}))
        respawn = {k: shm.stats[k] for k in ("forked", "crashes",
                                             "cold_latency_s")}
        prefix = shm.prefix
    synced(device)
    left = [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    row = {"rounds": len(rows), "stats": stats, "after_sigkill": respawn,
           "worker_crashed_events": len(crashes),
           "max_abs_diff_vs_inproc": diffs, "atol": PARITY_ATOL,
           # how far one round moves the params: the scale the check sees
           "round_step_max_abs": max_diff(ref[3], ref[2]),
           "shm_left": left, "launches": fold_launches(),
           "warm_wall_s": min(r["wall_s"] for r in rows[1:3]),
           "inproc_warm_wall_s": min(r["wall_s"] for r in ref_rows[1:3]),
           "warm_trace": min(rows[1:3], key=lambda r: r["wall_s"]),
           "inproc_warm_trace": min(ref_rows[1:3],
                                    key=lambda r: r["wall_s"])}
    log("shmproc " + json.dumps(row))
    if any(r["updates"] != RT_GOAL for r in rows):
        raise AssertionError("a shmproc round fell short of its goal")
    if not crashes or rows[-1]["crashes"] < 1 \
            or rows[-1]["redispatched"] < 1:
        raise AssertionError("the SIGKILL did not surface as WorkerCrashed "
                             "and a re-dispatch")
    if respawn["forked"] <= stats["forked"] or stats["warm_starts"] < 1:
        raise AssertionError(f"no warm start or no respawn: {row}")
    if not max(diffs) <= PARITY_ATOL:
        raise AssertionError(f"shmproc vs inproc {max(diffs):.3e} > "
                             f"{PARITY_ATOL}")
    if left:
        raise AssertionError(f"segments left in /dev/shm: {left}")
    return row


def daemon_stats(addr):
    """A daemon's ``stats_reply``: its engines' device and its own fold
    kernel launches, counted in its process."""
    conn = connect(addr, timeout=30.0)
    try:
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 30.0)
        conn.send("stats", {})
        return conn.recv_expect(("stats_reply",), 30.0).meta
    finally:
        conn.close()


def wire_totals(remote):
    """The controller's bytes on the wire, compressed and raw."""
    t = {"tx": 0, "tx_raw": 0, "rx": 0, "rx_raw": 0}
    for node in remote._nodes.values():
        c = node.conn
        t["tx"] += c.tx_bytes
        t["rx"] += c.rx_bytes
        t["tx_raw"] += sum(c.tx_raw_by_kind.values())
        t["rx_raw"] += sum(c.rx_raw_by_kind.values())
    return t


def two_node_round(addrs, n, device):
    """One driven round across both daemons at the model's size: six
    updates (numpy, seed 3), three a node, the root fold on nodeA's
    daemon (node-top), nodeB's partial shipped daemon to daemon.  Its
    delta against the blocked numpy engine's in-process tree, bit for
    bit: every mid fold is one eager fold, which the kernel rounds as
    numpy does, and the root fold is an fp32 add."""
    rng = np.random.default_rng(3)
    ups = [(rng.standard_normal(n) * 1e-3).astype(np.float32)
           for _ in range(6)]
    ws = [float(1 + i % 3) for i in range(6)]
    assignment = {"nodeA": [0, 2, 4], "nodeB": [1, 3, 5]}
    plan = build_fold_plan(assignment, top_node="nodeA", topology="node")

    def drive(rt):
        out = RoundDriver(rt).run_round(
            round_id=0, assignment=assignment, goal=6, n_elems=n,
            fold_plan=plan,
            updates=((("nodeA", "nodeB")[i % 2], f"c{i}", u, w)
                     for i, (u, w) in enumerate(zip(ups, ws))))
        return out

    want = drive(InProcRuntime(agg_engine="blocked")).delta
    rt = RemoteRuntime(addrs, agg_engine=EngineConfig(name="auto",
                                                      device=device))
    try:
        w0 = wire_totals(rt)
        t0 = time.perf_counter()
        out = drive(rt)
        wall = time.perf_counter() - t0
        w1 = wire_totals(rt)
    finally:
        rt.close()
    row = {"wall_s": wall, "updates": out.count, "fold_tier": out.fold_tier,
           "root_node": out.root_node, "exec_s": out.exec_s,
           "bitexact_vs_blocked": bool(np.array_equal(out.delta, want)),
           **{f"wire_{k}": w1[k] - w0[k] for k in w0}}
    if out.count != 6 or not row["bitexact_vs_blocked"]:
        raise AssertionError(f"two-node round: {row}")
    return row


def phase_multinode(fleet, device="cuda", daemon_device=None):
    """Phase 5's rounds across two ``netd`` daemons on the card (each its
    own process and CUDA context, ``runtime="inproc"``), node-top with
    locality placement: three rounds, then one with ``wire_compress=6``,
    the params against an in-process session over two nodes of the same
    names and capacities within ``PARITY_ATOL``.  Locality packs the
    8-client cohort onto one node, as in the JAX package's session
    tests (a fixed plan keeps the clients' order, and so their updates,
    the same in both sessions); a driven round then spreads six
    model-size updates over both daemons.  The daemons' devices and
    fold kernel launches come from their ``stats_reply``; bytes on the
    wire from the controller's connections; a publish's device-to-host
    copy is timed on the same card."""
    model, params, clients, _, _ = fleet
    rc = lambda topology: RoundConfig(  # noqa: E731
        aggregation_goal=RT_GOAL, placement_policy="locality",
        topology=topology)
    same = {n: NodeState(node=n, max_capacity=20.0) for n in ("nodeA",
                                                              "nodeB")}
    ref, ref_rows = inproc_reference(fleet, 3, device, rc("controller"),
                                     nodes=same)
    for row in ref_rows:
        log("net_ref_round " + json.dumps(row))
    n = sum(l.numel() for l in tree_leaves(params))
    procs = []
    t0 = time.perf_counter()
    try:
        for name in ("nodeA", "nodeB"):
            procs.append(spawn_local_daemon(name, runtime="inproc",
                                            timeout=300.0,
                                            device=daemon_device))
        spawn_s = time.perf_counter() - t0
        addrs = [a for _, a in procs]
        zero_fold_launches()
        rows, diffs = [], []
        for compress, rounds in ((0, 3), (6, 1)):
            with Session.open(model, params, clients(), nodes=addrs,
                              round_cfg=rc("node"), wire_compress=compress,
                              seed=0, device=device) as s:
                remote = s.trainer._runtime
                for r in range(rounds):
                    w0 = wire_totals(remote)
                    row = logged_round(
                        s, f"net{'-z' if compress else ''}-{r}", device)
                    w1 = wire_totals(remote)
                    row.update({f"wire_{k}": w1[k] - w0[k] for k in w0})
                    row["compress"] = compress
                    row["daemon_agg_exec_s"] = {
                        node: sum(v[0] for k, v in per.items()
                                  if k.endswith("/agg_exec_s"))
                        for node, per in s.trace().telemetry.items()}
                    row["max_abs_diff_vs_inproc"] = max_diff(
                        leaves_cpu(s.params), ref[r])
                    diffs.append(row["max_abs_diff_vs_inproc"])
                    rows.append(row)
                    log("net_round " + json.dumps(row))
        launches = fold_launches()
        spread = two_node_round(addrs, n, device)
        log("net_two_node_round " + json.dumps(spread))
        daemons = [daemon_stats(a) for a in addrs]
    finally:
        for p, _ in procs:
            reap_local_daemon(p)
    # a daemon's publish: its accumulator to the host (TorchEngine.
    # to_numpy, as the daemon calls it), timed here on the same card
    eng = TorchEngine(device)
    acc = eng.begin(n)
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        eng.to_numpy(acc)
        times.append(time.perf_counter() - t1)
    del acc, eng
    z = rows[-1]
    row = {"spawn_s": spawn_s, "rounds": len(rows),
           "max_abs_diff_vs_inproc": diffs, "atol": PARITY_ATOL,
           "daemons": [{k: d[k] for k in ("node", "device",
                                          "kernel_launches", "daemon")}
                       for d in daemons],
           "launches": launches, "two_node_round": spread,
           "publish_copy_s": sorted(times)[2],
           "warm_wall_s": min(r["wall_s"] for r in rows[1:3]),
           "inproc_warm_wall_s": min(r["wall_s"] for r in ref_rows[1:3]),
           "warm_trace": min(rows[1:3], key=lambda r: r["wall_s"]),
           "inproc_warm_trace": min(ref_rows[1:3],
                                    key=lambda r: r["wall_s"]),
           "compressed_ratio": z["wire_tx"] / max(1, z["wire_tx_raw"])}
    log("multinode " + json.dumps(row))
    if any(r["updates"] != RT_GOAL for r in rows):
        raise AssertionError("a multi-node round fell short of its goal")
    if not max(diffs) <= PARITY_ATOL:
        raise AssertionError(f"multi-node vs inproc {max(diffs):.3e} > "
                             f"{PARITY_ATOL}")
    return row


#: the serve phase's external client: it imports the port alone and
#: pushes three updates of the model's size, not retrying a busy verdict
SERVE_CLIENT = """
import json, sys
import numpy as np
from repro_torch.runtime.netrt import BusyError, push_update
addr, n = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(7)
out = []
for i in range(3):
    u = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    try:
        ack = push_update(addr, f"edge-{i}", u, weight=4.0, busy_retries=0)
        out.append({"client": f"edge-{i}", "queued": ack["queued"]})
    except BusyError as e:
        out.append({"client": f"edge-{i}", "busy": True,
                    "retry_after_s": e.retry_after_s})
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules)
print(json.dumps(out))
"""


def phase_serve_ingest(fleet, device="cuda"):
    """``Session.serve()`` behind ``admission=AdmissionPolicy(max_queue=
    2)``: a client process pushes three full-size updates, two are
    queued and the third comes back ``busy`` with ``retry_after_s``; the
    round that follows folds the two in place of two clients."""
    model, params, clients, nodes, _ = fleet
    n = sum(l.numel() for l in tree_leaves(params))
    zero_fold_launches()
    arrived = []
    with Session.open(model, params, clients(), nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=RT_GOAL),
                      seed=0, device=device,
                      admission=AdmissionPolicy(max_queue=2,
                                                retry_base_s=0.05)) as s:
        addr = s.serve("127.0.0.1:0")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", SERVE_CLIENT, addr, str(n)],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        push_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"serve client failed:\n{r.stderr[-3000:]}")
        pushed = json.loads(r.stdout.strip().splitlines()[-1])
        s.on(UpdateArrived, lambda ev: arrived.append(ev.client_id))
        row = logged_round(s, "serve", device)
        ingress = s.metrics()["ingress"]
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree_leaves(s.params))
    row.update({"pushed": pushed, "client_process_s": push_s,
                "externals_folded": sorted(c for c in arrived
                                           if c.startswith("edge-")),
                "ingress": ingress, "launches": fold_launches()})
    log("serve_ingest " + json.dumps(row))
    if sum(1 for p in pushed if p.get("busy")) < 1:
        raise AssertionError("admission never pushed back")
    if row["externals_folded"] != ["edge-0", "edge-1"] \
            or row["updates"] != RT_GOAL or not finite:
        raise AssertionError(f"the served updates were not folded: {row}")
    return row


# ---------------------------------------------------------------------------
# phases 16-17: the always-on service, checkpoints
# ---------------------------------------------------------------------------

#: phase 16's jobs: fair-share weight; both share phase 5's fleet
SVC_JOBS = {"femnist-a": 2.0, "femnist-b": 1.0}
SVC_GOAL, SVC_ROUNDS = 4, 3


def client_deltas(fleet):
    """Phase 5's eight clients' local updates from the seed-0 params (one
    epoch of SGD at the paper's lr and batch) as the wire's fp32
    vectors, with their sample counts: what the service's jobs are
    sent."""
    model, params, clients, _, _ = fleet
    rng = np.random.default_rng(0)
    out = []
    for c in clients():
        delta, w = c.local_update(model, params, lr=CLIENT_LR, batch_size=32,
                                  epochs=1, rng=rng)
        out.append((flatten_jax_layout(delta)[0], w))
    return out


def push_bf16(addr, job, cid, flat, weight):
    """One ``submit_update`` frame carrying ``flat`` rounded to bf16 (its
    raw words under the name ``bfloat16``, as the JAX package's wire
    names it): the port's push_update takes numpy arrays, and numpy has
    no bf16."""
    words = torch.from_numpy(flat).to(torch.bfloat16).view(torch.int16)
    conn = connect(addr, timeout=30.0)
    try:
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 30.0)
        conn.send("submit_update", {
            "client_id": cid, "weight": weight, "submission_id": cid,
            "job": job, "dtype": "bfloat16", "shape": [flat.size]},
            blob=words.numpy())
        reply = conn.recv_expect(("ack", "error", "busy"), 60.0)
    finally:
        conn.close()
    if reply.kind != "ack":
        raise AssertionError(f"bf16 push refused: {reply.meta}")
    return words.view(torch.bfloat16).float().numpy()


def replay_job(recs, params, updates, twice=False, device="cuda"):
    """A job's closed rounds replayed in order on the card, each cohort
    through a fresh sequential ``RoundDriver`` (the library path) and
    the server step the trainer takes; ``twice`` folds the first
    round's first update twice, in place of its second (the planted
    fault).  -> the params after the last round."""
    rt = InProcRuntime(agg_engine=EngineConfig(name="auto", device=device))
    drv = RoundDriver(rt)
    state = init_server_state("fedavg", params)
    n = sum(l.numel() for l in tree_leaves(params))
    try:
        for i, rec in enumerate(recs):
            cohort = [(n, cid, updates[cid], w) for n, cid, w in rec["cohort"]]
            if twice and i == 0:
                cohort[1] = cohort[0]
            out = drv.run_round(round_id=rec["ticket"],
                                assignment=rec["assignment"],
                                updates=cohort, goal=len(cohort),
                                n_elems=n, top_node=rec["top_node"])
            params, state = apply_server_opt(
                "fedavg", params, state,
                unflatten_jax_layout(out.delta, params), lr=-1.0)
    finally:
        rt.close()
    return params


def phase_service(fleet, ckpt_dir, device="cuda"):
    """One ``AggregationService`` on the card with two jobs of phase 5's
    full-width ResNet-18 (seed-0 params, weights 2:1) over phase 5's
    fleet: the jobs' updates are the clients' real deltas, queued
    through admission, one of them pushed over the wire as bf16; three
    rolling rounds a job closed by ``MinCohortIdleGap``; job a
    checkpoints its params after its last round (phase 17).  Each job's
    params against its cohorts replayed in order on the card, and one
    update folded twice above ``PARITY_ATOL``."""
    model, params, clients, nodes, _ = fleet
    deltas = client_deltas(fleet)
    jobs = list(SVC_JOBS)
    svc = AggregationService(nodes(), admission=AdmissionPolicy(max_queue=64),
                             device=device)
    updates, published = {}, []
    try:
        for job, weight in SVC_JOBS.items():
            tr = svc.add_job(job, model, params, clients(), weight=weight,
                             round_cfg=RoundConfig(aggregation_goal=SVC_GOAL))
            if not isinstance(svc.runtime.engine_for(f"mid:{job}@probe"),
                              TorchEngine):
                raise AssertionError("the service took a numpy engine")
        # phase 17: job a's trainer checkpoints at its last round's end
        tr_a = svc.trainer(jobs[0])
        tr_a.ckpt, tr_a.checkpoint_every = \
            AsyncCheckpointer(ckpt_dir), SVC_ROUNDS
        addr = svc.serve("127.0.0.1:0")
        t0 = time.perf_counter()
        cid = f"{jobs[0]}-u0"
        updates[cid] = push_bf16(addr, jobs[0], cid, deltas[0][0],
                                 deltas[0][1])
        push_s = time.perf_counter() - t0
        for job in jobs:
            for k in range(SVC_GOAL * SVC_ROUNDS):
                cid = f"{job}-u{k}"
                if cid in updates:
                    continue
                flat, w = deltas[(k + 3 * jobs.index(job)) % len(deltas)]
                v = svc.submit(job, cid, flat, w, submission_id=cid)
                if not v["admitted"]:
                    raise AssertionError(f"{cid} not admitted: {v}")
                updates[cid] = flat
        svc.driver.on(PartialReady, published.append)
        zero_fold_launches()
        t0 = time.perf_counter()
        recs = svc.run_rounds(
            {job: SVC_ROUNDS for job in jobs},
            policy=MinCohortIdleGap(min_cohort=SVC_GOAL, idle_gap_s=0.05))
        synced(device)
        wall = time.perf_counter() - t0
        launches = fold_launches()
        tr_a.ckpt.wait()
        health = svc.health()
        traces = {job: svc.trainer(job).trace() for job in jobs}
        engines = dict(svc.runtime._engines)
        final = {job: svc.trainer(job).params for job in jobs}
        overlap = svc.pipeline_overlap()
    finally:
        svc.close()
    mids = [e for k, e in engines.items() if k.startswith("mid")]
    tops = [e for k, e in engines.items() if k.startswith("top")]
    copies = sum(e.host_copies for e in mids)
    by_job = {job: [r for r in recs if r["job"] == job] for job in jobs}
    rows = {}
    for job in jobs:
        rs = by_job[job]
        walls = [r["t_close"] - r["t_open"] for r in rs]
        want = replay_job(rs, params, updates, device=device)
        diff = max_diff(leaves_cpu(final[job]), leaves_cpu(want))
        rows[job] = {"rounds": len(rs), "weight": SVC_JOBS[job],
                     "cohorts": [len(r["cohort"]) for r in rs],
                     "round_wall_s": walls, "warm_round_wall_s":
                     min(walls[1:]), "max_abs_diff_vs_sequential": diff,
                     "bitexact_vs_sequential": diff == 0.0,
                     # the job's last round, split by its trace
                     "last_round_trace": traces[job].breakdown()}
    fault = max_diff(leaves_cpu(final[jobs[0]]), leaves_cpu(
        replay_job(by_job[jobs[0]], params, updates, twice=True,
                   device=device)))
    row = {"jobs": rows, "wall_s": wall, "pipeline_overlap": overlap,
           "bf16_push_s": push_s,
           "bf16_in_cohort": any(c == f"{jobs[0]}-u0"
                                 for r in recs for _, c, _ in r["cohort"]),
           "launches": launches, "publishes": len(published),
           "publish_host_copies": copies,
           "host_copies_per_publish": copies / max(len(published), 1),
           "publish_copy_ms": (sum(e.host_copy_s for e in mids)
                               / max(copies, 1) * 1e3),
           "top_fold_host_copies": sum(e.host_copies for e in tops),
           "fault_max_abs_diff": fault, "atol": PARITY_ATOL}
    log("service " + json.dumps(row))
    log("service_health " + summary_line(health))
    if any(r["rounds"] != SVC_ROUNDS or min(r["cohorts"]) != SVC_GOAL
           for r in rows.values()) or not row["bf16_in_cohort"]:
        raise AssertionError(f"the service rounds fell short: {row}")
    if any(r["max_abs_diff_vs_sequential"] > PARITY_ATOL
           for r in rows.values()):
        raise AssertionError(f"service vs sequential above {PARITY_ATOL}")
    if not fault > PARITY_ATOL:
        raise AssertionError(f"the update folded twice went unseen: {fault}")
    if row["host_copies_per_publish"] != 1.0:
        raise AssertionError(f"{copies} host copies for "
                             f"{len(published)} publishes")
    if device == "cuda":
        check_fold_launches("the service rounds", launches,
                            ("eager_accumulate",))
    return row, final[jobs[0]], tr_a.ckpt


def phase_checkpoint(params, ckpt, ckpt_dir):
    """Phase 16's job-a checkpoint (``AsyncCheckpointer`` at its last
    round's end) restored and held against the job's params bit for
    bit; the submit's time in the round (the snapshot to pinned host
    memory) and the write's on its thread, for that first submit (it
    allocates the pinned buffers) and a second one (it reuses them)."""
    t0 = time.perf_counter()
    got, step = restore_checkpoint(ckpt_dir, like=params)
    synced(tree_leaves(got)[0].device)
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(params)))
    nbytes = sum(f.stat().st_size for f in Path(ckpt_dir).glob("*.npz"))
    first = (ckpt.submit_s, ckpt.write_s)
    ckpt.submit(step + 1, params)
    ckpt.wait()
    row = {"step": step, "bitexact": same, "submit_ms": first[0] * 1e3,
           "write_ms": first[1] * 1e3, "warm_submit_ms": ckpt.submit_s * 1e3,
           "warm_write_ms": ckpt.write_s * 1e3, "restore_ms": restore_s * 1e3,
           "npz_bytes": nbytes, "completed": ckpt.completed}
    log("checkpoint " + json.dumps(row))
    if not same or step != SVC_ROUNDS or ckpt.completed != 2:
        raise AssertionError(f"checkpoint round trip failed: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 24: the fused round across ranks on the one card
# ---------------------------------------------------------------------------

#: full-width llama3.2-3b cut to 2 layers: 595,341,312 params (the
#: 394,002,432 of the tied embedding, 2 x 100,669,440, the final norm)
DIST_LAYERS = 2
DIST_AXES = ("pod", "data", "model")
#: the world-4 full-width round against the one-process round: bf16
#: weight gradients are rounded over half the rows before the fp32 sum
DIST_NORM_RTOL, DIST_LOSS_ATOL = 1e-2, 1e-3
DIST_NONE_ATOL = 5e-5        # tests/test_torch_fused_round.py's limit


def exact_matmuls() -> None:
    """Phase 1's switches: no TF32 and no reduced-precision bf16
    reduction (the JAX reference accumulates bf16 products in fp32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def dist_cfg():
    return dataclasses.replace(ARCHS[LM_ARCH], num_layers=DIST_LAYERS)


def digest(params) -> str:
    """sha256 over every leaf's bytes, in leaf order."""
    import hashlib

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


@contextlib.contextmanager
def data_rank_counted_twice(mesh):
    """A planted fault for the world-4 round: data rank 1's accumulator
    enters its pod's sum twice (its token count once), as ``pod_counted_
    twice`` does for a pod."""
    wire, orig = mesh.wire, mesh.wire.all_reduce

    def faulted(tensors, group, kind, **kw):
        if kind == "data_all_reduce" and mesh.coord("data") == 1:
            for t in tensors[:-1]:          # the last is the counts
                t.mul_(2)
        return orig(tensors, group, kind, **kw)

    wire.all_reduce = faulted
    try:
        yield
    finally:
        del wire.all_reduce


@contextlib.contextmanager
def hop_skipped():
    """A planted fault: the int8 ring runs one hop short (P − 2 hops), so
    the pod the last hop would bring never reaches the sum."""
    orig = compression._ring_gather
    compression._ring_gather = lambda q, s, mesh, axis, hops: orig(
        q, s, mesh, axis, hops=hops - 1)
    try:
        yield
    finally:
        compression._ring_gather = orig


def rank_round(trainer, params, batch, fault=contextlib.nullcontext):
    """One round of a rank from ``params`` with its launch counts, peak
    and wire statistics zeroed just before and read just after."""
    trainer.mesh.wire.stats.clear()
    with fault():
        rec, wall, launches, peak = driven_round(trainer, params, batch)
    return {"rec": rec, "wall_s": wall, "peak_gb": peak / 1e9,
            "launches": {k: n for k, n in launches.items() if n},
            "wire": {k: dict(v) for k, v in trainer.mesh.wire.stats.items()}}


def dist_rank(rank, device, shape, world2):
    """What each rank of phase 24 runs: full-width llama3.2-3b at
    ``DIST_LAYERS`` layers on ``shape`` from seed-0 params.  ``world2``:
    an int8 round, a warm one from the same params and a ``none`` round,
    with the digests of the first and the last; else two int8 rounds
    (the digest after both), one with a data rank counted twice, and the
    reduced fp32 rounds (``dist_reduced_rank``)."""
    exact_matmuls()
    cfg = dist_cfg()
    mesh = make_debug_mesh(shape, DIST_AXES)
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=FUSED_SEQ,
                              n_cohorts=4).round_batch(8, 0)
    t8 = FusedFLTrainer(cfg, mesh, round_agg("int8"), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t8.init(seed=0)             # checks that the ranks drew the same
    torch.cuda.synchronize()
    out = {"rank": rank, "coords": mesh.coords, "device": str(device),
           "init_s": time.perf_counter() - t0}
    p0 = t8.params
    rounds = out["rounds"] = {}
    rounds["int8_cold"] = rank_round(t8, p0, batch)
    if world2:
        rounds["int8_cold"]["digest"] = digest(t8.params)
        rounds["int8_warm"] = rank_round(t8, p0, batch)
        tn = FusedFLTrainer(cfg, mesh, round_agg("none"), device=device)
        rounds["none"] = rank_round(tn, p0, batch)
        rounds["none"]["digest"] = digest(tn.params)
        tn.params = tn.server_state = None
    else:
        rounds["int8_warm"] = rank_round(t8, t8.params, batch)
        rounds["int8_warm"]["digest"] = digest(t8.params)
        t8.params = None
        rounds["int8_fault"] = rank_round(
            t8, p0, batch, lambda: data_rank_counted_twice(mesh))
    del p0
    t8.params = t8.server_state = None
    torch.cuda.empty_cache()
    if not world2:
        out["reduced"] = dist_reduced_rank(rank, device, shape)
    return out


def dist_reduced_rank(rank, device, shape):
    """The reduced fp32 rounds of a rank from seed-0 params: ``none``,
    int8, and int8 with a hop skipped; rank 0 returns the params."""
    cfg = ARCHS[LM_ARCH].reduced(dtype="float32")
    mesh = make_debug_mesh(shape, DIST_AXES)
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=64,
                              n_cohorts=4).round_batch(8, 0)
    out = {}
    for label, comp, fault in (("none", "none", contextlib.nullcontext),
                               ("int8", "int8", contextlib.nullcontext),
                               ("hop_skipped", "int8", hop_skipped)):
        t = FusedFLTrainer(cfg, mesh, round_agg(comp), device=device)
        t.init(seed=0)
        row = rank_round(t, t.params, batch, fault)
        row["digest"] = digest(t.params)
        if rank == 0:
            row["params"] = [l.cpu() for l in tree_leaves(t.params)]
        out[label] = row
    return out


def one_process_round(cfg, seq_len, comps, with_steps=True):
    """The one-process pods-in-turn round on the card (phase 11's mesh)
    from seed-0 params -> ({comp: (metrics, params)}, the int8 limit's
    steps when ``with_steps``)."""
    out, steps = {}, None
    for comp in comps:
        t, batch = round_setup(cfg, seq_len, "cuda", comp)
        t.init(seed=0)
        if comp == "int8" and with_steps:
            steps = pod_steps(t, batch)
        rec = t.train_round(batch)
        out[comp] = (rec, t.params)
    return out, steps


def slowest(rows, label, key="wall_s"):
    return max(r["rounds"][label][key] for r in rows)


def wire_row(rows, label, n_pods):
    """Bytes and seconds a rank sent per pod hop and per data all-reduce
    in one round (rank 0's count; the slowest rank's seconds)."""
    out = {}
    for kind, per in (("pod_hop", max(n_pods - 1, 1)),
                      ("data_all_reduce", 1), ("pod_all_reduce", 1)):
        got = [r["rounds"][label]["wire"].get(kind) for r in rows]
        if got[0] is None:
            continue
        out[kind] = {"bytes_per": got[0]["bytes"] / per,
                     "seconds_per": max(g["seconds"] for g in got) / per,
                     "calls": got[0]["calls"]}
    return out


def check_rank_launches(label, rows, round_label, leaves, n_pods):
    """Quantize once a leaf and dequantize once a leaf and pod on every
    rank in an int8 round, no other kernel."""
    want = {QUANTIZE.name: leaves, DEQUANTIZE.name: leaves * n_pods}
    got = [r["rounds"][round_label]["launches"] for r in rows]
    if any(g != want for g in got):
        raise AssertionError(f"{label}: launches a rank {got}, not {want}")
    return [g[QUANTIZE.name] for g in got], [g[DEQUANTIZE.name] for g in got]


def phase_dist_round(spawn):
    """Phase 24: the fused round with one process a mesh coordinate, the
    ranks on the one card over gloo (every wire tensor staged through
    pinned host memory).  World 2 on (2,1,1): full-width llama3.2-3b
    (bf16, 2 layers) int8 and ``none`` bit-equal (by sha256) to the
    one-process round of the same params and batch. World 4 on (2,2,1):
    two int8 rounds with every rank bit-identical, the first round's
    update norm and loss against the one-process round's, and a data
    rank counted twice above that limit; then reduced fp32 llama3.2-3b
    ``none`` (atol 5e-5) and int8 (the two-part limit) against the
    one-process round on the card, and a hop skipped above the limit.
    ``spawn(world)`` starts the world's ranks (``phase_ranks``) and
    returns each rank's ``dist_rank`` result."""
    t_start = time.perf_counter()
    cfg = dist_cfg()
    ref, _ = one_process_round(cfg, FUSED_SEQ, ("int8", "none"), False)
    ref_digests = {c: digest(p) for c, (_, p) in ref.items()}
    ref_recs = {c: rec for c, (rec, _) in ref.items()}
    leaves = len(tree_leaves(ref["int8"][1]))
    n_params = sum(l.numel() for l in tree_leaves(ref["int8"][1]))
    del ref
    torch.cuda.empty_cache()

    # world 2: bit-equal to the one-process round (each pod's delta comes
    # from the same kernels on the same inputs, and a sum of two commutes)
    t2 = time.perf_counter()
    rows2 = spawn(2)
    world2_s = time.perf_counter() - t2
    launches2 = check_rank_launches("world 2", rows2, "int8_cold", leaves, 2)
    equal = {c: all(r["rounds"][lbl]["digest"] == ref_digests[c]
                    for r in rows2)
             for c, lbl in (("int8", "int8_cold"), ("none", "none"))}
    row2 = {
        "world": 2, "mesh": [2, 1, 1], "backend": "gloo", "arch": LM_ARCH,
        "layers": DIST_LAYERS, "params": n_params, "dtype": cfg.dtype,
        "seqs_per_pod": 4, "seq_len": FUSED_SEQ, "microbatches_per_pod": 2,
        "int8_cold_s": slowest(rows2, "int8_cold"),
        "int8_warm_s": slowest(rows2, "int8_warm"),
        "none_s": slowest(rows2, "none"),
        "init_s": max(r["init_s"] for r in rows2),
        "peak_gb_int8": [r["rounds"]["int8_cold"]["peak_gb"] for r in rows2],
        "wire_int8": wire_row(rows2, "int8_cold", 2),
        "wire_none": wire_row(rows2, "none", 2),
        "quantize_launches": launches2[0],
        "dequantize_launches": launches2[1],
        "int8": rows2[0]["rounds"]["int8_cold"]["rec"],
        "int8_one_process": ref_recs["int8"],
        "bit_equal_one_process": equal, "spawn_wall_s": world2_s}
    log("dist_round " + json.dumps(row2))
    if not all(equal.values()):
        raise AssertionError(f"world 2: params differ from the one-process "
                             f"round: {equal}")

    # world 4: full width, then reduced fp32
    red_cfg = ARCHS[LM_ARCH].reduced(dtype="float32")
    red_ref, red_steps = one_process_round(red_cfg, 64, ("none", "int8"))
    t4 = time.perf_counter()
    rows4 = spawn(4)
    world4_s = time.perf_counter() - t4
    launches4 = check_rank_launches("world 4", rows4, "int8_cold", leaves, 2)
    digests = {r["rounds"]["int8_warm"]["digest"] for r in rows4}
    rec4 = rows4[0]["rounds"]["int8_cold"]["rec"]
    recf = rows4[0]["rounds"]["int8_fault"]["rec"]
    norm_rel = abs(rec4["update_norm"] / ref_recs["int8"]["update_norm"] - 1)
    fault_rel = abs(recf["update_norm"] / ref_recs["int8"]["update_norm"]
                    - 1)
    loss_err = abs(rec4["loss"] - ref_recs["int8"]["loss"])
    red = {}
    for label in ("none", "int8", "hop_skipped"):
        got = rows4[0]["reduced"][label]["params"]
        want = [t.cpu() for t in tree_leaves(
            red_ref["none" if label == "none" else "int8"][1])]
        same = len({r["reduced"][label]["digest"] for r in rows4}) == 1
        if label == "none":
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            red[label] = {"max_abs_err": err, "ok": err <= DIST_NONE_ATOL,
                          "ranks_bit_identical": same}
        else:
            share, worst, ok = int8_limit(got, want, red_steps)
            red[label] = {"share_over_1e-5": share, "worst_in_steps": worst,
                          "ok": ok, "ranks_bit_identical": same}
    red_launches = check_rank_launches(
        "world 4 reduced", [{"rounds": r["reduced"]} for r in rows4],
        "int8", len(rows4[0]["reduced"]["int8"]["params"]), 2)
    row4 = {
        "world": 4, "mesh": [2, 2, 1], "backend": "gloo", "arch": LM_ARCH,
        "layers": DIST_LAYERS, "params": n_params,
        "int8_cold_s": slowest(rows4, "int8_cold"),
        "int8_warm_s": slowest(rows4, "int8_warm"),
        "init_s": max(r["init_s"] for r in rows4),
        "peak_gb_int8": [r["rounds"]["int8_cold"]["peak_gb"] for r in rows4],
        "wire_int8": wire_row(rows4, "int8_cold", 2),
        "quantize_launches": launches4[0],
        "dequantize_launches": launches4[1],
        "ranks_bit_identical_after_two_rounds": len(digests) == 1,
        "int8": rec4, "int8_one_process": ref_recs["int8"],
        "update_norm_rel": norm_rel, "loss_abs_err": loss_err,
        "limits": {"update_norm_rel": DIST_NORM_RTOL,
                   "loss_abs": DIST_LOSS_ATOL},
        "data_rank_counted_twice": {"update_norm_rel": fault_rel,
                                    "loss": recf["loss"]},
        "reduced": red,
        "reduced_quantize_launches": red_launches[0],
        "reduced_dequantize_launches": red_launches[1],
        "reduced_wire_int8": wire_row(
            [{"rounds": r["reduced"]} for r in rows4], "int8", 2),
        "spawn_wall_s": world4_s}
    log("dist_round " + json.dumps(row4))
    if len(digests) != 1:
        raise AssertionError("world 4: the ranks differ after two rounds")
    if not (norm_rel <= DIST_NORM_RTOL and loss_err <= DIST_LOSS_ATOL):
        raise AssertionError(f"world 4 vs the one-process round: {row4}")
    if not fault_rel > DIST_NORM_RTOL:
        raise AssertionError(f"world 4: a data rank counted twice stayed "
                             f"inside the limit: {fault_rel}")
    if not (red["none"]["ok"] and red["int8"]["ok"]
            and red["none"]["ranks_bit_identical"]
            and red["int8"]["ranks_bit_identical"]):
        raise AssertionError(f"world 4 reduced rounds: {red}")
    if red["hop_skipped"]["ok"]:
        raise AssertionError(f"world 4: a skipped hop stayed inside the "
                             f"limit: {red['hop_skipped']}")
    return {"world2": row2, "world4": row4,
            "phase_24_s": time.perf_counter() - t_start}


def dist_launches(kern, dist):
    """A quantize kernel's launches on each rank of phase 24's int8
    rounds."""
    key = ("quantize_launches" if kern is QUANTIZE
           else "dequantize_launches")
    w2, w4 = dist["world2"], dist["world4"]
    return {
        f"phase 24: 2 ranks (2,1,1), {LM_ARCH} {DIST_LAYERS} layers, int8 "
        "round, each rank": w2[key],
        f"phase 24: 4 ranks (2,2,1), {LM_ARCH} {DIST_LAYERS} layers, int8 "
        "round, each rank": w4[key],
        f"phase 24: 4 ranks (2,2,1), reduced fp32 {LM_ARCH}, int8 round, "
        "each rank": w4["reduced_" + key]}


# ---------------------------------------------------------------------------
# phase 25: the model axis across ranks on the one card
# ---------------------------------------------------------------------------

MODEL_LAYERS = 2             # full width cut to 2 layers (deepseek's layer
                             # 1 is MoE: 32 of its 64 experts a rank)
GEMMA_RING_SEQ = 32          # reduced gemma3-4b on 4 model ranks: a shard of
                             # 8 rows, its window of 8 one hop of the ring


#: phase 26's full-width depths: (decoder layers, encoder layers)
MODEL_DEPTHS = {"falcon-mamba-7b": (1, 0), "hymba-1.5b": (2, 0),
                "internvl2-26b": (1, 0), "seamless-m4t-large-v2": (1, 1)}


def model_cfg(arch):
    """Full width cut to ``MODEL_LAYERS`` (phase 25) or to
    ``MODEL_DEPTHS`` (phase 26)."""
    layers, enc = MODEL_DEPTHS.get(arch, (MODEL_LAYERS, 0))
    return dataclasses.replace(ARCHS[arch], num_layers=layers,
                               encoder_layers=enc)


def reduced_cfg(arch):
    return ARCHS[arch].reduced(dtype="float32")


def model_batch(cfg, seq):
    """Phase 11's batch (8 sequences of ``seq`` tokens) and, for a
    frontend config, ``round_setup``'s stub embeddings."""
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=seq,
                              n_cohorts=4).round_batch(8, 0)
    if cfg.frontend:
        batch["frontend"] = front_embeddings(cfg, 8, 2, "cpu").numpy()
    return batch


@contextlib.contextmanager
def model_part_counted_twice(mesh):
    """A planted fault for phase 25: model rank 1's gradient part enters
    the (data, model) all-reduce twice."""
    wire, orig = mesh.wire, mesh.wire.all_reduce

    def faulted(tensors, group, kind, **kw):
        if kind in ("data_all_reduce", "all_reduce") \
                and mesh.coord("model") == 1:
            for t in tensors[:-1]:          # the last is the counts (0 here)
                t.mul_(2)
        return orig(tensors, group, kind, **kw)

    wire.all_reduce = faulted
    try:
        yield
    finally:
        del wire.all_reduce


def xproj_unsummed():
    """A planted fault for phase 26: each model rank's ``x_proj`` product
    over its d_inner slice used without the model group's psum."""
    return replaced(ssm_mod, "_ssm_inputs", lambda inputs: (
        lambda cfg, params, u, contract=None: inputs(cfg, params, u)))


def encoder_sp_causal():
    """A planted fault for phase 26: the context-parallel flash run with
    a causal mask in the encoder's layers (the decoder's are causal)."""
    return replaced(attn_mod, "flash_self_attention_sp", lambda sp: (
        lambda q, k, v, window, causal, *args, **kw: sp(
            q, k, v, window, True, *args, **kw)))


#: each fault round's planted fault, made from the rank's mesh
MODEL_FAULTS = {"fault": model_part_counted_twice,
                "fault_xproj": lambda mesh: xproj_unsummed(),
                "fault_causal": lambda mesh: encoder_sp_causal()}


def model_wire(row):
    """The model group's traffic of one rank's round: calls, bytes sent
    and seconds, over every ``model_*`` kind; and the tier all-reduce's
    over (data, model)."""
    kinds = {k: v for k, v in row["wire"].items() if k.startswith("model_")}
    tier = row["wire"].get("data_all_reduce") or row["wire"].get(
        "all_reduce") or {"calls": 0, "bytes": 0, "seconds": 0.0}
    return {"model_calls": sum(v["calls"] for v in kinds.values()),
            "model_bytes": sum(v["bytes"] for v in kinds.values()),
            "model_s": sum(v["seconds"] for v in kinds.values()),
            "model_by_kind": kinds, "tier_all_reduce": tier,
            "pod_hop": row["wire"].get("pod_hop")}


def model_rank(rank, device, runs):
    """What each rank of phases 25 and 26 runs: for each run ``(label,
    arch, full, shape, seq, rounds)`` a trainer on ``shape`` from seed-0
    params (``full``: full width at ``model_cfg``'s depth, bf16; else
    reduced fp32); ``rounds`` names them in order: "cold" (int8 from the
    seed-0 params), "warm" (int8 from the cold round's), "none" and the
    "fault" rounds (int8 with a ``MODEL_FAULTS`` fault planted), each
    but "warm" from the seed-0 params.  -> {label: {round: rank_round's
    row with the params' digest}}; rank 0 also returns the reduced runs'
    params."""
    exact_matmuls()
    out = {}
    for label, arch, full, shape, seq, rounds in runs:
        cfg = model_cfg(arch) if full else reduced_cfg(arch)
        mesh = make_debug_mesh(shape, DIST_AXES)
        batch = model_batch(cfg, seq)
        trainers = {c: FusedFLTrainer(cfg, mesh, round_agg(c), device=device)
                    for c in ("int8", "none") if c == "int8" or c in rounds}
        t8 = trainers["int8"]
        t8.init(seed=0)
        p0, rows = t8.params, {}
        for name in rounds:
            t = trainers["none" if name == "none" else "int8"]
            start = t8.params if name == "warm" else p0
            fault = (lambda: MODEL_FAULTS[name](mesh)) \
                if name.startswith("fault") else contextlib.nullcontext
            row = rank_round(t, start, batch, fault)
            row["digest"] = digest(t.params)
            if rank == 0 and not full:
                row["params"] = [l.cpu() for l in tree_leaves(t.params)]
            rows[name] = row
            if name != "cold":
                t.params = t.server_state = None
        out[label] = rows
        del p0, trainers, t8
        torch.cuda.empty_cache()
    return out


def model_reference(arch, full, pods, seq, comps):
    """The one-process round on the card from seed-0 params on a
    ``(pods, 1, 1)`` mesh -> ({comp: (metrics, params on the host)}, for
    a reduced run the int8 limit's steps, the number of leaves)."""
    cfg = model_cfg(arch) if full else reduced_cfg(arch)
    mesh = make_debug_mesh((pods, 1, 1), DIST_AXES)
    batch = model_batch(cfg, seq)
    out, steps = {}, None
    for comp in comps:
        t = FusedFLTrainer(cfg, mesh, round_agg(comp), device="cuda")
        t.init(seed=0)
        n_leaves = len(tree_leaves(t.params))
        if comp == "int8" and not full:
            steps = pod_steps(t, batch)
        rec = t.train_round(batch)
        out[comp] = (rec, None if full else
                     [l.cpu() for l in tree_leaves(t.params)])
        t.params = t.server_state = None
        del t
        torch.cuda.empty_cache()
    return out, steps, n_leaves


def model_checks(label, rows, ref, steps, full, n_pods, leaves, phase=25,
                 extra=None):
    """The checks of one phase-25 or phase-26 run against the
    one-process round: every rank's params bit-identical after each
    round; full width, the cold round's update norm within
    ``DIST_NORM_RTOL`` (relative) and its loss within ``DIST_LOSS_ATOL``,
    each fault's norm outside; reduced, ``none`` within
    ``DIST_NONE_ATOL``, int8 within the two-part limit and each fault
    above it; quantize once a leaf and dequantize once a leaf and pod on
    every rank of an int8 round.  ``extra``: more keys for the run's
    ``model_round`` line.  -> the run's row."""
    per = [r[label] for r in rows]
    rounds = list(per[0])
    faults = [n for n in rounds if n.startswith("fault")]
    same = {n: len({p[n]["digest"] for p in per}) == 1 for n in rounds}
    rec = per[0]["cold"]["rec"]
    want = ref["int8"][0]
    out = {"phase": phase, "run": label, "ranks": len(per),
           "rounds": rounds, **(extra or {}),
           "ranks_bit_identical": same,
           "cold_s": max(p["cold"]["wall_s"] for p in per),
           "peak_gb_cold": [p["cold"]["peak_gb"] for p in per],
           "wire_cold_rank0": model_wire(per[0]["cold"]),
           "model_s_slowest": max(model_wire(p["cold"])["model_s"]
                                  for p in per),
           "int8": rec, "int8_one_process": want}
    if "warm" in per[0]:
        out["warm_s"] = max(p["warm"]["wall_s"] for p in per)
        out["peak_gb_warm"] = [p["warm"]["peak_gb"] for p in per]
    launches = check_rank_launches(label, [{"rounds": p} for p in per],
                                   "cold", leaves, n_pods)
    out["quantize_launches"], out["dequantize_launches"] = launches
    ok, fault_ok = all(same.values()), True
    if full:
        norm = abs(rec["update_norm"] / want["update_norm"] - 1)
        loss = abs(rec["loss"] - want["loss"])
        out.update(update_norm_rel=norm, loss_abs_err=loss,
                   limits={"update_norm_rel": DIST_NORM_RTOL,
                           "loss_abs": DIST_LOSS_ATOL})
        for n in faults:
            rel = abs(per[0][n]["rec"]["update_norm"]
                      / want["update_norm"] - 1)
            out[f"{n}_update_norm_rel"] = rel
            fault_ok = fault_ok and rel > DIST_NORM_RTOL
        ok = ok and norm <= DIST_NORM_RTOL and loss <= DIST_LOSS_ATOL
    else:
        got = per[0]["cold"]["params"]
        share, worst, lim = int8_limit(got, ref["int8"][1], steps)
        out["int8_limit"] = {"share_over_1e-5": share,
                             "worst_in_steps": worst, "ok": lim}
        ok = ok and lim
        if "none" in per[0]:
            err = max(float((g - w).abs().max()) for g, w in
                      zip(per[0]["none"]["params"], ref["none"][1]))
            out["none_max_abs_err"] = err
            ok = ok and err <= DIST_NONE_ATOL
        for n in faults:
            fs, fw, flim = int8_limit(per[0][n]["params"], ref["int8"][1],
                                      steps)
            out[n] = {"share_over_1e-5": fs, "worst_in_steps": fw,
                      "ok": flim}
            fault_ok = fault_ok and not flim
    log("model_round " + json.dumps(out))
    if not ok:
        raise AssertionError(f"phase {phase} {label}: against the "
                             f"one-process round or across ranks: {out}")
    if not fault_ok:
        raise AssertionError(f"phase {phase} {label}: a planted fault "
                             f"({', '.join(faults)}) stayed inside the "
                             "limit")
    return out


MODEL_RUNS = {
    2: [("llama_112", LM_ARCH, True, (1, 1, 2), FUSED_SEQ,
         ("cold", "fault")),
        ("deepseek_112", MOE_ARCH, True, (1, 1, 2), FUSED_SEQ,
         ("cold", "fault")),
        ("llama_112_reduced", LM_ARCH, False, (1, 1, 2), 64,
         ("cold", "none", "fault")),
        ("deepseek_112_reduced", MOE_ARCH, False, (1, 1, 2), 64,
         ("cold", "fault"))],
    4: [("llama_212", LM_ARCH, True, (2, 1, 2), FUSED_SEQ,
         ("cold", "fault")),
        ("gemma_114_reduced", "gemma3-4b", False, (1, 1, 4),
         GEMMA_RING_SEQ, ("cold", "none", "fault"))]}


def model_references(runs):
    """The one-process rounds on the card that ``runs`` are held against,
    each from seed-0 params: full width int8 on a (pods, 1, 1) mesh; a
    reduced config's ``none`` (where a run has one) and int8 (with the
    int8 limit's steps).  -> {"full", "reduced", "leaves"}."""
    full, red, leaves = {}, {}, {}
    for label, arch, f, shape, seq, rounds in runs:
        if f and (arch, shape[0]) not in full:
            full[arch, shape[0]], _, leaves[arch, True] = model_reference(
                arch, True, shape[0], seq, ("int8",))
        elif not f and arch not in red:
            comps = ("none", "int8") if "none" in rounds else ("int8",)
            *red[arch], leaves[arch, False] = model_reference(
                arch, False, 1, seq, comps)
    return {"full": full, "reduced": red, "leaves": leaves}


def model_rows(refs, got, table, phase, extra=lambda label: None):
    """Each run of ``table`` ({world: runs}) checked against its
    one-process round (``model_checks``).  ``got[world]``: each rank's
    ``model_rank`` result.  -> {label: row}."""
    rows = {}
    for world, runs in table.items():
        for label, arch, f, shape, seq, _ in runs:
            ref = refs["full"][arch, shape[0]] if f \
                else refs["reduced"][arch][0]
            steps = None if f else refs["reduced"][arch][1]
            rows[label] = model_checks(label, got[world], ref, steps, f,
                                       shape[0], refs["leaves"][arch, f],
                                       phase, extra(label))
    return rows


def took_collective(phase, rows, label, kind):
    """A run's cold round must have sent ``kind`` over the model group."""
    kinds = rows[label]["wire_cold_rank0"]["model_by_kind"]
    if not kinds.get(kind, {}).get("calls"):
        raise AssertionError(f"phase {phase}: {label} sent no {kind}: "
                             f"{kinds}")


def phase_model_axis(refs, got):
    """Phase 25: the model axis across ranks, the ranks time-sharing the
    one card over gloo (``MODEL_RUNS``; the ranks are phase 24's, which
    run these after their phase-24 rounds).  World 2 on (1,1,2):
    full-width llama3.2-3b at 2 layers, one int8 round and a faulted one
    (the warm round was cut to keep the script within half its limit);
    full-width
    deepseek-v2-lite-16b at 2 layers (its layer 1 MoE, 32 experts a
    rank), one int8 round and a faulted one; reduced fp32 llama3.2-3b
    (``none``, int8, faulted) and deepseek-v2-lite-16b (int8, faulted).
    World 4: full-width llama3.2-3b on (2,1,2), one int8 round and a
    faulted one; reduced fp32 gemma3-4b on (1,1,4), S 32 (the ring),
    ``none``, int8 and faulted.  Each run against the one-process round
    of the same params and batch on this card (``model_checks``).
    ``got[world]``: each rank's ``model_rank`` result."""
    rows = model_rows(refs, got, MODEL_RUNS, 25)
    took_collective(25, rows, "gemma_114_reduced", "model_ppermute")
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phase 26: the SSM, hybrid, frontend and encoder configs on the model
# axis, and serving across ranks through fl/round.py's serving steps
# ---------------------------------------------------------------------------

FALCON, HYMBA = SSM_ARCHS
INTERNVL, SEAMLESS = FRONT_ARCHS
MODEL26_RUNS = {
    2: [("falcon_112", FALCON, True, (1, 1, 2), FUSED_SEQ,
         ("cold", "warm")),
        ("hymba_112", HYMBA, True, (1, 1, 2), FUSED_SEQ, ("cold", "warm")),
        ("internvl_112", INTERNVL, True, (1, 1, 2), FUSED_SEQ,
         ("cold", "warm")),
        ("seamless_112", SEAMLESS, True, (1, 1, 2), FUSED_SEQ,
         ("cold", "warm")),
        ("falcon_112_reduced", FALCON, False, (1, 1, 2), 64,
         ("cold", "none", "fault", "fault_xproj")),
        ("seamless_112_reduced", SEAMLESS, False, (1, 1, 2), 64,
         ("cold", "none", "fault", "fault_causal"))],
    4: [("hymba_114_reduced", HYMBA, False, (1, 1, 4), GEMMA_RING_SEQ,
         ("cold", "none", "fault")),
        ("internvl_114_reduced", INTERNVL, False, (1, 1, 4), 64,
         ("cold", "none", "fault"))]}
SERVE26_STEPS = 8


def serve26_cfg():
    """Phase 26's serve run: hymba-1.5b at full width and phase 26's
    depth, in fp32 (phase 20's parity tolerance is an fp32 one)."""
    return dataclasses.replace(model_cfg(HYMBA), dtype="float32")


def serve_through_steps(mesh, device):
    """hymba-1.5b (``serve26_cfg``, seed-0 params) through
    ``build_prefill_step`` and ``build_decode_step`` on ``mesh``: a
    prefill of ``LM_BATCH`` prompts of ``LM_PROMPT`` tokens, then
    ``SERVE26_STEPS`` greedy decode steps, with the launch counts zeroed
    just before and read just after.  -> {"logits" (B, 1 + steps, V) on
    the host, "tokens", "digest" of the logits, "prefill_s", "decode_s",
    "launches", "peak_gb"}."""
    cfg = serve26_cfg()
    opts = dataclasses.replace(
        serve_options(cfg, mesh),
        prefill_cache_capacity=LM_PROMPT + SERVE26_STEPS + 8)
    prefill, model = build_prefill_step(cfg, mesh, opts)
    decode, _ = build_decode_step(cfg, mesh)
    params = model.init(seed=0, device=device)
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).to(
            device)
    for k in all_kernels():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, toks, lat = [logits], [logits[:, -1].argmax(-1)[:, None]], []
    for i in range(SERVE26_STEPS):
        t0 = time.perf_counter()
        logits, caches = decode(params, toks[-1], caches, LM_PROMPT + i)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    logits = torch.cat(out, 1)
    row = {"logits": logits.cpu(), "tokens": torch.cat(toks, 1).cpu(),
           "digest": digest([logits]), "prefill_s": prefill_s,
           "decode_s": lat,
           "launches": {k.name: k.launches for k in all_kernels()
                        if k.launches},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, caches, logits, out
    torch.cuda.empty_cache()
    return row


def serve_rank(rank, device):
    """Phase 26's serve run on a rank of world 2, on (1,1,2)."""
    mesh = make_debug_mesh((1, 1, 2), DIST_AXES)
    mesh.wire.stats.clear()
    row = serve_through_steps(mesh, device)
    row["wire"] = {k: dict(v) for k, v in mesh.wire.stats.items()}
    return row


def phase_model_serve(ref, rows):
    """Phase 26's serve check: every rank's logits bit-identical (sha256),
    the greedy tokens the one-process serve's and the logits within
    ``LM_PARITY_ATOL`` (phase 20's) of it; no kernel launched (the
    prefill's attention is the plain flash path, as under the JAX
    ``build_prefill_step``'s ``chunked_sp``).  -> the ``model_serve`` line's row."""
    same = len({r["digest"] for r in rows}) == 1
    err = float((rows[0]["logits"] - ref["logits"]).abs().max())
    tokens = bool((rows[0]["tokens"] == ref["tokens"]).all())
    cfg = serve26_cfg()
    out = {"phase": 26, "arch": HYMBA, "mesh": [1, 1, 2],
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "steps": SERVE26_STEPS,
           "ranks_bit_identical": same, "same_greedy_tokens": tokens,
           "max_abs_diff_one_process": err, "atol": LM_PARITY_ATOL,
           "prefill_s": max(r["prefill_s"] for r in rows),
           "prefill_s_one_process": ref["prefill_s"],
           "decode_p50_ms": 1e3 * max(float(np.median(r["decode_s"]))
                                      for r in rows),
           "decode_p50_ms_one_process": 1e3 * float(
               np.median(ref["decode_s"])),
           "peak_gb": [r["peak_gb"] for r in rows],
           "launches": [r["launches"] for r in rows],
           "wire_rank0": rows[0]["wire"]}
    log("model_serve " + json.dumps(out))
    if not (same and tokens and err <= LM_PARITY_ATOL):
        raise AssertionError(f"phase 26 serve: {out}")
    if any(r["launches"] for r in rows) or ref["launches"]:
        raise AssertionError(f"phase 26 serve launched a kernel: {out}")
    return out


def reckoned_part(arch, full):
    """The fp32 gradient part a rank all-reduces, from ``param_count()``
    at the run's depth."""
    cfg = model_cfg(arch) if full else reduced_cfg(arch)
    n = cfg.param_count()
    return {"param_count": n, "reckoned_part_gb": 4 * n / 1e9}


def phase_model_axis_26(refs, got, serve_ref):
    """Phase 26 (``MODEL26_RUNS``, in the ranks of phases 24 and 25 after
    their rounds): world 2 on (1,1,2), full width in bf16 from seed-0
    params, phase 11's batch: falcon-mamba-7b at 1 layer (d_inner split
    over the model ranks), hymba-1.5b at 2 (the window of 1024 on 1000
    rows a rank takes the all-gather), internvl2-26b at 1 with 256 stub
    patches a sequence (F + S = 768 rows split), seamless-m4t-large-v2
    at 1 encoder and 1 decoder layer with 512 stub frames (the encoder
    non-causal through the context-parallel flash); each a cold int8
    round and a warm one against the one-process round of the same
    params and batch; reduced fp32 falcon-mamba-7b and
    seamless-m4t-large-v2 with model rank 1's part counted twice and,
    each, its family's fault (the ``x_proj`` product unsummed, the
    encoder run causal); then hymba-1.5b served through the serving steps
    (``phase_model_serve``).  World 4 on (1,1,4): reduced fp32
    hymba-1.5b at 32 tokens (its window of 8 takes the ring) and
    internvl2-26b (4 patches + 64 tokens split into 4), each with a part
    counted twice.  ``got[world]``: each rank's ``model_rank`` result;
    ``serve_ref``: the one-process serve."""
    runs = {label: (arch, f) for w in MODEL26_RUNS.values()
            for label, arch, f, *_ in w}
    rows = model_rows(refs, got["model"], MODEL26_RUNS, 26,
                      lambda label: reckoned_part(*runs[label]))
    # an attention-free model gathers only the scan's y and state
    for label in ("falcon_112", "falcon_112_reduced"):
        took_collective(26, rows, label, "model_all_gather")
    took_collective(26, rows, "hymba_114_reduced", "model_ppermute")
    serve = phase_model_serve(serve_ref, got["serve"])
    return {"rows": rows, "serve": serve}


# ---------------------------------------------------------------------------
# phase 27: sharded storage across ranks (FSDP over the batch axes, TP
# storage over the model axis), and the dry run
# ---------------------------------------------------------------------------

#: the sharded round's bf16 arithmetic against the replicated round's: the
#: gathers' adjoint rounds a leaf's gradient summed over the data ranks
#: to bf16 once a microbatch (``launch/dist.py``), where the replicated
#: round sums bf16 gradients in fp32, and each microbatch's bf16 backward
#: runs from a seed of its weight, where the replicated round multiplies
#: after, so every rounding of the backward moves.  Two such bf16
#: computations differ by a few ulps (2^-8) of a leaf's scale (reduced
#: bf16 llama3.2-3b on 4 CPU ranks read up to 0.0093 of the leaf's
#: largest element, at wk): a sharded delta within 2^-5 of its leaf's
#: largest element of the replicated delta, with 3x headroom
FSDP_NONE_RTOL = 2.0 ** -5
#: phase 27's runs on world 4: (label, mesh, hierarchy, sharded rounds);
#: each round takes phase 11's batch as one microbatch (the gathers and
#: their adjoints run once a microbatch: two would double the wire)
FSDP_RUNS = (("a", (2, 2, 1), "hierarchical",
              ("none", "int8_cold", "int8_warm", "int8_fault")),
             ("b", (1, 2, 2), "flat", ("none",)))
FSDP_MICRO = 1


@contextlib.contextmanager
def kept_deltas(kept):
    """Each round's delta as the rank step hands it to the server
    optimizer (this rank's blocks, or whole leaves), appended to
    ``kept``."""
    orig = fl_round.apply_server_opt

    def keep(name, params, state, delta, **kw):
        kept.append([d.detach() for d in tree_leaves(delta)])
        return orig(name, params, state, delta, **kw)

    fl_round.apply_server_opt = keep
    try:
        yield kept
    finally:
        fl_round.apply_server_opt = orig


@contextlib.contextmanager
def pod_scales(kept):
    """The int8 scales of this pod's delta as it enters the pod hop: one
    ``(safe scales, last)`` a leaf appended to ``kept``.  The quantize
    launches of this capture are not the round's: its counts are put
    back."""
    orig = compression.pod_mean_compressed

    def keep(delta, pod, *args, **kw):
        counts = {k: k.launches for k in all_kernels()}
        for leaf in tree_leaves(delta):
            _, safe, last = compression._quantize_blocks_last_axis(leaf, 256)
            kept.append((safe, last))
        for k, n in counts.items():
            k.launches = n
        return orig(delta, pod, *args, **kw)

    compression.pod_mean_compressed = keep
    try:
        yield kept
    finally:
        compression.pod_mean_compressed = orig


@contextlib.contextmanager
def shard_counted_twice(mesh):
    """A planted fault for phase 27: data rank 1's part of every gradient
    gathered over the data axis enters the gathers' adjoint sum twice."""
    wire, orig = mesh.wire, mesh.wire.all_reduce

    def faulted(tensors, group, kind, **kw):
        if kind == "data_psum" and mesh.coord("data") == 1:
            for t in tensors:
                t.mul_(2)
        return orig(tensors, group, kind, **kw)

    wire.all_reduce = faulted
    try:
        yield
    finally:
        del wire.all_reduce


def block_hash(t: torch.Tensor, piece: int = 1 << 24) -> int:
    """A 64-bit hash of a tensor's bits on its device (phase 27's ranks
    compare their blocks by it; sha256 on the host took a second a round
    and rank): Σ word_i · m_i mod 2^64 over its 16- or 32-bit words, m_i
    odd, so a changed word always changes it; ``piece`` words at a time."""
    words = t.detach().contiguous().view(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()])
    h = torch.zeros((), dtype=torch.int64, device=t.device)
    for a in range(0, words.numel(), piece):
        w = words[a:a + piece].long()
        m = torch.arange(a, a + w.numel(), device=t.device) \
            * 0x5851F42D4C957F2D + 0x14057B7EF767814F
        h += (w * (m | 1)).sum()
    return int(h)


def fsdp_round(mesh, step, params, state, batch, fault=None):
    """One round of a rank with its launch counts, wire statistics and
    peak zeroed just before and read just after -> (row, the delta's
    leaves as the server optimizer took them, the new params)."""
    for k in all_kernels():
        k.launches = 0
    mesh.wire.stats.clear()
    kept = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kept_deltas(kept), (fault(mesh) if fault
                             else contextlib.nullcontext()):
        new, _, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    row = {"wall_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "launches": {k.name: k.launches for k in all_kernels()
                        if k.launches},
           "wire": {k: {"calls": v["calls"], "bytes": v["bytes"],
                        "seconds": v["seconds"]}
                    for k, v in mesh.wire.stats.items()}}
    return row, kept[0], new


def none_readings(got, want, maxes, piece=1 << 24):
    """A sharded ``none`` delta's blocks against the replicated delta's
    (on the host) -> (the largest difference over ``FSDP_NONE_RTOL``
    times its leaf's largest replicated element: <= 1, the differences
    |got - want| a leaf on the host, fp32).  ``piece`` elements at a
    time on the card (four ranks share it), in fp64."""
    share, gaps = 0.0, []
    for g, w, m in zip(got, want, maxes):
        allow = FSDP_NONE_RTOL * float(m)
        gap = torch.empty(g.shape, dtype=torch.float32)
        flat, g, w = gap.view(-1), g.reshape(-1), w.reshape(-1)
        for a in range(0, g.numel(), piece):
            d = (g[a:a + piece].double()
                 - w[a:a + piece].to(g.device).double()).abs()
            share = max(share, float(d.max()) / max(allow, 1e-30))
            flat[a:a + piece] = d.float().cpu()
        gaps.append(gap)
    return share, gaps


def int8_readings(got, want, gaps, steps, piece=1 << 24):
    """A sharded int8 delta's blocks against the replicated int8 delta's,
    with the same round's measured ``none`` gap as the allowance: int8
    adds to each pod's delta its rounding, which the two rounds' scales
    s_p and s'_p bound by (s_p + s'_p) / 2, so |int8 difference| <=
    |none difference| + Σ_p (s_p + s'_p) / 2P (``steps``) + 1e-5 -> (the
    share of elements over 1e-5, reported: the bf16 arithmetic moves
    most; the largest (|int8 difference| - |none difference| - 1e-5) in
    steps: <= 1)."""
    over, n, worst = 0, 0, float("-inf")
    for g, w, gap, st in zip(got, want, gaps, steps):
        g, w = g.reshape(-1), w.reshape(-1)
        gap, st = gap.reshape(-1), st.reshape(-1)
        for a in range(0, g.numel(), piece):
            d = (g[a:a + piece].double()
                 - w[a:a + piece].to(g.device).double()).abs()
            over += int((d > 1e-5).sum())
            n += d.numel()
            d -= gap[a:a + piece].to(g.device).double() + 1e-5
            worst = max(worst, float(
                (d / st[a:a + piece].to(g.device).double()).max()))
    return over / n, worst


def pod_step_sums(scales, deltas, mesh, specs=None):
    """Σ_p s_p per element of this rank's block: the int8 scales of each
    leaf's blocks (``pod_scales``) summed over the pods and repeated
    over their blocks, cut to this rank's block of ``specs`` where the
    deltas were whole leaves; on the host."""
    safe = [s for s, _ in scales]
    mesh.wire.all_reduce(safe, mesh.group("pod"), "steps")
    out = []
    for i, ((s, last), d) in enumerate(zip(scales, deltas)):
        st = s.repeat_interleave(min(256, last), -1)[..., :last].reshape(
            d.shape)
        out.append((st if specs is None else shard_leaf(st, specs[i], mesh)
                    ).cpu())
    return out


def fsdp_run(device, cfg, batch, shape, hier, rounds, whole):
    """One run of phase 27 on this rank.  With ``whole`` empty (run a):
    the replicated ``none`` and int8 rounds from seed-0 params first,
    ``none``'s delta kept whole on the host in ``whole`` (run b holds its
    blocks to it: a flat round's mean is the hierarchical one's, every
    microbatch of phase 11's batch having the same weight), int8's
    blocks of this rank and its scales kept.  Then the sharded rounds
    from the same params held as this rank's blocks of
    ``train_shardings``' specs: ``none`` first, whose differences are
    the int8 rounds' allowance."""
    t0 = time.perf_counter()
    mesh = make_debug_mesh(shape, DIST_AXES)
    agg = {c: AggregationConfig(hierarchy=hier, compress=c,
                                num_microbatches=FSDP_MICRO)
           for c in ("none", "int8")}
    step, model = build_train_step(cfg, mesh, agg["none"])
    pspecs, sspecs = train_shardings(model, mesh, agg["none"])
    leaf_specs = tree_leaves(pspecs)
    out = {"rank": mesh.rank, "coords": mesh.coords, "rounds": {}}
    ref = {}
    for comp in () if whole else ("none", "int8"):
        step, _ = build_train_step(cfg, mesh, agg[comp])
        params = model.init(0, device=device)
        scales = []
        with pod_scales(scales) if comp == "int8" else \
                contextlib.nullcontext():
            row, delta, _ = fsdp_round(mesh, step, params,
                                       init_server_state("fedavg", params),
                                       batch)
        whole.setdefault("ref", {})[comp] = {k: row[k]
                                             for k in ("wall_s", "peak_gb")}
        if comp == "none":
            whole["none"] = [d.cpu() for d in delta]
            # each leaf's largest element of the replicated delta
            maxes = torch.stack([d.abs().max().float().cpu()
                                 for d in delta])
            torch.distributed.all_reduce(maxes,
                                         op=torch.distributed.ReduceOp.MAX)
            whole["none_max"] = maxes
        else:
            ref["int8"] = [shard_leaf(d, s, mesh).cpu()
                           for d, s in zip(delta, leaf_specs)]
            ref["steps"] = pod_step_sums(scales, delta, mesh, leaf_specs)
        del params, delta
    out["ref"] = whole["ref"]
    ref["none"] = [shard_leaf(d, s, mesh)
                   for d, s in zip(whole["none"], leaf_specs)]
    torch.cuda.empty_cache()
    blocks = shard_tree(model.init(0, device=device), pspecs, mesh)
    # the server state of the blocks is the blocks of the state
    sblocks = init_server_state("fedavg", blocks)
    aparams = abstract_params(model)
    out["resident_bytes"] = sum(t.numel() * t.element_size()
                                for t in tree_leaves([blocks, sblocks]))
    out["reckoned_bytes"] = block_bytes(aparams, pspecs, mesh) + \
        block_bytes(init_server_state("fedavg", aparams), sspecs, mesh)
    out["replica_bytes"] = sum(t.numel() * t.element_size()
                               for t in tree_leaves(aparams))
    out["split_over"] = [list(split_over(s, mesh)) for s in leaf_specs]
    n_pods = mesh.shape["pod"]
    for name in rounds:
        comp = "int8" if name.startswith("int8") else "none"
        sstep, _ = build_train_step(cfg, mesh, agg[comp],
                                    in_specs=(pspecs, sspecs))
        scales = []
        with pod_scales(scales) if name == "int8_cold" else \
                contextlib.nullcontext():
            row, delta, new = fsdp_round(
                mesh, sstep, blocks, sblocks, batch,
                shard_counted_twice if name.endswith("fault") else None)
        if name == "none":
            share, gaps = none_readings(delta, ref["none"],
                                        whole["none_max"])
            row["readings"] = {"none_limit_share": share}
        elif name != "int8_warm":     # the warm round's bits are the cold's
            if name == "int8_cold":   # Σ_p (s_p + s'_p) / 2P
                steps = [(a + b) / (2 * n_pods) for a, b in zip(
                    ref["steps"], pod_step_sums(scales, delta, mesh))]
            share, worst = int8_readings(delta, ref["int8"], gaps, steps)
            row["readings"] = {"int8_share_over_1e5": share,
                               "int8_worst_steps": worst}
        if not name.endswith("fault"):
            row["digests"] = [block_hash(t) for t in tree_leaves(new)]
        out["rounds"][name] = row
        del delta, new
        torch.cuda.empty_cache()    # four ranks share the card
    del blocks, sblocks
    torch.cuda.empty_cache()
    out["run_s"] = time.perf_counter() - t0
    return out


def fsdp_rank(rank, device):
    """Phase 27 on a rank of world 4: ``FSDP_RUNS`` at full width
    (llama3.2-3b cut to 2 layers, bf16, seed-0 params, phase 11's
    batch), run b held to run a's replicated ``none`` round."""
    exact_matmuls()
    cfg = dist_cfg()
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in CohortTokenLoader(cfg.vocab_size, seq_len=FUSED_SEQ,
                                           n_cohorts=4).round_batch(
                 8, 0).items()}
    whole = {}
    return {label: fsdp_run(device, cfg, batch, shape, hier, rounds, whole)
            for label, shape, hier, rounds in FSDP_RUNS}


def matmul_rate(n: int = 8192) -> float:
    """The card's bf16 dense matmul rate in FLOP/s: ``torch.mm`` of two
    n x n bf16 matrices, CUDA events (``time_ms``)."""
    g = torch.Generator(device="cuda").manual_seed(27)
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16, generator=g)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16, generator=g)
    c = torch.empty_like(a)
    ms = time_ms(lambda: torch.mm(a, b, out=c), reps=10, inner=5)
    return 2.0 * n ** 3 / (ms * 1e-3)


def check_fsdp_peak(what, row, ref) -> None:
    """A sharded round's peak below the replicated round's."""
    if not row["peak_gb"] < ref["peak_gb"]:
        raise AssertionError(f"{what}: peak {row['peak_gb']:.3f} GB, not "
                             f"below the replicated round's "
                             f"{ref['peak_gb']:.3f}")


def check_fsdp_launches(what, row, want) -> None:
    """A sharded round's kernel launches: quantize once a leaf and
    dequantize once a leaf and pod in an int8 round, nothing else."""
    if row["launches"] != want:
        raise AssertionError(f"{what}: launches {row['launches']}, not "
                             f"{want}")


def phase_fsdp(rows):
    """Phase 27's checks (module docstring), one ``fsdp_round`` line a
    run, ``fsdp_dryrun`` (the dry run of run a's cell, rank 0, against
    the real rank 0) and ``bf16_matmul`` (the card's rate beside that
    cell's FLOPs)."""
    out = {}
    leaves = len(tree_leaves(build_model(dist_cfg()).init(0, device="meta")))
    for label, shape, hier, rounds in FSDP_RUNS:
        runs = [r[label] for r in rows]
        n_pods = shape[0]
        row = {"run": label, "mesh": shape, "hierarchy": hier,
               "fsdp": "data" if hier == "hierarchical" else "pod,data",
               "replicated_run": FSDP_RUNS[0][0],
               "resident_gb": [r["resident_bytes"] / 1e9 for r in runs],
               "replica_gb": runs[0]["replica_bytes"] / 1e9,
               "run_s": max(r["run_s"] for r in runs),
               "replicated_wall_s": {c: max(r["ref"][c]["wall_s"]
                                            for r in runs)
                                     for c in runs[0]["ref"]},
               "replicated_peak_gb": {c: [r["ref"][c]["peak_gb"]
                                          for r in runs]
                                      for c in runs[0]["ref"]}}
        for name in rounds:
            rr = [r["rounds"][name] for r in runs]
            row[name] = {
                "wall_s": max(x["wall_s"] for x in rr),
                "peak_gb": [x["peak_gb"] for x in rr],
                "readings": {k: max(x["readings"][k] for x in rr)
                             for k in rr[0].get("readings", {})},
                "launches": [x["launches"] for x in rr],
                "metrics": rr[0]["metrics"],
                "wire": {k: {"calls": v["calls"], "bytes": v["bytes"],
                             "seconds": max(x["wire"][k]["seconds"]
                                            for x in rr)}
                         for k, v in rr[0]["wire"].items()}}
        log("fsdp_round " + json.dumps(row))
        for r in runs:
            if r["resident_bytes"] != r["reckoned_bytes"] or \
                    not r["resident_bytes"] < r["replica_bytes"]:
                raise AssertionError(f"phase 27 {label}: rank {r['rank']} "
                                     f"holds {r['resident_bytes']} bytes, "
                                     f"reckoned {r['reckoned_bytes']}")
            for name, rnd in r["rounds"].items():
                what = f"phase 27 {label} {name}, rank {r['rank']}"
                int8 = name.startswith("int8")
                check_fsdp_peak(what, rnd, r["ref"]["int8" if int8
                                                   else "none"])
                check_fsdp_launches(what, rnd, {
                    QUANTIZE.name: leaves, DEQUANTIZE.name: leaves * n_pods}
                    if int8 else {})
                if name == "int8_warm":
                    continue              # held to the cold round's bits
                reading = rnd["readings"]
                bad = reading["int8_worst_steps"] > 1 if int8 else \
                    reading["none_limit_share"] > 1
                if name.endswith("fault") != bad:
                    raise AssertionError(f"{what}: {reading}")
        # ranks that hold the same block of a leaf hold the same bits
        for name in (n for n in rounds if not n.endswith("fault")):
            for i, axes in enumerate(runs[0]["split_over"]):
                holders = {}
                for r in runs:
                    key = tuple(c for a, c in zip(DIST_AXES, r["coords"])
                                if a in axes)
                    holders.setdefault(key, set()).add(
                        r["rounds"][name]["digests"][i])
                if any(len(d) != 1 for d in holders.values()):
                    raise AssertionError(f"phase 27 {label} {name}: leaf "
                                         f"{i}'s holders differ")
        if "int8_warm" in rounds and any(
                r["rounds"]["int8_warm"]["digests"]
                != r["rounds"]["int8_cold"]["digests"] for r in runs):
            raise AssertionError(f"phase 27 {label}: two int8 rounds from "
                                 "the same blocks differ")
        out[label] = row
    # (c) the dry run of run a's cell, rank 0, against the real rank 0
    label, shape, hier, _ = FSDP_RUNS[0]
    t0 = time.perf_counter()
    cell = dry_run_cell(dist_cfg(), ShapeConfig("phase27", FUSED_SEQ, 8,
                                                "train"),
                        stand_in_mesh(shape, DIST_AXES, 0),
                        AggregationConfig(hierarchy=hier, compress="int8",
                                          num_microbatches=FSDP_MICRO),
                        fsdp=("data",))
    real0 = rows[0][label]
    real_wire = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                 for k, v in real0["rounds"]["int8_cold"]["wire"].items()}
    dry = {"resident_bytes": cell["memory"]["resident_bytes"],
           "real_resident_bytes": real0["resident_bytes"],
           "wire": cell["wire"], "real_wire": real_wire,
           "peak_bytes_per_device": cell["memory"]["peak_bytes_per_device"],
           "real_peak_gb": real0["rounds"]["int8_cold"]["peak_gb"],
           "flops": cell["cost"]["flops"], "bytes": cell["cost"]["bytes"],
           "trace_s": cell["trace_s"], "wall_s": time.perf_counter() - t0}
    log("fsdp_dryrun " + json.dumps(dry))
    if dry["resident_bytes"] != dry["real_resident_bytes"] or \
            dry["wire"] != real_wire:
        raise AssertionError(f"phase 27 (c): the dry run predicted {dry}")
    # (d) the card's bf16 matmul rate, beside (c)'s roofline (a
    # production cell's dry run is a CPU job: tests/test_torch_dryrun.py
    # and ``python -m repro_torch.launch.dryrun``)
    rate = matmul_rate()
    log("bf16_matmul " + json.dumps({
        "card": device_line(), "n": 8192, "flops_per_s": rate,
        "cell": "phase 27 (a), rank 0", "cell_flops": cell["cost"]["flops"],
        "compute_s_at_measured_rate": cell["cost"]["flops"] / rate,
        "roofline": cell["roofline"]}))
    out["dryrun"] = dry
    out["matmul_flops"] = rate
    return out


def rank_phases(rank, device, world):
    """What each rank of phases 24 to 27 runs, in one process: phase 24's
    rounds (``dist_rank``: (2,1,1) in world 2, (2,2,1) in world 4), then
    phase 25's (``model_rank`` over ``MODEL_RUNS[world]``), then phase
    26's (``MODEL26_RUNS[world]``, and in world 2 the serve run), then in
    world 4 phase 27's (``fsdp_rank``), so a world starts once and pays a
    fresh process's first touch once.  -> {"dist", "model", "model26",
    "serve26", "fsdp27", "seconds" of each}."""
    t0 = time.perf_counter()
    dist = dist_rank(rank, device, (2, 1, 1) if world == 2 else (2, 2, 1),
                     world == 2)
    t1 = time.perf_counter()
    model = model_rank(rank, device, MODEL_RUNS[world])
    t2 = time.perf_counter()
    model26 = model_rank(rank, device, MODEL26_RUNS[world])
    serve26 = serve_rank(rank, device) if world == 2 else None
    t3 = time.perf_counter()
    fsdp27 = fsdp_rank(rank, device) if world == 4 else None
    return {"dist": dist, "model": model, "model26": model26,
            "serve26": serve26, "fsdp27": fsdp27,
            "seconds": {"phase_24": t1 - t0, "phase_25": t2 - t1,
                        "phase_26": t3 - t2,
                        "phase_27": time.perf_counter() - t3}}


def phase_ranks():
    """Phases 24, 25 and 26 and phase 27's rounds, which share one spawn
    a world (``rank_phases``): the one-process references of phases 25
    and 26, then phase 24 (which spawns each world and checks
    its part), then the checks of phases 25 and 26.  A world's start and its
    ranks' first touch count in phase 24; phase 25's and 26's time is
    each's references, checks and, a world, the slowest rank's rounds.
    -> (phase 24's result, phase 25's, phase 26's, phase 27's rows of
    world 4, the slowest rank's seconds in them)."""
    t0 = time.perf_counter()
    refs = model_references([r for w in MODEL_RUNS.values() for r in w])
    ref_s = time.perf_counter() - t0
    refs26 = model_references([r for w in MODEL26_RUNS.values() for r in w])
    serve_ref = serve_through_steps(make_debug_mesh((1, 1, 1), DIST_AXES), "cuda")
    ref26_s = time.perf_counter() - t0 - ref_s
    torch.cuda.empty_cache()    # the ranks share the card with this process
    got = {}

    def spawn(world):
        got[world] = spawn_ranks(rank_phases, world, world, timeout_s=600)
        return [r["dist"] for r in got[world]]

    t1 = time.perf_counter()
    dist = phase_dist_round(spawn)
    t2 = time.perf_counter()
    model = phase_model_axis(refs, {w: [r["model"] for r in rows]
                                    for w, rows in got.items()})
    t3 = time.perf_counter()
    model26 = phase_model_axis_26(refs26, {
        "model": {w: [r["model26"] for r in rows]
                  for w, rows in got.items()},
        "serve": [r["serve26"] for r in got[2]]}, serve_ref)
    ranks_s = {k: {w: max(r["seconds"][k] for r in rows)
                   for w, rows in got.items()}
               for k in ("phase_24", "phase_25", "phase_26", "phase_27")}
    model.update(references_s=ref_s, ranks_s=ranks_s["phase_25"],
                 phase_25_s=ref_s + sum(ranks_s["phase_25"].values())
                 + t3 - t2)
    model26.update(references_s=ref26_s, ranks_s=ranks_s["phase_26"],
                   phase_26_s=ref26_s + sum(ranks_s["phase_26"].values())
                   + time.perf_counter() - t3)
    rank27_s = sum(ranks_s["phase_27"].values())
    dist["phase_24_s"] = t2 - t1 - sum(ranks_s["phase_25"].values()) \
        - sum(ranks_s["phase_26"].values()) - rank27_s
    log("phases_24_26 " + json.dumps({
        "phase_24_s": dist["phase_24_s"], "phase_25_s": model["phase_25_s"],
        "phase_26_s": model26["phase_26_s"],
        "phase_27_ranks_s": rank27_s,
        "phase_25_references_s": ref_s, "phase_26_references_s": ref26_s,
        "ranks_s": ranks_s, "wall_s": time.perf_counter() - t0}))
    return dist, model, model26, [r["fsdp27"] for r in got[4]], rank27_s


def fsdp_launches(kern, fsdp):
    """A quantize kernel's launches on each rank of phase 27's int8
    rounds."""
    return {f"phase 27: run {label} (sharded storage), {name}, each rank":
                [n.get(kern.name, 0) for n in fsdp[label][name]["launches"]]
            for label, _, _, rounds in FSDP_RUNS
            for name in rounds if name.startswith("int8")}


def model_launches(kern, model, phase=25):
    """A quantize kernel's launches on each rank of phase 25's or 26's
    int8 rounds."""
    key = ("quantize_launches" if kern is QUANTIZE
           else "dequantize_launches")
    return {f"phase {phase}: {label}, int8 round, each rank": row[key]
            for label, row in model["rows"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # each phase group's wall, printed as the ``phase_seconds`` line
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now

    # phase 1: device
    card = device_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    exact_matmuls()
    matmul = torch.backends.cuda.matmul
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={matmul.allow_tf32} "
        f"allow_bf16_reduced_precision_reduction="
        f"{matmul.allow_bf16_reduced_precision_reduction}")

    # phase 2: build (one nvcc per source, all at once) + copy bandwidth
    t0 = time.perf_counter()
    sources = (fed.LIB, *FA_LIBS, Q_LIB)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda lib: lib.build(), sources))
    log(f"build: {', '.join(str(l.relative_to(ROOT)) for l in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    copy_bps = copy_bandwidth()
    lap("1-2 device, build, copy rate")
    log(f"copy bandwidth: {copy_bps / 1e9:.1f} GB/s device-to-device "
        f"(nominal {NOMINAL_BPS / 1e9:.0f})")

    # phase 3: kernels against their plain versions
    cases = phase_kernels(copy_bps)

    # phase 4: engine
    stage_s = phase_engine()

    lap("3-4 kernels, engine")

    # phase 5: the main path
    rounds, launches, k_main = phase_round()
    phase_parity()
    lap("5 ResNet round, parity")

    # phases 6-8: the flash kernels, the serve path, the LM checks
    flash_rows = phase_flash()
    serve_row, flash_launches, flash_main = phase_serve(copy_bps)
    fp32_row, fp32_dev = phase_fp32_prefill()
    tf32_lm_launches = phase_lm_checks()
    lap("6-8 flash, serve, fp32 prefill, LM checks")

    # phase 18: MoE / MLA serving, full-width deepseek-v2-lite-16b
    moe_row = phase_moe_serve(copy_bps)
    lap("18 MoE serve")

    # phases 10-12: the quantize kernels, the fused round, its parity
    _, quant_rows = phase_quant()
    fused_row, fused_dev = phase_fused_round()
    phase_round_parity()
    lap("10-12 quantize, fused round, parity")

    # phase 19: the MoE / MLA fused round, deepseek-v2-lite-16b
    moe_round, moe_round_dev, _ = phase_moe_round()
    launches19 = moe_round["launches_int8"]
    lap("19 MoE round")

    # phase 20: SSM / hybrid serving, full-width falcon-mamba-7b and
    # hymba-1.5b (phase 19's model is freed)
    ssm_cells, ssm_flash = phase_ssm_serve(copy_bps)
    launches20 = {name: sum(launches[name] for _, launches in
                            ssm_cells.values())
                  for name in ssm_cells[SSM_ARCHS[0]][1]}
    lap("20 SSM serve")

    # phase 21: frontend and encoder-decoder serving, full-width
    # internvl2-26b and seamless-m4t-large-v2 (phase 20's models are
    # freed)
    t21 = time.perf_counter()
    front_cells, front_flash = phase_front_serve(copy_bps)
    front_s = time.perf_counter() - t21
    launches21 = {name: sum(launches[name] for _, launches in
                            front_cells.values())
                  for name in front_cells[FRONT_ARCHS[0]][1]}
    lap("21 frontend serve")

    # phases 22-23: the fused round of internvl2-26b and
    # seamless-m4t-large-v2, then of falcon-mamba-7b and hymba-1.5b, at
    # full width (phase 21's models are freed)
    t22 = time.perf_counter()
    bytes_a_param = fused_row["peak_mem_gb_int8"] * 1e9 / fused_row["params"]
    front_train = phase_train_rounds(FRONT_ARCHS, "front_round_parity",
                                     bytes_a_param)
    t23 = time.perf_counter()
    ssm_train = phase_train_rounds(SSM_ARCHS, "ssm_round_parity",
                                   bytes_a_param, ssm_chunk=PARITY_SSM_CHUNK)
    train_s = {"phase_22_s": t23 - t22,
               "phase_23_s": time.perf_counter() - t23}
    train_cells = {**front_train, **ssm_train}
    lap("22-23 frontend and SSM rounds")

    def train_launches(kern, phase, cells):
        """A kernel's launches in each of a phase's int8 rounds."""
        return {f"phase {phase}: {arch} fused round ({row['layers']} of "
                f"{row['full_depth_layers']} layers)":
                    row["launches_int8"][kern.name]
                for arch, (row, _) in cells.items()}

    # phases 13-15: phase 5's workload on the shmproc and multi-node
    # runtimes and through serve mode (the kernels were built in phase
    # 2, before any daemon starts)
    fleet = resnet_fleet()
    with deterministic_convs():
        shm_row = phase_shmproc(fleet)
        net_row = phase_multinode(fleet)
    landed = [d for d in net_row["daemons"]
              if d["daemon"]["updates_landed"] > 0]
    if not landed or any(not d["device"].startswith("cuda")
                         for d in net_row["daemons"]):
        raise AssertionError(f"the daemons did not fold on the card: "
                             f"{net_row['daemons']}")
    for d in landed:
        check_fold_launches(f"netd {d['node']}", d["kernel_launches"],
                            ("eager_accumulate",))
    ingest_row = phase_serve_ingest(fleet)
    check_fold_launches("the serve round", ingest_row["launches"],
                        ("eager_accumulate",))
    lap("13-15 shmproc, multinode, serve mode")

    # phases 16-17: the always-on service over phase 5's fleet, and job
    # a's checkpoint; the engines' fold speedup for the simulator
    ckpt_dir = ROOT / "build" / "phase17_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    svc_row, svc_params, ckpt = phase_service(fleet, ckpt_dir)
    ckpt_row = phase_checkpoint(svc_params, ckpt, ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    speedup = engine_speedup()
    log("engine_speedup " + json.dumps(speedup))
    del fleet, svc_params
    lap("16-17 service, checkpoint")

    # phases 24-26: the fused round with one process a mesh coordinate,
    # the ranks on this card over gloo, then the model axis across ranks
    # in the same rank processes
    torch.cuda.empty_cache()
    dist, model, model26, fsdp_rows, rank27_s = phase_ranks()
    lap("24-26 ranks")

    # phase 27: sharded storage's checks (its rounds ran in world 4's
    # ranks above), the dry run of its cell, the bf16 matmul rate
    fsdp = phase_fsdp(fsdp_rows)
    lap("27 sharded storage, dry run")
    phase_s["24-26 ranks"] -= rank27_s
    phase_s["27 sharded storage, dry run"] += rank27_s

    # phase 9: summary at the main paths' shapes (f32 wire; the lazy
    # round's largest burst for fedavg_accumulate_k): the phase-3 rows
    # where they are those shapes
    main_k = {"eager_accumulate": 1, "fedavg_accumulate_k": max(k_main, 2),
              "fedavg_reduce": 8}
    measured = {(r["name"], r["K"]): r for r in cases
                if r["dtype"] == "float32" and r["view"] == [0, 0]}
    out = []
    for kern in fed.KERNELS:
        k = main_k[kern.name]
        row = measured.get((kern.name, k)) or kernel_case(
            kern.name, torch.float32, k, copy_bps)
        out.append({
            "name": kern.name, "route": "cuda",
            "source": "src/repro_torch/kernels/fedavg/csrc/fedavg.cu",
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            **({"previous_ms": row["previous_ms"]}
               if kern is fed.EAGER else {}),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "K": row["K"], "N": row["N"],
            "bound_copy_ms": row["bound_copy_ms"],
            "launches_by_path": {
                "phase 5: ResNet rounds, inproc": launches[kern.name],
                "phase 13: shmproc, controller (workers fold with numpy)":
                    shm_row["launches"][kern.name],
                "phase 14: multi-node, in netd": sum(
                    d["kernel_launches"][kern.name]
                    for d in net_row["daemons"]),
                "phase 14: multi-node, controller":
                    net_row["launches"][kern.name],
                "phase 15: serve round, inproc":
                    ingest_row["launches"][kern.name],
                "phase 16: service, two jobs, inproc":
                    svc_row["launches"][kern.name],
                "phase 19: MoE fused round": launches19[kern.name],
                "phase 20: SSM / hybrid serve": launches20[kern.name],
                "phase 21: frontend / enc-dec serve":
                    launches21[kern.name],
                **train_launches(kern, 22, front_train),
                **train_launches(kern, 23, ssm_train)}})
    kernel_ms = sum(launches[o["name"]] * o["ms"] for o in out) / 1e3
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/"

    def flash_paths(kern):
        """A flash kernel's launches on each path that runs attention."""
        return {"phase 7: bf16 prefill":
                    serve_row["flash_launches"][kern.name],
                "phase 7: bf16 prefill, the mma.sync kernel named":
                    serve_row["launches_mma"][kern.name],
                "phase 7b: fp32 prefill": fp32_row["launches"][kern.name],
                "phase 7b: fp32 prefill, the CUDA-core kernel named":
                    fp32_row["launches_cuda_core"][kern.name],
                "phase 8: fp32 serve loop":
                    tf32_lm_launches * int(kern is FLASH_TF32X3),
                "phase 11: fused round":
                    fused_row["launches_int8"][kern.name],
                "phase 19: MoE fused round": launches19[kern.name],
                **{f"phase 20: {arch} serve": launches[kern.name]
                   for arch, (_, launches) in ssm_cells.items()},
                **{f"phase 21: {arch} serve": launches[kern.name]
                   for arch, (_, launches) in front_cells.items()},
                **train_launches(kern, 22, front_train),
                **train_launches(kern, 23, ssm_train)}

    def noncausal(row):
        """A kernel's non-causal case (phase 6, seamless's encoder)."""
        return {k: row[k] for k in (
            "case", "shape", "dtype", "aligned", "max_abs_err",
            "limit_share", "ms", "previous_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "causal_plain_vs_kernel")}

    out.append({
        "name": FLASH_WGMMA.name, "route": "cuda",
        "source": flash_src + "flash_attention_sm90.cu",
        "replaces": FLASH_WGMMA.replaces, "launches": flash_launches,
        "launches_path": "phase 7: the bf16 prefill",
        "launches_by_path": flash_paths(FLASH_WGMMA),
        **{k: flash_main[k] for k in (
            "max_abs_err", "ms", "previous_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape", "dtype")},
        "noncausal": noncausal(flash_rows["seamless_encoder", "bfloat16"])})
    tf32_row = flash_rows["path", "float32"]
    out.append({
        "name": FLASH_TF32X3.name, "route": "cuda",
        "source": flash_src + "flash_attention_tf32x3.cu",
        "replaces": FLASH_TF32X3.replaces,
        "launches": fp32_row["launches"][FLASH_TF32X3.name],
        "launches_path": "phase 7b: the fp32 prefill",
        "launches_by_path": flash_paths(FLASH_TF32X3),
        **{k: tf32_row[k] for k in (
            "max_abs_err", "limit_share", "ms", "previous_ms", "plain_ms",
            "bound_ms", "bound_simt_ms", "bound_by", "library_ms", "shape",
            "dtype")},
        "noncausal": noncausal(flash_rows["seamless_encoder", "float32"])})
    mma_row = flash_rows["h2o_danube3_unaligned", "bfloat16"]
    out.append({
        "name": FLASH_MMA.name, "route": "cuda",
        "source": flash_src + "flash_attention_mma.cu",
        "replaces": FLASH_MMA.replaces,
        "launches": serve_row["launches_mma"][FLASH_MMA.name],
        "launches_path": "phase 7: the bf16 prefill with this kernel "
                         "named in the wgmma kernel's place",
        "launches_by_path": flash_paths(FLASH_MMA),
        "previous": {"name": FLASH_SIMT.name,
                     "source": flash_src + "flash_attention.cu",
                     "launches_by_path": flash_paths(FLASH_SIMT)},
        **{k: mma_row[k] for k in (
            "max_abs_err", "limit_share", "ms", "previous_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "dtype",
            "aligned", "moved_back_plain_vs_kernel")},
        "noncausal": noncausal(
            flash_rows["seamless_encoder_unaligned", "bfloat16"])})

    for kern in Q_KERNELS:
        r = quant_rows[kern.name]
        out.append({
            "name": kern.name, "route": "cuda",
            "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
            "replaces": kern.replaces,
            "launches": fused_row["launches_int8"][kern.name],
            "launches_by_path": {
                "phase 11: fused round, llama3.2-3b":
                    fused_row["launches_int8"][kern.name],
                f"phase 19: MoE fused round, {MOE_ARCH} "
                f"({MOE_ROUND_LAYERS} layers)": launches19[kern.name],
                "phase 20: SSM / hybrid serve": launches20[kern.name],
                "phase 21: frontend / enc-dec serve":
                    launches21[kern.name],
                **train_launches(kern, 22, front_train),
                **train_launches(kern, 23, ssm_train),
                **dist_launches(kern, dist),
                **model_launches(kern, model),
                **model_launches(kern, model26, 26),
                **fsdp_launches(kern, fsdp)},
            **{k: r[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "rows")}})
    lap("9 kernels line")
    log("phase_seconds " + json.dumps(
        {**phase_s, "script_s": time.perf_counter() - SCRIPT_T0}))
    log("summary " + json.dumps({
        "rounds": len(rounds),
        "client_train_s": sum(r["trace_client_train_s"] for r in rounds),
        "agg_exec_s": sum(r["agg_exec_s"] for r in rounds),
        "kernel_s_est": kernel_ms,
        "staging_s_per_fold": stage_s,
        "wall_s": sum(r["wall_s"] for r in rounds),
        "serve_prefill_ms": serve_row["prefill_ms"],
        "serve_decode_p50_ms": serve_row["decode_p50_ms"],
        "flash_ms_est": flash_launches * flash_main["ms"],
        "serve_prefill_mma_ms": serve_row["prefill_mma_ms"],
        "fp32_prefill_ms": fp32_row["prefill_ms"],
        "fp32_prefill_cuda_core_ms": fp32_row["prefill_cuda_core_ms"],
        "fp32_prefill_flash_share": fp32_dev["flash_share"],
        "moe_serve_prefill_ms": moe_row["prefill_ms"],
        "moe_serve_decode_p50_ms": moe_row["decode_p50_ms"],
        "moe_serve_peak_mem_gb": moe_row["peak_mem_gb"],
        "fused_round_warm_s": fused_row["int8_warm_s"],
        "fused_round_quant_ms": fused_dev["quantize_ms"]
        + fused_dev["dequantize_ms"],
        "moe_round_warm_s": moe_round["int8_warm_s"],
        "moe_round_peak_mem_gb": moe_round["peak_mem_gb_int8"],
        "moe_round_idle_share": moe_round_dev["idle_share"],
        **{f"{arch}_{key}": row[key] for arch, (row, _) in ssm_cells.items()
           for key in ("prefill_ms", "decode_p50_ms", "peak_mem_gb")},
        "hymba_flash_max_limit_share": max(r["limit_share"]
                                           for r in ssm_flash),
        **{f"{arch}_{key}": row[key] for arch, (row, _) in
           front_cells.items() for key in ("prefill_ms", "decode_p50_ms",
                                           "peak_mem_gb")},
        "front_flash_max_limit_share": max(r["limit_share"]
                                           for r in front_flash),
        "front_phase_s": front_s,
        **{f"{arch}_train_{key}": row[key]
           for arch, (row, _) in train_cells.items()
           for key in ("int8_warm_s", "peak_mem_gb_int8", "kernels_a_round")},
        **{f"{arch}_train_idle_share": split["idle_share"]
           for arch, (_, split) in train_cells.items()},
        **{f"{arch}_train_scan_share": split["scan_ms"] / split["busy_ms"]
           for arch, (_, split) in ssm_train.items()},
        **train_s,
        **{f"dist_{w}_{key}": dist[w][key] for w in ("world2", "world4")
           for key in ("int8_cold_s", "int8_warm_s")},
        "dist_phase_24_s": dist["phase_24_s"],
        **{f"model_{label}_{key}": row[key]
           for label, row in model["rows"].items()
           for key in ("cold_s", "warm_s") if key in row},
        "model_phase_25_s": model["phase_25_s"],
        **{f"model26_{label}_{key}": row[key]
           for label, row in model26["rows"].items()
           for key in ("cold_s", "warm_s") if key in row},
        "model26_serve_prefill_s": model26["serve"]["prefill_s"],
        "model26_phase_26_s": model26["phase_26_s"],
        **{f"fsdp_{label}_{name}_wall_s": fsdp[label][name]["wall_s"]
           for label, _, _, rounds in FSDP_RUNS for name in rounds},
        "fsdp_dryrun_trace_s": fsdp["dryrun"]["trace_s"],
        "bf16_matmul_tflops": fsdp["matmul_flops"] / 1e12,
        "shmproc_warm_wall_s": shm_row["warm_wall_s"],
        "shmproc_fork_cold_s": shm_row["stats"]["cold_latency_s"],
        "shmproc_fork_warm_s": shm_row["stats"]["warm_latency_s"],
        "multinode_warm_wall_s": net_row["warm_wall_s"],
        "multinode_compressed_ratio": net_row["compressed_ratio"],
        "service_wall_s": svc_row["wall_s"],
        "service_warm_round_wall_s": {
            j: r["warm_round_wall_s"] for j, r in svc_row["jobs"].items()},
        "service_pipeline_overlap": svc_row["pipeline_overlap"],
        "publish_host_copies_per_publish": svc_row["host_copies_per_publish"],
        "publish_copy_ms": svc_row["publish_copy_ms"],
        "checkpoint_submit_ms": ckpt_row["submit_ms"],
        "checkpoint_write_ms": ckpt_row["write_ms"],
        "torch_engine_speedup": speedup["speedup"]["torch"]}))
    log(json.dumps({"kernels": out}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
