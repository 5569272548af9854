#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version on the card, serve a 2:4-pruned
Qwen1.5-0.5B at full width through ``ServeEngine.generate`` with the
reference's serve defaults (the prefix cache, copy-on-write attach, host
swap, cancel), sampled and in static mode, run the pruning launcher's
default path — the pipelined engine, Algorithm 1 with MM 2:4 — on it at
full width and depth, train, prune and serve the tiny LM with the port's
own trainer, serve Jamba-1.5-Large's blocks without the experts at full
width, run the paper's Table 3 on the tiny Mamba LM, serve the pruned
Qwen1.5-0.5B over HTTP/SSE through the front end (two replicas, the
supervisor, injected faults, the CLI's server), and serve and prune
gemma-2b, Qwen3-14B and Gemma3-12B at full width (head dim 256, qk-norm,
sliding-window layers), and the Mixture-of-Experts models — phi3.5-moe,
kimi-k2 and Jamba with its experts — served static at full width, phi3.5
pruned — the xLSTM: xlstm-350m served 2:4-packed, pruned and trained
at full width — and the prefix-LM and the encoder-decoder: paligemma-3b
and seamless-m4t-large-v2 served static 2:4-packed, pruned and trained
at full width — and distribution: a 1-rank NCCL group and two ranks
sharing the card, pruning and training over a DeviceMesh.

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any failure
    python3 chip_smoke.py --phases 1,12   # phase 1's hd-256 / window /
                                          # new-width / weighted rows and
                                          # phase 12 only (or a part of it:
                                          # 12a ... 12d)
    python3 chip_smoke.py --phases 1w,13  # the weighted hessian_accum rows
                                          # and phase 13 (or 13a ... 13c);
                                          # 1m: the MoE widths' rows
    python3 chip_smoke.py --phases 1x,14  # the xLSTM widths' rows and
                                          # phase 14 (or 14a ... 14d)
    python3 chip_smoke.py --phases 1e,15  # flash_attn with a prefix and
                                          # S != T, the frontend models'
                                          # widths, and phase 15 (or 15a
                                          # ... 15e)
    python3 chip_smoke.py --phases 15e,16 # the frontend models trained,
                                          # and distribution (16a, 16b,
                                          # 16c, 16d)
    python3 chip_smoke.py --phases 1t,16d # 16c's, 16d's and 16e's
                                          # rank-local kernel shapes;
                                          # tensor-parallel serving of the
                                          # recurrent and expert families
                                          # alone (16c: the dense
                                          # decoders'; 16e: the prefix-LM
                                          # and the encoder-decoder; 16f:
                                          # the server under the mesh):
                                          # its one-device runs and the
                                          # two ranks' (no 16a / 16b)
    python3 chip_smoke.py --phases 16g    # training with FSDP on 2x1 and
                                          # tensor-parallel on 1x2, and a
                                          # resume across them: one
                                          # device's runs, then the two
                                          # ranks'

Phases (any failure exits non-zero; no exception is swallowed):

  0. the card's name and power limit, and the kernels' build time;
  1. every kernel against its plain version at the main paths' shapes —
     the seven Qwen linears at M = 8 (decode) and M = 32 (prefill chunk)
     through nm_spmm_decode, and at M = 1, 16, 64, 128 on attn.wq (bias)
     and mlp.wg (silu), the same seven at M = 256 through nm_spmm,
     paged_attn at B = 8 with ragged lengths, an idle slot, a window and
     int8 pages, at the long-prompt run's B = 8 with one slot at 544 keys
     in a 36-page table, at B = 1 over 544 keys, at gemma-2b's G 8 /
     hd 256, and at B = 8 with every live row's first 3 pages shared (a
     prefix-cache attach; bf16 and int8 pages) (each row on f32 and bf16
     inputs, its plan printed, idle slots exact zeros, the same bits
     twice); hessian_accum at m = 1024 / 2816 on T = 16384 tokens
     (one serial batch; α = 1, β = 0 and the streaming-mean α, β), at a
     ragged m = 130 on T = 4097, and on T = 262144 (the pipelined
     engine's stacked capture); nm_select on 128-column blocks and whole
     matrices of the seven Qwen linears (masks bit-equal to the plain
     version's, vector route); flash_attn in f32 and bf16,
     causal and not, T in {128, 129, 200, 257, 2048}, G in {1, 2}, then
     at (8, 2048, 16, 64) and (128, 2048, 16, 64) bf16; nm_spmm also at
     ragged M = 257, (200, 132, 200) and with padding-slot groups; then
     flash_attn at head dim 256 (f32 and bf16, causal and not, T in {128,
     129, 257, 2048}, G in {1, 2, 8}) and over a sliding window (1024 at
     T 2048 and 2100, 64 at T 257), timed at gemma-2b's and Gemma3-12B's
     stacked captures beside SDPA, and nm_spmm_decode (M 8) / nm_spmm
     (M 256) at Qwen3-14B's seven linears and gemma-2b's mlp.wo (K
     16384) and attn.wk (N 256) beside torch.matmul, the same at phase
     13b's packed linears (phi3.5's and kimi-k2's attention, kimi-k2's
     shared expert: K 7168 <-> 2048) and flash_attn at their 32 / 8 and
     64 / 8 heads, hd 128 (f32 and bf16, T 64 / 129 / 2048); hessian_accum's
     weighted form at phi3.5's expert shapes (T 40960, m 4096 / 6400;
     bool weights on the tensor cores, float weights on the f32 FMA,
     beside torch.addmm on the weighted f32 copy; the count on the card
     with no host sync), an all-zero w, f32 and ragged rows; and
     nm_spmm_decode (M 8) / nm_spmm (M 256) at xlstm-350m's packed
     widths (K 1024 -> N 2048, 2048 -> 1024, 1024 -> 1024) beside
     torch.matmul, hessian_accum at m 2048; flash_attn with the
     prefix-LM's bidirectional prefix (prefix_len 1, 63, 64, 65, 256 and
     320 at PaliGemma's (8, 320, 8, 1, 256), and at hd 64 with G 1 and 2)
     and non-causal with S != T ((T, S) = (1, 1024), (64, 1024), (200,
     129), (1024, 1024) at seamless's 16 / 16 heads, hd 64), f32 and bf16,
     the bf16 rows at the two models' shapes timed beside masked SDPA;
     nm_spmm_decode / nm_spmm at PaliGemma's mlp.wo (K 16384; M 8 and
     the 8 x 320 prefill) and seamless's mlp.wi and xattn.wk (M 8 and the
     8 x 1024 frames) beside torch.matmul; and 16c's and 16d's rank-local shapes
     on a 1x2 mesh (``check_tp_widths``): nm_spmm_decode (M 8) / nm_spmm
     (M 256) at Qwen1.5-0.5B's and Qwen3-14B's column- and row-parallel
     halves (K 1408 / 512 / 8704 / 2560, N 1408 / 512 / 2560 / 8704),
     paged_attn at their local 8 KV heads (hd 64) and 4 KV heads of G 5
     (hd 128), and flash_attn at their half heads (8 / 8, hd 64; 20 / 4,
     hd 128) — 16d's: Jamba's Mamba halves (in_proj's x and z blocks K
     8192 -> N 16384, x_proj row-parallel K 8192 -> 544, dt_proj 512 ->
     8192, out_proj K 8192) and MLP halves (8192 <-> 12288), xlstm-350m's
     mLSTM (1024 -> 1024, wo K 1024) and sLSTM (1024 -> 512, wo K 512),
     phi3.5's attention (4096 -> 2048 / 512, wo K 2048), paged_attn at
     Jamba's 4 KV heads of G 8 (hd 128) and flash_attn at 32 / 4 and 16 /
     4 heads (hd 128) —, each in f32 and bf16 with its route asserted.  Every
     nm_spmm, nm_spmm_decode and hessian_accum row asserts its route
     (``last_kernel``: tensor cores for bf16, f32 FMA for f32 and for
     rows off 16 bytes) and the same bits from a second call; hessian_accum
     rows also exact symmetry.  Errors are taken on f32 and bf16 inputs;
     times are device times in the main path's bf16 (CUDA events around
     back-to-back calls while a spin kernel holds the card), weights
     rotated through more than the 50 MB L2 so that every launch streams
     them from device memory as a decode step does;
  2. end to end in f32 at reduced depth (Qwen width, 2 layers): the same
     requests served with the kernels and with the plain override; the
     per-step logits must agree within LOGIT_TOL and the greedy streams
     must be equal, except at a step whose plain top-two logit gap is
     below LOGIT_TOL (a near tie, printed);
  3. the serving main path: Qwen1.5-0.5B at full width, QWEN_SERVE_LAYERS
     of its 24 layers (cut to keep the run inside its time limit), bf16,
     random init
     from a seeded torch.Generator, magnitude 2:4 on the seven linears of
     every layer, packed by the engine — 8 greedy requests (64-token
     prompts, 32 new tokens), one 512-token prompt at prefill_chunk 256
     (the tiled nm_spmm), and the 8 requests again with int8 KV pages,
     each engine with the prefix cache and a pool-sized pinned swap arena
     (its bytes and allocation time printed).  Every launch counter is
     zeroed just before and read just after; each serving kernel's must
     be > 0;
  3b. the reference's default serve features on phase 3's model: the 8
     requests with the defaults and with both features off, in turns
     (tok/s); a staged shared-prefix schedule (12 requests: 48-token stem,
     whole-prompt repeats, prompts extended by generated tokens) and two
     long prompts at chunk 256 after an attach, each with the cache on
     and off — equal streams, prefix hits and copy-on-write copies, fewer
     prefill tokens and chunks, the device busy time of one profiled run
     each; swap against recompute preemption on a 33-page pool in bf16
     and int8 pages, in turns — equal streams, swap only in the swap run
     (pages out == in > 0), more prefill tokens in the recompute run, the
     bytes moved and the host<->device rate; cancel of a swapped-out and
     of a decoding request — the pool's invariants and the arena's free
     slots after each, the other streams unchanged.  The serving kernels'
     launches over the phase must each be > 0;
  3c. sampled decoding on phase 3's model and requests — temperature 0.8
     with top-k 40, with top-p 0.9, and plain temperature 1.0: streams
     equal at steps_per_sync 8 and 1, and (top-k) on a 33-page pool with
     swap and with recompute preemption equal to the unpreempted run's;
     the card's threefry bits for the (8, 151936) draw equal to the CPU's;
     categorical flips between the card and the CPU on the same logits
     and keys (printed); sampled against greedy tok/s in turns; the
     kernels and device time one sampled draw adds, and a profiled run
     of each;
  3d. static mode on the same model: one dense-cache bucket of the 8
     requests — greedy streams equal to phase 3's continuous run except
     where they part at a near tie (the two tokens' logit gap from a
     full forward below STATIC_TIE), one host sync, the tiled nm_spmm in
     the 512-row prefill; sampled in the fori variant and the while
     variant (mixed max_new), each while stream a prefix of the fori
     one; static against continuous greedy in f32 at 2 layers, near ties
     at LOGIT_TOL;
  4. profiler traces of two serving runs (the 8 requests; the 512-token
     prompt, whose chunks take the tiled nm_spmm): device busy and idle
     share, device time by kernel, paged_attn's device time and launches;
  5. the prune main path: the launcher's default engine (pipelined:
     the 16 calibration batches stacked, one capture and one propagate
     per layer) on Qwen1.5-0.5B at full width and depth (PRUNE_LAYERS),
     bf16, random init; the paper's calibration protocol (128 random
     sequences x 2048 tokens); MM 2:4 at blocksize 128 — the counters
     are zeroed just before and read just after (PRUNE_LAYERS of the 24
     layers since phase 12 came), and flash_attn,
     hessian_accum and nm_select must each be > 0, hessian_accum 7 a
     layer and nm_select 70; wall, seconds per layer, HBM held and the
     host syncs PyTorch reports
     (``torch.cuda.set_sync_debug_mode``); every pruned linear must
     hold at most 2 nonzeros in every group of 4 (what packing needs)
     with the engine's reported sparsity 0.5, and the pruned model,
     packed, serves 8 greedy requests;
  5b. the serial and the pipelined engine on the same calibration, held
     against each other in f32 at 2 layers — layer 0 (identical inputs):
     masks equal except in rows whose first difference is a near tie of
     the serial run (loss gap below LAYER_TIE_REL), every linear's
     reconstruction error within LAYER_ERR_REL; layer 1: MASK_AGREE_MIN
     of mask entries equal, errors within LAYER_ERR_REL — and in bf16 on
     PRUNE_CMP_LAYERS layers, the serial one with its StageClock
     breakdown (hessian_accum 112 launches a layer) and the pipelined one
     instrumented (each stage synchronised; the capture stage beside the
     device time of its 7 hessian_accum launches): layer 0
     MASK_AGREE_MIN equal and within
     LAYER_ERR_REL, all layers' total reconstruction error within
     PIPE_TOTAL_ERR_REL and equal sparsity (layer 0's captures and
     Hessians compared first: where the engines part); then a bf16
     pipelined run whose progress store raises after segment 2, rerun
     from the store, must end bit-identical to the uninterrupted run;
  6. one f32 layer at Qwen width pruned by the launcher's default engine
     with the kernels and with the plain override (which must launch no
     kernel): the tie rule and error bound of 5b, and the weights of
     rows whose masks agree within LAYER_W_TOL;
  8. train → prune → serve: every param leaf of paper_tiny_lm gets a
     gradient through the differentiable route on the card;
     ``repro_torch.launch.train`` with the reference's defaults (300
     steps, batch 16 x 64), and the same run stopped at step 150 and
     resumed — its step-300 checkpoint bit-identical (deterministic
     algorithms), no kernel launched by training, the loss falling; the
     two runs, and phase 10's two, at once beside phase 0's kernel build
     (``start_trainers``: the host-bound trainers launch no kernel, and
     phase 1 waits for them);
     ``repro_torch.launch.prune --ckpt`` for MM 2:4 and SM 0.5 on the
     synthetic corpus (dense and pruned perplexity printed, flash_attn,
     hessian_accum and nm_select counted); the MM 2:4 model packed and
     served sampled (top-p 0.9);
  9. Jamba-1.5-Large's blocks without the experts at full width: one
     period (7 Mamba + 1 attention layers), d_model 8192, d_ff 24576,
     bf16, random weights from a seeded torch.Generator, magnitude 2:4 on
     the mlp and attn linears, packed (the Mamba linears stay dense, as
     the reference's patterns leave them).  Greedy: 8 requests (64-token
     prompts, 32 new) continuous at page 16 and chunk 32, one 512-token
     prompt at chunk 256, the 8 as one static bucket, the 8 on a
     STARVED_PAGES pool, and two requests on one 48-token stem one after
     the other.  Gates: continuous equals static except at near ties
     (STATIC_TIE_ULPS bf16 ulps at the logits' magnitude, phase 3d's
     policy), the starved run preempts by recompute at least twice and
     its streams equal the unstarved run's, the stem pair gets 0 prefix
     hits (no index over recurrent state) and equals static up to near
     ties, no swap anywhere, nm_spmm, nm_spmm_decode, paged_attn and
     flash_attn each launched; tok/s, host syncs a token and HBM held
     printed; a profiled generate (device idle share); then the kernels
     against their plain versions at Jamba's shapes (nm_spmm_decode at
     M = 8 and nm_spmm at M = 256 on the seven packed linears, paged_attn
     at KV 8, G 8, hd 128) beside torch.matmul / SDPA, and the selective
     scan's device time;
  10. the paper's Table 3: paper-tiny-mamba trained on the card with the
     reference's benchmark defaults (300 steps, batch 16 x 64, lr 1e-3
     warmup-cosine) in a process of its own (``--train-mamba``), and the
     same run stopped at 150 and resumed — bit-identical checkpoints;
     both beside phase 0's build, as phase 8's;
     magnitude, wanda, SS and SM at 0.5 (blocksize 64, 32 x 64 corpus
     calibration tokens) and MM 2:4 through the default pipelined engine;
     dense and pruned perplexity and last-token accuracy on the 8 eval
     batches of ``benchmarks/common.py`` (finite, 2:4 where asked; SM < SS
     reported, not gated); the MM model served greedily, continuous
     against static (equal except at near ties, LOGIT_TOL);
  11. the serving front end: phase 3's model and engine settings behind
     ``launch.serve.make_router`` — two replicas on one registry, the
     HTTP/SSE Server on 127.0.0.1 (port 0) and the Supervisor.  11a: 16
     SSE clients (64-token prompts, 32 new, greedy), every stream in more
     than one frame and equal to its JSON response and to one engine's
     ``generate``; 4 prompts repeated one after another reuse prefix
     pages; /healthz, 404, /metrics (both replicas' TTFT counts, host
     syncs and tokens > 0, the preemption series), /stats ``_summary``;
     aggregate tok/s and idle share of one replica, then two, profiled,
     on 16 fresh requests; TTFT / TPOT from the histograms; the trace's
     request spans equal to the requests.  11b: engine_step on r0's third
     burst and a client that hangs up mid-stream — the other streams
     equal 11a's, the restart, failover, cancel and recovery series
     tick, the pools' invariants hold and no arena slot leaks.  11c: the
     16 sampled (temperature 0.8, top-p 0.9) through two replicas equal
     one engine's ``generate``.  11d: ``python -m
     repro_torch.launch.serve --server --port 0 --replicas 2`` answers a
     streamed completion and exits 0 on SIGTERM after "draining...".
  12. the dense decoders' attention variants at full width, bf16 unless
     named: 12a each model's kernels against the plain override end to
     end in f32 (2 layers; Gemma3-12B one period of 6 with a 1100-token
     prompt past its window), phase 2's LOGIT_TOL and tie rule; 12b
     gemma-2b at full depth, Qwen3-14B and Gemma3-12B at
     DENSE_SERVE_LAYERS (10 of 40, 12 of 48), magnitude 2:4
     packed by the engine — the 8 requests continuous (the reference's
     serve defaults), with int8 pages and as one static bucket (static
     equal to continuous up to near ties), Gemma3-12B also one 2048-token
     prompt at chunk 256 whose stream must part from a window=None copy's;
     every serving kernel launched, the pools' invariants, tok/s, HBM and
     a profiled run's idle share; 12c each pruned MS 2:4 through the
     launcher's default (pipelined) engine on 128 x 2048 random tokens at
     DENSE_PRUNE_LAYERS (gemma-2b 2 layers, Qwen3-14B 2, Gemma3-12B one
     period, its calibration in DENSE_CALIB_SHARDS = 4 shards, which HBM
     forces): hessian_accum 7 and flash_attn 2 launches a layer and
     shard, nm_select 7 a layer, at most 1 host sync, finite perplexity,
     every linear 2:4, the result served packed; 12d MM 2:4 on gemma-2b's
     layer 0 (mlp.wo skipped, and mlp.wg: mlp.wi's shape) through the
     serial engine, seconds by stage and linear;
 13. Mixture-of-Experts: 13a phi3.5-moe at full width in f32, one layer,
     4 x 512 tokens — every linear's Hessian (the 48 experts' weighted)
     accumulated by the kernels and by the plain override from the same
     captures, within KERNEL_TOL_REL, and the experts' 𝔐 2:4 masks
     bit-equal; its SMOKE pruned MM 2:4 and served static (continuous
     asked) with the kernels and under the plain override (which launches
     nothing): masks as phase 5b's, streams equal; 13b phi3.5-moe (8
     layers), kimi-k2 (1 layer: 384 experts, top-8, the shared expert)
     and Jamba's first 4 layers with their experts at full width, bf16,
     attention and dense / shared MLPs 2:4-packed, the routed experts
     dense: phase 3's 8 requests asked continuous, served static
     (``mode``), tok/s, HBM held, idle share, nm_spmm_decode's device ms;
     13c phi3.5-moe pruned MS 2:4 through the launcher's default
     (pipelined) engine, 1 layer, 128 x 2048 random tokens: seconds a
     layer, HBM held, host syncs (≤ 1), launches a layer (hessian_accum
     53, flash_attn 2, nm_select 52), every linear 2:4.
 14. the xLSTM (xlstm-350m: 24 layers, 21 mLSTM and 3 sLSTM, d_model
     1024, 4 heads, mLSTM head dim 512): 14a one f32 period at full width
     (3 mLSTM + the sLSTM) 2:4-packed, phase 3's 8 requests continuous and
     static with the kernels and under the plain override — streams
     equal; its SMOKE pruned MS 2:4, kernels against plain (masks as
     13a's rule, bit-equality printed); 14b the whole model, bf16,
     magnitude 2:4 on the 99 block linears packed with their patterns
     (the defaults pack none): the 8 requests continuous (page 16, chunk
     32), as one static bucket (the f32 twin's streams equal up to near
     ties at LOGIT_TOL; bf16's partings printed beside the bf16 forward's
     error) and continuous with forced recompute preemptions (a pure recurrent
     pool has no pages to starve; streams equal the continuous run's);
     tok/s, host syncs a token, HBM, idle share, nm_spmm_decode and
     nm_spmm launched, the cells' device time alone; 14c one mLSTM layer
     at T 16384, chunkwise against quadratic (each against the quadratic
     form in f64: the chunkwise error within XLSTM_F64_RATIO times the
     quadratic's), and
     the static prefill of one 9216-token prompt (the chunkwise path) + 32
     tokens, with one sLSTM layer's loop timed alone over
     XLSTM_LOOP_STEPS steps; 14d MS 2:4
     through the launcher's default (pipelined) engine at
     XLSTM_PRUNE_LAYERS (one period) on 128 x 2048 random ids in
     XLSTM_CALIB_SHARDS shards (hessian_accum 33 a shard, nm_select 33,
     ≤ 1 host sync, every linear 2:4), then three
     trainer steps at 4 x 256 through ``repro_torch.launch.train``.
 15. the prefix-LM and the encoder-decoder at full width, bf16, random
     init, magnitude 2:4 on every attention (self and cross, the
     encoder's) and MLP linear, packed by the engine, served static
     (continuous asked: ``effective_mode``) with (8, F, fd) stub features
     from a seeded torch.Generator through ``extra_batch``: 15a
     paligemma-3b (18 layers; 256 image positions in front of 64-id
     prompts), 15b seamless-m4t-large-v2 (24 + 24 layers over 1024
     frames) — phase 3's 8 greedy requests with the kernels and under the
     plain override, and with other features: the f32 twin's first-step
     logits within LOGIT_TOL and its streams equal up to near ties (the
     bf16 partings reported beside it), other features move the logits,
     the cross K / V written at the prefill alone; tok/s, HBM held, the
     idle share and kernels a step of a profiled run, flash_attn's
     launches.  15c PaliGemma (2 of 18 layers) and 15d seamless (2 + 2 of
     24 + 24: the enc → enc/ln → dec calibration flow, the xattn.wk / wv
     Hessians over the encoder's output) pruned MS 2:4 through the
     launcher's default (pipelined) engine on 128 x 2048 random ids and
     their features, then the serial engine on the same: launches a
     segment, ≤ 1 host sync, every linear 2:4, the first segment's masks
     and errors as phase 5b's rule, seconds a layer, perplexity before
     and after.  15e trains each 3 steps (the Trainer: autograd on the
     differentiable route, AdamW with f32 moments) at full width, 4 x 256
     text tokens with their features, at FRONTEND_TRAIN's depth: each
     loss finite, seconds a step, HBM held;
 16. distribution.  16a, a 1-rank NCCL group (``--mesh host``): the
     prune launcher's engine on Qwen1.5-0.5B at full width, DIST_LAYERS
     layers, MM 2:4 pipelined, with and without the mesh — masks equal,
     weights within DIST_W_TOL, every prune kernel launched on the mesh
     run; hessian_allreduce (timed), prune_matrix_sharded and
     compressed_psum over the group at mlp.wo's shape; three
     paper_tiny_lm trainer steps with grad_compression, on the mesh and
     without (losses within DIST_LOSS_ABS).  16b, two ranks sharing the
     card (``--dist-rank`` processes, RANK / WORLD_SIZE / MASTER_PORT as
     torchrun sets them; gloo on CUDA tensors, since NCCL refuses two
     ranks on one device): the same prune on 1x2 (row-parallel solves)
     and 2x1 (calibration sharded over data), masks equal to 16a's (1x2:
     its one-device run; 2x1: its run in two calibration shards, whose
     GEMMs have the ranks' shapes) and weights within DIST_W_TOL, each
     rank's hessian_accum and nm_select launches printed and > 0; three
     data-parallel trainer steps equal to 16a's one-rank steps (losses
     within DIST_LOSS_ABS, params within DIST_TRAIN_REL by norm), and
     phi3.5-moe SMOKE's three (the global batch routed across the ranks:
     loss and aux within DIST_LOSS_ABS of one rank's).  16c, in the same
     two processes on a 1x2 mesh: tensor-parallel serving (TP_CASES) —
     Qwen1.5-0.5B at full width and DIST_LAYERS layers, magnitude 2:4,
     phase 3's 8 requests continuous and static in bf16 and in an f32
     twin, and Qwen3-14B (TP_QWEN3_LAYERS of 40 layers) bf16 continuous —
     against the same runs on one device: the f32 twin's streams equal,
     8 of 8 in each mode, both ranks' streams bit-equal, each rank's
     nm_spmm_decode and paged_attn (static: flash_attn and nm_spmm)
     launched, the rank-local packed shapes printed with their route;
     bf16 agreement, tok/s and the HBM a rank holds against one device.
     16d, in the same two processes on 1x2: the recurrent and expert
     families (TP_FAMILY_CASES), each built, served and freed in turn at
     full width with every prunable linear magnitude-2:4 packed, phase
     3's 8 requests, bf16 and an f32 twin — Jamba-1.5-Large's first
     TP_JAMBA_SLOTS slots without the experts (3 Mamba and the attention;
     continuous: the paged pool and the StatePool), xlstm-350m's first
     TP_XLSTM_LAYERS layers (one period; continuous) and phi3.5-moe's
     first
     TP_PHI_LAYERS (static, 8 experts a rank) — against the same runs on
     one device: each f32 twin's streams equal, 8 of 8, both ranks'
     streams bit-equal, each rank's TP_FAMILY_NEED launched, a rank's
     census and memory_allocated under TP_BYTES_RATIO of one device's;
     bf16 agreement and tok/s printed.  16e, in the same two processes
     on 1x2: the prefix-LM and the encoder-decoder (TP_FRONTEND_CASES) —
     paligemma-3b at full width, 2 of 18 layers, and
     seamless-m4t-large-v2, 2 + 2 of 24 + 24, every linear of decoder
     and encoder magnitude-2:4 packed, bf16 and an f32 twin, phase 3's 8
     requests static with 15a-b's seeded stub features — against the same
     runs on one device: each f32 twin's streams equal, 8 of 8, the
     ranks' bit-equal, each rank's TP_FRONTEND_NEED launched, a rank's
     census and memory_allocated under TP_BYTES_RATIO, every rank-local
     packed shape one of phase 1t's rows.  16f, last in the same two
     processes: ``launch.serve.run_frontend`` under 1x2 — Qwen1.5-0.5B at
     full width, DIST_LAYERS layers, f32, 2:4-packed, two replicas; rank
     0 serves HTTP on port 0 (the router, the supervisor), rank 1
     mirrors both replicas — while this process streams phase 3's 8 greedy
     requests to it; a replica_worker death is armed on r0 once it has
     streamed a token; then SIGTERM to both ranks: the streams equal
     16c's one-device f32 streams, the death fired once and failed
     requests over, each rank launched paged_attn, printed "draining..."
     and exited 0.  16g, in the same two processes before 16f: the
     Trainer on Qwen1.5-0.5B at full width, DIST_LAYERS layers, the
     reference's keyed init, TRAIN_16G's 3 steps of 8 x 128 random ids
     (AdamW, f32 moments) — (a) on 2x1 with FSDP (the default), (b) on
     1x2 tensor-parallel, each in f32 and in bf16 — against the same runs
     on one device (in this process, before the ranks start): the f32
     runs' losses within DIST_LOSS_ABS, the ranks' bit-equal, every leaf
     within DIST_TRAIN_REL by norm with at most DIST_TRAIN_OUTLIERS of
     its entries past DIST_TRAIN_ENTRY_ABS; bf16 printed; each rank's
     bytes of params and moments against one device's and the seconds a
     step; (c) the 2x1 f32 run's step-2 checkpoint resumed for step 3 on
     1x2, its loss within DIST_LOSS_ABS of the uninterrupted run's.  16b
     also trains the tiny LM once replicated (``fsdp_axes=()``), at the
     same gates as its FSDP run.

Then a ``{"kernels": [...]}`` line (every ported kernel, its check — a
failed check has ended the run before — its numbers at the phase 1
shapes — hessian_accum's weighted rows under ``weighted`` — and its
launches over phases 3-16, 16b-f's two ranks' included; flash_attn's
rows at phase 1e's shapes under ``frontend``), the nvidia-smi
line, and last the ``{"ok": true, "device": {...}}`` line.  Longer tables go to
``chiprun_out/chip_smoke.txt``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12,      # f32 outside the tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor cores
KERNEL_TOL_REL = 2e-5                # |kernel - plain| / max(1, |plain|) in f32
BF16_KERNEL_TOL_REL = 1e-4           # flash_attn on bf16 inputs, relative as above:
                                     # both sides compute in f32 and the kernel
                                     # keeps ~16 bits of P (8e-6 on an H100); P
                                     # rounded once to bf16 is ~1e-3 off
MASK_AGREE_MIN = 0.999               # phase 5b: mask entries that agree, and the
PIPE_TOTAL_ERR_REL = 0.05            # total reconstruction error: the reference's
                                     # pipelined-vs-serial contract
TIE_REL = 1e-6                       # nm_select: a loss gap below this is a tie
LAYER_TIE_REL = 1e-4                 # phases 5b, 6: the two runs' Hessians differ
                                     # by ~1e-6, amplified by Hinv's condition
LAYER_W_TOL = 1e-3                   # phase 6: |Δw| / max|w0| on agreeing rows
LAYER_ERR_REL = 1e-3                 # phases 5b, 6: reconstruction error, relative
PRUNE_LAYERS = 8                     # phase 5 depth: 8 of the 24 (≈ 2.7 s a layer;
                                     # cut with phase 12's arrival, as
QWEN_SERVE_LAYERS = 4                # phases 3-4 and 11a-c: 4 of the 24 layers
                                     # (8 until phases 15e and 16 came),
                                     # to keep chip_smoke inside its time limit)
PRUNE_CMP_LAYERS = 3                 # serial vs pipelined, and resume (4
                                     # until phases 15e and 16 came)
PRUNE_ROW_CHUNK = 128                # rows per MRP solve: ≤ 1 GB (rows, k, k)
SERVE_KERNELS = ("nm_spmm", "nm_spmm_decode", "paged_attn")
PRUNE_KERNELS = ("hessian_accum", "nm_select", "flash_attn")
LOGIT_TOL = 1e-3                     # phase 2, f32 logits (and near-tie gap)
L2_BYTES = 50 * 2**20
SPIN_HZ = 2.0e9                      # spin-kernel cycles per second (≥ SM clock)
QWEN_LINEARS = (                     # (name, K, N, bias, activation)
    ("attn.wq", 1024, 1024, True, None),
    ("attn.wk", 1024, 1024, True, None),
    ("attn.wv", 1024, 1024, True, None),
    ("attn.wo", 1024, 1024, False, None),
    ("mlp.wi", 1024, 2816, False, None),
    ("mlp.wg", 1024, 2816, False, "silu"),
    ("mlp.wo", 2816, 1024, False, None),
)
QWEN3_LINEARS = (                    # Qwen3-14B: d_model 5120, 40 heads,
    ("qwen3 attn.wq", 5120, 5120, False, None),      # 8 kv heads, hd 128
    ("qwen3 attn.wk", 5120, 1024, False, None),
    ("qwen3 attn.wv", 5120, 1024, False, None),
    ("qwen3 attn.wo", 5120, 5120, False, None),
    ("qwen3 mlp.wi", 5120, 17408, False, None),
    ("qwen3 mlp.wg", 5120, 17408, False, "silu"),
    ("qwen3 mlp.wo", 17408, 5120, False, None),
)
GEMMA_LINEARS = (                    # gemma-2b: the widest K, the narrowest N
    ("gemma-2b mlp.wo", 16384, 2048, False, None),
    ("gemma-2b attn.wk", 2048, 256, False, None),
)
DENSE_ARCHS = ("gemma_2b", "qwen3_14b", "gemma3_12b")
DENSE_SERVE_LAYERS = {"qwen3_14b": 10,  # phase 12b: Qwen3-14B cut from 40
                      "gemma3_12b": 12}  # layers to 20 to make room for
                                     # phase 13 inside the time limit, and
                                     # to 10 for phase 14; Gemma3-12B from
                                     # 48 to 12 (two 5 local : 1 global
                                     # periods) for phases 15e and 16
DENSE_PRUNE_LAYERS = {"gemma_2b": 2,   # phase 12c: gemma-2b 2 of 18 (18
                      "qwen3_14b": 2,  # until phase 14 came, 6 until phase
                                     # 15's PaliGemma pruned 2 layers of its
                                     # backbone's widths), Qwen3-14B 2
                      "gemma3_12b": 6}  # of 40 (4 before), Gemma3-12B one
                                     # period (5 local + 1 global)
DENSE_CALIB_SHARDS = {"gemma3_12b": 4}  # phase 12c: Gemma3-12B's segment is
                                     # its 6-layer period, whose stacked
                                     # capture of all 128 x 2048 tokens would
                                     # hold ≈ 84 GB of linear inputs: the same
                                     # tokens in 4 shards (calib_shard)
LOG = []
# wall seconds spent in timing only — device_ms's loops (the calls past a
# row's first, checked one) and profiler runs — and the calls, so far
TIMING = {"device_ms_s": 0.0, "device_ms_calls": 0, "profiled_s": 0.0}


def say(*parts) -> None:
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    LOG.append(line)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def _device_us(prof) -> list:
    """Per-kernel device durations (µs, name) from a profiler run, read
    off the raw Kineto events: ``prof.events()`` builds a Python event
    tree first, tens of µs of host time an event — most of a phase's
    wall once a run launches 10⁵ kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.duration_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def device_ms(fn, arg_sets, n: int = 10, reps: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    of the mean of ``n`` back-to-back calls, cycling through
    ``arg_sets`` (rotated so that the weights stream from device memory).
    A spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues the n calls, so that the CUDA events around them time the
    device alone, not the host's launch gaps."""
    import torch

    t_start = time.monotonic()
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    spin_s = 2 * host_s + 1e-3
    while len(times) < reps:
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        e0.record()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*arg_sets[(len(times) * n + i) % len(arg_sets)])
        e1.record()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enq < spin_s:
            times.append(e0.elapsed_time(e1) / n)
        elif spin_s > 1.0:
            fail("device_ms: the host cannot enqueue the calls ahead of "
                 "the card")
        else:                    # the host fell behind: spin longer, redo
            spin_s *= 2
    TIMING["device_ms_s"] += time.monotonic() - t_start
    TIMING["device_ms_calls"] += 2 + n * (1 + reps)
    return statistics.median(times)


def bound(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ----------------------------------------------------------------------
def _sparse_weight(gen, k, n, dtype, padding=False):
    """A magnitude-2:4 (K, N) weight, dense and packed.  ``padding``:
    columns 0-2 of every group hold a kept value at position 0 beside a
    padding slot, two padding slots, and a kept value at position 3
    (idx (0, 0) and (3, 0), as compress_24 packs short groups)."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops

    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    w = prune_linears({"layers": [{"mlp": {"wo": w}}]},
                      "2:4")["layers"][0]["mlp"]["wo"]
    if padding:
        grp = w.view(k // 4, 4, n)
        grp[:, :, 0] = torch.tensor([1.5, 0.0, 0.0, 0.0], device="cuda")
        grp[:, :, 1] = 0.0
        grp[:, :, 2] = torch.tensor([0.0, 0.0, 0.0, -2.0], device="cuda")
    w = w.to(dtype)
    vals, idx = ops.compress_24(w)
    return w, vals, idx


def _route_of(dtype):
    """The route nm_spmm, nm_spmm_decode and hessian_accum must take on
    rows aligned to 16 bytes: the tensor cores for bf16, the f32-FMA kernel
    for f32."""
    import torch

    return "tensor cores" if dtype == torch.bfloat16 else "f32 FMA"


def nm_row(gen, m, name, k, n, has_bias, act, timed=True):
    """One nm_spmm (M > 128) or nm_spmm_decode (M <= 128) row: the kernel
    against its plain version in f32 and in bf16 (route, same bits),
    then (``timed``) timed in bf16 beside torch.matmul on the dense
    weight, weights rotated past L2; its bound from this call's bytes and
    products."""
    import torch

    from repro_torch.kernels import nm_spmm as K

    kname = "nm_spmm_decode" if m <= K.DECODE_MAX_M else "nm_spmm"
    kern = getattr(K, kname)
    plain = getattr(K, kname + "_plain")
    act = act if m <= K.DECODE_MAX_M else None
    has_bias = has_bias and m <= K.DECODE_MAX_M
    # correctness, f32
    _, vals, idx = _sparse_weight(gen, k, n, torch.float32)
    x = torch.randn(m, k, generator=gen, device="cuda")
    bias = (0.1 * torch.randn(n, generator=gen, device="cuda")
            if has_bias else None)
    extra = (bias, act) if kname == "nm_spmm_decode" else ()
    got = kern(x, vals, idx, *extra)
    route_ok = kern.last_kernel == _route_of(torch.float32)
    want = plain(x, vals, idx, *extra)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
    del got, want, vals, idx, x
    # bf16, the path's dtype: checked (both sides sum exact bf16 products
    # in f32) and timed, weights rotated past L2
    w, vals, idx = _sparse_weight(gen, k, n, torch.bfloat16)
    wbytes = vals.numel() * 3
    reps = max(2, -(-2 * L2_BYTES // wbytes))
    xb = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    bb = bias.to(torch.bfloat16) if bias is not None else None
    bextra = (bb, act) if extra else ()
    got = kern(xb, vals, idx, *bextra)
    route_ok &= kern.last_kernel == _route_of(torch.bfloat16)
    same = bool(torch.equal(got, kern(xb, vals, idx, *bextra)))
    want = plain(xb, vals, idx, *bextra)
    torch.cuda.synchronize()
    err_b = (got - want).abs().max().item()
    tol_b = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
    del got, want
    ms = plain_ms = lib_ms = None
    if timed:
        sets, lib_sets = [], []
        for _ in range(reps):
            v2, i2 = vals.clone(), idx.clone()
            sets.append((xb, v2, i2, *((bb, act) if extra else ())))
            lib_sets.append((xb, w.clone()))
        ms = device_ms(kern, sets)
        plain_ms = device_ms(plain, sets)
        lib_ms = device_ms(torch.matmul, lib_sets)
    n_bytes = (m * k * 2 + vals.numel() * 2 + idx.numel()
               + (n * 2 if bb is not None else 0) + m * n * 4)
    b_ms, b_by = bound(n_bytes, 2.0 * m * n * (k // 2), "bfloat16")
    ok = err <= tol and err_b <= tol_b and route_ok and same
    row = dict(kernel=kname, shape=f"{name} M={m} K={k} N={n}",
               max_abs_err=max(err, err_b), tol=tol, ok=ok, err_f32=err,
               err_bf16=err_b, tol_bf16=tol_b, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               route=kern.last_kernel, deterministic=same)
    say(f"  {kname:15s} {row['shape']:30s} err f32 {err:.3e} tol "
        f"{tol:.3e}, bf16 {err_b:.3e} tol {tol_b:.3e} ({row['route']}) "
        f"same bits {same} {'ok' if ok else 'FAIL'}"
        + (f"  ms {ms:.5f} plain {plain_ms:.5f} lib {lib_ms:.5f} bound "
           f"{b_ms:.5f}" if timed else f"  bound {b_ms:.5f} (not timed)"))
    return row


def check_nm_spmm(gen, rows):
    per_kernel = {"nm_spmm_decode": [], "nm_spmm": []}
    for m in (8, 32, 256):
        for lin in QWEN_LINEARS:
            row = nm_row(gen, m, *lin)
            rows.append(row)
            if m in (8, 256):
                per_kernel[row["kernel"]].append(row)
    check_nm_spmm_edges(gen, rows)
    check_decode_edges(gen, rows)
    return per_kernel


def check_decode_edges(gen, rows):
    """nm_spmm_decode at the batch sizes the timed rows skip — M = 1, 16
    (two 8-row fragments), 64 and 128 (row blocks of 32) — on attn.wq with
    its bias and mlp.wg with its silu, f32 and bf16: each on its dtype's
    route, within tolerance, the same bits twice."""
    import torch

    from repro_torch.kernels.nm_spmm import (nm_spmm_decode,
                                             nm_spmm_decode_plain)

    cases = [(name, k, n, has_bias, act)
             for name, k, n, has_bias, act in QWEN_LINEARS
             if name in ("attn.wq", "mlp.wg")]
    worst, n_rows = 0.0, 0
    for m in (1, 16, 64, 128):
        for name, k, n, has_bias, act in cases:
            for dtype in (torch.float32, torch.bfloat16):
                _, vals, idx = _sparse_weight(gen, k, n, dtype)
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                bias = (0.1 * torch.randn(n, generator=gen, device="cuda")
                        ).to(dtype) if has_bias else None
                got = nm_spmm_decode(x, vals, idx, bias, act)
                route = nm_spmm_decode.last_kernel
                same = bool(torch.equal(
                    got, nm_spmm_decode(x, vals, idx, bias, act)))
                want = nm_spmm_decode_plain(x, vals, idx, bias, act)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
                ok = err <= tol and same and route == _route_of(dtype)
                dname = "f32" if dtype == torch.float32 else "bf16"
                row = dict(kernel="nm_spmm_decode",
                           shape=f"{name} M={m} K={k} N={n} {dname}",
                           max_abs_err=err, tol=tol, ok=ok, route=route,
                           deterministic=same)
                rows.append(row)
                worst, n_rows = max(worst, err / tol), n_rows + 1
                LOG.append(f"  nm_spmm_decode  {row['shape']:42s} err "
                           f"{err:.3e} tol {tol:.3e} ({route}) same bits "
                           f"{same} {'ok' if ok else 'FAIL'}")
    say(f"  nm_spmm_decode  {n_rows} cases (M=1/16/64/128 x attn.wq with "
        f"bias, mlp.wg with silu; bf16 and f32): worst err/tol "
        f"{worst:.3e}, failed {sum(not r['ok'] for r in rows[-n_rows:])}")


def check_nm_spmm_edges(gen, rows):
    """nm_spmm (the tiled kernel) off the path's round shapes, in both
    routes: ragged M = 257 at the seven Qwen linears, (M, K, N) = (200,
    132, 200) — rows not on 16 bytes, a K tile and an N tile cut short —
    and a weight with padding-slot groups at mlp.wo's shape.  Each must
    take its dtype's route and give the same bits twice."""
    import torch

    from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_plain

    cases = [(f"{name} M=257 K={k} N={n}", 257, k, n, False)
             for name, k, n, _, _ in QWEN_LINEARS]
    cases += [("ragged M=200 K=132 N=200", 200, 132, 200, False),
              ("padding slots M=256 K=2816 N=1024", 256, 2816, 1024, True)]
    worst = 0.0
    for label, m, k, n, padding in cases:
        for dtype in (torch.bfloat16, torch.float32):
            _, vals, idx = _sparse_weight(gen, k, n, dtype, padding)
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            got = nm_spmm(x, vals, idx)
            route = nm_spmm.last_kernel
            again = nm_spmm(x, vals, idx)
            want = nm_spmm_plain(x, vals, idx)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
            same = bool(torch.equal(got, again))
            ok = err <= tol and same and route == _route_of(dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            row = dict(kernel="nm_spmm", shape=f"{label} {dname}",
                       max_abs_err=err, tol=tol, ok=ok, route=route,
                       deterministic=same)
            rows.append(row)
            worst = max(worst, err / tol)
            LOG.append(f"  nm_spmm         {row['shape']:42s} err {err:.3e} "
                       f"tol {tol:.3e} ({route}) same bits {same} "
                       f"{'ok' if ok else 'FAIL'}")
    say(f"  nm_spmm         {2 * len(cases)} edge cases (M=257 x 7 linears, "
        f"200x132x200, padding slots; bf16 and f32): worst err/tol "
        f"{worst:.3e}, failed "
        f"{sum(not r['ok'] for r in rows[-2 * len(cases):])}")


def _paged_case(gen, b, kvh, g, hd, ps, p_max, lengths, dtype, int8,
                shared=0):
    """``shared``: every live row maps the same first ``shared`` pages, as
    a prefix-cache attach leaves them, then pages of its own."""
    import torch

    n_pages = b * p_max + 1
    q = torch.randn(b, kvh, g, hd, generator=gen, device="cuda").to(dtype)
    if int8:
        kp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                           device="cuda").to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, ps, kvh, hd), generator=gen,
                           device="cuda").to(torch.int8)
        ks = torch.rand(n_pages, ps, kvh, generator=gen, device="cuda") / 64
        vs = torch.rand(n_pages, ps, kvh, generator=gen, device="cuda") / 64
    else:
        kp = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                         device="cuda").to(dtype)
        ks = vs = None
    bt = np.zeros((b, p_max), np.int32)
    pid = 1 + shared
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // ps)):
            if j < shared:
                bt[i, j] = 1 + j
            else:
                bt[i, j] = pid
                pid += 1
    bt = torch.from_numpy(bt).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens, ks, vs


def check_paged(gen, rows):
    """paged_attn at the serving shapes (:func:`paged_rows`).  Returns
    the rows of the serving runs' decode steps: the 8-request batch, the
    512-token prompt (one slot of the 36-page table live) and the 8 rows
    that share their first 3 pages (phase 3b's prefix-cache attach).  The
    B = 1 row is the long context without the idle slots."""
    lengths = [96, 70, 65, 0, 33, 128, 17, 81]       # slot 3 idle
    cases = [("B=8 KV=16 G=1 hd=64 ps=16", 8, 16, 1, 64, 16, 8, lengths,
              None, False),
             ("B=8 window=32", 8, 16, 1, 64, 16, 8, lengths, 32, False),
             ("B=8 int8 pages", 8, 16, 1, 64, 16, 8, lengths, None, True),
             ("B=4 KV=4 G=4 (GQA)", 4, 4, 4, 64, 16, 4, [50, 0, 64, 9],
              None, False),
             ("B=8 p_max=36 one slot 544 keys", 8, 16, 1, 64, 16, 36,
              [544] + [0] * 7, None, False),
             ("B=1 544 keys (off the path)", 1, 16, 1, 64, 16, 34, [544],
              None, False),
             ("B=2 KV=1 G=8 hd=256 (gemma-2b)", 2, 1, 8, 256, 16, 4,
              [50, 17], None, False)]
    shared_lengths = [96, 70, 65, 0, 49, 128, 50, 81]   # slot 3 idle
    cases = [(*c, 0) for c in cases] + [
        ("B=8 3 shared pages, then own", 8, 16, 1, 64, 16, 8,
         shared_lengths, None, False, 3),
        ("B=8 3 shared pages, int8", 8, 16, 1, 64, 16, 8, shared_lengths,
         None, True, 3)]
    main = paged_rows(gen, rows, cases)
    return main[cases[0][0]], main[cases[4][0]], main[cases[7][0]]


def paged_rows(gen, rows, cases):
    """paged_attn on each case (label, B, KV, G, hd, page size, p_max,
    lengths, window, int8 pages, shared first pages), each row on f32
    inputs and on the path's bf16 (or int8) pages — bf16 held against the
    plain version on the same values in f32, which keeps the
    probabilities unrounded as the kernel does — then timed in bf16
    beside SDPA on the gathered pages.  Idle slots must be exact zeros
    and a second call the same bits.  Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

    main = {}
    for label, b, kvh, g, hd, ps, p_max, lens, win, int8, shared in cases:
        errs, tols, oks = [], [], []
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, ln, ks, vs = _paged_case(
                gen, b, kvh, g, hd, ps, p_max, lens, dtype, int8, shared)
            got = paged_attn(q, kp, vp, bt, ln, win, ks, vs)
            f32 = (lambda t: t) if int8 else (lambda t: t.float())
            want = paged_attn_plain(q.float(), f32(kp), f32(vp), bt, ln, win,
                                    ks, vs)
            again = paged_attn(q, kp, vp, bt, ln, win, ks, vs)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
            errs.append(err)
            tols.append(tol)
            oks.append(err <= tol and bool((got[ln == 0] == 0).all())
                       and torch.equal(got, again))
        plan = paged_attn.last_plan
        # speed in the main path's dtype (bf16 q; bf16 or int8 pages)
        args = [(q, kp, vp, bt, ln, win, ks, vs)]
        ms = device_ms(paged_attn, args)
        plain_ms = device_ms(paged_attn_plain, args)
        # library yardstick: SDPA over the gathered (dequantized) pages
        s_len = p_max * ps
        kg = kp[bt.long()].reshape(b, s_len, kvh, hd)
        vg = vp[bt.long()].reshape(b, s_len, kvh, hd)
        if int8:
            kg = (kg.float() * ks[bt.long()].reshape(b, s_len, kvh, 1))
            vg = (vg.float() * vs[bt.long()].reshape(b, s_len, kvh, 1))
        kg = kg.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        vg = vg.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        kpos = torch.arange(s_len, device="cuda")
        mask = (kpos[None] < ln[:, None])
        if win is not None:
            mask &= kpos[None] >= ln[:, None] - win
        mask = mask[:, None, None, :]
        ql = q.reshape(b, kvh, g, hd)
        if g > 1:                   # SDPA's plain layout: repeat KV heads
            kg = kg.repeat_interleave(g, dim=1)
            vg = vg.repeat_interleave(g, dim=1)
            ql = ql.reshape(b, kvh * g, 1, hd)
        lib_ms = device_ms(F.scaled_dot_product_attention,
                           [(ql, kg, vg, mask)])
        live = sum(min(n_, win or n_) for n_ in lens)
        # key rows read once: a shared page's rows count once
        rows_read = live - shared * ps * max(0, sum(
            n_ > 0 for n_ in lens) - 1)
        row_b = 1 if int8 else 2
        n_bytes = (q.numel() * 2 + 2 * rows_read * kvh * hd * row_b
                   + (2 * rows_read * kvh * 4 if int8 else 0)
                   + sum(-(-n_ // ps) for n_ in lens) * 4 + b * 4
                   + b * kvh * g * hd * 4)
        b_ms, b_by = bound(n_bytes, 4.0 * live * kvh * g * hd, "bfloat16")
        ok = all(oks)
        row = dict(kernel="paged_attn", shape=label, max_abs_err=max(errs),
                   tol=min(tols), ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   split=plan.split, pages=plan.pages,
                   route=paged_attn.last_kernel)
        rows.append(row)
        say(f"  paged_attn      {label:30s} err f32 {errs[0]:.3e} bf16 "
            f"{errs[1]:.3e} idle-zero, same bits {'ok' if ok else 'FAIL'}  "
            f"plan S={plan.split} pages={plan.pages} heads={plan.heads}x"
            f"{plan.head_blocks}  ms {ms:.5f} plain {plain_ms:.5f} lib "
            f"{lib_ms:.5f} bound {b_ms:.5f}")
        main[label] = row
    return main


def check_hessian(gen, rows,
                  shapes=((16384, 1024), (16384, 2816), (4097, 130))):
    """hessian_accum at the prune path's shapes (T, m): by default T =
    16384 tokens (one calibration batch, 8 x 2048) of the m = 1024 and m =
    2816 captures, and a ragged bf16 m = 130 (rows off 16 bytes: the
    f32-FMA route) on T = 4097.  Each row asserts its route, exact
    symmetry and the same bits from a second call."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.hessian_accum import (hessian_accum,
                                                   hessian_accum_plain)

    per_m = []
    for t, m in shapes:
        # the streaming mean of the second batch: n_prev = t, n = 2t
        ab = [("α=1 β=0", 1.0, 0.0), ("α=1/n β=n'/n", 1.0 / (2 * t), 0.5)]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(t, m, generator=gen, device="cuda").to(dtype)
            h0 = torch.randn(m, m, generator=gen, device="cuda")
            h0 = h0 + h0.T
            route_want = "f32 FMA" if m % 8 else _route_of(dtype)
            for label, alpha, beta in ab:
                def fresh():                 # β = 0 must not read h
                    return (h0.clone() if beta else
                            torch.full_like(h0, float("nan")))
                got = hessian_accum(x, fresh(), alpha, beta)
                route = hessian_accum.last_kernel
                same = bool(torch.equal(
                    got, hessian_accum(x, fresh(), alpha, beta)))
                want = (ref.hessian_accum_ref(x.T) if beta == 0 else
                        hessian_accum_plain(x, h0.clone(), alpha, beta))
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = KERNEL_TOL_REL * max(1.0, want.abs().max().item())
                sym = bool(torch.equal(got, got.T))
                ok = err <= tol and sym and same and route == route_want
                dname = "f32" if dtype == torch.float32 else "bf16"
                row = dict(kernel="hessian_accum",
                           shape=f"T={t} m={m} {dname} {label}",
                           max_abs_err=err, tol=tol, ok=ok, route=route,
                           deterministic=same)
                if dtype == torch.bfloat16 and beta and m % 8 == 0:
                    # speed on the path's call: bf16 captures, streaming α/β
                    h = h0.clone()
                    x32 = x.float()
                    args = [(x, h, alpha, beta)]
                    row["ms"] = device_ms(hessian_accum, args)
                    row["plain_ms"] = device_ms(hessian_accum_plain, args)
                    row["library_ms"] = device_ms(
                        lambda a, b: torch.addmm(b, a.T, a, beta=beta,
                                                 alpha=2 * alpha),
                        [(x32, h)])
                    n_bytes = t * m * 2 + 2 * m * m * 4
                    flops = float(m) * (m + 1) * t    # the symmetric half
                    # a bf16 x bf16 product is exact in f32, so bf16 tensor
                    # cores with an f32 accumulator could do this work
                    row["bound_ms"], row["bound_by"] = bound(
                        n_bytes, flops, "bfloat16")
                    per_m.append(row)
                rows.append(row)
                say(f"  hessian_accum   {row['shape']:34s} err {err:.3e} "
                    f"tol {tol:.3e} symmetric {sym} ({route}) same bits "
                    f"{same} {'ok' if ok else 'FAIL'}"
                    + (f"  ms {row['ms']:.5f} plain {row['plain_ms']:.5f} "
                       f"lib {row['library_ms']:.5f} bound "
                       f"{row['bound_ms']:.5f}" if "ms" in row else ""))
            del x
    return per_m


def check_hessian_stacked(gen, rows):
    """hessian_accum on the pipelined engine's call: every calibration
    token of a segment in one launch, T = 128 x 2048 = 262144 bf16 tokens,
    α = 1/T, β = 0.  Both the kernel and the plain version sum T terms
    in f32, whose rounding drifts as sqrt(T)·eps, so the tolerance is
    KERNEL_TOL_REL (set at T = 16384) times sqrt(T / 16384); each side's
    distance from an f64 product is printed beside it."""
    import torch

    from repro_torch.kernels.hessian_accum import (hessian_accum,
                                                   hessian_accum_plain)

    t = 128 * 2048
    alpha = 1.0 / t
    per_m = []
    for m in (1024, 2816):
        x = torch.randn(t, m, generator=gen, device="cuda").to(torch.bfloat16)
        h = torch.empty(m, m, device="cuda")
        got = hessian_accum(x, h.clone(), alpha, 0.0)
        route = hessian_accum.last_kernel
        same = bool(torch.equal(got, hessian_accum(x, h.clone(), alpha,
                                                   0.0)))
        want = hessian_accum_plain(x, h.clone(), alpha, 0.0)
        x64 = x.double()
        exact = (2.0 * alpha) * (x64.T @ x64)
        del x64
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        err_k = (got.double() - exact).abs().max().item() / scale
        err_p = (want.double() - exact).abs().max().item() / scale
        tol = KERNEL_TOL_REL * math.sqrt(t / 16384) * scale
        sym = bool(torch.equal(got, got.T))
        del got, want, exact
        x32 = x.float()
        args = [(x, h, alpha, 0.0)]
        ms = device_ms(hessian_accum, args, n=3, reps=3)
        plain_ms = device_ms(hessian_accum_plain, args, n=3, reps=3)
        lib_ms = device_ms(lambda a: torch.addmm(h, a.T, a, beta=0.0,
                                                 alpha=2 * alpha),
                           [(x32,)], n=3, reps=3)
        b_ms, b_by = bound(t * m * 2 + m * m * 4, float(m) * (m + 1) * t,
                           "bfloat16")
        ok = (err <= tol and sym and same
              and route == _route_of(torch.bfloat16))
        row = dict(kernel="hessian_accum",
                   shape=f"T={t} m={m} bf16 α=1/T β=0 (stacked)",
                   max_abs_err=err, tol=tol, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, rel_err_vs_f64=(err_k, err_p), route=route,
                   deterministic=same)
        rows.append(row)
        per_m.append(row)
        say(f"  hessian_accum   {row['shape']:34s} err {err:.3e} tol "
            f"{tol:.3e} symmetric {sym} ({route}) same bits {same} "
            f"{'ok' if ok else 'FAIL'}; "
            f"vs f64: kernel {err_k:.2e} plain {err_p:.2e}  ms {ms:.5f} "
            f"plain {plain_ms:.5f} lib {lib_ms:.5f} bound {b_ms:.5f}")
        del x, x32, h, args
    return per_m


def _flash_inputs(gen, b, t, h, kv, hd, dtype):
    import torch

    q = torch.randn(b, t, h, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _flash_bound(b, t, h, kv, hd, causal):
    """Each input element read once (bf16), the f32 output written once;
    2·B·H·T²·hd flops causal (QKᵀ and PV over the lower triangle), twice
    that otherwise, on the bf16 tensor cores."""
    n_bytes = (b * t * h * hd + 2 * b * t * kv * hd) * 2 + b * t * h * hd * 4
    flops = (2.0 if causal else 4.0) * b * h * t * t * hd
    return bound(n_bytes, flops, "bfloat16")


def check_flash(gen, rows):
    """flash_attn against flash_attn_plain: f32 and bf16, causal and not,
    T in {128, 129, 200, 257, 2048} (T = 129 and 257 leave a 128-row
    query tile ragged), G in {1, 2}, each on its dtype's route; then the
    path's shapes in bf16 —
    one serial calibration batch (8, 2048, 16, 64) and the pipelined
    engine's stacked capture (128, 2048, 16, 64) — with device times,
    the bound and scaled_dot_product_attention as a yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain

    def err_of(got, want, dtype):
        err = (got - want).abs().max().item()
        tol = ((KERNEL_TOL_REL if dtype == torch.float32
                else BF16_KERNEL_TOL_REL) * max(1.0, want.abs().max().item()))
        return err, tol

    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for t in (128, 129, 200, 257, 2048):
                for g in (1, 2):
                    q, k, v = _flash_inputs(gen, 2, t, 4, 4 // g, 64, dtype)
                    got = flash_attn(q, k, v, causal)
                    route = flash_attn.last_kernel
                    want = flash_attn_plain(q, k, v, causal)
                    torch.cuda.synchronize()
                    err, tol = err_of(got, want, dtype)
                    dname = "f32" if dtype == torch.float32 else "bf16"
                    want_route = ("f32 FMA" if dtype == torch.float32
                                  else "tensor cores")
                    row = dict(kernel="flash_attn",
                               shape=f"B=2 T={t} H=4 G={g} hd=64 {dname} "
                                     f"{'causal' if causal else 'full'}",
                               max_abs_err=err, tol=tol,
                               ok=err <= tol and route == want_route,
                               route=route)
                    rows.append(row)
                    LOG.append(f"  flash_attn      {row['shape']:34s} err "
                               f"{err:.3e} tol {tol:.3e} ({route}) "
                               f"{'ok' if row['ok'] else 'FAIL'}")
    small = [r for r in rows if r["kernel"] == "flash_attn"]
    say(f"  flash_attn      {len(small)} cases (f32/bf16, causal/full, T "
        f"128/129/200/257/2048, G 1/2): worst err/tol "
        f"{max(r['max_abs_err'] / r['tol'] for r in small):.3e}")

    timed = []
    for b, label in ((8, "serial batch"), (128, "stacked capture")):
        q, k, v = _flash_inputs(gen, b, 2048, 16, 16, 64, torch.bfloat16)
        got = flash_attn(q, k, v, True)
        route = flash_attn.last_kernel
        chunk = 8                     # the plain version's (8·16, T, T) scores
        want = torch.cat([flash_attn_plain(q[i:i + chunk], k[i:i + chunk],
                                           v[i:i + chunk], True)
                          for i in range(0, b, chunk)])
        torch.cuda.synchronize()
        err, tol = err_of(got, want, torch.bfloat16)
        del got, want
        n, reps = (10, 3) if b == 8 else (5, 3)

        def plain_chunked(q, k, v, causal):
            for i in range(0, q.shape[0], chunk):
                flash_attn_plain(q[i:i + chunk], k[i:i + chunk],
                                 v[i:i + chunk], causal)

        args = [(q, k, v, True)]
        ms = device_ms(flash_attn, args, n=n, reps=reps)
        plain_ms = device_ms(plain_chunked, args, n=max(1, 32 // b), reps=3)
        sdpa = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))]
        lib_ms = device_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True), sdpa, n=n, reps=reps)
        b_ms, b_by = _flash_bound(b, 2048, 16, 16, 64, True)
        row = dict(kernel="flash_attn",
                   shape=f"B={b} T=2048 H=16 KV=16 hd=64 bf16 causal "
                         f"({label})",
                   max_abs_err=err, tol=tol, ok=err <= tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, route=route)
        rows.append(row)
        timed.append(row)
        say(f"  flash_attn      {row['shape']:52s} ({route}) err {err:.3e} "
            f"tol {tol:.3e} {'ok' if row['ok'] else 'FAIL'}  ms {ms:.5f} "
            f"plain {plain_ms:.5f} lib {lib_ms:.5f} bound {b_ms:.5f} "
            f"({b_by})")
        del q, k, v, sdpa, args
    return timed


def _band_pairs(t, window):
    """(query, key) pairs a causal attention over T tokens computes: every
    key at or before its query, or only the last ``window`` of them."""
    if window is None or window >= t:
        return t * (t + 1) / 2
    return window * (window + 1) / 2 + (t - window) * window


def check_flash_256(gen, rows):
    """flash_attn at gemma's head dim 256 and with a sliding window,
    against flash_attn_plain: f32 and bf16, causal and not, T in {128,
    129, 257, 2048}, G in {1, 2, 8} (H 8); windows 1024 at T 2048 and
    2100 and 64 at T 257 (the band across key tiles, ragged), causal,
    both dtypes.  Each row asserts its route (tensor cores for bf16, f32
    FMA for f32) and the same bits from a second call.  Then timed in
    bf16 at the prune path's stacked captures: gemma-2b's (128, 2048, 8,
    1, 256) causal and Gemma3-12B's (128, 2048, 16, 8, 256) over its
    window of 1024, beside scaled_dot_product_attention (an explicit
    mask for the window; k / v expanded to H heads) and the bound
    (operations over the band's pairs)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain

    cases = [(t, g, causal, None) for t in (128, 129, 257, 2048)
             for g in (1, 2, 8) for causal in (True, False)]
    cases += [(2048, 2, True, 1024), (2100, 2, True, 1024),
              (257, 8, True, 64)]
    n0 = len(rows)
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        want_route = "f32 FMA" if dtype == torch.float32 else "tensor cores"
        tol_rel = (KERNEL_TOL_REL if dtype == torch.float32
                   else BF16_KERNEL_TOL_REL)
        for t, g, causal, window in cases:
            q, k, v = _flash_inputs(gen, 1, t, 8, 8 // g, 256, dtype)
            got = flash_attn(q, k, v, causal, window)
            route = flash_attn.last_kernel
            same = bool(torch.equal(got, flash_attn(q, k, v, causal,
                                                    window)))
            want = flash_attn_plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = tol_rel * max(1.0, want.abs().max().item())
            row = dict(kernel="flash_attn",
                       shape=f"B=1 T={t} H=8 G={g} hd=256 {dname} "
                             f"{'causal' if causal else 'full'}"
                             + (f" window={window}" if window else ""),
                       max_abs_err=err, tol=tol,
                       ok=err <= tol and route == want_route and same,
                       route=route, deterministic=same)
            rows.append(row)
            LOG.append(f"  flash_attn      {row['shape']:46s} err "
                       f"{err:.3e} tol {tol:.3e} ({route}) same bits "
                       f"{same} {'ok' if row['ok'] else 'FAIL'}")
            del q, k, v, got, want
    new = rows[n0:]
    say(f"  flash_attn      {len(new)} cases at hd 256 (f32/bf16, causal/"
        f"full, T 128/129/257/2048, G 1/2/8; windows 1024 at T 2048/2100, "
        f"64 at T 257): {sum(r['ok'] for r in new)} ok, worst err/tol "
        f"{max(r['max_abs_err'] / r['tol'] for r in new):.3e}")

    timed = []
    for b, t, h, kv, window, label in (
            (128, 2048, 8, 1, None, "gemma-2b stacked capture"),
            (128, 2048, 16, 8, 1024, "Gemma3-12B stacked capture, local "
                                     "layer")):
        q, k, v = _flash_inputs(gen, b, t, h, kv, 256, torch.bfloat16)
        got = flash_attn(q, k, v, True, window)
        route = flash_attn.last_kernel
        chunk = 8
        want = torch.cat([flash_attn_plain(q[i:i + chunk], k[i:i + chunk],
                                           v[i:i + chunk], True, window)
                          for i in range(0, b, chunk)])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = BF16_KERNEL_TOL_REL * max(1.0, want.abs().max().item())
        del got, want

        def plain_chunked(q, k, v, causal, window):
            for i in range(0, q.shape[0], chunk):
                flash_attn_plain(q[i:i + chunk], k[i:i + chunk],
                                 v[i:i + chunk], causal, window)

        args = [(q, k, v, True, window)]
        ms = device_ms(flash_attn, args, n=3, reps=3)
        plain_ms = device_ms(plain_chunked, args, n=1, reps=3)
        g = h // kv
        sdpa = [(q.transpose(1, 2),
                 k.repeat_interleave(g, dim=2).transpose(1, 2),
                 v.repeat_interleave(g, dim=2).transpose(1, 2))]
        if window is None:
            lib_ms = device_ms(lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=True), sdpa, n=3, reps=3)
        else:
            # a masked call on the memory-efficient backend (the math
            # fallback would hold the (B, H, T, T) scores)
            from torch.nn.attention import SDPBackend, sdpa_kernel

            pos = torch.arange(t, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)

            def masked(a, b_, c):
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(a, b_, c,
                                                          attn_mask=band)

            lib_ms = device_ms(masked, sdpa, n=3, reps=3)
        pairs = _band_pairs(t, window)
        n_bytes = (b * t * h * 256 + 2 * b * t * kv * 256) * 2 \
            + b * t * h * 256 * 4
        b_ms, b_by = bound(n_bytes, 4.0 * b * h * 256 * pairs, "bfloat16")
        row = dict(kernel="flash_attn",
                   shape=f"B={b} T={t} H={h} KV={kv} hd=256 bf16 causal"
                         + (f" window={window}" if window else "")
                         + f" ({label})",
                   max_abs_err=err, tol=tol,
                   ok=err <= tol and route == "tensor cores", ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, route=route)
        rows.append(row)
        timed.append(row)
        say(f"  flash_attn      {row['shape']:70s} ({route}) err {err:.3e} "
            f"tol {tol:.3e} {'ok' if row['ok'] else 'FAIL'}  ms {ms:.5f} "
            f"plain {plain_ms:.5f} lib {lib_ms:.5f} bound {b_ms:.5f} "
            f"({b_by})")
        del q, k, v, sdpa, args
        torch.cuda.empty_cache()
    return timed


def check_dense_widths(gen, rows):
    """nm_spmm_decode (M 8) and nm_spmm (M 256) at the new models'
    widths: Qwen3-14B's seven linears, gemma-2b's mlp.wo (K 16384) and
    attn.wk (N 256), beside torch.matmul and the bound."""
    out = {"nm_spmm_decode": [], "nm_spmm": []}
    for m in (8, 256):
        for lin in (*QWEN3_LINEARS, *GEMMA_LINEARS):
            row = nm_row(gen, m, *lin)
            rows.append(row)
            out[row["kernel"]].append(row)
    return out


def _near_tie_gap(w, hinv):
    """Relative gap between the two smallest Eq. (12) pair losses of every
    group, from the plain losses: (R, G)."""
    import torch

    from repro_torch.kernels import ref

    two = torch.topk(ref.nm_select_losses(w, hinv), 2, dim=-1,
                     largest=False).values
    return (two[..., 1] - two[..., 0]) / two[..., 0].abs().clamp_min(1e-30)


def check_nm_select(gen, rows):
    """nm_select on the seven Qwen linears (R, C): one 128-column block as
    the MM loop hands it over (strided views of w and Hinv) and the whole
    matrix.  Masks must be bit-equal to the plain version's, on the vector
    route; differences are still sorted into near ties (plain gap <
    TIE_REL) and beyond, to say what a failure was."""
    import torch

    from repro_torch.kernels.nm_select import nm_select, nm_select_plain

    hinvs = {}
    for c in (1024, 2816):
        a = torch.randn(c, c, generator=gen, device="cuda")
        hinvs[c] = a @ a.T / c + torch.eye(c, device="cuda")
    per_block = []
    for name, k, n, _, _ in QWEN_LINEARS:
        r, c = n, k                        # paper orientation (out, in)
        w = torch.randn(r, c, generator=gen, device="cuda")
        for label, wv, hv in (("block", w[:, 128:256],
                               hinvs[c][128:256, 128:256]),
                              ("full", w, hinvs[c])):
            got = nm_select(wv, hv)
            route = nm_select.last_kernel
            want = nm_select_plain(wv, hv)
            torch.cuda.synchronize()
            diff = (got != want).reshape(r, -1, 4).any(-1)
            gap = _near_tie_gap(wv, hv)
            ties = int((diff & (gap < TIE_REL)).sum())
            bad = int((diff & (gap >= TIE_REL)).sum())
            equal = diff.numel() - int(diff.sum())
            valid = bool((got.reshape(r, -1, 4).sum(-1) == 2).all())
            # bit-equal masks: the kernel rounds each step as the plain
            # version does, so not even a near tie may differ
            ok = equal == diff.numel() and valid and route == "vector loads"
            row = dict(kernel="nm_select",
                       shape=f"{name} {label} R={r} C={wv.shape[1]}",
                       max_abs_err=float(bad + ties), tol=0.0, ok=ok,
                       ties=ties, equal=equal, route=route)
            if label == "block":
                # speed in the path's dtype: the compensated weights are bf16
                wb = w.to(torch.bfloat16)
                args = [(wb[:, 128:256], hv)]
                row["ms"] = device_ms(nm_select, args)
                # ~110 small kernels a call: 4 calls stay inside the launch
                # queue while the spin kernel holds the card
                row["plain_ms"] = device_ms(nm_select_plain, args, n=4)
                row["library_ms"] = None
                g = r * 32
                row["bound_ms"], row["bound_by"] = bound(
                    r * 128 * 2 + r * 128 + 32 * 10 * 4, g * 6 * 14.0,
                    "float32")
                per_block.append(row)
            rows.append(row)
            say(f"  nm_select       {row['shape']:34s} equal groups "
                f"{equal}/{diff.numel()} (differing: {bad} beyond ties, {ties}"
                f" ties) exactly-2 {valid} {route} "
                f"{'ok' if ok else 'FAIL'}"
                + (f"  ms {row['ms']:.5f} plain {row['plain_ms']:.5f} "
                   f"bound {row['bound_ms']:.5f}" if "ms" in row else ""))
    return per_block


# ----------------------------------------------------------------------
# phase 2: end to end, f32, reduced depth
# ----------------------------------------------------------------------
class Recorder:
    """Passes through to the LM and keeps every call's logits, and in
    ``steps`` which method made them ("decode" or "prefill")."""

    def __init__(self, model):
        self.model = model
        self.calls = []
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *a, **kw):
        out = self.model.decode_step(*a, **kw)
        self.calls.append(out.cpu())
        self.steps.append("decode")
        return out

    def prefill_chunk(self, *a, **kw):
        out = self.model.prefill_chunk(*a, **kw)
        self.calls.append(out.cpu())
        self.steps.append("prefill")
        return out

    def prefill(self, params, tokens, cache, **kw):
        """A static bucket's prefill; keeps the bucket's cache, a copy of
        its cross K / V and the tiled nm_spmm launches so far (phase 15b:
        the cross K / V are written here and nowhere after)."""
        from repro_torch.kernels import ops

        out = self.model.prefill(params, tokens, cache, **kw)
        self.calls.append(out.cpu())
        self.steps.append("prefill")
        self.cache = cache
        self.cross = [(c["xk"].clone(), c["xv"].clone()) for c in cache
                      if "xk" in c]
        self.tiled_at_prefill = ops.launch_counts()["nm_spmm"]
        return out


def e2e_f32(arch="qwen1.5-0.5b", layers=2, long_prompt=0, tag="e2e"):
    """The same requests served with the kernels and with the plain
    override, f32, ``arch`` at full width and ``layers`` deep; request 0's
    prompt ``long_prompt`` tokens long when given (past a window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = prune_linears(model.init(gen), "2:4")
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=(long_prompt if i == 0 and long_prompt
                                 else (40, 23, 70, 9)[i % 4]),
        dtype=np.int32), max_new_tokens=12) for i in range(8)]
    runs = {}
    for label in ("kernels", "plain"):
        rec = Recorder(model)
        eng = ServeEngine(rec, params, max_batch=8,
                          max_len=max(96, long_prompt + 16), page_size=16,
                          prefill_chunk=32)
        say(f"  {label}: {arena_line(eng)}")
        if label == "plain":
            with ops.override_dispatch(plain=True):
                res = eng.generate(reqs)
        else:
            res = eng.generate(reqs)
        runs[label] = (res, rec.calls)
    (rk, ck), (rp, cp) = runs["kernels"], runs["plain"]
    if len(ck) != len(cp):
        fail(f"{tag}: kernel and plain runs made different numbers of "
             "steps")
    max_diff, n_cmp = 0.0, 0
    for a, b in zip(ck, cp):
        max_diff = max(max_diff, (a - b).abs().max().item())
        n_cmp += 1
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break                   # streams part here: later inputs differ
    say(f"  per-step logits: max |kernel - plain| {max_diff:.3e} over "
        f"{n_cmp} steps (tol {LOGIT_TOL:g})")
    if max_diff > LOGIT_TOL:
        fail(f"{tag} logits differ by {max_diff:.3e} > {LOGIT_TOL:g}")
    n_tok = 0
    for a, b in zip(rk, rp):
        n_tok += len(b.tokens)
        diff = np.nonzero(a.tokens != b.tokens)[0]
        if len(diff) == 0:
            continue
        j = int(diff[0])
        ctx = np.concatenate([reqs[a.uid].prompt, b.tokens[:j]])
        with ops.override_dispatch(plain=True):
            lg = model.forward(params, torch.from_numpy(ctx)[None].cuda())
        top2 = torch.topk(lg[0, -1], 2).values
        gap = (top2[0] - top2[1]).item()
        say(f"  request {a.uid}: streams part at token {j}; plain top-two "
            f"gap there {gap:.3e}")
        if gap >= LOGIT_TOL:
            fail(f"{tag} stream of request {a.uid} differs at token {j} "
                 f"with a top-two gap {gap:.3e} >= {LOGIT_TOL:g}")
    say(f"  greedy streams: {n_tok} tokens, kernels == plain except near "
        "ties printed above")
    return dict(max_logit_diff=max_diff, steps=n_cmp, tokens=n_tok)


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------
def main_path():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=QWEN_SERVE_LAYERS)
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = prune_linears(model.init(gen), "2:4")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    long_req = [Request(uid=100, prompt=rng.integers(
        0, cfg.vocab_size, size=512, dtype=np.int32), max_new_tokens=32)]
    runs = [("8 requests, bf16 KV",
             dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32),
             reqs),
            ("512-token prompt, chunk 256",
             dict(max_batch=8, max_len=576, page_size=16,
                  prefill_chunk=256), long_req),
            ("8 requests, int8 KV",
             dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32,
                  kv_dtype="int8"), reqs)]
    engines = [ServeEngine(model, params, **runs[0][1])]
    del params                                      # the engine packed them
    engines += [ServeEngine(model, engines[0].params, **kw)
                for _, kw, _ in runs[1:]]
    packed = engines[0].n_sparse_leaves
    for (label, _, _), eng in zip(runs, engines):
        say(f"  {label}: {arena_line(eng)}")
    say(f"  packed {packed} linears ({cfg.num_layers} layers x 7)")
    if packed != cfg.num_layers * 7:
        fail(f"expected {cfg.num_layers * 7} packed linears, got {packed}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the main path starts
    outs = {}
    for (label, kw, rq), eng in zip(runs, engines):
        t0 = time.monotonic()
        res = eng.generate(rq)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        toks = sum(len(r.tokens) for r in res)
        st = eng.stats
        say(f"  {label}: {toks} tokens in {dt:.3f} s = {toks / dt:.1f} "
            f"tok/s; host syncs/token {st['host_syncs'] / toks:.3f}; "
            f"device steps/sync {st['device_steps'] / st['host_syncs']:.2f}"
            f"; prefill chunks {st['prefill_chunks']}; preemptions "
            f"{st['preemptions']}")
        for r in res:
            if len(r.tokens) != r_max(rq, r.uid) or (
                    r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size):
                fail(f"{label}: request {r.uid} emitted a bad stream "
                     f"{r.tokens.tolist()}")
        outs[label] = (res, toks / dt, st["host_syncs"] / toks)
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  launch counters over the main path: {counts}")
    say(f"  HBM held (max_memory_allocated): {hbm / 2**30:.3f} GiB")
    for name in SERVE_KERNELS:
        c = counts[name]
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")
    a = outs["8 requests, bf16 KV"][0]
    b = outs["8 requests, int8 KV"][0]
    same = sum(int(np.sum(x.tokens == y.tokens)) for x, y in zip(a, b))
    say(f"  int8 vs bf16 KV: {same}/{sum(len(x.tokens) for x in a)} tokens "
        "equal position by position (random init: no gate)")
    return counts, outs, hbm, engines, [rq for _, _, rq in runs]


def arena_line(eng):
    """The engine's pool and its pinned swap arena: pages, bytes and the
    time the arena's allocation took."""
    pool, arena = eng.pool, eng.pool.arena
    return (f"pool {pool.num_pages} pages, prefix cache "
            f"{'on' if pool.prefix is not None else 'off'}, swap arena "
            + (f"{arena.capacity} pages = {arena.nbytes / 2**20:.1f} MiB "
               f"{'pinned' if arena.pinned else 'pageable'} host memory, "
               f"allocated in {arena.alloc_s * 1e3:.1f} ms"
               if arena is not None else "off"))


def r_max(reqs, uid):
    return next(r.max_new_tokens for r in reqs if r.uid == uid)


def profile_main(eng, reqs):
    """Device busy / idle share and device time by kernel for one
    main-path generate."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = _device_us(prof)
    busy = sum(d for d, _ in evs) / 1e6
    by = {}
    for d, name in evs:
        key = ("nm_spmm tiled kernel (tensor cores)"
               if "nm_spmm_tc_kernel" in name
               else "nm_spmm_decode kernel (tensor cores)"
               if "nm_spmm_decode_tc_kernel" in name
               else "nm_spmm_kernel (f32 FMA)" if "nm_spmm_kernel" in name
               else "paged_attn kernel" if "paged_attn_kernel" in name
               else name[:60])
        by[key] = by.get(key, 0.0) + d / 1e6
    toks = sum(len(r.tokens) for r in res)
    paged = [d for d, name in evs if "paged_attn_kernel" in name]
    say(f"  profiled run: wall {wall:.3f} s, device busy {busy:.3f} s, "
        f"idle share {1 - busy / wall:.3f}, {len(evs)} kernels, "
        f"{len(evs) / max(1, eng.stats['device_steps'] + eng.stats['prefill_chunks']):.0f} per step")
    say(f"    paged_attn: {sum(paged) / 1e3:.3f} ms device time over "
        f"{len(paged)} launches ({sum(paged) / max(1, len(paged)):.2f} us "
        "a launch)")
    for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
        say(f"    {k:60s} {v * 1e3:9.3f} ms  ({v / wall:.3f} of wall)")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, busy_s=busy, tokens=toks, by_kernel_s=dict(top),
                kernels=len(evs), paged_attn_launches=len(paged),
                paged_attn_ms=sum(paged) / 1e3)


# ----------------------------------------------------------------------
# phase 3b: the reference's default serve features
# ----------------------------------------------------------------------
def profiled(fn):
    """``fn()`` under the profiler: its result, wall, device busy time
    and kernel count."""
    import torch

    t_start = time.monotonic()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = _device_us(prof)
    TIMING["profiled_s"] += time.monotonic() - t_start
    return out, wall, sum(d for d, _ in evs) / 1e6, len(evs)


def staged_prefix_run(eng, prompts, stage4):
    """Phase 3b's shared-prefix schedule through one session (a prompt's
    pages enter the index only when its last chunk activates it, so the
    requests come in stages):
      1. request 0 (a 48-token stem + 16 tokens of its own), stepped until
         it activates;
      2. requests 1-7 (the same stem, 16 of their own), until all decode;
      3. requests 8 and 9 repeat the prompts of 2 and 5 whole (3 pages
         shared, the 4th a copy-on-write source, one token prefilled);
      4. once the first wave has retired, requests 10 and 11: the prompts
         of 1 and 6 plus their first 20 generated tokens (``stage4``, or
         built from this run's streams when None): 5 full pages and a
         partial-tail copy at token 83.
    Returns the streams by uid and the stage-4 prompts."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import SeqState

    ses = eng.session()
    seqs, done = {}, {}
    live = (SeqState.RUNNING, SeqState.FINISHED)

    def submit(uid, prompt):
        seqs[uid] = ses.submit(Request(uid=uid, prompt=prompt,
                                       max_new_tokens=32))

    def step_until(cond):
        while not cond():
            if not ses.has_work():
                fail("phase 3b: the session ran dry before its stage ended")
            for ev in ses.step():
                if ev.finished:
                    if ev.finish_reason != "length":
                        fail(f"phase 3b: request {ev.uid} ended with "
                             f"{ev.finish_reason!r}")
                    done[ev.uid] = ev.result.tokens

    submit(0, prompts[0])
    step_until(lambda: seqs[0].state in live)
    for u in range(1, 8):
        submit(u, prompts[u])
    step_until(lambda: all(seqs[u].state in live for u in range(8)))
    submit(8, prompts[2])
    submit(9, prompts[5])
    step_until(lambda: all(u in done for u in range(8)))
    if stage4 is None:
        stage4 = [np.concatenate([prompts[u], done[u][:20]]) for u in (1, 6)]
    submit(10, stage4[0])
    submit(11, stage4[1])
    step_until(lambda: not ses.has_work())
    eng.pool.check_invariants()
    return done, stage4


def fmt_s(xs):
    return " / ".join(f"{x:.3f}" for x in xs)


def long_prefix_run(eng, a, rest):
    """The long prompts at prefill chunk 256 (the tiled nm_spmm) after an
    attach: request 0 (``a``, 512 tokens) runs to retirement; then
    request 1 repeats it plus its first 20 generated tokens (33 full pages
    and a partial-tail copy: one token prefilled, mid-page) beside
    request 2, ``a[:300]`` + ``rest`` (18 full pages shared).  Returns
    the streams by uid."""
    from repro_torch.serve.engine import Request

    ses = eng.session()
    done = {}

    def run(reqs):
        for r in reqs:
            ses.submit(r)
        while ses.has_work():
            for ev in ses.step():
                if ev.finished:
                    done[ev.uid] = ev.result.tokens

    run([Request(uid=0, prompt=a, max_new_tokens=32)])
    run([Request(uid=1, prompt=np.concatenate([a, done[0][:20]]),
                 max_new_tokens=32),
         Request(uid=2, prompt=np.concatenate([a[:300], rest]),
                 max_new_tokens=32)])
    eng.pool.check_invariants()
    return done


def default_serve_features(model, params, reqs):
    """Phase 3b: the prefix cache with copy-on-write attach (the staged
    shared-prefix schedule, cache on against off), swap against recompute
    preemption (phase 3's 8 requests on a 33-page pool, bf16 and int8
    pages) and cancel (mid-decode and swapped out) on Qwen1.5-0.5B at
    full width and depth.  Token streams must be equal between the runs
    compared — every kernel on the path computes each row of its launch
    independently of the others.  Returns the serving kernels' launches
    over the phase and its numbers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SeqState

    cfg = model.cfg
    totals = {k: 0 for k in SERVE_KERNELS}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c = ops.launch_counts()
        for k in SERVE_KERNELS:
            totals[k] += c[k]
        return out, {k: c[k] for k in SERVE_KERNELS}

    kw = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
    # the defaults' host cost where nothing matches: phase 3's 8 random
    # prompts with the cache and the arena on and with both off, in turns
    engs = {True: ServeEngine(model, params, **kw),
            False: ServeEngine(model, params, prefix_cache=False,
                               host_swap_pages=0, **kw)}
    plain, first = {True: [], False: []}, None
    for on in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out, _ = counted(lambda: engs[on].generate(reqs))
        plain[on].append(sum(len(r.tokens) for r in out)
                         / (time.monotonic() - t0))
        if engs[on].stats["prefix_hit_tokens"]:
            fail("phase 3b: random prompts matched the prefix index")
        first = first or out
        if any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(first, out)):
            fail("phase 3b: defaults on and off give different streams")
    say(f"  phase 3's 8 requests in turns, tok/s: defaults (prefix cache, "
        f"arena) {fmt_s(plain[True])}; both off {fmt_s(plain[False])}")
    del engs
    rng = np.random.default_rng(5)
    stem = rng.integers(0, cfg.vocab_size, 48, dtype=np.int32)
    prompts = [np.concatenate([stem, rng.integers(0, cfg.vocab_size, 16,
                                                  dtype=np.int32)])
               for _ in range(8)]
    runs, stage4 = {}, None
    for cache in (False, True):
        eng = ServeEngine(model, params, prefix_cache=cache, **kw)
        tag = "on" if cache else "off"
        say(f"  shared prefix, cache {tag}: {arena_line(eng)}")
        before = dict(eng.stats)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (streams, stage4), launches = counted(
            lambda: staged_prefix_run(eng, prompts, stage4))
        wall = time.monotonic() - t0
        st = {k: v - before[k] for k, v in eng.stats.items()}
        ((again, _), p_wall, busy, n_k), _ = counted(lambda: profiled(
            lambda: staged_prefix_run(eng, prompts, stage4)))
        for u, t in streams.items():
            if not np.array_equal(t, again[u]):
                fail(f"phase 3b: cache {tag}: request {u}'s stream differs "
                     "between two runs of the same schedule")
            if len(t) != 32 or t.min() < 0 or t.max() >= cfg.vocab_size:
                fail(f"phase 3b: request {u} emitted a bad stream")
        toks = sum(len(t) for t in streams.values())
        runs[cache] = dict(streams=streams, stats=st, wall_s=wall,
                           tok_s=toks / wall, launches=launches,
                           busy_s=busy, profiled_wall_s=p_wall, kernels=n_k)
        say(f"  shared prefix, cache {tag}: {toks} tokens in {wall:.3f} s = "
            f"{toks / wall:.1f} tok/s; prefill tokens {st['prefill_tok']}, "
            f"chunks {st['prefill_chunks']}, prefix hit tokens "
            f"{st['prefix_hit_tokens']}, pages reused "
            f"{st['prefix_pages_reused']}, cow copies {st['cow_copies']}, "
            f"evictions {st['prefix_evictions']}; host syncs "
            f"{st['host_syncs']}; profiled: wall {p_wall:.3f} s, device busy "
            f"{busy:.3f} s, idle share {1 - busy / p_wall:.3f}, {n_k} kernels;"
            f" launches {launches}")
        del eng
    # the long prompts: chunk 256, so every chunk takes the tiled nm_spmm
    a = rng.integers(0, cfg.vocab_size, 512, dtype=np.int32)
    rest = rng.integers(0, cfg.vocab_size, 232, dtype=np.int32)
    long = {}
    for cache in (False, True):
        eng = ServeEngine(model, params, prefix_cache=cache, max_batch=8,
                          max_len=576, page_size=16, prefill_chunk=256)
        tag = "on" if cache else "off"
        before = dict(eng.stats)
        t0 = time.monotonic()
        streams, launches = counted(lambda: long_prefix_run(eng, a, rest))
        wall = time.monotonic() - t0
        st = {k: v - before[k] for k, v in eng.stats.items()}
        long[cache] = dict(streams=streams, stats=st, wall_s=wall,
                           launches=launches)
        say(f"  long prompts at chunk 256, cache {tag}: {arena_line(eng)}; "
            f"wall {wall:.3f} s, prefill tokens {st['prefill_tok']}, chunks "
            f"{st['prefill_chunks']}, prefix hit tokens "
            f"{st['prefix_hit_tokens']}, cow copies {st['cow_copies']}; "
            f"launches {launches}")
        del eng
    for u in range(3):
        if not np.array_equal(long[False]["streams"][u],
                              long[True]["streams"][u]):
            fail(f"phase 3b: long prompt {u}'s stream differs with the "
                 "prefix cache on")
    lo, ln = long[False]["stats"], long[True]["stats"]
    if not (ln["cow_copies"] > 0 and ln["prefill_tok"] < lo["prefill_tok"]):
        fail(f"phase 3b: the long prompts did not attach: on {ln}, off {lo}")
    if long[True]["launches"]["nm_spmm"] <= 0:
        fail("phase 3b: the chunks after the attach did not launch the "
             "tiled nm_spmm")

    off, on = runs[False], runs[True]
    for u in range(12):
        if not np.array_equal(off["streams"][u], on["streams"][u]):
            fail(f"phase 3b: request {u}'s stream differs with the prefix "
                 f"cache on: {on['streams'][u].tolist()} vs "
                 f"{off['streams'][u].tolist()}")
    so, sn = off["stats"], on["stats"]
    if not (sn["prefix_hit_tokens"] > 0 and sn["cow_copies"] > 0
            and sn["prefill_tok"] < so["prefill_tok"]
            and sn["prefill_chunks"] < so["prefill_chunks"]
            and so["prefix_hit_tokens"] == 0):
        fail(f"phase 3b: the prefix cache saved nothing: on {sn}, off {so}")
    say(f"  cache on == off: 12 streams equal; prefill tokens "
        f"{so['prefill_tok']} -> {sn['prefill_tok']} (saved "
        f"{so['prefill_tok'] - sn['prefill_tok']}), chunks "
        f"{so['prefill_chunks']} -> {sn['prefill_chunks']}; device busy "
        f"{off['busy_s']:.3f} -> {on['busy_s']:.3f} s; tok/s "
        f"{off['tok_s']:.1f} -> {on['tok_s']:.1f}")

    # swap against recompute on a pool that must preempt
    swap, swap_eng, swap_streams = {}, None, {}
    for kv in ("fp32", "int8"):
        engs, gather = {}, {}
        for arena_pages in (None, 0):
            eng = ServeEngine(model, params, num_pages=33,
                              prefix_cache=False,
                              host_swap_pages=arena_pages, kv_dtype=kv,
                              **kw)
            engs[arena_pages] = eng
            if eng.pool.arena is not None:     # time the blocking D2H copy
                inner = eng.pool.arena.gather

                def timed(*a, _inner=inner):
                    t0 = time.perf_counter()
                    out = _inner(*a)
                    gather["s"] += time.perf_counter() - t0
                    return out

                eng.pool.arena.gather = timed
        page_bytes = sum(t[0].numel() * t.element_size()
                         for layer in engs[0].pool.kv for t in layer.values())
        res = {}
        for arena_pages in (None, 0, 0, None):  # in turns: swap first
            eng = engs[arena_pages]
            gather["s"] = 0.0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out, launches = counted(lambda: eng.generate(reqs))
            wall = time.monotonic() - t0
            if arena_pages in res:
                r = res[arena_pages]
                r["walls_s"].append(wall)
                if any(not np.array_equal(a.tokens, b.tokens)
                       for a, b in zip(r["out"], out)):
                    fail("phase 3b: a preempting run's streams differ "
                         "between two runs")
                continue
            res[arena_pages] = dict(out=out, stats=dict(eng.stats),
                                    wall_s=wall, walls_s=[wall],
                                    gather_s=gather["s"], launches=launches,
                                    arena=arena_line(eng))
        if kv == "fp32":
            swap_eng = engs[None]             # the cancel run below reuses it
            swap_streams = {r.uid: r.tokens for r in res[None]["out"]}
        del engs, eng
        sw, rc = res[None], res[0]
        label = "bf16" if kv == "fp32" else "int8"
        for a, b in zip(sw["out"], rc["out"]):
            if a.uid != b.uid or not np.array_equal(a.tokens, b.tokens):
                fail(f"phase 3b: {label} pages: request {a.uid}'s stream "
                     "differs between swap and recompute preemption")
        ss, sr = sw["stats"], rc["stats"]
        if not (ss["preempt_swap"] > 0 and ss["preempt_recompute"] == 0
                and ss["swap_out_pages"] == ss["swap_in_pages"] > 0):
            fail(f"phase 3b: {label} pages: the swap run did not swap: {ss}")
        if not (sr["preempt_recompute"] > 0
                and sr["prefill_tok"] > ss["prefill_tok"]):
            fail(f"phase 3b: {label} pages: the recompute run did not "
                 f"recompute: {sr}")
        out_b = ss["swap_out_pages"] * page_bytes
        in_b = ss["swap_in_pages"] * page_bytes
        swap[label] = dict(
            swap_walls_s=sw["walls_s"], recompute_walls_s=rc["walls_s"],
            swap_stats=ss, recompute_stats=sr, page_bytes=page_bytes,
            out_bytes=out_b, in_bytes=in_b, gather_s=sw["gather_s"],
            swap_in_wall_s=ss["swap_in_wall_s"],
            launches=dict(swap=sw["launches"], recompute=rc["launches"]))
        say(f"  swap vs recompute, {label} pages, 33-page pool: "
            f"{sw['arena']}")
        say(f"    streams equal; swap: walls {fmt_s(sw['walls_s'])} s, "
            f"preemptions {ss['preempt_swap']} swap / "
            f"{ss['preempt_recompute']} recompute, pages out "
            f"{ss['swap_out_pages']} in {ss['swap_in_pages']} "
            f"({page_bytes / 2**20:.3f} MiB a page), prefill tokens "
            f"{ss['prefill_tok']}; recompute: walls {fmt_s(rc['walls_s'])} s, "
            f"preemptions {sr['preempt_recompute']}, prefill tokens "
            f"{sr['prefill_tok']}")
        say(f"    device->host {out_b / 2**20:.1f} MiB in "
            f"{sw['gather_s'] * 1e3:.2f} ms "
            f"({out_b / max(sw['gather_s'], 1e-9) / 1e9:.2f} GB/s); "
            f"host->device {in_b / 2**20:.1f} MiB in "
            f"{ss['swap_in_wall_s'] * 1e3:.2f} ms (swap_in_wall_s, "
            f"{in_b / max(ss['swap_in_wall_s'], 1e-9) / 1e9:.2f} GB/s)")

    # cancel mid-decode and while swapped out
    eng = swap_eng
    ses = eng.session()
    for r in reqs:
        ses.submit(r)
    arena = eng.pool.arena
    done, gone = {}, {}

    def held():
        return sum(s.swap.n_host for s in ses.sched.waiting
                   if s.swap is not None)

    def cancel(seq, where):
        ev = ses.cancel(seq.req.uid)
        if ev is None or ev.finish_reason != "cancelled":
            fail(f"phase 3b: cancel of request {seq.req.uid} ({where}) "
                 "gave no terminal event")
        eng.pool.check_invariants()
        if arena.free_slots != arena.capacity - held():
            fail(f"phase 3b: cancel ({where}) leaked arena slots: "
                 f"{arena.free_slots} free of {arena.capacity}, "
                 f"{held()} held")
        gone[where] = (seq.req.uid, arena.free_slots, held())

    def step():
        for ev in ses.step():
            if ev.finished:
                done[ev.uid] = ev.result.tokens

    ops.reset_launch_counts()
    while ses.has_work():
        if "swapped out" not in gone:
            out = [s for s in ses.sched.waiting if s.swap is not None]
            if out:
                cancel(out[0], "swapped out")
        elif "mid-decode" not in gone:
            dec = [s for s in ses.sched.running
                   if s.state is SeqState.RUNNING and s.tokens]
            if dec:
                cancel(dec[-1], "mid-decode")
        if ses.has_work():
            step()
    c = ops.launch_counts()
    for k in SERVE_KERNELS:
        totals[k] += c[k]
    if set(gone) != {"swapped out", "mid-decode"}:
        fail(f"phase 3b: the cancel run cancelled only {sorted(gone)}")
    eng.pool.check_invariants()
    if arena.free_slots != arena.capacity:
        fail("phase 3b: arena slots leaked after the cancel run")
    for u, t in done.items():
        if not np.array_equal(t, swap_streams[u]):
            fail(f"phase 3b: request {u}'s stream changed when others "
                 "were cancelled")
    say(f"  cancel: request {gone['swapped out'][0]} while swapped out, "
        f"request {gone['mid-decode'][0]} mid-decode; after each the pool's "
        f"invariants held and the arena's free slots were its capacity "
        f"({arena.capacity}) less the slots other swapped requests hold "
        f"({gone['swapped out'][2]}, {gone['mid-decode'][2]}); the other "
        f"{len(done)} streams equal the swap run's; launches "
        f"{ {k: c[k] for k in SERVE_KERNELS} }")
    say(f"  serving kernels' launches over phase 3b: {totals}")
    for k in SERVE_KERNELS:
        if totals[k] <= 0:
            fail(f"kernel {k} was not launched in phase 3b")
    for r in (*runs.values(), *long.values()):
        del r["streams"]
    return totals, dict(random_prompts_tok_s={"defaults": plain[True],
                                              "off": plain[False]},
                        prefix={"off": runs[False], "on": runs[True]},
                        long_prefix={"off": long[False], "on": long[True]},
                        swap=swap, cancel=gone)


# ----------------------------------------------------------------------
# phase 3c: sampled decoding
# ----------------------------------------------------------------------
SAMPLINGS = (("temperature 0.8, top-k 40", dict(temperature=0.8, top_k=40)),
             ("temperature 0.8, top-p 0.9", dict(temperature=0.8, top_p=0.9)),
             ("temperature 1.0", dict(temperature=1.0)))


def _streams(res):
    return {r.uid: r.tokens for r in res}


def _check_streams(label, reqs, res, vocab):
    for r in res:
        if len(r.tokens) != r_max(reqs, r.uid) or (
                r.tokens.min() < 0 or r.tokens.max() >= vocab):
            fail(f"{label}: request {r.uid} emitted a bad stream "
                 f"{r.tokens.tolist()}")


def _same(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[u], b[u])
                                        for u in a)


def sampled_decoding(model, params, reqs, greedy):
    """Phase 3c: the three sampled settings of the reference launcher on
    phase 3's model and requests — streams equal at steps_per_sync 1 and
    8 and across swap, recompute and no preemption (the per-(uid, step)
    key contract); the card's threefry bits equal to the CPU's; the
    categorical flips between the card and the CPU on the same logits and
    keys; sampled against greedy tokens/s in turns; the launches and
    device time one sampled draw adds to a step.  Returns the serving
    kernels' launches over the phase and its numbers."""
    import torch

    from repro_torch import random as rnd
    from repro_torch.kernels import ops
    from repro_torch.serve import fused
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    totals = {k: 0 for k in SERVE_KERNELS}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c = ops.launch_counts()
        for k in SERVE_KERNELS:
            totals[k] += c[k]
        return out

    kw = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
    out = {}
    # threefry on the card against the CPU, at the draw's shape
    keys = rnd.fold_in(rnd.fold_in(rnd.key(0, "cuda"),
                                   torch.arange(8, device="cuda")), 5)
    bits = rnd.random_bits(keys, (cfg.vocab_size,))
    bits_cpu = rnd.random_bits(keys.cpu(), (cfg.vocab_size,))
    if not torch.equal(bits.cpu(), bits_cpu):
        fail("phase 3c: the card's threefry bits differ from the CPU's")
    say(f"  threefry: the (8, {cfg.vocab_size}) bits of 8 (uid, step) keys "
        "are equal on the card and the CPU, bit for bit")
    # categorical flips, card against CPU: the prompts' last logits, keys
    # of 8 uids x 4 steps, each setting
    dense = model.init_cache(len(reqs), 64 + 1)
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    with torch.no_grad():
        logits = model.prefill(params, toks, dense)
    del dense
    lg = logits.repeat(4, 1)                                   # (32, V)
    uids = torch.arange(8, device="cuda").repeat(4).to(torch.int32)
    steps = torch.arange(4, device="cuda").repeat_interleave(8).to(
        torch.int32)
    flips = {}
    for label, knobs in SAMPLINGS:
        kn = dict(dict(top_k=None, top_p=None), **knobs)
        a = fused.sample_rows(lg, uids, steps, rnd.key(0, "cuda"), **kn)
        b = fused.sample_rows(lg.cpu(), uids.cpu(), steps.cpu(),
                              rnd.key(0), **kn)
        flips[label] = int((a.cpu() != b).sum())
    say(f"  categorical draws card vs CPU on the same logits and keys "
        f"(32 draws a setting, V = {cfg.vocab_size}): flips {flips}")
    out["flips_of_32"] = flips
    # the launches and device time one sampled draw adds
    kn = dict(temperature=0.8, top_k=40, top_p=None)
    draw = lambda: fused.sample_rows(logits, uids[:8], steps[:8],  # noqa
                                     rnd.key(0, "cuda"), **kn)
    draw()
    # four calls a profile: the profiler has dropped a lone short call
    _, wall, busy, n_k = profiled(lambda: [draw() for _ in range(4)])
    wall, busy, n_k = wall / 4, busy / 4, n_k / 4
    _, gwall, gbusy, gn_k = profiled(
        lambda: [torch.argmax(logits, -1) for _ in range(4)])
    gbusy, gn_k = gbusy / 4, gn_k / 4
    say(f"  one sampled draw (8 rows, top-k 40; the mean of 4): {n_k:g} "
        f"kernels, device {busy * 1e3:.3f} ms, host {wall * 1e3:.3f} ms; "
        f"greedy argmax: {gn_k:g} kernels, device {gbusy * 1e3:.3f} ms")
    out["draw"] = dict(kernels=n_k, device_ms=busy * 1e3,
                       host_ms=wall * 1e3, greedy_kernels=gn_k,
                       greedy_device_ms=gbusy * 1e3)
    # streams at steps_per_sync 8 and 1, each setting
    base = {}
    for label, knobs in SAMPLINGS:
        res = {}
        for sps in (8, 1):
            eng = ServeEngine(model, params, steps_per_sync=sps, **knobs,
                              **kw)
            r = counted(lambda: eng.generate(reqs))
            _check_streams(f"phase 3c {label}", reqs, r, cfg.vocab_size)
            res[sps] = _streams(r)
            del eng
        if not _same(res[8], res[1]):
            fail(f"phase 3c: {label}: streams differ between "
                 "steps_per_sync 8 and 1")
        if _same(res[8], greedy):
            fail(f"phase 3c: {label}: the sampled streams equal the greedy "
                 "ones")
        base[label] = res[8]
        say(f"  {label}: streams equal at steps_per_sync 8 and 1")
    # a 33-page pool: swap, recompute — against the unpreempted streams
    label, knobs = SAMPLINGS[0]
    for arena in (None, 0):
        eng = ServeEngine(model, params, num_pages=33, prefix_cache=False,
                          host_swap_pages=arena, **knobs, **kw)
        r = counted(lambda: eng.generate(reqs))
        st = eng.stats
        kind = "preempt_swap" if arena is None else "preempt_recompute"
        if st[kind] <= 0:
            fail(f"phase 3c: the 33-page pool did not {kind}: {st}")
        if not _same(_streams(r), base[label]):
            fail(f"phase 3c: {label}: {kind} changed the streams")
        say(f"  {label}, 33-page pool: {st[kind]} x {kind}, streams equal "
            "to the unpreempted run's")
        del eng
    # sampled against greedy tokens/s, in turns
    engs = {"greedy": ServeEngine(model, params, **kw),
            "sampled": ServeEngine(model, params, **knobs, **kw)}
    rates = {"greedy": [], "sampled": []}
    for which in ("greedy", "sampled", "greedy", "sampled", "sampled",
                  "greedy"):
        eng = engs[which]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        r = counted(lambda: eng.generate(reqs))
        dt = time.monotonic() - t0
        rates[which].append(sum(len(x.tokens) for x in r) / dt)
    say(f"  tok/s in turns: greedy {fmt_s(rates['greedy'])}, sampled "
        f"({label}) {fmt_s(rates['sampled'])}")
    prof = {}
    for which, eng in engs.items():
        r, wall, busy, n_k = profiled(lambda: eng.generate(reqs))
        steps_run = eng.stats["device_steps"] + eng.stats["prefill_chunks"]
        prof[which] = dict(wall_s=wall, busy_s=busy, kernels=n_k,
                           kernels_per_step=n_k / max(1, steps_run),
                           busy_ms_per_step=busy * 1e3 / max(1, steps_run))
        say(f"  profiled {which}: wall {wall:.3f} s, device busy "
            f"{busy:.3f} s, idle share {1 - busy / wall:.3f}, {n_k} "
            f"kernels, {n_k / max(1, steps_run):.0f} and "
            f"{busy * 1e3 / max(1, steps_run):.3f} device ms a step")
    out.update(tok_s=rates, profile=prof)
    del engs
    say(f"  serving kernels' launches over phase 3c: {totals}")
    for k in ("nm_spmm_decode", "paged_attn"):
        if totals[k] <= 0:
            fail(f"kernel {k} was not launched in phase 3c")
    return totals, out


# ----------------------------------------------------------------------
# phase 3d: static mode
# ----------------------------------------------------------------------
STATIC_TIE = 0.0625      # phase 3d, bf16: |logit(a) - logit(b)| where the
                         # static and continuous greedy streams part (four
                         # bf16 ulps at the logits' magnitude)
STATIC_TIE_ULPS = 4      # phase 9: the same policy at its logits' magnitude


def _bf16_ulps(x: float, n: int) -> float:
    """``n`` bf16 ulps (8 significant bits) at the magnitude of ``x``."""
    return n * 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _first_divergence(model, params, reqs, got, want, tol, label,
                      ulps=None, feats=None):
    """Where two greedy streams part: the two tokens' logit gap from a
    full-sequence forward of the shared context; a gap of ``tol`` or
    more fails (not a near tie).  ``ulps``: the tolerance is that many
    bf16 ulps at the two logits' magnitude instead (STATIC_TIE is four
    at phase 3d's logits, which lie in [2, 4)).  ``feats``: a frontend
    model's features, row i for request i.  Returns the number of
    streams that part."""
    import torch

    parted = 0
    for i, r in enumerate(reqs):
        a, b = want[r.uid], got[r.uid]
        diff = np.nonzero(a != b)[0]
        if len(diff) == 0:
            continue
        parted += 1
        j = int(diff[0])
        ctx = np.concatenate([r.prompt, a[:j]])
        with torch.no_grad():
            lg = model.forward(params, torch.from_numpy(ctx)[None].cuda(),
                               frontend_feats=(None if feats is None
                                               else feats[i:i + 1]))
        la, lb = lg[0, -1, int(a[j])].item(), lg[0, -1, int(b[j])].item()
        gap = abs(la - lb)
        if ulps is not None:
            tol = _bf16_ulps(max(abs(la), abs(lb)), ulps)
        say(f"  {label}: request {r.uid} parts at token {j}: logit gap "
            f"{gap:.3e} at logits {la:.4g} / {lb:.4g} (tol {tol:g})")
        if gap >= tol:
            fail(f"{label}: request {r.uid} parts at token {j} with a gap "
                 f"{gap:.3e} >= {tol:g}: not a near tie")
    return parted


def static_mode(model, params, reqs, greedy):
    """Phase 3d: static mode on phase 3's model and requests (one bucket
    of 8 64-token prompts): greedy streams equal to the continuous greedy
    run's (except where they part at a near tie), one host sync a bucket,
    the tiled nm_spmm in the prefill (8 x 64 = 512 rows); sampled in both
    variants — ``fori`` (EOS off, one max_new) and ``while`` (mixed
    max_new), whose streams must be prefixes of the fori run's (the same
    split sequence, the same batch); then the f32 check at 2 layers:
    static against continuous greedy, near ties at LOGIT_TOL.  Returns
    the serving kernels' and flash_attn's launches and the phase's numbers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    counted = (*SERVE_KERNELS, "flash_attn")        # the prefill's attention
    totals = {k: 0 for k in counted}
    kw = dict(max_batch=8, max_len=128, mode="static")
    out = {}

    def run(eng, rq):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.generate(rq)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        c = ops.launch_counts()
        for k in counted:
            totals[k] += c[k]
        _check_streams("phase 3d", rq, res, cfg.vocab_size)
        if eng.stats["host_syncs"] != 1:
            fail(f"phase 3d: {eng.stats['host_syncs']} host syncs for one "
                 "bucket")
        toks = sum(len(r.tokens) for r in res)
        return _streams(res), c, toks / dt

    eng = ServeEngine(model, params, **kw)
    st, c, rate = run(eng, reqs)
    if c["nm_spmm"] <= 0 or c["flash_attn"] <= 0:
        fail("phase 3d: the prefill did not launch the tiled nm_spmm and "
             f"flash_attn: {c}")
    parted = _first_divergence(model, params, reqs, st, greedy, STATIC_TIE,
                               "phase 3d greedy static vs continuous")
    same = sum(int(np.sum(st[u] == greedy[u])) for u in st)
    say(f"  greedy: {len(reqs) - parted}/{len(reqs)} streams equal to the "
        f"continuous run's ({same}/{sum(len(v) for v in st.values())} "
        f"tokens), 1 host sync, {rate:.1f} tok/s; launches "
        f"{ {k: c[k] for k in counted} }")
    out["greedy"] = dict(parted=parted, tok_s=rate, launches=c)
    del eng
    knobs = dict(temperature=0.8, top_k=40)
    fori = ServeEngine(model, params, **knobs, **kw)
    st_f, c_f, rate_f = run(fori, reqs)
    mixed = [Request(uid=r.uid, prompt=r.prompt,
                     max_new_tokens=(8, 16, 24, 32)[r.uid % 4])
             for r in reqs]
    wl = ServeEngine(model, params, **knobs, **kw)
    st_w, c_w, rate_w = run(wl, mixed)
    if wl.stats["device_steps"] != 32 or fori.stats["device_steps"] != 32:
        fail("phase 3d: a bucket ran other than 32 steps")
    for r in mixed:
        if not np.array_equal(st_w[r.uid], st_f[r.uid][:r.max_new_tokens]):
            fail(f"phase 3d: the while variant's stream of request {r.uid} "
                 "is not a prefix of the fori variant's")
    if _same(st_f, st):
        fail("phase 3d: the sampled static streams equal the greedy ones")
    say(f"  sampled (temperature 0.8, top-k 40): fori {rate_f:.1f} tok/s, "
        f"while (max_new 8/16/24/32) {rate_w:.1f} tok/s; each while "
        "stream is the prefix of the fori stream")
    out["sampled"] = dict(fori_tok_s=rate_f, while_tok_s=rate_w)
    del fori, wl

    # f32 at 2 layers: static against continuous greedy
    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.models.transformer import LM

    cfg32 = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=2,
                                dtype="float32")
    m32 = LM(cfg32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    p32 = prune_linears(m32.init(gen), "2:4")
    cont = ServeEngine(m32, p32, max_batch=8, max_len=128, page_size=16,
                       prefill_chunk=32)
    want = _streams(cont.generate(reqs))
    got, _, _ = run(ServeEngine(m32, cont.params, **kw), reqs)
    parted32 = _first_divergence(m32, cont.params, reqs, got, want,
                                 LOGIT_TOL, "phase 3d f32 static vs "
                                 "continuous")
    say(f"  f32, 2 layers: {len(reqs) - parted32}/{len(reqs)} greedy static "
        "streams equal to the continuous run's")
    out["f32_parted"] = parted32
    say(f"  kernels' launches over phase 3d: {totals}")
    for k in counted:
        if totals[k] <= 0 and k != "paged_attn":
            fail(f"kernel {k} was not launched in phase 3d")
    return totals, out


# ----------------------------------------------------------------------
# phase 8: train -> prune -> serve the tiny LM on the card
# ----------------------------------------------------------------------
def _launch(mod, argv):
    """A launcher's ``main(argv)`` with its standard output captured
    (echoed into the log); returns (its return value, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        say(f"    | {line}")
    return ret, text


def _train(argv, label="phase 8", echo=True):
    """``python -m repro_torch.launch.train`` in a process of its own: it
    runs under deterministic algorithms, which cuBLAS allows only when
    CUBLAS_WORKSPACE_CONFIG is set before the process's first product
    (the launcher sets it; here the earlier phases have run products
    already).  Returns its standard output, echoed into the log unless
    ``echo`` is off."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return _process([sys.executable, "-m", "repro_torch.launch.train",
                     *argv], env, label, echo)


def _process(cmd, env, label, echo=True):
    """``cmd`` run from the checkout's root: its standard output, echoed
    into the log unless ``echo`` is off; a non-zero exit fails ``label``."""
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if echo:
        for line in proc.stdout.strip().splitlines():
            say(f"    | {line}")
    if proc.returncode != 0:
        fail(f"{label}: the trainer exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return proc.stdout


TRAIN_WORK = {"8": ROOT / "build" / "phase8",
              "10": ROOT / "build" / "phase10"}
TRAIN_STOPS = (("uninterrupted", (None,)), ("resumed", (150, None)))


def _train_chains():
    """Phases 8 and 10's trainer chains, {(phase, tag): (run one process,
    the arguments of each process in turn)}: paper_tiny_lm through
    ``launch.train`` (phase 8) and the tiny Mamba LM through
    ``--train-mamba`` (phase 10), each uninterrupted and stopped at 150
    then resumed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def mamba(args):
        return _process([sys.executable, str(ROOT / "chip_smoke.py"),
                         "--train-mamba", *args], env, "phase 10",
                        echo=False)

    chains = {}
    for tag, stops in TRAIN_STOPS:
        chains["8", tag] = (lambda a: _train(a, echo=False), [
            ["--out", str(TRAIN_WORK["8"] / tag)]
            + ([] if stop is None else ["--stop-at", str(stop)])
            for stop in stops])
        chains["10", tag] = (mamba, [
            [str(TRAIN_WORK["10"] / tag)]
            + ([] if stop is None else [str(stop)]) for stop in stops])
    return chains


def start_trainers():
    """Phases 8 and 10's four trainer chains, all at once, in the
    background while the kernels build (``nvcc`` on the host): a trainer
    launches no kernel of the port, is host-bound (27–70 ms a step) and
    deterministic in its own process, so the chains leave the same bits
    beside the build and beside one another.  Returns a future of
    {(phase, tag): (each process's output, the chain's wall seconds)};
    phase 1 waits for it, so that no trainer shares the card with a
    timed kernel."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    for work in TRAIN_WORK.values():
        shutil.rmtree(work, ignore_errors=True)
    chains = _train_chains()
    pool = ThreadPoolExecutor(len(chains))

    def run(run_one, args_list):
        t0 = time.monotonic()
        outs = [run_one(args) for args in args_list]
        return outs, time.monotonic() - t0

    futures = {key: pool.submit(run, *chain) for key, chain in chains.items()}
    pool.shutdown(wait=False)
    waiter = ThreadPoolExecutor(1)
    done = waiter.submit(lambda: {k: f.result() for k, f in futures.items()})
    waiter.shutdown(wait=False)
    return done


def _trained_runs(trained, phase, pattern, label):
    """A phase's two chains from ``start_trainers``' results: their
    outputs echoed into the log, and per chain its steps, losses, ms a
    step, HBM and wall."""
    runs = {}
    for tag, _ in TRAIN_STOPS:
        texts, wall = trained[phase, tag]
        parts = []
        for text in texts:
            for line in text.strip().splitlines():
                say(f"    | {line}")
            m = re.search(pattern, text)
            if m is None:
                fail(f"{label}: no training summary in {text!r}")
            parts.append([float(x) for x in m.groups()])
        runs[tag] = dict(wall_s=wall, first_loss=parts[0][1],
                         last_loss=parts[-1][2],
                         ms_per_step=[p[3] for p in parts],
                         hbm_mib=max(p[4] for p in parts),
                         steps=int(sum(p[0] for p in parts)))
        say(f"  train ({tag}): {runs[tag]['steps']} steps in "
            f"{wall:.1f} s (processes included), loss "
            f"{runs[tag]['first_loss']:.4f} -> {runs[tag]['last_loss']:.4f}"
            f", {' / '.join(f'{x:.2f}' for x in runs[tag]['ms_per_step'])} "
            f"ms a step, contended (beside the kernels' build and the other "
            f"three chains on one host and one card: not comparable with a "
            f"chain run alone), HBM held {runs[tag]['hbm_mib']:.1f} MiB")
    return runs


def _number_after(text, prefix):
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line[len(prefix):].split()[0])
    fail(f"phase 8: no {prefix!r} line in the launcher's output")


def train_prune_serve(trained):
    """Phase 8: ``repro_torch.launch.train`` with the reference's defaults
    (paper_tiny_lm, 300 steps, batch 16, seq 64, lr 1e-3 warmup-cosine,
    a checkpoint every 50), an identical run stopped at step 150 and
    resumed (its step-300 checkpoint must equal the uninterrupted one's
    bit for bit, under deterministic algorithms); every param leaf's
    gradient on the card; ``repro_torch.launch.prune --ckpt`` for MM 2:4
    and SM 0.5 (the synthetic corpus's calibration and eval batches;
    flash_attn, hessian_accum and nm_select counted); the MM 2:4 model
    packed and served sampled.  Returns the kernels' launches over the
    phase and its numbers."""
    import shutil

    import torch

    from repro_torch import random as rnd
    from repro_torch.ckpt import CheckpointStore, load_pytree
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    work = TRAIN_WORK["8"]
    out = {}
    totals = {k: 0 for k in ops.KERNELS}

    def count(c):
        for k in totals:
            totals[k] += c[k]

    # every leaf gets a gradient through the differentiable route
    cfg = get_config("paper_tiny_lm")
    model = LM(cfg, device="cuda")
    params = model.init(rnd.key(0, "cuda"))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = DataPipeline(cfg, 16, 64, device="cuda").batch_at(0)
    ops.reset_launch_counts()
    loss, _ = model.loss_fn(params, batch, differentiable=True)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        fail(f"phase 8: the training route launched a kernel: "
             f"{ops.launch_counts()}")
    if not all(g is not None and bool(torch.isfinite(g).all())
               and float(g.abs().sum()) > 0 for g in grads):
        fail("phase 8: a param leaf got no gradient on the card")
    say(f"  differentiable loss {float(loss):.4f}: all {len(grads)} param "
        "leaves have finite, nonzero gradients on the card, no kernel "
        "launched")
    del params, leaves, grads, loss

    # trained: uninterrupted, and stopped at 150 then resumed (the chains
    # ran beside the kernels' build: start_trainers)
    runs = _trained_runs(trained, "8", r"trained (\d+) steps.*\nloss "
                         r"([\d.]+) -> ([\d.]+); ([\d.]+) ms a step "
                         r"\(median\) on \S+; HBM held ([\d.]+) MiB",
                         "phase 8")
    full = runs["uninterrupted"]
    if not full["last_loss"] < full["first_loss"] - 1.0:
        fail(f"phase 8: the loss did not fall: {full}")
    a, _ = load_pytree(str(work / "uninterrupted" / "step_00000300"))
    b, _ = load_pytree(str(work / "resumed" / "step_00000300"))
    if a.keys() != b.keys():
        fail("phase 8: the resumed checkpoint has other leaves")
    diff = [k for k in a if not np.array_equal(a[k], b[k])]
    if diff:
        fail(f"phase 8: the resumed run differs from the uninterrupted one "
             f"in {diff[:5]}")
    say(f"  resumed at 150 -> 300: all {len(a)} checkpoint leaves "
        "(params, moments, step) bit-identical to the uninterrupted run's")
    out["train"] = runs

    # prune the checkpoint, MM 2:4 and SM 0.5
    ckpt = str(work / "uninterrupted")
    if CheckpointStore(ckpt).latest_step() != 300:
        fail("phase 8: the trainer's latest checkpoint is not step 300")
    prune_runs = {}
    for method, sparsity in (("MM", "2:4"), ("SM", "0.5")):
        ops.reset_launch_counts()
        t0 = time.monotonic()
        _, text = _launch(launch_prune, [
            "--arch", "paper_tiny_lm", "--ckpt", ckpt, "--method", method,
            "--sparsity", sparsity, "--out", str(work / f"{method}")])
        torch.cuda.synchronize()
        c = ops.launch_counts()
        count(c)
        pr = dict(wall_s=time.monotonic() - t0,
                  dense_ppl=_number_after(text, "dense ppl: "),
                  pruned_ppl=_number_after(text, f"{method} {sparsity} ppl: "),
                  launches={k: c[k] for k in PRUNE_KERNELS})
        prune_runs[f"{method} {sparsity}"] = pr
        if "synthetic corpus" not in text:
            fail("phase 8: the prune launcher did not take the corpus")
        for k in ("flash_attn", "hessian_accum") + (
                ("nm_select",) if method == "MM" else ()):
            if c[k] <= 0:
                fail(f"phase 8: {method} {sparsity}: kernel {k} was not "
                     "launched")
        say(f"  prune {method} {sparsity}: dense ppl {pr['dense_ppl']:.4f}, "
            f"pruned {pr['pruned_ppl']:.4f}, {pr['wall_s']:.1f} s, launches "
            f"{pr['launches']}")
    out["prune"] = prune_runs

    # serve the MM 2:4 model, sampled
    flat, _ = load_pytree(str(work / "MM" / "pruned_params"))
    pruned = model.params_from_jax(flat)
    eng = ServeEngine(model, pruned, max_batch=8, max_len=128, page_size=16,
                      prefill_chunk=32, temperature=0.8, top_p=0.9)
    if eng.n_sparse_leaves != cfg.num_layers * 7:
        fail(f"phase 8: {eng.n_sparse_leaves} packed leaves, expected "
             f"{cfg.num_layers * 7}")
    pipe = DataPipeline(cfg, 8, 32, device="cuda")
    prompts = pipe.eval_batch(100)["tokens"].cpu().numpy()
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=32)
            for i in range(8)]
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = eng.generate(reqs, seed=0)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    c = ops.launch_counts()
    count(c)
    _check_streams("phase 8 serve", reqs, res, cfg.vocab_size)
    toks = sum(len(r.tokens) for r in res)
    for k in ("nm_spmm_decode", "paged_attn"):
        if c[k] <= 0:
            fail(f"phase 8: serving the pruned model did not launch {k}")
    say(f"  served the MM 2:4 model (packed {eng.n_sparse_leaves} linears), "
        f"sampled top-p 0.9: {toks} tokens in {dt:.3f} s = {toks / dt:.1f} "
        f"tok/s; launches {c}")
    out["serve"] = dict(tok_s=toks / dt, launches=c)
    say(f"  kernels' launches over phase 8: {totals}")
    shutil.rmtree(work, ignore_errors=True)
    return totals, out


# ----------------------------------------------------------------------
# phase 9: Jamba-1.5-Large's blocks (no experts) at full width
# ----------------------------------------------------------------------
JAMBA_LINEARS = (                    # the packed linears of Jamba's blocks
    ("attn.wq", 8192, 8192, False, None),
    ("attn.wk", 8192, 1024, False, None),
    ("attn.wv", 8192, 1024, False, None),
    ("attn.wo", 8192, 8192, False, None),
    ("mlp.wi", 8192, 24576, False, None),
    ("mlp.wg", 8192, 24576, False, "silu"),
    ("mlp.wo", 24576, 8192, False, None),
)
JAMBA_LENGTHS = [96, 70, 65, 0, 33, 96, 17, 81]     # slot 3 idle
JAMBA_PAGED = [
    ("Jamba B=8 KV=8 G=8 hd=128 ps=16", 8, 8, 8, 128, 16, 8, JAMBA_LENGTHS,
     None, False, 0),
    ("Jamba B=8 int8 pages", 8, 8, 8, 128, 16, 8, JAMBA_LENGTHS, None, True,
     0),
    ("Jamba B=8 p_max=36 one slot 544 keys", 8, 8, 8, 128, 16, 36,
     [544] + [0] * 7, None, False, 0)]
STARVED_PAGES = 33                   # phase 9: 32 allocatable pages for 8
                                     # prompts of 4 pages that each grow to 6


def _jamba_blocks():
    """Jamba-1.5-Large's config without the experts: one period (8
    layers, slot 3 attention), every slot with its dense SwiGLU FFN."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("jamba_1_5_large_398b"), moe=None,
                               moe_slots=(), num_layers=8)


def _scan_ms(cfg):
    """Device time of the selective scan alone at phase 9's shapes: one
    decode step's recurrence over the 7 Mamba layers (B = 8), and the
    Hillis–Steele scan of one layer for a 256-token chunk and for the
    static bucket's 8 x 64 prompt."""
    import torch

    from repro_torch.models import ssm

    di, n = cfg.d_inner, cfg.ssm_state
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    a = -torch.rand(di, n, generator=gen, device="cuda") * n

    def step(dt, xc, b, c, state):
        abar = torch.exp(dt[:, :, None] * a[None])
        st = abar * state + (dt * xc)[..., None] * b[:, None, :]
        return torch.einsum("bdn,bn->bd", st, c)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    dec = [(rand(8, di) * 0.1, rand(8, di), rand(8, n), rand(8, n),
            rand(8, di, n)) for _ in range(7)]
    out = {"decode step, 7 layers, B=8": 7 * device_ms(step, dec)}
    for label, bsz, t in (("prefill chunk, 1 layer, 1 x 256", 1, 256),
                          ("static prefill, 1 layer, 8 x 64", 8, 64)):
        args = [(rand(bsz, t, di) * 0.1, rand(bsz, t, di), rand(bsz, t, n),
                 rand(bsz, t, n), a)]
        out[label] = device_ms(ssm._mamba_ssm_scan, args, n=5, reps=3)
    return out


def hybrid_full_width(gen, rows):
    """Phase 9: Jamba's blocks at full width (d_model 8192, 7 Mamba + 1
    attention, bf16), random weights from a seeded torch.Generator,
    magnitude 2:4 on the mlp and attn linears, packed.  Serves the 8
    requests continuous (page 16, chunk 32), one 512-token prompt at chunk
    256, the 8 as one static bucket, the 8 on a starved pool (recompute
    preemption only), and two requests on one 48-token stem one after
    the other (the prefix cache asked for, none built over recurrent
    state).  Then the kernels at Jamba's shapes, a profiled generate and
    the selective scan's device time.  Returns the launches of the
    serving runs and the phase's numbers."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import compressed_param_tree

    cfg = _jamba_blocks()
    model = LM(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = compressed_param_tree(prune_linears(model.init(g), "2:4"))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    say(f"  init + magnitude 2:4 + packing in {time.monotonic() - t0:.1f} s;"
        f" params {n_bytes / 2**30:.3f} GiB on the card")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    long_req = [Request(uid=100, prompt=rng.integers(
        0, cfg.vocab_size, size=512, dtype=np.int32), max_new_tokens=32)]
    stem = rng.integers(0, cfg.vocab_size, size=48, dtype=np.int32)
    pair = [Request(uid=200 + i, prompt=np.concatenate(
        [stem, rng.integers(0, cfg.vocab_size, size=16, dtype=np.int32)]),
        max_new_tokens=16) for i in range(2)]
    kw = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
    eng = ServeEngine(model, params, **kw)
    long_eng = ServeEngine(model, params, **{**kw, "max_len": 576,
                                             "prefill_chunk": 256})
    static = ServeEngine(model, params, max_batch=8, max_len=128,
                         mode="static")
    starved = ServeEngine(model, params, **kw, num_pages=STARVED_PAGES)
    if eng.n_sparse_leaves != 8 * 3 + 4:
        fail(f"phase 9: {eng.n_sparse_leaves} packed leaves, expected 28 "
             "(8 FFNs x 3 + the attention's 4)")
    for e in (eng, starved):
        if e.pool.prefix is not None or e.state_pool is None or e._swap_ok:
            fail("phase 9: the hybrid's engine built a prefix index or "
                 "allows swap")
    say(f"  engine: {arena_line(eng)}; state rows of {len(eng.state_pool.entries)}"
        " Mamba layers")
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the path starts

    def run(label, e, rq):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = e.generate(rq)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        _check_streams(f"phase 9 {label}", rq, res, cfg.vocab_size)
        toks = sum(len(r.tokens) for r in res)
        st = dict(e.stats)
        say(f"  {label}: {toks} tokens in {dt:.3f} s = {toks / dt:.2f} "
            f"tok/s; host syncs/token {st['host_syncs'] / toks:.3f}; "
            f"prefill chunks {st['prefill_chunks']}; preemptions "
            f"recompute {st['preempt_recompute']} swap {st['preempt_swap']}"
            f"; prefix hit tokens {st['prefix_hit_tokens']}")
        out[label] = dict(tok_s=toks / dt, wall_s=dt,
                          syncs_per_token=st["host_syncs"] / toks, stats=st)
        if st["preempt_swap"]:
            fail(f"phase 9 {label}: a swap preemption")
        return _streams(res)

    cont = run("8 requests, continuous", eng, reqs)
    run("512-token prompt, chunk 256", long_eng, long_req)
    stat = run("8 requests, static", static, reqs)
    pre = run(f"8 requests, {STARVED_PAGES}-page pool", starved, reqs)
    # the stem pair: one request after the other, so that a prefix index
    # (were there one) would hold the first's pages when the second comes
    before = dict(eng.stats)
    session = eng.session()
    got = {}
    for r in pair:
        session.submit(r)
        while session.has_work():
            for ev in session.step():
                if ev.finished:
                    got[ev.uid] = ev.result.tokens
    hits = eng.stats["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    pair_static = _streams(static.generate(pair))
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  stem pair: prefix hit tokens {hits}; launches over the phase's "
        f"serving runs {counts}; HBM held {hbm / 2**30:.3f} GiB")
    parted = _first_divergence(model, params, reqs, stat, cont, STATIC_TIE,
                               "phase 9 continuous vs static",
                               ulps=STATIC_TIE_ULPS)
    if pre.keys() != cont.keys() or any(not np.array_equal(pre[u], cont[u])
                                        for u in cont):
        fail("phase 9: the preempted run's streams differ from the "
             "unstarved run's")
    n_pre = out[f"8 requests, {STARVED_PAGES}-page pool"]["stats"][
        "preempt_recompute"]
    if n_pre < 2:
        fail(f"phase 9: the starved pool preempted {n_pre} times (< 2)")
    if hits != 0:
        fail(f"phase 9: {hits} prefix hit tokens over recurrent state")
    parted_pair = _first_divergence(model, params, pair, pair_static, got,
                                    STATIC_TIE, "phase 9 stem pair vs static",
                                    ulps=STATIC_TIE_ULPS)
    for k in ("nm_spmm", "nm_spmm_decode", "paged_attn", "flash_attn"):
        if counts[k] <= 0:
            fail(f"phase 9: kernel {k} was not launched")
    say(f"  continuous vs static: {len(reqs) - parted}/{len(reqs)} streams "
        f"equal (the rest part at near ties); {STARVED_PAGES}-page pool: "
        f"{n_pre} recompute preemptions, streams equal to the unstarved "
        f"run's; stem pair: 0 hits, {2 - parted_pair}/2 equal to static")
    out["parted"] = dict(static=parted, stem_pair=parted_pair)
    out["hbm_gib"] = hbm / 2**30
    out["launches"] = counts

    say("  the profiled run: the 8 requests, continuous")
    out["profile"] = profile_main(eng, reqs)
    del eng, long_eng, static, starved, session
    torch.cuda.empty_cache()
    say("  kernels at Jamba's shapes (bf16 timings; torch.matmul / SDPA "
        "beside)")
    jrows = [nm_row(gen, m, *lin) for m in (8, 256) for lin in JAMBA_LINEARS]
    jrows += list(paged_rows(gen, [], JAMBA_PAGED).values())
    rows.extend(jrows)
    out["kernel_rows"] = jrows
    scan = _scan_ms(cfg)
    for k, v in scan.items():
        say(f"  selective scan, {k}: {v:.4f} ms device time")
    out["scan_ms"] = scan
    del params
    torch.cuda.empty_cache()
    return counts, out


# ----------------------------------------------------------------------
# phase 10: the paper's Table 3 on the card
# ----------------------------------------------------------------------
TABLE3 = (("magnitude", "0.5"), ("wanda", "0.5"), ("SS", "0.5"),
          ("SM", "0.5"), ("MM", "2:4"))


def train_mamba(out, stop_at=None):
    """The tiny Mamba LM's training with the reference's benchmark
    defaults (``benchmarks/common.py``: 300 steps, batch 16 x 64, lr 1e-3
    on warmup_cosine(lr, 20, 300)), a checkpoint every 50 steps, under
    deterministic algorithms — run as ``python3 chip_smoke.py
    --train-mamba OUT [STOP_AT]`` in a process of its own, since cuBLAS
    allows deterministic mode only when CUBLAS_WORKSPACE_CONFIG is set
    before the process's first product.  Prints the launcher's summary
    lines."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs.paper_tiny_lm import MAMBA
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    torch.use_deterministic_algorithms(True)
    model = LM(MAMBA, device="cuda")
    pipe = DataPipeline(MAMBA, 16, 64, seed=0, device="cuda")
    trainer = Trainer(model, AdamW(lr=warmup_cosine(1e-3, 20, 300)), pipe,
                      TrainConfig(total_steps=300, global_batch=16,
                                  seq_len=64, ckpt_every=50, out_dir=out,
                                  log_every=100))
    steps = None if stop_at is None else (
        stop_at - (trainer.store.latest_step() or 0))
    _, _, info = trainer.run(steps)
    secs = info["step_seconds"]
    print(f"trained {info['steps']} steps")
    print(f"loss {info['first_loss']:.4f} -> {info['last_loss']:.4f}; "
          f"{statistics.median(secs) * 1e3:.2f} ms a step (median); HBM "
          f"held {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return 0


def last_token_acc(model, params, batches):
    """The reference's LAMBADA analogue (``benchmarks/common.py``,
    ``eval_last_token_acc``): the share of eval segments whose final
    token is the argmax at the position before it."""
    import torch

    hit = tot = 0
    with torch.no_grad():
        for b in batches:
            logits = model.forward(params, b["tokens"])
            pred = torch.argmax(logits[:, -2, :], dim=-1)
            hit += int((pred == b["tokens"][:, -1]).sum())
            tot += int(b["tokens"].shape[0])
    return hit / tot


def mamba_table3(trained):
    """Phase 10: paper-tiny-mamba trained on the card with the reference's
    benchmark defaults, uninterrupted and stopped at 150 then resumed
    (bit-identical checkpoints); pruned with magnitude, wanda, SS and SM
    at 0.5 (blocksize 64, 32 x 64 corpus calibration tokens) and MM 2:4
    through the default pipelined engine; dense and pruned perplexity
    and last-token accuracy on the 8 eval batches of
    ``benchmarks/common.py``; the MM model served greedily, continuous
    against static.  Returns the kernels' launches and the numbers."""
    import shutil

    import torch

    from repro_torch.ckpt import load_pytree
    from repro_torch.configs.paper_tiny_lm import MAMBA
    from repro_torch.data import DataPipeline, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import is_24_sparse

    work = TRAIN_WORK["10"]
    out = {}
    totals = {k: 0 for k in ops.KERNELS}
    runs = _trained_runs(trained, "10", r"trained (\d+) steps\nloss "
                         r"([\d.]+) -> ([\d.]+); ([\d.]+) ms a step "
                         r"\(median\); HBM held ([\d.]+) MiB", "phase 10")
    full = runs["uninterrupted"]
    if not full["last_loss"] < full["first_loss"] - 1.0:
        fail(f"phase 10: the loss did not fall: {full}")
    a, _ = load_pytree(str(work / "uninterrupted" / "step_00000300"))
    b, _ = load_pytree(str(work / "resumed" / "step_00000300"))
    diff = [k for k in a if k not in b or not np.array_equal(a[k], b[k])]
    if a.keys() != b.keys() or diff:
        fail(f"phase 10: the resumed run differs from the uninterrupted one"
             f" in {diff[:5]}")
    say(f"  resumed at 150 -> 300: all {len(a)} checkpoint leaves (params, "
        "moments, step) bit-identical to the uninterrupted run's")
    out["train"] = runs

    model = LM(MAMBA, device="cuda")
    params = launch_prune.load_params(model, str(work / "uninterrupted"))
    calib = calibration_batches(MAMBA, n_samples=32, seq_len=64,
                                device="cuda")
    pipe = DataPipeline(MAMBA, 16, 64, seed=0, device="cuda")
    evals = [pipe.eval_batch(i) for i in range(8)]
    dense = dict(ppl=launch_prune.eval_ppl(model, params, evals),
                 acc=last_token_acc(model, params, evals))
    say(f"  dense: ppl {dense['ppl']:.4f}, last-token accuracy "
        f"{dense['acc']:.4f}")
    table = {"dense": dense}
    pruned_mm = None
    for method, spec in TABLE3:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pruned, reports = launch_prune.prune(model, params, calib, spec,
                                             method, blocksize=64)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        c = ops.launch_counts()
        for k in totals:
            totals[k] += c[k]
        row = dict(ppl=launch_prune.eval_ppl(model, pruned, evals),
                   acc=last_token_acc(model, pruned, evals), wall_s=wall,
                   launches={k: c[k] for k in PRUNE_KERNELS})
        table[f"{method} {spec}"] = row
        say(f"  {method} {spec}: ppl {row['ppl']:.4f}, last-token accuracy "
            f"{row['acc']:.4f}, {wall:.2f} s, launches {row['launches']}")
        if len(reports) != 4 * MAMBA.num_layers or any(
                abs(r.sparsity - 0.5) > 1e-6 for r in reports):
            fail(f"phase 10: {method} {spec}: {len(reports)} linears, or a "
                 "sparsity other than 0.5")
        if not (math.isfinite(row["ppl"]) and 0.0 <= row["acc"] <= 1.0):
            fail(f"phase 10: {method} {spec}: non-finite result {row}")
        if method in ("SS", "SM", "MM") and c["hessian_accum"] <= 0:
            fail(f"phase 10: {method}: hessian_accum was not launched")
        if method == "MM":
            if c["nm_select"] <= 0:
                fail("phase 10: MM: nm_select was not launched")
            if not all(is_24_sparse(lp["mamba"][k]) for lp in pruned["layers"]
                       for k in ("in_proj", "x_proj", "dt_proj",
                                 "out_proj")):
                fail("phase 10: MM 2:4 left a group of 4 with more than 2 "
                     "nonzeros")
            pruned_mm = pruned
    sm_lt_ss = table["SM 0.5"]["ppl"] < table["SS 0.5"]["ppl"]
    say(f"  SM < SS at 0.5 (the paper's ordering; no gate): {sm_lt_ss}")
    out["table3"] = table
    out["sm_lt_ss"] = sm_lt_ss

    # the MM model served greedily, continuous against static
    prompts = pipe.eval_batch(100)["tokens"][:, :32].cpu().numpy()
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=32)
            for i in range(8)]
    served = {}
    for mode in ("continuous", "static"):
        eng = ServeEngine(model, pruned_mm, max_batch=8, max_len=128,
                          page_size=16, prefill_chunk=32, mode=mode)
        ops.reset_launch_counts()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        for k in totals:
            totals[k] += c[k]
        _check_streams(f"phase 10 serve {mode}", reqs, res,
                       MAMBA.vocab_size)
        served[mode] = _streams(res)
    parted = _first_divergence(model, pruned_mm, reqs, served["static"],
                               served["continuous"], LOGIT_TOL,
                               "phase 10 MM served continuous vs static")
    say(f"  served the MM 2:4 model greedily: {8 - parted}/8 streams equal "
        "continuous and static (the rest part at near ties); Mamba "
        "linears stay dense (no packed leaf)")
    out["serve_parted"] = parted
    say(f"  kernels' launches over phase 10: {totals}")
    shutil.rmtree(work, ignore_errors=True)
    return totals, out


# ----------------------------------------------------------------------
# phase 5: the prune path
# ----------------------------------------------------------------------
def _pruned_masks(model, params):
    """{linear name: bool mask (out, in), True = pruned} of every layer."""
    from repro_torch.core.pruner import LINEARS

    return {f"period{i}.s0.{sub}.{key}": (lp[sub][key].T == 0)
            for i, lp in enumerate(params["layers"]) for sub, key in LINEARS}


@contextlib.contextmanager
def count_syncs(box):
    """Counts the host syncs PyTorch reports inside the scope
    (``torch.cuda.set_sync_debug_mode``): ``box["n"]``, and
    ``box["where"]`` the Python lines they came from, most first."""
    import collections
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield box
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    box["n"] = len(syncs)
    box["where"] = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        for w in syncs).most_common(6)


def _qwen(layers, dtype="bfloat16", seed=0):
    from repro_torch.configs import get_config
    from repro_torch.launch import prune as launch_prune
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=layers,
                              dtype=dtype)
    model = LM(cfg, device="cuda")
    return cfg, model, launch_prune.load_params(model, None, seed=seed)


def prune_path():
    """The launcher's default path: the pipelined engine over the whole
    model, with the host syncs it makes counted."""
    import torch

    from repro_torch.core.engine import PruningEngine
    from repro_torch.core.pruner import LINEARS
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import is_24_sparse

    cfg, model, params = _qwen(PRUNE_LAYERS)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ev = [{"tokens": t, "labels": t} for t in torch.randint(
        0, cfg.vocab_size, (2, 4, 512), generator=gen, device="cuda")]
    dense_ppl = launch_prune.eval_ppl(model, params, ev)
    pipeline = launch_prune.build_parser().get_default("pipeline")
    if pipeline != "auto":
        fail(f"the launcher defaults to --pipeline {pipeline}")
    engine = PruningEngine(model, "2:4", method="MM", blocksize=128,
                           row_chunk=PRUNE_ROW_CHUNK, pipeline=pipeline)
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the prune path starts
    t0 = time.monotonic()
    with count_syncs(syncs), torch.no_grad():
        pruned, reports = engine.run(params, calib)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    ps = engine.last_pipeline_stats
    say(f"  pipelined: {PRUNE_LAYERS} layers in {wall:.2f} s "
        f"({wall / PRUNE_LAYERS:.3f} s a layer); HBM held "
        f"{hbm / 2**30:.3f} GiB; {ps.segments} segments, {ps.batches} "
        f"batches stacked into {ps.calib_shards} shard(s)")
    say(f"  host time by stage (not synchronised), s a layer: capture "
        f"{ps.capture_s / PRUNE_LAYERS:.3f}, solve "
        f"{ps.solve_s / PRUNE_LAYERS:.3f}, propagate "
        f"{ps.propagate_s / PRUNE_LAYERS:.3f}")
    say(f"  host syncs in the run: {syncs['n']} "
        f"({syncs['n'] / PRUNE_LAYERS:.1f} a layer); from {syncs['where']}")
    for r in reports:
        LOG.append(f"    {r.name:22s} {str(r.shape):14s} {r.seconds:7.3f} s "
                   f"recon {r.recon_error:.4e} sparsity {r.sparsity:.4f}")
    from repro_torch.kernels.flash_attn import flash_attn

    say(f"  flash_attn's last launch took the {flash_attn.last_kernel} "
        "kernel")
    say(f"  launch counters over the prune path: {counts}; a layer: "
        f"flash_attn {counts['flash_attn'] / PRUNE_LAYERS:g}, hessian_accum "
        f"{counts['hessian_accum'] / PRUNE_LAYERS:g}, nm_select "
        f"{counts['nm_select'] / PRUNE_LAYERS:g}")
    for name in PRUNE_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the prune path")
    if counts["hessian_accum"] != 7 * PRUNE_LAYERS:
        fail(f"{counts['hessian_accum']} hessian_accum launches, expected 7 "
             "a layer (one stacked capture per linear)")
    if counts["nm_select"] != 70 * PRUNE_LAYERS:
        fail(f"{counts['nm_select']} nm_select launches, expected 70 a layer "
             "(one a 128-column block: 6 linears x 8 + mlp.wo's 22)")
    # what packing needs: at most 2 nonzeros in each group of 4 of every
    # stored weight (a compensated kept weight may land on exactly 0.0,
    # so "w == 0" is not the mask); the mask itself is the engine's, whose
    # reported sparsity must be 2:4's
    packable = {f"period{i}.s0.{sub}.{key}": is_24_sparse(lp[sub][key])
                for i, lp in enumerate(pruned["layers"])
                for sub, key in LINEARS}
    if len(packable) != 7 * PRUNE_LAYERS or len(reports) != 7 * PRUNE_LAYERS:
        fail(f"expected {7 * PRUNE_LAYERS} pruned linears")
    for name, ok in packable.items():
        if not ok:
            fail(f"{name}: more than 2 nonzeros in a group of 4 after MM "
                 "pruning")
    off = [r.name for r in reports if abs(r.sparsity - 0.5) > 1e-6]
    if off:
        fail(f"the engine reports a sparsity other than 0.5 for {off[:4]}")
    say(f"  all {len(packable)} pruned linears hold at most 2 nonzeros in "
        "every group of 4, and the engine reports sparsity 0.5 for each")
    pruned_ppl = launch_prune.eval_ppl(model, pruned, ev)
    say(f"  perplexity on 2 x 4 x 512 random tokens: dense {dense_ppl:.2f}, "
        f"MM 2:4 {pruned_ppl:.2f} (random weights: no gate)")
    if not (math.isfinite(dense_ppl) and math.isfinite(pruned_ppl)):
        fail("non-finite perplexity")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=32,
                                               dtype=np.int32),
                    max_new_tokens=16) for i in range(8)]
    eng = ServeEngine(model, pruned, max_batch=8, max_len=64, page_size=16,
                      prefill_chunk=32)
    if eng.n_sparse_leaves != 7 * PRUNE_LAYERS:
        fail(f"packed {eng.n_sparse_leaves} linears, expected "
             f"{7 * PRUNE_LAYERS}")
    say(f"  serving the pruned model: {arena_line(eng)}")
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    for r in res:
        if len(r.tokens) != 16 or r.tokens.min() < 0 or (
                r.tokens.max() >= cfg.vocab_size):
            fail(f"pruned model: request {r.uid} emitted a bad stream")
    say(f"  the pruned model, packed ({eng.n_sparse_leaves} linears), served "
        f"{len(res)} requests x 16 tokens through ServeEngine")
    return counts, dict(wall_s=wall, s_per_layer=wall / PRUNE_LAYERS,
                        hbm_gib=hbm / 2**30, syncs=syncs["n"],
                        host_stage_s=dict(capture=ps.capture_s,
                                          solve=ps.solve_s,
                                          propagate=ps.propagate_s))


def compare_layer(model, params, run_a, run_b, gaps, layer, tag,
                  gate=True):
    """Layer ``layer`` pruned by two runs: masks equal except in rows
    whose first difference is a near tie of run a (plain loss gap below
    LAYER_TIE_REL, from ``gaps``: run a's mask selections in call order;
    ``gaps=None`` counts the differing rows without the tie rule), and
    every linear's reconstruction error within LAYER_ERR_REL (left to the
    caller with ``gate=False``).  Returns the largest |Δw| / max|w0| on
    rows whose masks agree, the largest relative reconstruction-error
    difference and the share of mask entries that agree."""
    import torch

    (pa, ra), (pb, rb) = run_a, run_b
    ma, mb = _pruned_masks(model, pa), _pruned_masks(model, pb)
    names = [n for n in ma if n.startswith(f"period{layer}.")]
    call = 0
    worst_w = worst_err = worst_gap = 0.0
    n_rows = n_groups = n_same = n_all = 0
    for li, name in enumerate(names):
        rows_, cols = ma[name].shape
        nblk = cols // 128
        blk_gaps = gaps[call:call + nblk] if gaps is not None else None
        call += nblk
        n_same += int((ma[name] == mb[name]).sum())
        n_all += ma[name].numel()
        diff = (ma[name] != mb[name]).reshape(rows_, -1, 4).any(-1)
        bad_rows = torch.nonzero(diff.any(-1)).flatten().tolist()
        for r in bad_rows if gaps is not None else ():
            g0 = int(torch.nonzero(diff[r])[0])
            gap = blk_gaps[g0 // 32][r, g0 % 32].item()
            worst_gap = max(worst_gap, gap)
            if gap >= LAYER_TIE_REL:
                fail(f"{tag} {name}: row {r} first differs at group {g0} "
                     f"where the loss gap is {gap:.3e} >= {LAYER_TIE_REL:g}")
        n_rows += len(bad_rows)
        n_groups += int(diff.sum())
        sub, key = name.split(".")[-2:]
        w0 = params["layers"][layer][sub][key]
        wa, wb = pa["layers"][layer][sub][key], pb["layers"][layer][sub][key]
        agree = ~(ma[name] != mb[name]).any(-1)       # paper rows = out cols
        if agree.any():
            dw = ((wa.float() - wb.float())[:, agree].abs().max().item()
                  / w0.float().abs().max().item())
            worst_w = max(worst_w, dw)
        ea, eb = ra[layer * 7 + li].recon_error, rb[layer * 7 + li].recon_error
        worst_err = max(worst_err, abs(ea - eb) / ea)
    if gaps is not None and call > len(gaps):
        fail(f"{tag}: {len(gaps)} mask selections recorded, expected "
             f">= {call}")
    ties = (f", each row's first difference a near tie (largest gap there "
            f"{worst_gap:.3e} < {LAYER_TIE_REL:g})" if gaps is not None
            else " (no tie rule)")
    say(f"  {tag}: masks: {n_groups} groups differ in {n_rows} rows{ties}; "
        f"{n_same / n_all:.6f} of mask entries agree; "
        f"reconstruction error: max relative difference {worst_err:.3e} "
        f"(tol {LAYER_ERR_REL:g}); agreeing rows' weights: max |Δw| / "
        f"max|w0| {worst_w:.3e}")
    if gate and worst_err > LAYER_ERR_REL:
        fail(f"{tag}: reconstruction errors differ by {worst_err:.3e}")
    return worst_w, worst_err, n_same / n_all


def where_engines_part(model, params, calib):
    """Where the bf16 engines part on layer 0: its captures from one
    stacked apply (the pipelined engine's M = 128 x 2048 tokens) against
    per-batch applies (the serial engine's M = 8 x 2048), and the
    Hessians each engine accumulates from them (one update over every
    token, or a running mean over the batches).  Printed, not gated."""
    import torch

    from repro_torch.core.calibration import CalibrationSet

    seg = model.prunable_segments()[0]
    sp = seg.get_params(params)
    states = [model.calib_init(params, b) for b in calib]
    n = states[0].shape[0]
    _, stacked = seg.apply(sp, torch.cat(states), capture=True)
    piped = CalibrationSet.from_captures(stacked)
    serial = CalibrationSet()
    differ = dict.fromkeys(stacked, 0)
    for i, st in enumerate(states):
        _, caps = seg.apply(sp, st, capture=True)
        for name, x in caps.items():
            differ[name] += int((x != stacked[name][i * n:(i + 1) * n]).sum())
        serial.update(caps)
        del caps
    say("  layer 0 captures, per-batch vs stacked apply, elements that "
        "differ: " + ", ".join(f"{k} {d}" for k, d in differ.items()))
    rel = {k: ((serial.hessian(k) - piped.hessian(k)).abs().max()
               / piped.hessian(k).abs().max()).item() for k in piped.names()}
    say("  layer 0 Hessians, serial running mean vs stacked update, max "
        "|dH| / max|H|: " + ", ".join(f"{k} {r:.3e}" for k, r in rel.items()))
    del stacked, states, piped, serial
    torch.cuda.empty_cache()


def serial_vs_pipelined(hess_rows):
    """The serial and the pipelined engine over the same calibration.
    f32, 2 layers: layer 0 (identical inputs) under the tie rule and
    LAYER_ERR_REL, as phase 6; layer 1 (inputs an f32 rounding apart)
    MASK_AGREE_MIN of mask entries equal and within LAYER_ERR_REL.  bf16,
    PRUNE_CMP_LAYERS layers, the serial engine with its StageClock
    breakdown: layer 0 MASK_AGREE_MIN equal and within LAYER_ERR_REL; the
    two engines' Hessians differ by the order of their f32 sums
    (``where_engines_part`` prints it), the pruned weights then round to
    different bf16 values, and deeper layers' masks drift apart at near
    ties, so past layer 0 the quality is held: the total reconstruction error
    within PIPE_TOTAL_ERR_REL (the reference's pipelined contract) and
    per-linear sparsity equal.  Then resume — a pipelined run whose
    store raises after segment 2, rerun, must end bit-identical to the
    uninterrupted one.  ``hess_rows``: phase 1's stacked hessian_accum
    rows (m = 1024, 2816), the share of the capture stage they explain."""
    import tempfile

    import torch

    from repro_torch.ckpt import PruneProgressStore
    from repro_torch.core.clock import StageClock
    from repro_torch.core.engine import PruningEngine
    from repro_torch.core.pipeline import run_pipelined
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    kw = dict(blocksize=128, row_chunk=PRUNE_ROW_CHUNK)
    # f32, layer 0: the tie rule
    cfg, model, params = _qwen(2, dtype="float32")
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    gaps = []
    with record_plain_gaps(gaps):
        serial = launch_prune.prune(model, params, calib, "2:4", "MM",
                                    pipeline="off", **kw)
    piped = launch_prune.prune(model, params, calib, "2:4", "MM", **kw)
    compare_layer(model, params, serial, piped, gaps, 0,
                  "serial vs pipelined, f32, layer 0")
    # layer 1: inputs that differ by f32 roundings, the pipelined contract
    _, _, agree = compare_layer(model, params, serial, piped, None, 1,
                                "serial vs pipelined, f32, layer 1")
    if agree < MASK_AGREE_MIN:
        fail(f"serial vs pipelined, f32, layer 1: {agree:.6f} of mask "
             f"entries agree (min {MASK_AGREE_MIN})")
    del model, params, serial, piped, gaps
    torch.cuda.empty_cache()

    layers = PRUNE_CMP_LAYERS
    cfg, model, params = _qwen(layers)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    with torch.no_grad():
        where_engines_part(model, params, calib)
    clock = StageClock("cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    serial = launch_prune.prune(model, params, calib, "2:4", "MM",
                                clock=clock, pipeline="off", **kw)
    torch.cuda.synchronize()
    t_serial = time.monotonic() - t0
    n_hess = ops.launch_counts()["hessian_accum"]
    stages = {k: v / layers for k, v in clock.seconds.items()}
    say(f"  serial, bf16: {layers} layers in {t_serial:.2f} s "
        f"({t_serial / layers:.3f} s a layer); seconds per layer by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(stages.items(), key=lambda kv: -kv[1]))
        + f"; hessian_accum launches a layer {n_hess / layers:g}")
    if n_hess != 7 * len(calib) * layers:
        fail(f"serial: {n_hess} hessian_accum launches, expected "
             f"{7 * len(calib)} a layer (7 linears x {len(calib)} batches)")
    # instrumented: each stage synchronises at its end, so its seconds
    # are its device cost (the results are the same bits)
    engine = PruningEngine(model, "2:4", method="MM", **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        piped = run_pipelined(engine, params, calib, instrument=True)
    torch.cuda.synchronize()
    t_piped = time.monotonic() - t0
    ps = engine.last_pipeline_stats
    piped_stages = {k: getattr(ps, f"{k}_s") / layers
                    for k in ("capture", "solve", "propagate")}
    say(f"  pipelined, bf16, instrumented: {layers} layers in {t_piped:.2f} s"
        f" ({t_piped / layers:.3f} s a layer); seconds per layer by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in piped_stages.items()))
    hess_ms = 6 * hess_rows[0]["ms"] + hess_rows[1]["ms"]
    say(f"  capture stage {piped_stages['capture']:.3f} s a layer, of which "
        f"its 7 stacked hessian_accum launches (6 at m = 1024, 1 at m = "
        f"2816) take {hess_ms / 1e3:.4f} s at phase 1's device times")
    # layer 0 (identical inputs): every linear's error within
    # LAYER_ERR_REL and the masks MASK_AGREE_MIN equal; past it each
    # layer's inputs differ by the bf16 rounding of the layer before, the
    # masks drift apart at near ties, and the quality is held: the total
    # reconstruction error (the reference's pipelined contract) and the
    # sparsity
    bf16 = [compare_layer(model, params, serial, piped, None, layer,
                          f"serial vs pipelined, bf16, layer {layer}",
                          gate=layer == 0) for layer in range(layers)]
    tot_s, tot_p = (sum(r.recon_error for r in run[1])
                    for run in (serial, piped))
    tot_rel = abs(tot_p - tot_s) / tot_s
    same_sparsity = all(a.sparsity == b.sparsity
                        for a, b in zip(serial[1], piped[1]))
    say(f"  serial vs pipelined, bf16, {layers} layers: total reconstruction "
        f"error {tot_s:.6e} vs {tot_p:.6e}, relative {tot_rel:.3e} (tol "
        f"{PIPE_TOTAL_ERR_REL:g}); per-linear sparsity equal: "
        f"{same_sparsity}")
    if (bf16[0][2] < MASK_AGREE_MIN or tot_rel > PIPE_TOTAL_ERR_REL
            or not same_sparsity):
        fail("serial vs pipelined, bf16: outside the pipelined contract")

    class Bomb(PruneProgressStore):
        def save(self, next_segment, flat):
            super().save(next_segment, flat)
            if next_segment == 2:
                raise RuntimeError("simulated node failure")

    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as out:
        try:
            launch_prune.prune(model, params, calib, "2:4", "MM",
                               progress_store=Bomb(out), **kw)
            fail("resume: the store did not interrupt the run")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        seg, _ = PruneProgressStore(out).load()
        t0 = time.monotonic()
        resumed, reports = launch_prune.prune(
            model, params, calib, "2:4", "MM",
            progress_store=PruneProgressStore(out), **kw)
        torch.cuda.synchronize()
        t_res = time.monotonic() - t0
    a, b = model.params_to_flat(piped[0]), model.params_to_flat(resumed)
    same = all(np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
               for k in a)
    say(f"  resume: interrupted after segment {seg}, rerun pruned "
        f"{len(reports) // 7} segments in {t_res:.2f} s; final params "
        f"bit-identical to the uninterrupted run: {same}")
    if seg != 2 or len(reports) != 7 * (layers - 2) or not same:
        fail("resume: the resumed run differs from the uninterrupted one")
    return dict(serial_s_per_layer=t_serial / layers,
                pipelined_s_per_layer=t_piped / layers,
                serial_stages_s_per_layer=stages,
                pipelined_stages_s_per_layer=piped_stages)


# ----------------------------------------------------------------------
# phase 6: one f32 layer, kernels against the plain override
# ----------------------------------------------------------------------
@contextlib.contextmanager
def record_plain_gaps(gaps):
    """Within the scope, every 2:4 mask the plain path selects also
    records its groups' near-tie gaps (in call order)."""
    from repro_torch.kernels import ops

    select = ops.nm_select_mask

    def recording(w, hinv):
        gaps.append(_near_tie_gap(w, hinv))
        return select(w, hinv)

    ops.nm_select_mask = recording
    try:
        yield
    finally:
        ops.nm_select_mask = select


def prune_layer_f32():
    """One f32 layer pruned by the launcher's default (pipelined) engine
    with the kernels and under the plain override; the plain run must
    launch no kernel."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    cfg, model, params = _qwen(1, dtype="float32", seed=1)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 16, 2048,
                                        "cuda", seed=1)
    kw = dict(blocksize=128, row_chunk=PRUNE_ROW_CHUNK)
    ops.reset_launch_counts()
    kernels = launch_prune.prune(model, params, calib, "2:4", "MM", **kw)
    torch.cuda.synchronize()
    k_counts = ops.launch_counts()
    gaps = []
    ops.reset_launch_counts()
    with ops.override_dispatch(plain=True), record_plain_gaps(gaps):
        plain = launch_prune.prune(model, params, calib, "2:4", "MM", **kw)
    torch.cuda.synchronize()
    p_counts = ops.launch_counts()
    say(f"  launches with the kernels: {k_counts}; under the plain "
        f"override: {p_counts}")
    if any(p_counts[k] for k in PRUNE_KERNELS) or not all(
            k_counts[k] for k in PRUNE_KERNELS):
        fail("phase 6: the plain override launched a kernel, or the "
             "kernel run missed one")
    n_sel = (6 * cfg.d_model + cfg.d_ff) // 128    # 128-column blocks
    if len(gaps) != n_sel:
        fail(f"phase 6: {len(gaps)} plain mask selections, expected {n_sel}")
    worst_w, _, _ = compare_layer(model, params, plain, kernels, gaps, 0,
                                  "kernels vs plain")
    if worst_w > LAYER_W_TOL:
        fail(f"phase 6: weights differ by {worst_w:.3e} on agreeing rows "
             f"(tol {LAYER_W_TOL:g})")


# ----------------------------------------------------------------------
# phase 11: the serving front end on the card
# ----------------------------------------------------------------------
FRONT_KNOBS = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32,
                   steps_per_sync=8)          # phase 3's engine
FRONT_CLI = ["--arch", "qwen1.5-0.5b", "--magnitude-24", "--sparse"]
FRONT_N = 16                                   # requests a wave


async def _http(host, port, method, path, obj=None, hang_up=False):
    """One HTTP/1.1 exchange with the in-process server: (status, head,
    body).  ``hang_up``: close the connection after the first SSE frame
    (a client that leaves mid-stream)."""
    import asyncio

    body = json.dumps(obj).encode() if obj is not None else b""
    r, w = await asyncio.open_connection(host, port)
    w.write(f"{method} {path} HTTP/1.1\r\nHost: chip\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await w.drain()
    if hang_up:
        head = await r.readuntil(b"\r\n\r\n")
        await r.readuntil(b"\n\n")
        w.close()
        return int(head.split()[1]), head, b""
    data = await r.read()
    w.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), head, rest


def _serve_http(router, scenario):
    """``scenario(host, port)`` against a Server over ``router`` on
    127.0.0.1, port 0; the listener closes after it."""
    import asyncio

    from repro_torch.serve.frontend import Server

    async def run():
        srv = Server(router, port=0)
        host, port = await srv.start()
        try:
            return await scenario(host, port)
        finally:
            srv._server.close()
            await srv._server.wait_closed()

    return asyncio.run(run())


def _totals(router, name):
    """{replica label: value} of one counter family over the router's
    registry."""
    out = {}
    for reg in router.registries():
        fam = reg.get(name)
        for labels, child in (fam.children() if fam is not None else []):
            out[labels[0]] = out.get(labels[0], 0) + child.value
    return out


def _idle_wait(router, what):
    deadline = time.monotonic() + 60
    while any(r.load for r in router.replicas):
        if time.monotonic() > deadline:
            fail(f"phase 11 {what}: requests still in flight "
                 f"{[r.load for r in router.replicas]}")
        time.sleep(0.01)


def _pool_checks(router, what):
    """The pools' invariants and the arenas' free slots, each under its
    replica's lock (no worker steps meanwhile)."""
    for rep in router.replicas:
        with rep._lock:
            pool = rep.engine.pool
            pool.check_invariants()
            if pool.arena is not None and (pool.arena.free_slots
                                           != pool.arena.capacity):
                fail(f"phase 11 {what}: {rep.name} leaked arena slots: "
                     f"{pool.arena.free_slots} of {pool.arena.capacity}")


def frontend_on_card(smi, cli=FRONT_CLI):
    """Phase 11: Qwen1.5-0.5B (full width and depth, bf16, magnitude 2:4,
    packed) behind the front end — two replicas on one Obs, the HTTP/SSE
    Server on 127.0.0.1 and the Supervisor:
      11a. 16 SSE clients (64-token prompts, 32 new, greedy): each stream
           in more than one frame, equal to its non-stream JSON and to one
           engine's ``generate``; 4 prompts repeated one after another must
           reuse prefix pages; /healthz, 404, /metrics (both replicas'
           TTFT counts, host syncs and tokens > 0; the preemption series),
           /stats with ``_summary``; aggregate tok/s and idle share of one
           replica, then two, under the profiler, 16 fresh prompts each;
           the trace's request spans;
      11b. chaos: engine_step:after=2,replica=r0 and one client hanging up
           mid-stream — the other 15 streams equal 11a's, r0 restarted,
           requests failed over and cancelled, recovery observed, the
           pools' invariants and no arena slot leaked;
      11c. the 16 sampled (temperature 0.8, top-p 0.9) through two
           replicas equal to one engine's ``generate``;
      11d. ``python -m repro_torch.launch.serve --server --port 0
           --replicas 2``, started before 11c and up beside it, answers a
           streamed completion and exits 0 on SIGTERM after "draining...".
    Returns the serving kernels' launches over 11a-11c and the numbers."""
    import asyncio

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_router
    from repro_torch.models.transformer import LM
    from repro_torch.obs.metrics import merge_histograms
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.frontend import (CompletionRequest, Router,
                                            Supervisor, sse_decode)

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=QWEN_SERVE_LAYERS)
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    one = ServeEngine(model, prune_linears(model.init(gen), "2:4"),
                      **FRONT_KNOBS)
    params = one.params                        # packed once, shared
    rng = np.random.default_rng(11)

    def wave(uid0=0, n=FRONT_N):
        return [Request(uid=uid0 + i, prompt=rng.integers(
            0, cfg.vocab_size, 64, dtype=np.int32), max_new_tokens=32)
            for i in range(n)]

    def body(r, **kw):
        return dict(dict(prompt=[int(t) for t in r.prompt],
                         max_tokens=r.max_new_tokens, uid=r.uid), **kw)

    def creqs(reqs):
        return [CompletionRequest(**body(r)) for r in reqs]

    a = wave()
    want = {r.uid: r.tokens.tolist() for r in one.generate(a)}
    out = {}
    totals = {k: 0 for k in SERVE_KERNELS}

    def count(c):
        for k in SERVE_KERNELS:
            totals[k] += c[k]

    # ---------------------------------------------------------- 11a
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    router = make_router(model, params, ServeConfig(replicas=2, trace=True,
                                                    **FRONT_KNOBS))
    for rep in router.replicas:
        say(f"  {rep.name}: {arena_line(rep.engine)} ({smi})")
    ops.reset_launch_counts()
    lat = {}

    async def scenario_a(host, port):
        t0 = time.monotonic()
        sse = await asyncio.gather(*[_http(host, port, "POST",
                                           "/v1/completions",
                                           body(r, stream=True)) for r in a])
        lat["sse_wall_s"] = time.monotonic() - t0
        for key, name in (("ttft", "serve_ttft_seconds"),
                          ("tpot", "serve_tpot_seconds")):
            h = merge_histograms([reg.get(name)
                                  for reg in router.registries()])
            lat[key] = dict(count=h.count, p50_ms=h.quantile(0.5) * 1e3,
                            p99_ms=h.quantile(0.99) * 1e3)
        whole = await asyncio.gather(*[_http(host, port, "POST",
                                             "/v1/completions", body(r))
                                       for r in a])
        reused0 = sum(_totals(router,
                              "serve_prefix_pages_reused_total").values())
        seq = [await _http(host, port, "POST", "/v1/completions",
                           body(r, uid=100 + r.uid)) for r in a[:4]]
        reused = int(sum(_totals(router, "serve_prefix_pages_reused_total")
                         .values()) - reused0)
        gets = {p: await _http(host, port, "GET", p)
                for p in ("/healthz", "/nope", "/metrics", "/stats")}
        return sse, whole, seq, reused, gets

    sse, whole, seq, reused, gets = _serve_http(router, scenario_a)
    c = ops.launch_counts()
    count(c)
    hbm = torch.cuda.max_memory_allocated()
    frames = []
    for r, (status, _, rest) in zip(a, sse):
        chunks = sse_decode(rest)
        toks = [t for ch in chunks for t in ch.tokens]
        frames.append(len(chunks))
        if status != 200 or len(chunks) < 2 or not chunks[-1].finished:
            fail(f"phase 11a: request {r.uid}: status {status}, "
                 f"{len(chunks)} frames")
        if toks != want[r.uid]:
            fail(f"phase 11a: request {r.uid}'s stream differs from one "
                 f"engine's generate: {toks} vs {want[r.uid]}")
    for r, (status, _, rest) in zip(a, whole):
        if status != 200 or json.loads(rest)["tokens"] != want[r.uid]:
            fail(f"phase 11a: request {r.uid}'s JSON response differs from "
                 "its stream")
    for r, (status, _, rest) in zip(a, seq):
        if status != 200 or json.loads(rest)["tokens"] != want[r.uid]:
            fail(f"phase 11a: repeated prompt {r.uid} gave another stream")
    if reused <= 0:
        fail("phase 11a: the repeated prompts reused no prefix page")
    status, _, health = gets["/healthz"]
    if status != 200 or not all(v["healthy"] for v in
                                json.loads(health).values()):
        fail(f"phase 11a: /healthz answered {status} {health!r}")
    if gets["/nope"][0] != 404:
        fail(f"phase 11a: /nope answered {gets['/nope'][0]}")
    metrics = gets["/metrics"][2].decode()
    for name in ("serve_ttft_seconds_count", "serve_host_syncs_total",
                 "serve_tokens_total"):
        for lbl in ("r0", "r1"):
            m = re.search(rf'^{name}\{{replica="{lbl}"\}} (\S+)$', metrics,
                          re.M)
            if m is None or float(m.group(1)) <= 0:
                fail(f"phase 11a: /metrics has no {name} > 0 for {lbl}")
    for name in ("serve_preempt_swap_total", "serve_preempt_recompute_total"):
        if f"# TYPE {name} counter" not in metrics:
            fail(f"phase 11a: /metrics lacks {name}")
    stats = json.loads(gets["/stats"][2])
    if "_summary" not in stats or "ttft_ms_p50" not in stats["_summary"]:
        fail("phase 11a: /stats has no _summary")
    if c["nm_spmm_decode"] <= 0 or c["paged_attn"] <= 0:
        fail(f"phase 11a: launches {c}")
    toks = sum(len(v) for v in want.values())
    say(f"  11a: {FRONT_N} SSE streams ({min(frames)}-{max(frames)} frames "
        f"each) equal to one engine's generate and to their JSON responses;"
        f" SSE wave {toks} tokens in {lat['sse_wall_s']:.3f} s = "
        f"{toks / lat['sse_wall_s']:.1f} tok/s over HTTP; TTFT p50 "
        f"{lat['ttft']['p50_ms']:.1f} ms p99 {lat['ttft']['p99_ms']:.1f} ms, "
        f"TPOT p50 {lat['tpot']['p50_ms']:.2f} ms (n={lat['ttft']['count']},"
        f" histograms); 4 repeated prompts reused {reused} prefix pages; "
        f"launches {c}; HBM held with two replicas {hbm / 2**30:.3f} GiB "
        f"({smi})")
    # one replica against two, 16 fresh prompts each, once each and both
    # under the profiler (a wave of 8 would fit one replica's batch, and a
    # second replica could not win); the two-replica leg's idle share is
    # the one this phase reports
    one_router = Router([router.replicas[0]])
    rates, prof = {}, {}
    for n, r_ in ((1, one_router), (2, router)):
        reqs = wave(1000 * n)
        ops.reset_launch_counts()
        res, p_wall, busy, n_k = profiled(
            lambda: r_.complete(creqs(reqs)))
        count(ops.launch_counts())
        n_tok = sum(len(x.tokens) for x in res)
        if n_tok != FRONT_N * 32:
            fail(f"phase 11a: {n} replica(s) emitted {n_tok} tokens")
        rates[n] = n_tok / p_wall
        prof[n] = dict(wall_s=p_wall, busy_s=busy, kernels=n_k)
        say(f"  {n} replica(s), Router.complete of {FRONT_N} requests under "
            f"the profiler: {rates[n]:.3f} tok/s, wall {p_wall:.3f} s, "
            f"device busy {busy:.3f} s, idle share {1 - busy / p_wall:.3f}, "
            f"{n_k} kernels ({smi})")
    ratio = rates[2] / rates[1]
    say(f"  aggregate tok/s, two replicas / one = {ratio:.3f} ({smi})")
    router.drain(timeout=60)
    n_req = FRONT_N * 2 + 4 + 2 * FRONT_N
    tracer = router.replicas[0].engine.obs.tracer
    spans = len(tracer.events("request", ph="b"))
    ends = len(tracer.events("request", ph="e"))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    n_ev = tracer.export(str(ROOT / "chiprun_out" / "phase11_trace.json"))
    if spans != n_req or ends != n_req:
        fail(f"phase 11a: {spans} request spans opened and {ends} closed "
             f"for {n_req} requests")
    say(f"  trace: {spans} request spans for {n_req} requests, {n_ev} events"
        f" (chiprun_out/phase11_trace.json; {smi})")
    router.close()
    out["11a"] = dict(frames=frames, sse_wall_s=lat["sse_wall_s"],
                      ttft=lat["ttft"], tpot=lat["tpot"], reused=reused,
                      launches=c, hbm_bytes=hbm, tok_s=rates, ratio=ratio,
                      profiled=prof,
                      arena_bytes=[r.engine.pool.arena.nbytes
                                   for r in router.replicas],
                      arena_alloc_s=[r.engine.pool.arena.alloc_s
                                     for r in router.replicas])
    del router, one_router
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 11b
    plan = FaultPlan.parse(["engine_step:after=2,replica=r0"])
    chaos = make_router(model, params, ServeConfig(replicas=2, faults=plan,
                                                   **FRONT_KNOBS))
    sup = Supervisor(chaos, poll_s=0.05)
    sup.start()
    gone = a[-1].uid

    async def scenario_b(host, port):
        return await asyncio.gather(*[
            _http(host, port, "POST", "/v1/completions",
                  body(r, stream=True), hang_up=r.uid == gone) for r in a])

    try:
        ops.reset_launch_counts()
        outs = _serve_http(chaos, scenario_b)
        _idle_wait(chaos, "b")
        count(ops.launch_counts())
    finally:
        sup.stop()
    for r, (status, _, rest) in zip(a, outs):
        if r.uid == gone:
            continue
        toks = [t for ch in sse_decode(rest) for t in ch.tokens]
        if status != 200 or toks != want[r.uid]:
            fail(f"phase 11b: request {r.uid}'s stream differs from 11a's "
                 f"under the injected crash: {toks}")
    restarts = _totals(chaos, "replica_restarts_total")
    failed_over = sum(_totals(chaos, "requests_failed_over_total").values())
    cancelled = sum(_totals(chaos, "requests_cancelled_total").values())
    rec = merge_histograms([reg.get("serve_recovery_seconds")
                            for reg in chaos.registries()])
    if (plan.fired.get("engine_step") != 1 or restarts.get("r0", 0) < 1
            or failed_over < 1 or cancelled < 1 or rec.count < 1):
        fail(f"phase 11b: fired {plan.fired}, restarts {restarts}, failed "
             f"over {failed_over}, cancelled {cancelled}, recoveries "
             f"{rec.count}")
    _pool_checks(chaos, "b")
    say(f"  11b: engine_step fired on r0, restarts {restarts}, failed over "
        f"{failed_over:.0f}, cancelled {cancelled:.0f}; recovery "
        f"{rec.sum:.4f} s over {rec.count} (serve_recovery_seconds); "
        f"{FRONT_N - 1} surviving streams equal 11a's; pools sound, no "
        f"arena slot leaked ({smi})")
    out["11b"] = dict(restarts=restarts, failed_over=failed_over,
                      cancelled=cancelled, recovery_s=rec.sum,
                      recoveries=rec.count)
    chaos.close()
    del chaos
    torch.cuda.empty_cache()

    # 11d's server process comes up while 11c runs (11c times nothing)
    cli_proc, cli_lines, cli_ready, cli_up = _start_cli_server(cli)
    try:
        _sampled_parity(model, params, a, want, creqs, count, smi)
        _cli_server(cli_proc, cli_lines, cli_ready, cli_up, smi)
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
    del one
    torch.cuda.empty_cache()
    out["11d"] = dict(cli_up)
    return totals, out


def _sampled_parity(model, params, a, want, creqs, count, smi):
    """11c: the 16 at temperature 0.8, top-p 0.9 through two replicas
    equal one engine's ``generate``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_router
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    sampled = dict(FRONT_KNOBS, temperature=0.8, top_p=0.9)
    ops.reset_launch_counts()
    s_one = ServeEngine(model, params, **sampled)
    s_want = {r.uid: r.tokens.tolist() for r in s_one.generate(a)}
    s_router = make_router(model, params, ServeConfig(replicas=2,
                                                      **sampled))
    got = s_router.complete(creqs(a))
    s_router.drain(timeout=60)
    count(ops.launch_counts())
    placed = sorted({x.replica for x in got})
    for x in got:
        if x.tokens != s_want[x.uid]:
            fail(f"phase 11c: sampled request {x.uid} differs between two "
                 "replicas and one engine's generate")
    if s_want == want or placed != ["r0", "r1"]:
        fail(f"phase 11c: sampled streams equal the greedy ones, or one "
             f"replica served all ({placed})")
    say(f"  11c: {FRONT_N} sampled streams (temperature 0.8, top-p 0.9) "
        f"through r0 and r1 equal one engine's generate ({smi})")
    s_router.close()
    del s_router, s_one
    torch.cuda.empty_cache()


def _start_cli_server(cli):
    """Start ``python -m repro_torch.launch.serve ... --server --port 0
    --replicas 2``; a thread reads its output and notes when it says
    where it serves."""
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *cli,
         "--server", "--port", "0", "--replicas", "2"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ready, up = [], threading.Event(), {}

    def pump():
        for line in proc.stdout:
            lines.append(line)
            m = re.match(r"serving on http://([\d.]+):(\d+)", line)
            if m and not ready.is_set():
                up.update(host=m.group(1), port=int(m.group(2)),
                          up_s=time.monotonic() - t0)
                ready.set()
        ready.set()                              # the process ended

    up["thread"] = threading.Thread(target=pump, daemon=True)
    up["thread"].start()
    return proc, lines, ready, up


def _cli_server(proc, lines, ready, up, smi):
    """11d: the CLI's server answers one streamed completion and exits 0
    on SIGTERM after "draining..."."""
    import asyncio

    from repro_torch.serve.frontend import sse_decode

    ready.wait(timeout=300)
    if "port" not in up:
        fail(f"phase 11d: the server did not come up (exit {proc.poll()}): "
             f"{''.join(lines)}")
    status, _, rest = asyncio.run(_http(
        up["host"], up["port"], "POST", "/v1/completions",
        {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_tokens": 12,
         "stream": True}))
    chunks = sse_decode(rest)
    n_tok = sum(len(ch.tokens) for ch in chunks)
    if status != 200 or not chunks or not chunks[-1].finished or n_tok != 12:
        fail(f"phase 11d: the CLI server answered {status}, {n_tok} tokens")
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=120)
    up.pop("thread").join(timeout=10)
    text = "".join(lines)
    if proc.returncode != 0 or "draining..." not in text:
        fail(f"phase 11d: SIGTERM gave exit {proc.returncode}: {text!r}")
    up["frames"] = len(chunks)
    say(f"  11d: the CLI server came up in {up['up_s']:.1f} s (beside 11c), "
        f"streamed {n_tok} tokens in {len(chunks)} frames, and drained on "
        f"SIGTERM (exit 0; {smi})")


# ----------------------------------------------------------------------
# phase 12: the dense decoders' attention variants at full width
# ----------------------------------------------------------------------
def _dense(arch, layers=None):
    """``arch``'s published config, cut to ``layers`` where given, and its
    model on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg, LM(cfg, device="cuda")


def dense_e2e():
    """12a: each model at full width, f32, 2 layers (Gemma3-12B: its
    whole period of 6, request 0's prompt 1100 tokens past the window of
    1024), served with the kernels and with the plain override."""
    import torch

    out = {}
    for arch in DENSE_ARCHS:
        gemma3 = arch == "gemma3_12b"
        say(f"  {arch}: f32, {6 if gemma3 else 2} layers")
        out[arch] = e2e_f32(arch, 6 if gemma3 else 2,
                            long_prompt=1100 if gemma3 else 0,
                            tag=f"phase 12a {arch}")
        torch.cuda.empty_cache()
    return out


def dense_serve(arch, gen_seed=0):
    """12b: ``arch`` at full width and depth, bf16, random init from a
    seeded torch.Generator, magnitude 2:4 on every linear, packed by the
    engine.  Phase 3's 8 greedy requests continuous (page 16, chunk 32;
    the reference's serve defaults), the same with int8 pages, and as one
    static bucket; for Gemma3-12B one 2048-token prompt at chunk 256,
    served again by a copy of the model without the window (the streams
    must part).  Every serving kernel launched, the pools' invariants,
    static equal to continuous up to near ties; tok/s, HBM held and the
    idle share of one profiled generate."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = _dense(arch, DENSE_SERVE_LAYERS.get(arch))
    t0 = time.monotonic()
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed)
    params = prune_linears(model.init(g), "2:4")
    kw = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
    eng = ServeEngine(model, params, **kw)
    del params                                      # the engine packed them
    params = eng.params
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    say(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"hd {cfg.hd}; init + magnitude 2:4 + packing in "
        f"{time.monotonic() - t0:.1f} s; params {n_bytes / 2**30:.3f} GiB "
        f"packed; HBM peak so far {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if eng.n_sparse_leaves != 7 * cfg.num_layers:
        fail(f"phase 12b {arch}: packed {eng.n_sparse_leaves} linears, "
             f"expected {7 * cfg.num_layers}")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    int8 = ServeEngine(model, params, **kw, kv_dtype="int8")
    static = ServeEngine(model, params, max_batch=8, max_len=128,
                         mode="static")
    runs = [("8 requests, continuous", eng, reqs),
            ("8 requests, int8 pages", int8, reqs),
            ("8 requests, static", static, reqs)]
    long_req = None
    if cfg.window is not None:
        # one token repeated over the first 1024 positions, random ids
        # after them: the window leaves the repeated block out of the
        # local layers' attention, which a random init (whose residual
        # the embedding dominates) shows only where the block's values
        # add up coherently
        long_req = [Request(uid=100, prompt=np.concatenate(
            [np.full(1024, 7, np.int32), rng.integers(
                0, cfg.vocab_size, size=1024, dtype=np.int32)]),
            max_new_tokens=32)]
        long_kw = dict(max_batch=1, max_len=2080, page_size=16,
                       prefill_chunk=256)
        runs.append(("2048-token prompt, chunk 256",
                     ServeEngine(model, params, **long_kw), long_req))
    say(f"  engine: {arena_line(eng)}")
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the path starts
    streams = {}
    for label, e, rq in runs:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = e.generate(rq)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        _check_streams(f"phase 12b {arch} {label}", rq, res, cfg.vocab_size)
        toks = sum(len(r.tokens) for r in res)
        st = dict(e.stats)
        say(f"  {label}: {toks} tokens in {dt:.3f} s = {toks / dt:.2f} "
            f"tok/s; host syncs/token {st['host_syncs'] / toks:.3f}; "
            f"prefill chunks {st['prefill_chunks']}")
        out[label] = dict(tok_s=toks / dt, wall_s=dt, stats=st)
        streams[label] = _streams(res)
        if e.pool is not None:
            e.pool.check_invariants()
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  launches over the serving runs {counts}; HBM held "
        f"{hbm / 2**30:.3f} GiB")
    for k in (*SERVE_KERNELS, "flash_attn"):
        if counts[k] <= 0:
            fail(f"phase 12b {arch}: kernel {k} was not launched")
    parted = _first_divergence(model, params, reqs,
                               streams["8 requests, static"],
                               streams["8 requests, continuous"], STATIC_TIE,
                               f"phase 12b {arch} static vs continuous",
                               ulps=STATIC_TIE_ULPS)
    say(f"  static vs continuous: {len(reqs) - parted}/{len(reqs)} streams "
        "equal (the rest part at near ties)")
    out.update(parted=parted, hbm_gib=hbm / 2**30, launches=counts,
               params_gib=n_bytes / 2**30)
    if long_req is not None:
        # the window's proof: the same prompt served again, by a copy of
        # the model without the window (the same params), each step's
        # logits recorded on both sides.  The streams may still agree: a
        # random init's tied head follows the last token's own embedding
        glob = LM(dataclasses.replace(cfg, window=None), device="cuda")
        recs = [Recorder(model), Recorder(glob)]
        band, full = (_streams(ServeEngine(rec, params, **long_kw).generate(
            long_req))[100] for rec in recs)
        if recs[0].steps != recs[1].steps:
            fail(f"phase 12b {arch}: the runs with and without the window "
                 "made different steps")
        pre = [i for i, k in enumerate(recs[0].steps) if k == "prefill"]
        shift_all = [(a - b).abs().max().item()
                     for a, b in zip(recs[0].calls, recs[1].calls)]
        # the chunks, then the decode steps after the last one (the
        # idle-slot decode steps between chunks compute nothing served)
        shift = ([shift_all[i] for i in pre]
                 + shift_all[pre[-1] + 1:])
        n_pre = len(pre)
        if n_pre != long_req[0].prompt.size // long_kw["prefill_chunk"]:
            fail(f"phase 12b {arch}: {n_pre} prefill chunks recorded")
        if not np.array_equal(band, streams["2048-token prompt, chunk 256"][
                100]):
            fail(f"phase 12b {arch}: the recorded run's stream differs "
                 "from the timed run's")
        diff = np.nonzero(full != band)[0]
        say(f"  without the window (window=None, the same params): the "
            f"logits of prefill chunks 0-3 move by {max(shift[:4]):.3e} "
            f"(positions < 1024: the band is whole), of the last chunk by "
            f"{shift[n_pre - 1]:.3e}, of the {len(shift) - n_pre} decode "
            f"steps by {min(shift[n_pre:]):.3e} to "
            f"{max(shift[n_pre:]):.3e}; the stream "
            + (f"parts at token {int(diff[0])} ({len(diff)}/32 tokens "
               "differ)" if len(diff) else "is the same (the tied head's "
               "argmax)"))
        if max(shift[:4]) != 0.0:
            fail(f"phase 12b {arch}: the window moved the logits of a "
                 "chunk that lies inside every band")
        if min(shift[n_pre - 1], max(shift[n_pre:])) < STATIC_TIE:
            fail(f"phase 12b {arch}: without the window the first token's "
                 f"logits or the decode steps' moved by less than "
                 f"{STATIC_TIE}")
        out["window"] = dict(shift_first_chunks=max(shift[:4]),
                             shift_last_chunk=shift[n_pre - 1],
                             shift_decode_max=max(shift[n_pre:]),
                             shift_decode_min=min(shift[n_pre:]),
                             stream_parts_at=(int(diff[0]) if len(diff)
                                              else None))
        del glob, recs
    say("  the profiled run: the 8 requests, continuous")
    out["profile"] = profile_main(eng, reqs)
    del runs, eng, int8, static, params, model
    torch.cuda.empty_cache()
    return counts, out


def dense_prune(arch):
    """12c: ``launch.prune.prune`` with the launcher's default engine
    (pipelined), MS 2:4 at blocksize 128 (the paper's 𝔐 mask over whole
    matrices with the 𝔖 compensation) on ``arch`` at full width and
    DENSE_PRUNE_LAYERS deep, 128 x 2048 random calibration tokens in
    DENSE_CALIB_SHARDS shards (default 1); launches a layer (hessian_accum
    7 and flash_attn 2 a shard, nm_select 7), host
    syncs, perplexity before and after, every pruned linear 2:4; then the
    pruned model served packed."""
    import torch

    from repro_torch.core.pruner import LINEARS
    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import is_24_sparse

    layers = DENSE_PRUNE_LAYERS[arch]
    shards = DENSE_CALIB_SHARDS.get(arch, 1)
    cfg, model = _dense(arch, layers)
    params = launch_prune.load_params(model, None, seed=0)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ev = [{"tokens": t, "labels": t} for t in torch.randint(
        0, cfg.vocab_size, (2, 4, 512), generator=gen, device="cuda")]
    dense_ppl = launch_prune.eval_ppl(model, params, ev)
    pipeline = launch_prune.build_parser().get_default("pipeline")
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the prune path starts
    t0 = time.monotonic()
    with count_syncs(syncs):
        pruned, reports = launch_prune.prune(
            model, params, calib, "2:4", "MS", blocksize=128,
            row_chunk=PRUNE_ROW_CHUNK, pipeline=pipeline,
            calib_shard=shards)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  {cfg.name}, {layers} layers, MS 2:4 ({pipeline}, {shards} "
        f"calibration shard(s)): {wall:.2f} s "
        f"({wall / layers:.3f} s a layer); HBM held {hbm / 2**30:.3f} GiB; "
        f"host syncs {syncs['n']} from {syncs['where']}; launches {counts}")
    want = {"hessian_accum": 7 * layers * shards,
            "flash_attn": 2 * layers * shards, "nm_select": 7 * layers}
    for k, n in want.items():
        if counts[k] != n:
            fail(f"phase 12c {arch}: {counts[k]} {k} launches, expected "
                 f"{n} ({n // layers} a layer)")
    if syncs["n"] > 1:
        fail(f"phase 12c {arch}: {syncs['n']} host syncs in the pipelined "
             "run (expected the final readback only)")
    bad = [f"{i}.{sub}.{key}" for i, lp in enumerate(pruned["layers"])
           for sub, key in LINEARS if not is_24_sparse(lp[sub][key])]
    if bad or len(reports) != 7 * layers:
        fail(f"phase 12c {arch}: not 2:4 after MS: {bad[:4]}; "
             f"{len(reports)} reports")
    off = [r.name for r in reports if abs(r.sparsity - 0.5) > 1e-6]
    if off:
        fail(f"phase 12c {arch}: sparsity other than 0.5 for {off[:4]}")
    pruned_ppl = launch_prune.eval_ppl(model, pruned, ev)
    say(f"  perplexity on 2 x 4 x 512 random tokens: dense {dense_ppl:.2f}, "
        f"MS 2:4 {pruned_ppl:.2f} (random weights: no gate)")
    if not (math.isfinite(dense_ppl) and math.isfinite(pruned_ppl)):
        fail(f"phase 12c {arch}: non-finite perplexity")
    del params
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=32,
                                               dtype=np.int32),
                    max_new_tokens=16) for i in range(8)]
    eng = ServeEngine(model, pruned, max_batch=8, max_len=64, page_size=16,
                      prefill_chunk=32)
    if eng.n_sparse_leaves != 7 * layers:
        fail(f"phase 12c {arch}: packed {eng.n_sparse_leaves} linears")
    res = eng.generate(reqs)
    _check_streams(f"phase 12c {arch} pruned", reqs, res, cfg.vocab_size)
    say(f"  the pruned model, packed ({eng.n_sparse_leaves} linears), "
        f"served {len(res)} requests x 16 tokens")
    out = dict(layers=layers, shards=shards, wall_s=wall,
               s_per_layer=wall / layers,
               hbm_gib=hbm / 2**30, syncs=syncs["n"], launches=counts,
               dense_ppl=dense_ppl, pruned_ppl=pruned_ppl)
    del eng, pruned, model, calib
    torch.cuda.empty_cache()
    return counts, out


def dense_mrp_timed():
    """12d: the paper's MRP compensation (MM 2:4) on gemma-2b's layer 0 at
    full width, the serial engine with its StageClock, mlp.wo skipped
    (Eq. 13 there: m 16384, 128 blocks each re-solved against the whole
    mask, ≈ 1.2·10¹⁶ flops) and mlp.wg too (mlp.wi's shape: the same
    solve timed once).  Prints the seconds by stage and by linear."""
    import torch

    from repro_torch.core.clock import StageClock
    from repro_torch.launch import prune as launch_prune

    cfg, model = _dense("gemma_2b", 1)
    params = launch_prune.load_params(model, None, seed=0)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    clock = StageClock("cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, reports = launch_prune.prune(
        model, params, calib, "2:4", "MM", blocksize=128,
        row_chunk=PRUNE_ROW_CHUNK, clock=clock, pipeline="off",
        skip=("mlp.wg", "mlp.wo"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    names = [r.name for r in reports]
    if len(reports) != 5 or any(k in n for n in names
                                for k in ("mlp.wg", "mlp.wo")):
        fail(f"phase 12d: pruned {names}, expected the five linears but "
             "mlp.wg and mlp.wo")
    stages = dict(sorted(clock.seconds.items(), key=lambda kv: -kv[1]))
    say(f"  gemma-2b layer 0, MM 2:4, serial, mlp.wg and mlp.wo skipped: "
        f"{wall:.2f} s;"
        " by stage: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    say("  by linear: " + ", ".join(f"{r.name} {r.seconds:.2f} s"
                                    for r in reports))
    del model, params, calib
    torch.cuda.empty_cache()
    return dict(wall_s=wall, stages_s=stages,
                linears_s={r.name: r.seconds for r in reports})


def dense_variants(parts="abcd"):
    """Phase 12: 12a-12d (those of ``parts``); returns the launches of the
    serving and pruning runs and the phase's numbers."""
    import torch

    out = {}
    serve_counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    prune_counts = {k: 0 for k in PRUNE_KERNELS}
    t = time.monotonic()
    if "a" in parts:
        say("  12a: kernels against plain end to end, f32")
        out["e2e"] = dense_e2e()
        say(f"  12a took {time.monotonic() - t:.1f} s")
    for arch in DENSE_ARCHS if "b" in parts else ():
        t = time.monotonic()
        say(f"  12b: {arch} served at full width and depth, bf16, 2:4")
        c, out[f"serve {arch}"] = dense_serve(arch)
        for k in serve_counts:
            serve_counts[k] += c[k]
        say(f"  12b {arch} took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    for arch in DENSE_ARCHS if "c" in parts else ():
        t = time.monotonic()
        say(f"  12c: {arch} pruned MS 2:4 through the pipelined engine")
        c, out[f"prune {arch}"] = dense_prune(arch)
        for k in prune_counts:
            prune_counts[k] += c[k]
        say(f"  12c {arch} took {time.monotonic() - t:.1f} s")
    if "d" in parts:
        t = time.monotonic()
        say("  12d: MRP compensation at gemma-2b's width, timed")
        out["mrp"] = dense_mrp_timed()
        say(f"  12d took {time.monotonic() - t:.1f} s")
    return serve_counts, prune_counts, out


# ----------------------------------------------------------------------
# phase 13: Mixture-of-Experts — phi3.5-moe, kimi-k2, Jamba with experts
# ----------------------------------------------------------------------
MOE_T = 40960                        # phi3.5's capacity at 128 x 2048
                                     # tokens: 262144 · 2 / 16 · 1.25
MOE_SERVE_LAYERS = {"phi3_5_moe_42b_a6_6b": 8,   # 13b: ≈ 19.7 GiB
                    "kimi_k2_1t_a32b": 1,        # ≈ 36 GiB (384 experts)
                    "jamba_1_5_large_398b": 4}   # slots 0-3: ≈ 42 GiB
MOE_PRUNE_LAYERS = 1                 # 13c: phi3.5, MS 2:4, pipelined (2
                                     # layers until phase 14 came)
MOE_LINEARS = (                      # 13b's packed linears, held against
    ("phi3.5 attn.wq", 4096, 4096, False, None),     # the plain version in
    ("phi3.5 attn.wk", 4096, 1024, False, None),     # phase 1 (phi3.5 has
    ("phi3.5 attn.wv", 4096, 1024, False, None),     # no shared expert)
    ("phi3.5 attn.wo", 4096, 4096, False, None),
    ("kimi attn.wq", 7168, 8192, False, None),
    ("kimi attn.wk", 7168, 1024, False, None),
    ("kimi attn.wv", 7168, 1024, False, None),
    ("kimi attn.wo", 8192, 7168, False, None),
    ("kimi moe.shared.wi", 7168, 2048, False, None),
    ("kimi moe.shared.wg", 7168, 2048, False, "silu"),
    ("kimi moe.shared.wo", 2048, 7168, False, None),
)
MOE_FLASH_HEADS = ((32, 8), (64, 8))  # phi3.5's and kimi's (H, KV), hd 128
MOE_CALIB_SHARDS = 1                 # 13c: the stacked capture (≈ 50 GB at
                                     # its peak) fits in one shard


def check_moe_widths(gen, rows):
    """The kernels 13b serves with at the MoE models' widths, each against
    its plain version: nm_spmm_decode (M 8) and nm_spmm (M 256) at
    MOE_LINEARS (timed, as check_dense_widths), and flash_attn at phi3.5's
    32 / 8 and kimi's 64 / 8 heads, hd 128, f32 and bf16, causal, B 2 and
    T in {64, 129, 2048} (64: 13b's prompts; 2048: 13c's captures), each
    on its dtype's route with the same bits from a second call."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain

    out = {"nm_spmm_decode": [], "nm_spmm": []}
    for m in (8, 256):
        for lin in MOE_LINEARS:
            row = nm_row(gen, m, *lin)
            rows.append(row)
            out[row["kernel"]].append(row)
    n0 = len(rows)
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        want_route = "f32 FMA" if dtype == torch.float32 else "tensor cores"
        tol_rel = (KERNEL_TOL_REL if dtype == torch.float32
                   else BF16_KERNEL_TOL_REL)
        for h, kv in MOE_FLASH_HEADS:
            for t in (64, 129, 2048):
                q, k, v = _flash_inputs(gen, 2, t, h, kv, 128, dtype)
                got = flash_attn(q, k, v, True)
                route = flash_attn.last_kernel
                same = bool(torch.equal(got, flash_attn(q, k, v, True)))
                want = flash_attn_plain(q, k, v, True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = tol_rel * max(1.0, want.abs().max().item())
                row = dict(kernel="flash_attn",
                           shape=f"B=2 T={t} H={h} KV={kv} hd=128 {dname} "
                                 "causal",
                           max_abs_err=err, tol=tol,
                           ok=err <= tol and route == want_route and same,
                           route=route, deterministic=same)
                rows.append(row)
                LOG.append(f"  flash_attn      {row['shape']:40s} err "
                           f"{err:.3e} tol {tol:.3e} ({route}) same bits "
                           f"{same} {'ok' if row['ok'] else 'FAIL'}")
                del q, k, v, got, want
    new = rows[n0:]
    say(f"  flash_attn      {len(new)} cases at the MoE models' heads (H/KV "
        f"32/8 and 64/8, hd 128, f32/bf16, causal, T 64/129/2048): "
        f"{sum(r['ok'] for r in new)} ok, worst err/tol "
        f"{max(r['max_abs_err'] / r['tol'] for r in new):.3e}")
    out["flash_attn"] = new
    torch.cuda.empty_cache()
    return out


def check_hessian_weighted(gen, rows):
    """The weighted hessian_accum (a MoE expert's routed tokens) at
    phi3.5's expert shapes, T = MOE_T, m = 4096 (wi / wg) and 6400 (wo),
    bf16 captures, count c = T/2 on the device and H_old random: bool
    weights (routing validity, 80 % kept) on the tensor cores and float
    weights (gates) on the f32 FMA, each against the plain version; the
    count must come back c + Σw with no host sync.  Then small edges: an
    all-zero w (H and c unchanged), f32 captures with bool weights, a
    ragged m = 130.  Each row asserts its route, exact symmetry and the
    same bits from a second call."""
    import torch

    from repro_torch.kernels.hessian_accum import (
        hessian_accum, hessian_accum_weighted, hessian_accum_weighted_plain)

    cases = [(MOE_T, 4096, torch.bfloat16, "bool", True),
             (MOE_T, 6400, torch.bfloat16, "bool", True),
             (MOE_T, 4096, torch.bfloat16, "float", True),
             (MOE_T, 6400, torch.bfloat16, "float", True),
             (4097, 256, torch.bfloat16, "zero", False),
             (4097, 512, torch.float32, "bool", False),
             (4097, 130, torch.bfloat16, "bool", False)]
    per = []
    for t, m, dtype, kind, timed in cases:
        x = torch.randn(t, m, generator=gen, device="cuda").to(dtype)
        if kind == "float":
            w = torch.rand(t, generator=gen, device="cuda")
        else:
            w = torch.rand(t, generator=gen, device="cuda") < (
                0.0 if kind == "zero" else 0.8)
        h0 = torch.randn(m, m, generator=gen, device="cuda")
        h0 = h0 + h0.T
        c0 = torch.full((), t / 2, device="cuda")
        want_route = ("tensor cores" if dtype == torch.bfloat16
                      and kind != "float" and m % 8 == 0 else "f32 FMA")
        syncs = {}
        h1, c1 = h0.clone(), c0.clone()
        torch.cuda.synchronize()
        with count_syncs(syncs):
            got = hessian_accum_weighted(x, w, h1, c1)
        route = hessian_accum.last_kernel
        h2, c2 = h0.clone(), c0.clone()
        same = bool(torch.equal(got, hessian_accum_weighted(x, w, h2, c2)))
        hp, cp = h0.clone(), c0.clone()
        want = hessian_accum_weighted_plain(x, w, hp, cp)
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL_REL * math.sqrt(max(1.0, t / 16384)) * scale
        sym = bool(torch.equal(got, got.T))
        count_ok = abs(c1.item() - cp.item()) <= 1e-6 * cp.item()
        if kind == "zero":
            count_ok = count_ok and c1.item() == c0.item()
            sym = sym and bool(torch.equal(got, h0))
        ok = (err <= tol and sym and same and route == want_route
              and count_ok and syncs["n"] == 0)
        dname = "f32" if dtype == torch.float32 else "bf16"
        row = dict(kernel="hessian_accum",
                   shape=f"T={t} m={m} {dname} {kind} weights (weighted)",
                   max_abs_err=err, tol=tol, ok=ok, route=route,
                   deterministic=same, syncs=syncs["n"],
                   count=(c1.item(), cp.item()))
        if timed:
            x32 = x.float()
            xw = x32 * w.float()[:, None]
            h = h0.clone()
            cnt = [c0.clone() for _ in range(8)]
            args = [(x, w, h, c) for c in cnt]
            row["ms"] = device_ms(hessian_accum_weighted, args, n=3, reps=3)
            row["plain_ms"] = device_ms(hessian_accum_weighted_plain, args,
                                        n=3, reps=3)
            beta = 0.5
            row["library_ms"] = device_ms(
                lambda a, b: torch.addmm(h, a.T, b, beta=beta,
                                         alpha=2.0 / t), [(xw, x32)],
                n=3, reps=3)
            # the work this run's weights need: the kept tokens (bool) or
            # all of them (float, multiplied in f32)
            n_used = int(w.sum().item()) if kind == "bool" else t
            row["bound_ms"], row["bound_by"] = bound(
                t * m * 2 + t * w.element_size() + 2 * m * m * 4,
                float(m) * (m + 1) * n_used,
                "bfloat16" if kind == "bool" else "float32")
            per.append(row)
            del x32, xw, h, cnt, args
        rows.append(row)
        say(f"  hessian_accum   {row['shape']:44s} err {err:.3e} tol "
            f"{tol:.3e} symmetric {sym} ({route}) same bits {same} count "
            f"{c1.item():.1f} (plain {cp.item():.1f}) syncs {syncs['n']} "
            f"{'ok' if ok else 'FAIL'}"
            + (f"  ms {row['ms']:.5f} plain {row['plain_ms']:.5f} lib "
               f"{row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
               f"({row['bound_by']})" if "ms" in row else ""))
        del x, w, h0, h1, h2, hp, got, want
        torch.cuda.empty_cache()
    return per


def _moe_model(arch, layers, dtype=None):
    """``arch`` at full width, ``layers`` deep; a Jamba cut below its
    8-layer period keeps its first ``layers`` slots as the period (4:
    mamba, mamba + experts, mamba, attention + experts)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    cfg = get_config(arch)
    if layers < len(cfg.period):
        cfg = dataclasses.replace(
            cfg, period=cfg.period[:layers],
            moe_slots=tuple(j for j in cfg.moe_slots if j < layers))
    cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, LM(cfg, device="cuda")


def moe_expert_hessians_f32():
    """13a (i): phi3.5-moe at full width in f32, one MoE layer, 4 x 512
    random ids (C = 320 tokens an expert): one capture (kernels), then
    every linear's Hessian accumulated by the kernels and by the plain
    override from the same captures — the 48 expert linears' weighted,
    the router's and attention's plain — and each expert linear's 𝔐 2:4
    mask from the kernel's Hinv, nm_select against the plain version
    (bit-equal, as phase 1's)."""
    import torch

    from repro_torch.core.calibration import CalibrationSet
    from repro_torch.core.hessian import dampened_inverse
    from repro_torch.kernels import ops

    cfg, model = _moe_model("phi3_5_moe_42b_a6_6b", 1, "float32")
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    params = model.init(g)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=g,
                         device="cuda")
    seg = model.prunable_segments()[0]
    sp = seg.get_params(params)
    with torch.no_grad():
        _, caps = seg.apply(sp, model.calib_init(params, {"tokens": toks}),
                            capture=True)
        kern = CalibrationSet.from_captures(caps)
        with ops.override_dispatch(plain=True):
            plain = CalibrationSet.from_captures(caps)
    worst, n_weighted, counts = 0.0, 0, []
    for name in sorted(kern.names()):
        a, b = kern.hessian(name), plain.hessian(name)
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        worst = max(worst, err)
        if kern.accs[name].weighted:
            n_weighted += 1
            counts.append(kern.accs[name].count.item())
            if kern.accs[name].count.item() != plain.accs[name].count.item():
                fail(f"phase 13a: {name}'s count differs, kernel against "
                     "plain")
    say(f"  13a: {len(list(kern.names()))} Hessians ({n_weighted} weighted, "
        f"routed tokens an expert {min(counts):.0f}-{max(counts):.0f} of "
        f"C = {caps['s0.moe.wi.0'][0].shape[0]}), worst |kernel - plain| / "
        f"max(1, |plain|) {worst:.3e} (tol {KERNEL_TOL_REL:g})")
    if worst > KERNEL_TOL_REL or n_weighted != 48:
        fail(f"phase 13a: weighted Hessians off by {worst:.3e}, "
             f"{n_weighted} weighted")
    diff_groups = groups = 0
    for lin in seg.linears:
        if ".moe." not in lin.name:
            continue
        hinv = dampened_inverse(kern.hessian(lin.name))
        w = lin.get(sp).contiguous()                 # (out, in)
        got = ops.nm_select_mask(w, hinv)
        with ops.override_dispatch(plain=True):
            want = ops.nm_select_mask(w, hinv)
        diff_groups += int((got != want).reshape(w.shape[0], -1, 4).any(
            -1).sum())
        groups += w.numel() // 4
        del hinv, got, want
    say(f"  13a: 𝔐 2:4 masks of the 48 expert linears, nm_select against "
        f"plain: {groups - diff_groups}/{groups} groups equal")
    if diff_groups:
        fail(f"phase 13a: {diff_groups} mask groups differ")
    del caps, kern, plain, params, sp
    torch.cuda.empty_cache()
    return dict(worst_rel_err=worst, weighted=n_weighted,
                routed_min=min(counts), routed_max=max(counts),
                mask_groups=groups)


def moe_smoke_plain():
    """13a (ii): phi3.5-moe's SMOKE in f32 on the card: MM 2:4 through the
    pipelined engine and a static greedy serve of the result (4 requests
    in one bucket, continuous asked), each with the kernels and under the
    plain override — the override launching nothing.  Masks and weights,
    and the streams, must be equal."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import PruningEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke("phi3_5_moe_42b_a6_6b")
    model = LM(cfg, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    params = model.init(g)
    params["embed"]["tok"] = params["embed"]["tok"] * 8.0   # sharp logits
    calib = [{"tokens": t, "labels": t} for t in torch.randint(
        0, cfg.vocab_size, (2, 4, 32), generator=g, device="cuda")]
    rng = np.random.default_rng(13)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=16,
                                               dtype=np.int32),
                    max_new_tokens=12) for i in range(4)]
    runs = {}
    for label in ("kernels", "plain"):
        ctx = (ops.override_dispatch(plain=True) if label == "plain"
               else contextlib.nullcontext())
        ops.reset_launch_counts()
        with ctx, torch.no_grad():
            pruned, reports = PruningEngine(
                model, "2:4", method="MM", blocksize=32).run(params, calib)
            eng = ServeEngine(model, pruned, max_batch=4, max_len=32,
                              page_size=8, mode="continuous")
            res = eng.generate(reqs)
        n = ops.launch_counts()
        if eng.mode != "static":
            fail(f"phase 13a: a MoE engine reports mode {eng.mode!r}")
        if (label == "plain") == any(n.values()):
            fail(f"phase 13a {label}: launches {n}")
        runs[label] = (pruned, reports, _streams(res), n)
    (pk, rk, sk, nk), (pp, rp, spl, _) = runs["kernels"], runs["plain"]
    flat_k, flat_p = model.params_to_flat(pk), model.params_to_flat(pp)
    mask_diff = sum(int(((flat_k[k] == 0) != (flat_p[k] == 0)).sum())
                    for k in flat_k)
    w_err = max(float(np.abs(flat_k[k].astype(np.float32)
                             - flat_p[k].astype(np.float32)).max())
                for k in flat_k)
    total = sum(flat_k[k].size for k in flat_k
                if re.search(r"/(attn|moe)/w", k))
    agree = 1 - mask_diff / total
    err_k = sum(r.recon_error for r in rk)
    err_p = sum(r.recon_error for r in rp)
    err_rel = abs(err_k - err_p) / max(abs(err_p), 1e-12)
    say(f"  13a: SMOKE MM 2:4 ({len(rk)} linears), kernels against plain: "
        f"{mask_diff} of {total} mask entries differ (agree {agree:.5f}), "
        f"max |Δw| {w_err:.3e}, total recon error {err_k:.6g} against "
        f"{err_p:.6g} ({err_rel:.3e}); static greedy streams equal "
        f"{_same(sk, spl)}; kernel launches {nk}")
    # the f32 captures differ by ~1e-6 (flash_attn against its plain
    # version), so a near tie may flip, as in phase 5b
    if agree < MASK_AGREE_MIN or err_rel > PIPE_TOTAL_ERR_REL:
        fail("phase 13a: the SMOKE prune differs, kernels against plain")
    if not _same(sk, spl):
        fail(f"phase 13a: static streams differ: {sk} against {spl}")
    for k in ("hessian_accum", "nm_select", "flash_attn", "nm_spmm_decode"):
        if nk[k] <= 0:
            fail(f"phase 13a: kernel {k} not launched")
    return dict(linears=len(rk), mask_diff=mask_diff, agree=agree,
                w_err=w_err, recon_rel=err_rel, launches=nk)


def moe_serve(arch, smi):
    """13b: ``arch`` at full width, MOE_SERVE_LAYERS deep, bf16, random
    weights from a seeded torch.Generator, magnitude 2:4 on attention and
    the dense and shared MLPs (packed), the routed experts dense.  Phase
    3's 8 requests of 64 + 32 tokens asked continuous, served static (the
    engine's effective mode); tok/s, HBM held, and one profiled generate's
    idle share and nm_spmm_decode device time."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    layers = MOE_SERVE_LAYERS[arch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, model = _moe_model(arch, layers)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    with torch.no_grad():
        params = prune_linears(model.init(g), "2:4")
    eng = ServeEngine(model, params, max_batch=8, max_len=128, page_size=16,
                      prefill_chunk=32, mode="continuous")
    del params
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(eng.params))
    expert_bytes = sum(lp["moe"][k].numel() * lp["moe"][k].element_size()
                       for lp in eng.params["layers"] if "moe" in lp
                       for k in ("wi", "wg", "wo"))
    torch.cuda.synchronize()
    mc = cfg.moe
    say(f"  {cfg.name}: {layers} layers ({model.kinds}, MoE slots "
        f"{[j for j, m in enumerate(model.moe_slots) if m]}), d_model "
        f"{cfg.d_model}, {mc.num_experts} experts top-{mc.top_k} d_ff "
        f"{mc.d_ff_expert}, shared {mc.num_shared}; init + 2:4 + packing "
        f"{time.monotonic() - t0:.1f} s; params {n_bytes / 2**30:.3f} GiB "
        f"({expert_bytes / 2**30:.3f} GiB routed experts, dense), "
        f"{eng.n_sparse_leaves} packed; mode asked continuous, served "
        f"{eng.mode}; HBM peak so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({smi})")
    if eng.mode != "static":
        fail(f"phase 13b {arch}: mode {eng.mode!r}, expected static")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the path starts
    t0 = time.monotonic()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    _check_streams(f"phase 13b {arch}", reqs, res, cfg.vocab_size)
    toks = sum(len(r.tokens) for r in res)
    say(f"  mode {eng.mode}: {toks} tokens in {dt:.3f} s = {toks / dt:.2f} "
        f"tok/s; host syncs {eng.stats['host_syncs']}; HBM held "
        f"{hbm / 2**30:.3f} GiB; launches {counts}")
    for k in ("nm_spmm", "nm_spmm_decode", "flash_attn"):
        if counts[k] <= 0:
            fail(f"phase 13b {arch}: kernel {k} was not launched")
    prof = profile_main(eng, reqs)
    dec = sum(v for k, v in prof["by_kernel_s"].items()
              if k.startswith("nm_spmm_decode"))
    say(f"  nm_spmm_decode device time in the profiled generate: "
        f"{dec * 1e3:.3f} ms; idle share {1 - prof['busy_s'] / prof['wall_s']:.3f}")
    out = dict(layers=layers, mode=eng.mode, tok_s=toks / dt, wall_s=dt,
               hbm_gib=hbm / 2**30, params_gib=n_bytes / 2**30,
               expert_gib=expert_bytes / 2**30, packed=eng.n_sparse_leaves,
               launches=counts, profile=prof,
               idle=1 - prof["busy_s"] / prof["wall_s"],
               nm_spmm_decode_ms=dec * 1e3)
    del eng, res, model
    torch.cuda.empty_cache()
    return counts, out


def moe_prune(smi):
    """13c: ``launch.prune.prune`` with the launcher's default (pipelined)
    engine, MS 2:4 at blocksize 128, on phi3.5-moe at full width,
    MOE_PRUNE_LAYERS deep, 128 x 2048 random ids (C = 40960 tokens an
    expert): seconds a layer, HBM held, host syncs (≤ 1: the weighted
    Hessians' counts stay on the card), launches a layer (hessian_accum
    53: 4 attention, the router, 48 experts; flash_attn 2; nm_select
    52), every pruned linear 2:4, finite perplexity."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    layers = MOE_PRUNE_LAYERS
    cfg, model = _moe_model("phi3_5_moe_42b_a6_6b", layers)
    params = launch_prune.load_params(model, None, seed=0)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ev = [{"tokens": t, "labels": t} for t in torch.randint(
        0, cfg.vocab_size, (2, 4, 512), generator=gen, device="cuda")]
    dense_ppl = launch_prune.eval_ppl(model, params, ev)
    pipeline = launch_prune.build_parser().get_default("pipeline")
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the prune path starts
    t0 = time.monotonic()
    with count_syncs(syncs):
        pruned, reports = launch_prune.prune(
            model, params, calib, "2:4", "MS", blocksize=128,
            row_chunk=PRUNE_ROW_CHUNK, pipeline=pipeline,
            calib_shard=MOE_CALIB_SHARDS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    e = cfg.moe.num_experts
    per_layer = 4 + 3 * e
    say(f"  {cfg.name}, {layers} layers, MS 2:4 ({pipeline}, "
        f"{MOE_CALIB_SHARDS} shard(s)): {wall:.2f} s ({wall / layers:.3f} s "
        f"a layer); HBM held {hbm / 2**30:.3f} GiB; host syncs {syncs['n']} "
        f"from {syncs['where']}; launches {counts} ({smi})")
    want = {"hessian_accum": (per_layer + 1) * layers * MOE_CALIB_SHARDS,
            "flash_attn": 2 * layers * MOE_CALIB_SHARDS,
            "nm_select": per_layer * layers}
    for k, n in want.items():
        if counts[k] != n:
            fail(f"phase 13c: {counts[k]} {k} launches, expected {n}")
    if syncs["n"] > 1:
        fail(f"phase 13c: {syncs['n']} host syncs in the pipelined run")
    if len(reports) != per_layer * layers or any(
            abs(r.sparsity - 0.5) > 1e-6 for r in reports):
        fail(f"phase 13c: {len(reports)} reports, or a sparsity other than "
             "0.5")
    bad = []
    for i, lp in enumerate(pruned["layers"]):
        for key in ("wq", "wk", "wv", "wo"):
            g4 = lp["attn"][key].T.reshape(-1, 4)
            if not bool(((g4 != 0).sum(-1) <= 2).all()):
                bad.append(f"{i}.attn.{key}")
        for key in ("wi", "wg", "wo"):
            st = lp["moe"][key].transpose(1, 2).reshape(-1, 4)
            if not bool(((st != 0).sum(-1) <= 2).all()):
                bad.append(f"{i}.moe.{key}")
    if bad:
        fail(f"phase 13c: not 2:4 after MS: {bad}")
    pruned_ppl = launch_prune.eval_ppl(model, pruned, ev)
    say(f"  perplexity on 2 x 4 x 512 random tokens: dense {dense_ppl:.2f}, "
        f"MS 2:4 {pruned_ppl:.2f} (random weights: no gate)")
    if not (math.isfinite(dense_ppl) and math.isfinite(pruned_ppl)):
        fail("phase 13c: non-finite perplexity")
    out = dict(layers=layers, wall_s=wall, s_per_layer=wall / layers,
               hbm_gib=hbm / 2**30, syncs=syncs["n"], launches=counts,
               dense_ppl=dense_ppl, pruned_ppl=pruned_ppl)
    del pruned, params, model, calib
    torch.cuda.empty_cache()
    return counts, out


def moe_phase(smi, parts="abc"):
    """Phase 13 (those of ``parts``): returns the launches of the serving
    and pruning runs and the phase's numbers."""
    import torch

    out = {}
    serve_counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    prune_counts = {k: 0 for k in PRUNE_KERNELS}
    t = time.monotonic()
    if "a" in parts:
        say("  13a: the weighted Hessians and 𝔐 masks of phi3.5's 48 expert "
            "linears at full width, f32; the SMOKE prune and static serve, "
            "kernels against plain")
        out["hessians"] = moe_expert_hessians_f32()
        out["smoke"] = moe_smoke_plain()
        say(f"  13a took {time.monotonic() - t:.1f} s")
    for arch in MOE_SERVE_LAYERS if "b" in parts else ():
        t = time.monotonic()
        say(f"  13b: {arch} served at full width, {MOE_SERVE_LAYERS[arch]} "
            "layers, bf16")
        c, out[f"serve {arch}"] = moe_serve(arch, smi)
        for k in serve_counts:
            serve_counts[k] += c[k]
        say(f"  13b {arch} took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "c" in parts:
        t = time.monotonic()
        say("  13c: phi3.5-moe pruned MS 2:4 through the pipelined engine")
        prune_counts, out["prune"] = moe_prune(smi)
        say(f"  13c took {time.monotonic() - t:.1f} s")
    return serve_counts, prune_counts, out


# ----------------------------------------------------------------------
# phase 14: the xLSTM — xlstm-350m served, pruned and trained
# ----------------------------------------------------------------------
XLSTM_LINEARS = (                    # xlstm-350m's packed (K, N) pairs,
    ("mlstm.wq|wk|wv", 1024, 2048, False, None),   # held against the plain
    ("mlstm.wo", 2048, 1024, False, None),         # version in phase 1
    ("slstm.wz|wi|wf|wo_gate|wo", 1024, 1024, False, None),
)
XLSTM_PACKED = 21 * 4 + 3 * 5        # 14b: the packed leaves of 24 layers
XLSTM_QUAD_T = 16384                 # 14c: one mLSTM layer, chunkwise
                                     # against quadratic: a (1, 4, T, T)
                                     # f32 tensor is 4.3 GB, ≈ 3 live
XLSTM_LONG = 9216                    # 14c: the smallest prompt > 8192 that
                                     # is a multiple of 1024 (chunkwise)
XLSTM_LOOP_STEPS = 1024              # 14c: the sLSTM loop timed alone over
                                     # these steps (a step's time is the
                                     # same at every position)
XLSTM_PRUNE_LAYERS = 8               # 14d: one period (7 mLSTM + the sLSTM)
XLSTM_PRUNE_PACKED = 7 * 4 + 5       # of the 24, its 33 linears (all 24
                                     # layers until phases 15e and 16 came)
XLSTM_CALIB_SHARDS = 2               # 14d: a (64, 4, 2048, 2048) f32 tensor
                                     # is 4.3 GB, ≈ 3 live in the quadratic
                                     # form, beside a segment's captures
                                     # (≈ 6 GB a shard)
XLSTM_F64_RATIO = 4.0                # 14c: the chunkwise form's error
                                     # against the quadratic form in f64, at
                                     # most this many times the f32
                                     # quadratic form's own


def check_xlstm_widths(gen, rows):
    """nm_spmm_decode (M 8) and nm_spmm (M 256) at xlstm-350m's three
    packed (K, N) pairs beside torch.matmul and the bound, and
    hessian_accum at m 2048 (the mLSTM's ``wo`` input)."""
    out = {"nm_spmm_decode": [], "nm_spmm": []}
    for m in (8, 256):
        for lin in XLSTM_LINEARS:
            row = nm_row(gen, m, *lin)
            rows.append(row)
            out[row["kernel"]].append(row)
    out["hessian_accum"] = check_hessian(gen, rows, ((16384, 2048),))
    return out


def _xlstm(layers, dtype=None):
    """xlstm-350m at full width, ``layers`` deep (below its period of 8,
    the period's first ``layers`` slots: 4 → three mLSTM and the
    sLSTM)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    cfg = get_config("xlstm_350m")
    if layers < len(cfg.period):
        cfg = dataclasses.replace(cfg, period=cfg.period[:layers])
    cfg = dataclasses.replace(cfg, num_layers=layers,
                              dtype=dtype or cfg.dtype)
    return cfg, LM(cfg, device="cuda")


def _xlstm_packed(model, seed=0, sharpen=False):
    """Random weights from a seeded torch.Generator, magnitude 2:4 on the
    block linears (``LM.block_linears``), packed with their patterns —
    the reference's ``compressed_param_tree(params, patterns)``; the
    defaults would pack none of them."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.serve.sparse import compressed_param_tree, linear_patterns

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pairs = model.block_linears()
    with torch.no_grad():
        params = prune_linears(model.init(g), "2:4", linears=pairs)
        if sharpen:
            params["embed"]["tok"] = params["embed"]["tok"] * 8.0
        return compressed_param_tree(params, linear_patterns(pairs))


def _xlstm_requests(cfg, n=8, prompt=64, new=32, seed=0):
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=prompt, dtype=np.int32),
                    max_new_tokens=new) for i in range(n)]


def _forced_recompute(eng, reqs, every=3, limit=4):
    """A continuous session whose youngest decoding request is preempted
    by recompute every ``every`` steps, ``limit`` times: a pure recurrent
    model has no pages, so no pool starves it.  Returns (streams, the
    preemptions forced)."""
    session = eng.session()
    for r in reqs:
        session.submit(r)
    got, steps, forced = {}, 0, 0
    while session.has_work():
        for ev in session.step():
            if ev.finished:
                got[ev.uid] = ev.result.tokens
        steps += 1
        live = [s for s in session.sched.running if len(s.tokens) > 1]
        if live and steps % every == 0 and forced < limit:
            session.sched.preempt(live[-1])
            forced += 1
    return got, forced


def xlstm_f32_plain():
    """14a: (i) one f32 period at full width — three mLSTM and the sLSTM,
    d_model 1024 — 2:4-packed, the embedding sharpened: phase 3's 8
    requests continuous (page 16, chunk 32) and as one static bucket, with
    the kernels and under the plain override (which launches nothing):
    streams equal.  (ii) The SMOKE model (one period) pruned MS 2:4 by the
    pipelined engine, kernels against plain: masks compared entry by entry
    (the f32 Hessians differ by rounding, so a near tie may flip: phase
    13a's rule), weights and reconstruction errors."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import PruningEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine

    cfg, model = _xlstm(4, "float32")
    packed = _xlstm_packed(model, seed=3, sharpen=True)
    reqs = _xlstm_requests(cfg)
    streams = {}
    for label in ("kernels", "plain"):
        ctx = (ops.override_dispatch(plain=True) if label == "plain"
               else contextlib.nullcontext())
        ops.reset_launch_counts()
        with ctx, torch.no_grad():
            cont = ServeEngine(model, packed, max_batch=8, max_len=128,
                               page_size=16, prefill_chunk=32).generate(reqs)
            stat = ServeEngine(model, packed, max_batch=8, max_len=128,
                               mode="static").generate(reqs)
        n = ops.launch_counts()
        if (label == "plain") == any(n.values()):
            fail(f"phase 14a {label}: launches {n}")
        _check_streams(f"phase 14a {label}", reqs, cont, cfg.vocab_size)
        streams[label] = (_streams(cont), _streams(stat), n)
    (ck, sk, nk), (cp, sp, _) = streams["kernels"], streams["plain"]
    say(f"  14a: {cfg.name} 4 layers f32 ({model.kinds}), 2:4-packed: "
        f"streams kernels vs plain equal — continuous {_same(ck, cp)}, "
        f"static {_same(sk, sp)}; kernel launches {nk}")
    if not (_same(ck, cp) and _same(sk, sp)):
        fail("phase 14a: the packed f32 period's streams differ, kernels "
             "against plain")
    for k in ("nm_spmm", "nm_spmm_decode"):
        if nk[k] <= 0:
            fail(f"phase 14a: kernel {k} not launched")

    scfg = get_smoke("xlstm_350m")
    smodel = LM(scfg, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    params = smodel.init(g)
    calib = [{"tokens": t, "labels": t} for t in torch.randint(
        0, scfg.vocab_size, (2, 4, 32), generator=g, device="cuda")]
    runs = {}
    for label in ("kernels", "plain"):
        ctx = (ops.override_dispatch(plain=True) if label == "plain"
               else contextlib.nullcontext())
        ops.reset_launch_counts()
        with ctx, torch.no_grad():
            pruned, reports = PruningEngine(
                smodel, "2:4", method="MS", blocksize=32).run(params, calib)
        n = ops.launch_counts()
        if (label == "plain") == any(n.values()):
            fail(f"phase 14a {label}: prune launches {n}")
        runs[label] = (smodel.params_to_flat(pruned), reports, n)
    (fk, rk, nk), (fp, rp, _) = runs["kernels"], runs["plain"]
    keys = [k for k in fk if re.search(r"/(mlstm|slstm)/w", k)
            and not re.search(r"mlstm/w[if]$", k)]
    mask_diff = sum(int(((fk[k] == 0) != (fp[k] == 0)).sum()) for k in keys)
    total = sum(fk[k].size for k in keys)
    w_err = max(float(np.abs(fk[k] - fp[k]).max()) for k in keys)
    err_k = sum(r.recon_error for r in rk)
    err_p = sum(r.recon_error for r in rp)
    err_rel = abs(err_k - err_p) / max(abs(err_p), 1e-12)
    say(f"  14a: SMOKE MS 2:4 ({len(rk)} linears), kernels against plain: "
        f"masks bit-equal {mask_diff == 0} ({mask_diff} of {total} entries "
        f"differ), max |Δw| {w_err:.3e}, total recon error {err_k:.6g} "
        f"against {err_p:.6g} ({err_rel:.3e}); launches {nk}")
    if 1 - mask_diff / total < MASK_AGREE_MIN or err_rel > PIPE_TOTAL_ERR_REL:
        fail("phase 14a: the SMOKE prune differs, kernels against plain")
    for k in ("hessian_accum", "nm_select"):
        if nk[k] <= 0:
            fail(f"phase 14a: kernel {k} not launched")
    return dict(streams_equal=True, mask_diff=mask_diff, masks=total,
                w_err=w_err, recon_rel=err_rel, linears=len(rk))


def _xlstm_parts_ms(cfg):
    """Device time of the xLSTM's cells alone at 14b's decode shapes (B =
    8, f32 state): the mLSTM recurrence of one step over the 21 mLSTM
    layers, and the sLSTM cell over the 3 sLSTM layers."""
    import torch

    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    nh, d = cfg.num_heads, cfg.d_model
    hd = cfg.mlstm_proj * d // nh

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    mstep = [(rand(8, nh, hd, hd), rand(8, nh, hd), rand(8, nh) - 5,
              rand(8, nh, hd) / math.sqrt(hd), rand(8, nh, hd),
              rand(8, nh, hd), rand(8, nh) * 0.1, rand(8, nh) * 0.1 - 3)
             for _ in range(3)]
    rec = rand(nh, d // nh, 4 * d // nh) / math.sqrt(d // nh)
    bf = torch.full((d,), 3.0, device="cuda")
    sstep = [(rec, bf, rand(8, d), rand(8, d), rand(8, d), rand(8, d),
              (rand(8, d), rand(8, d).abs() + 1, rand(8, d), rand(8, d)),
              nh, d // nh)]
    return {"mLSTM decode step, 21 layers, B=8":
            21 * device_ms(ssm._mlstm_step, mstep),
            "sLSTM cell, 3 layers, B=8":
            3 * device_ms(ssm._slstm_cell, sstep)}


def _upcast(tree):
    """A param tree in f32: packed ``{"vals", "idx"}`` leaves keep their
    indices."""
    if isinstance(tree, dict):
        return {k: (v if k == "idx" else _upcast(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upcast(v) for v in tree]
    return tree.float()


def _bf16_partings(model, params, model32, params32, reqs, got, want,
                   label, feats=None):
    """Where two bf16 greedy streams part, beside the f32 twin (the same
    weights upcast): the two tokens' gap there and the bf16 forward's
    errors against it, ``|e16(a)| + |e16(b)|`` — how far bf16 rounding
    alone moves the two logits.  Reported, not gated: the f32 twin's
    streams are the gate.  Returns (streams that part, partings whose f32
    gap is within the bf16 errors).  ``feats``: a frontend model's
    features, row i for request i."""
    import torch

    parted = explained = 0
    for i, r in enumerate(reqs):
        a, b = want[r.uid], got[r.uid]
        diff = np.nonzero(a != b)[0]
        if len(diff) == 0:
            continue
        parted += 1
        j = int(diff[0])
        ctx = torch.from_numpy(np.concatenate([r.prompt, a[:j]]))[None].cuda()
        f = None if feats is None else feats[i:i + 1]
        with torch.no_grad():
            lg = model.forward(params, ctx, frontend_feats=f)[0, -1]
            lf = model32.forward(params32, ctx, frontend_feats=f)[0, -1]
        ta, tb = int(a[j]), int(b[j])
        gap32 = abs(lf[ta] - lf[tb]).item()
        err = (abs(lg[ta] - lf[ta]) + abs(lg[tb] - lf[tb])).item()
        explained += gap32 <= err
        say(f"  {label}: request {r.uid} parts at token {j}: bf16 logits "
            f"{lg[ta].item():.4g} / {lg[tb].item():.4g}, f32 twin "
            f"{lf[ta].item():.4g} / {lf[tb].item():.4g} (gap {gap32:.3e}, "
            f"bf16 errors {err:.3e}; bf16 against f32 over the vocabulary "
            f"{(lg - lf).abs().max().item():.3e} at logits of "
            f"{lf.abs().max().item():.3g})")
    return parted, explained


def xlstm_serve(smi):
    """14b: xlstm-350m at full width and depth (24 layers: 21 mLSTM, 3
    sLSTM), bf16, magnitude 2:4 on the 99 block linears, packed.  Phase 3's
    8 requests (64 + 32 tokens) continuous (page 16, chunk 32), as one
    static bucket, and continuous again with forced recompute preemptions;
    tok/s, host syncs a token, HBM held, a profiled generate's idle share,
    and the cells' device time alone.  Continuous against static: the
    same weights in f32 must give equal streams up to near ties at
    LOGIT_TOL; in bf16 the two round apart (other kernels for the linears
    — M 32 chunks against the 512-row prefill — and the chunkwise form
    against the quadratic one), and the partings are reported beside the
    bf16 forward's error (``_bf16_partings``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sparse import count_packed

    torch.cuda.synchronize()
    t0 = time.monotonic()
    cfg, model = _xlstm(24)
    packed = _xlstm_packed(model, seed=0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(packed))
    n_packed = count_packed(packed)
    say(f"  {cfg.name}: 24 layers ({model.kinds.count('mlstm')} mLSTM, "
        f"{model.kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads (mLSTM head dim "
        f"{cfg.mlstm_proj * cfg.d_model // cfg.num_heads}); init + 2:4 + "
        f"packing {time.monotonic() - t0:.1f} s; params {n_bytes / 2**30:.3f}"
        f" GiB, {n_packed} packed leaves ({smi})")
    if n_packed != XLSTM_PACKED:
        fail(f"phase 14b: {n_packed} packed leaves, expected {XLSTM_PACKED}")
    reqs = _xlstm_requests(cfg)
    kw = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
    eng = ServeEngine(model, packed, **kw)
    static = ServeEngine(model, packed, max_batch=8, max_len=128,
                         mode="static")
    forced_eng = ServeEngine(model, packed, **kw)
    for e in (eng, forced_eng):
        if (e.pool.has_kv_pages or e.state_pool is None or e._swap_ok
                or e.pool.prefix is not None):
            fail("phase 14b: the xLSTM's pool has pages, a prefix index or "
                 "swap, or no state rows")
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the path starts

    def run(label, e, fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        streams, extra = fn()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        toks = sum(len(v) for v in streams.values())
        st = dict(e.stats)
        say(f"  {label}: {toks} tokens in {dt:.3f} s = {toks / dt:.2f} tok/s;"
            f" host syncs/token {st['host_syncs'] / toks:.3f}; prefill "
            f"chunks {st['prefill_chunks']}; preemptions recompute "
            f"{st['preempt_recompute']} swap {st['preempt_swap']}{extra}")
        out[label] = dict(tok_s=toks / dt, wall_s=dt,
                          syncs_per_token=st["host_syncs"] / toks, stats=st)
        return streams

    def gen(e):
        def fn():
            res = e.generate(reqs)
            _check_streams("phase 14b", reqs, res, cfg.vocab_size)
            return _streams(res), ""
        return fn

    def forced():
        got, n = _forced_recompute(forced_eng, reqs)
        return got, f" ({n} forced)"

    cont = run("8 requests, continuous", eng, gen(eng))
    stat = run("8 requests, static", static, gen(static))
    pre = run("8 requests, continuous, forced recompute preemptions",
              forced_eng, forced)
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    say(f"  launches over the phase's serving runs {counts}; HBM held "
        f"{hbm / 2**30:.3f} GiB ({smi})")
    if forced_eng.stats["preempt_recompute"] < 2 or not _same(pre, cont):
        fail("phase 14b: the forced recompute run preempted fewer than 2 "
             "times, or its streams differ from the continuous run's")
    for k in ("nm_spmm", "nm_spmm_decode"):
        if counts[k] <= 0:
            fail(f"phase 14b: kernel {k} was not launched")
    cfg32, model32 = _xlstm(24, "float32")
    packed32 = _upcast(packed)
    cont32 = _streams(ServeEngine(model32, packed32, **kw).generate(reqs))
    stat32 = _streams(ServeEngine(model32, packed32, max_batch=8,
                                  max_len=128, mode="static").generate(reqs))
    parted32 = _first_divergence(model32, packed32, reqs, stat32, cont32,
                                 LOGIT_TOL, "phase 14b f32 continuous vs "
                                 "static")
    parted, explained = _bf16_partings(
        model, packed, model32, packed32, reqs, cont, stat,
        "phase 14b bf16 continuous vs static")
    del packed32, model32
    torch.cuda.empty_cache()
    say(f"  continuous vs static: f32 {len(reqs) - parted32}/{len(reqs)} "
        f"streams equal (the rest part at near ties); bf16 "
        f"{len(reqs) - parted}/{len(reqs)}, {explained} of the {parted} "
        "partings within the bf16 forward's own error; forced recompute: "
        "streams equal to the continuous run's")
    say("  the profiled run: the 8 requests, continuous")
    out["profile"] = profile_main(eng, reqs)
    prof = out["profile"]
    out["idle"] = 1 - prof["busy_s"] / prof["wall_s"]
    parts = _xlstm_parts_ms(cfg)
    for k, v in parts.items():
        say(f"  {k}: {v:.4f} ms device time")
    out.update(parted=parted, explained=explained, parted_f32=parted32,
               hbm_gib=hbm / 2**30,
               launches=counts,
               params_gib=n_bytes / 2**30, packed=n_packed, parts_ms=parts)
    del eng, static, forced_eng
    torch.cuda.empty_cache()
    return counts, model, packed, out


def xlstm_long(model, packed, smi):
    """14c: (i) one mLSTM layer of the 14b model, B 1, T XLSTM_QUAD_T: the
    chunkwise form (chunk 1024) and the quadratic one on the same
    projections, each timed with the HBM it holds, and both against the
    quadratic form in f64 — the normaliser divides sums of 16384 terms
    that nearly cancel, so f32 rounding alone parts the two forms by far
    more than at short lengths: the chunkwise error must stay within
    XLSTM_F64_RATIO times the quadratic's; (ii) the
    whole model's static prefill of one XLSTM_LONG-token prompt (the
    chunkwise path) and 32 decode tokens, and one sLSTM layer's prefill
    over XLSTM_LOOP_STEPS tokens alone (its per-token loop: host time; a
    step costs the same at every position)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    out = {}
    p = packed["layers"][0]["mlstm"]
    with torch.no_grad():
        h = torch.randn(1, XLSTM_QUAD_T, cfg.d_model, generator=g,
                        device="cuda").to(torch.bfloat16)
        xs = ssm.mlstm_projections(p, h, cfg)
        del h
        times = {}
        for label, fn in (("chunkwise", lambda: ssm._mlstm_chunkwise(
                *xs, ssm.MLSTM_CHUNK)[0]),
                ("quadratic", lambda: ssm._mlstm_parallel(*xs)[0])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            y = fn()
            torch.cuda.synchronize()
            times[label] = (time.monotonic() - t0,
                            (torch.cuda.max_memory_allocated() - base) / 2**30)
            out[label] = y
        err = (out["chunkwise"] - out["quadratic"]).abs().max().item()
        ref = ssm._mlstm_parallel(*(x.double() for x in xs))[0]
        e64 = {k: (out[k].double() - ref).abs().max().item()
               for k in ("chunkwise", "quadratic")}
        scale = ref.abs().max().item()
        del out["chunkwise"], out["quadratic"], xs, ref
    say(f"  14c: one mLSTM layer, B 1, T {XLSTM_QUAD_T}: chunkwise "
        f"{times['chunkwise'][0]:.3f} s ({times['chunkwise'][1]:.2f} GiB "
        f"above its inputs), quadratic {times['quadratic'][0]:.3f} s "
        f"({times['quadratic'][1]:.2f} GiB); max |Δ| {err:.3e} between "
        f"them; against the quadratic form in f64 (scale {scale:.3g}): "
        f"chunkwise {e64['chunkwise']:.3e}, quadratic "
        f"{e64['quadratic']:.3e} ({smi})")
    if not e64["chunkwise"] <= XLSTM_F64_RATIO * e64["quadratic"]:
        fail(f"phase 14c: the chunkwise form's error {e64['chunkwise']:.3e} "
             f"is more than {XLSTM_F64_RATIO} times the quadratic's")
    out["quad_vs_chunk"] = dict(err=err, err_f64=e64, scale=scale,
                                times=times)

    rng = np.random.default_rng(3)
    from repro_torch.serve.engine import Request
    req = [Request(uid=0, prompt=rng.integers(0, cfg.vocab_size,
                                              size=XLSTM_LONG,
                                              dtype=np.int32),
                   max_new_tokens=32)]
    eng = ServeEngine(model, packed, max_batch=1,
                      max_len=XLSTM_LONG + 32, mode="static")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    res = eng.generate(req)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    _check_streams("phase 14c", req, res, cfg.vocab_size)
    hbm = torch.cuda.max_memory_allocated()
    sp = packed["layers"][3]["slstm"]
    with torch.no_grad():
        h = torch.randn(1, XLSTM_LOOP_STEPS, cfg.d_model, generator=g,
                        device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ssm.slstm_apply(sp, h, cfg)
        torch.cuda.synchronize()
        s_wall = time.monotonic() - t0
    say(f"  14c: static prefill of a {XLSTM_LONG}-token prompt + 32 decode "
        f"tokens: {wall:.3f} s; HBM held {hbm / 2**30:.3f} GiB; launches "
        f"{counts}; one sLSTM layer's loop alone over {XLSTM_LOOP_STEPS} "
        f"steps {s_wall:.3f} s ({s_wall / XLSTM_LOOP_STEPS * 1e6:.1f} µs a "
        f"step; 3 layers ≈ {3 * XLSTM_LONG * s_wall / XLSTM_LOOP_STEPS:.3f}"
        f" s of the prefill) ({smi})")
    if counts["nm_spmm"] <= 0:
        fail("phase 14c: the long prefill did not launch the tiled nm_spmm")
    out.update(long_wall_s=wall, long_hbm_gib=hbm / 2**30, launches=counts,
               slstm_layer_s=XLSTM_LONG * s_wall / XLSTM_LOOP_STEPS)
    return counts, out


def xlstm_prune(smi):
    """14d: ``launch.prune.prune`` with the launcher's default (pipelined)
    engine, MS 2:4 at blocksize 128, on xlstm-350m at full width,
    XLSTM_PRUNE_LAYERS deep, bf16, 128 x 2048 random ids in XLSTM_CALIB_SHARDS shards:
    seconds a layer, HBM held, host syncs (≤ 1), launches (hessian_accum
    one a linear and shard, nm_select one a linear), every linear 2:4,
    finite perplexity.  Then three trainer steps of xlstm-350m at batch
    4 x 256 through ``repro_torch.launch.train`` (a process of its own,
    as phase 8's): loss finite, seconds a step."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    cfg, model = _xlstm(XLSTM_PRUNE_LAYERS)
    params = launch_prune.load_params(model, None, seed=0)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ev = [{"tokens": t, "labels": t} for t in torch.randint(
        0, cfg.vocab_size, (2, 4, 512), generator=gen, device="cuda")]
    dense_ppl = launch_prune.eval_ppl(model, params, ev)
    pipeline = launch_prune.build_parser().get_default("pipeline")
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the prune path starts
    t0 = time.monotonic()
    with count_syncs(syncs):
        pruned, reports = launch_prune.prune(
            model, params, calib, "2:4", "MS", blocksize=128,
            row_chunk=PRUNE_ROW_CHUNK, pipeline=pipeline,
            calib_shard=XLSTM_CALIB_SHARDS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    say(f"  {cfg.name}, {layers} layers, MS 2:4 ({pipeline}, "
        f"{XLSTM_CALIB_SHARDS} shards): {wall:.2f} s ({wall / layers:.3f} s "
        f"a layer); HBM held {hbm / 2**30:.3f} GiB; host syncs {syncs['n']} "
        f"from {syncs['where']}; launches {counts} ({smi})")
    want = {"hessian_accum": XLSTM_PRUNE_PACKED * XLSTM_CALIB_SHARDS,
            "flash_attn": 0, "nm_select": XLSTM_PRUNE_PACKED}
    for k, n in want.items():
        if counts[k] != n:
            fail(f"phase 14d: {counts[k]} {k} launches, expected {n}")
    if syncs["n"] > 1:
        fail(f"phase 14d: {syncs['n']} host syncs in the pipelined run")
    if len(reports) != XLSTM_PRUNE_PACKED or any(
            abs(r.sparsity - 0.5) > 1e-6 for r in reports):
        fail(f"phase 14d: {len(reports)} reports, or a sparsity other than "
             "0.5")
    bad = [f"{i}.{sub}.{key}" for i, lp in enumerate(pruned["layers"])
           for sub, key in model.block_linears() if sub in lp
           if not bool(((lp[sub][key].T.reshape(-1, 4) != 0).sum(-1)
                        <= 2).all())]
    if bad:
        fail(f"phase 14d: not 2:4 after MS: {bad}")
    pruned_ppl = launch_prune.eval_ppl(model, pruned, ev)
    say(f"  perplexity on 2 x 4 x 512 random tokens: dense {dense_ppl:.2f}, "
        f"MS 2:4 {pruned_ppl:.2f} (random weights: no gate)")
    if not (math.isfinite(dense_ppl) and math.isfinite(pruned_ppl)):
        fail("phase 14d: non-finite perplexity")
    out = dict(wall_s=wall, s_per_layer=wall / layers, hbm_gib=hbm / 2**30,
               syncs=syncs["n"], launches=counts, dense_ppl=dense_ppl,
               pruned_ppl=pruned_ppl)
    del pruned, params, model, calib
    torch.cuda.empty_cache()
    work = ROOT / "build" / "phase14"
    if work.exists():
        import shutil
        shutil.rmtree(work)
    text = _train(["--arch", "xlstm-350m", "--steps", "3", "--batch", "4",
                   "--seq", "256", "--ckpt-every", "3", "--out",
                   str(work / "train")], label="phase 14d")
    m = re.search(r"loss (\S+) -> (\S+); ([\d.]+) ms a step", text)
    if not m or not all(math.isfinite(float(x)) for x in m.groups()[:2]):
        fail(f"phase 14d: no finite training summary in {text!r}")
    out["train"] = dict(first_loss=float(m.group(1)),
                        last_loss=float(m.group(2)),
                        ms_per_step=float(m.group(3)))
    say(f"  trainer, 3 steps at 4 x 256: loss {m.group(1)} -> {m.group(2)}, "
        f"{m.group(3)} ms a step (median) ({smi})")
    return counts, out


def xlstm_phase(smi, parts="abcd"):
    """Phase 14 (those of ``parts``): returns the launches of the serving
    and pruning runs and the phase's numbers."""
    import torch

    out = {}
    serve_counts = {k: 0 for k in SERVE_KERNELS}
    prune_counts = {k: 0 for k in PRUNE_KERNELS}
    t = time.monotonic()
    if "a" in parts:
        say("  14a: one f32 period at full width served, and the SMOKE "
            "pruned MS 2:4, kernels against plain")
        out["f32"] = xlstm_f32_plain()
        say(f"  14a took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "b" in parts or "c" in parts:
        t = time.monotonic()
        say("  14b: xlstm-350m served at full width and depth, bf16, "
            "2:4-packed")
        c, model, packed, out["serve"] = xlstm_serve(smi)
        for k in serve_counts:
            serve_counts[k] += c[k]
        say(f"  14b took {time.monotonic() - t:.1f} s")
        if "c" in parts:
            t = time.monotonic()
            c, out["long"] = xlstm_long(model, packed, smi)
            for k in serve_counts:
                serve_counts[k] += c[k]
            say(f"  14c took {time.monotonic() - t:.1f} s")
        del model, packed
        torch.cuda.empty_cache()
    if "d" in parts:
        t = time.monotonic()
        say("  14d: xlstm-350m pruned MS 2:4 through the pipelined engine; "
            "three trainer steps")
        prune_counts, out["prune"] = xlstm_prune(smi)
        say(f"  14d took {time.monotonic() - t:.1f} s")
    return serve_counts, prune_counts, out


# ----------------------------------------------------------------------
# phase 15: the prefix-LM and the encoder-decoder — paligemma-3b and
# seamless-m4t-large-v2
# ----------------------------------------------------------------------
FRONTEND_ARCHS = ("paligemma_3b", "seamless_m4t_large_v2")
PALI_PREFIXES = (1, 63, 64, 65, 256, 320)  # 1e: prefix_len at T 320 (256
                                     # image + 64 text positions): inside
                                     # a key tile, on its edges, the image,
                                     # the whole sequence
CROSS_SHAPES = ((1, 1024), (64, 1024), (200, 129), (1024, 1024))
                                     # 1e: non-causal (T, S) at seamless's
                                     # 16 / 16 heads, hd 64: one decoder
                                     # token, the 64-token prefill's cross-
                                     # attention, ragged tiles, the encoder
FRONTEND_LINEARS = (                 # 1e: (name, M, K, N) at the new widths
    ("paligemma mlp.wo", 8, 16384, 2048),
    ("paligemma mlp.wo", 8 * 320, 16384, 2048),
    ("seamless mlp.wi", 8, 1024, 8192),
    ("seamless mlp.wi", 8 * 1024, 1024, 8192),
    ("seamless xattn.wk", 8 * 1024, 1024, 1024),
)
FRONTEND_PRUNE = {"paligemma_3b": dict(num_layers=2),  # 15c: 2 of 18
                  "seamless_m4t_large_v2": dict(num_layers=2,
                                                enc_layers=2)}
                                     # 15d: 2 + 2 of 24 + 24
FRONTEND_FEATS_SEED = 15


def _prefix_pairs(t, prefix):
    """(query, key) pairs a causal attention with a bidirectional prefix
    computes: query t sees max(t + 1, prefix) keys."""
    return sum(max(i + 1, prefix) for i in range(t))


def check_flash_frontend(gen, rows):
    """1e: flash_attn with the prefix-LM's bidirectional prefix and with
    S ≠ T (cross-attention), against flash_attn_plain in f32 and bf16:
    PALI_PREFIXES at PaliGemma's (8, 320, 8, 1, 256) and at hd 64 with
    G 1 and 2 (B 2, H 4); CROSS_SHAPES at seamless's 16 / 16 heads, hd
    64, B 8.  Each row asserts its route and the same bits from a second
    call; the bf16 rows at PaliGemma's and seamless's shapes are timed
    beside masked SDPA (the prefix's mask on the efficient backend; k / v
    expanded to H heads) and the bound over the pairs the mask leaves."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain

    cases = [(8, 320, 8, 1, 256, p, None) for p in PALI_PREFIXES]
    cases += [(2, 320, 4, kv, 64, p, None) for kv in (4, 2)
              for p in PALI_PREFIXES]
    cases += [(8, t, 16, 16, 64, None, s) for t, s in CROSS_SHAPES]
    timed, n0 = [], len(rows)
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        want_route = "f32 FMA" if dtype == torch.float32 else "tensor cores"
        tol_rel = (KERNEL_TOL_REL if dtype == torch.float32
                   else BF16_KERNEL_TOL_REL)
        for b, t, h, kv, hd, prefix, s in cases:
            q = torch.randn(b, t, h, hd, generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn(b, s or t, kv, hd, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            causal = s is None
            args = (q, k, v, causal, None, prefix)
            got = flash_attn(*args)
            route = flash_attn.last_kernel
            same = bool(torch.equal(got, flash_attn(*args)))
            want = flash_attn_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = tol_rel * max(1.0, want.abs().max().item())
            shape = (f"B={b} T={t} H={h} KV={kv} hd={hd} {dname} "
                     + (f"prefix={prefix}" if causal else f"S={s} full"))
            row = dict(kernel="flash_attn", shape=shape, max_abs_err=err,
                       tol=tol, ok=err <= tol and route == want_route
                       and same, route=route, deterministic=same)
            rows.append(row)
            del got, want
            if dtype == torch.bfloat16 and (hd == 256 or not causal):
                ms = device_ms(flash_attn, [args])
                plain_ms = device_ms(flash_attn_plain, [args], n=5, reps=3)
                g = h // kv
                sdpa = [(q.transpose(1, 2),
                         k.repeat_interleave(g, dim=2).transpose(1, 2),
                         v.repeat_interleave(g, dim=2).transpose(1, 2))]
                if causal:
                    pos = torch.arange(t, device="cuda")
                    mask = ((pos[None, :] <= pos[:, None])
                            | (pos[None, :] < prefix))

                    def lib(a, b_, c, mask=mask):
                        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                            return F.scaled_dot_product_attention(
                                a, b_, c, attn_mask=mask)
                    pairs = _prefix_pairs(t, min(prefix, t))
                else:
                    def lib(a, b_, c):
                        return F.scaled_dot_product_attention(a, b_, c)
                    pairs = t * s
                lib_ms = device_ms(lib, sdpa)
                n_bytes = ((b * t * h * hd + 2 * b * (s or t) * kv * hd) * 2
                           + b * t * h * hd * 4)
                b_ms, b_by = bound(n_bytes, 4.0 * b * h * hd * pairs,
                                   "bfloat16")
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, pairs=pairs)
                timed.append(row)
                say(f"  flash_attn      {shape:46s} ({route}) err {err:.3e} "
                    f"tol {tol:.3e} {'ok' if row['ok'] else 'FAIL'}  ms "
                    f"{ms:.5f} plain {plain_ms:.5f} lib {lib_ms:.5f} bound "
                    f"{b_ms:.5f} ({b_by}, {pairs} pairs a head)")
                del sdpa
            else:
                LOG.append(f"  flash_attn      {shape:46s} err {err:.3e} tol "
                           f"{tol:.3e} ({route}) same bits {same} "
                           f"{'ok' if row['ok'] else 'FAIL'}")
            del q, k, v
    new = rows[n0:]
    say(f"  flash_attn      {len(new)} cases with a prefix (1/63/64/65/256/"
        f"320 at T 320: hd 256 G 8, hd 64 G 1/2) or S != T (non-causal "
        f"(T, S) {list(CROSS_SHAPES)}), f32 and bf16: "
        f"{sum(r['ok'] for r in new)} ok, worst err/tol "
        f"{max(r['max_abs_err'] / r['tol'] for r in new):.3e}")
    torch.cuda.empty_cache()
    return timed


def check_frontend_widths(gen, rows):
    """1e: nm_spmm_decode / nm_spmm at FRONTEND_LINEARS (PaliGemma's
    mlp.wo, K 16384, at decode and the 8 x 320 prefill; seamless's mlp.wi
    and xattn.wk at decode and over the 8 x 1024 frames) beside
    torch.matmul."""
    out = {"nm_spmm_decode": [], "nm_spmm": []}
    for name, m, k, n in FRONTEND_LINEARS:
        row = nm_row(gen, m, name, k, n, False, None)
        rows.append(row)
        out[row["kernel"]].append(row)
    return out


def _frontend(arch, dtype=None, device="cuda", **cut):
    """``arch``'s published config (cut where ``cut`` says, in ``dtype``
    where given) and its model on ``device`` (the card)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(get_config(arch), **cut,
                              **({"dtype": dtype} if dtype else {}))
    return cfg, LM(cfg, device=device)


def _frontend_feats(cfg, b, seed):
    """(b, frontend_len, frontend_dim) stub features from a seeded
    torch.Generator on the card: 0.25 × normals, in bf16, as the
    reference's pipeline draws them."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return (0.25 * torch.randn(b, cfg.frontend_len, cfg.frontend_dim,
                               generator=g, device="cuda")
            ).to(torch.bfloat16)


def frontend_serve(arch, smi):
    """15a / 15b: ``arch`` at full width and depth, bf16, random init from
    a seeded torch.Generator, magnitude 2:4 on its attention (self and
    cross, the encoder's too) and MLP linears, packed by the engine,
    served static (continuous asked): phase 3's 8 greedy requests (64-id
    prompts, 32 new) with (8, F, fd) features through ``extra_batch`` —
    with the kernels (timed, then profiled) and under the plain override,
    and with other features.  Gates: the engine serves static; the f32
    twin (the same weights upcast) with the kernels against plain —
    first-step logits within LOGIT_TOL, streams equal except at near
    ties (LOGIT_TOL); the bf16 partings are reported beside the f32
    twin (``_bf16_partings``); other features move the first-step logits
    by more than LOGIT_TOL; flash_attn, nm_spmm and nm_spmm_decode
    launched; the encoder-decoder's cross K / V written at the prefill
    and left as they were by the 32 decode steps (no tiled nm_spmm after
    the prefill)."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import count_packed

    tag = "phase 15a" if arch == "paligemma_3b" else "phase 15b"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, model = _frontend(arch)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = model.init(g)
    layers = list(params["layers"]) + list(
        params.get("enc", {}).get("layers", []))
    prune_linears({"layers": layers}, "2:4",
                  linears=(("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                           ("attn", "wo"), ("xattn", "wq"), ("xattn", "wk"),
                           ("xattn", "wv"), ("xattn", "wo"), ("mlp", "wi"),
                           ("mlp", "wg"), ("mlp", "wo")))
    del layers
    feats = _frontend_feats(cfg, 8, FRONTEND_FEATS_SEED)
    other = _frontend_feats(cfg, 8, FRONTEND_FEATS_SEED + 1)
    off = model.prefix_len or 0
    kw = dict(max_batch=8, max_len=off + 64 + 32)
    eng = ServeEngine(model, params, **kw,
                      extra_batch={"frontend_feats": feats})
    del params
    params = eng.params
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    n_packed = count_packed(params)
    per_dec = 10 if cfg.encdec else 7
    want_packed = per_dec * cfg.num_layers + 6 * cfg.enc_layers
    say(f"  {cfg.name}: {cfg.num_layers} layers"
        + (f" + {cfg.enc_layers} encoder layers" if cfg.encdec else "")
        + f", d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} "
        f"heads, hd {cfg.hd}, frontend {cfg.frontend} ({cfg.frontend_len} x "
        f"{cfg.frontend_dim}); init + 2:4 + packing "
        f"{time.monotonic() - t0:.1f} s; params {n_bytes / 2**30:.3f} GiB, "
        f"{n_packed} packed leaves ({smi})")
    if n_packed != want_packed:
        fail(f"{tag}: {n_packed} packed leaves, expected {want_packed}")
    if eng.mode != "static" or eng.config.mode != "continuous":
        fail(f"{tag}: served {eng.mode!r} (asked {eng.config.mode!r})")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=64,
                                               dtype=np.int32),
                    max_new_tokens=32) for i in range(8)]
    out = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()                       # the path starts
    t1 = time.monotonic()
    res = eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.monotonic() - t1
    counts = ops.launch_counts()                    # ... and ends
    _check_streams(tag, reqs, res, cfg.vocab_size)
    toks = sum(len(r.tokens) for r in res)
    hbm = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)
    bf16 = _streams(res)
    say(f"  8 requests, static: {toks} tokens in {dt:.3f} s = "
        f"{toks / dt:.2f} tok/s; host syncs {st['host_syncs']}; launches "
        f"{counts}; HBM held {hbm / 2**30:.3f} GiB")
    # the prefill's: every encoder layer, and a decoder block's self- and
    # cross-attention; the prefix-LM's layers once
    want_flash = (cfg.enc_layers + 2 * cfg.num_layers if cfg.encdec
                  else cfg.num_layers)
    if counts["flash_attn"] != want_flash:
        fail(f"{tag}: {counts['flash_attn']} flash_attn launches, expected "
             f"{want_flash} (the prefill's)")
    for k in ("nm_spmm", "nm_spmm_decode"):
        if counts[k] <= 0:
            fail(f"{tag}: kernel {k} was not launched")
    # the same run again, each step's logits recorded (a host copy a step:
    # untimed), the bucket's cache kept
    rec = Recorder(model)
    recorded = _streams(ServeEngine(rec, params, **kw, extra_batch={
        "frontend_feats": feats}).generate(reqs))
    if not _same(recorded, bf16):
        fail(f"{tag}: the recorded run's streams differ from the timed run's")
    first = rec.calls[0]
    if cfg.encdec:
        kept = all(torch.equal(c["xk"], xk) and torch.equal(c["xv"], xv)
                   for c, (xk, xv) in zip(
                       [c for c in rec.cache if "xk" in c], rec.cross))
        filled = all(xk.abs().amax().item() > 0 for xk, _ in rec.cross)
        tiled = ops.launch_counts()["nm_spmm"]
        if not (kept and filled) or tiled != rec.tiled_at_prefill:
            fail(f"{tag}: the cross K / V were not filled at the prefill "
                 "alone (changed in decode, left zero, or recomputed)")
        say(f"  cross K / V: {len(rec.cross)} layers x 2 x "
            f"{tuple(rec.cross[0][0].shape)} written at the prefill, equal "
            "after the 32 decode steps; no tiled nm_spmm after the prefill")
        rec.cache = rec.cross = None
    # other features move the served logits
    o_rec = Recorder(model)
    ServeEngine(o_rec, params, **kw, extra_batch={
        "frontend_feats": other}).generate(reqs)
    moved = (o_rec.calls[0] - first).abs().max().item()
    say(f"  other {cfg.frontend} features: the first-step logits move by "
        f"{moved:.3e}")
    if moved <= LOGIT_TOL:
        fail(f"{tag}: other frontend features moved the logits by "
             f"{moved:.3e} <= {LOGIT_TOL:g}")
    # the plain route, bf16
    p_rec = Recorder(model)
    with ops.override_dispatch(plain=True):
        plain = _streams(ServeEngine(p_rec, params, **kw, extra_batch={
            "frontend_feats": feats}).generate(reqs))
    bf16_gap = (p_rec.calls[0] - first).abs().max().item()
    # the f32 twin, kernels against plain: the gate
    cfg32, model32 = _frontend(arch, "float32")
    params32 = _upcast(params)
    twin = {}
    for label in ("kernels", "plain"):
        r32 = Recorder(model32)
        e32 = ServeEngine(r32, params32, **kw, extra_batch={
            "frontend_feats": feats})
        with ops.override_dispatch(plain=label == "plain"):
            twin[label] = (_streams(e32.generate(reqs)), r32.calls[0])
    gap32 = (twin["kernels"][1] - twin["plain"][1]).abs().max().item()
    say(f"  first-step logits, kernels against plain: f32 twin {gap32:.3e} "
        f"(tol {LOGIT_TOL:g}), bf16 {bf16_gap:.3e} (reported) at logits of "
        f"{first.abs().max().item():.3g}")
    if gap32 > LOGIT_TOL:
        fail(f"{tag}: f32 first-step logits differ by {gap32:.3e}")
    parted32 = _first_divergence(model32, params32, reqs, twin["plain"][0],
                                 twin["kernels"][0], LOGIT_TOL,
                                 f"{tag} f32 kernels vs plain", feats=feats)
    parted, explained = _bf16_partings(
        model, params, model32, params32, reqs, plain, bf16,
        f"{tag} bf16 kernels vs plain", feats=feats)
    say(f"  kernels vs plain: f32 {len(reqs) - parted32}/{len(reqs)} streams "
        f"equal (the rest part at near ties); bf16 {len(reqs) - parted}/"
        f"{len(reqs)}, {explained} of the {parted} partings within the bf16 "
        "forward's own error")
    del params32, model32, twin
    torch.cuda.empty_cache()
    say("  the profiled run: the 8 requests, static")
    prof = profile_main(eng, reqs)
    out.update(tok_s=toks / dt, wall_s=dt, stats=st, hbm_gib=hbm / 2**30,
               params_gib=n_bytes / 2**30, packed=n_packed, launches=counts,
               flash_launches=counts["flash_attn"], moved=moved,
               first_gap_f32=gap32, first_gap_bf16=bf16_gap,
               parted_f32=parted32, parted_bf16=parted, explained=explained,
               profile=prof, idle=1 - prof["busy_s"] / prof["wall_s"],
               kernels_a_step=prof["kernels"] / max(1, st["device_steps"]))
    del eng, rec, o_rec, p_rec, params, model
    torch.cuda.empty_cache()
    return counts, out


def frontend_prune(arch, smi):
    """15c / 15d: ``launch.prune.prune`` with the launcher's default
    engine (pipelined), MS 2:4 at blocksize 128, on ``arch`` at full width
    cut to FRONTEND_PRUNE's depth, 128 x 2048 random ids and their
    frontend features from ``load_tokens``'s generator (PaliGemma's text
    1792 ids after its 256 image positions; seamless's 2048 ids over 1024
    frames); then the serial engine on the same calibration.  Gates: the
    pipelined run's launches a segment (hessian_accum one a linear,
    nm_select one a linear, flash_attn 2 an encoder or prefix-LM layer and
    4 a decoder layer: capture and propagate), at most 1 host sync, every
    linear 2:4 at sparsity 0.5; against the serial run: the first
    segment's masks MASK_AGREE_MIN equal and every linear's
    reconstruction error within LAYER_ERR_REL, the total within
    PIPE_TOTAL_ERR_REL.  Seconds a layer, HBM, perplexity before and
    after on 4 x 512 random ids (a prefix-LM's 256 image positions
    among them)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune
    from repro_torch.serve.sparse import is_24_sparse

    tag = "phase 15c" if arch == "paligemma_3b" else "phase 15d"
    cut = FRONTEND_PRUNE[arch]
    cfg, model = _frontend(arch, **cut)
    params = launch_prune.load_params(model, None, seed=0)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0, cfg=cfg)
    ev, _ = launch_prune.load_tokens(None, cfg.vocab_size, 4, 512, "cuda",
                                     seed=2, cfg=cfg)
    dense_ppl = launch_prune.eval_ppl(model, params, ev)
    pipeline = launch_prune.build_parser().get_default("pipeline")
    segs = model.prunable_segments()
    n_lin = sum(len(s.linears) for s in segs)
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                       # the prune path starts
    t0 = time.monotonic()
    with count_syncs(syncs):
        pruned, reports = launch_prune.prune(
            model, params, calib, "2:4", "MS", blocksize=128,
            row_chunk=PRUNE_ROW_CHUNK, pipeline=pipeline)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()                    # ... and ends
    hbm = torch.cuda.max_memory_allocated()
    n_seg = len(segs)
    say(f"  {cfg.name}, {n_seg} segments ({[s.name for s in segs]}), MS 2:4 "
        f"({pipeline}): {wall:.2f} s ({wall / n_seg:.3f} s a layer); HBM "
        f"held {hbm / 2**30:.3f} GiB; host syncs {syncs['n']} from "
        f"{syncs['where']}; launches {counts} ({smi})")
    n_dec = cfg.num_layers if cfg.encdec else 0
    want = {"hessian_accum": n_lin, "nm_select": n_lin,
            "flash_attn": 2 * n_seg + 2 * n_dec}
    for k, n in want.items():
        if counts[k] != n:
            fail(f"{tag}: {counts[k]} {k} launches, expected {n}")
    if syncs["n"] > 1:
        fail(f"{tag}: {syncs['n']} host syncs in the pipelined run "
             "(expected the final readback only)")
    off = [r.name for r in reports if abs(r.sparsity - 0.5) > 1e-6]
    if len(reports) != n_lin or off:
        fail(f"{tag}: {len(reports)} reports of {n_lin}; sparsity other "
             f"than 0.5 for {off[:4]}")
    specs = [(f"{s.name}.{lin.name}", s, lin) for s in segs
             for lin in s.linears]
    bad = [n for n, s, lin in specs
           if not is_24_sparse(lin.get(s.get_params(pruned)).T)]
    if bad:
        fail(f"{tag}: not 2:4 after MS: {bad[:4]}")
    pruned_ppl = launch_prune.eval_ppl(model, pruned, ev)
    t1 = time.monotonic()
    serial, s_reports = launch_prune.prune(
        model, params, calib, "2:4", "MS", blocksize=128,
        row_chunk=PRUNE_ROW_CHUNK, pipeline="off")
    torch.cuda.synchronize()
    s_wall = time.monotonic() - t1
    first = segs[0].name
    agree, worst_first = {}, 0.0
    for (name, s, lin), rp, rs in zip(specs, reports, s_reports):
        a = lin.get(s.get_params(pruned)) == 0
        b = lin.get(s.get_params(serial)) == 0
        agree[name] = (a == b).float().mean().item()
        rel = abs(rp.recon_error - rs.recon_error) / max(rs.recon_error,
                                                         1e-30)
        if name.startswith(first + "."):
            worst_first = max(worst_first, rel)
            if agree[name] < MASK_AGREE_MIN or rel > LAYER_ERR_REL:
                fail(f"{tag}: {name}: masks {agree[name]:.5f} equal, "
                     f"reconstruction error {rel:.3e} apart (pipelined "
                     "against serial)")
    tot_p = sum(r.recon_error for r in reports)
    tot_s = sum(r.recon_error for r in s_reports)
    tot_rel = abs(tot_p - tot_s) / max(tot_s, 1e-30)
    say(f"  serial engine: {s_wall:.2f} s ({s_wall / n_seg:.3f} s a layer); "
        f"pipelined against serial: {first}'s masks "
        f"{min(v for k, v in agree.items() if k.startswith(first + '.')):.5f}"
        f"+ equal, errors within {worst_first:.3e}; all masks "
        f"{min(agree.values()):.5f}+; total reconstruction error "
        f"{tot_p:.6g} against {tot_s:.6g} ({tot_rel:.3e} apart)")
    if tot_rel > PIPE_TOTAL_ERR_REL:
        fail(f"{tag}: total reconstruction errors {tot_rel:.3e} apart")
    say(f"  perplexity on 4 x 512 random ids: dense {dense_ppl:.2f}, MS "
        f"2:4 {pruned_ppl:.2f} (random weights: no gate)")
    if not (math.isfinite(dense_ppl) and math.isfinite(pruned_ppl)):
        fail(f"{tag}: non-finite perplexity")
    out = dict(segments=n_seg, wall_s=wall, s_per_layer=wall / n_seg,
               serial_wall_s=s_wall, hbm_gib=hbm / 2**30, syncs=syncs["n"],
               launches=counts, dense_ppl=dense_ppl, pruned_ppl=pruned_ppl,
               mask_agree_min=min(agree.values()), total_recon_rel=tot_rel)
    del pruned, serial, params, model, calib
    torch.cuda.empty_cache()
    return counts, out


def frontend_phase(smi, parts="abcde"):
    """Phase 15 (those of ``parts``): returns the launches of the serving
    and pruning runs and the phase's numbers (15e trains, launching no
    kernel: the trainer takes the differentiable route)."""
    import torch

    out = {}
    serve_counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    prune_counts = {k: 0 for k in PRUNE_KERNELS}
    for part, arch in zip("ab", FRONTEND_ARCHS):
        if part not in parts:
            continue
        t = time.monotonic()
        say(f"  15{part}: {arch} served static at full width and depth, "
            "bf16, 2:4-packed")
        c, out[f"serve {arch}"] = frontend_serve(arch, smi)
        for k in serve_counts:
            serve_counts[k] += c[k]
        say(f"  15{part} took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    for part, arch in zip("cd", FRONTEND_ARCHS):
        if part not in parts:
            continue
        t = time.monotonic()
        say(f"  15{part}: {arch} pruned MS 2:4, pipelined against serial")
        c, out[f"prune {arch}"] = frontend_prune(arch, smi)
        for k in prune_counts:
            prune_counts[k] += c[k]
        say(f"  15{part} took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "e" in parts:
        t = time.monotonic()
        say(f"  15e: {' and '.join(FRONTEND_ARCHS)} trained 3 steps at full "
            f"width, {FRONTEND_TRAIN_BATCH[0]} x {FRONTEND_TRAIN_BATCH[1]}")
        for arch in FRONTEND_ARCHS:
            out[f"train {arch}"] = frontend_train(arch, smi)
            torch.cuda.empty_cache()
        say(f"  15e took {time.monotonic() - t:.1f} s")
    return serve_counts, prune_counts, out


# ----------------------------------------------------------------------
# phase 15e: the two frontend archs trained on the card
# ----------------------------------------------------------------------
FRONTEND_TRAIN = {"paligemma_3b": dict(num_layers=16),  # 15e: 16 of 18
                  "seamless_m4t_large_v2": {}}  # (18 ran out of the card's
                                     # 80 GB: params, grads and AdamW's f32
                                     # moments with the update's copies);
                                     # seamless at full depth
FRONTEND_TRAIN_BATCH = (4, 256)      # 15e: 4 sequences of 256 text tokens


class _RandomBatches:
    """15e's training batches: token ids and stub features from a seeded
    torch.Generator on the card (both vocabularies make the synthetic
    corpus's (V, V) table 66 G entries), the features 0.25 × normals in
    bf16 as the reference's pipeline draws them."""

    def __init__(self, cfg, batch, seq, seed=0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def batch_at(self, step):
        import torch

        g = torch.Generator(device="cuda")
        g.manual_seed(1000 * self.seed + step)
        toks = torch.randint(0, self.cfg.vocab_size, (self.batch, self.seq),
                             generator=g, device="cuda", dtype=torch.int32)
        feats = (0.25 * torch.randn(self.batch, self.cfg.frontend_len,
                                    self.cfg.frontend_dim, generator=g,
                                    device="cuda")).to(torch.bfloat16)
        return {"tokens": toks, "labels": toks, "frontend_feats": feats}


def frontend_train(arch, smi):
    """15e: three trainer steps of ``arch`` at full width (the depth in
    FRONTEND_TRAIN: what AdamW's f32 moments leave room for on one card),
    4 × 256 text tokens with the stub's features, bf16 params from a seeded
    torch.Generator.  The Trainer's own step (the differentiable route,
    autograd, AdamW); its end-of-run checkpoint is skipped (the state is
    tens of GB).  Every loss finite."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    cfg, model = _frontend(arch, **FRONTEND_TRAIN[arch])
    b, t = FRONTEND_TRAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = AdamW(lr=warmup_cosine(1e-4, 1, 3))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        trainer = Trainer(model, opt, _RandomBatches(cfg, b, t),
                          TrainConfig(total_steps=3, global_batch=b,
                                      seq_len=t, ckpt_every=3, out_dir=out,
                                      log_every=1))
        trainer.init_state = lambda seed=0: (
            params, opt.init(params),
            torch.zeros((), dtype=torch.float32, device="cuda"))
        trainer._save = lambda *a: None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, info = trainer.run()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
    hbm = torch.cuda.max_memory_allocated() / 2**30
    secs = info["step_seconds"]
    say(f"  {arch}: {cfg.num_layers} of {get_config(arch).num_layers} layers"
        f"{' (+ ' + str(cfg.enc_layers) + ' encoder)' if cfg.encdec else ''}"
        f", {n_params / 1e9:.3f} B params, AdamW f32 moments; 3 steps at "
        f"{b} x {t}: losses {losses}; {[round(s, 3) for s in secs]} s a "
        f"step; HBM held {hbm:.2f} GiB ({smi})")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        fail(f"15e {arch}: losses {losses}")
    if info["skipped_steps"]:
        fail(f"15e {arch}: {info['skipped_steps']} steps skipped")
    return dict(layers=cfg.num_layers, params_b=n_params / 1e9,
                losses=losses, step_s=secs, hbm_gib=hbm)


# ----------------------------------------------------------------------
# phase 16: distribution — a 1-rank NCCL group, two ranks on one card
# ----------------------------------------------------------------------
DIST_LAYERS = 2                      # 16a / 16b: Qwen1.5-0.5B, 2 layers
DIST_W_TOL = 1e-3                    # |Δw| / max|w| of the mesh runs
DIST_LOSS_ABS = 1e-4                 # trainer losses, f32
DIST_TRAIN_REL = 1e-3                # 16b's trained params against one
DIST_TRAIN_ENTRY_ABS = 1e-5          # rank's: by norm, and at most
DIST_TRAIN_OUTLIERS = 1e-3           # DIST_TRAIN_OUTLIERS of the entries
                                     # past DIST_TRAIN_ENTRY_ABS — the mean
                                     # of two half-batch gradients rounds
                                     # apart from the whole batch's, and
                                     # AdamW's first steps move an entry
                                     # whose gradient is ≈ 0 by ≈ lr
DIST_TRAIN = dict(steps=3, batch=16, seq=64)


def _dist_prune(model, params, calib, mesh=None, calib_shard="auto"):
    """MM 2:4 through the prune launcher's engine (pipelined, as
    ``launch.prune.prune``), on ``mesh`` or the active context's; returns
    (pruned params, reports, wall seconds, launch counts)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import prune as launch_prune

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    pruned, reports = launch_prune.prune(
        model, params, calib, "2:4", "MM", blocksize=128,
        row_chunk=PRUNE_ROW_CHUNK, mesh=mesh, calib_shard=calib_shard)
    torch.cuda.synchronize()
    return pruned, reports, time.monotonic() - t0, ops.launch_counts()


def _dist_flat(model, params):
    """The pruned linears' weights (paper orientation) by name, on the
    host."""
    from repro_torch.core.pruner import LINEARS

    return {f"period{i}.{sub}.{key}": lp[sub][key].T.float().cpu()
            for i, lp in enumerate(params["layers"]) for sub, key in LINEARS}


def _dist_same(label, got, want, reports=None, want_reports=None):
    """Masks equal and weights within DIST_W_TOL of their scale."""
    import torch

    for name, w in want.items():
        g = got[name]
        if not torch.equal(g == 0, w == 0):
            fail(f"{label}: {name}'s mask differs from the mesh-less run's")
        err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        if err > DIST_W_TOL:
            fail(f"{label}: {name}'s weights {err:.3e} apart")
    if reports is not None:
        for r, q in zip(reports, want_reports):
            if abs(r.recon_error - q.recon_error) > 1e-3 * max(
                    abs(q.recon_error), 1e-12):
                fail(f"{label}: {r.name}'s error {r.recon_error} against "
                     f"{q.recon_error}")


def _dist_train(mesh=None, out=None, grad_compression=True, fsdp_axes=None):
    """DIST_TRAIN's steps of paper_tiny_lm (f32), on ``mesh``
    (data-parallel: FSDP over data by default, ``fsdp_axes=()``
    replicated) or one device: (losses, final params flat, info)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("paper_tiny_lm")
    model = LM(cfg, device="cuda")
    n, b, t = DIST_TRAIN["steps"], DIST_TRAIN["batch"], DIST_TRAIN["seq"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trainer = Trainer(model, AdamW(lr=warmup_cosine(1e-3, 1, n)),
                          DataPipeline(cfg, b, t, seed=0, mesh=mesh,
                                       device="cuda"),
                          TrainConfig(total_steps=n, global_batch=b,
                                      seq_len=t, ckpt_every=n,
                                      out_dir=out or tmp, log_every=1,
                                      grad_compression=grad_compression),
                          mesh=mesh, fsdp_axes=fsdp_axes)
        params, opt_state, info = trainer.run()
        params, _, _ = trainer.gather_state(params, opt_state)
        losses = None
        if os.path.exists(os.path.join(out or tmp, "metrics.jsonl")):
            with open(os.path.join(out or tmp, "metrics.jsonl")) as f:
                losses = [json.loads(line)["loss"] for line in f]
    flat = {k: torch.from_numpy(v.astype("float32"))
            for k, v in model.params_to_flat(params).items()}
    return losses, flat, info


def dist_one_rank(smi):
    """16a: a 1-rank NCCL group on the card (``--mesh host``).  The prune
    launcher's engine on Qwen1.5-0.5B at full width, DIST_LAYERS layers,
    MM 2:4 pipelined, with and without the mesh (masks equal, weights
    within DIST_W_TOL, each linear's error within 1e-3), and without it
    in two calibration shards (16b's 2x1 reference); hessian_allreduce,
    prune_matrix_sharded and compressed_psum called over the group at
    ``mlp.wo``'s shape (1024 x 2816, H 2816²), the all-reduce timed; three
    paper_tiny_lm trainer steps with grad_compression on the mesh against
    without, and without compression on one rank for 16b.  Returns (the
    mesh run's launches, numbers, the mesh-less prunes' weights, the
    one-rank trainer's params and losses, for 16b)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import (hessian_allreduce,
                                              prune_matrix_sharded)
    from repro_torch.core.pruner import prune_matrix
    from repro_torch.dist import comm, mesh_context
    from repro_torch.launch import prune as launch_prune
    from repro_torch.optim.compression import compressed_psum

    out = {}
    cfg, model, params = _qwen(DIST_LAYERS)
    calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                        "cuda", seed=0)
    with torch.no_grad():
        plain, plain_rep, plain_s, _ = _dist_prune(model, params, calib)
        want = _dist_flat(model, plain)
        # the same calibration in two shards, merged on the one device:
        # 16b's 2x1 run computes exactly this across its two ranks
        two, _, _, _ = _dist_prune(model, params, calib, calib_shard=2)
        want_two = _dist_flat(model, two)
        del two
        with mesh_context("host", "cuda") as ctx:
            backend = dist.get_backend()
            meshed, rep, mesh_s, counts = _dist_prune(model, params, calib)
            say(f"  host mesh {tuple(ctx.mesh.shape)} {ctx.mesh.mesh_dim_names}"
                f" over a {dist.get_world_size()}-rank {backend} group: "
                f"{mesh_s / DIST_LAYERS:.3f} s a layer against "
                f"{plain_s / DIST_LAYERS:.3f} without a mesh ({smi}); "
                f"launches {counts}")
            if backend != "nccl":
                fail(f"16a: the card's group is {backend}, not nccl")
            for name in PRUNE_KERNELS:
                if counts[name] <= 0:
                    fail(f"16a: {name} was not launched on the mesh's prune")
            _dist_same("16a", _dist_flat(model, meshed), want, rep,
                       plain_rep)
            say(f"  16a: {len(want)} masks equal to the mesh-less run's, "
                f"weights within {DIST_W_TOL:g}")
            # the collectives at mlp.wo's shape
            g = torch.Generator(device="cuda")
            g.manual_seed(16)
            w = torch.randn(1024, 2816, generator=g, device="cuda")
            x = torch.randn(8192, 2816, generator=g, device="cuda")
            h = 2.0 * (x.T @ x) / x.shape[0]
            group = comm.group_of(ctx.mesh, "data")
            merged = hessian_allreduce(ctx.mesh, h, 8192.0, "data")
            herr = float((merged - h).abs().max() / h.abs().max())
            if herr > 1e-6:
                fail(f"16a: hessian_allreduce over one rank {herr:.3e} off")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            reps = 20
            start.record()
            for _ in range(reps):
                hessian_allreduce(ctx.mesh, h, 8192.0, "data")
            stop.record()
            torch.cuda.synchronize()
            ar_ms = start.elapsed_time(stop) / reps
            w_sh, m_sh = prune_matrix_sharded(w, h, "2:4", ctx.mesh,
                                              method="MM", blocksize=128,
                                              row_chunk=PRUNE_ROW_CHUNK)
            ref = prune_matrix(w, h, "2:4", method="MM", blocksize=128,
                               row_chunk=PRUNE_ROW_CHUNK, row_balanced=True)
            if not torch.equal(m_sh, ref.mask):
                fail("16a: prune_matrix_sharded's mask differs from "
                     "prune_matrix(row_balanced=True)'s")
            werr = float((w_sh - ref.w).abs().max() / ref.w.abs().max())
            flat = w.reshape(-1)
            cp = compressed_psum(flat, group)
            step = float(flat.abs().max()) / 127.0
            cerr = float((cp - flat).abs().max())
            if cerr > step:
                fail(f"16a: compressed_psum {cerr:.3e} off, step {step:.3e}")
            say(f"  16a collectives at mlp.wo (1024 x 2816): "
                f"hessian_allreduce (H 2816², f32) {ar_ms:.4f} ms a call, "
                f"{herr:.2e} from H; prune_matrix_sharded masks equal, "
                f"weights {werr:.2e} apart; compressed_psum within "
                f"{cerr:.3e} (one int8 step {step:.3e}) ({smi})")
            losses_mesh, _, _ = _dist_train(ctx.mesh)
        dist.destroy_process_group()
        losses, _, _ = _dist_train()
        # 16b's data-parallel steps are held against these
        losses_one, flat_one, _ = _dist_train(grad_compression=False)
    for a, b in zip(losses_mesh, losses):
        if abs(a - b) > DIST_LOSS_ABS:
            fail(f"16a: trainer losses {losses_mesh} against {losses}")
    say(f"  16a trainer, paper_tiny_lm, {DIST_TRAIN['steps']} steps with "
        f"grad_compression: losses {losses_mesh} on the mesh, {losses} "
        "without")
    out.update(s_per_layer=mesh_s / DIST_LAYERS,
               plain_s_per_layer=plain_s / DIST_LAYERS,
               allreduce_ms_m2816=ar_ms, losses=losses_mesh,
               plain_losses=losses)
    return counts, out, (want, want_two), flat_one, losses_one


# 16c: tensor-parallel serving on 16b's two ranks (a 1x2 mesh, gloo)
TP_LINEARS = (                       # 16c's rank-local packed linears at tp 2
    ("tp2 qwen1.5 attn.wq", 1024, 512, True, None),   # wk, wv: the same
    ("tp2 qwen1.5 attn.wo", 512, 1024, False, None),  # row-parallel
    ("tp2 qwen1.5 mlp.wi", 1024, 1408, False, None),
    ("tp2 qwen1.5 mlp.wg", 1024, 1408, False, "silu"),
    ("tp2 qwen1.5 mlp.wo", 1408, 1024, False, None),  # row-parallel
    ("tp2 qwen3 attn.wq", 5120, 2560, False, None),
    ("tp2 qwen3 attn.wk", 5120, 512, False, None),    # wv: the same
    ("tp2 qwen3 attn.wo", 2560, 5120, False, None),   # row-parallel
    ("tp2 qwen3 mlp.wi", 5120, 8704, False, None),
    ("tp2 qwen3 mlp.wg", 5120, 8704, False, "silu"),
    ("tp2 qwen3 mlp.wo", 8704, 5120, False, None),    # row-parallel
)
TP_PAGED = (                         # (label, B, KV, G, hd): 16c's decode
    ("tp2 qwen1.5 B=8 KV=8 G=1 hd=64", 8, 8, 1, 64),  # steps on a rank's
    ("tp2 qwen3 B=8 KV=4 G=5 hd=128", 8, 4, 5, 128),  # pool (page 16,
)                                    # 8 pages a row: 64 + 32 tokens)
TP_FLASH = (("qwen1.5", 8, 8, 64), ("qwen3", 20, 4, 128))
                                     # (model, H, KV, hd) a rank's heads of
                                     # a static prefill, B 8, T 64
TP_FAMILY_PAGED = (("tp2 jamba B=8 KV=4 G=8 hd=128", 8, 4, 8, 128),)
TP_FAMILY_FLASH = (("jamba", 32, 4, 128), ("phi3.5", 16, 4, 128))
TP_QWEN3_LAYERS = 2                  # 16c: Qwen3-14B, 2 of its 40 layers
TP_SERVE = dict(max_batch=8, max_len=128, page_size=16, prefill_chunk=32)
TP_CASES = (                         # (label, arch, layers, dtype, modes)
    ("qwen1.5-0.5b bf16", "qwen1.5-0.5b", DIST_LAYERS, "bfloat16",
     ("continuous", "static")),
    ("qwen1.5-0.5b f32", "qwen1.5-0.5b", DIST_LAYERS, "float32",
     ("continuous", "static")),
    ("qwen3-14b bf16", "qwen3-14b", TP_QWEN3_LAYERS, "bfloat16",
     ("continuous",)),
)
MOE_TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"   # 16b: its SMOKE config, 3 steps
TP_JAMBA_SLOTS = 4                   # 16d: Jamba's first 4 slots (3 Mamba
TP_XLSTM_LAYERS = 8                  # and the attention); xlstm-350m's
TP_PHI_LAYERS = 2                    # first period (7 mLSTM, the sLSTM at
                                     # slot 3); phi3.5-moe 2 of 32 layers
TP_FAMILY_CASES = (                  # (label, model, dtype, mode)
    ("jamba-blocks bf16", "jamba", "bfloat16", "continuous"),
    ("jamba-blocks f32", "jamba", "float32", "continuous"),
    ("xlstm-350m bf16", "xlstm", "bfloat16", "continuous"),
    ("xlstm-350m f32", "xlstm", "float32", "continuous"),
    ("phi3.5-moe bf16", "phi", "bfloat16", "static"),
    ("phi3.5-moe f32", "phi", "float32", "static"),
)
TP_FAMILY_NEED = {                   # 16d: the kernels each rank launches
    "jamba": ("nm_spmm_decode", "paged_attn"),
    "xlstm": ("nm_spmm_decode",),
    "phi": ("nm_spmm_decode", "flash_attn", "nm_spmm"),
}
TP_BYTES_RATIO = 0.6                 # 16d: a rank's bytes / one device's


@functools.lru_cache(maxsize=None)
def tp_family_linears(tp=2):
    """16d's rank-local packed linears, one row a distinct (K, N, fused
    activation): each model of TP_FAMILY_CASES initialised on the meta
    device from a threefry key there (shapes only: no draw, no memory —
    a CPU generator would draw every weight), its linears packed as
    ``_packed_every_linear`` packs them and split as
    ``dist.sharding.param_split`` splits them for one rank of ``tp`` —
    the rule the engine shards by, so no shape a rank runs is left out.
    Rows as TP_LINEARS': (label, K, N, bias, activation)."""
    from repro_torch import random as rnd
    from repro_torch.dist.sharding import param_split
    from repro_torch.serve.sparse import (DEFAULT_SPARSE_PATTERNS,
                                          linear_patterns)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}" if path else k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    found = {}
    for kind in dict.fromkeys(c[1] for c in TP_FAMILY_CASES):
        cfg, model = _tp_family_model(kind, "bfloat16", device="meta")
        pats = DEFAULT_SPARSE_PATTERNS + linear_patterns(
            model.block_linears())
        for path, w in leaves(model.init(rnd.key(0, device="meta"))):
            if w.ndim != 2 or not any(re.search(p, path) for p in pats):
                continue
            k, n = w.shape
            dim = param_split(f"{path}/vals", (k // 2, n), tp, cfg)
            k, n = (k // tp, n) if dim == 0 else (k, n // tp) if dim else (
                k, n)
            sub, key = path.split("/")[-2:]
            act = "silu" if (sub, key) == ("mlp", "wg") else None
            found.setdefault((k, n, act), f"tp{tp} {kind} {sub}.{key}")
    return tuple((label, k, n, False, act)
                 for (k, n, act), label in found.items())


def _unheld_shapes(routes, linears):
    """The packed shapes ("K x N") of a rank's ``routes`` that phase 1t
    holds against no plain kernel: none of ``linears``' (K, N)."""
    held = {f"{lin[1]} x {lin[2]}" for lin in linears}
    return sorted(set(routes) - held)


def check_tp_widths(gen, rows):
    """16c's rank-local shapes, each against its plain version in f32 and
    bf16 at KERNEL_TOL_REL (flash_attn's bf16 at BF16_KERNEL_TOL_REL, as
    in every flash_attn row) with its route asserted: nm_spmm_decode (M 8,
    a decode step; bias and silu where the path fuses them) and nm_spmm
    (M 256) at TP_LINEARS, timed at ``mlp.wi``; paged_attn at TP_PAGED (bf16 pages,
    ragged lengths over 8 pages of 16, the 16-byte-copy route); flash_attn
    at TP_FLASH, causal (the tensor cores for bf16, the f32 FMA kernel
    for f32), the same bits from a second call.  16d's shapes beside
    them: ``tp_family_linears`` (every packed shape a rank of Jamba's
    slots, xlstm-350m or phi3.5 runs), TP_FAMILY_PAGED (Jamba's
    attention slot on its 4 KV heads) and TP_FAMILY_FLASH; 16e's:
    ``tp_frontend_linears`` (every packed shape a rank of PaliGemma or
    seamless runs, at the M of its prefill and its decode steps; timed
    at ``mlp.wi``, a rank's widest linear, the others checked only) and
    TP_FRONTEND_FLASH (PaliGemma's 4 of 8 heads on its one KV head with
    the 256-position prefix; seamless's encoder, cross-attention and
    decoder on 8 of 16 heads)."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain

    out = {"nm_spmm_decode": [], "nm_spmm": []}
    family = tp_family_linears()
    for m in (8, 256):
        for lin in (*TP_LINEARS, *family):
            # checked, and timed at a rank's widest linear, mlp.wi (the
            # others' times hold within 2 % from run to run)
            row = nm_row(gen, m, *lin, timed=lin[0].endswith("mlp.wi"))
            rows.append(row)
            out[row["kernel"]].append(row)
    for label, m, k, n, act in tp_frontend_linears():
        # checked, and timed where a rank's widest linear runs
        row = nm_row(gen, m, label, k, n, False, act,
                     timed=label.endswith("mlp.wi"))
        rows.append(row)
        out[row["kernel"]].append(row)
    lengths = [96, 70, 65, 81, 64, 90, 77, 88]
    paged = paged_rows(gen, rows, [(label, b, kvh, g, hd, 16, 8, lengths,
                                    None, False, 0)
                                   for label, b, kvh, g, hd
                                   in (*TP_PAGED, *TP_FAMILY_PAGED)])
    for row in paged.values():
        if row["route"] != "16-byte copies":
            row["ok"] = False
            say(f"  paged_attn      {row['shape']}: route {row['route']}, "
                "not 16-byte copies FAIL")
    out["paged_attn"] = list(paged.values())
    out["flash_attn"] = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        want_route = _route_of(dtype)
        tol_rel = (KERNEL_TOL_REL if dtype == torch.float32
                   else BF16_KERNEL_TOL_REL)
        for model, h, kv, hd in (*TP_FLASH, *TP_FAMILY_FLASH):
            q, k, v = _flash_inputs(gen, 8, 64, h, kv, hd, dtype)
            got = flash_attn(q, k, v, True)
            route = flash_attn.last_kernel
            same = bool(torch.equal(got, flash_attn(q, k, v, True)))
            want = flash_attn_plain(q, k, v, True)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = tol_rel * max(1.0, want.abs().max().item())
            row = dict(kernel="flash_attn",
                       shape=f"tp2 {model} B=8 T=64 H={h} KV={kv} hd={hd} "
                             f"{dname} causal",
                       max_abs_err=err, tol=tol,
                       ok=err <= tol and route == want_route and same,
                       route=route, deterministic=same)
            rows.append(row)
            out["flash_attn"].append(row)
            say(f"  flash_attn      {row['shape']:40s} err {err:.3e} tol "
                f"{tol:.3e} ({route}) same bits {same} "
                f"{'ok' if row['ok'] else 'FAIL'}")
            del q, k, v, got, want
        for label, b, t, h, kv, hd, prefix, kv_len in TP_FRONTEND_FLASH:
            q, k, v = _flash_inputs(gen, b, t, h, kv, hd, dtype)
            if kv_len is not None:
                k, v = (torch.randn(b, kv_len, kv, hd, generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
            args = (q, k, v, kv_len is None, None, prefix)
            got = flash_attn(*args)
            route = flash_attn.last_kernel
            same = bool(torch.equal(got, flash_attn(*args)))
            want = flash_attn_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = tol_rel * max(1.0, want.abs().max().item())
            shape = (f"tp2 {label} B={b} T={t} H={h} KV={kv} hd={hd} "
                     f"{dname} " + (f"prefix={prefix}" if prefix else
                                    f"S={kv_len} full" if kv_len else
                                    "causal"))
            row = dict(kernel="flash_attn", shape=shape, max_abs_err=err,
                       tol=tol, ok=err <= tol and route == want_route
                       and same, route=route, deterministic=same)
            timed = ""
            if dtype == torch.bfloat16:          # the path's dtype: timed
                pairs = (t * kv_len if kv_len else _prefix_pairs(
                    t, prefix or 0))
                n_bytes = ((b * t * h * hd + 2 * b * (kv_len or t) * kv * hd)
                           * 2 + b * t * h * hd * 4)
                b_ms, b_by = bound(n_bytes, 4.0 * b * h * hd * pairs,
                                   "bfloat16")
                row.update(ms=device_ms(flash_attn, [args]),
                           plain_ms=device_ms(flash_attn_plain, [args], n=5,
                                              reps=3),
                           bound_ms=b_ms, bound_by=b_by)
                timed = (f"  ms {row['ms']:.5f} plain {row['plain_ms']:.5f}"
                         f" bound {b_ms:.5f} ({b_by})")
            rows.append(row)
            out["flash_attn"].append(row)
            say(f"  flash_attn      {shape:52s} err {err:.3e} tol "
                f"{tol:.3e} ({route}) same bits {same} "
                f"{'ok' if row['ok'] else 'FAIL'}{timed}")
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _packed_routes(params):
    """The 2:4-packed linears of a param tree: "K x N" → the decode
    kernel's route for their shape and pointers (``decode_plan``'s rule:
    bf16 with N % 8 == 0 and aligned vals / idx take the tensor cores)."""
    import torch

    routes = {}

    def walk(node):
        if isinstance(node, dict) and set(node) == {"vals", "idx"}:
            v, i = node["vals"], node["idx"]
            tc = (v.dtype == torch.bfloat16 and v.shape[1] % 8 == 0
                  and v.data_ptr() % 16 == 0 and i.data_ptr() % 8 == 0)
            routes[f"{2 * v.shape[0]} x {v.shape[1]}"] = (
                "tensor cores" if tc else "f32 FMA")
        elif isinstance(node, dict):
            for x in node.values():
                walk(x)
        elif isinstance(node, list):
            for x in node:
                walk(x)

    walk(params)
    return routes


def tp_serve(mesh=None):
    """16c's serving, on one device (``mesh`` None) or as one rank of a
    1x2 mesh: each of TP_CASES at full width, from a seeded
    torch.Generator, magnitude 2:4 on every linear, packed — and under
    the mesh sharded — by the engine; phase 3's 8 requests (64-token
    prompts, 32 new) in each mode.  Per case: per mode the streams, tok/s
    and the launches of the run (the counts set to 0 just before it), the
    HBM held once the engines are built and the peak of the runs, and the
    packed linears' shapes with their decode route; ``memory_allocated``
    once the first engine is built, beside the census of its tensors."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    out = {}
    for label, arch, layers, dtype, modes in TP_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype=dtype)
        torch.cuda.empty_cache()
        model = LM(cfg, device="cuda")
        gen = torch.Generator(device="cuda")
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=64, dtype=np.int32), max_new_tokens=32)
            for i in range(8)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        engines = {}
        for mode in modes:
            # each engine from its own copy of the same seeded weights, so
            # that the first one's allocation is what an engine holds
            gen.manual_seed(0)
            params = prune_linears(model.init(gen), "2:4")
            engines[mode] = ServeEngine(model, params, mesh=mesh, mode=mode,
                                        **TP_SERVE)
            del params
            if len(engines) == 1:
                torch.cuda.synchronize()
                allocated = torch.cuda.memory_allocated() - base
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = engines[modes[0]]
        # what one engine holds on the card: the allocator's count once it
        # is built, and the census of its (packed, sharded) params and KV
        # pool tensors
        res = {"modes": {}, "param_bytes": _tensor_bytes(first.params),
               "pool_bytes": _tensor_bytes(first.pool.kv)
               if first.pool is not None else 0,
               "allocated_bytes": allocated,
               "routes": _packed_routes(first.params)}
        for mode, eng in engines.items():
            ops.reset_launch_counts()            # the run starts
            t0 = time.monotonic()
            got = eng.generate(reqs)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            counts = ops.launch_counts()         # ... and ends
            _check_streams(f"16c {label} {mode}", reqs, got, cfg.vocab_size)
            toks = sum(len(r.tokens) for r in got)
            res["modes"][mode] = dict(
                streams=[r.tokens.tolist() for r in got], tok_s=toks / dt,
                counts=counts, flash_route=(flash_attn.last_kernel
                                            if mode == "static" else None))
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["held_bytes"] = res["param_bytes"] + res["pool_bytes"]
        out[label] = res
        del engines
    torch.cuda.empty_cache()
    return out


def _tp_family_model(kind, dtype, device="cuda"):
    """16d's models at full width: Jamba-1.5-Large's first TP_JAMBA_SLOTS
    slots without the experts, xlstm-350m's first TP_XLSTM_LAYERS layers,
    phi3.5-moe's first TP_PHI_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    if kind == "jamba":
        cfg = get_config("jamba_1_5_large_398b")
        cfg = dataclasses.replace(cfg, moe=None, moe_slots=(),
                                  period=cfg.period[:TP_JAMBA_SLOTS],
                                  num_layers=TP_JAMBA_SLOTS)
    elif kind == "xlstm":
        cfg = dataclasses.replace(get_config("xlstm_350m"),
                                  num_layers=TP_XLSTM_LAYERS)
    else:
        cfg = dataclasses.replace(get_config("phi3_5_moe_42b_a6_6b"),
                                  num_layers=TP_PHI_LAYERS)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, LM(cfg, device=device)


def _packed_every_linear(model, seed=0):
    """Weights from a seeded torch.Generator, magnitude 2:4 on every
    prunable linear — the attention's, the MLP's, the shared expert's and
    the recurrent blocks' (``LM.block_linears``) — and packed; the routed
    experts stay dense, as they are served."""
    import torch

    from repro_torch.core.pruner import LINEARS, prune_linears
    from repro_torch.serve.sparse import (DEFAULT_SPARSE_PATTERNS,
                                          compressed_param_tree,
                                          linear_patterns)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pairs = model.block_linears()
    params = prune_linears(model.init(g), "2:4", linears=LINEARS + pairs)
    return compressed_param_tree(params, DEFAULT_SPARSE_PATTERNS
                                 + linear_patterns(pairs))


def tp_family_serve(mesh=None):
    """16d's serving, on one device (``mesh`` None) or as one rank of a
    1x2 mesh: each of TP_FAMILY_CASES built, served and freed in turn —
    phase 3's 8 requests (64-token prompts, 32 new) through one engine
    (continuous: the paged pool and the StatePool; static for the MoE).
    Per case: the streams, tok/s and the launches of the run (the counts
    set to 0 just before it), the census of the engine's params and pool
    (pages and state rows), ``memory_allocated`` once the engine is
    built, the peak of the run, and the packed linears' decode routes."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.serve.engine import Request, ServeEngine

    out = {}
    for label, kind, dtype, mode in TP_FAMILY_CASES:
        torch.cuda.empty_cache()
        cfg, model = _tp_family_model(kind, dtype)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=64, dtype=np.int32), max_new_tokens=32)
            for i in range(8)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params = _packed_every_linear(model)
        eng = ServeEngine(model, params, mesh=mesh, mode=mode, **TP_SERVE)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()                # the run starts
        t0 = time.monotonic()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = ops.launch_counts()             # ... and ends
        _check_streams(f"16d {label}", reqs, got, cfg.vocab_size)
        out[label] = dict(
            streams=[r.tokens.tolist() for r in got],
            tok_s=sum(len(r.tokens) for r in got) / dt, counts=counts,
            flash_route=flash_attn.last_kernel if mode == "static" else None,
            param_bytes=_tensor_bytes(eng.params),
            pool_bytes=(_tensor_bytes(eng.pool.kv) if eng.pool is not None
                        else 0),
            allocated_bytes=allocated,
            peak_bytes=torch.cuda.max_memory_allocated(),
            routes=_packed_routes(eng.params))
        out[label]["held_bytes"] = (out[label]["param_bytes"]
                                    + out[label]["pool_bytes"])
        del eng, model, got
    torch.cuda.empty_cache()
    return out


def _tp_family_check(ranks, one, smi):
    """16d's gates on the two ranks' ``tp_family_serve`` results against
    the one-device run ``one``: each f32 twin's streams equal one
    device's, 8 of 8; both ranks' streams bit-equal in every case; each
    rank launched TP_FAMILY_NEED's kernels itself; a rank's census and
    ``memory_allocated`` under TP_BYTES_RATIO of one device's; every
    packed shape a rank runs is one of phase 1t's rows.  Prints
    the bf16 agreement and tok/s (reported, not gated).  Returns the
    ranks' launches, summed."""
    counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    family = tp_family_linears()
    for label, kind, dtype, mode in TP_FAMILY_CASES:
        o = one[label]
        rs = [r["16d"][label] for r in ranks]
        a, b = (r["streams"] for r in rs)
        if a != b:
            fail(f"16d {label}: the ranks' streams differ")
        want = o["streams"]
        same = sum(x == y for x, y in zip(a, want))
        toks = sum(len(x) for x in want)
        pos = sum(int(np.sum(np.asarray(x) == np.asarray(y)))
                  for x, y in zip(a, want))
        if dtype == "float32" and same != len(want):
            fail(f"16d {label}: {same} of {len(want)} streams equal the "
                 "one-device run's")
        for r in rs:
            for k in TP_FAMILY_NEED[kind]:
                if r["counts"][k] <= 0:
                    fail(f"16d {label}: a rank never launched {k}")
            for k in counts:
                counts[k] += r["counts"][k]
        held = max(r["held_bytes"] for r in rs) / o["held_bytes"]
        alloc = max(r["allocated_bytes"] for r in rs) / o["allocated_bytes"]
        if held > TP_BYTES_RATIO or alloc > TP_BYTES_RATIO:
            fail(f"16d {label}: a rank holds {held:.3f}x (census) and "
                 f"{alloc:.3f}x (memory_allocated) of one device's bytes")
        unheld = _unheld_shapes({k for r in rs for k in r["routes"]},
                                family)
        if unheld:
            fail(f"16d {label}: a rank runs packed shapes {unheld} that "
                 "phase 1t's tp_family_linears does not hold against the "
                 "plain kernel")
        off = ({k: v for k, v in rs[0]["routes"].items()
                if v != "tensor cores"} if dtype == "bfloat16"
               else "f32 takes the FMA kernels by its dtype")
        say(f"  16d {label} {mode} on 1x2: {same}/{len(want)} streams and "
            f"{pos}/{toks} tokens equal to one device's; the ranks' streams "
            f"bit-equal; tok/s {rs[0]['tok_s']:.1f} against "
            f"{o['tok_s']:.1f} on one device; rank 0's launches "
            f"{rs[0]['counts']}"
            + (f"; flash_attn route {rs[0]['flash_route']}"
               if rs[0]["flash_route"] else "")
            + f"; census {rs[0]['held_bytes'] / 2**30:.4f} GiB a rank "
            f"(params {rs[0]['param_bytes'] / 2**30:.4f}, pool "
            f"{rs[0]['pool_bytes'] / 2**30:.4f}) against "
            f"{o['held_bytes'] / 2**30:.4f} GiB (params "
            f"{o['param_bytes'] / 2**30:.4f}, pool "
            f"{o['pool_bytes'] / 2**30:.4f}): {held:.3f}x; "
            f"memory_allocated "
            + ", ".join(f"{r['allocated_bytes'] / 2**30:.4f}" for r in rs)
            + f" GiB a rank against {o['allocated_bytes'] / 2**30:.4f}: "
            f"{alloc:.3f}x; peak "
            f"{max(r['peak_bytes'] for r in rs) / 2**30:.3f} GiB a rank, "
            f"{o['peak_bytes'] / 2**30:.3f} on one device; rank-local "
            f"packed shapes {sorted(rs[0]['routes'])}; off the tensor "
            f"cores: {off if off else 'none'} ({smi})")
    return counts


# 16e: the prefix-LM and the encoder-decoder tensor-parallel on 16b's two
# ranks (1x2): their depth cut, widths whole
TP_FRONTEND = {"paligemma_3b": dict(num_layers=2),      # 2 of 18 layers
               "seamless_m4t_large_v2": dict(num_layers=2, enc_layers=2)}
                                     # 2 + 2 of 24 + 24
TP_FRONTEND_CASES = (                # (label, arch, dtype)
    ("paligemma-3b bf16", "paligemma_3b", "bfloat16"),
    ("paligemma-3b f32", "paligemma_3b", "float32"),
    ("seamless-m4t-large-v2 bf16", "seamless_m4t_large_v2", "bfloat16"),
    ("seamless-m4t-large-v2 f32", "seamless_m4t_large_v2", "float32"),
)
TP_FRONTEND_NEED = ("flash_attn", "nm_spmm", "nm_spmm_decode")
TP_FRONTEND_FLASH = (                # (label, B, T, H, KV, hd, prefix, S):
    ("paligemma prefix", 8, 320, 4, 1, 256, 256, None),   # 4 of 8 query
    ("seamless encoder", 8, 1024, 8, 8, 64, None, 1024),  # heads a rank;
    ("seamless cross", 8, 64, 8, 8, 64, None, 1024),      # S: non-causal
    ("seamless decoder", 8, 64, 8, 8, 64, None, None),    # over S keys
)
# the M of each packed linear a rank runs at 16e's 8 requests: 8 at a
# decode step; the prefill's rows — PaliGemma's 8 x (256 + 64), seamless
# decoder's 8 x 64, its encoder's (and xattn.wk / wv over the encoder's
# output) 8 x 1024 frames
TP_FRONTEND_M = {"paligemma_3b": {"dec": (8, 8 * 320)},
                 "seamless_m4t_large_v2": {"dec": (8, 8 * 64),
                                           "enc": (8 * 1024,)}}
TP_FRONTEND_LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                       ("attn", "wo"), ("xattn", "wq"), ("xattn", "wk"),
                       ("xattn", "wv"), ("xattn", "wo"), ("mlp", "wi"),
                       ("mlp", "wg"), ("mlp", "wo"))


@functools.lru_cache(maxsize=None)
def tp_frontend_linears(tp=2):
    """16e's rank-local packed linears, one row a distinct (M, K, N,
    fused activation): each TP_FRONTEND model initialised on the meta
    device (shapes only), every prunable linear of its decoder and
    encoder split as ``dist.sharding.param_split`` splits it for one rank
    of ``tp``, at the M its prefill and decode give it (TP_FRONTEND_M).
    Rows: (label, M, K, N, activation)."""
    from repro_torch import random as rnd
    from repro_torch.dist.sharding import param_split

    found = {}
    for arch, cut in TP_FRONTEND.items():
        cfg, model = _frontend(arch, "bfloat16", device="meta", **cut)
        params = model.init(rnd.key(0, device="meta"))
        # the linear whose epilogue fuses the MLP's gelu (models.layers)
        gelu_at = {"geglu": ("mlp", "wg"),
                   "gelu": ("mlp", "wi")}.get(cfg.mlp_kind)
        stacks = [("dec", f"layers/{i}", b)
                  for i, b in enumerate(params["layers"])]
        stacks += [("enc", f"enc/layers/{i}", b)
                   for i, b in enumerate(params.get("enc", {}).get(
                       "layers", []))]
        for part, path, block in stacks:
            for sub, key in TP_FRONTEND_LINEARS:
                if key not in block.get(sub, {}):
                    continue
                k, n = block[sub][key].shape
                dim = param_split(f"{path}/{sub}/{key}/vals", (k // 2, n),
                                  tp, cfg)
                k, n = (k // tp, n) if dim == 0 else (
                    (k, n // tp) if dim else (k, n))
                act = "gelu" if (sub, key) == gelu_at else None
                ms = TP_FRONTEND_M[arch][part]
                if (sub, key) in (("xattn", "wk"), ("xattn", "wv")):
                    ms = TP_FRONTEND_M[arch]["enc"]     # over enc_out
                for m in ms:
                    found.setdefault((m, k, n, act),
                                     f"tp{tp} {arch.split('_')[0]} "
                                     f"{part} {sub}.{key}")
    return tuple((label, m, k, n, act)
                 for (m, k, n, act), label in found.items())


def tp_frontend_serve(mesh=None):
    """16e's serving, on one device (``mesh`` None) or as one rank of a
    1x2 mesh: each of TP_FRONTEND_CASES at full width and TP_FRONTEND's
    depth, from a seeded torch.Generator, magnitude 2:4 on every linear
    of its decoder and encoder, packed — and under the mesh sharded — by
    the engine, served static: phase 3's 8 requests with 15a-b's seeded
    stub features through ``extra_batch``.  Per case: the streams, tok/s,
    the launches of the run (the counts set to 0 just before it), the
    census of the engine's params, ``memory_allocated`` once it is built
    and the packed linears' decode routes."""
    import torch

    from repro_torch.core.pruner import prune_linears
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.serve.engine import Request, ServeEngine

    out = {}
    for label, arch, dtype in TP_FRONTEND_CASES:
        torch.cuda.empty_cache()
        cfg, model = _frontend(arch, dtype, **TP_FRONTEND[arch])
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=64, dtype=np.int32), max_new_tokens=32)
            for i in range(8)]
        feats = _frontend_feats(cfg, 8, FRONTEND_FEATS_SEED)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        params = model.init(g)
        layers = list(params["layers"]) + list(
            params.get("enc", {}).get("layers", []))
        prune_linears({"layers": layers}, "2:4",
                      linears=TP_FRONTEND_LINEARS)
        del layers
        eng = ServeEngine(model, params, mesh=mesh, max_batch=8,
                          max_len=(model.prefix_len or 0) + 64 + 32,
                          extra_batch={"frontend_feats": feats})
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated = torch.cuda.memory_allocated() - base
        ops.reset_launch_counts()                # the run starts
        t0 = time.monotonic()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = ops.launch_counts()             # ... and ends
        _check_streams(f"16e {label}", reqs, got, cfg.vocab_size)
        out[label] = dict(
            streams=[r.tokens.tolist() for r in got],
            tok_s=sum(len(r.tokens) for r in got) / dt, counts=counts,
            flash_route=flash_attn.last_kernel, mode=eng.mode,
            param_bytes=_tensor_bytes(eng.params),
            allocated_bytes=allocated, routes=_packed_routes(eng.params))
        del eng, model, got, feats
    torch.cuda.empty_cache()
    return out


def _tp_frontend_check(ranks, one, smi):
    """16e's gates on the two ranks' ``tp_frontend_serve`` results against
    the one-device run ``one``: served static; each f32 twin's streams
    equal one device's, 8 of 8; both ranks' streams bit-equal in every
    case; each rank launched TP_FRONTEND_NEED itself; a rank's census and
    ``memory_allocated`` under TP_BYTES_RATIO of one device's; every
    packed shape a rank runs is one of phase 1t's rows.  Prints the bf16
    agreement and tok/s (reported, not gated).  Returns the ranks'
    launches, summed."""
    counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    held_rows = [(label, k, n) for label, _, k, n, _ in tp_frontend_linears()]
    for label, arch, dtype in TP_FRONTEND_CASES:
        o = one[label]
        rs = [r["16e"][label] for r in ranks]
        if any(r["mode"] != "static" for r in (o, *rs)):
            fail(f"16e {label}: served {[r['mode'] for r in rs]}, not static")
        a, b = (r["streams"] for r in rs)
        if a != b:
            fail(f"16e {label}: the ranks' streams differ")
        want = o["streams"]
        same = sum(x == y for x, y in zip(a, want))
        toks = sum(len(x) for x in want)
        pos = sum(int(np.sum(np.asarray(x) == np.asarray(y)))
                  for x, y in zip(a, want))
        if dtype == "float32" and same != len(want):
            fail(f"16e {label}: {same} of {len(want)} streams equal the "
                 "one-device run's")
        for r in rs:
            for k in TP_FRONTEND_NEED:
                if r["counts"][k] <= 0:
                    fail(f"16e {label}: a rank never launched {k}")
            for k in counts:
                counts[k] += r["counts"][k]
        held = max(r["param_bytes"] for r in rs) / o["param_bytes"]
        alloc = max(r["allocated_bytes"] for r in rs) / o["allocated_bytes"]
        if held > TP_BYTES_RATIO or alloc > TP_BYTES_RATIO:
            fail(f"16e {label}: a rank holds {held:.3f}x (census) and "
                 f"{alloc:.3f}x (memory_allocated) of one device's bytes")
        unheld = _unheld_shapes({k for r in rs for k in r["routes"]},
                                held_rows)
        if unheld:
            fail(f"16e {label}: a rank runs packed shapes {unheld} that "
                 "phase 1t's tp_frontend_linears does not hold against the "
                 "plain kernel")
        say(f"  16e {label} static on 1x2: {same}/{len(want)} streams and "
            f"{pos}/{toks} tokens equal to one device's; the ranks' streams "
            f"bit-equal; tok/s {rs[0]['tok_s']:.1f} against "
            f"{o['tok_s']:.1f} on one device; rank 0's launches "
            f"{rs[0]['counts']}; flash_attn route {rs[0]['flash_route']}; "
            f"params {rs[0]['param_bytes'] / 2**30:.4f} GiB a rank against "
            f"{o['param_bytes'] / 2**30:.4f}: {held:.3f}x; memory_allocated "
            + ", ".join(f"{r['allocated_bytes'] / 2**30:.4f}" for r in rs)
            + f" GiB a rank against {o['allocated_bytes'] / 2**30:.4f}: "
            f"{alloc:.3f}x; rank-local packed shapes "
            f"{sorted(rs[0]['routes'])} ({smi})")
    return counts


# 16f: the serve CLI's server under the 1x2 mesh of 16b's two ranks
TP_SERVER_ARGS = ["--device", "cuda", "--sparse", "--server", "--port", "0",
                  "--replicas", "2", "--max-batch", "8", "--max-len", "128",
                  "--page-size", "16", "--prefill-chunk", "32"]
TP_SERVER_CASE = "qwen1.5-0.5b f32"   # 16c's one-device streams it equals


def tp_server_rank(mesh, rank):
    """16f on one rank: Qwen1.5-0.5B at full width, DIST_LAYERS layers,
    f32 (16c's twin: the same seeded weights, magnitude 2:4, packed) behind
    ``launch.serve.run_frontend`` with TP_SERVER_ARGS under ``mesh`` —
    rank 0 the router, two replicas, the supervisor and the HTTP server
    on port 0; rank 1 the followers of both — until SIGTERM.  On rank 0 a
    ``replica_worker`` death is armed on r0 once r0 has streamed a token
    (requests in flight).  Returns the launches of the run (the counts set
    to 0 just before it) and, on rank 0, the recovery counters."""
    import threading

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pruner import prune_linears
    from repro_torch.dist import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import LM
    from repro_torch.obs import Obs
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.faults import FaultPlan, FaultSpec

    args = serve.build_parser().parse_args(TP_SERVER_ARGS)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=DIST_LAYERS, dtype="float32")
    model = LM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = prune_linears(model.init(gen), "2:4")
    plan = FaultPlan()
    config = dataclasses.replace(ServeConfig.from_args(args), faults=plan)
    obs = Obs.create(metrics=True, trace=False)

    def total(name, replica=None):
        fam = obs.metrics.get(name)
        return sum(child.value for labels, child in (
            fam.children() if fam is not None else [])
            if replica is None or labels[0] == replica)

    armed = threading.Event()

    def arm():          # r0's next worker pass raises, requests in flight
        while not armed.is_set():
            if total("serve_tokens_total", "r0") > 0:
                with plan._lock:
                    plan.specs.append(FaultSpec(
                        "replica_worker", after=0, count=1, replica="r0"))
                armed.set()
            time.sleep(0.001)

    if rank == 0:
        threading.Thread(target=arm, daemon=True).start()
    ops.reset_launch_counts()                    # the run starts
    t0 = time.monotonic()
    with torch.no_grad(), use_mesh(mesh):
        serve.run_frontend(cfg, model, params, args, config, obs)
    torch.cuda.synchronize()
    res = dict(counts=ops.launch_counts(),        # ... and ends
               wall_s=time.monotonic() - t0)
    armed.set()
    if rank == 0:
        res.update(fired=dict(plan.fired),
                   restarts=total("replica_restarts_total", "r0"),
                   failed_over=total("requests_failed_over_total"))
    return res


def tp_server_client(lines, ready, up, want, smi):
    """16f's client: phase 3's 8 greedy requests (64-token prompts, 32
    new), streamed concurrently over HTTP/SSE to rank 0's server once it
    says where it serves: their streams, gated equal to ``want`` (16c's
    one-device streams of the same model)."""
    import asyncio

    from repro_torch.serve.frontend import sse_decode

    ready.wait(timeout=900)
    if "port" not in up:
        fail(f"16f: rank 0's server did not come up: {''.join(lines)}")
    from repro_torch.configs import get_config

    vocab = get_config("qwen1.5-0.5b").vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=64, dtype=np.int32).tolist()
               for _ in range(8)]

    async def run():
        return await asyncio.gather(*[_http(
            up["host"], up["port"], "POST", "/v1/completions",
            {"prompt": p, "max_tokens": 32, "uid": i, "stream": True})
            for i, p in enumerate(prompts)])

    t0 = time.monotonic()
    replies = asyncio.run(run())
    dt = time.monotonic() - t0
    streams = []
    for status, _, rest in replies:
        chunks = sse_decode(rest)
        if status != 200 or not chunks or not chunks[-1].finished:
            fail(f"16f: the server answered {status}: {rest[-300:]!r}")
        streams.append([t for ch in chunks for t in ch.tokens])
    same = sum(a == b for a, b in zip(streams, want))
    if same != len(want):
        fail(f"16f: {same} of {len(want)} streams equal 16c's one-device "
             f"streams")
    toks = sum(len(x) for x in streams)
    say(f"  16f: 8 streamed completions through the server under 1x2 (two "
        f"replicas, r0's worker killed mid-stream), {toks} tokens in "
        f"{dt:.2f} s = {toks / dt:.1f} tok/s, {same}/{len(want)} streams "
        f"equal to 16c's one-device {TP_SERVER_CASE} streams ({smi})")
    return dict(streams=streams, tok_s=toks / dt, wall_s=dt)


def moe_train(mesh=None, out=None):
    """phi3.5-moe SMOKE (f32) on the card, 3 steps of a global batch of
    8 x 32, data-parallel over ``mesh`` or on one device: each step's
    logged (loss, aux)."""
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke(MOE_TRAIN_ARCH)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = out or tmp
        Trainer(LM(cfg, device="cuda"), AdamW(lr=warmup_cosine(1e-3, 2, 3)),
                DataPipeline(cfg, 8, 32, seed=0, mesh=mesh, device="cuda"),
                TrainConfig(total_steps=3, global_batch=8, seq_len=32,
                            ckpt_every=3, out_dir=out, log_every=1),
                mesh=mesh).run()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [(r["loss"], r["aux"]) for r in map(json.loads, f)]


# ----------------------------------------------------------------------
# 16g: FSDP and a model axis in training, on 16b's two ranks (gloo)
# ----------------------------------------------------------------------
TRAIN_16G = dict(steps=3, batch=8, seq=128)   # Qwen1.5-0.5B, DIST_LAYERS
TRAIN_16G_RUNS = (("2x1", "float32"), ("2x1", "bfloat16"),
                  ("1x2", "float32"), ("1x2", "bfloat16"))
# a checkpoint's gather holds one whole leaf on the card at a time: a
# rank's bytes there rise by at most this many of the largest whole leaf
# while it writes (a whole-tree gather: ≈ 3.3 of them)
SAVE_RISE_LEAVES = 1.5


class _RankRows:
    """16g's batches: the global batch of token ids from a seeded
    torch.Generator on the card (Qwen's vocabulary makes the synthetic
    corpus's (V, V) table 92 GB), of which a rank keeps its rows over the
    data axis (``dist.sharding.batch_sharding``, as ``DataPipeline``)."""

    def __init__(self, cfg, batch, seq, mesh=None, seed=0):
        from repro_torch.dist.sharding import batch_sharding

        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.shard = None if mesh is None else batch_sharding(mesh)

    def batch_at(self, step):
        import torch

        g = torch.Generator(device="cuda")
        g.manual_seed(1000 * self.seed + step)
        toks = torch.randint(0, self.cfg.vocab_size, (self.batch, self.seq),
                             generator=g, device="cuda", dtype=torch.int32)
        if self.shard is not None:
            toks = self.shard.take(toks)
        return {"tokens": toks, "labels": toks}


def train_16g(mesh=None, dtype="float32", out=None, save_at=()):
    """TRAIN_16G's steps of Qwen1.5-0.5B at full width and DIST_LAYERS
    layers in ``dtype`` (AdamW's moments f32; the reference's keyed
    init), through the Trainer: on ``mesh`` (its default: FSDP over
    data, blocks over model) or on one device; a run that finds a
    checkpoint in ``out`` resumes from it.  It writes a checkpoint there
    after the steps of ``save_at`` only (the state is 2.2 GB in f32, and
    only (c) reads one), and measures how far the rank's bytes on the
    card rose while it wrote (``save_rise``) against the largest whole
    leaf (``whole_leaf``, rank 0's).  Returns (the model, the whole
    params — on rank 0's host under a mesh, None elsewhere — and info:
    every step's loss, step seconds, the bytes of params and moments the
    rank held, the run's wall seconds)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    n, b, t = TRAIN_16G["steps"], TRAIN_16G["batch"], TRAIN_16G["seq"]
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=DIST_LAYERS, dtype=dtype)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trainer = Trainer(LM(cfg, device="cuda"),
                          AdamW(lr=warmup_cosine(1e-3, 1, n)),
                          _RankRows(cfg, b, t, mesh),
                          TrainConfig(total_steps=n, global_batch=b,
                                      seq_len=t, ckpt_every=1,
                                      out_dir=out or tmp, log_every=n),
                          mesh=mesh)
        save, rise = trainer._save, {}

        def saving(step, *state):
            if step in save_at:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                save(step, *state)
                rise["save_rise"] = torch.cuda.max_memory_allocated() - base

        trainer._save = saving
        t0 = time.monotonic()
        params, opt_state, info = trainer.run()
        info["wall_s"] = time.monotonic() - t0
        params, _, _ = trainer.gather_state(params, opt_state, to_host=True)
    info.update(rise)
    if params is not None and tree_leaves(params)[0] is not None:
        info["whole_leaf"] = max(v.numel() * v.element_size()
                                 for v in tree_leaves(params))
    return trainer.model, params, info


def _flat32(model, params):
    """An f32 model's params (the reference's paths) as host tensors."""
    import torch

    return {k: torch.from_numpy(v)
            for k, v in model.params_to_flat(params).items()}


def train_16g_one(work):
    """16g's one-device runs, in this process: f32 (its params saved to
    ``work`` for the ranks to hold theirs against) and bf16.  Returns
    {dtype: (losses, median step seconds, bytes held)}."""
    import statistics

    import torch

    out = {}
    for dtype in ("float32", "bfloat16"):
        model, params, info = train_16g(dtype=dtype)
        if dtype == "float32":
            torch.save(_flat32(model, params),
                       os.path.join(work, "one_f32.pt"))
        out[dtype] = (info["losses"], statistics.median(info["step_seconds"]),
                      info["rank_state_bytes"])
        del model, params
        torch.cuda.empty_cache()
    return out


def train_16g_rank(work, rank):
    """16g on one of the two ranks: TRAIN_16G_RUNS (2x1 with FSDP, 1x2
    tensor-parallel; f32 and bf16), then (c) the 2x1 f32 run's step-2
    checkpoint resumed for step 3 on 1x2.  Rank 0 holds each f32 run's
    params against the one-device run's (``work``/one_f32.pt): each
    leaf's relative error by norm and its entries past
    DIST_TRAIN_ENTRY_ABS."""
    import shutil
    import statistics

    import torch

    from repro_torch.dist import comm, mesh_from_spec

    meshes = {spec: mesh_from_spec(spec, "cuda", backend="gloo")
              for spec in ("2x1", "1x2")}
    one = (torch.load(os.path.join(work, "one_f32.pt")) if rank == 0
           else None)
    res = {}
    for spec, dtype in TRAIN_16G_RUNS:
        comm.barrier()
        saved = (os.path.join(work, "16g_saved")
                 if (spec, dtype) == ("2x1", "float32") else None)
        model, params, info = train_16g(meshes[spec], dtype, out=saved,
                                        save_at=(2,) if saved else ())
        run = dict(losses=info["losses"], bytes=info["rank_state_bytes"],
                   step_s=statistics.median(info["step_seconds"]),
                   wall_s=info["wall_s"], save_rise=info.get("save_rise"),
                   whole_leaf=info.get("whole_leaf"))
        if rank == 0 and dtype == "float32":
            rel, far = {}, {}
            for k, v in _flat32(model, params).items():
                d = v - one[k]
                rel[k] = float(d.norm() / one[k].norm().clamp(min=1e-30))
                far[k] = int((d.abs() > DIST_TRAIN_ENTRY_ABS).sum()
                             ) / v.numel()
            run.update(rel=rel, far=far)
        res[f"{spec} {dtype}"] = run
        del model, params
        torch.cuda.empty_cache()
    # (c): the 2x1 run's step-2 checkpoint, step 3 on 1x2
    resumed = os.path.join(work, "16g_resumed")
    if rank == 0:
        os.makedirs(resumed)
        shutil.copytree(os.path.join(work, "16g_saved", "step_00000002"),
                        os.path.join(resumed, "step_00000002"))
    comm.barrier()
    model, params, info = train_16g(meshes["1x2"], "float32", out=resumed)
    res["resumed"] = dict(losses=info["losses"], wall_s=info["wall_s"])
    del model, params
    torch.cuda.empty_cache()
    return res


def train_16g_check(ranks, one, smi):
    """16g's gates: each f32 run's losses within DIST_LOSS_ABS of one
    device's, the ranks' bit-equal, every leaf within DIST_TRAIN_REL by
    norm with at most DIST_TRAIN_OUTLIERS of its entries past
    DIST_TRAIN_ENTRY_ABS; the 2x1 f32 run's checkpoint raising no rank's
    bytes on the card by more than SAVE_RISE_LEAVES whole leaves; (c)'s
    step 3 within DIST_LOSS_ABS of the uninterrupted run's.  bf16
    printed.  Returns the numbers."""
    out = {}
    key = "2x1 float32"
    leaf = ranks[0]["16g"][key]["whole_leaf"]
    rises = [r["16g"][key]["save_rise"] for r in ranks]
    if max(rises) > SAVE_RISE_LEAVES * leaf:
        fail(f"16g {key}: writing the checkpoint raised a rank's bytes on "
             f"the card by {rises}, past {SAVE_RISE_LEAVES} of the largest "
             f"whole leaf's {leaf}")
    say(f"  16g {key}: the step-2 checkpoint raised the ranks' bytes on "
        f"the card by {rises[0] / 2**20:.1f} / {rises[1] / 2**20:.1f} MiB "
        f"(the largest whole leaf {leaf / 2**20:.1f} MiB)")
    out["save_rise"] = dict(rises=rises, whole_leaf=leaf)
    for spec, dtype in TRAIN_16G_RUNS:
        key = f"{spec} {dtype}"
        r0, r1 = (r["16g"][key] for r in ranks)
        losses1, step1, bytes1 = one[dtype]
        if r0["losses"] != r1["losses"]:
            fail(f"16g {key}: the ranks' losses differ: {r0['losses']} "
                 f"against {r1['losses']}")
        far_loss = max(abs(a - b) for a, b in zip(r0["losses"], losses1))
        if dtype == "float32":
            if far_loss > DIST_LOSS_ABS:
                fail(f"16g {key}: losses {r0['losses']} against one "
                     f"device's {losses1}")
            worst = max(r0["rel"], key=r0["rel"].get)
            outlier = max(r0["far"], key=r0["far"].get)
            if (r0["rel"][worst] > DIST_TRAIN_REL
                    or r0["far"][outlier] > DIST_TRAIN_OUTLIERS):
                fail(f"16g {key}: trained {worst} {r0['rel'][worst]:.3e} "
                     f"from one device's by norm; {outlier} "
                     f"{r0['far'][outlier]:.2e} of its entries past "
                     f"{DIST_TRAIN_ENTRY_ABS:g}")
        ratio = [r["16g"][key]["bytes"] / bytes1 for r in ranks]
        say(f"  16g {key}: losses {r0['losses']} (one device "
            f"{losses1}; at most {far_loss:.2e} apart"
            + (f"; params {r0['rel'][worst]:.2e} by norm at most, "
               f"{worst}" if dtype == "float32" else "")
            + f"); a rank held {r0['bytes'] / 2**20:.1f} MiB of params "
            f"and moments, {ratio[0]:.3f} / {ratio[1]:.3f} of one "
            f"device's {bytes1 / 2**20:.1f}; {r0['step_s']:.3f} s a step "
            f"(one device {step1:.3f}), the run {r0['wall_s']:.1f} s ({smi})")
        out[key] = dict(r0, ratio=ratio, one_losses=losses1,
                        one_step_s=step1, one_bytes=bytes1)
    got = ranks[0]["16g"]["resumed"]["losses"]
    want = one["float32"][0][-1]
    if len(got) != 1 or abs(got[0] - want) > DIST_LOSS_ABS:
        fail(f"16g (c): step 3 resumed on 1x2 from 2x1's step-2 checkpoint "
             f"lost {got} against the uninterrupted run's {want}")
    say(f"  16g (c): 2x1's step-2 checkpoint resumed on 1x2: step 3 loss "
        f"{got[0]} against the uninterrupted run's {want} (the run "
        f"{ranks[0]['16g']['resumed']['wall_s']:.1f} s)")
    out["resumed"] = dict(loss=got[0], want=want)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_rank_main(work, parts="bc") -> int:
    """One of 16b's two ranks (``chip_smoke.py --dist-rank WORK [PARTS]``,
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in the environment, as
    torchrun sets them): a gloo group on CUDA tensors, both ranks on the
    one card.  16b (``b`` in PARTS): the Qwen prune on 1x2 (row-parallel
    solves) and on 2x1 (calibration sharded over data), then the trainers
    on 2x1 (paper_tiny_lm, and phi3.5-moe SMOKE routing the global
    batch); 16c (``c``): tensor-parallel serving on 1x2 (``tp_serve``);
    16d (``d``): the recurrent and expert families' tensor-parallel
    serving on 1x2 (``tp_family_serve``); 16e (``e``): the prefix-LM's
    and the encoder-decoder's (``tp_frontend_serve``); 16g (``g``): the
    trainer with FSDP on 2x1 and tensor-parallel on 1x2, and a resume
    across them (``train_16g_rank``); 16f (``f``, the last): the serve
    CLI's server on 1x2 until SIGTERM (``tp_server_rank``).  Each result
    saved under ``WORK``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import comm, mesh_from_spec, use_mesh
    from repro_torch.kernels import build
    from repro_torch.launch import prune as launch_prune

    build.library()
    rank = int(os.environ["RANK"])
    tp = mesh_from_spec("1x2", "cuda", backend="gloo")
    dp = mesh_from_spec("2x1", "cuda", backend="gloo")
    res = {"rank": rank}
    if "b" in parts:
        cfg, model, params = _qwen(DIST_LAYERS)
        calib, _ = launch_prune.load_tokens(None, cfg.vocab_size, 128, 2048,
                                            "cuda", seed=0)
        for spec, mesh in (("1x2", tp), ("2x1", dp)):
            with torch.no_grad(), use_mesh(mesh):
                pruned, reports, wall, counts = _dist_prune(model, params,
                                                            calib)
            res[spec] = dict(wall_s=wall, counts=counts,
                             errors=[r.recon_error for r in reports])
            torch.save(_dist_flat(model, pruned),
                       os.path.join(work, f"prune_{spec}_{rank}.pt"))
            del pruned
            torch.cuda.empty_cache()
        del model, params, calib
        comm.barrier()
        t0 = time.monotonic()
        losses, flat, _ = _dist_train(dp, out=os.path.join(work, "train"),
                                      grad_compression=False)
        res["train"] = dict(losses=losses, wall_s=time.monotonic() - t0)
        torch.save(flat, os.path.join(work, f"train_{rank}.pt"))
        # the replicated route (fsdp_axes=()) against the same one rank
        losses, flat, _ = _dist_train(dp, out=os.path.join(work, "rep"),
                                      grad_compression=False, fsdp_axes=())
        res["train_rep"] = dict(losses=losses)
        torch.save(flat, os.path.join(work, f"train_rep_{rank}.pt"))
        res["moe_train"] = moe_train(dp, out=os.path.join(work, "moe"))
        torch.cuda.empty_cache()
    if "c" in parts:
        comm.barrier()
        t0 = time.monotonic()
        with torch.no_grad():
            res["16c"] = tp_serve(tp)
        res["16c_wall_s"] = time.monotonic() - t0
    if "d" in parts:
        comm.barrier()
        t0 = time.monotonic()
        with torch.no_grad():
            res["16d"] = tp_family_serve(tp)
        res["16d_wall_s"] = time.monotonic() - t0
    if "e" in parts:
        comm.barrier()
        t0 = time.monotonic()
        with torch.no_grad():
            res["16e"] = tp_frontend_serve(tp)
        res["16e_wall_s"] = time.monotonic() - t0
    if "g" in parts:
        comm.barrier()
        t0 = time.monotonic()
        res["16g"] = train_16g_rank(work, rank)
        res["16g_wall_s"] = time.monotonic() - t0
        torch.cuda.empty_cache()
    if "f" in parts:                 # the last: it serves until SIGTERM
        comm.barrier()
        torch.cuda.empty_cache()
        res["16f"] = tp_server_rank(tp, rank)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    comm.barrier()
    torch.distributed.destroy_process_group()   # not at the exit
    return 0


def _tp_check(ranks, one, smi):
    """16c's gates on the two ranks' ``tp_serve`` results against the
    one-device run ``one``: the f32 twin's streams equal, 8 of 8 in each
    mode; both ranks' streams bit-equal in every case; each rank launched
    nm_spmm_decode and paged_attn (continuous) and flash_attn and nm_spmm
    (static) itself; every packed shape a rank runs is one of TP_LINEARS
    (phase 1t's rows).  Prints the bf16 agreement, tok/s and HBM against
    one device, and every rank-local shape off the tensor-core route.
    Returns the ranks' launches, summed."""
    counts = {k: 0 for k in (*SERVE_KERNELS, "flash_attn")}
    need = {"continuous": ("nm_spmm_decode", "paged_attn"),
            "static": ("nm_spmm_decode", "flash_attn", "nm_spmm")}
    for label, arch, layers, dtype, modes in TP_CASES:
        o = one[label]
        rs = [r["16c"][label] for r in ranks]
        for mode in modes:
            a, b = (r["modes"][mode]["streams"] for r in rs)
            if a != b:
                fail(f"16c {label} {mode}: the ranks' streams differ")
            want = o["modes"][mode]["streams"]
            same = sum(x == y for x, y in zip(a, want))
            toks = sum(len(x) for x in want)
            pos = sum(int(np.sum(np.asarray(x) == np.asarray(y)))
                      for x, y in zip(a, want))
            if dtype == "float32" and same != len(want):
                fail(f"16c {label} {mode}: {same} of {len(want)} streams "
                     "equal the one-device run's")
            for r in rs:
                c = r["modes"][mode]["counts"]
                for k in need[mode]:
                    if c[k] <= 0:
                        fail(f"16c {label} {mode}: a rank never launched "
                             f"{k}")
                for k in counts:
                    counts[k] += c[k]
            flash = rs[0]["modes"][mode]["flash_route"]
            say(f"  16c {label} ({layers} layers) {mode} on 1x2: {same}/"
                f"{len(want)} streams and {pos}/{toks} tokens equal to one "
                f"device's; the ranks' streams bit-equal; tok/s "
                f"{rs[0]['modes'][mode]['tok_s']:.1f} against "
                f"{o['modes'][mode]['tok_s']:.1f} on one device; rank 0's "
                f"launches {rs[0]['modes'][mode]['counts']}"
                + (f"; flash_attn route {flash}" if flash else "")
                + f" ({smi})")
        unheld = _unheld_shapes({k for r in rs for k in r["routes"]},
                                TP_LINEARS)
        if unheld:
            fail(f"16c {label}: a rank runs packed shapes {unheld} that "
                 "phase 1t's TP_LINEARS does not hold against the plain "
                 "kernel")
        off = ({k: v for k, v in rs[0]["routes"].items()
                if v != "tensor cores"} if dtype == "bfloat16"
               else "f32 takes the FMA kernels by its dtype")
        say(f"  16c {label}: a {modes[0]} engine's memory_allocated "
            + ", ".join(f"{r['allocated_bytes'] / 2**30:.4f}" for r in rs)
            + f" GiB a rank against {o['allocated_bytes'] / 2**30:.4f} GiB "
            f"on one device: "
            f"{rs[0]['allocated_bytes'] / o['allocated_bytes']:.3f}x; the "
            f"census of its tensors "
            + ", ".join(f"{r['held_bytes'] / 2**30:.4f}" for r in rs)
            + f" GiB a rank (params "
            f"{rs[0]['param_bytes'] / 2**30:.4f}, KV pool "
            f"{rs[0]['pool_bytes'] / 2**30:.4f}) against "
            f"{o['held_bytes'] / 2**30:.4f} GiB (params "
            f"{o['param_bytes'] / 2**30:.4f}, KV pool "
            f"{o['pool_bytes'] / 2**30:.4f}) on one device: "
            f"{rs[0]['held_bytes'] / o['held_bytes']:.3f}x; the process's "
            f"peak over its {len(modes)} engines' runs "
            f"{max(r['peak_bytes'] for r in rs) / 2**30:.3f} GiB a rank, "
            f"{o['peak_bytes'] / 2**30:.3f} on one device; rank-local "
            f"packed shapes {sorted(rs[0]['routes'])}; off the tensor "
            f"cores: {off if off else 'none'}")
    return counts


def dist_two_ranks(smi, parts="bc", wants=None, flat_one=None,
                   losses_one=None, moe_one=None, tp_one=None,
                   family_one=None, frontend_one=None):
    """16b and 16c: two ranks that share the card, each a process of its
    own (``--dist-rank``), a gloo group on CUDA tensors (NCCL refuses two
    ranks on one device).  16b: their Qwen prunes must give 16a's masks
    and weights (within DIST_W_TOL): 1x2 those of 16a's one-device run,
    2x1 — whose ranks capture half the batches each, GEMMs of another
    shape — those of 16a's run in two calibration shards, and its
    agreement with the one-shard run is printed; each rank must launch
    hessian_accum and nm_select itself; the data-parallel trainers' steps
    must equal the one-rank runs' (paper_tiny_lm, and phi3.5-moe SMOKE:
    loss and aux).  16c: ``_tp_check``; 16d: ``_tp_family_check``; 16e:
    ``_tp_frontend_check``; 16f: ``tp_server_client`` streams to rank 0's
    server, then SIGTERM goes to both ranks, which must print
    "draining..." and exit 0; each rank must have launched paged_attn,
    and r0's armed worker death must have fired once, been restarted and
    failed requests over.  Returns (the ranks' launches, summed, and
    numbers)."""
    import tempfile

    import torch

    import threading

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        if "g" in parts:       # the one-device runs the ranks hold theirs to
            t0 = time.monotonic()
            g_one = train_16g_one(work)
            out["16g_one_s"] = time.monotonic() - t0
            say(f"  16g's one-device runs took {out['16g_one_s']:.1f} s")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE="2")
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
             work, parts], cwd=ROOT,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        # each rank's output, line by line; rank 0's server (16f) noted
        # when it says where it serves
        lines = [[], []]
        ready, up = threading.Event(), {}

        def pump(r):
            for line in procs[r].stdout:
                lines[r].append(line)
                m = re.match(r"serving on http://([\d.]+):(\d+)", line)
                if m and r == 0:
                    up.update(host=m.group(1), port=int(m.group(2)))
                    ready.set()
            if r == 0:
                ready.set()                      # the process ended

        pumps = [threading.Thread(target=pump, args=(r,), daemon=True)
                 for r in range(2)]
        for t in pumps:
            t.start()
        try:
            if "f" in parts:
                out["16f_client"] = tp_server_client(
                    lines[0], ready, up,
                    tp_one[TP_SERVER_CASE]["modes"]["continuous"]["streams"],
                    smi)
                for p in procs:                  # as torchrun signals them
                    p.send_signal(signal.SIGTERM)
            for p in procs:
                p.wait(timeout=900)
            for t in pumps:
                t.join(timeout=30)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        logs = ["".join(x) for x in lines]
        wall = time.monotonic() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"16b: rank {r} exited {p.returncode}: {text[-3000:]}")
            if "f" in parts and "draining..." not in text:
                fail(f"16f: rank {r} exited without draining: "
                     f"{text[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            if "b" not in parts:
                continue
            for spec, want in zip(("1x2", "2x1"), wants):
                got = torch.load(os.path.join(work, f"prune_{spec}_{r}.pt"))
                _dist_same(f"16b rank {r} {spec}", got, want)
                if spec == "2x1":
                    agree = [float(((got[k] == 0) == (w == 0)).float().mean())
                             for k, w in wants[0].items()]
                    out[f"2x1 mask agreement with one shard, rank {r}"] = \
                        min(agree)
            for name in ("train", "train_rep"):
                got = torch.load(os.path.join(work, f"{name}_{r}.pt"))
                for k, v in flat_one.items():
                    err = float((got[k] - v).norm()
                                / v.norm().clamp(min=1e-30))
                    far = int(((got[k] - v).abs()
                               > DIST_TRAIN_ENTRY_ABS).sum())
                    out.setdefault(f"{name}_rel", []).append(err)
                    out.setdefault(f"{name}_far", []).append(far)
                    if err > DIST_TRAIN_REL or far > (DIST_TRAIN_OUTLIERS
                                                      * v.numel()):
                        fail(f"16b rank {r} ({name}): trained {k} "
                             f"{err:.3e} from one rank's by norm, {far} "
                             f"entries past {DIST_TRAIN_ENTRY_ABS:g}")
    counts = {k: 0 for k in PRUNE_KERNELS}
    if "c" in parts:
        for k, v in _tp_check(ranks, tp_one, smi).items():
            counts[k] = counts.get(k, 0) + v
        out["16c"] = {r["rank"]: r["16c"] for r in ranks}
        say(f"  16c: the ranks' serving took "
            f"{max(r['16c_wall_s'] for r in ranks):.1f} s")
    if "d" in parts:
        for k, v in _tp_family_check(ranks, family_one, smi).items():
            counts[k] = counts.get(k, 0) + v
        out["16d"] = {r["rank"]: r["16d"] for r in ranks}
        say(f"  16d: the ranks' serving took "
            f"{max(r['16d_wall_s'] for r in ranks):.1f} s")
    if "e" in parts:
        for k, v in _tp_frontend_check(ranks, frontend_one, smi).items():
            counts[k] = counts.get(k, 0) + v
        out["16e"] = {r["rank"]: r["16e"] for r in ranks}
        say(f"  16e: the ranks' serving took "
            f"{max(r['16e_wall_s'] for r in ranks):.1f} s")
    if "g" in parts:
        out["16g"] = train_16g_check(ranks, g_one, smi)
        say(f"  16g: the ranks' training took "
            f"{max(r['16g_wall_s'] for r in ranks):.1f} s")
    if "f" in parts:
        f0 = ranks[0]["16f"]
        for r in ranks:
            if r["16f"]["counts"]["paged_attn"] <= 0:
                fail(f"16f: rank {r['rank']} never launched paged_attn")
            for k, v in r["16f"]["counts"].items():
                counts[k] = counts.get(k, 0) + v
        if (f0["fired"] != {"replica_worker": 1} or f0["restarts"] != 1
                or f0["failed_over"] < 1):
            fail(f"16f: the armed replica_worker death: fired "
                 f"{f0['fired']}, restarts {f0['restarts']}, failed over "
                 f"{f0['failed_over']}")
        out["16f"] = {r["rank"]: r["16f"] for r in ranks}
        say(f"  16f: r0's worker died mid-stream once; the supervisor "
            f"restarted it (mirrored to rank 1) and failed "
            f"{f0['failed_over']:g} requests over; SIGTERM: both ranks "
            f"printed draining... and exited 0; launches rank 0 "
            f"{f0['counts']}, rank 1 {ranks[1]['16f']['counts']}; the "
            f"server's run {max(r['16f']['wall_s'] for r in ranks):.1f} s "
            f"({smi})")
    if "b" not in parts:
        out.update(wall_s=wall)
        return counts, out
    for r in ranks:
        for spec in ("1x2", "2x1"):
            c = r[spec]["counts"]
            say(f"  16b rank {r['rank']} on {spec}: prune {r[spec]['wall_s']:.2f} "
                f"s; launches hessian_accum {c['hessian_accum']}, nm_select "
                f"{c['nm_select']}, flash_attn {c['flash_attn']}")
            for k in ("hessian_accum", "nm_select"):
                if c[k] <= 0:
                    fail(f"16b rank {r['rank']} {spec}: {k} never launched")
            for k in counts:
                counts[k] += c[k]
    losses = ranks[0]["train"]["losses"]
    for name in ("train", "train_rep"):
        for a, b in zip(ranks[0][name]["losses"], losses_one):
            if abs(a - b) > DIST_LOSS_ABS:
                fail(f"16b ({name}): data-parallel losses "
                     f"{ranks[0][name]['losses']} against one rank's "
                     f"{losses_one}")
    for r in ranks:
        for (loss, aux), (loss1, aux1) in zip(r["moe_train"], moe_one):
            if abs(loss - loss1) > DIST_LOSS_ABS or abs(
                    aux - aux1) > DIST_LOSS_ABS:
                fail(f"16b rank {r['rank']}: phi3.5-moe's data-parallel "
                     f"(loss, aux) {r['moe_train']} against one rank's "
                     f"{moe_one}")
    say(f"  16b: phi3.5-moe SMOKE, 3 steps of 8 x 32 on 2x1 (the global "
        f"batch routed across the ranks): (loss, aux) "
        f"{ranks[0]['moe_train']} against {moe_one} on one rank")
    say(f"  16b: both ranks' masks equal 16a's on 1x2 (one shard) and 2x1 "
        f"(two shards; least agreement of a linear with the one-shard run "
        f"{min(v for k, v in out.items() if 'agreement' in k):.6f}); the "
        f"data-parallel trainer's losses {losses} with FSDP, "
        f"{ranks[0]['train_rep']['losses']} replicated (one rank: "
        f"{losses_one}), params {max(out['train_rel']):.2e} / "
        f"{max(out['train_rep_rel']):.2e} apart by norm at most, "
        f"{max(out['train_far'])} / {max(out['train_rep_far'])} entries past "
        f"{DIST_TRAIN_ENTRY_ABS:g} in a leaf at most; wall {wall:.1f} s for "
        f"the two processes ({smi})")
    out.update(wall_s=wall, ranks=ranks)
    return counts, out


def dist_phase(smi, parts="abcdefg"):
    """Phase 16 (those of ``parts``; 16a runs for 16b too): (the mesh
    runs' launches — prune kernels, and 16c's and 16d's serving kernels
    — and numbers)."""
    import torch

    out = {}
    counts = {k: 0 for k in PRUNE_KERNELS}
    wants = flat_one = losses_one = moe_one = tp_one = family_one = None
    frontend_one = None
    if "a" in parts or "b" in parts:
        t = time.monotonic()
        say("  16a: a 1-rank NCCL group (--mesh host)")
        c, out["16a"], wants, flat_one, losses_one = dist_one_rank(smi)
        for k in counts:
            counts[k] += c[k]
        say(f"  16a took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "b" in parts:
        moe_one = moe_train()
    if "c" in parts or "f" in parts:        # 16f's streams are 16c's
        t = time.monotonic()
        with torch.no_grad():
            tp_one = tp_serve()
        out["16c_one_device"] = tp_one
        say(f"  16c's one-device runs took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "d" in parts:
        t = time.monotonic()
        with torch.no_grad():
            family_one = tp_family_serve()
        out["16d_one_device"] = family_one
        say(f"  16d's one-device runs took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    if "e" in parts:
        t = time.monotonic()
        with torch.no_grad():
            frontend_one = tp_frontend_serve()
        out["16e_one_device"] = frontend_one
        say(f"  16e's one-device runs took {time.monotonic() - t:.1f} s")
        torch.cuda.empty_cache()
    ranks = "".join(p for p in "bcdefg" if p in parts)
    if ranks:
        t = time.monotonic()
        say(f"  16{'/16'.join(ranks)}: two ranks on the one card (gloo)"
            + (", 1x2 and 2x1" if "b" in ranks else "")
            + (", 16c tensor-parallel serving on 1x2" if "c" in ranks
               else "")
            + (", 16d the recurrent and expert families on 1x2"
               if "d" in ranks else "")
            + (", 16e the prefix-LM and the encoder-decoder on 1x2"
               if "e" in ranks else "")
            + (", 16g the trainer with FSDP on 2x1 and tensor-parallel on "
               "1x2" if "g" in ranks else "")
            + (", 16f the server, its two replicas and the supervisor on "
               "1x2" if "f" in ranks else ""))
        c, out["16bc"] = dist_two_ranks(smi, ranks, wants, flat_one,
                                        losses_one, moe_one, tp_one,
                                        family_one, frontend_one)
        for k in c:
            counts[k] = counts.get(k, 0) + c[k]
        say(f"  the two ranks took {time.monotonic() - t:.1f} s")
    return counts, out


def partial_run(only, gen, rows, t_start) -> int:
    """``--phases``: phase 1's rows of PR 21 (hd 256, the window, the new
    widths) with the MoE widths' and the weighted hessian_accum's ("1"),
    those alone ("1m", "1w"), the xLSTM widths' rows ("1x"), the
    frontend models' rows ("1e": flash_attn with a prefix and S != T, the
    new widths), 16c's rank-local shapes ("1t"), phases 11, 12, 13, 14,
    15 and/or 16 (or parts of them), then a
    summary line; no result lines."""
    import torch

    out = {}
    if "1" in only:
        say("phase 1 (partial): flash_attn at hd 256 and windowed; nm_spmm "
            "at the new widths")
        out["flash_attn_hd256"] = check_flash_256(gen, rows)
        out["dense_widths"] = check_dense_widths(gen, rows)
        torch.cuda.empty_cache()
    if "1" in only or "1m" in only:
        say("phase 1 (partial): the kernels at the MoE models' widths")
        out["moe_widths"] = check_moe_widths(gen, rows)
    if "1" in only or "1w" in only:
        say("phase 1 (partial): the weighted hessian_accum")
        out["hessian_weighted"] = check_hessian_weighted(gen, rows)
        torch.cuda.empty_cache()
    parts = "abcd" if "12" in only else "".join(
        p[2] for p in sorted(only) if p.startswith("12") and len(p) == 3)
    if parts:
        say(f"phase 12 (partial: {parts})")
        out["serve"], out["prune"], out["dense"] = dense_variants(parts)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if "11" in only:
        say(f"phase 11 (partial; {smi})")
        out["counts_11"], out["frontend"] = frontend_on_card(smi)
    parts = "abc" if "13" in only else "".join(
        p[2] for p in sorted(only) if p.startswith("13") and len(p) == 3)
    if parts:
        say(f"phase 13 (partial: {parts})")
        out["serve_13"], out["prune_13"], out["moe"] = moe_phase(smi, parts)
    if "1x" in only:
        say(f"phase 1 (partial): the kernels at xlstm-350m's widths ({smi})")
        out["xlstm_widths"] = check_xlstm_widths(gen, rows)
    parts = "abcd" if "14" in only else "".join(
        p[2] for p in sorted(only) if p.startswith("14") and len(p) == 3)
    if parts:
        say(f"phase 14 (partial: {parts}; {smi})")
        out["serve_14"], out["prune_14"], out["xlstm"] = xlstm_phase(
            smi, parts)
    if "1e" in only:
        say(f"phase 1 (partial): flash_attn with a prefix and with S != T; "
            f"nm_spmm at the frontend models' widths ({smi})")
        out["flash_frontend"] = check_flash_frontend(gen, rows)
        out["frontend_widths"] = check_frontend_widths(gen, rows)
        torch.cuda.empty_cache()
    parts = "abcde" if "15" in only else "".join(
        p[2] for p in sorted(only) if p.startswith("15") and len(p) == 3)
    if parts:
        say(f"phase 15 (partial: {parts}; {smi})")
        out["serve_15"], out["prune_15"], out["frontend"] = frontend_phase(
            smi, parts)
    if "1t" in only:
        say(f"phase 1 (partial): the kernels at 16c's, 16d's and 16e's "
            f"rank-local shapes ({smi})")
        out["tp_widths"] = check_tp_widths(gen, rows)
    parts = "abcdefg" if "16" in only else "".join(
        p[2] for p in sorted(only) if p.startswith("16") and len(p) == 3)
    if parts:
        say(f"phase 16 (partial: {parts}; {smi})")
        out["prune_16"], out["dist"] = dist_phase(smi, parts)
    bad = [r for r in rows if not r["ok"]]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke_partial.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
        f.write(json.dumps({"rows": rows, **out}, default=str) + "\n")
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: "
             f"{[(r['kernel'], r['shape']) for r in bad]}")
    say(f"partial run (phases {sorted(only)}) passed in "
        f"{time.monotonic() - t_start:.1f} s")
    return 0


# ----------------------------------------------------------------------
def main(argv) -> int:
    """``argv`` empty runs every phase; ``--train-mamba OUT [STOP_AT]`` is
    phase 10's trainer process; ``--phases 1,12`` runs only phases 0, 1
    and 12 (a partial run: no result lines, exit 0 when they pass)."""
    if argv[:1] == ["--train-mamba"]:
        return train_mamba(argv[1], int(argv[2]) if len(argv) > 2 else None)
    if argv[:1] == ["--dist-rank"] and len(argv) in (2, 3):
        return dist_rank_main(*argv[1:])
    only = None
    if argv[:1] == ["--phases"] and len(argv) == 2:
        only = set(argv[1].split(","))
        if not only <= {"1", "1m", "1w", "1x", "1e", "1t", "11", "12", "12a",
                        "12b", "12c", "12d", "13", "13a", "13b", "13c", "14",
                        "14a", "14b", "14c", "14d", "15", "15a", "15b",
                        "15c", "15d", "15e", "16", "16a", "16b", "16c",
                        "16d", "16e", "16f", "16g"}:
            print("chip_smoke: --phases takes 1, 1m, 1w, 1x, 1e, 1t, 11, 12, "
                  "12a-12d, 13, 13a-13c, 14, 14a-14d, 15, 15a-15e, 16 and "
                  "16a-16g", file=sys.stderr)
            return 2
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    def head(msg):
        say(f"[{time.monotonic() - t_start:.0f} s; timing only so far: "
            f"device_ms {TIMING['device_ms_s']:.1f} s in "
            f"{TIMING['device_ms_calls']} calls, profiler runs "
            f"{TIMING['profiled_s']:.1f} s] {msg}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import build, ops

    # phases 8 and 10's trainers launch no kernel: they run beside the
    # build (a full run only)
    trainers = start_trainers() if only is None else None
    t0 = time.monotonic()
    build.library()
    head(f"phase 0: kernels built and loaded in {time.monotonic() - t0:.1f} s"
         f" (nvcc ran: {build.build_seconds is not None}"
         + ("; contended: beside phases 8 and 10's four trainer chains)"
            if trainers is not None else ")"))
    for line in build.ptxas_report().splitlines():
        LOG.append("  " + line)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    if only is not None:
        return partial_run(only, gen, rows, t_start)
    trained = trainers.result()
    head("phases 8 and 10's trainer chains done beside the build (the "
         "longest " + f"{max(w for _, w in trained.values()):.1f} s)")
    head("phase 1: kernels against their plain versions")

    def check(fn):
        """``fn(gen, rows)``, its seconds and its timing loops' printed."""
        t, d0 = time.monotonic(), TIMING["device_ms_s"]
        out = fn(gen, rows)
        say(f"  ({fn.__name__}: {time.monotonic() - t:.1f} s, its timing "
            f"loops {TIMING['device_ms_s'] - d0:.1f} s)")
        return out

    per_kernel = check(check_nm_spmm)
    paged_main, paged_long, paged_shared = check(check_paged)
    check(check_hessian)
    hess_rows = check(check_hessian_stacked)
    hess_w_rows = check(check_hessian_weighted)
    select_rows = check(check_nm_select)
    flash_rows = check(check_flash)
    flash_256 = check(check_flash_256)
    dense_rows = check(check_dense_widths)
    moe_rows = check(check_moe_widths)
    xlstm_rows = check(check_xlstm_widths)
    flash_frontend = check(check_flash_frontend)
    frontend_rows = check(check_frontend_widths)
    tp_rows = check(check_tp_widths)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: "
             f"{[(r['kernel'], r['shape']) for r in bad]}")

    head("phase 2: end to end, f32, Qwen width, 2 layers")
    e2e_f32()

    head(f"phase 3: main path, Qwen1.5-0.5B, {QWEN_SERVE_LAYERS} of 24 "
         "layers, bf16, 2:4-packed")
    counts, outs, hbm, engines, run_reqs = main_path()

    head("phase 3b: the reference's default serve features — prefix cache "
         f"with copy-on-write attach, host swap, cancel — Qwen1.5-0.5B, "
         f"{QWEN_SERVE_LAYERS} layers, bf16, 2:4-packed")
    counts_3b, features = default_serve_features(
        engines[0].model, engines[0].params, run_reqs[0])
    greedy = _streams(outs["8 requests, bf16 KV"][0])

    head("phase 3c: sampled decoding — temperature 0.8 with top-k 40, with "
         f"top-p 0.9, plain temperature 1.0 — Qwen1.5-0.5B, "
         f"{QWEN_SERVE_LAYERS} layers, bf16, 2:4-packed")
    counts_3c, sampled = sampled_decoding(engines[0].model,
                                          engines[0].params, run_reqs[0],
                                          greedy)

    head("phase 3d: static mode — one dense-cache bucket of the 8 requests, "
         "greedy and sampled (fori and while variants)")
    counts_3d, static = static_mode(engines[0].model, engines[0].params,
                                    run_reqs[0], greedy)

    head("phase 4: profile of main-path runs: 8 requests; the 512-token "
         "prompt at chunk 256 (the tiled nm_spmm)")
    prof = {"8 requests": profile_main(engines[0], run_reqs[0]),
            "512-token prompt": profile_main(engines[1], run_reqs[1])}
    del engines
    torch.cuda.empty_cache()

    head(f"phase 5: the launcher's default (pipelined) prune path, "
         f"Qwen1.5-0.5B, {PRUNE_LAYERS} layers, bf16, MM 2:4, 128 x 2048 "
         "calibration tokens")
    prune_counts, prune_run = prune_path()
    counts = {**{k: counts[k] + counts_3b[k] + counts_3c[k] + counts_3d[k]
                 for k in SERVE_KERNELS},
              **{k: prune_counts[k] for k in PRUNE_KERNELS}}
    counts["flash_attn"] += counts_3d["flash_attn"]
    torch.cuda.empty_cache()

    head(f"phase 5b: serial and pipelined engines at {PRUNE_CMP_LAYERS} "
         "layers, the same calibration; resume")
    cmp_run = serial_vs_pipelined(hess_rows)
    torch.cuda.empty_cache()

    head("phase 6: one f32 layer at Qwen width, kernels against plain")
    prune_layer_f32()
    torch.cuda.empty_cache()

    head("phase 8: train paper_tiny_lm (the reference's defaults), stop at "
         "150 and resume, prune the checkpoint (MM 2:4, SM 0.5), serve it "
         "sampled")
    counts_8, trained_8 = train_prune_serve(trained)
    counts = {k: counts[k] + counts_8[k] for k in counts}
    torch.cuda.empty_cache()

    head("phase 9: Jamba-1.5-Large's blocks without the experts at full "
         "width — 7 Mamba + 1 attention, d_model 8192, bf16, 2:4-packed "
         "mlp and attn linears; continuous, static, a starved pool, a "
         "shared stem")
    counts_9, hybrid = hybrid_full_width(gen, rows)
    torch.cuda.empty_cache()

    head("phase 10: the paper's Table 3 — paper-tiny-mamba trained on the "
         "card (stop at 150, resume), pruned by magnitude, wanda, SS, SM at "
         "0.5 and MM 2:4, served continuous against static")
    counts_10, table3 = mamba_table3(trained)
    counts = {k: counts[k] + counts_9[k] + counts_10[k] for k in counts}
    torch.cuda.empty_cache()

    head(f"phase 11: the serving front end — Qwen1.5-0.5B, "
         f"{QWEN_SERVE_LAYERS} layers (the CLI's server: 24), bf16, "
         f"2:4-packed, two replicas on one registry behind the HTTP/SSE "
         f"server and the supervisor; chaos, sampled, the CLI ({smi})")
    t11 = time.monotonic()
    counts_11, frontend = frontend_on_card(smi)
    say(f"  phase 11 took {time.monotonic() - t11:.1f} s; serving kernels' "
        f"launches over 11a-11c: {counts_11}")
    for k in SERVE_KERNELS:
        counts[k] += counts_11[k]

    head("phase 12: the dense decoders' attention variants — gemma-2b (hd "
         "256), Qwen3-14B (qk-norm), Gemma3-12B (qk-norm, 5 sliding-window "
         "layers to 1 global) — served and pruned at full width")
    t12 = time.monotonic()
    serve_12, prune_12, dense = dense_variants()
    for k in counts:
        counts[k] += serve_12.get(k, 0) + prune_12.get(k, 0)
    say(f"  phase 12 took {time.monotonic() - t12:.1f} s; launches: serving "
        f"{serve_12}, pruning {prune_12}")
    torch.cuda.empty_cache()

    head("phase 13: Mixture-of-Experts — phi3.5-moe (16 experts, top-2), "
         "kimi-k2 (384, top-8, a shared expert) and Jamba with its experts: "
         "kernels against plain, served static at full width, phi3.5 "
         f"pruned MS 2:4 ({smi})")
    t13 = time.monotonic()
    serve_13, prune_13, moe_out = moe_phase(smi)
    for k in counts:
        counts[k] += serve_13.get(k, 0) + prune_13.get(k, 0)
    say(f"  phase 13 took {time.monotonic() - t13:.1f} s; launches: serving "
        f"{serve_13}, pruning {prune_13}")
    torch.cuda.empty_cache()

    head("phase 14: the xLSTM — xlstm-350m (21 mLSTM, 3 sLSTM, d_model "
         "1024) served 2:4-packed at full width and depth, continuous, "
         "static and under forced recompute; the chunkwise form at 16384 "
         "and a 9216-token prefill; pruned MS 2:4 and trained 3 steps "
         f"({smi})")
    t14 = time.monotonic()
    serve_14, prune_14, xlstm_out = xlstm_phase(smi)
    for k in counts:
        counts[k] += serve_14.get(k, 0) + prune_14.get(k, 0)
    say(f"  phase 14 took {time.monotonic() - t14:.1f} s; launches: serving "
        f"{serve_14}, pruning {prune_14}")
    torch.cuda.empty_cache()

    head("phase 15: the prefix-LM and the encoder-decoder — paligemma-3b "
         "(18 layers, 256 image positions as a bidirectional prefix) and "
         "seamless-m4t-large-v2 (24 encoder + 24 decoder layers over 1024 "
         "frames) served static 2:4-packed at full width and depth, kernels "
         f"against plain; pruned MS 2:4, pipelined against serial ({smi})")
    t15 = time.monotonic()
    serve_15, prune_15, frontend_out = frontend_phase(smi)
    for k in counts:
        counts[k] += serve_15.get(k, 0) + prune_15.get(k, 0)
    say(f"  phase 15 took {time.monotonic() - t15:.1f} s; launches: serving "
        f"{serve_15}, pruning {prune_15}")
    torch.cuda.empty_cache()

    head("phase 16: distribution — a 1-rank NCCL group (--mesh host): the "
         f"prune launcher's engine on Qwen1.5-0.5B ({DIST_LAYERS} layers, MM "
         "2:4), hessian_allreduce, prune_matrix_sharded, compressed_psum, "
         "the trainer with grad_compression; two ranks on the one card "
         f"(gloo): 1x2 row-parallel solves, 2x1 sharded calibration and "
         f"data-parallel training (paper_tiny_lm, phi3.5-moe SMOKE); 16c "
         f"tensor-parallel serving on 1x2 (Qwen1.5-0.5B {DIST_LAYERS} "
         f"layers bf16 and f32, Qwen3-14B {TP_QWEN3_LAYERS} layers); 16d "
         f"the recurrent and expert families on 1x2 (Jamba's first "
         f"{TP_JAMBA_SLOTS} slots without the experts, xlstm-350m "
         f"{TP_XLSTM_LAYERS} layers, phi3.5-moe {TP_PHI_LAYERS} layers; bf16 "
         f"and f32); 16e the prefix-LM and the encoder-decoder on 1x2 "
         f"(paligemma-3b 2 of 18 layers, seamless-m4t-large-v2 2 + 2; bf16 "
         f"and f32); 16g the trainer on Qwen1.5-0.5B ({DIST_LAYERS} layers, "
         f"f32 and bf16) with FSDP on 2x1 and tensor-parallel on 1x2, and "
         f"2x1's checkpoint resumed on 1x2; 16f the server under 1x2 "
         f"(Qwen1.5-0.5B {DIST_LAYERS} layers f32, two replicas, a worker's "
         f"death, SIGTERM) ({smi})")
    t16 = time.monotonic()
    prune_16, dist_out = dist_phase(smi)
    for k in prune_16:
        counts[k] += prune_16[k]
    say(f"  phase 16 took {time.monotonic() - t16:.1f} s; launches (16a's "
        f"mesh run, 16b-16f's two ranks): {prune_16}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: "
             f"{[(r['kernel'], r['shape']) for r in bad]}")

    sources = {"nm_spmm": ("nm_spmm.cu", "nm_spmm.py:68"),
               "nm_spmm_decode": ("nm_spmm.cu", "nm_spmm.py:130"),
               "paged_attn": ("paged_attn.cu", "paged_attn.py:97"),
               "hessian_accum": ("hessian_accum.cu", "hessian_accum.py:36"),
               "nm_select": ("nm_select.cu", "nm_select.py:65"),
               "flash_attn": ("flash_attn.cu", "flash_attn.py:76")}

    def agg(name, rs, at, **extra):
        cu, tpu = sources[name]
        lib = [r["library_ms"] for r in rs]
        return {**extra, "name": name, "route": "cuda", "check": "pass",
                "source": f"src/repro_torch/kernels/csrc/{cu}",
                "replaces": f"src/repro/kernels/{tpu}",
                "launches": counts[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["kernel"] == name),
                "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": rs[0]["bound_by"],
                "library_ms": None if None in lib else sum(lib),
                "at": at}

    kernels = [
        agg("nm_spmm_decode", per_kernel["nm_spmm_decode"],
            "sum over the 7 linears of one layer, M=8, bf16"),
        agg("nm_spmm", per_kernel["nm_spmm"],
            "sum over the 7 linears of one layer, M=256, bf16"),
        agg("paged_attn", [paged_shared],
            "B=8 KV=16 G=1 hd=64 ps=16, bf16 pages, every live row's first "
            "3 pages shared (a prefix-cache attach, phase 3b); unshared "
            f"B=8 {paged_main['ms']:.5f} ms, SDPA "
            f"{paged_main['library_ms']:.5f}; the long-prompt run's step "
            f"(B=8, p_max=36, one slot at 544 keys) {paged_long['ms']:.5f} "
            f"ms, SDPA {paged_long['library_ms']:.5f}"),
        agg("hessian_accum", hess_rows,
            "sum of m=1024 and m=2816, T=262144 bf16 tokens (the stacked "
            "capture), α=1/T β=0; the weighted route under 'weighted'",
            weighted={r["shape"]: {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "route")} for r in hess_w_rows}),
        agg("nm_select", select_rows,
            "sum over one 128-column block of each of the 7 linears, bf16 w"),
        agg("flash_attn", flash_rows[1:],
            "B=128 T=2048 H=16 KV=16 hd=64 bf16 causal (the stacked "
            "capture); plain over 16 slices of B=8; the prefix-LM's and "
            "the cross-attention's shapes under 'frontend'",
            frontend={r["shape"]: {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "route")} for r in flash_frontend}),
    ]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
        f.write(json.dumps({"rows": rows, "profile": prof,
                            "default_serve": features, "sampled": sampled,
                            "static": static, "prune": prune_run,
                            "serial_vs_pipelined": cmp_run,
                            "train_prune_serve": trained_8,
                            "hybrid_full_width": hybrid,
                            "table3": table3, "frontend": frontend,
                            "flash_attn_hd256": flash_256,
                            "dense_widths": dense_rows,
                            "moe_widths": moe_rows,
                            "xlstm_widths": xlstm_rows, "xlstm": xlstm_out,
                            "flash_frontend": flash_frontend,
                            "frontend_widths": frontend_rows,
                            "tp_widths": tp_rows,
                            "frontend": frontend_out,
                            "dense_variants": dense,
                            "hessian_weighted": hess_w_rows, "moe": moe_out,
                            "dist": dist_out},
                           default=str) + "\n")
    say(f"timing only: device_ms {TIMING['device_ms_s']:.1f} s in "
        f"{TIMING['device_ms_calls']} calls, profiler runs "
        f"{TIMING['profiled_s']:.1f} s")
    say(f"all phases passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
