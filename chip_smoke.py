#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any mismatch raises and the run exits non-zero:

1. the card's name and power limit, and the build of every CUDA kernel
   from the sources in this checkout (``kernels/_build.py``, one ``nvcc``
   per source, all in parallel); the tensor-core kernels of B1 and B2
   (``dequant_tc.cuh``) must hold HGMMA instructions in their SASS
   (``kernel_bench.sass_counts``);
2. kernel phase: the packed dequant-matmul kernel against its plain
   PyTorch twin for int4/int3/int2 payloads at the serving path's shapes
   (m ∈ {1, 8}, the decode kernel, and m ∈ {TC_MIN_M, 128, 256},
   the tensor-core kernel, each call checked to have taken its path; (k,
   n) ∈ {(2304, 2304), (2304, 5760), (5760, 2304)}), the ragged (2300,
   5757) and (301, 37) at m = 130, plus a ragged-k case and an escape
   case, each kernel call run twice (equal
   bits: the split-K sums are added in a fixed order, and the escapes in
   (row, col) order, also for a permuted COO); each case prints the
   kernel time,
   the twin's time, one library call's time (``F.linear`` against the
   pre-dequantized f32 weight) and the least time the card could take
   (``bound_ms``, the larger of the bytes over 3.35 TB/s and the 2·m·n·k
   multiply-adds done exactly on the bf16 tensor cores: codes are exact in
   bf16 and f32 x·s splits into three bf16 terms, 3 products at 989
   TFLOP/s; the f32 CUDA-core time of the same count, at 67 TFLOP/s, is
   ``f32_cuda_core_ms`` in the detail file);
2b. int8 kernel phase: the int8 dequant-matmul kernel against its twin
   (``ref.dequant_matmul_ref``) at (k, n) ∈ the three shapes above and
   m ∈ {1, 8} ∪ {TC_MIN_M, 128, 256}, with the codes stored (k, n) as a serving leaf
   stores them and read in place through their transposed view, and in
   an (n, k)-contiguous matrix (copied by the wrapper into that layout),
   plus the ragged (2300, 5757) at m = 8 and (2300, 5757), (301, 37) at
   m = 130; each run twice (equal bits).  The
   serving layout is timed with L2 cold: the kernel, the twin, ``F.linear``
   against the pre-dequantized weight and the plain product the serving
   path ran before the kernel (``before_ms``), with the bound (bytes
   against the 2·m·n·k multiply-adds on the bf16 tensor cores in a
   3-term split, as phase 2);
2c. prefill kernels: B1 (int4) and B2 at m = 256 (8 prompts of 32
   tokens) on the three shapes, timed as above (the tensor-core path);
3. the ZSIC block kernel against its twin, bit for bit, at bn = 128 and the
   PTQ path's row counts (230, 576, 2304, 5760), with its bound (bytes of
   y, codes, residual and the L block against the a·bn·(bn+1)/2 unfused
   multiply-subtracts, 2 f32 instructions each, and the a·bn divisions and
   roundings on the CUDA cores; no library call computes ZSIC), its event
   time (L2 cold) beside its device time (``torch.profiler``, warm); then one
   full ``zsic_quantize`` at (2304, 2304), which launches the kernel on
   strided column slices as the PTQ path does, against the same run through
   the twin (bit for bit) and against ``zsic_numpy`` in float64 (≥ 99.9 %
   of the codes equal, Lemma 3.2);
4. the flash attention kernel against its twin at minicpm-2b's heads
   (B·H = 4·36, d = 64), S ∈ {128, 256, 200}, window ∈ {0, 64}, causal,
   with ``F.scaled_dot_product_attention`` timed as the library call (never
   called by the port); untimed, d = 128 and d = 256 (B·H = 4), S = 1, S
   below one query tile and a ragged S without the causal mask;
5. serve phase: minicpm-2b at full width and depth, packed int4,
   ``ContinuousEngine`` with 8 slots serving 8 requests (prompt 32, 16 new
   tokens, max_len 64, prefill chunk 16).  First-step logits through the
   kernel are held against the dequantized-weight model, and the kernel
   must have been launched 7 × 40 times per decode step; then a few
   decode steps at that batch are timed on the host clock and traced with
   ``torch.profiler`` for the device's busy and idle share of the step and
   the packed kernels' device time; one decode step captured in a CUDA
   graph must hold one device kernel per packed dense (its kernel nodes
   counted by name: the profiler now and then drops the record of a
   kernel launched as a thread-block cluster);
5b. prefill phase: ``models.prefill`` of 8 prompts of 32 tokens at 40
   layers (each dequant kernel once per layer of each of its leaves, all
   of them at m = 256 on the tensor-core kernel, flash once per layer)
   against ``decode_chunk`` over the same prompts: cache and last logits
   within LOGIT_TOL of the largest value; also for the mixed tree in
   phase 10 and the int3 and int2 trees of phase 6.  Every serve run
   (the engines step m = slots rows, also in their prefill chunks:
   ``decode_chunk`` is C decode steps) must hold no tensor-core launch,
   every prefill, encode and cross-K/V run only tensor-core launches;
5c. obs serve phase: the serve phase's traffic with ``repro_torch.obs``
   off and on (equal streams, both step times printed), then int8, int3
   and int2 at 4 layers with it on; the Chrome trace, Prometheus text,
   JSONL log and a bench JSON go to ``chiprun_out/obs_*`` and
   ``benchmarks/check_obs.py`` and ``check_bytes.py`` run on them
   unchanged (a nonzero exit fails the smoke);
6. ladder phase: the same at full width and 4 layers for int3 and int2,
   each also through ``prefill`` (phase 5b);
7. PTQ phase: minicpm-2b at full width cut to 1 layer (PTQ_LAYERS, for
   the smoke's time), weights from the
   port's ``init_params`` (seed 0), calibration 2 batches of 4 × 128 and
   evaluation 1 batch of 4 × 257 numpy tokens.  ``quantize_model`` runs
   ``watersic`` (the LMMSE column loop) and ``hptq`` (the ZSIC kernel) at
   3 bits; each prints its realized rate (within 0.05 of 3), seconds per
   matrix, ZSIC-kernel launches (> 0 for hptq) and, from the same run, the
   synchronized host time of its main spans; ``model_ppl`` of the
   float, watersic and hptq models runs through the flash kernel (one
   launch per layer and batch) and through the twin;
8. serve-after-PTQ phase: the watersic codes installed as packed int4
   leaves (``from_watersic``, escapes included) serve 4 requests (prompt
   16, 8 new tokens) twice (equal streams); first-step logits against the
   model with ``QuantizedLinear.dequant()`` weights; each escaped leaf's
   product equal bit for bit on a rerun and for a permuted COO;
8b. gptq phase: the PTQ phase's model and calibration (7 matrices):
   WaterSIC (no LMMSE) at 3 bits and Huffman-GPTQ at each matrix's
   WaterSIC rate, both through the ZSIC kernel; each method's rate and
   weighted distortion Σ N·D; for one (2304, 2304) matrix the card's GPTQ
   codes against float64 ``gptq_frantar`` on the flipped order (≥ 99.9 %
   equal; the oracle runs in a host process of its own beside the later
   phases and is read at the end) and the rANS bits per entry beside the
   empirical entropy;
8c. flash grad phase: q/k/v grads through the flash wrapper (forward: the
   kernel) against the twin's at the ``model_ppl`` shape, and
   ``loss_fn``'s wq/wk/wv grads on the PTQ phase's model against the twin
   path's (GRAD_TOL);
9. plan phase: ``python -m repro_torch.launch.plan build`` in process
   (minicpm-2b at full width cut to 2 layers, numpy weights and tokens
   from seed 0, 2 calibration batches of 32 × 128, ``output`` weighting,
   5.0 bits per parameter): the snapped plan must hold int8 and sub-byte
   payloads, reload equal and ``inspect``; ``plan_inputs_for_model`` +
   ``execute_plan(quantize_kwargs={"lmmse": False})`` (WaterSIC spacing,
   ZSIC through its kernel) runs the snapped plan on 1 and on 4 worker
   threads (codes, α, γ and t equal tensor for tensor), then the
   continuous waterfilled optimum and ``even_plan`` at the same budget:
   realized bits within 0.05 of planned each, and the waterfilled
   weighted output distortion below the even spread's;
10. mixed serve phase: ``serving_formats_from_plan`` of that plan on
   minicpm-2b at full width and depth (40 layers): the int8 types through
   the int8 kernel, the others through the packed one (each kernel once
   per layer of each of its leaves per decode step, and a decode step
   captured in a CUDA graph holding one device kernel per int8 and per
   packed call),
   first-step logits against the dequantized-weight model, the serve
   phase's 8 requests;
   then a 2-layer copy's greedy streams from ``ServeEngine`` and
   ``ContinuousEngine`` must be identical.

Serving resilience and the rest of the serving path (each report line
carries the card's name and power limit; every kernel count is zeroed
just before a phase and read just after, and the phase fails if a kernel
of its path never launched):

5d. resilience serve: the serve phase's traffic at full width and
   CHECK_LAYERS (8) layers (a fresh int4 tree of that depth) with
   ``ResilienceConfig(retry, integrity_every=8, snapshot_every=5)``
   against the same traffic with it off: equal streams; both step times,
   one integrity check's time (crc32 of every payload, copied to the
   host) and one snapshot's;
5e. int8 KV (``REPRO_OPTS=int8_kv``) on that tree: the exact prefill's
   int8 cache equals ``q8`` of the f32 prefill's cache at every layer and
   after the first decode step the new layer-0 rows equal ``q8`` of the
   f32 cache's new rows, bit for bit (deeper rows attend to a dequantized
   prefix: reported); first-step logit difference, greedy agreement over
   the serve traffic, KV bytes and step time against the f32 cache;
6b. chaos matrix: ``repro_torch.launch.chaos`` at full width cut to 4
   layers, packed int4, each of the five fault kinds at seed 0, each
   summary and trace passing ``benchmarks/check_chaos.py`` unchanged;
   then B1's product of the leaf a corrupt-payload plan flips changes and
   returns bit for bit after ``PayloadGuard.heal``;
6c. degrade ladder: int4 → int3 → int2 at full width cut to 4 layers,
   12 requests on 2 slots (high watermark 4): all complete; the rung
   trace and the step time per rung;
11. quality and requant: the reference bench's two quality cells and its
   requant cell at its own model (``BENCH_CFG``: 4 layers, d 256) pass
   ``check_quality.py`` and ``check_requant.py`` (no ``--baseline``: it
   holds the reference's numbers from another platform); then one
   requant actuation at full width cut to 2 layers, its limit fixed at
   1.5× the clean phase's largest Frobenius shift before the drift
   phase, reporting both, the actuation's wall time and the launches of
   the step that serves the swapped tree (the re-plan quantizes with the
   reference's LMMSE column loop, which is no kernel: B4 is not on this
   path).

The MoE family (phi3.5-moe-42b-a6.6b at full width: d 4096, 32/8 heads,
16 experts of d_ff 6400, top-2), last:

12. MoE serve: 4 of its 32 layers (the serving tree keeps the stacked
   experts f32, as the reference's does: 5.03 GB a layer), attention
   packed int4 through B1; first-step logits against the
   dequantized-weight model; the serve phase's traffic on the continuous
   engine, B1 4 × 4 times per decode step; the step's wall time, traced
   idle share and a CUDA graph of one step holding one B1 kernel per
   packed dense; a rerun of the continuous engine with equal streams,
   two ``moe`` calls with equal bits; the static engine's streams against
   the continuous engine's (reported only: capacity couples the rows of a
   step); one decode step of an int8-attention copy through B2 (16
   launches);
12b. MoE expert codes: one unstacked layer's experts (16, 4096, 6400)
   as int8 and as packed int4 leaves: ``moe`` against the same layer with
   dequantized experts (KERNEL_TOL), equal bits on a rerun; then one
   full-width moonshot-v1-16b-a3b layer packed int4, whose (2048, 64)
   router runs through B1 (one launch per call), against the dequantized
   layer;
12c. MoE prefill: 8 × 32 at the serve depth against ``decode_chunk``
   with capacity factor E/k = 8 (no pair dropped: held to LOGIT_TOL), and
   at the config's 1.25 (reported only);
12d. MoE PTQ: ``quantize_model`` (hptq, 3 bits) of 1 full-width layer
   on 2 × 4 × 128 calibration tokens: 52 matrices, realized rate within
   0.05, B4 launches, finite ``model_ppl``; each expert's Σ_X comes from
   at most 128 routed tokens (rank deficient, reported);
12e. MoE plan: ``launch.plan build`` of that layer (output weighting,
   4.0 bits), executed through B4: realized bits within 0.05 of planned;
   ``probe`` weighting refused.

The recurrent families (rwkv6-7b: ssm, d 4096, d_ff 14336, 64 heads of
64, decay LoRA 64; recurrentgemma-2b: hybrid, d 2560, RG-LRU width 2560,
10 query heads over 1 KV head of 256, window 2048, d_ff 7680), after the
MoE phases, on the serve phase's traffic:

13. recurrent kernels: B1 (packed int4) and B2 against their twins at
   m = 8 at every (k, n) of the two families, rwkv's (4096, 4096), (4096,
   64), (64, 4096), (4096, 14336), (14336, 4096) and recurrentgemma's
   (2560, 5120), (2560, 2560), (2560, 256), (2560, 7680), (7680, 2560),
   each run twice with equal bits, timed as in the kernel phase;
13b. rwkv6-7b at full width and depth (32 layers), every dense packed
   int4: init time and peak memory; the first decode step against the
   dequantized-weight model layer by layer (``models.decode_layers``:
   each layer of both trees gets the oracle's input x to it; its block's
   contribution y − x, its state and the logits within LOGIT_TOL of the
   largest value; the end-to-end logits reported, with the float model's
   own rounding amplification, which must exceed LOGIT_TOL); the
   continuous engine's streams (B1 10 ×
   32 times per decode step), the step's breakdown (its CUDA graph holds
   one B1 node per packed dense), B1's and the WKV recurrence's device
   time per step; a rerun and ``ServeEngine`` with equal streams; one
   decode step of an int8 copy through B2 (320 launches, held the same
   way); ``prefill`` of 8 × 32 stepped and parallel
   (``REPRO_OPTS=parallel_prefill``), both timed, held to each other
   layer by layer (``models.prefill_layers`` against each layer's decode
   steps), end to end reported;
13c. recurrentgemma-2b at full width and depth (26 layers: 8 groups and
   the 2-layer tail): the same, B1 7 × 26 times per decode step, the
   RG-LRU update and scan timed, and its first steps (int4 and int8) and
   prefill also held end to end;
13d. windowed hybrid: recurrentgemma at full width, 5 layers (one group
   and the tail), window 16 under 32-token prompts: parallel prefill
   against stepped layer by layer and end to end (the ring's slots among
   the state leaves, the next step's logits), continuous
   against static streams with an f32 and an int8 KV cache, and under
   ``int8_kv`` the parallel prefill's codes and scales ``q8`` of the f32
   parallel prefill's K/V bit for bit, the stepped prefill's codes within
   one of them.

The encoder–decoder and prefix-LM families (whisper-base: 6 encoder and
6 decoder layers, d 512, 8 heads of 64, d_ff 2048, 1500 frames;
paligemma-3b: 18 layers, d 2048, 8 query heads over 1 KV head of 256,
d_ff 16384, 256 prefix positions), last, at full width and depth on the
serve phase's traffic:

14. encdec/vlm kernels: B1 (packed int4) and B2 at m = 8 at every (k, n)
   of the two families, whisper's (512, 512), (512, 2048), (2048, 512)
   and paligemma's (2048, 2048), (2048, 256), (2048, 16384), (16384,
   2048); B1 at their full-sequence rows (m = 8·1500 = 12000 for
   whisper's encoder and cross K/V, m = 8·288 = 2304 for paligemma's
   prefill); B3 non-causal at whisper's encoder (B·H = 64, S = 1500, d =
   64; SDPA the library call); each against its twin, twice with equal
   bits for B1/B2, timed as in the kernel phase;
14b. whisper-base, packed int4, frames (8, 1500, 512) from a seed:
   ``encode`` (36 B1 at m = 12000, 6 B3 non-causal), ``capture_cross_kv``
   (12 B1) and ``prefill`` (those and the decoder's 48 B1 and 6 B3
   causal), timed and counted; the prefill's self K/V and cross K/V
   against ``capture_cross_kv`` + ``decode_chunk`` over the prompt; 16
   greedy decode steps after the prefill, its logits and every step's
   against the dequantized model's ``forward_train`` over the frames and
   [prompt; served tokens]; then the continuous engine on token-only
   requests (the cross K/V stay zero, as the reference's engines leave
   them): first step against the dequantized model, 48 B1 per step and in
   a CUDA graph of one step, traced idle share, a rerun and the static
   engine with equal streams, one int8 step through B2 (48 launches);
14c. paligemma-3b, packed int4, patches (8, 256, 2048): ``prefill`` of
   256 + 32 positions (126 B1 at m = 2304, no B3: GQA and the prefix-LM
   mask take the plain softmax, as in the reference), then as whisper's
   (126 B1 and B2 per step).

The registry's largest dense configs at full width and depth, each
served int4 from the serve driver's layer-by-layer build
(``launch.serve.serving_tree``: no whole f32 tree is made; qwen2.5-32b's
is 128 GB) on the serve phase's traffic, after those:

14d. large kernels: B1 (packed int4) against its twin at every (k, n)
   of their decode steps (qwen2.5-32b's (5120, 5120), (5120, 1024),
   (5120, 27648), (27648, 5120); qwen1.5-32b's (5120, 27392), (27392,
   5120); minitron-8b's (4096, 4096), (4096, 1024), (4096, 16384),
   (16384, 4096)) at m = 8 and 128, timed as in the kernel phase;
14e. qwen2.5-32b (64 layers), qwen1.5-32b (64, MHA) and minitron-8b
   (32, relu², non-gated): the build's peak memory below the served tree
   plus 3 layers of f32; the first decode step against the float-weight
   model computed one layer at a time (``LayerByLayer``: each layer's
   leaves dequantized when reached, then dropped), end to end and layer
   by layer within LOGIT_TOL; the continuous engine's streams (B1 7 ×
   64, 7 × 64 and 6 × 32 times per decode step) equal to the static
   engine's; qwen2.5-32b's step breakdown (its CUDA graph holds 448 B1
   nodes) and its step counted by the cost counter (cost phase (e), as
   (a)); the serve's peak memory printed;
14f. one full-width qwen2.5-32b layer quantized by ``watersic-plain``
   at 3 bits through ``quantize_model`` on 32768 calibration tokens
   (every Σ_X full rank), its peak memory printed: the
   realized rate within 0.05 bits, B4's launches equal to the 128-column
   blocks of the rate searches' ZSIC passes, B4 against its twin at the
   row counts it ran at; the codes served as packed int4 with escapes
   (``from_watersic``), held against the layer of the dequantized codes
   within LOGIT_TOL.

Training on one device (minicpm-2b, the WSD schedule), last:

15. train: ``python -m repro_torch.launch.train``'s ``main`` at full width
   and depth (40 layers), 4 steps of 8 × 64 tokens in 2 microbatches,
   bf16 compute over f32 masters, no checkpoint (a full-depth state
   writes 33 GB): a finite loss and B3 n_layers × n_micro times per step
   (bf16 q/k/v, cast to f32 around the kernel); the same step through
   ``make_train_step``: synchronized medians of steps 2 onward, tokens/s,
   peak memory, one traced step's device-busy time and idle share, the
   step's bound (6·N·T flops at the bf16 peak against 7 × 4 bytes per
   parameter moved by the update); then one f32 step at 2 layers through
   the kernel against the same step with the twin in its place
   (``train_kernel_oracle``: loss, grads and updated params, the
   tolerance in its docstring);
16. lifecycle (tests/test_system.py::test_full_lifecycle at full width,
   1 layer): 60 bf16 steps under ``torch.use_deterministic_algorithms``
   uninterrupted and through ``run_with_restarts`` (a checkpoint every 30
   steps, failures at steps 10 and 40): losses and final state equal bit for
   bit, the loss falling; WaterSIC, HPTQ (B4) and Huffman-GPTQ (B4, at
   WaterSIC's per-matrix rate) of the trained weights at 2.5 bits on 6144
   calibration tokens (Σ_X full rank), realized rates within 0.05 and
   ``model_ppl`` of each recorded; ``finetune_rescalers`` 40 steps (the
   KL and ppl gates of tests/test_quant_pipeline.py); the trained codes
   served packed int4 through B1 (first step within LOGIT_TOL of the
   dequantized model, equal streams on a rerun) and int8 through B2
   (first step within 2e-2, equal streams on a rerun); last the trained
   tiny-MoE ordering of tests/test_quant_moe.py, recorded.

Tensor-parallel k-sharded serving (DESIGN.md §13), last: 4 rank
processes share the card (``launch.mesh``: gloo, since NCCL takes one rank
per card; partials and K/V blocks meet in device memory mapped through
CUDA IPC; the weights, shared with the ranks the same way, never cross):

17. shard kernels: B1 (packed int4) and B2 against their twins at the
   k-shard shapes of minicpm-2b at 4 shards, (k_loc, n) ∈ {(576, 2304),
   (576, 5760), (1440, 2304)}, m ∈ {8, 256}, timed as in the kernel phase;
17b. mesh: minicpm-2b packed int4 at full width cut to MESH_FULL_LAYERS
   (4 of its 40, for the smoke's time), sharded 4 ways
   (``serve.shard_params_tree``): the single-process oracle's first step
   (the sharded tree here) within LOGIT_TOL of the unsharded dequantized
   model, 4 × 7 × 4 B1 launches per step; then one launch of 4 ranks
   serves the serve phase's traffic (max_len 64: the K/V buffer shards),
   every rank's streams equal to the oracle's bit for bit, 7 × 4 B1
   launches per rank per decode step, float all-gathers only (no integer one: no
   weight byte crossed), each rank's step time, B1 time, all-gathers and
   bytes printed; the reference test's crc32 format mix at 2 layers (B2 on
   its int8 shards) equal to its oracle; seeded device-loss chaos at 2
   layers recovered equal to the clean mesh run; last ``python -m
   repro_torch.launch.serve --mesh --ranks 4`` at 2 layers and
   ``benchmarks/check_mesh.py`` unchanged on its JSON.

Last the training-mesh phases (``training_mesh_phases``): 4 ranks share
the card under gloo and their collectives meet in the CUDA-IPC mailboxes:

18. (a) compressed DP: minicpm-2b at full width cut to 2 layers, 4 ranks
   × 2 rows of 64 tokens, 6 steps of ``make_compressed_step`` (bf16,
   deterministic algorithms): every rank's (params, opt) checksum equal
   after every step and equal to an in-process oracle that runs the 4
   shards one after another with the same compress and int32 sum, each
   rank's error buffers equal to its shard's in the oracle, losses within
   1e-6 of the oracle's (an f32 sum of 4 losses), finite loss and grad
   norm, non-zero errors, B3 4 per rank per step, and the collective log
   1 B of int8 per parameter and one scalar max per leaf; each rank's step
   time (median of steps 2–6), collectives, bytes and peak printed;
18b. (d) elastic restore, in the same rank launch: the 2-layer params
   saved once and restored onto a (2, 2) mesh with ``param_specs_tree``'s
   specs: every block equal to its slice of the saved tree, the blocks
   gathered back equal to it, each rank's bytes against the whole;
18c. (b) ``launch.train --ranks 4`` (deterministic algorithms, which
   ``launch_ranks`` passes on to the ranks) at 2 layers, 8 × 64
   tokens per step, 6 steps: the uninterrupted run (its rank body, in the
   same rank launch), then ``launch.train.main`` resuming its step-3
   checkpoint with 4 ranks (each driver checks that its ranks' states are
   equal and records the checksum in its manifests): the two step-6
   states equal; one process over the whole batch within 1e-2 relative of
   the last loss and 2·lr per step of the params;
18d. (c) phi3.5-moe at full width, one layer, capacity factor 8 (no pair
   dropped on either path), on a (1, 4) mesh with ``moe_a2a``: the
   ``moe`` layer forward and backward on 8 × 64 tokens, its output,
   x-grad, router grad and each rank's expert-block grads within 1e-4 of
   max of the local ``moe`` in this process; then two bf16 train steps
   with the experts cut by ``expert_specs``: the replicated params
   bit-identical across ranks, each loss within 1e-2 relative of the
   single-process step's;
19. the cost tooling (``launch.hlo_cost``, ``launch.roofline`` with the
   H100 SXM's published peaks, ``launch.dryrun``): (a), right after the
   serve phase's step breakdown, one int4 decode step at 8 slots under
   the step cost counter, its counted B1 launches equal to the wrapper's
   count and to the CUDA graph's kernel nodes (7 × 40), its modeled
   bound beside the measured step (the roofline fraction); (b) the
   one-process train step of phase 20 (8 × 64 tokens in 2
   microbatches, at its FSDP_LAYERS) counted likewise, 40 B3 launches;
   (c) the counter's
   trace of one rank's mesh decode step on meta tensors under
   ``ShapeMesh(data=1, model=4)``, its collective log equal op for op to
   each rank's ``HostMesh`` log of its measured step in phase 17b; (d)
   minicpm-2b's train_4k, prefill_32k and decode_32k dry-run cells on
   the 256-rank mesh and decode_32k on the 512-rank one, traced on meta
   tensors in a process of their own while the kernels build, each
   ``ok``;
20. FSDP × TP (run after phase 16, before the mesh phases, whose rank
   launches leave CUDA tensors shared with their ranks in this process):
   minicpm-2b at full width cut to FSDP_LAYERS (20 of its 40, for the
   smoke's time) trained by 4 ranks
   sharing the card on a (data 2, model 2) mesh (gloo, CUDA-IPC
   mailboxes), 4 bf16 steps of 8 × 64 tokens (each rank's 4 rows in one
   microbatch): the one-process step first (in 2 microbatches; alone:
   its 56 GB do not fit beside the ranks), its final params saved for
   the ranks; each rank's first loss
   within 1e-3 and last loss within 1e-2 relative of the one process's,
   its blocks within 2·lr per step of the same cut of the one process's
   params and equal to their ``NamedSharding`` cut of the gathered
   leaves, B3 20 per rank per step, and its collective log of step 1
   equal op for op to the counter's ``ShapeMesh(data=2, model=2)``
   trace of that rank's step.  Its second part, right after: the MoE,
   ssm and hybrid families at full width, cut in depth
   (moonshot-v1-16b-a3b at 2 layers, rwkv6-7b at 4, recurrentgemma-2b at
   8: two (rec, rec, attn) groups and a 2-layer tail), each one's
   one-process run first and alone (3 bf16 steps of 8 × 64 tokens in 2
   microbatches, final params saved), then ONE launch of the same mesh
   whose ranks train the three in turn, each rank its 4 rows in one
   microbatch (so each MoE call sees the rows of one of the one
   process's microbatches), held as the minicpm-2b cell; B3 2 per rank
   per step on the MoE model (8 q and 8 kv heads per rank), 0 on the
   others (rwkv6 has no attention, the hybrid's is MQA).

The second-to-last line is the kernel summary JSON (ten entries: the
packed kernel per payload, the int8 kernel, their tensor-core kernels
(``*_tc``: launches summed over the prefill, encode and cross-K/V runs,
times at one prefill layer's mix at m = 256), ZSIC and flash; B1 int4's and
B2's launches include the recurrent, whisper and paligemma serve runs and
int8 steps, the large dense configs' and the WaterSIC layer's serve runs,
the lifecycle's served codes, the mesh phases' oracle and
rank runs and the counted decode step of phase 19, flash's whisper's
encode and prefill and the training phases' (the driver's steps, the
lifecycle's training, ``model_ppl`` and fine-tune, the compressed DP
ranks and their oracle, phase 20's one processes and ranks), ZSIC's the
lifecycle's hptq and GPTQ and the WaterSIC layer of phase 14f), the last line
``{"ok": true, "device": {...}}``.  Per-case numbers also go to
``chiprun_out/chip_smoke_detail.json``.  Tolerances:

* dequant kernels (packed and int8) vs twin: |Δ| ≤ 1e-4 + 1e-4·|twin|
  (inputs scaled so outputs are O(1); f32 sums over k ≤ 27648 in another
  order differ by ≈ eps·√k);
* ZSIC kernel vs twin: equal bit for bit (the same divisions, roundings
  and unfused products and subtractions);
* flash kernel vs twin: |Δ| ≤ 2e-5 + 2e-5·|twin| (f32 sums of the same
  terms in another order: online against materialized softmax);
* ``model_ppl`` through the kernel vs through the twin: 1e-5 relative
  (and so the train oracle's loss);
* logits vs the float-weight model: max|Δ| ≤ 1e-3 · max|logits|
  (f32 sums in another order over up to 64 layers); the recurrent families
  also hold each layer's contribution so (layer by layer, above);
  rwkv6-7b only so, since its random 32 layers amplify f32 rounding: the
  float model fed its own embedding moved by 1e-7 of itself moves its
  logits by about 0.6 of max, as far as the kernel path is from it,
  while every layer agrees within 1e-5.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
#: the cuBLAS workspace that deterministic mode asks for (the lifecycle
#: phase trains under ``torch.use_deterministic_algorithms``); PyTorch
#: reads it once, when CUDA starts, so it is set before anything runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (CODE_RANGE, RansCodec, chol_lower,  # noqa: E402
                              empirical_entropy, gptq_via_zsic, layer_distortion,
                              quantize_at_rate, random_covariance)
from repro_torch.core.packing import pack_codes_torch  # noqa: E402
from repro_torch.kernels import _build, flash  # noqa: E402
from repro_torch.kernels.flash import (attention_ref,  # noqa: E402
                                       flash_attention_cuda)
from repro_torch.kernels.flash import \
    reset_launches as reset_flash_launches  # noqa: E402
from repro_torch.kernels.zsic import ops as zsic_ops  # noqa: E402
from repro_torch.kernels.zsic import (zsic_block_cuda,  # noqa: E402
                                      zsic_block_ref, zsic_quantize)
from repro_torch.kernels.zsic import \
    reset_launches as reset_zsic_launches  # noqa: E402
# the tensor-core names (TC_LAUNCHES, TC_MIN_M, uses_tensor_cores) are
# read from the package when used: kernel_bench.py imports this module
# beside an older tree's package to time it
from repro_torch.kernels import dequant as dq  # noqa: E402
from repro_torch.kernels.dequant import (LAUNCHES, PLANE_GROUPS,  # noqa: E402
                                         dequant_matmul,
                                         dequant_matmul_int8_cuda,
                                         dequant_matmul_packed_cuda,
                                         dequant_matmul_packed_ref,
                                         dequant_matmul_ref,
                                         dequantize_leaf_ref, dequantize_ref,
                                         payload_nbits, reset_launches,
                                         unpack_payload_ref)
from repro_torch.launch import plan as launch_plan  # noqa: E402
from repro_torch.launch.serve import (f32_tree_bytes,  # noqa: E402
                                     quantize_for_wbits, serving_tree)
from repro_torch.launch.train import device_batch  # noqa: E402
from repro_torch.models import (capture_cross_kv,  # noqa: E402
                                decode_chunk, decode_layers, decode_step,
                                encode, forward_train, loss_fn, prefill,
                                prefill_layers)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import (init_cache, init_params,  # noqa: E402
                                split_layers)
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models import rwkv6 as rk  # noqa: E402
from repro_torch.models.layers import moe, q8, unembed  # noqa: E402
from repro_torch.plan import (QuantPlan, build_plan, even_plan,  # noqa: E402
                              execute_plan, model_sensitivities,
                              plan_inputs_for_model)
from repro_torch.quant import (from_watersic, is_qweight,  # noqa: E402
                               leaf_format_histogram, leaf_inventory,
                               quantize_params_tree, qweight_bytes,
                               serving_formats_from_plan)
from repro_torch.quant.pipeline import (PTQConfig, model_ppl,  # noqa: E402
                                        quantize_model)
from repro_torch.serve import (ContinuousEngine, EngineConfig,  # noqa: E402
                               QualityConfig, QualityMonitor, Request,
                               RequantConfig, ResilienceConfig, ServeEngine,
                               engine_from_plan, replan_from_sigma,
                               sigma_threshold_detectors)
from repro_torch import chaos  # noqa: E402
from repro_torch.obs.drift import Threshold  # noqa: E402
from repro_torch.plan import collect_sigma_x  # noqa: E402
from repro_torch.quant.pipeline import matrix_tap_map  # noqa: E402
from repro_torch.quant.calibrate import forward_with_taps  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa: E402
                              tree_map, tree_map_with_path)
# the H100 SXM's published rates (HBM, f32 outside the tensor cores, bf16
# tensor cores dense): one source, the port's roofline
from repro_torch.launch.roofline import (BF16_FLOP_PER_S,  # noqa: E402
                                         F32_FLOP_PER_S, HBM_BYTES_PER_S)

F32_INSTR_PER_S = F32_FLOP_PER_S / 2  # f32 instructions/s (an FMA is 2 flops)
#: bf16 tensor-core products per f32 product done exactly (x·s in 3 terms)
BF16_TERMS = 3
PATH_SHAPES = [(2304, 2304), (2304, 5760), (5760, 2304)]
#: depth of the PTQ, serve-after-PTQ, gptq and flash-grad phases' model
PTQ_LAYERS = 1
#: depth of the resilience and int8-KV serve checks (minicpm-2b's width)
CHECK_LAYERS = 8
#: per decoder layer: wq wk wv wo at (2304, 2304), w_gate w_up at
#: (2304, 5760), w_out at (5760, 2304)
PER_LAYER = {(2304, 2304): 4, (2304, 5760): 2, (5760, 2304): 1}
KERNEL_TOL = 1e-4
LOGIT_TOL = 1e-3
#: flash kernel vs twin: f32 sums of the same terms in another order
#: (online softmax against the materialized one) on O(1) outputs
FLASH_TOL = 2e-5
#: model_ppl through the kernel vs through the twin, relative
PPL_TOL = 1e-5
#: loss_fn's weight grads with the kernel's forward vs the twin's, relative
#: to the largest grad: both backwards are the twin's, but the activations
#: they start from differ by FLASH_TOL-sized f32 reorderings, carried
#: through two layers and the 122880-way softmax
GRAD_TOL = 1e-4
#: rows of the ZSIC block launches on the PTQ path at minicpm-2b's widths:
#: the secant search's 10 % subsamples of 2304 and 5760 rows, and the
#: full matrices
ZSIC_ROWS = (230, 576, 2304, 5760)
_HI = {4: 8, 3: 4, 2: 2}
SOURCE = "src/repro_torch/kernels/dequant/csrc/dequant_packed.cu"
#: the tensor-core path's main loop, shared by B1 and B2 (m >= TC_MIN_M)
TC_SOURCE = "src/repro_torch/kernels/dequant/csrc/dequant_tc.cuh"
#: ragged (k, n) of the tensor-core path at m = TC_RAGGED_M
TC_RAGGED = ((2300, 5757), (301, 37))
TC_RAGGED_M = 130
REPLACES = "src/repro/kernels/dequant/dequant_matmul.py:179"
ZSIC_SOURCE = "src/repro_torch/kernels/zsic/csrc/zsic_block.cu"
ZSIC_REPLACES = "src/repro/kernels/zsic/zsic_block.py:111"
FLASH_SOURCE = "src/repro_torch/kernels/flash/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash/flash_attention.py:99"
INT8_SOURCE = "src/repro_torch/kernels/dequant/csrc/dequant_int8.cu"
INT8_REPLACES = "src/repro/kernels/dequant/dequant_matmul.py:79"
#: the int8 kernel's rows: decode at 1 and 8 slots, a 16-token prefill
#: chunk of 8 slots
INT8_M = (1, 8)
#: the ragged int8 case (k, n): neither a multiple of the kernel's tiles
INT8_RAGGED = (2300, 5757)
#: the plan phase's global budget, bits per parameter: between the grid's
#: int4 and int8 rungs, so the snapped plan must mix sub-byte and int8
PLAN_BITS = 5.0
#: rows of each of the plan phase's 2 calibration batches of 128 tokens:
#: 8192 tokens, so every Σ_X (up to 5760 wide) can have full rank.  With
#: fewer tokens than in-features the planner's curves promise near-zero
#: distortion in Σ_X's null space, which the damped quantizer does not
#: deliver (at 2 × 4 × 128 tokens the waterfilled allocation realized
#: 1.85× the even spread's weighted distortion on the card)
PLAN_CALIB_ROWS = 32
#: (k, n) of each matrix type of a minicpm-2b layer, by (block, name)
TYPE_SHAPES = {("attn", "wq"): (2304, 2304), ("attn", "wk"): (2304, 2304),
               ("attn", "wv"): (2304, 2304), ("attn", "wo"): (2304, 2304),
               ("mlp", "w_gate"): (2304, 5760), ("mlp", "w_up"): (2304, 5760),
               ("mlp", "w_out"): (5760, 2304)}


def device_ms(fn, dev, *, reps=25, flush=None):
    """Median device time of ``fn`` (CUDA events), launches queued behind
    a spin kernel so host overhead never shows; ``flush`` (a > 50 MB
    buffer) is read between launches so each finds L2 cold (read, not
    written: the evicted lines are clean, as they are between the weight
    reads of a decode step)."""
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(20_000_000)
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profile_kernels(fn, dev, calls=10):
    """Device kernels of ``calls`` warm calls of ``fn`` in a
    ``torch.profiler`` trace: name → {"per_call": launches per call,
    "us_per_call": device µs per call}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + (e.time_range.end
                                            - e.time_range.start))
    return {name[:60]: {"per_call": n / calls, "us_per_call": us / calls}
            for name, (n, us) in by_name.items()}


def operands(m, k, n, nbits, dev, gen, *, esc=False):
    """x (m, k), planar payload of codes (n, k), s, t and escapes."""
    x = torch.randn((m, k), generator=gen, device=dev)
    hi = _HI[nbits] + (5 if esc else 0)
    z = torch.randint(-hi, hi, (n, k), generator=gen, device=dev,
                      dtype=torch.int32)
    s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) / k ** 0.5
    t = torch.rand(n, generator=gen, device=dev) + 0.5
    payload, er, ec, ev = pack_codes_torch(z, nbits=nbits)
    return x, payload, s, t, (er, ec, ev)


def check(got, want, what, *, atol, rtol):
    """Raise unless got is finite and |got − want| ≤ atol + rtol·|want|;
    returns max |got − want|."""
    bad = (got - want).abs() > atol + rtol * want.abs()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what}: max |Δ| {err:.3e} beyond atol {atol}"
                             f" rtol {rtol} ({int(bad.sum())} entries)")
    return err


def tc_m() -> tuple:
    """Rows at which the kernel phases hold the tensor-core path: the
    switch, 8 × 16 and a prefill of 8 × 32 tokens."""
    return (dq.TC_MIN_M, 128, 256)


def tc_launches() -> dict:
    """Tensor-core dequant launches by nbits since ``reset_launches``."""
    return {nb: c for nb, c in dq.TC_LAUNCHES.items() if c}


def check_tc(dev, what, rows, launches) -> dict:
    """A counted run whose dequant products all had ``rows`` rows of x
    (``launches``: LAUNCHES of the run): on the card all of them went
    through the tensor-core kernel from TC_MIN_M rows on, none below.
    Returns the run's tensor-core launches."""
    got = tc_launches()
    want = {nb: c for nb, c in launches.items() if c} \
        if dq.uses_tensor_cores(rows) else {}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{what}: tensor-core launches {got} at "
                             f"m = {rows}, expected {want} (TC_MIN_M = "
                             f"{dq.TC_MIN_M})")
    return got


def _one_path_call(fn, key, m, what):
    """``fn()`` once, checking that it went through the kernel of its
    rows: the tensor-core one from TC_MIN_M on (TC_LAUNCHES[key] + 1),
    else the decode one."""
    before = dq.TC_LAUNCHES[key]
    out = fn()
    if dq.TC_LAUNCHES[key] - before != int(dq.uses_tensor_cores(m)):
        raise AssertionError(f"{what}: tensor-core launches "
                             f"{dq.TC_LAUNCHES[key] - before} at m = {m}")
    return out


def kernel_case(nbits, m, k, n, dev, gen, flush):
    """Kernel vs twin at one shape, with times and bound."""
    x, payload, s, t, _ = operands(m, k, n, nbits, dev, gen)
    g, kg = PLANE_GROUPS[nbits], payload.shape[-1]
    xp = F.pad(x, (0, g * kg - k)).contiguous()
    sp = F.pad(s, (0, g * kg - k)).contiguous()
    xg, sg = xp.view(m, g, kg), sp.view(g, kg)
    got = _one_path_call(lambda: dequant_matmul_packed_cuda(
        xg, payload, sg, t, nbits=nbits), nbits, m,
        f"int{nbits} m={m} k={k} n={n}")
    want = dequant_matmul_packed_ref(xp, payload, sp, t, nbits=nbits)
    torch.cuda.synchronize(dev)
    err = check(got, want, f"int{nbits} m={m} k={k} n={n}",
                atol=KERNEL_TOL, rtol=KERNEL_TOL)
    # split-K sums added across the cluster in rank order: equal bits
    if not torch.equal(got, dequant_matmul_packed_cuda(xg, payload, sg, t,
                                                       nbits=nbits)):
        raise AssertionError(f"int{nbits} m={m} k={k} n={n}: two runs differ")
    w_hat = (t[:, None] * unpack_payload_ref(payload, nbits)[:, :k]
             .to(torch.float32) * s[None, :])            # (n, k)
    lib = F.linear(x, w_hat)
    check(lib, want, f"library int{nbits} m={m} k={k} n={n}",
          atol=KERNEL_TOL, rtol=KERNEL_TOL)
    nbytes = (payload.numel() + 4 * (x.numel() + s.numel() + t.numel()
                                     + m * n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = BF16_TERMS * 2 * m * n * k / BF16_FLOP_PER_S * 1e3
    return {
        "nbits": nbits, "m": m, "k": k, "n": n, "max_abs_err": err,
        "path": "tc" if dq.uses_tensor_cores(m) else "decode",
        "ms": device_ms(lambda: dequant_matmul_packed_cuda(
            xg, payload, sg, t, nbits=nbits), dev, flush=flush),
        "plain_ms": device_ms(lambda: dequant_matmul_packed_ref(
            xp, payload, sp, t, nbits=nbits), dev, flush=flush, reps=10),
        "library_ms": device_ms(lambda: F.linear(x, w_hat), dev,
                                flush=flush),
        "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "f32_cuda_core_ms": 2 * m * n * k / F32_FLOP_PER_S * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "payload_bytes": int(payload.numel())}


def kernel_phase(dev, gen):
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    # the first timing of a process reads slow (seen at 37-90 us for a
    # 12 us kernel); take it on a throwaway
    device_ms(lambda: flush.max(), dev, flush=flush)
    cases = []
    for nbits in (4, 3, 2):
        shapes = [(m, k, n) for m in (1, 8) + tc_m() for k, n in PATH_SHAPES] \
            + [(TC_RAGGED_M, k, n) for k, n in TC_RAGGED]
        for m, k, n in shapes:
            c = kernel_case(nbits, m, k, n, dev, gen, flush)
            cases.append(c)
            print(f"kernel int{nbits} m={m} k={k} n={n} ({c['path']}): "
                  f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                  f"library_ms={c['library_ms']:.5f} "
                  f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) "
                  f"max_abs_err={c['max_abs_err']:.3e}", flush=True)
        # ragged in-features (unaligned rows) and escapes, through ops
        for m, k, n, esc in ((3, 301, 37, False), (8, 2304, 2304, True)):
            x, payload, s, t, escs = operands(m, k, n, nbits, dev, gen,
                                              esc=esc)
            got = dequant_matmul(x, payload, s, t, escapes=escs)
            # the escapes are summed in (row, col) order without atomics:
            # a rerun, and a permuted COO, give equal bits
            perm = torch.randperm(escs[0].numel(), generator=gen,
                                  device=dev)
            for again in (escs, tuple(e[perm] for e in escs)):
                if not torch.equal(got, dequant_matmul(x, payload, s, t,
                                                       escapes=again)):
                    raise AssertionError(f"ops int{nbits} m={m} k={k} n={n}"
                                         ": two runs differ")
            w_hat = dequantize_leaf_ref({"codes": payload, "s": s, "t": t,
                                         "esc_row": escs[0],
                                         "esc_col": escs[1],
                                         "esc_dval": escs[2]})
            err = check(got, x @ w_hat,
                        f"ops int{nbits} m={m} k={k} n={n} esc={esc}",
                        atol=KERNEL_TOL, rtol=KERNEL_TOL)
            cases.append({"nbits": nbits, "m": m, "k": k, "n": n,
                          "escapes": int(escs[0].numel()),
                          "max_abs_err": err})
            print(f"ops int{nbits} m={m} k={k} n={n} "
                  f"escapes={int(escs[0].numel())}: max_abs_err={err:.3e}",
                  flush=True)
    return cases


def int8_case(m, k, n, layout, dev, gen, flush, *, timed):
    """The int8 kernel against its twin at one shape: codes stored (k, n)
    as a serving leaf stores them and read in place through their (n, k)
    view ("kn", the serving path), or an (n, k)-contiguous matrix ("nk",
    which the wrapper copies into the leaf's layout first).  With
    ``timed``: the kernel, the twin, one library call (``F.linear``
    against the pre-dequantized f32 weight) and the plain product the
    serving path ran before the kernel existed, with the bound."""
    x = torch.randn((m, k), generator=gen, device=dev)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    s = (torch.rand(k, generator=gen, device=dev) * 0.2 + 0.01) / k ** 0.5 \
        / 30
    t = torch.rand(n, generator=gen, device=dev) + 0.5
    z = codes.T if layout == "kn" else codes.T.contiguous()
    what = f"int8 {layout} m={m} k={k} n={n}"
    got = _one_path_call(lambda: dequant_matmul_int8_cuda(x, z, s, t), 8, m,
                         what)
    want = dequant_matmul_ref(x, z, s, t)
    torch.cuda.synchronize(dev)
    err = check(got, want, what, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    if not torch.equal(got, dequant_matmul_int8_cuda(x, z, s, t)):
        raise AssertionError(f"{what}: two runs differ")
    rec = {"layout": layout, "m": m, "k": k, "n": n, "max_abs_err": err,
           "path": "tc" if dq.uses_tensor_cores(m) else "decode"}
    if not timed:
        return rec
    w_hat = dequantize_ref(z, s, t)                          # (n, k) f32
    check(F.linear(x, w_hat), want, f"library {what}", atol=KERNEL_TOL,
          rtol=KERNEL_TOL)

    def before():
        return ((x * s) @ codes.to(torch.float32)) * t
    check(before(), want, f"plain product {what}", atol=KERNEL_TOL,
          rtol=KERNEL_TOL)
    # bytes: the codes once, x, s, t in and out once; operations: the
    # 2·m·n·k multiply-adds done exactly on the bf16 tensor cores (3
    # products: codes exact in bf16, x·s in three terms), as kernel_case;
    # the f32 CUDA-core time of the same count is f32_cuda_core_ms
    t_bytes = (n * k + 4 * (m * k + k + n + m * n)) / HBM_BYTES_PER_S * 1e3
    t_ops = BF16_TERMS * 2 * m * n * k / BF16_FLOP_PER_S * 1e3
    rec.update({
        "ms": device_ms(lambda: dequant_matmul_int8_cuda(x, z, s, t), dev,
                        flush=flush),
        "plain_ms": device_ms(lambda: dequant_matmul_ref(x, z, s, t), dev,
                              flush=flush, reps=10),
        "library_ms": device_ms(lambda: F.linear(x, w_hat), dev,
                                flush=flush),
        "before_ms": device_ms(before, dev, flush=flush, reps=10),
        "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "f32_cuda_core_ms": 2 * m * n * k / F32_FLOP_PER_S * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return rec


def int8_phase(dev, gen, flush):
    """The int8 kernel at the serving path's shapes in both layouts (the
    serving layout timed) and the ragged case."""
    cases = []
    for m in INT8_M + tc_m():
        for k, n in PATH_SHAPES:
            for layout in ("kn", "nk"):
                c = int8_case(m, k, n, layout, dev, gen, flush,
                              timed=layout == "kn")
                cases.append(c)
                if "ms" in c:
                    print(f"kernel int8 kn m={m} k={k} n={n} ({c['path']}): "
                          f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                          f"library_ms={c['library_ms']:.5f} before_ms="
                          f"{c['before_ms']:.5f} bound_ms={c['bound_ms']:.5f}"
                          f" ({c['bound_by']}) max_abs_err="
                          f"{c['max_abs_err']:.3e}", flush=True)
    for m, (k, n) in [(8, INT8_RAGGED)] + [(TC_RAGGED_M, kn)
                                          for kn in TC_RAGGED]:
        for layout in ("kn", "nk"):
            c = int8_case(m, k, n, layout, dev, gen, flush,
                          timed=layout == "kn")
            cases.append(c)
            print(f"kernel int8 {layout} m={m} k={k} n={n} (ragged, "
                  f"{c['path']}): max_abs_err={c['max_abs_err']:.3e}"
                  + (f" ms={c['ms']:.5f}" if "ms" in c else ""), flush=True)
    print(f"int8 kernel vs twin: {len(cases)} cases in both layouts, max "
          f"|Δ| {max(c['max_abs_err'] for c in cases):.3e}", flush=True)
    return cases


def dequantized_model(params):
    """The same model with every quantized leaf replaced by its effective
    f32 weight (ref.dequantize_leaf_ref), served by plain matmuls."""
    if is_qweight(params) and params["s"].ndim == 1:
        return dequantize_leaf_ref(params)
    if is_qweight(params):
        stack = params["s"].shape[0]
        return torch.stack([dequantize_leaf_ref(params, index=i)
                            for i in range(stack)])
    if isinstance(params, dict):
        return {k: dequantized_model(v) for k, v in params.items()}
    if isinstance(params, list):                 # the hybrid's tail
        return [dequantized_model(v) for v in params]
    return params


class LayerByLayer(NamedTuple):
    """The float-weight model of a quantized dense ``tree``, never held
    whole: a step dequantizes layer l's leaves
    (``dequantize_leaf_ref(leaf, index=l)``) when it reaches the layer,
    runs the layer with plain matmuls and drops them (the f32 model of
    qwen2.5-32b is 128 GB).  ``oracle_step`` and ``oracle_layers`` take
    it where they take a dequantized tree."""
    tree: dict


def dequantized_layer(layers, index):
    """Layer ``index`` of a stacked layer tree with every quantized leaf
    replaced by its effective f32 weight."""
    if is_qweight(layers):
        return dequantize_leaf_ref(layers, index=index)
    if isinstance(layers, dict):
        return {k: dequantized_layer(v, index) for k, v in layers.items()}
    return layers[index]


def _oracle_tree(oracle):
    """The tree an oracle reads its embedding and ``ln_f`` from."""
    return oracle.tree if isinstance(oracle, LayerByLayer) else oracle


def oracle_layers(cfg, oracle, cache):
    """``models.decode_layers`` of the float-weight oracle at
    ``cache.pos``: a dequantized tree, or a ``LayerByLayer`` one whose
    layers dequantize their weights when called."""
    if not isinstance(oracle, LayerByLayer):
        return decode_layers(cfg, split_layers(oracle), cache)
    layers = oracle.tree["layers"]

    def run(index, kind, state, x):
        return tfm._decode_layer(cfg, kind, dequantized_layer(layers, index),
                                 state, cache.pos, x)
    return [functools.partial(run, i, kind, state) for i, (kind, _, state)
            in enumerate(tfm._layer_states(cfg, split_layers(oracle.tree),
                                           cache))]


def oracle_step(cfg, oracle, cache, tok):
    """The oracle's logits of one decode step (``decode_step`` of a
    dense tree; a ``LayerByLayer`` oracle one layer at a time)."""
    if not isinstance(oracle, LayerByLayer):
        return decode_step(cfg, oracle, cache, tok)[0]
    x = tfm._embed_tokens(cfg, oracle.tree, tok)
    for layer in oracle_layers(cfg, oracle, cache):
        x = layer(x)
    return tfm._logits(cfg, oracle.tree, x)[:, 0, :]


def serve_path(cfg, wbits, dev, **kw):
    """Tree-quantized random weights at ``wbits``, served by serve_tree
    against the dequantized-weight model; returns (record, params)."""
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), wbits)
    torch.cuda.synchronize(dev)
    return serve_tree(cfg, params, dequantized_model, f"int{wbits}", dev,
                      **kw), params


def _stacked(leaf) -> int:
    """Layers a quantized leaf holds: its scales ``s`` are (L, in) when it
    is layer-stacked, (in,) for one layer (the hybrid's tail)."""
    return leaf["s"].shape[0] if leaf["s"].ndim == 2 else 1


def decode_tree(params):
    """The leaves a decode step reads (stacked): all but the embedding;
    of an encoder–decoder, the decoder's leaves but its cross attention's
    wk and wv, whose K/V the cache holds."""
    if "dec_layers" in params:
        dec = params["dec_layers"]
        return {"dec_layers": {**dec, "cross_attn": {
            k: v for k, v in dec["cross_attn"].items()
            if k not in ("wk", "wv")}}}
    return {k: v for k, v in params.items() if k != "embed"}


def launches_per_step(params):
    """Dequant-kernel launches one decode step makes, by nbits (8: the int8
    kernel): one per layer of every quantized leaf it reads
    (``decode_tree``: the stacked ``layers`` or ``groups``, the hybrid's
    unstacked ``tail``, an encoder–decoder's decoder)."""
    want = {}

    def walk(node):
        if is_qweight(node):
            c = node["codes"]
            nb = 8 if c.dtype == torch.int8 else payload_nbits(c)
            want[nb] = want.get(nb, 0) + _stacked(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(decode_tree(params))
    return want


def _rel_check(got, ref, what):
    """``check`` at LOGIT_TOL of ``ref``'s largest value; the relative
    error."""
    scale = max(float(ref.abs().max()), 1e-30)
    return check(got, ref, what, atol=LOGIT_TOL * scale, rtol=0.0) / scale


def layerwise_decode_check(cfg, tree, oracle, tok, dev, max_len, what):
    """One decode step of ``tree`` held against ``oracle`` layer by layer
    (``models.decode_layers``): both trees' layer l get the oracle's input
    x to it, and its contribution y − x (the residual taken out, so a
    large residual cannot hide a wrong block), the state it writes and
    the logits of the last layer's outputs are held within LOGIT_TOL of
    the oracle's largest value.  Errors then do not compound over the
    depth, which at full width amplifies f32 rounding on rwkv6-7b's
    random weights (``rounding_amplification``).  Returns the largest
    relative error."""
    b = tok.shape[0]
    caches = [init_cache(cfg, b, max_len, torch.float32, device=dev)
              for _ in range(2)]
    layers = [decode_layers(cfg, split_layers(tree), caches[0]),
              oracle_layers(cfg, oracle, caches[1])]
    x = tfm._embed_tokens(cfg, _oracle_tree(oracle), tok)
    errs = []
    for i, (fa, fb) in enumerate(zip(*layers)):
        ya, yb = fa(x), fb(x)
        errs.append(_rel_check(ya - x, yb - x, f"{what} layer {i} block"))
        x = yb
    errs.append(_rel_check(tfm._logits(cfg, tree, ya),
                           tfm._logits(cfg, _oracle_tree(oracle), yb),
                           f"{what} logits"))
    for i, (sa, sb) in enumerate(zip(*(tree_leaves(c.kv)
                                       for c in caches))):
        errs.append(_rel_check(sa, sb, f"{what} state leaf {i}"))
    return max(errs)


def rounding_amplification(cfg, oracle, tok, dev, max_len, rel=1e-7):
    """The float-weight model against itself: one decode step of
    ``oracle`` from the tokens' embedding and from that embedding with
    each entry moved by ``rel`` of itself (f32 rounding's size, Gaussian
    from a fixed seed); the logits' largest difference over their largest
    value.  Above LOGIT_TOL the depth amplifies rounding past the
    tolerance, and no other f32 implementation of the same model (a
    kernel summing in another order) can be held to it end to end."""
    base = _oracle_tree(oracle)
    x = tfm._embed_tokens(cfg, base, tok)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
    out = []
    for xi in (x, x + rel * x.abs() * noise):
        cache = init_cache(cfg, tok.shape[0], max_len, torch.float32,
                           device=dev)
        for layer in oracle_layers(cfg, oracle, cache):
            xi = layer(xi)
        out.append(tfm._logits(cfg, base, xi))
    return float((out[1] - out[0]).abs().max()) / float(out[0].abs().max())


def layerwise_prefill_check(cfg, tree, toks, dev, max_len, what):
    """The parallel prefill held against the stepped one layer by layer:
    each layer's full-sequence form (``models.prefill_layers``) and its
    decode steps over the same input (``models.decode_layers`` at each
    position) get the parallel pass's input x to the layer; the
    contributions y − x at every position and the state each form leaves
    are held within LOGIT_TOL of the stepped form's largest value.
    Returns the largest relative error."""
    b, s = toks.shape
    split = split_layers(tree)
    c_par = init_cache(cfg, b, max_len, torch.float32, device=dev)
    c_step = init_cache(cfg, b, max_len, torch.float32, device=dev)
    par = prefill_layers(cfg, split, c_par, torch.float32)
    steps = [decode_layers(cfg, split, c_step._replace(
        pos=torch.tensor(t, dtype=torch.int32, device=dev)))
        for t in range(s)]
    x = tfm._embed_tokens(cfg, split, toks)
    errs = []
    for i, layer in enumerate(par):
        y_step = torch.cat([steps[t][i](x[:, t:t + 1]) for t in range(s)],
                           dim=1)
        y = layer(x)
        errs.append(_rel_check(y - x, y_step - x, f"{what} layer {i} block"))
        x = y
    for i, (sa, sb) in enumerate(zip(tree_leaves(c_par.kv),
                                     tree_leaves(c_step.kv))):
        errs.append(_rel_check(sa, sb, f"{what} state leaf {i}"))
    return max(errs)


def serve_prompts(cfg, n_req, prompt_len):
    """The serve cells' prompts: ``n_req`` of ``prompt_len`` tokens from
    numpy seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
            for _ in range(n_req)]


def serve_tree(cfg, params, oracle_of, label, dev, *, n_req, prompt_len,
               new_tokens, max_len, slots, chunk, per_layer=7,
               layerwise=False, end_to_end=True):
    """First-step logits of the quantized tree against
    ``oracle_of(params)`` (the same model with float weights: a
    dequantized tree, or a ``LayerByLayer`` one), then
    ``ContinuousEngine`` serves ``n_req`` requests; each dequant kernel
    must run once per layer of each of its leaves per decode step
    (``per_layer`` × n_layers in all: 7 for a dense tree of one format, 4
    for a MoE tree, whose stacked experts stay f32).  With ``layerwise``
    the first step is also held layer by layer
    (``layerwise_decode_check``).  Without ``end_to_end`` the end-to-end
    logits are only reported, and only where the float model itself
    moves past LOGIT_TOL under a perturbation of f32 rounding's size
    (``rounding_amplification``, held above LOGIT_TOL): a depth that
    amplifies rounding so far cannot be held end to end.  Returns a
    record."""
    prompts = serve_prompts(cfg, n_req, prompt_len)
    # first-step logits: kernel-served model vs the float-weight model
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    got, _ = decode_step(cfg, params, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    oracle = oracle_of(params)
    want = oracle_step(cfg, oracle, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    if got.shape != (n_req, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(got.shape)}")
    scale = float(want.abs().max())
    first = {"held": end_to_end,
             "greedy_equal": float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean())}
    if end_to_end:
        first["rel_err"] = check(got, want, f"{cfg.name} {label} first-step "
                                 "logits", atol=LOGIT_TOL * scale,
                                 rtol=0.0) / scale
    else:
        first["rel_err"] = float((got - want).abs().max()) / scale
        first["oracle_amplification"] = rounding_amplification(
            cfg, oracle, tok, dev, max_len)
        if first["oracle_amplification"] <= LOGIT_TOL:
            raise AssertionError(
                f"{cfg.name} {label}: the float model moves its logits by "
                f"{first['oracle_amplification']:.3e} under a 1e-7 "
                "perturbation, within LOGIT_TOL: hold it end to end")
    logit_err = first["rel_err"]
    if layerwise:
        logit_err = layerwise_decode_check(
            cfg, params, oracle, tok, dev, max_len,
            f"{cfg.name} {label} first step")
    del oracle
    torch.cuda.empty_cache()

    steps = {"n": 0}

    def step_fn(p, c, t):
        steps["n"] += 1
        return decode_step(cfg, p, c, t)

    def chunk_fn(p, c, t):
        steps["n"] += t.shape[1]        # decode_chunk = C decode steps
        return decode_chunk(cfg, p, c, t)

    eng = ContinuousEngine(cfg, params, config=EngineConfig(
        n_slots=slots, max_len=max_len, cache_dtype=torch.float32,
        prefill_chunk=chunk, decode_fn=step_fn, decode_chunk_fn=chunk_fn))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=new_tokens))
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {nb: c for nb, c in LAUNCHES.items() if c}
    per_step = launches_per_step(params)
    want_launches = {nb: c * steps["n"] for nb, c in per_step.items()}
    if launches != want_launches or sum(per_step.values()) != \
            per_layer * cfg.n_layers:
        raise AssertionError(f"dequant launches by nbits {launches}, "
                             f"expected {want_launches} = {per_step} per "
                             f"step x {steps['n']} decode steps")
    # every product of the run is a decode step's, at most `slots` rows
    tc = check_tc(dev, f"serve {cfg.name} {label}", slots, launches)
    streams = {r.rid: list(r.out_tokens) for r in done}
    if sorted(streams) != list(range(n_req)) or any(
            len(r.out_tokens) != new_tokens
            or not all(0 <= x < cfg.vocab for x in r.out_tokens)
            for r in done):
        raise AssertionError("served streams have the wrong shape")
    tokens = sum(len(r.out_tokens) for r in done)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "format": label,
           "requests": n_req, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "decode_steps": steps["n"],
           "engine_decode_calls": eng.decode_calls,
           "decode_step_ms": 1e3 * eng.decode_s / max(eng.decode_calls, 1),
           "prefill_s": eng.prefill_s, "launches": launches,
           "tc_launches": tc, "launches_per_step": per_step,
           "weight_bytes": eng.weight_bytes,
           "weight_bytes_bf16": eng.weight_bytes_bf16,
           "first_step_logit_rel_err": logit_err, "streams": streams}
    if layerwise:
        rec["first_step_end_to_end"] = first
    print(f"serve {cfg.name} L={cfg.n_layers} {label}: {tokens} tokens in "
          f"{wall:.3f}s = {rec['tokens_per_s']:.2f} tok/s, decode step "
          f"{rec['decode_step_ms']:.3f} ms (wall), {steps['n']} decode steps,"
          f" kernel launches by nbits {launches}, weight bytes "
          f"{eng.weight_bytes} (bf16 {eng.weight_bytes_bf16}), first-step "
          f"logits rel err {logit_err:.3e}", flush=True)
    return rec


def graph_kernel_names(fn):
    """Function names of the kernel nodes of a CUDA graph that captures one
    call of ``fn``: the device kernels the call launches, read through
    libcuda (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName``) rather than from a profiler's trace."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # first-use work off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 256)()       # CUDA_KERNEL_NODE_PARAMS_v2
        name = ctypes.c_char_p()
        if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                              params) != 0 \
                or cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(
                    ctypes.c_void_p.from_buffer(params, 0).value)) != 0:
            raise RuntimeError("cannot read a kernel node's function name")
        names.append(name.value.decode())
    del graph
    return names


def _device_busy_ms(prof):
    """Union of the traced device activities' intervals (ms) and their
    time by kind: packed kernel, int8 kernel, matrix products, everything
    else; and the count of each dequant kernel."""
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    kinds = {"packed_ms": 0.0, "int8_ms": 0.0, "gemm_ms": 0.0,
             "other_ms": 0.0}
    packed = int8 = 0
    for a, b, name in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        low = name.lower()
        kind = ("packed_ms" if "dequant_packed" in low
                else "int8_ms" if "dequant_int8" in low
                else "gemm_ms" if "gemm" in low or "gemv" in low
                else "other_ms")
        packed += kind == "packed_ms"
        int8 += kind == "int8_ms"
        kinds[kind] += (b - a) / 1e3
    return {"busy_ms": busy / 1e3, "activities": len(spans),
            "packed_kernels": packed, "int8_kernels": int8, **kinds}


def step_breakdown(cfg, params, dev, slots, max_len, cases):
    """Decode steps at batch ``slots``: their wall time (host clock around
    a synchronize, median of 5) with the engines' pre-split layer views
    and with the stacked tree (split on every step); a ``torch.profiler``
    trace of 3 steps for the device's busy time and idle share; the
    unembed's device time; the packed kernels' device time per step from
    the kernel phase (m = 8, × n_layers).  The trace must hold one device
    kernel per quantized dense: one packed kernel per packed leaf and
    layer, one int8 kernel per int8 leaf and layer."""
    from torch.profiler import ProfilerActivity, profile

    cache = init_cache(cfg, slots, max_len, torch.float32, per_slot=True,
                       device=dev)
    tok = torch.zeros((slots, 1), dtype=torch.long, device=dev)
    split = split_layers(params)

    def wall_ms(p, n):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            decode_step(cfg, p, cache, tok)
            torch.cuda.synchronize(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
        return walls

    wall_ms(split, 1)
    rec = {"decode_step_wall_ms": statistics.median(wall_ms(split, 5)),
           "decode_step_wall_ms_stacked": statistics.median(
               wall_ms(params, 5))}
    # one device kernel per quantized dense and layer, counted exactly in
    # a CUDA graph of one step (the profiler now and then drops the record
    # of a kernel launched as a thread-block cluster, as both dequant
    # kernels are)
    per_step = launches_per_step(params)
    want = {"packed_kernels": sum(c for nb, c in per_step.items() if nb != 8),
            "int8_kernels": per_step.get(8, 0)}
    names = graph_kernel_names(lambda: decode_step(cfg, split, cache, tok))
    got = {"packed_kernels": sum("dequant_packed" in n for n in names),
           "int8_kernels": sum("dequant_int8" in n for n in names)}
    rec["graph_kernels_per_step"] = len(names)
    for key, n in want.items():
        rec[f"graph_{key}_per_step"] = got[key]
    if got != want:
        raise AssertionError(f"device kernels in a CUDA graph of one decode "
                             f"step {got}, expected {want}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = wall_ms(split, 3)
    busy = _device_busy_ms(prof)
    rec["traced_step_wall_ms"] = sum(traced) / 3
    if busy is None:
        rec["device_busy_ms_per_step"] = None      # no device activity seen
    else:
        rec["device_busy_ms_per_step"] = busy["busy_ms"] / 3
        rec["device_idle_share"] = 1 - busy["busy_ms"] / sum(traced)
        rec["device_activities_per_step"] = busy["activities"] / 3
        for k in ("packed_ms", "int8_ms", "gemm_ms", "other_ms",
                  "packed_kernels", "int8_kernels"):
            rec[f"traced_{k}_per_step"] = busy[k] / 3
    x = torch.randn((slots, 1, cfg.d_model), device=dev)
    rec["unembed_ms"] = device_ms(
        lambda: unembed(params["embed"], x, cfg.vocab), dev,
        flush=torch.ones(16 << 20, dtype=torch.float32, device=dev))
    if cases:
        rec["packed_kernels_ms_per_step"] = cfg.n_layers * sum(
            PER_LAYER[(c["k"], c["n"])] * c["ms"] for c in cases
            if c["nbits"] == 4 and c["m"] == slots and "ms" in c)
    return rec



# ---------------------------------------------------------------------------
# the quantizer's kernels: ZSIC block recursion and flash attention
# ---------------------------------------------------------------------------


def zsic_operands(a, bn, dev, seed):
    """(y (a, bn), lower-triangular L (bn, bn), WaterSIC spacings) f32 on
    the card, from a numpy seed; also the float64 numpy originals."""
    rng = np.random.default_rng(seed)
    sigma, _ = random_covariance(bn, condition=20.0, seed=seed + 1)
    l = chol_lower(sigma)
    y = rng.standard_normal((a, bn)) @ l
    ldiag = np.abs(np.diag(l))
    alphas = 0.05 * np.exp(np.mean(np.log(ldiag))) / ldiag
    f32 = [torch.as_tensor(v.astype(np.float32), device=dev)
           for v in (y, l, alphas)]
    return f32, (y, l, alphas)


def twin_block(y, l_block, alphas, *, out):
    """``kernels/zsic/ops.zsic_block`` with the twin in place of the
    kernel: the block's codes and residual copied into ``out``."""
    for dst, src in zip(out, zsic_block_ref(y, l_block, alphas)):
        dst.copy_(src)
    return out


def zsic_case(a, bn, dev, flush):
    """Kernel vs twin on one block, bit for bit, with times and bound."""
    (y, l, alphas), _ = zsic_operands(a, bn, dev, seed=a + bn)
    z, r = zsic_block_cuda(y, l, alphas)
    zt, rt = zsic_block_ref(y, l, alphas)
    torch.cuda.synchronize(dev)
    mismatches = int((z != zt).sum())
    err = float((r - rt).abs().max())
    if mismatches or not torch.equal(r, rt):
        raise AssertionError(f"zsic_block a={a} bn={bn}: {mismatches} code "
                             f"mismatches, max |Δ resid| {err:.3e}")
    # bytes: y in, codes and residual out, the L block and α once;
    # operations: a·bn·(bn+1)/2 multiply-subtracts, each an unfused f32
    # multiply and subtract (2 instructions), plus a·bn divisions and a·bn
    # roundings, on the CUDA cores (the recursion is exact f32: no tensor
    # cores)
    nbytes = 4 * (3 * a * bn + bn * bn + bn)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (a * bn * (bn + 1) + 2 * a * bn) / F32_INSTR_PER_S * 1e3
    kernels = profile_kernels(lambda: zsic_block_cuda(y, l, alphas), dev)
    return {"a": a, "bn": bn, "code_mismatches": mismatches,
            "max_abs_err": err,
            "ms": device_ms(lambda: zsic_block_cuda(y, l, alphas), dev,
                            flush=flush),
            "device_ms": sum(v["us_per_call"] for v in kernels.values())
            / 1e3,
            "device_kernels_per_call": sum(v["per_call"]
                                           for v in kernels.values()),
            "plain_ms": device_ms(lambda: zsic_block_ref(y, l, alphas), dev,
                                  flush=flush, reps=5),
            "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zsic_phase(dev, flush):
    """The block kernel at the PTQ path's row counts (full rows of the
    (2304, ·) and (5760, ·) matrices, and the secant search's 10 % row
    subsamples), then one full zsic_quantize against float64 numpy."""
    cases = {}
    for a in ZSIC_ROWS:
        c = cases[a] = zsic_case(a, 128, dev, flush)
        print(f"zsic_block a={a} bn=128: ms={c['ms']:.5f} (L2 cold; "
              f"device {c['device_ms']:.5f} warm in "
              f"{c['device_kernels_per_call']:g} kernel per call) plain_ms="
              f"{c['plain_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
              f"({c['bound_by']}) code_mismatches={c['code_mismatches']} "
              f"max_abs_err={c['max_abs_err']:.3e}", flush=True)
    (y, l, alphas), (y64, l64, a64) = zsic_operands(2304, 2304, dev, seed=7)
    z, r = zsic_quantize(y, l, alphas)
    # the same blocked run with the twin in place of the kernel: the PTQ
    # path's strided column slices of y and L, held bit for bit
    kernel_fn = zsic_ops.zsic_block
    zsic_ops.zsic_block = twin_block
    try:
        zt, rt = zsic_quantize(y, l, alphas)
    finally:
        zsic_ops.zsic_block = kernel_fn
    torch.cuda.synchronize(dev)
    strided_mismatches = int((z != zt).sum())
    if strided_mismatches or not torch.equal(r, rt):
        raise AssertionError(
            f"zsic_quantize (2304, 2304): {strided_mismatches} code "
            f"mismatches against the twin, max |Δ resid| "
            f"{float((r - rt).abs().max()):.3e}")
    print("zsic_quantize (2304, 2304) through the kernel equals the same run "
          "through the twin bit for bit", flush=True)
    bound = 0.5 * a64 * np.abs(np.diag(l64))
    lemma = bool(np.all(np.abs(r.cpu().numpy())
                        <= bound[None, :] * (1 + 1e-4) + 1e-6))
    print(f"zsic_quantize (2304, 2304): Lemma 3.2 "
          f"{'holds' if lemma else 'FAILS'}", flush=True)
    if not lemma:
        raise AssertionError("full ZSIC breaks Lemma 3.2's residual bound")
    return {"cases": cases, "full_lemma": lemma,
            "full_twin_code_mismatches": strided_mismatches,
            "full_codes": z.cpu().numpy(),
            "full_job": start_host_job("repro_torch.core:zsic_numpy", y64,
                                       l64, a64)}


def finish_zsic_oracle(rec) -> dict:
    """The zsic phase's float64 ``zsic_numpy`` oracle, read: the full
    (2304, 2304) run through the kernel must agree with it on at least
    0.999 of the codes."""
    codes = rec.pop("full_codes")
    (z_ref, _), oracle_s = finish_host_job(rec.pop("full_job"))
    agree = float((codes == z_ref).mean())
    rec.update(full_agreement=agree, full_oracle_s=oracle_s)
    print(f"zsic_quantize (2304, 2304) vs zsic_numpy float64: code agreement "
          f"{agree:.6f} (oracle {oracle_s:.1f}s on the host, beside the "
          f"later phases)", flush=True)
    if agree < 0.999:
        raise AssertionError("full ZSIC disagrees with the float64 oracle")
    return rec


def flash_twin(q, k, v, *, causal=True, window=0):
    """The flash kernel's plain twin on (B, S, H, d) CUDA tensors."""
    b, s, h, d = q.shape
    fold = [x.transpose(1, 2).reshape(b * h, s, d) for x in (q, k, v)]
    out = attention_ref(*fold, causal=causal, window=window)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _kept_pairs(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= i - j < window
    return int(keep.sum())


def flash_check(b, s, h, d, causal, window, dev, gen):
    """Kernel vs twin on one (B, S, H, d) case; returns (q, k, v, twin,
    max |Δ|)."""
    q, k, v = [torch.randn((b, s, h, d), generator=gen, device=dev)
               for _ in range(3)]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_twin(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(dev)
    err = check(got, want, f"flash B*H={b * h} S={s} d={d} causal={causal} "
                f"window={window}", atol=FLASH_TOL, rtol=FLASH_TOL)
    return q, k, v, want, err


def flash_case(s, window, dev, gen, flush, *, b=4, h=36, d=64,
               causal=True):
    """Kernel vs twin at minicpm-2b's heads (B·H = 4·36, d = 64), causal,
    or at the heads and mask given, with times and bound."""
    q, k, v, want, err = flash_check(b, s, h, d, causal, window, dev, gen)
    mask = None
    if window:
        i = torch.arange(s, device=dev)[:, None]
        j = torch.arange(s, device=dev)[None, :]
        mask = (j <= i) & (i - j < window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = float((library().transpose(1, 2) - want).abs().max())
    # bytes: q, k, v read and o written once; operations: 2·d for q·k and
    # 2·d for p·v per kept (query, key) pair, on the bf16 tensor cores with
    # an f32-accurate 3-term split (the f32 CUDA-core time is printed too)
    flops = 4 * d * _kept_pairs(s, causal, window) * b * h
    t_bytes = 4 * 4 * b * s * h * d / HBM_BYTES_PER_S * 1e3
    t_ops = BF16_TERMS * flops / BF16_FLOP_PER_S * 1e3
    return {"bh": b * h, "s": s, "d": d, "window": window, "causal": causal,
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": device_ms(lambda: flash_attention_cuda(
                q, k, v, causal=causal, window=window), dev, flush=flush),
            "plain_ms": device_ms(lambda: flash_twin(
                q, k, v, causal=causal, window=window), dev, flush=flush),
            "library_ms": device_ms(library, dev, flush=flush),
            "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "f32_cuda_core_ms": flops / F32_FLOP_PER_S * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


#: untimed flash cases beside the path's heads: (B, S, H, d, causal,
#: window) for the other head dims, S = 1, an S below one query tile (of
#: 64 rows), and a ragged S without the causal mask
FLASH_EDGE_CASES = [(1, 256, 4, 128, True, 0), (1, 200, 4, 256, False, 64),
                    (4, 1, 36, 64, True, 0), (4, 40, 36, 64, True, 0),
                    (4, 200, 36, 64, False, 0)]


def flash_phase(dev, gen, flush):
    cases = []
    for b, s, h, d, causal, window in FLASH_EDGE_CASES:
        err = flash_check(b, s, h, d, causal, window, dev, gen)[-1]
        cases.append({"bh": b * h, "s": s, "d": d, "causal": causal,
                      "window": window, "max_abs_err": err})
        print(f"flash B*H={b * h} S={s} d={d} causal={causal} window="
              f"{window}: max_abs_err={err:.3e}", flush=True)
    for s in (128, 256, 200):
        for window in (0, 64):
            c = flash_case(s, window, dev, gen, flush)
            cases.append(c)
            print(f"flash B*H=144 S={s} d=64 window={window}: ms="
                  f"{c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms="
                  f"{c['library_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
                  f"({c['bound_by']}; f32 CUDA cores "
                  f"{c['f32_cuda_core_ms']:.5f}) max_abs_err="
                  f"{c['max_abs_err']:.3e}", flush=True)
    return cases


# ---------------------------------------------------------------------------
# post-training quantization of minicpm-2b, then serving its codes
# ---------------------------------------------------------------------------


def ppl_pair(cfg, params, evalb, what):
    """model_ppl through the flash kernel (its launches counted) and
    through the plain twin; they must agree within PPL_TOL relative."""
    reset_flash_launches()
    ppl = model_ppl(cfg, params, evalb)
    launches = flash_attention_cuda.launches
    if launches != cfg.n_layers * len(evalb):
        raise AssertionError(f"{what}: {launches} flash launches, expected "
                             f"{cfg.n_layers} layers x {len(evalb)} batches")
    kernel_fn = flash.flash_attention
    flash.flash_attention = flash_twin
    try:
        ppl_twin = model_ppl(cfg, params, evalb)
    finally:
        flash.flash_attention = kernel_fn
    rel = abs(ppl - ppl_twin) / ppl_twin
    if not math.isfinite(ppl) or rel > PPL_TOL:
        raise AssertionError(f"{what}: model_ppl {ppl} (kernel) vs "
                             f"{ppl_twin} (twin)")
    print(f"model_ppl {what}: {ppl:.4f} through the flash kernel "
          f"({launches} launches), {ppl_twin:.4f} through the twin "
          f"(rel diff {rel:.2e})", flush=True)
    return {"ppl": ppl, "ppl_twin": ppl_twin, "rel_diff": rel,
            "flash_launches": launches}


#: (module, function) pairs whose host-clock time (synchronized on both
#: sides) the PTQ phase adds up, for where its time goes
PTQ_SPANS = (("repro_torch.quant.pipeline", "forward_with_taps"),
             ("repro_torch.quant.pipeline", "accumulate_stats"),
             ("repro_torch.core.watersic", "zsic_lmmse"),
             ("repro_torch.core.watersic", "zsic_quantize"),
             ("repro_torch.core.watersic", "find_optimal_rescalers"),
             ("repro_torch.core.entropy", "empirical_entropy"))


def timed_spans(dev, spans):
    """Wrap each (module, function) so its calls add their synchronized
    host-clock seconds to the returned dict, and count the calls and the
    columns of their first argument (``<name>_calls``, ``<name>_cols``)
    into a second; returns (seconds, counts, restore)."""
    import importlib
    took, counts, saved = {}, {}, []
    for modname, name in spans:
        mod = importlib.import_module(modname)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, _fn=fn, _name=name, **kw):
            counts[f"{_name}_calls"] = counts.get(f"{_name}_calls", 0) + 1
            if isinstance(a[0], torch.Tensor) and a[0].ndim == 2:
                counts[f"{_name}_cols"] = counts.get(f"{_name}_cols", 0) \
                    + a[0].shape[1]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize(dev)
                took[_name] = took.get(_name, 0.0) + time.perf_counter() - t0
        setattr(mod, name, wrapper)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return took, counts, restore


def ptq_phase(cfg, dev):
    """quantize_model (watersic: the LMMSE column loop; hptq: the ZSIC
    kernel) at 3 bits, and model_ppl of the float and quantized models.
    One run per method gives its wall time, its ZSIC launches and, with
    the spans of PTQ_SPANS timed, where the time goes."""
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
             for _ in range(2)]
    evalb = [rng.integers(0, cfg.vocab, (4, 257)).astype(np.int32)]
    rec = {"calib": "2 x (4, 128)", "eval": "1 x (4, 257)",
           "ppl": {"float": ppl_pair(cfg, params, evalb, "float")}}
    results = {}
    for method in ("watersic", "hptq"):
        shapes = []
        record = zsic_ops.zsic_block_cuda

        def recorder(y, *a, **kw):
            shapes.append(int(y.shape[0]))
            return record(y, *a, **kw)
        zsic_ops.zsic_block_cuda = recorder
        took, counts, restore = timed_spans(dev, PTQ_SPANS)
        reset_zsic_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            qp, qlin, budget, rows = quantize_model(
                cfg, params, calib, PTQConfig(target_bits=3.0, method=method))
            torch.cuda.synchronize(dev)
        finally:
            restore()
            zsic_ops.zsic_block_cuda = record
        wall = time.perf_counter() - t0
        launches = zsic_block_cuda.launches
        rate = budget.realized_rate
        if abs(rate - 3.0) > 0.05:
            raise AssertionError(f"{method}: realized rate {rate}")
        if method == "hptq" and launches == 0:
            raise AssertionError("hptq ran no ZSIC kernel launch")
        mix = {a: shapes.count(a) for a in sorted(set(shapes))}
        took["rest"] = wall - sum(took.values())
        print(f"ptq {method} where the time goes (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in took.items())
              + "; " + ", ".join(f"{k} {v}" for k, v in counts.items()),
              flush=True)
        rec[method] = {"realized_rate": rate, "wall_s": wall,
                       "breakdown_s": took, "span_counts": counts,
                       "s_per_matrix": wall / len(qlin),
                       "matrices": len(qlin), "zsic_launches": launches,
                       "zsic_launch_rows": mix,
                       "rate_eff_mean": float(np.mean([r["rate"]
                                                       for r in rows]))}
        print(f"ptq {cfg.name} L={cfg.n_layers} {method}: realized rate "
              f"{rate:.4f} bits, {wall:.2f}s for {len(qlin)} matrices = "
              f"{wall / len(qlin):.3f} s/matrix, {launches} ZSIC kernel "
              f"launches (rows per launch: {mix})", flush=True)
        rec["ppl"][method] = ppl_pair(cfg, qp, evalb, method)
        results[method] = (qp, qlin)
    return rec, results


def install_codes(qparams, qlinears, n_layers, nbits=4):
    """Swap the dequantized float weights for stacked packed leaves
    (``from_watersic``); a path's escape capacity is its largest escape
    count over the layers.  Returns (tree, escapes installed)."""
    lo, hi = CODE_RANGE[nbits]
    groups = {}
    for name, q in qlinears.items():
        groups.setdefault(tuple(name.split("/")[1:]), {})[
            int(name.split("/")[0][1:])] = q
    p = {**qparams, "layers": {k: dict(v) for k, v in
                               qparams["layers"].items()}}
    escapes = 0
    for path, per_layer in groups.items():
        counts = [int(((q.codes < lo) | (q.codes > hi)).sum())
                  for q in per_layer.values()]
        escapes += sum(counts)
        leaves = [from_watersic(per_layer[l], nbits=nbits,
                                escape_capacity=max(counts))
                  for l in range(n_layers)]
        p["layers"][path[0]][path[1]] = {
            **qparams["layers"][path[0]][path[1]],       # a bias stays
            "w": {k: torch.stack([lf[k] for lf in leaves])
                  for k in leaves[0]}}
    return p, escapes


def serve_after_ptq(cfg, qp, qlin, dev):
    """The watersic codes served as packed int4 with their escapes, twice:
    equal streams; and each escaped leaf's product (kernel + escape sum)
    at the decode batch gives equal bits on a rerun and for a permuted
    COO."""
    tree, escapes = install_codes(qp, qlin, cfg.n_layers)
    if escapes == 0:
        raise AssertionError("the installed WaterSIC codes carry no escapes")
    print(f"serve-after-ptq: watersic codes installed as packed int4 with "
          f"{escapes} escapes", flush=True)
    runs = [serve_tree(cfg, tree, lambda _: qp, "int4", dev, n_req=4,
                       prompt_len=16, new_tokens=8, max_len=32, slots=4,
                       chunk=16) for _ in range(2)]
    if runs[0]["streams"] != runs[1]["streams"]:
        raise AssertionError(f"serve-after-ptq streams differ on a rerun: "
                             f"{runs[0]['streams']} vs {runs[1]['streams']}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    leaves = 0
    for block in tree["layers"].values():
        for leaf in block.values():
            w = leaf.get("w") if isinstance(leaf, dict) else None
            if not is_qweight(w):
                continue
            for i in range(cfg.n_layers):
                esc = (w["esc_row"][i], w["esc_col"][i], w["esc_dval"][i])
                x = torch.randn((4, w["s"].shape[-1]), generator=gen,
                                device=dev)
                args = (x, w["codes"][i], w["s"][i], w["t"][i])
                first = dequant_matmul(*args, escapes=esc)
                perm = torch.randperm(esc[0].numel(), generator=gen,
                                      device=dev)
                for again in (esc, tuple(e[perm] for e in esc)):
                    if not torch.equal(first, dequant_matmul(
                            *args, escapes=again)):
                        raise AssertionError("an escaped product differs on "
                                             "a rerun")
                leaves += 1
    print(f"serve-after-ptq rerun: equal streams, and {leaves} escaped "
          f"products equal bit for bit on a rerun and a permuted COO",
          flush=True)
    rec = runs[0]
    rec.update({"escapes": escapes, "rerun_streams_equal": True,
                "rerun_equal_products": leaves})
    return rec


# ---------------------------------------------------------------------------
# the global planner: build → inspect → execute, then the mixed-rate serve
# ---------------------------------------------------------------------------


def weighted_distortion(plan):
    """Σ w_l·N_l·D_l over the realized distortions (the planner's
    objective, as ``launch/plan.py`` reports it)."""
    return sum(e.weight * e.n_params * e.realized_distortion for e in plan)


def execute(plan, weights, stats, dev, workers):
    """One execution of ``plan`` through the ZSIC kernel (WaterSIC spacing
    without LMMSE), with its wall time and kernel launches."""
    reset_zsic_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    q, report = execute_plan(plan, weights, stats, n_workers=workers,
                             quantize_kwargs={"lmmse": False},
                             compute_distortion=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if report.retries:
        raise AssertionError(f"{workers}-worker execution retried "
                             f"{report.retries} task(s)")
    realized, planned = plan.realized_bits_per_param, \
        plan.planned_bits_per_param
    if abs(realized - planned) > 0.05:
        raise AssertionError(f"{plan.weighting} plan: realized {realized} "
                             f"bits against {planned} planned")
    return q, {"workers": workers, "wall_s": wall,
               "serial_s": report.serial_s,
               "zsic_launches": zsic_block_cuda.launches,
               "planned_bits": planned, "realized_bits": realized,
               "weighted_distortion": weighted_distortion(plan)}


class shared_plan_model:
    """``launch.plan.model_from_provenance`` memoized while the block
    runs: ``launch.plan build`` and the phase's own execution rebuild the
    same numpy weights and tokens from one provenance, and a full-width
    draw takes seconds of host time (about 30 s for one phi3.5-moe
    layer).  The weights are only read by either."""

    KEYS = ("arch", "reduced", "n_layers", "seed", "calib_batches",
            "seq_len", "global_batch", "init")

    def __enter__(self):
        self.real, memo = launch_plan.model_from_provenance, {}

        def cached(prov, device):
            key = tuple(repr(prov.get(k)) for k in self.KEYS)
            if key not in memo:
                memo[key] = self.real(prov, device)
            return memo[key]
        launch_plan.model_from_provenance = cached
        return self

    def __exit__(self, *exc):
        launch_plan.model_from_provenance = self.real
        return False


def plan_phase(dev, out):
    """``launch.plan build`` (minicpm-2b at full width, 2 layers, numpy
    weights and tokens from seed 0, 2 × PLAN_CALIB_ROWS × 128 calibration
    tokens, output weighting, PLAN_BITS), the
    artifact reloaded and ``inspect``-ed, then the snapped plan executed on
    1 and 4 workers (identical results), and the continuous waterfilled
    optimum against the even spread at the same budget."""
    path = str(out / "plan.json")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plan = launch_plan.main([
        "build", "--arch", "minicpm-2b", "--n-layers", "2", "--seed", "0",
        "--target-bits", str(PLAN_BITS), "--weighting", "output",
        "--calib-batches", "2", "--seq-len", "128", "--global-batch",
        str(PLAN_CALIB_ROWS),
        "--out", path])
    torch.cuda.synchronize(dev)
    rec = {"build_s": time.perf_counter() - t0,
           "payloads": plan.payload_histogram()}
    if 8 not in rec["payloads"] or not set(rec["payloads"]) & {2, 3, 4}:
        raise AssertionError(f"the snapped plan at {PLAN_BITS} bits holds "
                             f"payloads {rec['payloads']}: it must mix int8 "
                             "and sub-byte")
    if QuantPlan.load(path) != plan:
        raise AssertionError("the plan artifact does not round-trip")
    launch_plan.main(["inspect", "--plan", path])
    cfg, params, calib = launch_plan.model_from_provenance(plan.provenance,
                                                           dev)
    weights, stats = plan_inputs_for_model(cfg, params, calib)
    q1, rec["snapped"] = execute(plan, weights, stats, dev, 1)
    if rec["snapped"]["zsic_launches"] == 0:
        raise AssertionError("plan execution ran no ZSIC kernel launch")
    q4, rec["snapped_4_workers"] = execute(QuantPlan.load(path), weights,
                                           stats, dev, 4)
    for name, a in q1.items():
        for f in ("codes", "alphas", "gamma", "t"):
            if not torch.equal(getattr(a, f), getattr(q4[name], f)):
                raise AssertionError(f"{name}.{f}: 4 workers differ from 1")
    print(f"plan execute: 4 workers equal 1 worker on all {len(q1)} "
          "matrices (codes, alphas, gamma, t)", flush=True)
    del q1, q4
    t0 = time.perf_counter()
    sens = model_sensitivities(cfg, params, calib, weighting="output")
    rec["sensitivities_s"] = time.perf_counter() - t0
    if build_plan(sens, PLAN_BITS, weighting="output").diff(plan):
        raise AssertionError("the library's snapped plan differs from the "
                             "artifact of launch.plan build")
    cont = build_plan(sens, PLAN_BITS, snap=False, weighting="output")
    even = even_plan(sens, PLAN_BITS)
    _, rec["waterfilled"] = execute(cont, weights, stats, dev, 1)
    _, rec["even"] = execute(even, weights, stats, dev, 1)
    d_wf = rec["waterfilled"]["weighted_distortion"]
    d_ev = rec["even"]["weighted_distortion"]
    if not d_wf < d_ev:
        raise AssertionError(f"waterfilled weighted distortion {d_wf} is not "
                             f"below the even spread's {d_ev}")
    for key in ("snapped", "snapped_4_workers", "waterfilled", "even"):
        r = rec[key]
        print(f"plan execute {key}: {r['wall_s']:.2f}s wall, "
              f"{r['zsic_launches']} ZSIC launches, realized "
              f"{r['realized_bits']:.4f} of {r['planned_bits']:.4f} bits, "
              f"weighted distortion {r['weighted_distortion']:.5e}",
              flush=True)
    print(f"plan: waterfilled/even weighted distortion "
          f"{d_wf / d_ev:.4f} at {PLAN_BITS} bits; snapped (planned "
          f"{plan.planned_bits_per_param:.4f}) "
          f"{rec['snapped']['weighted_distortion'] / d_ev:.4f} of even",
          flush=True)
    return plan, rec


def mixed_serve_phase(cfg, plan, dev):
    """The plan's per-type formats on full-width, full-depth minicpm-2b:
    int8 types through the int8 kernel, the rest through the packed one,
    held against the dequantized-weight model; then a 2-layer copy's
    greedy streams from the static and the continuous engine."""
    fmt = serving_formats_from_plan(plan)
    int8_types = [f"{b}/{k}" for b, k in TYPE_SHAPES
                  if fmt(("layers", b, k, "w")) == 8]
    mixed = quantize_params_tree(init_params(cfg, 0, device=dev),
                                 nbits_by_path=fmt)
    torch.cuda.synchronize(dev)
    hist = leaf_format_histogram(mixed)
    qb, fb = qweight_bytes(mixed)
    print(f"mixed serve formats {hist}, int8 types {int8_types}, param bytes "
          f"{qb} (bf16 {fb})", flush=True)
    rec = serve_tree(cfg, mixed, dequantized_model, "mixed", dev, n_req=8,
                     prompt_len=32, new_tokens=16, max_len=64, slots=8,
                     chunk=16)
    if rec["launches_per_step"].get(8) != len(int8_types) * cfg.n_layers:
        raise AssertionError(f"int8 launches per step "
                             f"{rec['launches_per_step']}, expected "
                             f"{len(int8_types)} x {cfg.n_layers}")
    # one device kernel per int8 call in a decode step, and a traced step
    traced = step_breakdown(cfg, mixed, dev, 8, 64, [])
    rec.update({k: traced[k] for k in traced if k.startswith("traced_")
                or k.startswith("graph_") or k.startswith("device_")
                or k.startswith("decode_step")})
    rec["prefill"] = prefill_phase(cfg, mixed, "mixed", dev)
    print(f"mixed serve decode step: {rec['graph_int8_kernels_per_step']} "
          f"int8 and {rec['graph_packed_kernels_per_step']} packed device "
          f"kernels of {rec['graph_kernels_per_step']} in a CUDA graph of "
          "the step"
          + ("" if rec.get("device_busy_ms_per_step") is None else
             f"; traced: int8 {rec['traced_int8_ms_per_step']:.3f} ms, "
             f"packed {rec['traced_packed_ms_per_step']:.3f} ms device per "
             f"step, device idle share {rec['device_idle_share']:.4f}"),
          flush=True)
    del mixed
    torch.cuda.empty_cache()
    rec.update({"formats": hist, "int8_types": int8_types,
                "qweight_bytes": qb, "bf16_bytes": fb})
    short = dataclasses.replace(cfg, n_layers=2)
    tree = quantize_params_tree(init_params(short, 0, device=dev),
                                nbits_by_path=fmt)
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, cfg.vocab, int(rng.integers(3, 12)))
             .astype(np.int32), int(rng.integers(2, 9))) for _ in range(6)]
    streams = []
    for cls in (ServeEngine, ContinuousEngine):
        eng = cls(short, tree, config=EngineConfig(
            n_slots=4, max_len=24, cache_dtype=torch.float32,
            prefill_chunk=4))
        for i, (p, b) in enumerate(work):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=b))
        streams.append({r.rid: list(r.out_tokens)
                        for r in eng.run_until_done()})
    if streams[0] != streams[1] or sorted(streams[0]) != list(range(6)):
        raise AssertionError(f"2-layer mixed streams differ: static "
                             f"{streams[0]}, continuous {streams[1]}")
    print(f"mixed serve 2 layers: static and continuous streams identical "
          f"({sum(len(v) for v in streams[0].values())} tokens)", flush=True)
    rec["two_layer_streams_equal"] = True
    return rec


# ---------------------------------------------------------------------------
# exact dense prefill, the GPTQ baseline, observability, flash gradients
# ---------------------------------------------------------------------------


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill_phase(cfg, tree, label, dev, *, n_req=8, prompt_len=32,
                  max_len=64, strict=True):
    """``models.prefill`` of ``n_req`` prompts in one full-sequence pass
    (every dequant kernel once per layer of each of its leaves over B·S
    rows, flash attention causal where its conditions hold) against
    ``decode_chunk`` over the same prompts: the f32 cache and the last
    logits within LOGIT_TOL of the largest value (the same products summed
    in another split and order over the depth: m = B·S against m = B
    launches, flash against the decode softmax over the cache).  With
    ``strict=False`` the differences are reported, not held (a MoE model
    whose experts' capacity drops pairs routes B·S tokens differently from
    B-token steps)."""
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (n_req, prompt_len)),
                           device=dev)
    split = split_layers(tree)
    prefill(cfg, split, {"tokens": toks[:, :4]}, max_len, torch.float32)
    _sync(dev)
    reset_launches()
    reset_flash_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, split, {"tokens": toks}, max_len,
                            torch.float32)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {nb: c for nb, c in LAUNCHES.items() if c}
    flash_launches = flash_attention_cuda.launches
    want_launches = launches_per_step(tree)
    hd = cfg.resolved_head_dim
    want_flash = cfg.n_layers if cfg.n_heads == cfg.n_kv \
        and hd in flash.HEAD_DIMS else 0
    if launches != want_launches or flash_launches != want_flash:
        raise AssertionError(f"prefill {label}: dequant launches {launches} "
                             f"(expected {want_launches}), flash "
                             f"{flash_launches} (expected {want_flash})")
    tc = check_tc(dev, f"prefill {label}", n_req * prompt_len, launches)
    t0 = time.perf_counter()
    want_logits, want = decode_chunk(cfg, split, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), toks)
    _sync(dev)
    chunk_wall = time.perf_counter() - t0
    if int(cache.pos) != prompt_len or logits.shape != (n_req, cfg.vocab):
        raise AssertionError(f"prefill {label}: pos {int(cache.pos)}, "
                             f"logits {tuple(logits.shape)}")
    errs = {}
    for what, got, ref in (("k", cache.kv.k, want.kv.k),
                           ("v", cache.kv.v, want.kv.v),
                           ("logits", logits, want_logits)):
        scale = float(ref.abs().max())
        if strict:
            errs[what] = check(got, ref, f"prefill {label} {what} vs "
                               "decode_chunk", atol=LOGIT_TOL * scale,
                               rtol=0.0) / scale
        else:
            errs[what] = float((got - ref).abs().max()) / scale
    greedy_equal = bool(torch.equal(logits.argmax(-1),
                                    want_logits.argmax(-1)))
    rec = {"format": label, "batch": n_req, "prompt_len": prompt_len,
           "strict": strict,
           "prefill_ms": 1e3 * wall, "decode_chunk_ms": 1e3 * chunk_wall,
           "launches": launches, "tc_launches": tc,
           "flash_launches": flash_launches,
           "rel_err": errs, "cache_bit_equal": bool(
               torch.equal(cache.kv.k, want.kv.k)
               and torch.equal(cache.kv.v, want.kv.v)),
           "greedy_equal": greedy_equal}
    print(f"prefill {cfg.name} L={cfg.n_layers} {label}: {n_req} x "
          f"{prompt_len} tokens in {rec['prefill_ms']:.2f} ms (decode_chunk "
          f"{rec['decode_chunk_ms']:.2f} ms), dequant launches {launches}, "
          f"flash launches {flash_launches}; vs decode_chunk rel err k "
          f"{errs['k']:.3e} v {errs['v']:.3e} logits {errs['logits']:.3e}, "
          f"cache bit-equal {rec['cache_bit_equal']}, greedy tokens equal "
          f"{greedy_equal}", flush=True)
    return rec


#: rows of a prefill launch: 8 prompts of 32 tokens
PREFILL_M = 256


def prefill_kernel_phase(dev, gen, flush):
    """B1 (int4) and B2 at m = PREFILL_M on the serving shapes: kernel,
    twin, ``F.linear`` on the pre-dequantized f32 weight, and the bound."""
    cases = {"int4": [], "int8": []}
    for k, n in PATH_SHAPES:
        c = kernel_case(4, PREFILL_M, k, n, dev, gen, flush)
        cases["int4"].append(c)
        c8 = int8_case(PREFILL_M, k, n, "kn", dev, gen, flush, timed=True)
        cases["int8"].append(c8)
        for name, r in (("B1 int4", c), ("B2 int8", c8)):
            print(f"prefill kernel {name} m={PREFILL_M} k={k} n={n}: "
                  f"us={1e3 * r['ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f}"
                  f" F.linear_us={1e3 * r['library_ms']:.2f} bound_us="
                  f"{1e3 * r['bound_ms']:.2f} ({r['bound_by']}) max_abs_err="
                  f"{r['max_abs_err']:.3e}", flush=True)
    return cases


#: GPTQ damping, relative to the mean diagonal of Σ_X (the pipeline's): the
#: 1024 calibration tokens leave Σ_X rank deficient at these widths
GPTQ_DAMP = 0.05
#: the matched-rate search stops within this many bits of WaterSIC's rate
RATE_TOL = 0.005


def _damped(sigma):
    n = sigma.shape[0]
    return sigma + GPTQ_DAMP * torch.mean(torch.diagonal(sigma)) * torch.eye(
        n, dtype=sigma.dtype, device=sigma.device)


def _distortion(w, w_hat, sigma):
    err = w - w_hat
    return float(((err @ sigma) * err).sum() / err.numel())


def gptq_at_rate(w, sigma_d, target, alpha0):
    """Huffman-GPTQ (``gptq_via_zsic``, ZSIC through the in-block kernel)
    with α found by a secant search on log₂ α so the codes' entropy hits
    ``target``; returns (result, α, evaluations)."""
    def h(x):
        return gptq_via_zsic(w, sigma_d, 2.0 ** x)
    x0 = math.log2(alpha0)
    r0 = h(x0)
    f0 = r0["entropy"] - target
    x1 = x0 + f0                      # entropy falls ≈ 1 bit per doubling
    r1 = h(x1)
    f1 = r1["entropy"] - target
    evals = 2
    while abs(f1) > RATE_TOL and evals < 8 and abs(f1 - f0) > 1e-9:
        x0, f0, x1 = x1, f1, x1 - f1 * (x1 - x0) / (f1 - f0)
        r1 = h(x1)
        f1 = r1["entropy"] - target
        evals += 1
    return r1, 2.0 ** x1, evals


def gptq_phase(cfg, dev):
    """The PTQ phase's full-width model (PTQ_LAYERS deep, 7 matrices a
    layer) and calibration: WaterSIC at 3 bits (ZSIC through the in-block kernel, no
    LMMSE) and Huffman-GPTQ through the same kernel at each matrix's
    WaterSIC rate; each method's rate and Σ N·D (weighted distortion on the
    undamped Σ_X).  Then for one (2304, 2304) matrix: the card's GPTQ
    codes against float64 ``gptq_frantar`` on the flipped order, and the
    rANS bits per entry of the codes beside their empirical entropy."""
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
             for _ in range(2)]
    weights, stats = plan_inputs_for_model(cfg, params, calib)
    rows, tot = [], {"watersic": [0.0, 0.0, 0], "gptq": [0.0, 0.0, 0]}
    reset_zsic_launches()
    t0 = time.perf_counter()
    for name in sorted(weights):
        w = weights[name].contiguous()
        sigma = stats[name].sigma_x.to(torch.float32)
        q = quantize_at_rate(w, stats[name], 3.0, damp=GPTQ_DAMP,
                             lmmse=False)
        d_ws = layer_distortion(w, q, sigma)
        alpha0 = float(torch.exp(torch.log(q.alphas).mean()))
        launches0 = zsic_block_cuda.launches
        g, alpha, evals = gptq_at_rate(w, _damped(sigma), q.entropy_bits,
                                       alpha0)
        d_g = _distortion(w, g["w_hat"], sigma)
        n_par = w.numel()
        for key, rate, dist in (("watersic", q.entropy_bits, d_ws),
                                ("gptq", g["entropy"], d_g)):
            tot[key][0] += rate * n_par
            tot[key][1] += dist * n_par
            tot[key][2] += n_par
        rows.append({"matrix": name, "shape": list(w.shape),
                     "watersic_rate": q.entropy_bits, "watersic_D": d_ws,
                     "gptq_rate": g["entropy"], "gptq_D": d_g,
                     "gptq_alpha": alpha, "gptq_evals": evals,
                     "gptq_zsic_launches": zsic_block_cuda.launches
                     - launches0})
        if abs(g["entropy"] - q.entropy_bits) > 0.05:
            raise AssertionError(f"{name}: GPTQ rate {g['entropy']} does not "
                                 f"match WaterSIC's {q.entropy_bits}")
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = zsic_block_cuda.launches
    if launches == 0 or any(r["gptq_zsic_launches"] == 0 for r in rows):
        raise AssertionError("GPTQ ran without the ZSIC kernel")
    summary = {k: {"rate": v[0] / v[2], "weighted_distortion": v[1],
                   "params": v[2]} for k, v in tot.items()}
    for k, v in summary.items():
        print(f"gptq phase {k}: rate {v['rate']:.4f} bits, weighted "
              f"distortion sum N*D {v['weighted_distortion']:.6e} over "
              f"{len(rows)} matrices", flush=True)
    ratio = summary["gptq"]["weighted_distortion"] \
        / summary["watersic"]["weighted_distortion"]
    print(f"gptq phase: GPTQ / WaterSIC weighted distortion {ratio:.4f} at "
          f"matched rate; {launches} ZSIC kernel launches in {wall:.2f}s",
          flush=True)
    # one (d_model, d_model) matrix: the card's GPTQ against float64 Frantar
    name = next(r["matrix"] for r in rows
                if r["shape"] == [cfg.d_model, cfg.d_model])
    alpha = next(r["gptq_alpha"] for r in rows if r["matrix"] == name)
    w = weights[name].contiguous()
    sigma_d = _damped(stats[name].sigma_x.to(torch.float32))
    flip = torch.arange(w.shape[1] - 1, -1, -1, device=dev)
    card = gptq_via_zsic(w[:, flip].contiguous(),
                         sigma_d[flip][:, flip].contiguous(), alpha)
    codes = card["codes"].flip(1).cpu().numpy()
    frantar = {"matrix": name, "shape": list(w.shape), "codes": codes,
               "card_distortion": card["distortion"],
               "job": start_host_job("repro_torch.core.gptq:gptq_frantar",
                                     w.double().cpu().numpy(),
                                     sigma_d.double().cpu().numpy(), alpha)}
    t0 = time.perf_counter()
    codec = RansCodec.from_data(codes)
    payload = codec.encode(codes)
    rans_s = time.perf_counter() - t0
    rans_bits = 8 * len(payload) / codes.size
    ent_bits = empirical_entropy(codes)
    if not ent_bits - 1e-6 <= rans_bits <= ent_bits + 0.05:
        raise AssertionError(f"rANS {rans_bits} bits/entry against entropy "
                             f"{ent_bits}")
    print(f"gptq {name}: rANS {rans_bits:.5f} bits/entry beside empirical "
          f"entropy {ent_bits:.5f} ({codes.size} codes, {rans_s:.1f}s)",
          flush=True)
    return {"matrices": rows, "summary": summary,
            "gptq_over_watersic_distortion": ratio, "wall_s": wall,
            "zsic_launches": launches,
            "frantar": frantar,
            "rans": {"bits_per_entry": rans_bits, "entropy": ent_bits,
                     "encode_s": rans_s}}


def start_host_job(fn, *args) -> dict:
    """``fn(*args)`` (a ``repro_torch`` function named "module:attr", on
    numpy arguments) in a process of its own on the host, beside the
    phases that follow: the float64 oracles' loops take tens of seconds of
    CPU that the card need not wait for.  ``finish_host_job`` returns its
    result; the process is stopped at exit if it still runs."""
    import atexit
    import pickle
    import tempfile
    (ROOT / "scratch").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "scratch", prefix="host_job_"))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(args, f)
    code = ("import importlib, pickle, sys, time\n"
            "d, (mod, attr) = sys.argv[1], sys.argv[2].split(':')\n"
            "fn = getattr(importlib.import_module(mod), attr)\n"
            "args = pickle.load(open(d + '/in.pkl', 'rb'))\n"
            "t0 = time.perf_counter()\n"
            "out = fn(*args)\n"
            "pickle.dump((out, time.perf_counter() - t0), "
            "open(d + '/out.pkl', 'wb'))\n")
    threads = "2"
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(tmp), fn], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS=threads, OPENBLAS_NUM_THREADS=threads,
                 MKL_NUM_THREADS=threads))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"fn": fn, "proc": proc, "dir": tmp}


def finish_host_job(job) -> tuple:
    """(result, seconds) of ``start_host_job``'s job, once it ends."""
    import pickle
    import shutil
    try:
        _, err = job["proc"].communicate(timeout=900)
        if job["proc"].returncode != 0:
            raise AssertionError(f"{job['fn']} exited "
                                 f"{job['proc'].returncode}: {err[-3000:]}")
        with open(job["dir"] / "out.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(job["dir"], ignore_errors=True)


def finish_frantar(rec) -> dict:
    """The gptq phase's float64 Frantar oracle, read: the card's codes
    (f32, ZSIC kernel) must agree with it on at least 0.999 of the
    entries."""
    codes = rec.pop("codes")
    ref, oracle_s = finish_host_job(rec.pop("job"))
    agree = float((codes == ref["codes"]).mean())
    rec.update(code_agreement=agree, frantar_distortion=ref["distortion"],
               oracle_s=oracle_s)
    print(f"gptq {rec['matrix']} {tuple(rec['shape'])}: card (f32, ZSIC "
          f"kernel) vs gptq_frantar float64 flipped: code agreement "
          f"{agree:.6f}, distortion {rec['card_distortion']:.6e} vs "
          f"{ref['distortion']:.6e} (oracle {oracle_s:.1f}s on the host, "
          f"beside the later phases)", flush=True)
    if agree < 0.999:
        raise AssertionError(f"GPTQ through the kernel agrees on {agree} of "
                             "the codes with float64 Frantar")
    return rec


def engine_run(cfg, tree, prompts, new_tokens, dev, *, slots, max_len,
               chunk, resilience=None) -> dict:
    """One ``ContinuousEngine`` run of ``tree`` (the kernel counts zeroed
    just before it): its streams, step and decode step times, tokens/s,
    KV-cache bytes and launches and, with ``repro_torch.obs`` on, the
    ladder entry that ``benchmarks/check_obs.py`` and ``check_bytes.py``
    read; ``engine`` is the engine itself."""
    eng = ContinuousEngine(cfg, tree, config=EngineConfig(
        n_slots=slots, max_len=max_len, cache_dtype=torch.float32,
        prefill_chunk=chunk, resilience=resilience))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=new_tokens))
    _sync(dev)
    before = obs.counters_snapshot("repro_kernel_")
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    _sync(dev)
    wall = time.perf_counter() - t0
    after = obs.counters_snapshot("repro_kernel_")
    # decode steps only: at most `slots` rows
    tc = check_tc(dev, f"engine run {cfg.name}", slots, dict(LAUNCHES))
    _, fb = qweight_bytes(tree)
    tokens = sum(len(r.out_tokens) for r in done)
    steps = [st.step_s for st in eng.step_stats]
    return {"tok_s": tokens / wall, "tokens": tokens, "wall_s": wall,
            "bytes_per_w": eng.weight_bytes / (fb / 2),
            "weight_bytes": eng.weight_bytes,
            "weight_formats": dict(eng.weight_formats),
            "obs_kernel": {k: v - before.get(k, 0.0) for k, v in after.items()
                           if v != before.get(k, 0.0)},
            "dispatches": eng.prefill_calls + eng.decode_calls,
            "inventory": leaf_inventory(tree),
            "decode_step_ms": 1e3 * eng.decode_s / max(eng.decode_calls, 1),
            "steps": len(steps),
            "step_ms_mean": 1e3 * statistics.mean(steps),
            "step_ms_median": 1e3 * statistics.median(steps),
            "kv_bytes": sum(t.numel() * t.element_size()
                            for t in tree_leaves(eng.cache.kv)),
            "launches": dict(LAUNCHES), "tc_launches": tc, "engine": eng,
            "streams": {r.rid: list(r.out_tokens) for r in done}}


def static_streams(cfg, tree, prompts, new_tokens, *, slots, max_len,
                   chunk):
    """``ServeEngine``'s greedy streams of the prompts: {rid: tokens}."""
    eng = ServeEngine(cfg, tree, config=EngineConfig(
        n_slots=slots, max_len=max_len, cache_dtype=torch.float32,
        prefill_chunk=chunk))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=new_tokens))
    return {r.rid: list(r.out_tokens) for r in eng.run_until_done()}


def obs_serve_phase(cfg, params, dev, out, *, n_req, prompt_len, new_tokens,
                    max_len, slots, chunk, ladder_layers):
    """The int4 serve traffic with observability off, then on (equal
    streams), then int8/int3/int2 at ``ladder_layers`` layers with it on;
    writes the trace, Prometheus text, event log and bench JSON into
    ``out`` and runs ``benchmarks/check_obs.py`` and ``check_bytes.py``
    unchanged; a gate's nonzero exit fails the phase."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    kw = dict(slots=slots, max_len=max_len, chunk=chunk)
    with obs.scoped(enable_obs=False):
        off = engine_run(cfg, params, prompts, new_tokens, dev, **kw)
    paths = {k: str(out / f) for k, f in (
        ("bench", "obs_bench.json"), ("trace", "obs_trace.json"),
        ("prom", "obs.prom"), ("events", "obs_events.jsonl"))}
    with obs.scoped(enable_obs=True):
        ladder = {"int4_packed": engine_run(cfg, params, prompts,
                                                new_tokens, dev, **kw)}
        short = dataclasses.replace(cfg, n_layers=ladder_layers)
        base = init_params(short, 0, device=dev)
        for name, wbits in (("int8", 8), ("int3_packed", 3),
                            ("int2_packed", 2)):
            ladder[name] = engine_run(short, quantize_for_wbits(
                base, wbits), prompts, new_tokens, dev, **kw)
        del base
        obs.write_trace(paths["trace"])
        obs.write_prometheus(paths["prom"])
        obs.write_jsonl(paths["events"])
    on = ladder["int4_packed"]
    if on["streams"] != off["streams"]:
        raise AssertionError("streams with obs on differ from obs off")
    keys = ("tok_s", "tokens", "bytes_per_w", "weight_bytes",
            "weight_formats", "obs_kernel", "dispatches", "inventory")
    with open(paths["bench"], "w") as f:
        json.dump({"ladder": {name: {k: e[k] for k in keys}
                              for name, e in ladder.items()},
                   "sched": {"n_slots": slots}}, f, indent=1,
                  sort_keys=True, default=float)
    gates = []
    for gate, args in (("check_obs", ["--bench", paths["bench"], "--trace",
                                      paths["trace"], "--prom", paths["prom"],
                                      "--events", paths["events"]]),
                       ("check_bytes", [paths["bench"]])):
        res = subprocess.run([sys.executable, str(ROOT / "benchmarks"
                                                  / f"{gate}.py"), *args],
                             capture_output=True, text=True, timeout=300)
        print(res.stdout.rstrip(), flush=True)
        if res.returncode != 0:
            raise AssertionError(f"{gate}.py exited {res.returncode}: "
                                 f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
        gates.append(gate)
    print(f"obs serve {cfg.name} L={cfg.n_layers} int4: streams equal with "
          f"obs on and off; decode step {on['decode_step_ms']:.3f} ms (on) "
          f"vs {off['decode_step_ms']:.3f} ms (off), {on['tok_s']:.2f} vs "
          f"{off['tok_s']:.2f} tok/s; {on['dispatches']} dispatches; gates "
          f"{gates} passed", flush=True)
    return {"streams_equal": True, "gates": gates,
            "decode_step_ms_on": on["decode_step_ms"],
            "decode_step_ms_off": off["decode_step_ms"],
            "tok_s_on": on["tok_s"], "tok_s_off": off["tok_s"],
            "dispatches": on["dispatches"],
            "ladder": {name: {k: e[k] for k in ("tokens", "dispatches",
                                                "weight_bytes",
                                                "decode_step_ms")}
                       for name, e in ladder.items()}}


#: the reference bench's serving model (``benchmarks/serve_bench.py``'s
#: ``run``, full size): the quality gates' thresholds were calibrated on it
BENCH_CFG = dict(name="bench", family="dense", n_layers=4, d_model=256,
                 n_heads=4, n_kv=4, d_ff=512, vocab=256, head_dim=64)


def bench_envelope(dev) -> dict:
    """The shared bench envelope ``benchmarks/bench_schema.py`` validates
    (schema 1, bench "serve"), written here without importing it."""
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=10).stdout.strip() or "unknown"
    except OSError:
        rev = "unknown"
    return {"schema_version": 1, "bench": "serve", "git_rev": rev,
            "host": {"device_count": (torch.cuda.device_count()
                                      if dev.type == "cuda" else 1),
                     "platform": "gpu" if dev.type == "cuda" else "cpu"}}


def quality_cells(cfg, params, dev, *, budget=24, step_limit_s=0.25,
                  delay_s=0.5) -> dict:
    """``serve_bench.quality_bench`` on this package: a warm-up run, then
    two obs-enabled cells over the same packed-int4 tree and workload with
    a ``QualityMonitor`` attached — clean (no drift flag allowed) and
    under seeded slow-step + corrupt-payload faults (``step_s`` and
    ``integrity`` must flag), equal streams; returns both summaries.
    ``step_limit_s``/``delay_s`` are the bench's step detector and sleep
    (a shared CPU running the twins needs wider ones)."""
    rng = np.random.default_rng(3)
    n_req, plen = 4, 8
    prompts = [rng.integers(0, cfg.vocab, plen).astype(np.int32)
               for _ in range(n_req)]
    calib = [rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
             for _ in range(2)]
    acc = collect_sigma_x(cfg, params, calib)
    qtree = quantize_params_tree(params, nbits=4, packed=True)
    max_len = plen + budget + 2
    # absolute-threshold step detector: a clean step of this model is
    # milliseconds, the chaos sleep 0.5 s
    qcfg = QualityConfig(
        sigma_every=2, probe_every=4, slo_every=8,
        detectors={"step_s": lambda: Threshold(limit=step_limit_s),
                   "integrity": lambda: Threshold(limit=0.0)},
        track_sigma_drift=False)    # live traffic != calib tokens by design

    def run(mon=None, resilience=None, plan=None):
        eng = ContinuousEngine(cfg, qtree, config=EngineConfig(
            n_slots=n_req, max_len=max_len, prefill_chunk=4, quality=mon,
            resilience=resilience))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.copy(),
                               max_new_tokens=budget))
        if plan is None:
            return eng, eng.run_until_done()
        with chaos.active(plan):
            return eng, eng.run_until_done()

    def cell(plan):
        with obs.scoped(enable_obs=True):
            mon = QualityMonitor(cfg, params, calib=acc, config=qcfg)
            eng, done = run(mon, ResilienceConfig(integrity_every=1), plan)
            assert len(done) == n_req and not eng.dropped
            summary = mon.summary()
            summary["out"] = {r.rid: list(map(int, r.out_tokens))
                              for r in done}
            summary["steps"] = len(eng.step_stats)
            return summary

    run()                               # warm every shape fault-free
    clean = cell(None)
    sp = chaos.seeded_plan("slow-step", seed=0, horizon=12, n_faults=2,
                           first=2, delay_s=delay_s)
    cp = chaos.seeded_plan("corrupt-payload", seed=0, horizon=12,
                           n_faults=2, first=2, n_bytes=3)
    chaotic = cell(chaos.ChaosPlan(seed=0, specs=sp.specs + cp.specs))
    if chaotic["out"] != clean["out"]:
        raise AssertionError("quality chaos cell changed token streams")
    if clean["drift"]["n_flags"]:
        raise AssertionError(f"clean quality cell flagged drift: "
                             f"{clean['drift']}")
    flagged = chaotic["drift"]["series"]
    if flagged.get("step_s", 0) < 1 or flagged.get("integrity", 0) < 1:
        raise AssertionError(f"quality chaos cell missed a flag: {flagged}")
    return {"clean": clean, "chaos": chaotic}


def requant_cell(cfg, params, dev, *, limit=2.0) -> dict:
    """``serve_bench.requant_bench`` on this package: clean traffic, then a
    rank-collapsing repeated-token phase trips the streamed-Σ Frobenius
    detectors (``limit``); the actuator must fire exactly once, swap at a
    step boundary with every busy step emitting, and the swapped tree
    must equal the offline re-plan from the recorded snapshots byte for
    byte.  Returns the summary ``benchmarks/check_requant.py`` reads."""
    rng = np.random.default_rng(9)
    plen, budget = 8, 8
    calib = [rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
             for _ in range(2)]
    sens = model_sensitivities(cfg, params, calib, weighting="output")
    plan = build_plan(sens, 4.0, weighting="output")
    acc = collect_sigma_x(cfg, params, calib)
    qcfg = QualityConfig(
        sigma_every=1, probe_every=10_000, slo_every=10_000,
        detectors=sigma_threshold_detectors(matrix_tap_map(cfg, params),
                                            limit=limit))
    with obs.scoped(enable_obs=True):
        eng = engine_from_plan(
            cfg, params, plan, calib=acc, sensitivities=sens,
            quality_config=qcfg,
            config=EngineConfig(
                n_slots=2, max_len=plen + budget + 2,
                requant=RequantConfig(min_samples=8, cooldown_steps=8,
                                      max_actuations=1)))
        rid = 0

        def drive(prompt_fn, n_req, n_steps):
            nonlocal rid
            for _ in range(n_req):
                eng.submit(Request(rid=rid, prompt=prompt_fn(),
                                   max_new_tokens=budget))
                rid += 1
            for _ in range(n_steps):
                eng.step()

        drive(lambda: rng.integers(0, cfg.vocab, plen).astype(np.int32),
              6, 40)
        drive(lambda: np.full(plen, 7, np.int32), 10, 80)
    # the bench JSON's requant block: per-step emission, the offline
    # bit-identity verdict, post-swap realized/predicted distortion
    steps = [{"tick": i + 1, "active": st.active, "admitted": st.admitted,
              "new_tokens": st.new_tokens}
             for i, st in enumerate(eng.step_stats)]
    acts = eng.requant.actuations
    if len(acts) != 1:
        raise AssertionError(f"expected exactly 1 actuation, got "
                             f"{len(acts)}")
    a = acts[0]
    _, tree, _, _, _ = replan_from_sigma(cfg, params, a["plan_before"],
                                         a["snapshots"])
    live = dict(tree_leaves_with_path(eng.params))
    offline = dict(tree_leaves_with_path(tree))
    bit_identical = live.keys() == offline.keys() and all(
        torch.equal(live[k], offline[k]) for k in live)
    swap_tick = next(t for t, why in eng.swap_history if why == "requant")
    ratios = {}
    for name in a["matrices"]:
        e = a["plan_after"].entry(name)
        if e.realized_distortion and e.pred_distortion:
            ratios[name] = e.realized_distortion / e.pred_distortion
    busy = [s for s in steps if s["active"] or s["admitted"]]
    return {
        "actuations": len(acts),
        "tick": a["tick"], "swap_tick": swap_tick,
        "taps": list(a["taps"]), "matrices": list(a["matrices"]),
        "payload_before": a["payload_before"],
        "payload_after": a["payload_after"],
        "bit_identical": bool(bit_identical),
        "busy_steps": len(busy),
        "stalled_steps": [s["tick"] for s in busy if s["new_tokens"] < 1],
        "finished": len(eng.finished),
        "dropped": sum(1 for r in eng.finished if r.dropped),
        "realized_over_pred": ratios,
        "replan_wall_s": a["wall_s"],
        "executor_wall_s": a["executor_wall_s"],
        "weight_formats_after": dict(eng.weight_formats)}


def run_gate(gate, args) -> str:
    """One stdlib gate of ``benchmarks/`` as a subprocess; its nonzero
    exit fails the phase."""
    res = subprocess.run([sys.executable, str(ROOT / "benchmarks"
                                              / f"{gate}.py"), *args],
                         capture_output=True, text=True, timeout=300)
    print(res.stdout.rstrip(), flush=True)
    if res.returncode != 0:
        raise AssertionError(f"{gate}.py exited {res.returncode}: "
                             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return gate


def quality_requant_phase(dev, out, *, cfg_kw=None, budget=24) -> dict:
    """The reference bench's two quality cells and its requant cell at its
    own model configuration (``BENCH_CFG``; weights from ``init_params``
    seed 0), written as a bench JSON (``out/quality_bench.json``) that
    ``benchmarks/check_quality.py`` and ``check_requant.py`` gate
    unchanged (without ``--baseline``: the committed baseline holds the
    reference's numbers from another platform).  B1 serves the int4
    cells, B1/B2 the plan's formats, B4 runs in the re-plan; each count is
    zeroed just before and read just after."""
    from repro_torch.configs.base import ArchConfig
    cfg = ArchConfig(**(cfg_kw or BENCH_CFG))
    params = init_params(cfg, 0, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    quality = quality_cells(cfg, params, dev, budget=budget)
    q_launches = dict(LAUNCHES)
    q_s = time.perf_counter() - t0
    reset_launches()
    reset_zsic_launches()
    t0 = time.perf_counter()
    requant = requant_cell(cfg, params, dev)
    rq_launches = {"dequant": dict(LAUNCHES),
                   "zsic": zsic_block_cuda.launches}
    rq_s = time.perf_counter() - t0
    payload = {**bench_envelope(dev), "quality": quality, "requant": requant}
    path = out / "quality_bench.json"
    path.write_text(json.dumps(payload, indent=1, default=float))
    gates = [run_gate("check_quality", ["--bench", str(path)]),
             run_gate("check_requant", ["--bench", str(path)])]
    # the bench cell's re-plan quantizes as the reference's does (WaterSIC
    # with LMMSE, no kernel): B4 is not on the requant path
    if dev.type == "cuda" and (q_launches[4] == 0
                               or sum(rq_launches["dequant"].values()) == 0):
        raise AssertionError(f"quality/requant cells missed a kernel: "
                             f"{q_launches} {rq_launches}")
    print(f"quality + requant cells ({cfg.name} L={cfg.n_layers} "
          f"d={cfg.d_model}): clean logits MSE "
          f"{quality['clean']['logits_mse_mean']:.4e}, chaos flags "
          f"{quality['chaos']['drift']['series']}; requant actuated at tick "
          f"{requant['tick']} (swap {requant['swap_tick']}), "
          f"{len(requant['matrices'])} matrices, re-plan "
          f"{requant['replan_wall_s']:.3f}s, bit-identical "
          f"{requant['bit_identical']}; B1 launches {q_launches[4]} "
          f"(quality), requant dequant {rq_launches['dequant']} ZSIC "
          f"{rq_launches['zsic']}; {q_s:.1f}s + {rq_s:.1f}s; gates {gates} "
          f"[{CARD}]", flush=True)
    return {"quality_launches": q_launches, "requant_launches": rq_launches,
            "quality_s": q_s, "requant_s": rq_s, "gates": gates,
            "requant": requant,
            "quality_logits_mse": quality["clean"]["logits_mse_mean"],
            "quality_chaos_flags": quality["chaos"]["drift"]["series"]}


def flash_grad_phase(cfg, dev, gen):
    """Gradients through the flash wrapper on the card: q/k/v grads at the
    ``model_ppl`` shape (B·H = 4·36, S = 256, d = 64) against the twin's
    autograd, and ``loss_fn``'s wq/wk/wv grads on the PTQ_LAYERS model
    against the same loss with the twin in the kernel's place."""
    b, s, h, d = 4, 256, 36, 64
    q, k, v = [torch.randn((b, s, h, d), generator=gen, device=dev)
               .requires_grad_() for _ in range(3)]
    g = torch.randn((b, s, h, d), generator=gen, device=dev)
    reset_flash_launches()
    out = flash.flash_attention(q, k, v, causal=True)
    if flash_attention_cuda.launches != 1:
        raise AssertionError("the flash wrapper did not launch the kernel")
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(flash_twin(q, k, v, causal=True), (q, k, v),
                               g)
    errs = [check(a, w, f"flash grad d{n}", atol=FLASH_TOL, rtol=FLASH_TOL)
            for a, w, n in zip(got, want, "qkv")]
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 129)), device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    leaves = [params["layers"]["attn"][n]["w"] for n in ("wq", "wk", "wv")]

    def grads():
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        loss_fn(cfg, params, batch).backward()
        return [t.grad for t in leaves]
    reset_flash_launches()
    kernel_grads = grads()
    launches = flash_attention_cuda.launches
    kernel_fn = flash.flash_attention
    flash.flash_attention = flash_twin
    try:
        twin_grads = grads()
    finally:
        flash.flash_attention = kernel_fn
    if launches != cfg.n_layers or any(x is None for x in kernel_grads):
        missing = [x is None for x in kernel_grads]
        raise AssertionError(f"loss_fn on the card: {launches} flash "
                             f"launches, wq/wk/wv grad missing {missing}")
    loss_errs = []
    for a, w, n in zip(kernel_grads, twin_grads, ("wq", "wk", "wv")):
        scale = float(w.abs().max())
        loss_errs.append(check(a, w, f"loss_fn grad {n}",
                               atol=GRAD_TOL * scale, rtol=0.0) / scale)
    print(f"flash grad B*H={b * h} S={s} d={d}: q/k/v grads through the "
          f"kernel's wrapper vs the twin max |d| "
          + ", ".join(f"{e:.3e}" for e in errs)
          + f"; loss_fn wq/wk/wv grads ({launches} flash launches) vs the "
          "twin path rel err " + ", ".join(f"{e:.3e}" for e in loss_errs),
          flush=True)
    return {"qkv_max_abs_err": errs, "loss_grad_rel_err": loss_errs,
            "loss_flash_launches": launches}


# ---------------------------------------------------------------------------
# Serving resilience, chaos, snapshot/resume, int8 KV (slice 7)
# ---------------------------------------------------------------------------

#: the chaos matrix's depth cut at full width
CHAOS_LAYERS = 4
#: the slow-step fault's sleep at full width: the step there carries an
#: integrity check of every payload (crc32 on the host), so the sleep must
#: stand clear of 4x the median step
CHAOS_DELAY_S = 2.0


def corrupt_product_check(cfg, dev) -> dict:
    """The corrupt-payload fault flips bytes that B1 reads: for the leaf a
    seed-0 plan corrupts, B1's product (every layer's view, m = 8) changes
    after the flip and returns bit for bit after ``PayloadGuard.heal``."""
    from repro_torch.kernels.dequant.ops import _walk_qweights
    from repro_torch.serve import PayloadGuard
    from repro_torch.models.layers import dense

    class Eng:
        params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    eng = Eng()
    views = split_layers(eng.params)
    guard = PayloadGuard(eng.params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((8, max(cfg.d_model, cfg.d_ff)), generator=gen,
                    device=dev)

    def product(path):
        """B1's product of every layer's view of the leaf at ``path``."""
        ys = []
        for layer in views["layers"]:
            node = layer
            for k in path.split("/")[1:]:
                node = node[k]
            ys.append(dense({"w": node}, x[:, :node["s"].shape[0]]))
        _sync(dev)
        return torch.stack(ys)

    clean = {p: product(p) for p, _ in _walk_qweights(eng.params)}
    rt = chaos.ChaosRuntime(chaos.seeded_plan(
        "corrupt-payload", 0, horizon=20, n_faults=2, first=0))
    while not rt.log:
        rt.fire("serve.step", engine=eng)
    path = rt.log[0]["path"]
    guard_bad = guard.verify(eng.params)
    dirty = product(path)
    guard.heal(eng.params, guard_bad)
    healed = product(path)
    clean = clean[path]
    changed = not torch.equal(dirty, clean)
    equal = torch.equal(healed, clean)
    if guard_bad != [path] or not changed or not equal:
        raise AssertionError(f"corrupt-payload product check: detected "
                             f"{guard_bad} (flipped {path}), changed "
                             f"{changed}, healed bit-equal {equal}")
    diff = float((dirty - clean).abs().max())
    print(f"corrupt-payload {path}: B1 product max |Δ| {diff:.4e} after the "
          f"flip, bit-equal after healing [{CARD}]", flush=True)
    return {"path": path, "n_bytes": rt.log[0]["n_bytes"],
            "dirty_max_abs_diff": diff, "healed_bit_equal": equal}


def chaos_phase(cfg, dev, out) -> dict:
    """The chaos matrix through ``repro_torch.launch.chaos`` at full width
    cut to CHAOS_LAYERS layers, packed int4: each of the five fault kinds
    at seed 0 (fault-free, faulted and snapshot→kill→resume runs), each
    summary and trace gated by ``benchmarks/check_chaos.py`` unchanged;
    B1 must run in each cell.  Then the corrupt-payload product check."""
    from repro_torch.launch import chaos as chaos_launch
    short = dataclasses.replace(cfg, n_layers=CHAOS_LAYERS)
    rows = {}
    for kind in chaos.FAULT_KINDS:
        t0 = time.perf_counter()
        js, tr = out / f"chaos_{kind}.json", out / f"chaos_{kind}_trace.json"
        reset_launches()
        summary = chaos_launch.main([
            "--kind", kind, "--seed", "0", "--arch", cfg.name,
            "--n-layers", str(short.n_layers), "--delay-s",
            str(CHAOS_DELAY_S), "--json-out", str(js), "--trace-out",
            str(tr)])
        b1 = LAUNCHES[4]
        run_gate("check_chaos", ["--summary", str(js), "--trace", str(tr)])
        if b1 == 0:
            raise AssertionError(f"chaos {kind}: B1 never launched")
        steps = summary["step_s"]
        rows[kind] = {"injected": summary["injected"],
                      "schedule": summary["schedule"],
                      "slow_steps": summary["slow_steps"],
                      "retries_used": summary["retries_used"],
                      "resume_match": summary["resume_match"],
                      "b1_launches": b1,
                      "median_step_ms": 1e3 * statistics.median(steps),
                      "cell_s": time.perf_counter() - t0}
        print(f"chaos {kind} at {short.name} L={short.n_layers}: "
              f"{summary['injected']} injected at {summary['schedule']}, "
              f"check_chaos passed; median step "
              f"{rows[kind]['median_step_ms']:.2f} ms, "
              f"{summary['slow_steps']} slow steps flagged, B1 {b1} "
              f"launches; "
              f"{rows[kind]['cell_s']:.1f}s [{CARD}]", flush=True)
    rows["corrupt_product"] = corrupt_product_check(short, dev)
    return rows


def _pairs(run_a, run_b):
    """``run_a``, ``run_b``, ``run_b``, ``run_a`` in turns (the host's
    spread drifts within a call); returns the two runs of each."""
    a1, b1 = run_a(), run_b()
    b2, a2 = run_b(), run_a()
    return (a1, a2), (b1, b2)


def resilience_serve_phase(cfg, params, dev, *, n_req, prompt_len,
                           new_tokens, max_len, slots, chunk) -> dict:
    """The serve cell's int4 traffic (at CHECK_LAYERS) with the resilience
    layer off and on (retry policy, integrity check every 8 steps,
    snapshots every 5 steps), in turns off, on, on, off: equal streams;
    the step times of each run, the time of one integrity check (crc32 of
    every payload, copied to the host), of building the guard (its
    pristine host copies) and of one snapshot."""
    import tempfile
    from repro_torch.dist.fault import RestartPolicy
    from repro_torch.kernels.dequant.ops import (_walk_qweights,
                                                 payload_checksums)
    from repro_torch.serve import PayloadGuard
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    kw = dict(slots=slots, max_len=max_len, chunk=chunk)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as snap:
        def run_on():
            res = ResilienceConfig(
                retry=RestartPolicy(max_restarts=3, backoff_base_s=0.01),
                integrity_every=8, snapshot_dir=snap, snapshot_every=5,
                snapshot_keep=1)
            rec = engine_run(cfg, params, prompts, new_tokens, dev,
                             resilience=res, **kw)
            rec["snapshots"] = len([d for d in Path(snap).iterdir()
                                    if d.name.startswith("step_")])
            return rec

        offs, ons = _pairs(lambda: engine_run(cfg, params, prompts,
                                              new_tokens, dev, **kw),
                           run_on)
        t0 = time.perf_counter()
        ons[1]["engine"].snapshot(snap)
        snapshot_s = time.perf_counter() - t0
    for r in offs + ons:
        r.pop("engine")
    if any(r["streams"] != offs[0]["streams"] for r in offs + ons):
        raise AssertionError("streams with the resilience layer on differ "
                             "from off")
    if dev.type == "cuda" and ons[0]["launches"][4] == 0:
        raise AssertionError("resilience serve: B1 never launched")
    checks = []
    for _ in range(3):
        t0 = time.perf_counter()
        payload_checksums(params)
        checks.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    PayloadGuard(params)
    guard_s = time.perf_counter() - t0
    payload_bytes = sum(leaf["codes"].numel()
                        for _, leaf in _walk_qweights(params))

    def each(runs, key):
        return [r[key] for r in runs]

    rec = {"step_ms_mean_off": each(offs, "step_ms_mean"),
           "step_ms_mean_on": each(ons, "step_ms_mean"),
           "step_ms_median_off": each(offs, "step_ms_median"),
           "step_ms_median_on": each(ons, "step_ms_median"),
           "decode_step_ms_off": each(offs, "decode_step_ms"),
           "decode_step_ms_on": each(ons, "decode_step_ms"),
           "tok_s_off": each(offs, "tok_s"), "tok_s_on": each(ons, "tok_s"),
           "steps": ons[0]["steps"], "snapshots_written_kept": ons[0][
               "snapshots"], "b1_launches_on": ons[0]["launches"][4],
           "integrity_check_s": statistics.median(checks),
           "payload_bytes": payload_bytes, "guard_build_s": guard_s,
           "snapshot_s": snapshot_s, "streams_equal": True}
    print(f"resilience serve {cfg.name} L={cfg.n_layers} ({rec['steps']} "
          f"steps, off/on/on/off): streams equal; step mean "
          f"{rec['step_ms_mean_off'][0]:.2f}/{rec['step_ms_mean_on'][0]:.2f}/"
          f"{rec['step_ms_mean_on'][1]:.2f}/{rec['step_ms_mean_off'][1]:.2f} "
          f"ms, median {rec['step_ms_median_off'][0]:.2f}/"
          f"{rec['step_ms_median_on'][0]:.2f}/"
          f"{rec['step_ms_median_on'][1]:.2f}/"
          f"{rec['step_ms_median_off'][1]:.2f} ms; integrity check "
          f"{1e3 * rec['integrity_check_s']:.1f} ms over "
          f"{payload_bytes / 1e9:.3f} GB of payload; guard build "
          f"{1e3 * guard_s:.1f} ms; snapshot {1e3 * snapshot_s:.1f} ms; B1 "
          f"{rec['b1_launches_on']} launches [{CARD}]", flush=True)
    return rec


def int8kv_phase(cfg, params, dev, *, n_req, prompt_len, new_tokens,
                 max_len, slots, chunk) -> dict:
    """``REPRO_OPTS=int8_kv`` (at CHECK_LAYERS) against the f32 cache: the
    exact prefill's int8 cache equals ``q8`` of the f32 prefill's, every
    layer, bit for bit; after the first decode step the new layer-0 rows
    equal ``q8`` of the f32 cache's new rows bit for bit (deeper layers
    read a dequantized prefix, so their rows are reported, not held);
    first-step logit difference; the serve traffic's greedy agreement,
    KV bytes and step time (f32, int8, int8, f32 in turns)."""
    import os
    from repro_torch.models import layer_kv
    from repro_torch.models.layers import q8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.long, device=dev)
    saved = os.environ.get("REPRO_OPTS")

    def first_step(opts):
        os.environ["REPRO_OPTS"] = opts
        logits, cache = prefill(cfg, params, {"tokens": toks}, max_len,
                                torch.float32)
        nxt = logits.argmax(-1, keepdim=True)
        step_logits, cache = decode_step(cfg, params, cache, nxt)
        _sync(dev)
        return logits, step_logits, cache

    try:
        l32, s32, c32 = first_step("")
        l8, s8, c8 = first_step("int8_kv")
        kw = dict(slots=slots, max_len=max_len, chunk=chunk)

        def run(opts):
            os.environ["REPRO_OPTS"] = opts
            return engine_run(cfg, params, prompts, new_tokens, dev, **kw)

        f32s, i8s = _pairs(lambda: run(""), lambda: run("int8_kv"))
        for r in f32s + i8s:
            r.pop("engine")
    finally:
        if saved is None:
            os.environ.pop("REPRO_OPTS", None)
        else:
            os.environ["REPRO_OPTS"] = saved
    f32, i8 = f32s[0], i8s[0]
    if f32s[1]["streams"] != f32["streams"] or \
            i8s[1]["streams"] != i8["streams"]:
        raise AssertionError("int8 KV: a rerun changed the streams")
    p = prompt_len
    prefix_equal = all(
        torch.equal(codes[:, :, :p], want[0])
        and torch.equal(scale[:, :, :p], want[1])
        for codes, scale, want in (
            (c8.kv.k, c8.kv.k_scale, q8(c32.kv.k[:, :, :p])),
            (c8.kv.v, c8.kv.v_scale, q8(c32.kv.v[:, :, :p]))))
    l0_8, l0_32 = layer_kv(c8.kv, 0), layer_kv(c32.kv, 0)
    new_row_equal = all(
        torch.equal(codes[:, p], q8(f[:, p])[0])
        and torch.equal(scale[:, p], q8(f[:, p])[1])
        for codes, scale, f in ((l0_8.k, l0_8.k_scale, l0_32.k),
                                (l0_8.v, l0_8.v_scale, l0_32.v)))
    deq = c8.kv.k[:, :, p].float() * c8.kv.k_scale[:, :, p]
    ref = c32.kv.k[:, :, p]
    row_rel = float((deq - ref).abs().max() / ref.abs().max())
    if not (prefix_equal and new_row_equal):
        raise AssertionError(f"int8 KV: prefill cache == q8(f32) "
                             f"{prefix_equal}, layer-0 new rows == q8(f32) "
                             f"{new_row_equal}")
    if not torch.equal(l8, l32):
        raise AssertionError("int8 KV: the prefill logits moved")
    agree = [sum(a == b for a, b in zip(f32["streams"][r],
                                        i8["streams"][r]))
             / len(f32["streams"][r]) for r in f32["streams"]]
    first_diff = float((s8 - s32).abs().max())
    rec = {"prefill_cache_equals_q8": prefix_equal,
           "first_step_layer0_rows_equal_q8": new_row_equal,
           "first_step_all_layers_k_row_max_rel": row_rel,
           "first_step_logit_max_abs_diff": first_diff,
           "first_step_logit_max_abs": float(s32.abs().max()),
           "first_step_greedy_equal": bool(torch.equal(s8.argmax(-1),
                                                       s32.argmax(-1))),
           "greedy_agreement": statistics.mean(agree),
           "streams_equal": f32["streams"] == i8["streams"],
           "kv_bytes_f32": f32["kv_bytes"], "kv_bytes_int8": i8["kv_bytes"],
           "decode_step_ms_f32": [r["decode_step_ms"] for r in f32s],
           "decode_step_ms_int8": [r["decode_step_ms"] for r in i8s],
           "tok_s_f32": [r["tok_s"] for r in f32s],
           "tok_s_int8": [r["tok_s"] for r in i8s],
           "b1_launches_int8": i8["launches"][4]}
    if dev.type == "cuda" and i8["launches"][4] == 0:
        raise AssertionError("int8 KV serve: B1 never launched")
    print(f"int8 KV {cfg.name} L={cfg.n_layers}: prefill cache == q8(f32 "
          f"cache) at every layer, layer-0 first-step rows == q8 bit for "
          f"bit (deeper K rows within {row_rel:.3e} of max); first-step "
          f"logits max |Δ| {first_diff:.4e} (max |logit| "
          f"{rec['first_step_logit_max_abs']:.3f}); greedy agreement "
          f"{rec['greedy_agreement']:.4f}; KV {rec['kv_bytes_int8']} vs "
          f"{rec['kv_bytes_f32']} bytes; decode step f32/int8/int8/f32 "
          f"{f32s[0]['decode_step_ms']:.2f}/{i8s[0]['decode_step_ms']:.2f}/"
          f"{i8s[1]['decode_step_ms']:.2f}/{f32s[1]['decode_step_ms']:.2f} "
          f"ms [{CARD}]", flush=True)
    return rec


def degrade_phase(cfg, dev) -> dict:
    """The int4 → int3 → int2 ladder at full width cut to 4 layers under a
    queue that crosses the high watermark (12 requests on 2 slots, high 4,
    low 1): every request completes; the rung trace, and the step time
    and launches at each rung."""
    from repro_torch.serve import DegradePolicy, build_bit_ladder
    short = dataclasses.replace(cfg, n_layers=4)
    base = init_params(short, 0, device=dev)
    ladder = build_bit_ladder(base, (4, 3, 2))
    del base
    eng = ContinuousEngine(short, ladder[0][1], config=EngineConfig(
        n_slots=2, max_len=32, cache_dtype=torch.float32, prefill_chunk=16,
        resilience=ResilienceConfig(degrade=DegradePolicy(
            ladder=ladder, high_watermark=4, low_watermark=1, streak=1,
            cooldown_steps=2))))
    rng = np.random.default_rng(0)
    for i in range(12):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, short.vocab, 16).astype(np.int32), max_new_tokens=8))
    reset_launches()
    by_rung, done = {}, []
    while eng.queue or eng.active_slots:
        before = dict(LAUNCHES)
        done += eng.step()
        name = ladder[eng._rung][0]
        rec = by_rung.setdefault(name, {"steps": 0, "step_s": [],
                                        "launches": {}})
        rec["steps"] += 1
        rec["step_s"].append(eng.step_stats[-1].step_s)
        for nb, n in LAUNCHES.items():
            if n - before[nb]:
                rec["launches"][nb] = rec["launches"].get(nb, 0) \
                    + n - before[nb]
    if len(done) != 12 or eng.dropped:
        raise AssertionError(f"degrade: {len(done)} of 12 finished, "
                             f"{len(eng.dropped)} dropped")
    if dev.type == "cuda" and not all(LAUNCHES[nb] for nb in (4, 3, 2)):
        raise AssertionError(f"degrade: a rung's kernel never launched "
                             f"{dict(LAUNCHES)}")
    rungs = [[t, n, d] for t, n, d in eng.rung_history]
    out = {"rungs": rungs, "finished": len(done), "launches": dict(LAUNCHES),
           "by_rung": {k: {"steps": v["steps"], "launches": v["launches"],
                           "step_ms_median": 1e3 * statistics.median(
                               v["step_s"])}
                       for k, v in by_rung.items()}}
    print(f"degrade {short.name} L=4: rungs "
          + " -> ".join(f"{n}@{t}({d})" for t, n, d in rungs)
          + "; step ms median by rung "
          + ", ".join(f"{k} {v['step_ms_median']:.2f} ({v['steps']} steps)"
                      for k, v in out["by_rung"].items())
          + f" [{CARD}]", flush=True)
    return out


class RuleThreshold:
    """A ``sigma_fro`` detector whose limit is fixed between phases: while
    ``box["limit"]`` is None it records the largest shift it sees (the
    clean phase's) and never fires; then it fires above the limit."""

    def __init__(self, box):
        self.box = box
        self.n = 0

    def update(self, x) -> bool:
        self.n += 1
        x = float(x)
        if self.box["limit"] is None:
            self.box["peak"] = max(self.box["peak"], x)
            return False
        return x > self.box["limit"]


def requant_full_phase(cfg, dev, *, n_layers=2, sigma_every=4) -> dict:
    """One requant actuation at full width cut to ``n_layers`` layers: a
    4.0-bit output-weighted plan from 64 calibration tokens served by
    ``engine_from_plan``; clean traffic, then the limit is fixed at 1.5×
    the clean phase's largest Frobenius shift, then repeated-token
    traffic until the actuator fires (once), then one step that lands and
    serves the swapped tree; the drift traffic is not run to its end.
    The re-plan quantizes as the reference's does (WaterSIC with LMMSE,
    whose column loop is no kernel; B4 is reported, not required).
    Reports both values, the actuation's wall time and its re-planned
    matrices, and the B1/B2 launches of the clean phase and of the
    swapped step."""
    short = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(short, 0, device=dev)
    rng = np.random.default_rng(9)
    plen, budget = 8, 8
    calib = [rng.integers(0, short.vocab, (2, 16)).astype(np.int32)
             for _ in range(2)]
    t0 = time.perf_counter()
    sens = model_sensitivities(short, params, calib, weighting="output")
    plan = build_plan(sens, 4.0, weighting="output")
    acc = collect_sigma_x(short, params, calib)
    build_s = time.perf_counter() - t0
    box = {"limit": None, "peak": 0.0}
    mats = matrix_tap_map(short, params)
    dets = sigma_threshold_detectors(mats, limit=math.inf)
    for rec in mats:
        dets[f"sigma_fro:L{rec['layer']}/{rec['tap']}"] = \
            lambda: RuleThreshold(box)
    qcfg = QualityConfig(sigma_every=sigma_every, probe_every=10_000,
                         slo_every=10_000, detectors=dets)
    with obs.scoped(enable_obs=True):
        eng = engine_from_plan(
            short, params, plan, calib=acc, sensitivities=sens,
            quality_config=qcfg, config=EngineConfig(
                n_slots=2, max_len=plen + budget + 2,
                cache_dtype=torch.float32,
                requant=RequantConfig(min_samples=8, cooldown_steps=8,
                                      max_actuations=1)))
        formats = dict(eng.weight_formats)
        reset_launches()
        for i in range(4):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, short.vocab, plen).astype(np.int32), max_new_tokens=budget))
        t0 = time.perf_counter()
        eng.run_until_done()
        clean_s = time.perf_counter() - t0
        serve_launches = dict(LAUNCHES)
        box["limit"] = 1.5 * box["peak"]
        reset_zsic_launches()
        for i in range(8):
            eng.submit(Request(rid=100 + i, prompt=np.full(plen, 7, np.int32),
                               max_new_tokens=budget))
        t0 = time.perf_counter()
        while (eng.queue or eng.active_slots) and not eng.requant.actuations:
            eng.step()
        zsic = zsic_block_cuda.launches
        reset_launches()
        eng.step()                  # the staged tree lands at this boundary
        swap_launches = dict(LAUNCHES)
        drift_s = time.perf_counter() - t0
    acts = eng.requant.actuations
    if len(acts) != 1:
        raise AssertionError(f"full-width requant: {len(acts)} actuations "
                             f"(clean peak {box['peak']:.4f}, limit "
                             f"{box['limit']:.4f})")
    a = acts[0]
    swapped = [why for _, why in eng.swap_history] == ["requant"]
    if not swapped or (dev.type == "cuda" and (
            serve_launches[4] == 0 or sum(swap_launches.values()) == 0)):
        raise AssertionError(f"full-width requant: swaps "
                             f"{eng.swap_history}, launches clean "
                             f"{serve_launches} swapped step "
                             f"{swap_launches}")
    ratios = {n: a["plan_after"].entry(n).realized_distortion
              / a["plan_after"].entry(n).pred_distortion
              for n in a["matrices"]
              if a["plan_after"].entry(n).realized_distortion
              and a["plan_after"].entry(n).pred_distortion}
    moved = {n: [a["payload_before"][n], a["payload_after"][n]]
             for n in a["matrices"]
             if a["payload_before"][n] != a["payload_after"][n]}
    out = {"clean_peak_fro_shift": box["peak"], "limit": box["limit"],
           "tick": a["tick"], "taps": a["taps"], "matrices": a["matrices"],
           "sigma_n": a["sigma_n"], "moved": moved,
           "realized_over_pred": ratios, "actuation_wall_s": a["wall_s"],
           "executor_wall_s": a["executor_wall_s"], "zsic_launches": zsic,
           "serve_launches": serve_launches,
           "swapped_step_launches": swap_launches, "formats_before": formats,
           "formats_after": dict(eng.weight_formats),
           "plan_build_s": build_s, "clean_s": clean_s,
           "drift_s": drift_s, "finished": len(eng.finished)}
    print(f"requant {short.name} L={n_layers} full width: clean peak shift "
          f"{box['peak']:.4f} -> limit {box['limit']:.4f}; actuated at tick "
          f"{a['tick']} on taps {a['taps']} ({len(a['matrices'])} matrices, "
          f"moved {moved or 'none'}); actuation {a['wall_s']:.3f} s "
          f"(executor {a['executor_wall_s']:.3f} s, {zsic} B4 launches); "
          f"swapped step launches {swap_launches}; realized/predicted "
          f"{ratios}; clean {clean_s:.1f} s, drift {drift_s:.1f} s "
          f"[{CARD}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# the MoE family: phi3.5-moe-42b-a6.6b at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
#: depth of the MoE serve and prefill cells: the serving tree keeps the
#: stacked (L, E, d, ff) experts f32, as the reference's does (3 × 16 ×
#: 4096 × 6400 × 4 B = 5.03 GB a layer), so 8 of 32 layers fit one card
MOE_LAYERS = 4
#: packed leaves of a MoE layer at --wbits 4: wq, wk, wv, wo
MOE_PER_LAYER = 4
#: the MoE plan phase's budget, bits per parameter
MOE_PLAN_BITS = 4.0


def _moe_kw(cfg):
    return dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                activation=cfg.activation)


def _layer0(node):
    """Layer 0 of a stacked tree, as views."""
    if isinstance(node, dict):
        return {k: _layer0(v) for k, v in node.items()}
    return node[0]


def moe_prompts(cfg, n_req, prompt_len):
    """The prompts ``serve_tree`` serves (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
            for _ in range(n_req)]


def moe_serve_phase(dev, gen, *, n_req, prompt_len, new_tokens, max_len,
                    slots, chunk) -> dict:
    """phi3.5-moe at full width cut to MOE_LAYERS layers, attention packed
    int4 (B1), stacked experts f32: first-step logits against the
    dequantized-weight model, the serve cell's traffic on the continuous
    engine (B1 MOE_PER_LAYER × layers times per decode step), the step's
    breakdown and its CUDA graph (one kernel per packed dense); a rerun of
    the continuous engine with equal streams, two ``moe`` calls with
    equal bits, the static engine's streams (equality with the continuous
    engine's reported only: capacity couples the rows of a step, and the
    engines batch different rows); one decode step of an int8-attention
    copy through B2; then the expert-code and prefill cells on the same
    weights."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    torch.empty(1, device=dev)          # the allocator exists before reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    formats = leaf_format_histogram(params)
    experts = params["layers"]["moe"]
    if formats.get("packed-int4") != MOE_PER_LAYER or any(
            is_qweight(experts[k]) for k in ("w_gate", "w_up", "w_out")) \
            or is_qweight(experts["router"]["w"]):
        raise AssertionError(f"MoE serving tree formats {formats}: expected "
                             "packed attention, f32 router and experts")
    traffic = dict(n_req=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
                   max_len=max_len, slots=slots, chunk=chunk)
    rec = serve_tree(cfg, params, dequantized_model, "int4 attention", dev,
                     per_layer=MOE_PER_LAYER, **traffic)
    rec.update(init_s=init_s, formats=formats,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    rec.update(step_breakdown(cfg, params, dev, slots, max_len, ()))
    prompts = moe_prompts(cfg, n_req, prompt_len)
    rerun = engine_run(cfg, params, prompts, new_tokens, dev, slots=slots,
                       max_len=max_len, chunk=chunk)
    if rerun["streams"] != rec["streams"]:
        raise AssertionError("MoE serve: a rerun of the continuous engine "
                             "gave other streams")
    rec["rerun_step_ms_median"] = rerun["step_ms_median"]
    static = static_streams(cfg, params, prompts, new_tokens, slots=slots,
                            max_len=max_len, chunk=chunk)
    rec["static_equals_continuous"] = static == rec["streams"]
    rec["static_continuous_tokens_equal"] = sum(
        a == b for rid in static for a, b in zip(static[rid],
                                                 rec["streams"][rid]))
    layer = _layer0(params["layers"]["moe"])
    layer_ms = {}
    for s_len in (1, prompt_len):
        x = torch.randn((slots, s_len, cfg.d_model), generator=gen,
                        device=dev)
        a = moe(layer, x, **_moe_kw(cfg))
        b = moe(layer, x, **_moe_kw(cfg))
        if not torch.equal(a, b):
            raise AssertionError(f"MoE layer at {slots} x {s_len} tokens: "
                                 "two runs differ")
        layer_ms[s_len] = device_ms(lambda: moe(layer, x, **_moe_kw(cfg)),
                                    dev, reps=5)
    rec["moe_layer_ms"] = layer_ms
    # int8 attention (B2): the dequantized attention requantized to int8
    deq = dequantized_model(params)
    int8 = quantize_params_tree(deq)
    del deq
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    reset_launches()
    got, _ = decode_step(cfg, int8, init_cache(cfg, n_req, max_len,
                                               torch.float32, device=dev),
                         tok)
    torch.cuda.synchronize(dev)
    int8_launches = {nb: c for nb, c in LAUNCHES.items() if c}
    want, _ = decode_step(cfg, dequantized_model(int8), init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    scale = float(want.abs().max())
    rec["int8_step"] = {
        "launches": int8_launches,
        "logit_rel_err": check(got, want, "MoE int8 first-step logits",
                               atol=LOGIT_TOL * scale, rtol=0.0) / scale}
    if int8_launches != {8: MOE_PER_LAYER * cfg.n_layers}:
        raise AssertionError(f"MoE int8 decode step launches {int8_launches}")
    del int8
    torch.cuda.empty_cache()
    busy = rec.get("device_busy_ms_per_step")
    print(f"moe serve {cfg.name} L={cfg.n_layers}: {rec['tokens']} tokens "
          f"{rec['tokens_per_s']:.2f} tok/s, decode step "
          f"{rec['decode_step_ms']:.3f} ms (engine), step wall "
          f"{rec['decode_step_wall_ms']:.3f} ms, traced step "
          f"{rec['traced_step_wall_ms']:.3f} ms, device busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms, idle share {rec['device_idle_share']:.4f}")
          + f"; B1 {rec['launches']} ({rec['graph_packed_kernels_per_step']} "
          f"in a CUDA graph of one step, {rec['graph_kernels_per_step']} "
          f"kernels in all); rerun equal; static == continuous "
          f"{rec['static_equals_continuous']} "
          f"({rec['static_continuous_tokens_equal']} of {rec['tokens']} "
          f"tokens); moe layer ms {layer_ms}, equal bits; int8 step B2 "
          f"{int8_launches}; init {init_s:.1f} s, peak "
          f"{rec['peak_memory_gb']:.1f} GB [{CARD}]", flush=True)
    rec["codes"] = moe_codes_phase(cfg, layer, dev, gen, slots=slots,
                                   prompt_len=prompt_len)
    rec["router"] = moe_router_phase(dev, gen, slots=slots,
                                     prompt_len=prompt_len)
    nodrop = dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts // cfg.top_k))
    rec["prefill_no_drop"] = prefill_phase(nodrop, params, "moe int4 cf 8",
                                           dev, n_req=n_req,
                                           prompt_len=prompt_len,
                                           max_len=max_len)
    rec["prefill_config_factor"] = prefill_phase(
        cfg, params, "moe int4 cf 1.25 (reported)", dev, n_req=n_req,
        prompt_len=prompt_len, max_len=max_len, strict=False)
    return rec


def moe_codes_phase(cfg, layer, dev, gen, *, slots, prompt_len) -> dict:
    """One unstacked phi3.5-moe layer (experts (16, 4096, 6400)) through
    ``quantize_params_tree`` as int8 and as packed int4 (the router stays
    f32): ``moe`` on the card against the same layer with dequantized
    experts (KERNEL_TOL), twice with equal bits, and its time."""
    x = torch.randn((slots, prompt_len, cfg.d_model), generator=gen,
                    device=dev)
    rec = {"f32_ms": device_ms(lambda: moe(layer, x, **_moe_kw(cfg)), dev,
                               reps=5)}
    for label, kw in (("int8", dict(nbits=8)),
                      ("int4", dict(nbits=4, packed=True))):
        q = quantize_params_tree(layer, **kw)
        fmt = leaf_format_histogram(q)
        if is_qweight(q["router"]["w"]) or not all(
                is_qweight(q[k]) for k in ("w_gate", "w_up", "w_out")):
            raise AssertionError(f"MoE {label} expert leaves: {fmt}")
        got = moe(q, x, **_moe_kw(cfg))
        if not torch.equal(got, moe(q, x, **_moe_kw(cfg))):
            raise AssertionError(f"MoE {label} experts: two runs differ")
        deq = dequantized_model(q)
        want = moe(deq, x, **_moe_kw(cfg))
        del deq
        err = check(got, want, f"MoE {label} experts vs dequantized",
                    atol=KERNEL_TOL, rtol=KERNEL_TOL)
        rec[label] = {"max_abs_err": err, "formats": fmt,
                      "weight_bytes": qweight_bytes(q)[0],
                      "ms": device_ms(lambda: moe(q, x, **_moe_kw(cfg)), dev,
                                      reps=5)}
        del q
        torch.cuda.empty_cache()
    print(f"moe expert codes ({cfg.n_experts}, {cfg.d_model}, {cfg.d_ff}) "
          f"at {slots} x {prompt_len} tokens: int8 max |Δ| "
          f"{rec['int8']['max_abs_err']:.3e} ({rec['int8']['ms']:.3f} ms), "
          f"int4 max |Δ| {rec['int4']['max_abs_err']:.3e} "
          f"({rec['int4']['ms']:.3f} ms), f32 experts {rec['f32_ms']:.3f} ms;"
          f" equal bits on reruns [{CARD}]", flush=True)
    return rec


def moe_router_phase(dev, gen, *, slots, prompt_len) -> dict:
    """One full-width moonshot-v1-16b-a3b layer (64 experts, top-6) with
    every eligible leaf packed int4: its (2048, 64) router passes min_dim,
    so ``moe`` computes the logits through B1 (one launch per call; the
    reference's ``moe`` raises on that leaf).  Held against the same layer
    with the router and experts dequantized (KERNEL_TOL)."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1)
    layer = _layer0(init_params(cfg, 0, device=dev)["layers"]["moe"])
    q = quantize_params_tree(layer, nbits=4, packed=True)
    if not is_qweight(q["router"]["w"]):
        raise AssertionError("moonshot's router was not quantized")
    x = torch.randn((slots, prompt_len, cfg.d_model), generator=gen,
                    device=dev)
    reset_launches()
    got = moe(q, x, **_moe_kw(cfg))
    torch.cuda.synchronize(dev)
    launches = {nb: c for nb, c in LAUNCHES.items() if c}
    if launches != {4: 1}:
        raise AssertionError(f"quantized router: launches {launches}")
    deq = dequantized_model(q)
    err = check(got, moe(deq, x, **_moe_kw(cfg)),
                "moonshot layer with a packed router vs dequantized",
                atol=KERNEL_TOL, rtol=KERNEL_TOL)
    print(f"moe router {cfg.name}: ({cfg.d_model}, {cfg.n_experts}) router "
          f"packed int4 through B1 {launches}, top-{cfg.top_k} layer max "
          f"|Δ| {err:.3e} against the dequantized layer [{CARD}]",
          flush=True)
    return {"launches": launches, "max_abs_err": err}


def moe_ptq_phase(dev) -> dict:
    """``quantize_model`` (hptq, 3 bits, the ZSIC kernel) of phi3.5-moe at
    full width cut to 1 layer, calibration 2 × 4 × 128 tokens: 4 attention
    and 3 × 16 expert matrices, realized rate within 0.05, B4 launches,
    ``model_ppl`` of the written-back tree finite.  Each expert's Σ_X
    comes from the tokens routed to it (about 128 of 1024 pairs' worth
    against d 4096: rank deficient, reported)."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
             for _ in range(2)]
    evalb = [rng.integers(0, cfg.vocab, (4, 257)).astype(np.int32)]
    routed = torch.zeros(cfg.n_experts, dtype=torch.float64)
    for tokens in calib:
        _, taps = forward_with_taps(cfg, params, tokens)
        routed += taps[0]["expert_occ"].sum(-1).to(torch.float64).cpu()
        del taps
    reset_zsic_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    qp, qlin, budget, rows = quantize_model(
        cfg, params, calib, PTQConfig(target_bits=3.0, method="hptq"))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = zsic_block_cuda.launches
    rate = budget.realized_rate
    want_rows = 4 + 3 * cfg.n_experts
    if len(rows) != want_rows or abs(rate - 3.0) > 0.05 or launches == 0:
        raise AssertionError(f"MoE PTQ: {len(rows)} rows (expected "
                             f"{want_rows}), realized rate {rate}, "
                             f"{launches} B4 launches")
    ppl = {"float": model_ppl(cfg, params, evalb),
           "hptq": model_ppl(cfg, qp, evalb)}
    if not all(math.isfinite(v) for v in ppl.values()):
        raise AssertionError(f"MoE PTQ model_ppl {ppl}")
    rec = {"rows": len(rows), "realized_rate": rate, "wall_s": wall,
           "s_per_matrix": wall / len(rows), "zsic_launches": launches,
           "ppl": ppl, "routed_tokens_per_expert": routed.tolist(),
           "sigma_rank_bound_max": float(routed.max()),
           "d_model": cfg.d_model, "d_ff": cfg.d_ff}
    print(f"moe ptq {cfg.name} L=1 hptq 3 bits: {len(rows)} matrices in "
          f"{wall:.2f} s ({rec['s_per_matrix']:.3f} s/matrix), realized "
          f"{rate:.4f} bits, {launches} B4 launches, ppl float "
          f"{ppl['float']:.2f} hptq {ppl['hptq']:.2f}; routed tokens per "
          f"expert {int(routed.min())}..{int(routed.max())} against d "
          f"{cfg.d_model} / ff {cfg.d_ff}: each expert's Σ_X is rank "
          f"deficient [{CARD}]", flush=True)
    return rec


def moe_plan_phase(dev, out) -> dict:
    """``launch.plan build`` of phi3.5-moe at full width cut to 1 layer
    (52 matrices, ``output`` weighting, MOE_PLAN_BITS, the PTQ phase's
    calibration shape), then the plan executed through B4 (WaterSIC
    spacing without LMMSE): realized bits within 0.05 of planned;
    ``probe`` weighting refused."""
    path = str(out / "moe_plan.json")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plan = launch_plan.main([
        "build", "--arch", MOE_ARCH, "--n-layers", "1", "--seed", "0",
        "--target-bits", str(MOE_PLAN_BITS), "--weighting", "output",
        "--calib-batches", "2", "--seq-len", "128", "--global-batch", "4",
        "--out", path])
    torch.cuda.synchronize(dev)
    rec = {"build_s": time.perf_counter() - t0, "entries": len(plan.entries),
           "payloads": plan.payload_histogram()}
    if rec["entries"] != 52:
        raise AssertionError(f"MoE plan holds {rec['entries']} entries")
    cfg, params, calib = launch_plan.model_from_provenance(plan.provenance,
                                                           dev)
    try:
        model_sensitivities(cfg, params, calib, weighting="probe")
    except ValueError:
        pass
    else:
        raise AssertionError("probe weighting on a MoE model did not raise")
    weights, stats = plan_inputs_for_model(cfg, params, calib)
    _, rec["executed"] = execute(plan, weights, stats, dev, 1)
    if rec["executed"]["zsic_launches"] == 0:
        raise AssertionError("MoE plan execution ran no B4 launch")
    r = rec["executed"]
    print(f"moe plan {cfg.name} L=1 at {MOE_PLAN_BITS} bits: build "
          f"{rec['build_s']:.1f} s, payloads {rec['payloads']}; executed "
          f"in {r['wall_s']:.2f} s, {r['zsic_launches']} B4 launches, "
          f"realized {r['realized_bits']:.4f} of {r['planned_bits']:.4f} "
          f"bits; probe refused [{CARD}]", flush=True)
    return rec


def shared_moe_plan(dev, out) -> dict:
    with shared_plan_model():
        return moe_plan_phase(dev, out)


def moe_phases(dev, out, gen) -> dict:
    """The MoE cells, in order: serve (with expert codes and prefill),
    PTQ, plan; each one's wall time."""
    rec, took = {}, {}
    for name, fn in (
            ("serve", lambda: moe_serve_phase(
                dev, gen, n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                slots=8, chunk=16)),
            ("ptq", lambda: moe_ptq_phase(dev)),
            ("plan", lambda: shared_moe_plan(dev, out))):
        t0 = time.perf_counter()
        rec[name] = fn()
        torch.cuda.empty_cache()
        took[name] = time.perf_counter() - t0
    rec["phase_s"] = took
    print("moe phases (s): " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in took.items())
          + f" [{CARD}]", flush=True)
    return rec


# ---------------------------------------------------------------------------
# the recurrent families: rwkv6-7b (ssm) and recurrentgemma-2b (hybrid)
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
RG_ARCH = "recurrentgemma-2b"
#: packed denses one layer runs per decode step: RWKV6's w_r w_k w_v w_g
#: w_o decay_a decay_b and channel-mix w_k w_v w_r; a recurrentgemma
#: layer's w_in w_a w_x w_out (recurrent) or wq wk wv wo (attention) and
#: its 3 MLP denses
RECURRENT_PER_LAYER = {RWKV_ARCH: 10, RG_ARCH: 7}
#: whether a family's full-depth first step and prefill are held end to
#: end at LOGIT_TOL: rwkv6-7b's random 32 layers amplify f32 rounding
#: past it (``rounding_amplification`` must show so, or the run fails),
#: so it is held layer by layer only
RECURRENT_END_TO_END = {RWKV_ARCH: False, RG_ARCH: True}
#: the (k, n) of every dense of the two families at full width
RECURRENT_SHAPES = {
    RWKV_ARCH: [(4096, 4096), (4096, 64), (64, 4096), (4096, 14336),
                (14336, 4096)],
    RG_ARCH: [(2560, 5120), (2560, 2560), (2560, 256), (2560, 7680),
              (7680, 2560)]}
#: the windowed hybrid: recurrentgemma at full width, one group and the
#: 2-layer tail, a 16-token window that 32-token prompts wrap
RG_WINDOW_LAYERS = 5
RG_WINDOW = 16


def recurrent_kernel_phase(dev, gen, flush) -> dict:
    """B1 (packed int4) and B2 against their twins at every (k, n) of the
    two families, m = 8 (the 8-slot decode batch), each run twice with
    equal bits, with the kernel, twin and ``F.linear`` times and the bound
    by the kernel phase's formulas: {(k, n): {"int4": case, "int8":
    case}}."""
    cases = {}
    for arch, shapes in RECURRENT_SHAPES.items():
        for k, n in shapes:
            c4 = kernel_case(4, 8, k, n, dev, gen, flush)
            c8 = int8_case(8, k, n, "kn", dev, gen, flush, timed=True)
            cases[(k, n)] = {"arch": arch, "int4": c4, "int8": c8}
            print(f"recurrent kernels {arch} m=8 k={k} n={n}: B1 int4 ms="
                  f"{c4['ms']:.5f} plain_ms={c4['plain_ms']:.5f} library_ms="
                  f"{c4['library_ms']:.5f} bound_ms={c4['bound_ms']:.5f} "
                  f"({c4['bound_by']}) err={c4['max_abs_err']:.3e}; B2 ms="
                  f"{c8['ms']:.5f} plain_ms={c8['plain_ms']:.5f} library_ms="
                  f"{c8['library_ms']:.5f} bound_ms={c8['bound_ms']:.5f} "
                  f"({c8['bound_by']}) err={c8['max_abs_err']:.3e} [{CARD}]",
                  flush=True)
    return cases


def kernel_ms_per_step(params, kcases, fmt):
    """Device time of one decode step's dequant launches from the kernel
    cases (m = 8): each quantized leaf's (k, n) case once per layer."""
    total = 0.0

    def walk(node):
        nonlocal total
        if is_qweight(node):
            k, n = node["s"].shape[-1], node["t"].shape[-1]
            total += _stacked(node) * kcases[(k, n)][fmt]["ms"]
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(params)
    return total


def scan_times(cfg, dev, slots, prompt_len) -> dict:
    """Device time (CUDA events, median) of the recurrences that run as
    plain PyTorch ops, the reference's XLA programs with no compiled
    counterpart here, at full width: per decode step (``slots`` rows) and
    per parallel prefill of ``prompt_len`` tokens, over the model's
    recurrent layers.  RWKV6: the WKV update of ``rwkv_time_mix_decode``
    and the time loop of ``rwkv_time_mix_train``; RG-LRU: the h update of
    ``rglru_decode`` and the doubling scan of ``rglru_train``."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    if cfg.family == "ssm":
        hd = cfg.wkv_head_dim
        h = cfg.d_model // hd
        n_rec = cfg.n_layers
        r, k, v = rnd(slots, h, hd), rnd(slots, h, hd), rnd(slots, h, hd)
        w = torch.rand((slots, h, hd), generator=g, device=dev)
        u, state = rnd(h, hd), rnd(slots, h, hd, hd)
        seq = [rnd(slots, prompt_len, h, hd) for _ in range(3)]
        wseq = torch.rand((slots, prompt_len, h, hd), generator=g,
                          device=dev)

        def decode():
            out, kv = rk._wkv_out(r, k, v, state, u)
            return out, w[..., None] * state + kv

        def train():
            st = torch.zeros_like(state)
            outs = []
            for t in range(prompt_len):
                out, kv = rk._wkv_out(seq[0][:, t], seq[1][:, t],
                                      seq[2][:, t], st, u)
                st = wseq[:, t, ..., None] * st + kv
                outs.append(out)
            return torch.stack(outs, dim=1), st
    else:
        lru = cfg.lru_width or cfg.d_model
        n_rec = sum(1 for t in cfg._layer_types() if t != "attn")
        a = torch.rand((slots, lru), generator=g, device=dev)
        gx, hst = rnd(slots, lru), rnd(slots, lru)
        a_s = torch.rand((slots, prompt_len, lru), generator=g, device=dev)
        gx_s = rnd(slots, prompt_len, lru)

        def decode():
            return a * hst + gx

        def train():
            return rg._linear_scan(a_s, gx_s)
    dec = device_ms(decode, dev, reps=10)
    tr = device_ms(train, dev, reps=5)
    return {"recurrent_layers": n_rec, "decode_ms_per_layer": dec,
            "decode_ms_per_step": dec * n_rec,
            "prefill_ms_per_layer": tr, "prefill_ms": tr * n_rec}


def _with_opts(value, fn):
    """``fn()`` with ``REPRO_OPTS`` set to ``value`` (restored after)."""
    old = os.environ.get("REPRO_OPTS")
    os.environ["REPRO_OPTS"] = value
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("REPRO_OPTS", None)
        else:
            os.environ["REPRO_OPTS"] = old


def recurrent_prefill_phase(cfg, params, label, dev, *, n_req, prompt_len,
                            max_len, end_to_end=False) -> dict:
    """``prefill`` of ``n_req`` prompts stepped (``decode_chunk``, the
    reference's baseline) and parallel (``REPRO_OPTS=parallel_prefill``),
    both timed; each dequant kernel once per layer of each of its leaves
    in the parallel pass (m = B·S), ``prompt_len`` times in the stepped
    one.  The two forms are held to each other layer by layer
    (``layerwise_prefill_check``); the end-to-end last logits, every state
    leaf and the next step's logits are reported, and held within
    LOGIT_TOL of the largest value with ``end_to_end`` (a depth that does
    not amplify rounding past it)."""
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (n_req, prompt_len)),
                           device=dev)
    split = split_layers(params)
    per_step = launches_per_step(params)
    runs = {}
    for mode, opts in (("stepped", ""), ("parallel", "parallel_prefill")):
        def run():
            prefill(cfg, split, {"tokens": toks[:, :2]}, max_len,
                    torch.float32)
            _sync(dev)
            reset_launches()
            t0 = time.perf_counter()
            out = prefill(cfg, split, {"tokens": toks}, max_len,
                          torch.float32)
            _sync(dev)
            return out, time.perf_counter() - t0
        (logits, cache), wall = _with_opts(opts, run)
        launches = {nb: c for nb, c in LAUNCHES.items() if c}
        times = prompt_len if mode == "stepped" else 1
        # stepped: decode steps of n_req rows; parallel: n_req · S rows
        tc = check_tc(dev, f"prefill {label} {mode}", n_req * (
            1 if mode == "stepped" else prompt_len), launches)
        if dev.type == "cuda" and launches != {
                nb: c * times for nb, c in per_step.items()}:
            raise AssertionError(f"prefill {label} {mode}: dequant launches "
                                 f"{launches}, expected {per_step} x {times}")
        if int(cache.pos) != prompt_len or logits.shape != (n_req,
                                                            cfg.vocab):
            raise AssertionError(f"prefill {label} {mode}: pos "
                                 f"{int(cache.pos)}, logits "
                                 f"{tuple(logits.shape)}")
        runs[mode] = (logits, cache, wall, launches)
    parallel_tc = tc
    (lg_s, c_s, wall_s, _), (lg_p, c_p, wall_p, launches) = \
        runs["stepped"], runs["parallel"]
    layer_err = layerwise_prefill_check(cfg, params, toks, dev, max_len,
                                        f"prefill {label} parallel vs "
                                        "stepped")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (n_req, 1)), device=dev)
    n_s, _ = decode_step(cfg, split, c_s, nxt)
    n_p, _ = decode_step(cfg, split, c_p, nxt)
    pairs = [(f"state{i}", a, b) for i, (a, b) in enumerate(zip(
        tree_leaves(c_p.kv), tree_leaves(c_s.kv)))]
    pairs += [("logits", lg_p, lg_s), ("next_logits", n_p, n_s)]
    errs = {}
    for name, got, ref in pairs:
        if end_to_end:
            errs[name] = _rel_check(got, ref, f"prefill {label} parallel "
                                    f"{name} vs stepped")
        else:
            errs[name] = float((got - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-30)
    rec = {"format": label, "batch": n_req, "prompt_len": prompt_len,
           "stepped_ms": 1e3 * wall_s, "parallel_ms": 1e3 * wall_p,
           "tc_launches": parallel_tc,
           "parallel_launches": launches, "layerwise_rel_err": layer_err,
           "end_to_end_held": end_to_end, "end_to_end_rel_err": errs,
           "max_end_to_end_rel_err": max(errs.values()),
           "greedy_equal": float((lg_p.argmax(-1) == lg_s.argmax(-1))
                                 .float().mean())}
    print(f"prefill {cfg.name} L={cfg.n_layers} {label}: {n_req} x "
          f"{prompt_len} tokens parallel {rec['parallel_ms']:.2f} ms, stepped "
          f"{rec['stepped_ms']:.2f} ms; parallel launches {launches}; "
          f"parallel vs stepped layer by layer max rel err "
          f"{layer_err:.3e}; end to end ("
          + ("held" if end_to_end else "reported")
          + f") max rel err {rec['max_end_to_end_rel_err']:.3e} over "
          f"{len(pairs) - 2} state leaves, last and next logits, greedy "
          f"equal {rec['greedy_equal']:.3f} [{CARD}]", flush=True)
    return rec


def recurrent_serve_phase(arch, dev, kcases, *, n_req, prompt_len,
                          new_tokens, max_len, slots, chunk) -> dict:
    """One recurrent family at full width and depth, packed int4 (B1 on
    every dense): init time and peak memory; first-step logits against
    the dequantized-weight model and the serve traffic on the continuous
    engine (B1 RECURRENT_PER_LAYER × layers per decode step); the step's
    breakdown (one B1 node per packed dense in its CUDA graph) with B1's
    and the recurrences' device time per step; a rerun and the static
    engine with equal streams; one decode step of an int8 copy through
    B2; the stepped and parallel prefill."""
    cfg = get_config(arch)
    per_layer = RECURRENT_PER_LAYER[arch]
    end_to_end = RECURRENT_END_TO_END[arch]
    torch.empty(1, device=dev)          # the allocator exists before reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    formats = leaf_format_histogram(params)
    traffic = dict(n_req=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
                   max_len=max_len, slots=slots, chunk=chunk)
    rec = serve_tree(cfg, params, dequantized_model, "int4", dev,
                     per_layer=per_layer, layerwise=True,
                     end_to_end=end_to_end, **traffic)
    rec.update(init_s=init_s, formats=formats,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    rec.update(step_breakdown(cfg, params, dev, slots, max_len, ()))
    rec["b1_ms_per_step"] = kernel_ms_per_step(params, kcases, "int4")
    rec["scan"] = scan_times(cfg, dev, slots, prompt_len)
    prompts = moe_prompts(cfg, n_req, prompt_len)
    rerun = engine_run(cfg, params, prompts, new_tokens, dev, slots=slots,
                       max_len=max_len, chunk=chunk)
    if rerun["streams"] != rec["streams"]:
        raise AssertionError(f"{arch}: a rerun of the continuous engine gave "
                             "other streams")
    rec["rerun_step_ms_median"] = rerun["step_ms_median"]
    static = static_streams(cfg, params, prompts, new_tokens, slots=slots,
                            max_len=max_len, chunk=chunk)
    if static != rec["streams"]:
        raise AssertionError(f"{arch}: ServeEngine's streams differ from "
                             "ContinuousEngine's")
    # int8 (B2): the dequantized model requantized to int8 codes
    deq = dequantized_model(params)
    int8 = quantize_params_tree(deq)
    del deq
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    reset_launches()
    got, _ = decode_step(cfg, int8, init_cache(cfg, n_req, max_len,
                                               torch.float32, device=dev),
                         tok)
    torch.cuda.synchronize(dev)
    int8_launches = {nb: c for nb, c in LAUNCHES.items() if c}
    if int8_launches != {8: per_layer * cfg.n_layers}:
        raise AssertionError(f"{arch} int8 decode step launches "
                             f"{int8_launches}")
    oracle = dequantized_model(int8)
    want, _ = decode_step(cfg, oracle, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    scale = float(want.abs().max())
    rec["int8_step"] = {
        "launches": int8_launches,
        "b2_ms_per_step": kernel_ms_per_step(int8, kcases, "int8"),
        "logit_rel_err": layerwise_decode_check(
            cfg, int8, oracle, tok, dev, max_len, f"{arch} int8 first step"),
        "end_to_end_held": end_to_end,
        "end_to_end_rel_err": (check(
            got, want, f"{arch} int8 first-step logits",
            atol=LOGIT_TOL * scale, rtol=0.0) if end_to_end
            else float((got - want).abs().max())) / scale}
    del oracle
    del int8
    torch.cuda.empty_cache()
    rec["prefill"] = recurrent_prefill_phase(
        cfg, params, "int4", dev, n_req=n_req, prompt_len=prompt_len,
        max_len=max_len, end_to_end=end_to_end)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    busy = rec.get("device_busy_ms_per_step")
    scan = rec["scan"]
    first = rec["first_step_end_to_end"]
    print(f"recurrent serve {arch} L={cfg.n_layers}: {rec['tokens']} tokens "
          f"{rec['tokens_per_s']:.2f} tok/s, decode step "
          f"{rec['decode_step_ms']:.3f} ms (engine), step wall "
          f"{rec['decode_step_wall_ms']:.3f} ms, traced step "
          f"{rec['traced_step_wall_ms']:.3f} ms, device busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms, idle share {rec['device_idle_share']:.4f}, "
             f"{rec['device_activities_per_step']:.0f} activities")
          + f"; B1 {rec['b1_ms_per_step']:.3f} ms per step (kernel cases), "
          f"{rec['launches_per_step']} per step, "
          f"{rec['graph_packed_kernels_per_step']} in a CUDA graph of one "
          f"step ({rec['graph_kernels_per_step']} kernels in all); "
          f"recurrence {scan['decode_ms_per_step']:.3f} ms per step, "
          f"{scan['prefill_ms']:.3f} ms per prefill; unembed "
          f"{rec['unembed_ms']:.5f} ms; rerun equal, static == continuous; "
          f"int8 step B2 {int8_launches} "
          f"({rec['int8_step']['b2_ms_per_step']:.3f} ms); first step "
          f"layer by layer rel err int4 "
          f"{rec['first_step_logit_rel_err']:.3e} int8 "
          f"{rec['int8_step']['logit_rel_err']:.3e}, end to end ("
          + ("held" if end_to_end else "reported, float model moves "
             f"{first['oracle_amplification']:.3e} under a 1e-7 "
             "perturbation")
          + f") int4 {first['rel_err']:.3e} (greedy equal "
          f"{first['greedy_equal']:.3f}) int8 "
          f"{rec['int8_step']['end_to_end_rel_err']:.3e}; init {init_s:.1f} s, "
          f"peak {rec['peak_memory_gb']:.1f} GB [{CARD}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return rec


def windowed_hybrid_phase(dev, *, n_req, prompt_len, new_tokens, max_len,
                          slots, chunk) -> dict:
    """recurrentgemma at full width, RG_WINDOW_LAYERS layers (one group
    and the 2-layer tail), window RG_WINDOW that the prompts wrap, packed
    int4: parallel prefill against stepped (the ring's slots, every state
    leaf, the next step's logits) and continuous against static streams;
    then under ``int8_kv``: the parallel prefill's int8 codes and scales
    are ``q8`` of the f32 parallel prefill's K/V bit for bit, its logits
    the f32 pass's, the stepped int8 cache's codes within one step of
    them, and the two engines' streams equal."""
    cfg = dataclasses.replace(get_config(RG_ARCH),
                              n_layers=RG_WINDOW_LAYERS,
                              local_window=RG_WINDOW)
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    split = split_layers(params)
    rec = {"prefill": recurrent_prefill_phase(
        cfg, params, f"int4 window {RG_WINDOW}", dev, n_req=n_req,
        prompt_len=prompt_len, max_len=max_len, end_to_end=True)}
    prompts = moe_prompts(cfg, n_req, prompt_len)
    kw = dict(slots=slots, max_len=max_len, chunk=chunk)
    for kv in ("f32", "int8"):
        opts = "int8_kv" if kv == "int8" else ""
        cont = _with_opts(opts, lambda: engine_run(
            cfg, params, prompts, new_tokens, dev, **kw))
        static = _with_opts(opts, lambda: static_streams(
            cfg, params, prompts, new_tokens, **kw))
        if static != cont["streams"]:
            raise AssertionError(f"windowed hybrid {kv} KV: static and "
                                 "continuous streams differ")
        rec[f"{kv}_streams"] = cont["streams"]
        rec[f"{kv}_step_ms_median"] = cont["step_ms_median"]
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.long, device=dev)
    batch = {"tokens": toks}
    lg8, c8 = _with_opts("int8_kv,parallel_prefill", lambda: prefill(
        cfg, split, batch, max_len, torch.float32))
    lg32, c32 = _with_opts("parallel_prefill", lambda: prefill(
        cfg, split, batch, max_len, torch.float32))
    _, c8s = _with_opts("int8_kv", lambda: prefill(
        cfg, split, batch, max_len, torch.float32))
    kv8, kv32, kv8s = c8.kv["kv"], c32.kv["kv"], c8s.kv["kv"]
    if kv8.k.dtype != torch.int8 or kv8s.k.dtype != torch.int8:
        raise AssertionError("int8_kv prefill: the cache is not int8")
    for name, codes, scale, f32 in (("k", kv8.k, kv8.k_scale, kv32.k),
                                    ("v", kv8.v, kv8.v_scale, kv32.v)):
        want_c, want_s = q8(f32)
        if not (torch.equal(codes, want_c) and torch.equal(scale, want_s)):
            raise AssertionError(f"int8_kv parallel prefill {name}: not q8 "
                                 "of the f32 parallel prefill's cache")
    scale = float(lg32.abs().max())
    lg_err = check(lg8, lg32, "int8_kv parallel prefill logits",
                   atol=LOGIT_TOL * scale, rtol=0.0) / scale
    code_diff = max(int((a.int() - b.int()).abs().max())
                    for a, b in ((kv8.k, kv8s.k), (kv8.v, kv8s.v)))
    if code_diff > 1:
        raise AssertionError(f"int8_kv prefill: parallel and stepped codes "
                             f"{code_diff} apart")
    rec["int8_kv"] = {
        "logits_rel_err": lg_err, "logits_bit_equal": bool(
            torch.equal(lg8, lg32)),
        "stepped_code_max_diff": code_diff,
        "stepped_codes_differing": float(torch.cat([
            (kv8.k != kv8s.k).flatten(), (kv8.v != kv8s.v).flatten()])
            .float().mean())}
    print(f"windowed hybrid {cfg.name} L={cfg.n_layers} window "
          f"{cfg.local_window}: prefill parallel "
          f"{rec['prefill']['parallel_ms']:.2f} ms vs stepped "
          f"{rec['prefill']['stepped_ms']:.2f} ms (max rel err "
          f"{rec['prefill']['max_end_to_end_rel_err']:.3e}, ring of "
          f"{kv32.k.shape[2]} slots); static == continuous with f32 and "
          f"int8 KV (median step {rec['f32_step_ms_median']:.2f} / "
          f"{rec['int8_step_ms_median']:.2f} ms); int8_kv parallel prefill "
          f"= q8 of the f32 cache, logits rel err {lg_err:.3e}, stepped "
          f"codes within {code_diff} "
          f"({rec['int8_kv']['stepped_codes_differing']:.4%} differ) "
          f"[{CARD}]", flush=True)
    return rec


def recurrent_phases(dev, gen) -> dict:
    """The recurrent cells, in order: B1/B2 at the families' shapes,
    rwkv6-7b and recurrentgemma-2b at full width and depth, the windowed
    hybrid; each one's wall time."""
    traffic = dict(n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                   slots=8, chunk=16)
    rec, took = {}, {}
    t0 = time.perf_counter()
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    kcases = recurrent_kernel_phase(dev, gen, flush)
    del flush
    took["kernels"] = time.perf_counter() - t0
    rec["kernels"] = [dict(k=k, n=n, **v) for (k, n), v in kcases.items()]
    for name, fn in (
            (RWKV_ARCH, lambda: recurrent_serve_phase(
                RWKV_ARCH, dev, kcases, **traffic)),
            (RG_ARCH, lambda: recurrent_serve_phase(
                RG_ARCH, dev, kcases, **traffic)),
            ("window", lambda: windowed_hybrid_phase(dev, **traffic))):
        t0 = time.perf_counter()
        rec[name] = fn()
        torch.cuda.empty_cache()
        took[name] = time.perf_counter() - t0
    rec["phase_s"] = took
    rec["total_s"] = sum(took.values())
    print("recurrent phases (s): " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in took.items())
          + f"; total {rec['total_s']:.1f} [{CARD}]", flush=True)
    return rec


# ---------------------------------------------------------------------------
# the encoder–decoder and prefix-LM families: whisper-base and paligemma-3b
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-base"
PALIGEMMA_ARCH = "paligemma-3b"
#: packed denses one decoder layer runs per decode step: whisper's self
#: wq wk wv wo, cross wq wo (the cross K/V are the cache's extras) and
#: MLP w_in w_out; a paligemma layer's wq wk wv wo and gated MLP
ENCDEC_PER_LAYER = {WHISPER_ARCH: 8, PALIGEMMA_ARCH: 7}
#: the (k, n) of every dense of the two families at full width
ENCDEC_SHAPES = {
    WHISPER_ARCH: [(512, 512), (512, 2048), (2048, 512)],
    PALIGEMMA_ARCH: [(2048, 2048), (2048, 256), (2048, 16384),
                     (16384, 2048)]}
#: rows of B1's full-sequence launches: whisper's encoder and cross K/V
#: over 8 × 1500 frames, paligemma's prefill of 8 × (256 + 32) positions
ENCDEC_PREFILL_M = {WHISPER_ARCH: 8 * 1500, PALIGEMMA_ARCH: 8 * (256 + 32)}


def encdec_kernel_phase(dev, gen, flush) -> dict:
    """B1 (packed int4) and B2 against their twins at m = 8 at every (k,
    n) of the two families, B1 at their full-sequence rows
    (ENCDEC_PREFILL_M) and B3 non-causal at whisper's encoder (B·H = 8·8,
    S = 1500, d = 64), each timed beside its bound, its twin and the
    library call as in the kernel phase: {"m8": {(k, n): {"arch",
    "int4", "int8"}}, "prefill": [case], "flash": case}."""
    out = {"m8": {}, "prefill": []}
    for arch, shapes in ENCDEC_SHAPES.items():
        for k, n in shapes:
            c4 = kernel_case(4, 8, k, n, dev, gen, flush)
            c8 = int8_case(8, k, n, "kn", dev, gen, flush, timed=True)
            out["m8"][(k, n)] = {"arch": arch, "int4": c4, "int8": c8}
            print(f"encdec/vlm kernels {arch} m=8 k={k} n={n}: B1 int4 ms="
                  f"{c4['ms']:.5f} plain_ms={c4['plain_ms']:.5f} library_ms="
                  f"{c4['library_ms']:.5f} bound_ms={c4['bound_ms']:.5f} "
                  f"({c4['bound_by']}) err={c4['max_abs_err']:.3e}; B2 ms="
                  f"{c8['ms']:.5f} plain_ms={c8['plain_ms']:.5f} library_ms="
                  f"{c8['library_ms']:.5f} bound_ms={c8['bound_ms']:.5f} "
                  f"({c8['bound_by']}) err={c8['max_abs_err']:.3e} [{CARD}]",
                  flush=True)
        m = ENCDEC_PREFILL_M[arch]
        for k, n in shapes:
            c = dict(kernel_case(4, m, k, n, dev, gen, flush), arch=arch)
            out["prefill"].append(c)
            print(f"encdec/vlm kernels {arch} B1 int4 m={m} k={k} n={n}: ms="
                  f"{c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms="
                  f"{c['library_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
                  f"({c['bound_by']}) err={c['max_abs_err']:.3e} [{CARD}]",
                  flush=True)
    c = flash_case(1500, 0, dev, gen, flush, b=8, h=8, d=64, causal=False)
    out["flash"] = c
    print(f"encdec kernels B3 non-causal B*H=64 S=1500 d=64: ms="
          f"{c['ms']:.5f} plain_ms={c['plain_ms']:.5f} library_ms="
          f"{c['library_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
          f"({c['bound_by']}) err={c['max_abs_err']:.3e} [{CARD}]",
          flush=True)
    return out


def _counted(dev, fn):
    """``fn()`` with every kernel count zeroed just before it: (its
    result, {"ms": synchronized wall ms, "b1": dequant launches by nbits,
    "flash": B3 launches})."""
    _sync(dev)
    reset_launches()
    reset_flash_launches()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, {"ms": 1e3 * (time.perf_counter() - t0),
                 "b1": {nb: c for nb, c in LAUNCHES.items() if c},
                 "tc_launches": tc_launches(),
                 "flash": flash_attention_cuda.launches}


def _greedy_steps(cfg, split, cache, logits, n):
    """``n`` greedy ``decode_step`` calls from a prefilled cache: (the
    tokens fed, [the prefill's logits, each step's logits], mean step
    wall ms)."""
    fed, seen = [], [logits]
    dev = logits.device
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        tok = seen[-1].argmax(-1, keepdim=True)
        fed.append(tok)
        logits, cache = decode_step(cfg, split, cache, tok)
        seen.append(logits)
    _sync(dev)
    return (torch.cat(fed, 1), seen,
            1e3 * (time.perf_counter() - t0) / n)


def _hold_steps(seen, oracle_logits, what):
    """Each served logits row (the prefill's, then each step's) against
    the oracle's forward_train logits at its position, within LOGIT_TOL
    of the oracle's largest value; the largest relative error."""
    want = oracle_logits[:, -len(seen):]
    return max(_rel_check(got, want[:, j], f"{what} step {j}")
               for j, got in enumerate(seen))


def encdec_serve_rest(cfg, params, kcases, dev, rec, traffic):
    """The part both families share after their prefill check: the
    continuous engine's token-only traffic (serve_tree: first step against
    the dequantized model, ENCDEC_PER_LAYER B1 per layer and step), the
    step's breakdown (its CUDA graph's B1 nodes), a rerun and the static
    engine with equal streams, one decode step of an int8 copy through
    B2."""
    arch = cfg.name
    per_layer = ENCDEC_PER_LAYER[arch]
    rec["serve"] = serve_tree(cfg, params, dequantized_model, "int4", dev,
                              per_layer=per_layer, **traffic)
    rec["serve"].update(step_breakdown(cfg, params, dev, traffic["slots"],
                                       traffic["max_len"], ()))
    rec["b1_ms_per_step"] = kernel_ms_per_step(decode_tree(params), kcases,
                                               "int4")
    prompts = moe_prompts(cfg, traffic["n_req"], traffic["prompt_len"])
    kw = dict(slots=traffic["slots"], max_len=traffic["max_len"],
              chunk=traffic["chunk"])
    rerun = engine_run(cfg, params, prompts, traffic["new_tokens"], dev,
                       **kw)
    if rerun["streams"] != rec["serve"]["streams"]:
        raise AssertionError(f"{arch}: a rerun of the continuous engine gave "
                             "other streams")
    rec["rerun_step_ms_median"] = rerun["step_ms_median"]
    if static_streams(cfg, params, prompts, traffic["new_tokens"],
                      **kw) != rec["serve"]["streams"]:
        raise AssertionError(f"{arch}: ServeEngine's streams differ from "
                             "ContinuousEngine's")
    deq = dequantized_model(params)
    int8 = quantize_params_tree(deq)
    del deq
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    n_req, max_len = traffic["n_req"], traffic["max_len"]
    got, counts = _counted(dev, lambda: decode_step(cfg, int8, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)[0])
    if counts["b1"] != {8: per_layer * cfg.n_layers}:
        raise AssertionError(f"{arch} int8 decode step launches "
                             f"{counts['b1']}")
    oracle = dequantized_model(int8)
    want, _ = decode_step(cfg, oracle, init_cache(
        cfg, n_req, max_len, torch.float32, device=dev), tok)
    rec["int8_step"] = {"launches": counts["b1"],
                        "logit_rel_err": _rel_check(
                            got, want, f"{arch} int8 first step")}
    del oracle, int8
    torch.cuda.empty_cache()


def _check_counts(dev, what, got, want, rows=None):
    """On the card, the (B1 launches by nbits, B3 launches) of a counted
    call (``_counted``) must be ``want``; the CPU's twins count nothing.
    With ``rows`` (the fewest rows of x of any of the call's products)
    its tensor-core launches are held as ``check_tc`` holds them."""
    if dev.type == "cuda" and (got["b1"], got["flash"]) != want:
        raise AssertionError(f"{what}: B1 {got['b1']}, B3 {got['flash']}; "
                             f"expected {want}")
    if rows is not None and dev.type == "cuda":
        tc = dict(got["b1"]) if dq.uses_tensor_cores(rows) else {}
        if got["tc_launches"] != tc:
            raise AssertionError(f"{what}: tensor-core launches "
                                 f"{got['tc_launches']} at m >= {rows}, "
                                 f"expected {tc}")


def whisper_prefill_phase(cfg, params, dev, *, n_req, prompt_len,
                          new_tokens, max_len) -> dict:
    """Frames (n_req, enc_seq, d) from a numpy seed: ``encode`` (6 B1 per
    encoder layer at m = n_req·enc_seq and one B3, non-causal),
    ``capture_cross_kv`` (2 B1 per decoder layer at that m) and the whole
    ``prefill`` (those, and 8 B1 per decoder layer at m = n_req·prompt_len
    and one B3, causal), each timed with its launches counted; the
    prefill's self K/V and extras against ``capture_cross_kv`` +
    ``decode_chunk`` over the prompt; ``new_tokens`` greedy decode steps
    after it, the prefill's and every step's logits against the
    dequantized model's ``forward_train`` over the frames and [prompt;
    served tokens].  All within LOGIT_TOL of the largest value."""
    split = split_layers(params)
    rng = np.random.default_rng(31)
    frames = torch.as_tensor(
        rng.standard_normal((n_req, cfg.enc_seq, cfg.d_model)),
        dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.stack(moe_prompts(cfg, n_req, prompt_len)),
                           dtype=torch.long, device=dev)
    batch = {"tokens": toks, "frames": frames}
    prefill(cfg, split, {"tokens": toks[:, :2], "frames": frames}, max_len,
            torch.float32)                                  # first use
    enc, c_enc = _counted(dev, lambda: encode(cfg, split, frames))
    extras, c_cross = _counted(dev, lambda: capture_cross_kv(
        cfg, split, enc, torch.float32))
    (logits, cache), c_pre = _counted(dev, lambda: prefill(
        cfg, split, batch, max_len, torch.float32))
    L, E = cfg.n_layers, cfg.enc_layers
    frames_rows = n_req * cfg.enc_seq
    _check_counts(dev, "whisper encode", c_enc, ({4: 6 * E}, E), frames_rows)
    _check_counts(dev, "whisper cross K/V", c_cross, ({4: 2 * L}, 0),
                  frames_rows)
    _check_counts(dev, "whisper prefill", c_pre,
                  ({4: 6 * E + 2 * L + 8 * L}, E + L),
                  min(frames_rows, n_req * prompt_len))
    if int(cache.pos) != prompt_len:
        raise AssertionError(f"whisper prefill pos {int(cache.pos)}")
    rec = {"encode": c_enc, "cross_kv": c_cross, "prefill": c_pre}
    ref = init_cache(cfg, n_req, max_len, torch.float32, device=dev)
    for dst, src in zip(ref.extras, extras):
        dst.copy_(src)
    ref_logits, ref = decode_chunk(cfg, split, ref, toks)
    rec["prefill_vs_decode_chunk_rel_err"] = {
        name: _rel_check(got, want, f"whisper prefill {name} vs "
                         "capture_cross_kv + decode_chunk")
        for name, got, want in (
            ("k", cache.kv.k, ref.kv.k), ("v", cache.kv.v, ref.kv.v),
            ("enc_k", cache.extras[0], ref.extras[0]),
            ("enc_v", cache.extras[1], ref.extras[1]),
            ("logits", logits, ref_logits))}
    del ref, extras, enc
    fed, seen, step_ms = _greedy_steps(cfg, split, cache, logits,
                                       new_tokens)
    oracle = dequantized_model(params)
    full = forward_train(cfg, oracle, {"tokens": torch.cat([toks, fed], 1),
                                       "frames": frames})
    rec["steps_rel_err"] = _hold_steps(seen, full, "whisper int4")
    rec["greedy_steps"] = new_tokens
    rec["prefilled_step_ms"] = step_ms
    return rec


def paligemma_prefill_phase(cfg, params, dev, *, n_req, prompt_len,
                            new_tokens) -> dict:
    """Patches (n_req, prefix_tokens, d) from a numpy seed: the
    ``prefill`` of prefix_tokens + prompt_len positions (7 B1 per layer at
    m = n_req·(P + S), no B3: GQA and the prefix-LM mask take the plain
    softmax), timed with its launches counted; ``new_tokens`` greedy
    decode steps after it, the prefill's and every step's logits against
    the dequantized model's ``forward_train`` over [patches; prompt;
    served tokens], within LOGIT_TOL of the largest value."""
    split = split_layers(params)
    rng = np.random.default_rng(32)
    patches = torch.as_tensor(
        rng.standard_normal((n_req, cfg.prefix_tokens, cfg.d_model)),
        dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.stack(moe_prompts(cfg, n_req, prompt_len)),
                           dtype=torch.long, device=dev)
    batch = {"tokens": toks, "patches": patches}
    max_len = cfg.prefix_tokens + prompt_len + new_tokens
    prefill(cfg, split, {"tokens": toks[:, :2], "patches": patches},
            max_len, torch.float32)                         # first use
    (logits, cache), c_pre = _counted(dev, lambda: prefill(
        cfg, split, batch, max_len, torch.float32))
    _check_counts(dev, "paligemma prefill", c_pre,
                  ({4: ENCDEC_PER_LAYER[PALIGEMMA_ARCH] * cfg.n_layers}, 0),
                  n_req * (cfg.prefix_tokens + prompt_len))
    if int(cache.pos) != cfg.prefix_tokens + prompt_len:
        raise AssertionError(f"paligemma prefill pos {int(cache.pos)}")
    fed, seen, step_ms = _greedy_steps(cfg, split, cache, logits,
                                       new_tokens)
    del cache
    oracle = dequantized_model(params)
    full = forward_train(cfg, oracle, {"tokens": torch.cat([toks, fed], 1),
                                       "patches": patches})
    return {"prefill": c_pre, "prefill_max_len": max_len,
            "steps_rel_err": _hold_steps(seen, full, "paligemma int4"),
            "greedy_steps": new_tokens, "prefilled_step_ms": step_ms}


def family_phase(arch, dev, kcases, *, n_req, prompt_len, new_tokens,
                 max_len, slots, chunk) -> dict:
    """whisper-base (6 encoder and 6 decoder layers, frames (8, 1500,
    512)) or paligemma-3b (18 layers, patches (8, 256, 2048)) at full
    width and depth, every dense packed int4 (B1): init time, the exact
    prefill and the steps after it (``whisper_prefill_phase``,
    ``paligemma_prefill_phase``), then ``encdec_serve_rest`` on the serve
    traffic; peak memory."""
    cfg = get_config(arch)
    torch.empty(1, device=dev)          # the allocator exists before reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    _sync(dev)
    rec = {"init_s": time.perf_counter() - t0,
           "formats": leaf_format_histogram(params)}
    torch.cuda.empty_cache()
    if arch == WHISPER_ARCH:
        rec.update(whisper_prefill_phase(
            cfg, params, dev, n_req=n_req, prompt_len=prompt_len,
            new_tokens=new_tokens, max_len=max_len))
    else:
        rec.update(paligemma_prefill_phase(
            cfg, params, dev, n_req=n_req, prompt_len=prompt_len,
            new_tokens=new_tokens))
    torch.cuda.empty_cache()
    traffic = dict(n_req=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
                   max_len=max_len, slots=slots, chunk=chunk)
    encdec_serve_rest(cfg, params, kcases, dev, rec, traffic)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    _print_family(cfg, rec)
    del params
    torch.cuda.empty_cache()
    return rec


def _print_family(cfg, rec):
    sv = rec["serve"]
    busy = sv.get("device_busy_ms_per_step")
    parts = [f"{k} {rec[k]['ms']:.2f} ms (B1 {rec[k]['b1']}, B3 "
             f"{rec[k]['flash']})" for k in ("encode", "cross_kv", "prefill")
             if k in rec]
    print(f"{cfg.name} L={cfg.n_layers}"
          + (f"+{cfg.enc_layers} enc" if cfg.enc_layers else "")
          + f": {'; '.join(parts)}; {rec['greedy_steps']} prefilled steps "
          f"{rec['prefilled_step_ms']:.2f} ms each, logits vs the "
          f"dequantized forward_train max rel err "
          f"{rec['steps_rel_err']:.3e}; engine {sv['tokens']} tokens "
          f"{sv['tokens_per_s']:.2f} tok/s, decode step "
          f"{sv['decode_step_ms']:.3f} ms (engine), step wall "
          f"{sv['decode_step_wall_ms']:.3f} ms, traced "
          f"{sv['traced_step_wall_ms']:.3f} ms, device busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms, idle share {sv['device_idle_share']:.4f}, "
             f"{sv['device_activities_per_step']:.0f} activities")
          + f"; B1 {sv['launches_per_step']} per step "
          f"({rec['b1_ms_per_step']:.3f} ms from the kernel cases), "
          f"{sv['graph_packed_kernels_per_step']} in a CUDA graph of one "
          f"step; unembed {sv['unembed_ms']:.5f} ms; rerun equal, static == "
          f"continuous; int8 step B2 {rec['int8_step']['launches']} rel err "
          f"{rec['int8_step']['logit_rel_err']:.3e}; init "
          f"{rec['init_s']:.1f} s, peak {rec['peak_memory_gb']:.1f} GB "
          f"[{CARD}]", flush=True)


def encdec_vlm_phases(dev, gen) -> dict:
    """The encoder–decoder and prefix-LM cells, in order: B1/B2/B3 at
    their shapes, whisper-base and paligemma-3b at full width and depth;
    each one's wall time."""
    traffic = dict(n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                   slots=8, chunk=16)
    rec, took = {}, {}
    t0 = time.perf_counter()
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    kcases = encdec_kernel_phase(dev, gen, flush)
    del flush
    took["kernels"] = time.perf_counter() - t0
    rec["kernels"] = {
        "m8": [dict(k=k, n=n, **v) for (k, n), v in kcases["m8"].items()],
        "prefill": kcases["prefill"], "flash": kcases["flash"]}
    for name in (WHISPER_ARCH, PALIGEMMA_ARCH):
        t0 = time.perf_counter()
        rec[name] = family_phase(name, dev, kcases["m8"], **traffic)
        torch.cuda.empty_cache()
        took[name] = time.perf_counter() - t0
    rec["phase_s"] = took
    rec["total_s"] = sum(took.values())
    print("encdec/vlm phases (s): " + ", ".join(f"{k} {v:.1f}"
                                                for k, v in took.items())
          + f"; total {rec['total_s']:.1f} [{CARD}]", flush=True)
    return rec


# ---------------------------------------------------------------------------
# The registry's largest dense configs (slice 16): qwen2.5-32b, qwen1.5-32b
# and minitron-8b served int4 at full width from the layer-by-layer build,
# and one full-width qwen2.5-32b layer quantized by WaterSIC through B4
# ---------------------------------------------------------------------------

#: arch → layers served (full depth), each tree built layer by layer by
#: the serve driver's ``serving_tree``
LARGE_DENSE = {"qwen2.5-32b": 64, "qwen1.5-32b": 64, "minitron-8b": 32}
#: B1 launches per layer of a decode step, by (k, n): qwen2.5-32b's wq/wo,
#: wk/wv (8 KV heads of 128), w_gate/w_up and w_out; qwen1.5-32b's four
#: attention matrices (40 KV heads) and its MLP; minitron-8b's wq/wo,
#: wk/wv and its non-gated relu² w_in and w_out
LARGE_PER_LAYER = {
    "qwen2.5-32b": {(5120, 5120): 2, (5120, 1024): 2, (5120, 27648): 2,
                    (27648, 5120): 1},
    "qwen1.5-32b": {(5120, 5120): 4, (5120, 27392): 2, (27392, 5120): 1},
    "minitron-8b": {(4096, 4096): 2, (4096, 1024): 2, (4096, 16384): 1,
                    (16384, 4096): 1}}
#: B1's rows at those shapes: a decode step of 8 slots and one prefill
#: chunk of 16 tokens of 8 slots
LARGE_M = (8, 128)
#: the WaterSIC layer's calibration: batches × rows × tokens = 32768
#: tokens, above the widest in-features (27648, w_out's), so every Σ_X
#: can have full rank (with fewer, Σ_X of the down projection is rank
#: deficient: ROADMAP queue C, fault 1)
LARGE_CALIB = (16, 8, 256)
#: the WaterSIC layer's method (no LMMSE and no rescalers: its ZSIC runs
#: blocked through B4) and target rate, bits per parameter
LARGE_PTQ = PTQConfig(target_bits=3.0, method="watersic-plain")


def large_kernel_phase(dev, gen, flush) -> list:
    """B1 (packed int4) against its twin at every (k, n) the three
    configs' decode steps give it, at m = 8 and 128, timed as in the
    kernel phase (L2 cold, ``F.linear`` on the pre-dequantized weight,
    the bound)."""
    shapes = sorted({s for per in LARGE_PER_LAYER.values() for s in per})
    cases = []
    for m in LARGE_M:
        for k, n in shapes:
            c = kernel_case(4, m, k, n, dev, gen, flush)
            cases.append(c)
            print(f"large kernel int4 m={m} k={k} n={n}: ms={c['ms']:.5f} "
                  f"plain_ms={c['plain_ms']:.5f} library_ms="
                  f"{c['library_ms']:.5f} bound_ms={c['bound_ms']:.5f} "
                  f"({c['bound_by']}) max_abs_err={c['max_abs_err']:.3e} "
                  f"[{CARD}]", flush=True)
    return cases


def _layer_f32_bytes(cfg) -> int:
    """Bytes of one layer's f32 weights (``init_layer_params``' tree)."""
    layer = split_layers(init_params(cfg, device="meta"))["layers"][0]
    return sum(x.numel() * x.element_size() for x in tree_leaves(layer))


def large_serve_phase(arch, dev, kcases, *, n_req, prompt_len, new_tokens,
                      max_len, slots, chunk) -> dict:
    """One config at full width and depth, packed int4: the serve
    driver's layer-by-layer build (its peak must stay below the served
    tree plus 3 layers of f32: no whole f32 tree was made), then
    ``serve_tree`` against the ``LayerByLayer`` oracle (first step end to
    end and layer by layer within LOGIT_TOL, B1 once per packed leaf and
    layer per decode step) and the static engine's streams, equal; the
    serve's peak (the tree included)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=LARGE_DENSE[arch])
    per_layer = LARGE_PER_LAYER[arch]
    _sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tree = serving_tree(cfg, 4, dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev) - base
    tree_bytes = qweight_bytes(tree)[0]
    layer_bytes = _layer_f32_bytes(cfg)
    limit = tree_bytes + 3 * layer_bytes
    print(f"large {arch} L={cfg.n_layers}: built layer by layer in "
          f"{build_s:.2f}s, tree {tree_bytes / 1e9:.3f} GB (one f32 layer "
          f"{layer_bytes / 1e9:.3f} GB, the f32 tree "
          f"{f32_tree_bytes(cfg) / 1e9:.2f} GB), build peak "
          f"{build_peak / 1e9:.3f} GB against the bound "
          f"{limit / 1e9:.3f} GB [{CARD}]", flush=True)
    if build_peak >= limit:
        raise AssertionError(f"{arch}: the build's peak {build_peak} B is "
                             f"not below the tree plus 3 f32 layers "
                             f"({limit} B)")
    torch.cuda.reset_peak_memory_stats(dev)
    rec = serve_tree(cfg, tree, LayerByLayer, "int4", dev, n_req=n_req,
                     prompt_len=prompt_len, new_tokens=new_tokens,
                     max_len=max_len, slots=slots, chunk=chunk,
                     per_layer=sum(per_layer.values()), layerwise=True)
    serve_peak = torch.cuda.max_memory_allocated(dev) - base
    static = static_streams(cfg, tree, serve_prompts(cfg, n_req, prompt_len),
                            new_tokens, slots=slots, max_len=max_len,
                            chunk=chunk)
    if static != rec["streams"]:
        raise AssertionError(f"{arch}: the continuous engine's streams "
                             f"differ from the static engine's")
    m8 = {(c["k"], c["n"]): c for c in kcases if c["m"] == slots}
    rec.update(build_s=build_s, build_peak_bytes=build_peak,
               tree_bytes=tree_bytes, layer_f32_bytes=layer_bytes,
               build_peak_limit_bytes=limit, serve_peak_bytes=serve_peak,
               static_streams_equal=True,
               b1_kernel_ms_per_step=cfg.n_layers * sum(
                   n * m8[s]["ms"] for s, n in per_layer.items()),
               b1_bound_ms_per_step=cfg.n_layers * sum(
                   n * m8[s]["bound_ms"] for s, n in per_layer.items()))
    print(f"large {arch}: serve peak {serve_peak / 1e9:.3f} GB (the tree "
          f"included), B1 {rec['launches_per_step']} per decode step "
          f"(kernel phase {rec['b1_kernel_ms_per_step']:.3f} ms, bound "
          f"{rec['b1_bound_ms_per_step']:.3f} ms per step), streams equal "
          f"to the static engine's [{CARD}]", flush=True)
    if arch == "qwen2.5-32b":
        rec.update(step_breakdown(cfg, tree, dev, slots, max_len, None))
        rec["cost"] = cost_decode_phase(cfg, tree, dev, rec, what="(e)")
        print(f"large {arch}: decode step {rec['decode_step_wall_ms']:.3f} "
              f"ms wall, idle share {rec.get('device_idle_share')}, "
              f"unembed {rec['unembed_ms']:.5f} ms device [{CARD}]",
              flush=True)
    del tree
    return rec


def large_watersic_phase(dev) -> dict:
    """One full-width qwen2.5-32b layer quantized by LARGE_PTQ
    (``watersic-plain``: waterfilled column spacings, the blocked ZSIC
    through B4) at 3 bits through the PTQ entry point ``quantize_model``
    (both tapped forwards, ``accumulate_stats`` and ``stats_for_matrix``
    at in-features 5120 and 27648) on LARGE_CALIB's 32768 tokens; its
    peak memory; the realized rate within 0.05 bits, B4's launches equal
    to the 128-column blocks of every ZSIC pass the rate searches made,
    B4 against its twin (bit for bit) and timed at each row count it ran
    at; then the codes served as packed int4 leaves with escapes
    (``from_watersic``), held against the layer of the dequantized codes
    within LOGIT_TOL (first step end to end and the layer's contribution)
    and served by the engine."""
    import repro_torch.core.watersic as ws
    cfg = dataclasses.replace(get_config("qwen2.5-32b"), n_layers=1)
    params = init_params(cfg, 0, device=dev)
    batches, rows, seq = LARGE_CALIB
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)
             for _ in range(batches)]
    # each blocked ZSIC pass's columns, and each B4 launch's rows
    passes, shapes = [], []
    inner_pass, inner_block = ws.zsic_quantize, zsic_ops.zsic_block_cuda

    def pass_recorder(y, l, alphas, **kw):
        passes.append(int(y.shape[1]))
        return inner_pass(y, l, alphas, **kw)

    def block_recorder(y, *a, **kw):
        shapes.append(int(y.shape[0]))
        return inner_block(y, *a, **kw)
    ws.zsic_quantize, zsic_ops.zsic_block_cuda = pass_recorder, block_recorder
    reset_zsic_launches()
    _sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        qp, qlin, budget, rows_rec = quantize_model(cfg, params, calib,
                                                    LARGE_PTQ)
        _sync(dev)
    finally:
        ws.zsic_quantize, zsic_ops.zsic_block_cuda = inner_pass, inner_block
    quant_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del params
    launches = zsic_block_cuda.launches
    blocks = sum(-(-n // zsic_ops.MAX_BLOCK) for n in passes)
    rate = budget.realized_rate
    print(f"large watersic qwen2.5-32b L=1 {LARGE_PTQ.method}: realized "
          f"rate {rate:.4f} bits (target {LARGE_PTQ.target_bits}), "
          f"quantize_model on {batches * rows * seq} calibration tokens in "
          f"{quant_s:.2f}s, peak {peak / 1e9:.3f} GB allocated (the f32 "
          f"model {base / 1e9:.3f} GB of it), {launches} B4 launches for "
          f"{len(passes)} ZSIC passes of {blocks} blocks; per matrix "
          + ", ".join(f"{r['matrix']} H={r['entropy']:.4f} "
                      f"dead={r['dead']}" for r in rows_rec)
          + f" [{CARD}]", flush=True)
    if abs(rate - LARGE_PTQ.target_bits) > 0.05:
        raise AssertionError(f"qwen2.5-32b {LARGE_PTQ.method}: realized "
                             f"rate {rate}")
    if launches != blocks or not launches:
        raise AssertionError(f"B4 launched {launches} times for {blocks} "
                             "blocks")
    # B4 against its twin and timed at the row counts it ran at (the
    # matrices' out-features and the rate searches' row subsamples)
    mix = {a: shapes.count(a) for a in sorted(set(shapes))}
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    zcases = {a: zsic_case(a, zsic_ops.MAX_BLOCK, dev, flush) for a in mix}
    del flush
    for a, c in zcases.items():
        print(f"large zsic_block a={a} bn={c['bn']} ({mix[a]} launches): "
              f"ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} bound_ms="
              f"{c['bound_ms']:.5f} ({c['bound_by']}) code_mismatches="
              f"{c['code_mismatches']} [{CARD}]", flush=True)
    # qp, the float model of the codes: each weight its dequantized codes
    tree, escapes = install_codes(qp, qlin, 1)
    torch.cuda.empty_cache()
    served = serve_tree(cfg, tree, lambda _: qp, "watersic int4", dev,
                        n_req=4, prompt_len=16, new_tokens=8, max_len=32,
                        slots=4, chunk=16, layerwise=True)
    rec = {"method": LARGE_PTQ.method, "target_bits": LARGE_PTQ.target_bits,
           "realized_rate": rate, "calib_tokens": batches * rows * seq,
           "quant_s": quant_s, "peak_bytes": peak, "matrices": rows_rec,
           "zsic_launches": launches, "zsic_passes": passes,
           "zsic_blocks": blocks, "zsic_launch_rows": mix,
           "zsic_cases": zcases, "escapes": escapes, "serve": served}
    del tree, qp, qlin
    return rec


def large_dense_phases(dev, gen) -> dict:
    """The registry's largest dense configs, in order: B1 at their
    shapes, qwen2.5-32b (also its step breakdown and counted cost),
    qwen1.5-32b and minitron-8b served, then the WaterSIC layer; each
    one's wall time, and the memory still allocated after each."""
    traffic = dict(n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                   slots=8, chunk=16)
    rec, took = {}, {}
    t0 = time.perf_counter()
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    rec["kernels"] = large_kernel_phase(dev, gen, flush)
    del flush
    took["kernels"] = time.perf_counter() - t0
    for arch in LARGE_DENSE:
        t0 = time.perf_counter()
        rec[arch] = large_serve_phase(arch, dev, rec["kernels"], **traffic)
        torch.cuda.empty_cache()
        took[arch] = time.perf_counter() - t0
        print(f"large {arch}: {took[arch]:.1f}s; still allocated "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    t0 = time.perf_counter()
    rec["watersic"] = large_watersic_phase(dev)
    torch.cuda.empty_cache()
    took["watersic"] = time.perf_counter() - t0
    rec["b1_launches"] = sum(rec[a]["launches"].get(4, 0)
                             for a in LARGE_DENSE) \
        + rec["watersic"]["serve"]["launches"].get(4, 0)
    rec["phase_s"] = took
    rec["total_s"] = sum(took.values())
    print("large dense phases (s): " + ", ".join(f"{k} {v:.1f}"
                                                 for k, v in took.items())
          + f"; total {rec['total_s']:.1f}; still allocated "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB [{CARD}]",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# Training on one device (slice 11): minicpm-2b trained at full width
# through the train driver, then the lifecycle (train with a restart, PTQ
# of the trained weights, rescaler fine-tune, serving the trained codes)
# at full width and LIFE_LAYERS layers
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm-2b"
#: the train phase's global batch, sequence and microbatches
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 64, 2
#: the driver's steps, and the steps of ``make_train_step`` timed after it
#: (the medians skip the first two)
TRAIN_MAIN_STEPS, TRAIN_TIMED_STEPS = 4, 6
#: depth of the f32 kernel-vs-twin train step (``train_kernel_oracle``)
TRAIN_ORACLE_LAYERS = 2
#: the lifecycle: the reference test's schedule at 1 layer, cut from its
#: 120 steps to 60 (the smoke's time), a checkpoint every 30 steps and two
#: injected failures: one before the first periodic save (replayed from
#: the step-0 checkpoint) and one after the checkpoint of step 30.  These
#: steps leave
#: the model above ln V; a schedule that goes below it makes WaterSIC's
#: rescaler fit fail (ROADMAP queue C, ``rescaler_probe.py``)
LIFE_LAYERS, LIFE_STEPS, LIFE_LR, LIFE_SAVE_EVERY = 1, 60, 2e-3, 30
LIFE_CRASHES = (10, 40)
LIFE_BITS = 2.5
#: calibration batches of 8 × 64 tokens: 6144 ≥ 5760, the largest
#: in-features, so every Σ_X can have full rank
LIFE_CALIB = 12
FT_STEPS, FT_LR = 40, 2e-4
#: tests/test_quant_moe.py's config (the red reference test's)
TINY_MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=48,
                n_heads=3, n_kv=3, d_ff=64, vocab=96, head_dim=16,
                n_experts=4, top_k=2)


def _clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _finite(x, what):
    if not math.isfinite(float(x)):
        raise AssertionError(f"{what} is {float(x)}")
    return float(x)


def top_kernels(prof, n=8) -> list:
    """The ``n`` device kernels of a ``torch.profiler`` trace with the most
    device time: [(name cut to 90 characters, ms, launches)]."""
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = by.get(e.name, (0.0, 0))
            by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                          k + 1)
    return [(name[:90], ms, k) for name, (ms, k) in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:n]]


def train_step_bound_ms(cfg, n_params, tokens):
    """The least time one train step could take on the card: the larger of
    6·N·T multiply-add flops (forward and backward over every parameter,
    the tied unembed included) at the bf16 tensor-core peak, and the bytes
    the update must move at the memory rate: the f32 params, m and v read
    and written once and the f32 mean grads read once (7 × 4 bytes per
    parameter); activations and the bf16 cast left out."""
    ops_ms = 1e3 * 6 * n_params * tokens / BF16_FLOP_PER_S
    bytes_ms = 1e3 * 7 * 4 * n_params / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms), "operations_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def train_kernel_oracle(cfg, dev, batch) -> dict:
    """One f32 train step (2 microbatches) of ``cfg`` through the flash
    kernel against the same step with the twin in its place, from equal
    states.  Held: the loss within PPL_TOL relative, the mean grads and
    the grad norm within GRAD_TOL of the largest (the flash grad phase's
    tolerance), and the updated params.  A first AdamW step moves each
    weight by lr·(g/(|g|+ε) + wd·p), g the clipped grad (m̂ = g, v̂ = g²):
    it divides each grad by its own size, so a grad near ε or near zero
    (most of them at this width: the clipped grads of 405 M weights are
    ~1e-6) turns a Δg far below GRAD_TOL of the largest grad into a large
    change of direction.  So the params are held within GRAD_TOL of each
    leaf's largest wherever the two clipped grads' directions g/(|g|+ε)
    differ by less than 0.1·GRAD_TOL·max|p|/lr (the step itself then
    cannot move them apart by more), and within 2·lr (the most two first
    steps can differ) elsewhere; the count of those elements is
    reported."""
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step, microbatch_grads)
    params = init_params(cfg, 0, device=dev)
    opt = AdamWConfig(lr=3e-3, schedule=cfg.lr_schedule, total_steps=4,
                      warmup_steps=1)

    def run(fn):
        kernel_fn = flash.flash_attention
        flash.flash_attention = fn or kernel_fn
        try:
            state = init_train_state(_clone_tree(params))
            _, grads = microbatch_grads(cfg, state.params, batch,
                                        TRAIN_MICRO, torch.float32)
            step = make_train_step(cfg, opt, n_micro=TRAIN_MICRO,
                                   compute_dtype=torch.float32)
            state, metrics = step(state, batch)
        finally:
            flash.flash_attention = kernel_fn
        return grads, state.params, metrics

    reset_flash_launches()
    gk, pk, mk = run(None)
    launches = flash_attention_cuda.launches
    if launches != 2 * cfg.n_layers * TRAIN_MICRO:
        raise AssertionError(f"train oracle: {launches} flash launches, "
                             f"expected {2 * cfg.n_layers * TRAIN_MICRO}")
    gt, pt, mt = run(flash_twin)
    loss_rel = abs(float(mk["loss"]) - float(mt["loss"])) \
        / abs(float(mt["loss"]))
    gn_rel = abs(float(mk["grad_norm"]) - float(mt["grad_norm"])) \
        / float(mt["grad_norm"])
    if loss_rel > PPL_TOL or gn_rel > GRAD_TOL:
        raise AssertionError(f"train oracle: loss rel {loss_rel:.3e}, "
                             f"grad norm rel {gn_rel:.3e}")
    lr, eps = float(mt["lr"]), opt.eps
    clip_k, clip_t = (min(1.0, opt.clip_norm / float(m["grad_norm"]))
                      for m in (mk, mt))
    grad_err = well = moved = 0.0
    loose = total = 0
    for a, b, x, y in zip(tree_leaves(gk), tree_leaves(gt),
                          tree_leaves(pk), tree_leaves(pt)):
        gscale = float(b.abs().max())
        grad_err = max(grad_err, check(a, b, "train oracle grad",
                                       atol=GRAD_TOL * gscale, rtol=0.0)
                       / max(gscale, 1e-30))
        diff = (x - y).abs()
        pscale = float(y.abs().max())
        ak, bt = a * clip_k, b * clip_t
        turn = (ak / (ak.abs() + eps) - bt / (bt.abs() + eps)).abs()
        cond = lr * turn <= 0.1 * GRAD_TOL * pscale
        if bool((diff * cond > GRAD_TOL * pscale).any()):
            raise AssertionError(
                f"train oracle: params apart by {float((diff * cond).max())}"
                f" where Adam's direction is well conditioned")
        if bool((diff > 2 * lr + GRAD_TOL * pscale).any()):
            raise AssertionError(f"train oracle: params apart by "
                                 f"{float(diff.max())} > 2·lr")
        well = max(well, float((diff * cond).max()) / pscale)
        moved = max(moved, float((diff * ~cond).max()))
        loose += int((~cond).sum())
        total += cond.numel()
    rec = {"n_layers": cfg.n_layers, "flash_launches": launches,
           "loss": float(mk["loss"]), "loss_twin": float(mt["loss"]),
           "loss_rel": loss_rel, "grad_norm_rel": gn_rel,
           "grad_rel_err": grad_err, "param_rel_err_well_conditioned": well,
           "param_abs_diff_elsewhere": moved, "lr": lr,
           "elements_not_well_conditioned": loose, "elements": total}
    print(f"train oracle L={cfg.n_layers} f32 (kernel vs twin, one step): "
          f"loss rel {loss_rel:.3e}, grad norm rel {gn_rel:.3e}, grads "
          f"{grad_err:.3e} of max, params {well:.3e} of max where the two "
          f"grads' Adam directions agree; {loose} of {total} elements "
          f"elsewhere, within {moved:.3e} (2·lr = {2 * lr:.1e}) "
          f"[{CARD}]", flush=True)
    return rec


def train_phase(dev) -> dict:
    """minicpm-2b at full width and depth: ``launch.train.main`` (4 steps
    of 8 × 64 tokens in 2 microbatches, bf16 compute over f32 masters, no
    checkpoint: a full-depth state would write 33 GB) with its B3 launches
    counted, n_layers × n_micro per step; then the same step through
    ``make_train_step``: synchronized wall times (medians of steps 2
    onward), tokens/s, peak memory, B3 launches per step and one traced
    step's device-busy time and idle share; then the kernel-vs-twin oracle
    at 2 layers (``train_kernel_oracle``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = get_config(TRAIN_ARCH)
    per_step = cfg.n_layers * TRAIN_MICRO
    tokens = TRAIN_BATCH * TRAIN_SEQ
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_MAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--n-micro", str(TRAIN_MICRO), "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    loss, counts = _counted(dev, lambda: launch_train.main(argv))
    main_peak = torch.cuda.max_memory_allocated(dev)
    _finite(loss, "launch.train's last loss")
    if counts["flash"] != TRAIN_MAIN_STEPS * per_step or counts["b1"]:
        raise AssertionError(f"launch.train: B3 {counts['flash']}, expected "
                             f"{TRAIN_MAIN_STEPS} steps x {per_step}; B1 "
                             f"{counts['b1']}")
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "n_micro": TRAIN_MICRO,
           "main": {"steps": TRAIN_MAIN_STEPS, "final_loss": loss,
                    "wall_s": counts["ms"] / 1e3,
                    "flash_launches": counts["flash"],
                    "peak_bytes": main_peak}}
    print(f"train {cfg.name} L={cfg.n_layers} launch.train: "
          f"{TRAIN_MAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} in "
          f"{counts['ms'] / 1e3:.2f}s, last loss {loss:.4f}, "
          f"{counts['flash']} B3 launches, peak "
          f"{main_peak / 1e9:.2f} GB [{CARD}]", flush=True)

    torch.cuda.empty_cache()
    state = init_train_state(init_params(cfg, 0, device=dev))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    opt = AdamWConfig(lr=3e-3, schedule=cfg.lr_schedule,
                      total_steps=TRAIN_TIMED_STEPS + 1, warmup_steps=1)
    step = make_train_step(cfg, opt, n_micro=TRAIN_MICRO)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [launch_train.device_batch(dcfg, s, dev)
               for s in range(TRAIN_TIMED_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats(dev)
    walls, launches, losses, norms = [], [], [], []
    for s in range(TRAIN_TIMED_STEPS):
        _sync(dev)
        reset_flash_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        launches.append(flash_attention_cuda.launches)
        losses.append(_finite(m["loss"], f"train step {s} loss"))
        norms.append(_finite(m["grad_norm"], f"train step {s} grad norm"))
    peak = torch.cuda.max_memory_allocated(dev)
    if set(launches) != {per_step}:
        raise AssertionError(f"B3 launches per train step {launches}, "
                             f"expected {per_step}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batches[-1])
        _sync(dev)
        traced = 1e3 * (time.perf_counter() - t0)
    _finite(m["loss"], "traced train step loss")
    busy = _device_busy_ms(prof)
    del state, m, batches
    torch.cuda.empty_cache()
    step_ms = statistics.median(walls[2:])
    rec["step"] = {"wall_ms": walls, "step_ms_median": step_ms,
                   "tokens_per_s": tokens / (step_ms / 1e3),
                   "peak_bytes": peak, "flash_launches_per_step": per_step,
                   "losses": losses, "grad_norms": norms,
                   "traced_step_wall_ms": traced, "params": n_params,
                   **train_step_bound_ms(cfg, n_params, tokens)}
    if busy is not None:
        rec["step"].update({
            "device_busy_ms": busy["busy_ms"],
            "device_idle_share": 1 - busy["busy_ms"] / traced,
            "device_activities": busy["activities"],
            "top_kernels": top_kernels(prof)})
    print(f"train {cfg.name} L={cfg.n_layers} make_train_step: step "
          f"{step_ms:.2f} ms (median of steps 2-{TRAIN_TIMED_STEPS - 1}; "
          f"all {', '.join(f'{w:.1f}' for w in walls)}), "
          f"{rec['step']['tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB, {per_step} B3 launches per step, bound "
          f"{rec['step']['bound_ms']:.2f} ms ({rec['step']['bound_by']}); "
          "traced step " + (
              "device busy not measured (no device activity in the trace)"
              if busy is None else
              f"{traced:.2f} ms wall, device busy {busy['busy_ms']:.2f} ms "
              f"(idle share {rec['step']['device_idle_share']:.4f}, "
              f"{busy['activities']} activities; most device time: "
              + "; ".join(f"{name[:48]} {ms:.2f} ms x{k}" for name, ms, k
                          in rec["step"]["top_kernels"][:5])
              + ")") + f" [{CARD}]", flush=True)
    rec["oracle"] = train_kernel_oracle(
        dataclasses.replace(cfg, n_layers=TRAIN_ORACLE_LAYERS), dev,
        launch_train.device_batch(dcfg, 0, dev))
    torch.cuda.empty_cache()
    return rec


def lifecycle_train(cfg, dev, dcfg) -> tuple:
    """LIFE_STEPS bf16 steps from ``init_params(cfg, 0)`` under
    ``torch.use_deterministic_algorithms``, twice: a plain loop, and
    through ``run_with_restarts`` with a checkpoint every LIFE_SAVE_EVERY
    steps (older ones pruned, a checkpoint of this state is 5 GB) and one
    failure injected at each of LIFE_CRASHES; the second's losses and
    final state must equal the first's bit for bit, and the loss must
    fall.  Returns (record, the trained params)."""
    import shutil
    import tempfile

    from repro_torch.dist.checkpoint import list_steps
    from repro_torch.dist.fault import RestartPolicy, run_with_restarts
    from repro_torch.launch.train import device_batch
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    step = make_train_step(cfg, AdamWConfig(lr=LIFE_LR,
                                            total_steps=LIFE_STEPS,
                                            warmup_steps=10))
    (ROOT / "scratch").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=ROOT / "scratch", prefix="lifecycle_")
    losses, pending, slept, resumed = {}, set(LIFE_CRASHES), [], []

    def step_fn(s, state):
        kept = list_steps(ckpt)
        for old in kept[:-1]:
            shutil.rmtree(os.path.join(ckpt, f"step_{old:08d}"))
        if s in pending:
            pending.remove(s)
            resumed.append(kept[-1])
            raise RuntimeError(f"injected failure at step {s}")
        state, m = step(state, device_batch(dcfg, s - 1, dev))
        losses[s] = float(m["loss"])
        return state

    torch.use_deterministic_algorithms(True)
    try:
        reset_flash_launches()
        t0 = time.perf_counter()
        clean = init_train_state(init_params(cfg, 0, device=dev))
        clean_losses = {}
        for s in range(1, LIFE_STEPS + 1):
            clean, m = step(clean, device_batch(dcfg, s - 1, dev))
            clean_losses[s] = float(m["loss"])
        clean_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, _ = run_with_restarts(
            step_fn, init_train_state(init_params(cfg, 0, device=dev)),
            n_steps=LIFE_STEPS, ckpt_dir=ckpt, save_every=LIFE_SAVE_EVERY,
            policy=RestartPolicy(max_restarts=len(LIFE_CRASHES)),
            sleep_fn=slept.append)
        _sync(dev)
        crash_s = time.perf_counter() - t0
        launches = flash_attention_cuda.launches
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    if len(slept) != len(LIFE_CRASHES) or losses != clean_losses:
        bad = [s for s in clean_losses if losses.get(s) != clean_losses[s]]
        raise AssertionError(f"lifecycle: {len(slept)} restarts; resumed "
                             f"losses differ from the uninterrupted run's at "
                             f"steps {bad[:5]}")
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(clean))):
        raise AssertionError("lifecycle: the resumed run's final state "
                             "differs from the uninterrupted run's")
    del clean
    want_resumed = [c // LIFE_SAVE_EVERY * LIFE_SAVE_EVERY
                    for c in LIFE_CRASHES]
    if resumed != want_resumed:
        raise AssertionError(f"lifecycle: failures resumed from {resumed}, "
                             f"expected the checkpoints {want_resumed}")
    curve = [losses[s] for s in range(1, LIFE_STEPS + 1)]
    first, last = float(np.mean(curve[:10])), float(np.mean(curve[-10:]))
    uniform = math.log(cfg.vocab)
    if not last < first:
        raise AssertionError(f"lifecycle: loss did not fall ({first} -> "
                             f"{last})")
    steps_run = 2 * LIFE_STEPS + sum(c - 1 - r for c, r in
                                     zip(LIFE_CRASHES, resumed))
    want = steps_run * cfg.n_layers
    if launches != want:
        raise AssertionError(f"lifecycle training: {launches} B3 launches, "
                             f"expected {want}")
    rec = {"steps": LIFE_STEPS, "lr": LIFE_LR,
           "save_every": LIFE_SAVE_EVERY, "crash_at": list(LIFE_CRASHES),
           "resumed_from": resumed, "resumed_equal_bitwise": True,
           "losses": curve, "loss_first10": first, "loss_last10": last,
           "ln_vocab": uniform, "clean_s": clean_s,
           "with_restart_s": crash_s, "flash_launches": launches}
    print(f"lifecycle train {cfg.name} L={cfg.n_layers}: {LIFE_STEPS} bf16 "
          f"steps at lr {LIFE_LR}, failures at steps {list(LIFE_CRASHES)} "
          f"resumed from the checkpoints of steps {resumed}: losses and "
          f"final state equal bit for bit to the uninterrupted run's "
          f"(deterministic algorithms); loss {first:.4f} -> {last:.4f} "
          f"(means of the first and last 10; ln V {uniform:.4f}); "
          f"{clean_s:.1f}s uninterrupted, {crash_s:.1f}s with the restarts "
          f"and {1 + LIFE_STEPS // LIFE_SAVE_EVERY} checkpoint saves; "
          f"{launches} B3 launches [{CARD}]", flush=True)
    return rec, state.params


def gptq_model(cfg, params, calib, qlin) -> tuple:
    """Huffman-GPTQ (``gptq_at_rate``: ZSIC through B4) of every matrix
    at the entropy of its WaterSIC code (matched rate), on the float
    model's Σ_X (one calibration pass, damped as the gptq phase damps);
    returns (params with each Ŵ installed, realized rate: the
    parameter-weighted code entropy, as ``RateBudget.realized_rate``
    counts WaterSIC's, ZSIC launches)."""
    weights, stats = plan_inputs_for_model(cfg, params, calib)
    qp = _clone_tree(params)
    launches0 = zsic_block_cuda.launches
    bits = n = 0.0
    for name in sorted(weights):
        w = weights[name].contiguous()
        q = qlin[name]
        g, _, _ = gptq_at_rate(w, _damped(stats[name].sigma_x.to(
            torch.float32)), q.entropy_bits,
            float(torch.exp(torch.log(q.alphas).mean())))
        if abs(g["entropy"] - q.entropy_bits) > 0.05:
            raise AssertionError(f"{name}: GPTQ rate {g['entropy']} does not "
                                 f"match WaterSIC's {q.entropy_bits}")
        l, blk, key = name.split("/")
        qp["layers"][blk][key]["w"][int(l[1:])].copy_(g["w_hat"].T)
        bits += g["entropy"] * w.numel()
        n += w.numel()
    return qp, bits / n, zsic_block_cuda.launches - launches0


def lifecycle_ptq(cfg, params, dev, dcfg) -> tuple:
    """WaterSIC, HPTQ (B4) and Huffman-GPTQ (B4) of the trained weights at
    LIFE_BITS on LIFE_CALIB batches: realized rates within 0.05 (hard),
    ``model_ppl`` through the flash kernel of each (recorded, ungated);
    returns (record, (qparams, qlinears) of WaterSIC)."""
    from repro_torch.data import global_batch_for_step
    calib = [global_batch_for_step(dcfg, 900 + i)["tokens"]
             for i in range(LIFE_CALIB)]
    evalb = [np.concatenate([b["tokens"], b["targets"][:, -1:]], axis=1)
             for b in (global_batch_for_step(dcfg, 1800 + i)
                       for i in range(2))]
    rec = {"calib_tokens": sum(c.size for c in calib),
           "eval": f"{len(evalb)} x {evalb[0].shape}", "methods": {}}
    reset_flash_launches()
    rec["ppl_float"] = model_ppl(cfg, params, evalb)
    results = {}
    for method in ("watersic", "hptq"):
        reset_zsic_launches()
        t0 = time.perf_counter()
        qp, qlin, budget, _ = quantize_model(
            cfg, params, calib, PTQConfig(target_bits=LIFE_BITS,
                                          method=method))
        _sync(dev)
        rate = budget.realized_rate
        if abs(rate - LIFE_BITS) > 0.05:
            raise AssertionError(f"lifecycle {method}: realized rate {rate}")
        rec["methods"][method] = {
            "realized_rate": rate, "wall_s": time.perf_counter() - t0,
            "zsic_launches": zsic_block_cuda.launches,
            "ppl": model_ppl(cfg, qp, evalb)}
        results[method] = (qp, qlin)
    if rec["methods"]["hptq"]["zsic_launches"] == 0:
        raise AssertionError("lifecycle hptq ran no ZSIC kernel launch")
    t0 = time.perf_counter()
    qp_g, rate, launches = gptq_model(cfg, params, calib,
                                      results["watersic"][1])
    _sync(dev)
    if abs(rate - LIFE_BITS) > 0.05 or launches == 0:
        raise AssertionError(f"lifecycle gptq: rate {rate}, {launches} "
                             "ZSIC launches")
    rec["methods"]["gptq"] = {"realized_rate": rate,
                              "wall_s": time.perf_counter() - t0,
                              "zsic_launches": launches,
                              "ppl": model_ppl(cfg, qp_g, evalb)}
    del qp_g, results["hptq"]
    rec["flash_launches"] = flash_attention_cuda.launches
    if rec["flash_launches"] != 4 * len(evalb) * cfg.n_layers:
        raise AssertionError(f"lifecycle model_ppl: "
                             f"{rec['flash_launches']} B3 launches")
    ppl = {m: v["ppl"] for m, v in rec["methods"].items()}
    for m, v in ppl.items():
        _finite(v, f"lifecycle {m} ppl")
    rec["watersic_over_hptq_ppl"] = ppl["watersic"] / ppl["hptq"]
    rec["watersic_over_gptq_ppl"] = ppl["watersic"] / ppl["gptq"]
    rec["evalb"] = evalb
    rec["calib"] = calib
    print(f"lifecycle ptq {cfg.name} L={cfg.n_layers} trained weights at "
          f"{LIFE_BITS} bits on {rec['calib_tokens']} calibration tokens: "
          + ", ".join(f"{m} rate {v['realized_rate']:.4f} ppl "
                      f"{v['ppl']:.4f} ({v['wall_s']:.1f}s, "
                      f"{v['zsic_launches']} ZSIC launches)"
                      for m, v in rec["methods"].items())
          + f"; float ppl {rec['ppl_float']:.4f}; WaterSIC/HPTQ "
          f"{rec['watersic_over_hptq_ppl']:.4f}, WaterSIC/GPTQ "
          f"{rec['watersic_over_gptq_ppl']:.4f} [{CARD}]", flush=True)
    return rec, results["watersic"]


def lifecycle_finetune(cfg, params, qp, qlin, calib, evalb) -> dict:
    """``finetune_rescalers`` for FT_STEPS steps on the WaterSIC model:
    the mean KL of the last 5 steps ≤ 1.05 × the first 5's and ppl after
    ≤ 1.10 × before (tests/test_quant_pipeline.py's gates)."""
    from repro_torch.train.distill import finetune_rescalers
    reset_flash_launches()
    t0 = time.perf_counter()
    qp_ft, _, kl = finetune_rescalers(cfg, params, qp, qlin, calib,
                                      steps=FT_STEPS, lr=FT_LR, log_every=0)
    wall = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    want = (len(calib) + FT_STEPS) * cfg.n_layers
    if launches != want:
        raise AssertionError(f"fine-tune: {launches} B3 launches, expected "
                             f"{want} (teacher and student forwards)")
    ppl_q, ppl_ft = model_ppl(cfg, qp, evalb), model_ppl(cfg, qp_ft, evalb)
    head, tail = float(np.mean(kl[:5])), float(np.mean(kl[-5:]))
    if not tail <= 1.05 * head or not ppl_ft <= 1.10 * ppl_q:
        raise AssertionError(f"fine-tune: KL {head} -> {tail}, ppl {ppl_q} "
                             f"-> {ppl_ft}")
    print(f"lifecycle fine-tune: {FT_STEPS} steps in {wall:.2f}s, KL "
          f"{head:.5f} -> {tail:.5f} (means of the first and last 5), ppl "
          f"{ppl_q:.4f} -> {ppl_ft:.4f}, {launches} B3 launches [{CARD}]",
          flush=True)
    return {"steps": FT_STEPS, "lr": FT_LR, "kl": kl, "kl_first5": head,
            "kl_last5": tail, "ppl_before": ppl_q, "ppl_after": ppl_ft,
            "wall_s": wall, "flash_launches": launches}


def lifecycle_serve_int8(cfg, qp, qlin, dev) -> dict:
    """The trained WaterSIC codes as int8 serving leaves (``from_watersic``,
    stacked as tests/test_system.py stacks them) through B2: first-step
    logits within 2e-2 of the largest of the dequantized path's, then the
    continuous engine twice with equal streams."""
    groups = {}
    for name, q in qlin.items():
        groups.setdefault(tuple(name.split("/")[1:]), {})[
            int(name.split("/")[0][1:])] = from_watersic(q)
    tree = {**qp, "layers": {k: dict(v) for k, v in qp["layers"].items()}}
    for (blk, key), per_layer in groups.items():
        tree["layers"][blk][key] = {
            **tree["layers"][blk][key],
            "w": {k: torch.stack([per_layer[l][k]
                                  for l in range(cfg.n_layers)])
                  for k in ("codes", "s", "t")}}
    prompts = moe_prompts(cfg, 4, 16)
    tok = torch.as_tensor(np.stack([p[:1] for p in prompts]),
                          dtype=torch.long, device=dev)
    got, counts = _counted(dev, lambda: decode_step(cfg, tree, init_cache(
        cfg, 4, 32, torch.float32, device=dev), tok)[0])
    if counts["b1"] != {8: 7 * cfg.n_layers}:
        raise AssertionError(f"int8 first step launches {counts['b1']}")
    want, _ = decode_step(cfg, qp, init_cache(cfg, 4, 32, torch.float32,
                                              device=dev), tok)
    rel = float((got - want).abs().max()) / float(want.abs().max())
    if not rel < 2e-2:
        raise AssertionError(f"int8 serving logits {rel} of max from the "
                             "dequantized path")
    runs = [engine_run(cfg, tree, prompts, 8, dev, slots=4, max_len=32,
                       chunk=16) for _ in range(2)]
    if runs[0]["streams"] != runs[1]["streams"]:
        raise AssertionError("lifecycle int8 streams differ on a rerun")
    b2 = sum(r["launches"].get(8, 0) for r in runs) + counts["b1"][8]
    print(f"lifecycle int8 serve: first-step logits {rel:.3e} of max from "
          f"the dequantized path, equal streams on a rerun, "
          f"{runs[0]['tok_s']:.1f} tokens/s, {b2} B2 launches [{CARD}]",
          flush=True)
    return {"first_step_rel_err": rel, "b2_launches": b2,
            "tokens_per_s": runs[0]["tok_s"],
            "streams": runs[0]["streams"]}


def tiny_moe_ordering(dev) -> dict:
    """tests/test_quant_moe.py's trained-MoE ordering on the card: its
    config (the port's init, seed 0) trained 100 bf16 steps, then
    WaterSIC and RTN at 2.5 bits on its one calibration batch, ``model_ppl``
    on its evaluation batch.  Recorded, not gated (the reference test is
    red)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data import DataConfig, global_batch_for_step
    from repro_torch.launch.train import device_batch
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = ArchConfig(**TINY_MOE)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=40, global_batch=8)
    state = init_train_state(init_params(cfg, 0, device=dev))
    step = make_train_step(cfg, AdamWConfig(lr=2e-3, total_steps=100,
                                            warmup_steps=10))
    for s in range(100):
        state, _ = step(state, device_batch(dcfg, s, dev))
    calib = [global_batch_for_step(dcfg, 900)["tokens"]]
    b = global_batch_for_step(dcfg, 1800)
    evalb = [np.concatenate([b["tokens"], b["targets"][:, -1:]], axis=1)]
    ppl = {}
    for method in ("watersic", "rtn"):
        qp, _, budget, _ = quantize_model(
            cfg, state.params, calib, PTQConfig(target_bits=2.5,
                                                method=method))
        ppl[method] = model_ppl(cfg, qp, evalb)
    ppl["float"] = model_ppl(cfg, state.params, evalb)
    holds = ppl["watersic"] <= ppl["rtn"]
    print(f"tiny MoE (tests/test_quant_moe.py's config, trained 100 steps): "
          f"ppl watersic {ppl['watersic']:.4f}, rtn {ppl['rtn']:.4f}, float "
          f"{ppl['float']:.4f}; WaterSIC <= RTN: {holds} (recorded, not "
          f"gated) [{CARD}]", flush=True)
    return {"ppl": ppl, "watersic_le_rtn": holds}


def lifecycle_phase(dev) -> dict:
    """tests/test_system.py::test_full_lifecycle on the card at
    minicpm-2b's full width and LIFE_LAYERS layers: train with a restart
    (``lifecycle_train``), PTQ of the trained weights (``lifecycle_ptq``),
    the rescaler fine-tune, the trained codes served as packed int4
    through B1 (``serve_after_ptq``: the first step within LOGIT_TOL of
    the dequantized model, equal streams on a rerun) and as int8 through
    B2; then the tiny-MoE ordering.  Prints the new phases' times."""
    from repro_torch.data import DataConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=LIFE_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    rec, took = {}, {}
    t0 = time.perf_counter()
    rec["train"], params = lifecycle_train(cfg, dev, dcfg)
    took["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["ptq"], (qp, qlin) = lifecycle_ptq(cfg, params, dev, dcfg)
    calib, evalb = rec["ptq"].pop("calib"), rec["ptq"].pop("evalb")
    took["ptq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["finetune"] = lifecycle_finetune(cfg, params, qp, qlin, calib, evalb)
    took["finetune"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["serve_int4"] = serve_after_ptq(cfg, qp, qlin, dev)
    rec["serve_int8"] = lifecycle_serve_int8(cfg, qp, qlin, dev)
    took["serve"] = time.perf_counter() - t0
    del qp, qlin
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["tiny_moe"] = tiny_moe_ordering(dev)
    took["tiny_moe"] = time.perf_counter() - t0
    rec["phase_s"] = took
    return rec


def training_phases(dev) -> dict:
    """The train phase, then the lifecycle; each one's wall time."""
    t0 = time.perf_counter()
    rec = {"train": train_phase(dev)}
    rec["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["lifecycle"] = lifecycle_phase(dev)
    rec["lifecycle_s"] = time.perf_counter() - t0
    rec["total_s"] = rec["train_s"] + rec["lifecycle_s"]
    print(f"training phases (s): train {rec['train_s']:.1f}, lifecycle "
          f"{rec['lifecycle_s']:.1f} ("
          + ", ".join(f"{k} {v:.1f}"
                      for k, v in rec["lifecycle"]["phase_s"].items())
          + f"); total {rec['total_s']:.1f} [{CARD}]", flush=True)
    return rec


MESH_RANKS = 4
#: (k_loc, n) of the k-shard partials of minicpm-2b at 4 shards: wq wk wv
#: wo, w_gate w_up, w_out (k = 2304 → 576, k = 5760 → 1440)
SHARD_SHAPES = [(576, 2304), (576, 5760), (1440, 2304)]
SHARD_PER_LAYER = {(576, 2304): 4, (576, 5760): 2, (1440, 2304): 1}
MESH_M = (8, 256)
#: depth of the mesh serve of the int4 tree (minicpm-2b has 40 layers;
#: cut for the smoke's time, as its width and traffic are not: 20 in PR
#: 24, 10 in PR 26, 4 from PR 27)
MESH_FULL_LAYERS = 4
#: depth of the mixed tree's and the gate's mesh runs, and of the chaos run
MESH_SHORT_LAYERS = 2
MESH_CHAOS_LAYERS = 2
#: seconds before the ranks of one launch are killed
MESH_TIMEOUT_S = 600.0


def mixed_bits(path):
    """The reference mesh test's per-leaf format: crc32 of the path over
    {2, 3, 4, 8} bits."""
    return [2, 3, 4, 8][zlib.crc32("/".join(path).encode()) % 4]


def shard_kernel_phase(dev, gen, flush) -> dict:
    """B1 (packed int4) and B2 against their twins at the k-shard shapes,
    m ∈ MESH_M, timed as in the kernel phase."""
    rec = {"b1": [], "b2": []}
    for m in MESH_M:
        for k, n in SHARD_SHAPES:
            c = kernel_case(4, m, k, n, dev, gen, flush)
            rec["b1"].append(c)
            c8 = int8_case(m, k, n, "kn", dev, gen, flush, timed=True)
            rec["b2"].append(c8)
            for name, r in (("B1 int4", c), ("B2 int8", c8)):
                print(f"shard kernel {name} m={m} k_loc={k} n={n}: "
                      f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                      f"library_ms={r['library_ms']:.5f} bound_ms="
                      f"{r['bound_ms']:.5f} ({r['bound_by']}) max_abs_err="
                      f"{r['max_abs_err']:.3e} [{CARD}]", flush=True)
    return rec


def _mesh_work(cfg, n_req, prompt_len, new_tokens):
    rng = np.random.default_rng(0)
    return [(0, i, rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
             new_tokens, None) for i in range(n_req)]


def mesh_phases(dev, gen) -> dict:
    """Tensor-parallel k-sharded serving on 4 ranks sharing the card.

    B1/B2 at the shard shapes; minicpm-2b at full width and
    MESH_FULL_LAYERS layers, packed int4, sharded 4 ways: the oracle's
    first step (the sharded tree in this process) against the unsharded
    dequantized model and its 4 × 7 B1 launches per layer and step; then
    one rank launch (gloo, tensors staged through the host; the weights
    shared through CUDA IPC, not copied) serves that tree (streams equal
    to the oracle's, 7 B1 per layer per rank per decode step, no integer
    all-gather), the mixed tree at 4 layers (B2 on
    its int8 shards) and the device-loss chaos case at 2 layers
    (recovered streams equal to the clean mesh run's); last the
    ``launch.serve --mesh`` gate at 4 layers through ``check_mesh.py``."""
    from repro_torch.dist.fault import RestartPolicy
    from repro_torch.launch.mesh import (backend_rule, launch_ranks,
                                         staging_rule)
    from repro_torch.serve import (MeshJob, run_oracle, serve_mesh_jobs,
                                   shard_params_tree)
    t_phase = time.perf_counter()
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    rec = {"kernels": shard_kernel_phase(dev, gen, flush)}
    del flush
    backend, why = backend_rule(MESH_RANKS, dev)
    staging = staging_rule(backend, dev)
    print(f"mesh: {MESH_RANKS} ranks, backend {backend} ({why}), staging "
          f"{staging} [{CARD}]", flush=True)
    rec.update(backend=backend, staging=staging)
    traffic = dict(n_req=8, prompt_len=32, new_tokens=16)
    econf = EngineConfig(n_slots=8, max_len=64, cache_dtype=torch.float32,
                         prefill_chunk=16)

    cfg = dataclasses.replace(get_config("minicpm-2b"),
                              n_layers=MESH_FULL_LAYERS)
    rec["n_layers"] = cfg.n_layers
    t0 = time.perf_counter()
    params = quantize_for_wbits(init_params(cfg, 0, device=dev), 4)
    sp = shard_params_tree(params, MESH_RANKS)
    _sync(dev)
    rec["shard_s"] = time.perf_counter() - t0
    # the oracle's first step against the unsharded dequantized model
    work = _mesh_work(cfg, **traffic)
    tok = torch.as_tensor(np.stack([w[2][:1] for w in work]),
                          dtype=torch.long, device=dev)
    reset_launches()
    got, _ = decode_step(cfg, sp, init_cache(cfg, 8, 64, torch.float32,
                                             device=dev), tok)
    _sync(dev)
    oracle_b1 = LAUNCHES[4]
    want, _ = decode_step(cfg, dequantized_model(params),
                          init_cache(cfg, 8, 64, torch.float32, device=dev),
                          tok)
    rec["oracle_first_step_rel_err"] = _rel_check(
        got, want, "sharded oracle first-step logits")
    del params, want
    torch.cuda.empty_cache()
    if oracle_b1 != MESH_RANKS * 7 * cfg.n_layers:
        raise AssertionError(f"the oracle's decode step launched B1 "
                             f"{oracle_b1} times, not {MESH_RANKS} x 7 x "
                             f"{cfg.n_layers}")
    short = dataclasses.replace(cfg, n_layers=MESH_SHORT_LAYERS)
    mixed = shard_params_tree(quantize_params_tree(
        init_params(short, 0, device=dev), nbits_by_path=mixed_bits),
        MESH_RANKS)
    tiny = dataclasses.replace(cfg, n_layers=MESH_CHAOS_LAYERS)
    tiny_sp = shard_params_tree(quantize_for_wbits(
        init_params(tiny, 0, device=dev), 4), MESH_RANKS)
    def retry():
        # 2 slots: 4 requests of 8 + 16 tokens make 30 decode dispatches,
        # past the plan's device losses at serve.decode 12 and 20
        return dataclasses.replace(econf, n_slots=2, resilience=(
            ResilienceConfig(retry=RestartPolicy(
                max_restarts=8, backoff_base_s=0.0, reset_after=4))))
    small = dict(n_req=4, prompt_len=8, new_tokens=16)
    jobs = [
        MeshJob("full", cfg, sp, econf, work, measure=True),
        MeshJob("mixed", short, mixed, econf, _mesh_work(short, **traffic)),
        MeshJob("chaos_clean", tiny, tiny_sp, retry(),
                _mesh_work(tiny, **small)),
        MeshJob("chaos_device_loss", tiny, tiny_sp, retry(),
                _mesh_work(tiny, **small), chaos=("device-loss", 0))]
    t0 = time.perf_counter()
    reset_launches()
    oracles = {j.name: run_oracle(j) for j in jobs[:2]}
    _sync(dev)
    oracle_launches = dict(LAUNCHES)
    rec["oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = launch_ranks(serve_mesh_jobs, MESH_RANKS,
                         (jobs, MESH_RANKS), device=dev,
                         timeout_s=MESH_TIMEOUT_S)
    rec["ranks_s"] = time.perf_counter() - t0
    by_job = {j.name: [r[i] for r in ranks] for i, j in enumerate(jobs)}
    for name, want_streams in oracles.items():
        for r in by_job[name]:
            if r["streams"] != want_streams["streams"]:
                raise AssertionError(f"mesh {name}: rank {r['rank']}'s "
                                     "streams differ from the oracle's")
    clean = by_job["chaos_clean"][0]["streams"]
    for r in by_job["chaos_clean"] + by_job["chaos_device_loss"]:
        if r["streams"] != clean:
            raise AssertionError(f"mesh chaos: rank {r['rank']}'s streams "
                                 "differ from the clean mesh run's")
    if [r["faults"] for r in by_job["chaos_device_loss"]] != [2] * MESH_RANKS:
        raise AssertionError("mesh chaos: the device losses did not fire "
                             "on every rank")
    rec["chaos_faults"] = by_job["chaos_device_loss"][0]["faults"]
    per_step = {}
    for r in by_job["full"]:
        if r["step"]["launches"][4] != 7 * cfg.n_layers:
            raise AssertionError(f"rank {r['rank']} launched B1 "
                                 f"{r['step']['launches'][4]} times in a "
                                 f"decode step, not 7 x {cfg.n_layers}")
    for name, rs in by_job.items():
        for r in rs:
            if r["integer_allgathers"] or not r["allgathers"] \
                    or r["allgather_dtypes"] != ["float32"]:
                raise AssertionError(f"mesh {name} rank {r['rank']}: "
                                     f"all-gathers {r['allgathers']} of "
                                     f"{r['allgather_dtypes']}, integer "
                                     f"{r['integer_allgathers'][:3]}")
    if any(r["launches"][8] == 0 or r["launches"][4] == 0
           for r in by_job["mixed"]):
        raise AssertionError("mesh mixed: B1 or B2 never launched on a "
                             "rank")
    b1 = {(c["k"], c["n"]): c["ms"] for c in rec["kernels"]["b1"]
          if c["m"] == 8}
    b1_step_ms = cfg.n_layers * sum(n * b1[s]
                                    for s, n in SHARD_PER_LAYER.items())
    for r in by_job["full"]:
        st = r["step"]
        step_ms = 1e3 * statistics.median(r["step_s"])
        per_step[r["rank"]] = {
            "host_step_ms": step_ms, "measured_step_ms": 1e3 * st["host_s"],
            "b1_launches": st["launches"][4],
            "allgathers": st["allgathers"],
            "allgather_bytes": st["allgather_bytes"]}
        print(f"mesh rank {r['rank']}: decode step {step_ms:.2f} "
              f"ms host (median engine step; one measured step "
              f"{1e3 * st['host_s']:.2f} ms), B1 {st['launches'][4]} "
              f"launches ≈ {b1_step_ms:.4f} ms device per step (the shard "
              f"kernel phase's L2-cold times), {st['allgathers']} "
              f"all-gathers of {st['allgather_bytes']} B per step, "
              f"backend {r['backend']}, staging {r['staging']} [{CARD}]",
              flush=True)
    rec["per_rank"] = per_step
    rec["step_logs"] = {r["rank"]: r["step"].pop("log") for r in by_job["full"]}
    rec["b1_device_ms_per_step"] = b1_step_ms
    rec["b1_launches"] = oracle_launches[4] + oracle_b1 + sum(
        r["launches"][4] + r.get("step", {}).get("launches", {}).get(4, 0)
        for rs in by_job.values() for r in rs)
    rec["b2_launches"] = oracle_launches[8] + sum(
        r["launches"][8] for rs in by_job.values() for r in rs)
    rec["jobs"] = {name: {k: v for k, v in rs[0].items()
                          if k not in ("streams",)}
                   for name, rs in by_job.items()}
    del sp, mixed, tiny_sp, jobs
    torch.cuda.empty_cache()
    # the gate: the serve driver's --mesh run and check_mesh.py unchanged
    t0 = time.perf_counter()
    out = ROOT / "chiprun_out" / "mesh_serve.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "minicpm-2b", "--n-layers", str(MESH_SHORT_LAYERS), "--wbits", "4",
         "--continuous", "--requests", "8", "--slots", "8", "--prompt-len",
         "16", "--max-new", "8", "--mesh", "--ranks", str(MESH_RANKS),
         "--mesh-json", str(out)],
        capture_output=True, text=True, timeout=MESH_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(res.stdout.rstrip(), flush=True)
    if res.returncode != 0:
        raise AssertionError(f"launch.serve --mesh exited {res.returncode}:"
                             f" {res.stderr[-3000:]}")
    run_gate("check_mesh", [str(out)])
    rec["gate_s"] = time.perf_counter() - t0
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh phases: {rec['phase_s']:.1f}s (sharding {rec['shard_s']:.1f}"
          f", oracles {rec['oracle_s']:.1f}, ranks {rec['ranks_s']:.1f}, "
          f"gate {rec['gate_s']:.1f}); oracle first step rel err "
          f"{rec['oracle_first_step_rel_err']:.3e}; streams bit-identical "
          f"on every rank [{CARD}]", flush=True)
    return rec


# ---------------------------------------------------------------------------
# training on a mesh of ranks (slice 13)
# ---------------------------------------------------------------------------

TRAIN_MESH_RANKS = 4
#: the compressed DP step: rows of 64 tokens per rank, and steps (the step
#: time is the median of steps 2-6)
CDP_ROWS, CDP_SEQ, CDP_STEPS = 2, 64, 6
#: launch.train's DP runs: global batch 8 x 64, steps, the checkpointed step
DP_BATCH, DP_STEPS, DP_STOP = 8, 6, 3
#: the expert-parallel cells: phi3.5-moe at full width, 8 x 64 tokens,
#: capacity factor 8 (no pair dropped, on either path), one layer
EP_BATCH, EP_SEQ, EP_CF, EP_LAYERS = 8, 64, 8.0, 1
EP_TOL = 1e-4
EP_KEYS = ("w_gate", "w_up", "w_out")
TRAIN_MESH_TIMEOUT_S = 600.0


def _rank_device(kind: str):
    """This rank's device (its card, set by the launcher) with the
    smoke's settings: no TF32, deterministic algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _checksum(tree) -> list:
    from repro_torch.dist.fault import tree_checksum
    return tree_checksum(tree).tolist()


def _mesh_cfg():
    return dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=MESH_SHORT_LAYERS)


def _ep_cfg():
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=EP_LAYERS,
                               capacity_factor=EP_CF)


#: the model arguments of launch.train's DP runs (the cfg of ``_mesh_cfg``)
DP_MODEL_ARGS = ["--arch", TRAIN_ARCH, "--n-layers", str(MESH_SHORT_LAYERS)]


def compressed_oracle(cfg, dev, dcfg, opt) -> dict:
    """The compressed DP step of TRAIN_MESH_RANKS ranks run in this
    process, shard after shard: each shard's grads of the bf16 cast tree
    (``train_loop._value_and_grad``), then per leaf the common scale from
    the shards' max|g + e| (a max in rank order), each shard's int8 codes
    and error (``grad_compress``'s in-place arithmetic), the codes summed
    into int32 in rank order and dequantized, the loss summed in rank
    order; AdamW in place.  Per step: the losses and the checksums of
    (params, opt) and of each shard's error buffers."""
    from repro_torch.train import adamw_update, init_train_state
    from repro_torch.train.grad_compress import _div
    from repro_torch.train.train_loop import _cast, _value_and_grad
    n = TRAIN_MESH_RANKS
    state = init_train_state(init_params(cfg, 0, device=dev))
    errs = [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=dev), state.params)
            for _ in range(n)]
    four = torch.full((), float(n), device=dev)
    rec = {"losses": [], "state_sums": [], "err_sums": []}
    for s in range(CDP_STEPS):
        batch = device_batch(dcfg, s, dev)
        losses, grads = [], []
        for r in range(n):
            shard = {k: v[r * CDP_ROWS:(r + 1) * CDP_ROWS]
                     for k, v in batch.items()}
            loss, g = _value_and_grad(cfg, _cast(state.params,
                                                 torch.bfloat16), shard)
            losses.append(loss)
            grads.append(g)
        flat = [tree_leaves(g) for g in grads]
        err_leaves = [tree_leaves(e) for e in errs]
        means = []
        with torch.no_grad():
            for i, g0 in enumerate(flat[0]):
                gfs = [flat[r][i].to(torch.float32) + err_leaves[r][i]
                       for r in range(n)]
                gmax = torch.max(torch.abs(gfs[0]))
                for gf in gfs[1:]:
                    gmax = torch.maximum(gmax, torch.max(torch.abs(gf)))
                scale = _div(gmax, 127.0) + 1e-12
                summed = None
                for r, gf in enumerate(gfs):
                    t = torch.div(gf, scale).round_().clamp_(-127, 127)
                    q = t.to(torch.int8)
                    torch.sub(gf, t.mul_(scale), out=err_leaves[r][i])
                    summed = q.to(torch.int32) if summed is None \
                        else summed.add_(q)
                del gfs
                deq = summed.to(torch.float32)
                means.append(_div(deq.mul_(scale), n).to(g0.dtype))
            loss = losses[0]
            for other in losses[1:]:
                loss = loss + other
            loss = loss / four
        del grads, flat
        it = iter(means)
        mean_tree = tree_map(lambda _: next(it), state.params)
        params, opt_state, m = adamw_update(opt, state.params, mean_tree,
                                            state.opt)
        state = state._replace(params=params, opt=opt_state)
        del means, mean_tree
        rec["losses"].append(float(loss))
        rec["state_sums"].append(_checksum((state.params, state.opt)))
        rec["err_sums"].append([_checksum(e) for e in errs])
    return rec


def _compressed_rank(rank, dev, cfg, dcfg, opt) -> dict:
    """One rank of phase (a): CDP_STEPS compressed DP steps on its 2 rows
    of each global batch; per step its wall time (host clock around a
    synchronize), loss, grad norm, B3 launches, collectives and bytes, and
    the checksums of (params, opt) and of its error buffers."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_train_state, make_compressed_step
    mesh = make_host_mesh(device=dev)
    _reset_peak(dev)
    steps = []
    with use_mesh(mesh):
        state = init_train_state(init_params(cfg, 0, device=dev),
                                 use_compression=True)
        step = make_compressed_step(cfg, opt, mesh)
        for s in range(CDP_STEPS):
            batch = device_batch(dcfg, s, dev)
            _sync(dev)
            reset_flash_launches()
            start = len(mesh.log)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            _sync(dev)
            wall = 1e3 * (time.perf_counter() - t0)
            log = mesh.log[start:]
            steps.append({
                "wall_ms": wall, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "b3": flash_attention_cuda.launches,
                "collectives": len(log),
                "bytes": sum(b for *_, b in log),
                "int8_bytes": sum(b for op, dt, _, b in log
                                  if dt == "int8"),
                "max_ops": sum(op == "all_reduce_max" and dt == "float32"
                               and b == 4 for op, dt, _, b in log),
                "state_sum": _checksum((state.params, state.opt)),
                "err_sum": _checksum(state.err)})
    err_nonzero = all(float(e.abs().max()) > 0
                      for e in tree_leaves(state.err))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    n_leaves = len(tree_leaves(state.params))
    peak = _peak(dev)
    del state, step
    mesh.close()
    torch.cuda.empty_cache()
    return {"steps": steps, "err_nonzero": err_nonzero, "peak_bytes": peak,
            "n_params": n_params, "n_leaves": n_leaves,
            "backend": mesh.backend, "staging": mesh.staging}


def _gather_full(mesh, block, spec):
    """A leaf put back together from the ranks' blocks of ``spec``."""
    out = block
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in reversed((entry,) if isinstance(entry, str) else entry):
            out = mesh.all_gather(out.contiguous(), name, dim, tiled=True)
    return out


def _restore_rank(rank, dev, cfg, ckpt, saved) -> dict:
    """One rank of phase (d): the checkpoint restored onto the (2, 2) mesh
    with ``param_specs_tree``'s specs; each block against the saved tree's
    slice (``saved``: the parent's tensors, shared through CUDA IPC), then
    every leaf gathered back against the whole."""
    from repro_torch.dist.checkpoint import restore_checkpoint
    from repro_torch.dist.sharding import NamedSharding, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import param_specs_tree
    mesh = make_host_mesh(model_parallel=2, device=dev)
    with use_mesh(mesh):
        specs = param_specs_tree(cfg)
    pairs = []
    tree_map(lambda leaf, spec: pairs.append((leaf, spec)), saved, specs)
    shardings = tree_map(lambda _, spec: NamedSharding(mesh, spec), saved,
                         specs)
    _sync(dev)
    t0 = time.perf_counter()
    state, manifest = restore_checkpoint(ckpt, saved, shardings=shardings)
    _sync(dev)
    secs = time.perf_counter() - t0
    blocks = tree_leaves(state)
    equal = all(torch.equal(b, NamedSharding(mesh, spec).block(full))
                for b, (full, spec) in zip(blocks, pairs))
    cut = sum(b.numel() < full.numel() for b, (full, _) in zip(blocks, pairs))
    gathered = all(torch.equal(_gather_full(mesh, b, spec), full)
                   for b, (full, spec) in zip(blocks, pairs))
    out = {"coord": (mesh.axis_index("data"), mesh.axis_index("model")),
           "step": manifest["step"], "blocks_equal": equal,
           "gathered_equal": gathered, "cut_leaves": cut,
           "leaves": len(blocks), "restore_s": secs,
           "bytes": sum(b.numel() * b.element_size() for b in blocks),
           "whole_bytes": sum(f.numel() * f.element_size()
                              for f, _ in pairs)}
    del state, blocks
    mesh.close()
    torch.cuda.empty_cache()
    return out


def _ep_rank(rank, dev, cfg, full, x, oracle, opt, batches) -> dict:
    """One rank of phase (c) on the (1, 4) mesh under ``moe_a2a``: layer
    0's ``moe`` forward and backward on its expert block (cut from the
    parent's stack, shared through CUDA IPC) against the parent's local
    ``moe`` (output, x-grad, router grad, the block of each expert grad);
    then two bf16 train steps of the 1-layer model with the experts cut by
    ``expert_specs`` (``make_train_step`` finds the blocks).  The layer runs
    twice and the second call is timed (the first grows the mailboxes and
    warms the libraries), as is the second step."""
    from repro_torch.dist.sharding import NamedSharding, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import expert_specs
    from repro_torch.train import init_train_state, make_train_step
    os.environ["REPRO_OPTS"] = "moe_a2a"
    mesh = make_host_mesh(model_parallel=TRAIN_MESH_RANKS, device=dev)
    cut = NamedSharding(mesh, ("model", None, None))
    lp = full["layers"]["moe"]
    p = {"router": {"w": lp["router"]["w"][0].clone().requires_grad_()},
         **{k: cut.block(lp[k][0]).clone().requires_grad_()
            for k in EP_KEYS}}
    xx = x.clone().requires_grad_()
    _reset_peak(dev)
    with use_mesh(mesh):
        for _ in range(2):          # the second call is timed and held
            for t in (xx, p["router"]["w"], *(p[k] for k in EP_KEYS)):
                t.grad = None
            _sync(dev)
            start = len(mesh.log)
            t0 = time.perf_counter()
            y = moe(p, xx, n_experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=EP_CF, activation=cfg.activation)
            y.sum().backward()
            _sync(dev)
            layer_ms = 1e3 * (time.perf_counter() - t0)
    log = mesh.log[start:]

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())
    errs = {"y": rel(y.detach(), oracle["y"]),
            "x_grad": rel(xx.grad, oracle["x_grad"]),
            "router": rel(p["router"]["w"].grad, oracle["router"]),
            **{k: rel(p[k].grad, cut.block(oracle[k])) for k in EP_KEYS}}
    layer = {"rel_err": errs, "ms": layer_ms, "collectives": len(log),
             "a2a": sum(op == "all_to_all" for op, *_ in log),
             "a2a_bytes": sum(b for op, _, _, b in log if op == "all_to_all"),
             "bytes": sum(b for *_, b in log),
             "peak_bytes": _peak(dev)}
    del p, xx, y
    # one train step with the experts cut
    specs = expert_specs(cfg)
    params = tree_map(lambda leaf, spec: leaf.detach().clone() if spec
                      is None else NamedSharding(mesh, spec).block(leaf)
                      .clone(), full, specs)
    state = init_train_state(params)
    step = make_train_step(cfg, opt)
    _reset_peak(dev)
    losses, norms = [], []
    with use_mesh(mesh):
        for b in batches:           # the second step is timed
            _sync(dev)
            start = len(mesh.log)
            t0 = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            step_ms = 1e3 * (time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    log = mesh.log[start:]
    replicated = []
    tree_map(lambda leaf, spec: replicated.append(leaf) if spec is None
             else None, state.params, specs)
    out = {"layer": layer,
           "step": {"ms": step_ms, "losses": losses, "grad_norms": norms,
                    "replicated_sum": _checksum(replicated),
                    "collectives": len(log),
                    "bytes": sum(b for *_, b in log),
                    "params": sum(t.numel()
                                  for t in tree_leaves(state.params)),
                    "peak_bytes": _peak(dev)}}
    del state, params, step
    mesh.close()
    os.environ.pop("REPRO_OPTS", None)
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(rank, kind, jobs) -> dict:
    """A rank of the training-mesh phases on a device of type ``kind``:
    the jobs named in ``jobs`` (``compressed``, ``restore`` and
    ``driver``, or ``ep``), in that order.  ``driver`` is the rank body of
    ``launch.train --ranks 4`` (``train_rank``, what its ``main`` spawns)
    on the given arguments: the uninterrupted run of phase (b), here so
    that it needs no launch of its own."""
    dev = _rank_device(kind)
    out = {}
    if "compressed" in jobs:
        out["compressed"] = _compressed_rank(rank, dev, **jobs["compressed"])
    if "restore" in jobs:
        out["restore"] = _restore_rank(rank, dev, **jobs["restore"])
    if "driver" in jobs:
        from repro_torch.launch import train as launch_train
        t0 = time.perf_counter()
        loss = launch_train.train_rank(rank, jobs["driver"],
                                       TRAIN_MESH_RANKS)
        out["driver"] = {"loss": loss, "s": time.perf_counter() - t0}
    if "ep" in jobs:
        out["ep"] = _ep_rank(rank, dev, **jobs["ep"])
    return out


def _reckon(what, per_rank_params, bytes_per_param, dev):
    """Print the state a phase's ranks will hold, before they start."""
    per_rank = per_rank_params * bytes_per_param
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 0
    print(f"train mesh {what}, reckoned before the run: {per_rank_params} "
          f"params per rank x {bytes_per_param} B = {per_rank / 1e9:.2f} GB "
          f"of state per rank plus transients, "
          f"{TRAIN_MESH_RANKS * per_rank / 1e9:.2f} GB for "
          f"{TRAIN_MESH_RANKS} ranks; {free / 1e9:.2f} GB free on the card "
          f"[{CARD}]", flush=True)
    return per_rank


def _same(values, what):
    if any(v != values[0] for v in values[1:]):
        raise AssertionError(f"{what} differ across ranks: {values}")
    return values[0]


def compressed_and_restore_phases(dev, cfg, driver_argv) -> dict:
    """Phases (a) and (d), and phase (b)'s uninterrupted driver run on
    ``driver_argv``, in one rank launch; their oracles first."""
    import shutil
    import tempfile

    from repro_torch.data import DataConfig
    from repro_torch.dist.checkpoint import save_checkpoint
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.train import AdamWConfig
    n = TRAIN_MESH_RANKS
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=CDP_SEQ,
                      global_batch=n * CDP_ROWS)
    opt = AdamWConfig(lr=3e-3, schedule=cfg.lr_schedule,
                      total_steps=CDP_STEPS, warmup_steps=1)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        reset_flash_launches()
        oracle = compressed_oracle(cfg, dev, dcfg, opt)
        oracle_b3 = flash_attention_cuda.launches
    finally:
        torch.use_deterministic_algorithms(False)
    oracle_s = time.perf_counter() - t0
    torch.cuda.empty_cache()        # the oracle's state, for the ranks
    saved = init_params(cfg, 0, device=dev)
    # f32 params, m, v and error buffers, the bf16 cast and its grads
    n_params = sum(t.numel() for t in tree_leaves(saved))
    reckoned = _reckon("(a) compressed DP", n_params, 20, dev)
    # (b)'s ranks: f32 params, m and v, the bf16 cast and its grads
    _reckon("(b) launch.train --ranks", n_params, 16, dev)
    (ROOT / "scratch").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=ROOT / "scratch", prefix="elastic_")
    try:
        save_checkpoint(ckpt, 5, saved)
        t0 = time.perf_counter()
        ranks = launch_ranks(train_mesh_rank, n, (dev.type, {
            "compressed": dict(cfg=cfg, dcfg=dcfg, opt=opt),
            "restore": dict(cfg=cfg, ckpt=ckpt, saved=saved),
            "driver": driver_argv},),
            device=dev, timeout_s=TRAIN_MESH_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del saved
    torch.cuda.empty_cache()
    comp = [r["compressed"] for r in ranks]
    n_params, n_leaves = comp[0]["n_params"], comp[0]["n_leaves"]
    per_step = cfg.n_layers                   # B3: layers x 1 microbatch
    for s in range(CDP_STEPS):
        rows = [c["steps"][s] for c in comp]
        want = oracle["state_sums"][s]
        _same([r["state_sum"] for r in rows], f"step {s} (params, opt)")
        if rows[0]["state_sum"] != want:
            raise AssertionError(f"compressed step {s}: the ranks' (params, "
                                 f"opt) differ from the in-process oracle's")
        for r, row in enumerate(rows):
            if row["err_sum"] != oracle["err_sums"][s][r]:
                raise AssertionError(f"compressed step {s}: rank {r}'s error"
                                     f" buffers differ from the oracle's")
            _finite(row["loss"], f"compressed step {s} loss")
            _finite(row["grad_norm"], f"compressed step {s} grad norm")
            if row["b3"] != per_step:
                raise AssertionError(f"compressed step {s} rank {r}: B3 "
                                     f"{row['b3']}, expected {per_step}")
            if row["int8_bytes"] != n_params or row["max_ops"] != n_leaves:
                raise AssertionError(
                    f"compressed step {s} rank {r}: {row['int8_bytes']} int8"
                    f" bytes for {n_params} params, {row['max_ops']} scalar "
                    f"maxes for {n_leaves} leaves")
        loss = _same([r["loss"] for r in rows], "losses")
        # the f32 sum of 4 shard losses: in rank order on the mailbox
        # route, in the backend's order on the others
        if abs(loss - oracle["losses"][s]) > 1e-6 * abs(oracle["losses"][s]):
            raise AssertionError(f"compressed step {s}: loss {loss} differs "
                                 f"from the oracle's {oracle['losses'][s]}")
    if not all(c["err_nonzero"] for c in comp):
        raise AssertionError("compressed step: an error buffer stayed zero")
    walls = [statistics.median(row["wall_ms"] for row in c["steps"][1:])
             for c in comp]
    rec = {"cfg": {"arch": cfg.name, "n_layers": cfg.n_layers,
                   "params": n_params, "leaves": n_leaves},
           "backend": comp[0]["backend"], "staging": comp[0]["staging"],
           "step_ms_median_per_rank": walls,
           "steps": comp, "oracle": oracle, "oracle_s": oracle_s,
           "reckoned_state_bytes_per_rank": reckoned,
           "oracle_b3": oracle_b3, "ranks_s": ranks_s,
           "b3_launches": sum(row["b3"] for c in comp
                              for row in c["steps"]) + oracle_b3}
    st = comp[0]["steps"][-1]
    print(f"train mesh (a) compressed DP {cfg.name} L={cfg.n_layers} "
          f"({n_params} params), {n} ranks x {CDP_ROWS}x{CDP_SEQ} tokens, "
          f"backend {rec['backend']} staging {rec['staging']}: step "
          + ", ".join(f"{w:.1f}" for w in walls)
          + f" ms per rank (median of steps 2-{CDP_STEPS}); per rank per "
          f"step {st['collectives']} collectives, {st['bytes']} B "
          f"({st['int8_bytes']} B int8, {st['max_ops']} scalar maxes); "
          f"B3 {per_step} per rank per step; peak "
          + ", ".join(f"{c['peak_bytes'] / 1e9:.2f}" for c in comp)
          + f" GB; ranks and in-process oracle bit-identical over "
          f"{CDP_STEPS} steps (losses "
          + ", ".join(f"{x:.4f}" for x in oracle["losses"])
          + f"); oracle {oracle_s:.1f}s, ranks {ranks_s:.1f}s [{CARD}]",
          flush=True)
    rec["driver"] = ranks[0]["driver"]
    res = [r["restore"] for r in ranks]
    for r in res:
        if not (r["blocks_equal"] and r["gathered_equal"]) \
                or r["cut_leaves"] == 0 or r["step"] != 5:
            raise AssertionError(f"elastic restore rank {r['coord']}: "
                                 f"{r}")
    rec["restore"] = res
    print(f"train mesh (d) elastic restore {cfg.name} L={cfg.n_layers} onto "
          f"(2, 2): every block equal to the saved slice, the gathered tree "
          f"equal to the saved one; {res[0]['cut_leaves']} of "
          f"{res[0]['leaves']} leaves cut; per rank "
          + ", ".join(f"{r['bytes'] / 1e9:.3f}" for r in res)
          + f" GB of {res[0]['whole_bytes'] / 1e9:.3f} GB, restored in "
          + ", ".join(f"{r['restore_s']:.2f}" for r in res)
          + f" s [{CARD}]", flush=True)
    return rec


def dp_argv(ckpt) -> list:
    """``launch.train``'s arguments of phase (b): 4 layers at full width,
    DP_STEPS steps of DP_BATCH x CDP_SEQ, checkpoints every DP_STOP
    steps."""
    return DP_MODEL_ARGS + [
        "--steps", str(DP_STEPS), "--batch", str(DP_BATCH), "--seq",
        str(CDP_SEQ), "--save-every", str(DP_STOP), "--log-every", "1",
        "--ckpt", ckpt]


def dp_driver_phase(dev, cfg, root, full) -> dict:
    """Phase (b): ``launch.train --ranks 4`` under deterministic
    algorithms (``launch_ranks`` passes the setting on).  The
    uninterrupted run (``full``: its last loss and seconds) ran in the (a)
    launch and checkpointed at DP_STOP and DP_STEPS under ``root/full``;
    its step-DP_STOP checkpoint, linked into a fresh directory, is resumed
    through ``launch.train.main`` with 4 ranks (a preempted run's restart:
    the same schedule, every rank restoring), whose step-DP_STEPS state
    must equal the uninterrupted run's (the checksum each driver checks
    equal across its ranks and records in the manifest); then one process
    over the whole batch, its last loss within 1e-2 relative and its
    params within 2·lr per step of the 4-rank run's."""
    from repro_torch.dist.checkpoint import read_manifest
    from repro_torch.launch import train as launch_train
    ranks = ["--ranks", str(TRAIN_MESH_RANKS)]
    ck = {k: os.path.join(root, k) for k in ("full", "resumed", "one")}
    losses, runs_s = {"full": full["loss"]}, {"full": full["s"]}
    stop = f"step_{DP_STOP:08d}"
    os.makedirs(os.path.join(ck["resumed"], stop))
    for name in os.listdir(os.path.join(ck["full"], stop)):
        os.link(os.path.join(ck["full"], stop, name),
                os.path.join(ck["resumed"], stop, name))
    torch.use_deterministic_algorithms(True)     # launch_ranks passes it on
    try:
        for name, extra in (("resumed", ranks),
                            ("one", ["--save-every", str(DP_STEPS)])):
            t0 = time.perf_counter()
            losses[name] = launch_train.main(dp_argv(ck[name]) + extra)
            runs_s[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    step_dir = f"step_{DP_STEPS:08d}"
    man = read_manifest(ck["full"], DP_STEPS)
    sums = [read_manifest(ck[k], DP_STEPS)["meta"]["checksum"]
            for k in ("full", "resumed")]
    if sums[0] != sums[1]:
        raise AssertionError(f"launch.train --ranks: the resumed run's "
                             f"state checksum {sums[1]} differs from the "
                             f"uninterrupted run's {sums[0]}")
    if losses["resumed"] != losses["full"]:
        raise AssertionError("launch.train --ranks: resumed last loss "
                             f"{losses['resumed']} != {losses['full']}")
    lr = 3e-3
    worst = 0.0
    for rec in man["leaves"]:
        if not rec["key"].startswith(".params"):
            continue
        a = np.load(os.path.join(ck["full"], step_dir, rec["file"]))
        b = np.load(os.path.join(ck["one"], step_dir, rec["file"]))
        worst = max(worst, float(np.abs(a - b).max()))
    if worst > 2 * lr * DP_STEPS:
        raise AssertionError(f"launch.train --ranks 4 vs one process: "
                             f"params {worst} apart")
    l4, l1 = losses["full"], losses["one"]
    if abs(l4 - l1) > 1e-2 * abs(l1):
        raise AssertionError(f"launch.train --ranks 4 vs one process: "
                             f"last loss {l4} vs {l1}")
    runs_s["compare"] = time.perf_counter() - t0
    rec = {"runs_s": runs_s, "last_loss": losses, "checksum": sums[0],
           "params_max_abs_vs_one": worst}
    print(f"train mesh (b) launch.train --ranks {TRAIN_MESH_RANKS} "
          f"{cfg.name} L={cfg.n_layers}, {DP_BATCH}x{CDP_SEQ} per step: "
          f"resumed from step {DP_STOP} equal bit for bit to the "
          f"uninterrupted run; last loss {l4:.6f} vs one process {l1:.6f}, "
          f"params within {worst:.2e}; "
          + ", ".join(f"{k} {v:.1f}s" for k, v in runs_s.items())
          + f" [{CARD}]", flush=True)
    return rec


def ep_phase(dev) -> dict:
    """Phase (c): phi3.5-moe at full width, 1 layer, on the (1, 4) mesh."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = _ep_cfg()
    full = init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn((EP_BATCH, EP_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    lp = full["layers"]["moe"]
    p = {"router": {"w": lp["router"]["w"][0].clone().requires_grad_()},
         **{k: lp[k][0].clone().requires_grad_() for k in EP_KEYS}}
    xx = x.clone().requires_grad_()
    for _ in range(2):              # the second call is timed
        for t in (xx, p["router"]["w"], *(p[k] for k in EP_KEYS)):
            t.grad = None
        _sync(dev)
        t0 = time.perf_counter()
        y = moe(p, xx, n_experts=cfg.n_experts, top_k=cfg.top_k,
                capacity_factor=EP_CF, activation=cfg.activation)
        y.sum().backward()
        _sync(dev)
        local_ms = 1e3 * (time.perf_counter() - t0)
    oracle = {"y": y.detach(), "x_grad": xx.grad,
              "router": p["router"]["w"].grad,
              **{k: p[k].grad for k in EP_KEYS}}
    del p, xx, y
    torch.cuda.empty_cache()
    opt = AdamWConfig(lr=3e-3, total_steps=10, warmup_steps=1)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=EP_SEQ, global_batch=EP_BATCH)
    batches = [device_batch(dcfg, s, dev) for s in range(2)]
    experts = sum(lp[k].numel() for k in EP_KEYS)
    # f32 params, m and v, the bf16 cast and its grads; E/4 experts a rank
    reckoned = _reckon("(c) EP train step", sum(
        t.numel() for t in tree_leaves(full)) - experts
        + experts // TRAIN_MESH_RANKS, 16, dev)
    t0 = time.perf_counter()
    ranks = launch_ranks(train_mesh_rank, TRAIN_MESH_RANKS, (dev.type, {
        "ep": dict(cfg=cfg, full=full, x=x, oracle=oracle, opt=opt,
                   batches=batches)},), device=dev,
        timeout_s=TRAIN_MESH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    del oracle
    torch.cuda.empty_cache()
    # the single-process steps on the whole tree (the local MoE path)
    state = init_train_state(full)
    step = make_train_step(cfg, opt)
    one_losses, one_norms = [], []
    for b in batches:
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        _sync(dev)
        one_ms = 1e3 * (time.perf_counter() - t0)
        one_losses.append(float(m["loss"]))
        one_norms.append(float(m["grad_norm"]))
    del state, full, m, batches
    torch.cuda.empty_cache()
    eps = [r["ep"] for r in ranks]
    for r, e in enumerate(eps):
        bad = {k: v for k, v in e["layer"]["rel_err"].items() if v > EP_TOL}
        if bad:
            raise AssertionError(f"EP layer rank {r}: {bad} past {EP_TOL} "
                                 "of max")
    _same([e["step"]["replicated_sum"] for e in eps],
          "EP train step replicated params")
    losses = _same([e["step"]["losses"] for e in eps],
                   "EP train step losses")
    norms = _same([e["step"]["grad_norms"] for e in eps],
                  "EP train step grad norms")
    for s, (loss, one) in enumerate(zip(losses, one_losses)):
        _finite(loss, f"EP train step {s} loss")
        if abs(loss - one) > 1e-2 * abs(one):
            raise AssertionError(f"EP train step {s} loss {loss} vs the "
                                 f"single process's {one}")
    rec = {"cfg": {"arch": cfg.name, "n_layers": cfg.n_layers,
                   "capacity_factor": EP_CF},
           "ranks": eps, "local_layer_ms": local_ms, "ranks_s": ranks_s,
           "reckoned_state_bytes_per_rank": reckoned,
           "losses": losses, "one_losses": one_losses, "grad_norms": norms,
           "one_grad_norms": one_norms, "one_step_ms": one_ms}
    lay = eps[0]["layer"]
    print(f"train mesh (c) EP {cfg.name} at full width: moe layer "
          f"{EP_BATCH}x{EP_SEQ} tokens on (1, {TRAIN_MESH_RANKS}), worst rel "
          f"err {max(max(e['layer']['rel_err'].values()) for e in eps):.2e}"
          f" of max; layer fwd+bwd "
          + ", ".join(f"{e['layer']['ms']:.1f}" for e in eps)
          + f" ms per rank (second call; local {local_ms:.1f} ms), "
          f"{lay['collectives']} collectives, {lay['a2a']} "
          f"all-to-alls of {lay['a2a_bytes']} B per rank; train step "
          f"L={cfg.n_layers} "
          + ", ".join(f"{e['step']['ms']:.1f}" for e in eps)
          + f" ms per rank (second step; {eps[0]['step']['params']} params"
          f" per rank, peak "
          f"{max(e['step']['peak_bytes'] for e in eps) / 1e9:.2f} GB, "
          f"{eps[0]['step']['collectives']} collectives of "
          f"{eps[0]['step']['bytes']} B), losses "
          + ", ".join(f"{x:.6f}" for x in losses) + " vs one process "
          + ", ".join(f"{x:.6f}" for x in one_losses)
          + f" ({one_ms:.1f} ms), replicated params bit-identical across "
          f"ranks; ranks {ranks_s:.1f}s [{CARD}]", flush=True)
    return rec


def training_mesh_phases(dev) -> dict:
    """Multi-device training on 4 ranks sharing the card (gloo; the
    collectives meet in the CUDA-IPC mailboxes): (a) the compressed DP
    step and (d) the elastic restore of minicpm-2b at full width, 4
    layers, and (b) ``launch.train --ranks 4`` (its uninterrupted run in
    the same rank launch); (c) the expert-parallel MoE of phi3.5-moe at
    full width; each phase's wall time."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    rec = {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        rec = {"parent_allocated_bytes": torch.cuda.memory_allocated(dev),
               "parent_reserved_bytes": torch.cuda.memory_reserved(dev),
               "device_free_bytes": free}
        print(f"training mesh phases: this process holds "
              f"{rec['parent_allocated_bytes'] / 1e9:.2f} GB "
              f"({rec['parent_reserved_bytes'] / 1e9:.2f} GB reserved), the "
              f"card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free "
              f"[{CARD}]", flush=True)
    import shutil
    import tempfile
    cfg = _mesh_cfg()
    (ROOT / "scratch").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=ROOT / "scratch", prefix="dp_")
    try:
        t0 = time.perf_counter()
        rec["compressed_restore"] = compressed_and_restore_phases(
            dev, cfg, dp_argv(os.path.join(root, "full")))
        rec["compressed_restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["dp_driver"] = dp_driver_phase(
            dev, cfg, root, rec["compressed_restore"]["driver"])
        rec["dp_driver_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    rec["ep"] = ep_phase(dev)
    rec["ep_s"] = time.perf_counter() - t0
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["b3_launches"] = rec["compressed_restore"]["b3_launches"]
    print(f"training mesh phases: {rec['phase_s']:.1f}s ((a)+(d) and (b)'s "
          f"uninterrupted run {rec['compressed_restore_s']:.1f}, the rest of "
          f"(b) {rec['dp_driver_s']:.1f}, (c) {rec['ep_s']:.1f}) [{CARD}]",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# the cost tooling and the FSDP × TP step (slice 14)
# ---------------------------------------------------------------------------

#: the FSDP × TP cell: minicpm-2b at full width and depth, global batch of
#: 8 x 64 tokens per step, 4 steps, on a (data, model) mesh of 4 gloo
#: ranks sharing the card; the one-process step takes it in 2
#: microbatches, each rank its 4 rows in one (a second microbatch's f32
#: grad accumulator is 2.7 GB more per rank, which 4 ranks beside this
#: process's own leftovers do not leave room for on one card)
FSDP_MESH = {"data": 2, "model": 2}
#: depth of the minicpm-2b FSDP × TP cell (of its 40 layers; cut for the
#: smoke's time, as its width, mesh and batch are not)
FSDP_LAYERS = 20
FSDP_BATCH, FSDP_SEQ, FSDP_MICRO, FSDP_STEPS = 8, 64, 2, 4
FSDP_RANK_MICRO = 1
FSDP_LR = 3e-3
#: bf16 steps against one process, as the training-mesh phases hold them:
#: the last loss within 1e-2 relative, params within 2·lr per step (Adam
#: divides each grad by its own size, so bf16 rounding that flips a tiny
#: grad moves its weight by up to 2·lr, and the next loss with it: step
#: 3's jumps by 2.0 in one process at this lr); the first loss, before any
#: update, within 1e-3 (the same weights through bf16 sums in another
#: order)
FSDP_LOSS_TOL, FSDP_FIRST_LOSS_TOL = 1e-2, 1e-3
FSDP_TIMEOUT_S = 600.0
#: phase 20's second part: one model of each of the MoE, ssm and hybrid
#: families at full width, cut in depth (PERF.md §4), trained by the
#: same mesh in one rank launch, FSDP_FAMILY_STEPS steps each; (label,
#: arch, layers, B3 launches per layer and microbatch on a rank: the MoE
#: model's 16 q and 16 kv heads are 8 and 8 per rank, the hybrid's
#: attention is MQA and rwkv6 has none; the dtype the ranks, the one
#: process and the ShapeMesh trace compute in).  Not bf16: so that the
#: ranks' gap to one process is rounding, far below what 3 Adam steps at
#: FSDP_LR move (in bf16 one process's third step jumps and the ranks'
#: sums in another order miss the jump).  rwkv6 in float64, as
#: tests/test_torch_fsdp_tp.py runs it: its grads are ill-conditioned
#: (the one process's own f32 grads lie ~2e-3 from its float64 grads;
#: :func:`fsdp_family_oracle` measures it)
FSDP_FAMILIES = (
    ("fsdp_moe", "moonshot-v1-16b-a3b", 2, 1, torch.float32),
    ("fsdp_ssm", "rwkv6-7b", 4, 0, torch.float64),
    ("fsdp_hybrid", "recurrentgemma-2b", 8, 0, torch.float32))
FSDP_FAMILY_STEPS = 3
#: their bounds: the first and every later loss relative to one
#: process's; the first moments after step 1 (the grads of step 1) per
#: leaf, sqrt(sum (rank - one)²) / sqrt(sum one²) over the 4 ranks'
#: blocks; the final params per leaf relative to how far the one process
#: moved them, sqrt(sum (rank - one)²) / sqrt(sum (one - init)²), and
#: each block within 2·lr per step of them, as the minicpm-2b cell.  The
#: params bound is loose: rwkv6's third step diverges in one process
#: (loss 11.5 -> 16.6) and the steps after a reordered sum follow it
#: less closely than its grads agree (PERF.md §6)
FSDP_FAMILY_FIRST_TOL, FSDP_FAMILY_LOSS_TOL = 1e-5, 1e-4
FSDP_FAMILY_M1_TOL, FSDP_FAMILY_PARAM_TOL = 1e-3, 5e-2
#: the controls (the initial params; the last batch's loss at them) must
#: miss the loss and param bounds by this factor, or the bounds could not
#: tell a rank that left its blocks where they started
FSDP_CONTROL_MARGIN = 10.0
#: the dry-run cells traced on meta in the cost phase
DRY_CELLS = [("train_4k", "single"), ("prefill_32k", "single"),
             ("decode_32k", "single"), ("decode_32k", "multi")]


def step_roofline(cfg, costs, kind, tokens, measured_ms, chips=1) -> dict:
    """The modeled roofline of one counted step (``launch.roofline`` with
    the H100 SXM's published figures) beside its measured wall time:
    roofline fraction = bound / measured."""
    from repro_torch.launch.roofline import model_flops, report_from_costs
    rep = report_from_costs(
        arch=cfg.name, shape=f"{kind}", mesh="one card", chips=chips,
        costs=costs, model_flops_total=model_flops(
            cfg.active_param_count(), tokens,
            "train" if kind == "train" else "serve"))
    bound_ms = 1e3 * rep.bound_time_s
    return {"flops": costs.dot_flops, "hbm_bytes": costs.hbm_bytes,
            "collective_bytes": costs.collective_bytes,
            "compute_ms": 1e3 * rep.compute_s,
            "memory_ms": 1e3 * rep.memory_s,
            "collective_ms": 1e3 * rep.collective_s,
            "dominant": rep.dominant, "bound_ms": bound_ms,
            "measured_ms": measured_ms,
            "roofline_fraction": bound_ms / measured_ms,
            "kernel_launches": costs.kernel_launches, "n_ops": costs.n_ops,
            "argument_bytes": costs.argument_bytes,
            "peak_temp_bytes": costs.peak_temp_bytes}


def _print_roofline(what, r):
    print(f"cost {what}: modeled {r['flops'] / 1e12:.4f} TFLOP, "
          f"{r['hbm_bytes'] / 1e9:.4f} GB HBM, "
          f"{r['collective_bytes'] / 1e9:.4f} GB collective -> compute "
          f"{r['compute_ms']:.4f} ms, memory {r['memory_ms']:.4f} ms, "
          f"collective {r['collective_ms']:.4f} ms, dominant "
          f"{r['dominant']}, bound {r['bound_ms']:.4f} ms (H100 SXM "
          f"published peaks); measured {r['measured_ms']:.3f} ms; roofline "
          f"fraction {r['roofline_fraction']:.5f}; {r['n_ops']} ops, "
          f"kernels {r['kernel_launches']} [{CARD}]", flush=True)


def cost_decode_phase(cfg, params, dev, serve, what="(a)") -> dict:
    """Cost phase ``what`` ((a): minicpm-2b's): one int4 decode step of
    the served tree at 8 slots under the step cost counter.  Its counted
    B1 launches must equal the wrapper's own count in that step and the
    kernel nodes of a CUDA graph of the step (the serve phase's
    ``graph_packed_kernels_per_step``); the modeled roofline is set
    beside the engine's measured step."""
    from repro_torch.launch.hlo_cost import count_costs
    split = split_layers(params)
    cache = init_cache(cfg, 8, 64, torch.float32, per_slot=True, device=dev)
    tok = torch.zeros((8, 1), dtype=torch.long, device=dev)
    costs, counts = _counted(dev, lambda: count_costs(
        decode_step, cfg, split, cache, tok, trip_counts=(cfg.n_layers,)))
    got = costs.kernel_launches.get("dequant_matmul_packed_int4", 0)
    want = {"wrapper": counts["b1"].get(4, 0),
            "graph": serve["graph_packed_kernels_per_step"],
            "per_layer": 7 * cfg.n_layers}
    if any(got != v for v in want.values()):
        raise AssertionError(f"cost {what}: the counter saw {got} B1 launches "
                             f"in a decode step, expected {want}")
    rec = step_roofline(cfg, costs, "decode", 8,
                        serve["decode_step_wall_ms"])
    rec.update(b1_counted=got, b1_expected=want,
               b1_traced=serve.get("traced_packed_kernels_per_step"))
    _print_roofline(f"{what} int4 decode step {cfg.name} L={cfg.n_layers} at "
                    f"8 slots (B1 {got} = wrapper {want['wrapper']} = CUDA "
                    f"graph {want['graph']}; profiler "
                    f"{rec['b1_traced']})", rec)
    return rec


def _dp_rows(batch, mesh):
    """This rank's rows of a global batch: its block along ``data``."""
    n, i = mesh.shape["data"], mesh.axis_index("data")
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def _fsdp_setup(cfg, dev, steps=FSDP_STEPS):
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import AdamWConfig
    opt = AdamWConfig(lr=FSDP_LR, schedule=cfg.lr_schedule,
                      total_steps=steps + 1, warmup_steps=1)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=FSDP_SEQ,
                      global_batch=FSDP_BATCH)
    return opt, [launch_train.device_batch(dcfg, s, dev)
                 for s in range(steps)]


def fsdp_tp_oracle(cfg, dev, path) -> dict:
    """The one-process bf16 step of the FSDP × TP cell from
    ``init_params(cfg, 0)``: step 1 under the step cost counter (cost
    phase (b): its counted B3 launches must be n_layers × n_micro), steps
    2-4 timed; the final params saved to ``path`` for the ranks' check."""
    from repro_torch.launch.hlo_cost import count_costs
    from repro_torch.train import init_train_state, make_train_step
    opt, batches = _fsdp_setup(cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(init_params(cfg, 0, device=dev))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    step = make_train_step(cfg, opt, n_micro=FSDP_MICRO)
    costs, counts = _counted(dev, lambda: count_costs(
        step, state, batches[0], trip_counts=(cfg.n_layers, FSDP_MICRO)))
    state, m = costs.result
    del costs.result                 # the state is 33 GB: keep one handle
    per_step = cfg.n_layers * FSDP_MICRO
    got = costs.kernel_launches.get("flash_attention", 0)
    if got != per_step or counts["flash"] != per_step:
        raise AssertionError(f"cost (b): the counter saw {got} B3 launches "
                             f"(the wrapper {counts['flash']}), expected "
                             f"{per_step}")
    losses = [_finite(m["loss"], "FSDP oracle step 1 loss")]
    walls, launches = [], [counts["flash"]]
    for s in range(1, FSDP_STEPS):
        _sync(dev)
        reset_flash_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        launches.append(flash_attention_cuda.launches)
        losses.append(_finite(m["loss"], f"FSDP oracle step {s + 1} loss"))
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    torch.save(state.params, path)
    save_s = time.perf_counter() - t0
    del state, m, batches
    torch.cuda.empty_cache()
    rec = {"losses": losses, "wall_ms": walls, "peak_bytes": peak,
           "b3_launches": launches, "params": n_params, "save_s": save_s,
           "cost": step_roofline(cfg, costs, "train",
                                 FSDP_BATCH * FSDP_SEQ,
                                 statistics.median(walls))}
    _print_roofline(f"(b) train step {cfg.name} L={cfg.n_layers}, "
                    f"{FSDP_BATCH}x{FSDP_SEQ} tokens in {FSDP_MICRO} "
                    f"microbatches, one process (B3 {got})", rec["cost"])
    print(f"fsdp x tp oracle: losses {', '.join(f'{x:.6f}' for x in losses)}"
          f"; steps 2-{FSDP_STEPS} {', '.join(f'{w:.1f}' for w in walls)} ms"
          f"; peak {peak / 1e9:.2f} GB; final params saved in "
          f"{save_s:.1f}s [{CARD}]", flush=True)
    return rec


def _fsdp_cfg():
    """minicpm-2b cut to FSDP_LAYERS: the FSDP × TP cell's model."""
    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=FSDP_LAYERS)


def fsdp_tp_rank(rank, kind, oracle_path) -> dict:
    """A rank of the FSDP × TP phase's minicpm-2b cell
    (:func:`_fsdp_rank_cell`)."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = _rank_device(kind)
    mesh = make_host_mesh(model_parallel=FSDP_MESH["model"], device=dev)
    out = _fsdp_rank_cell(rank, dev, mesh, _fsdp_cfg(), FSDP_STEPS,
                          oracle_path)
    mesh.close()
    return out


def fsdp_family_rank(rank, kind, cells) -> dict:
    """A rank of the FSDP × TP phase's second part: each (label, cfg,
    oracle path, dtype) of ``cells`` in turn on one mesh
    (:func:`_fsdp_rank_cell`), its state let go before the next."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = _rank_device(kind)
    mesh = make_host_mesh(model_parallel=FSDP_MESH["model"], device=dev)
    out = {}
    for label, cfg, path, dtype in cells:
        out[label] = _fsdp_rank_cell(rank, dev, mesh, cfg,
                                     FSDP_FAMILY_STEPS, path, dtype,
                                     _m_path(path))
        torch.cuda.empty_cache()
    mesh.close()
    return out


def _fsdp_rank_cell(rank, dev, mesh, cfg, steps, oracle_path,
                    dtype=torch.bfloat16, m_path=None) -> dict:
    """One FSDP × TP cell on this rank: its blocks of ``init_params(cfg,
    0)`` (each rank draws the whole tree from the same seed on the card,
    keeps its cut and waits for the others to drop theirs), ``steps``
    steps computed in ``dtype`` on its rows of each global batch, then
    leaf by leaf: the leaf gathered over the mesh and the block held
    equal to its ``NamedSharding`` cut of it, and the block to the same
    cut of the oracle's final params (read from ``oracle_path``,
    memory-mapped, and laid out as the blocks are: the mesh's heads, ff,
    experts and widths divide, so no leaf is padded, but the RG-LRU's
    ``w_in`` columns are reordered): the largest difference, and per leaf
    the sum of squared differences divided by the number of ranks that
    hold each entry (summed over the ranks: the whole leaf's).  Where
    ``m_path`` is given, the same sums for Adam's first moments after
    step 1 (a tenth of the step's grads) against the oracle's there."""
    from repro_torch.dist.sharding import (NamedSharding, use_layout,
                                           use_mesh)
    from repro_torch.models import fsdp_tp_blocks, fsdp_tp_layout
    from repro_torch.train import init_train_state, make_train_step
    lay = fsdp_tp_layout(cfg, mesh)
    opt, batches = _fsdp_setup(cfg, dev, steps)
    full = init_params(cfg, 0, device=dev)
    blocks = fsdp_tp_blocks(cfg, full, lay)
    del full
    torch.cuda.empty_cache()
    # no rank steps while another still holds its whole tree
    torch.distributed.barrier()
    _reset_peak(dev)
    state = init_train_state(blocks)
    step = make_train_step(cfg, opt, n_micro=FSDP_RANK_MICRO,
                           compute_dtype=dtype)
    losses, walls, launches, per_step = [], [], [], []
    first_log = None
    with use_mesh(mesh), use_layout(lay):
        for s in range(steps):
            rows = _dp_rows(batches[s], mesh)
            start = len(mesh.log)
            _sync(dev)
            reset_flash_launches()
            t0 = time.perf_counter()
            state, m = step(state, rows)
            _sync(dev)
            walls.append(1e3 * (time.perf_counter() - t0))
            launches.append(flash_attention_cuda.launches)
            losses.append(float(m["loss"]))
            log = mesh.log[start:]
            per_step.append((len(log), sum(r[3] for r in log)))
            if first_log is None:
                first_log = [tuple(r) for r in log]
            if s == 0 and m_path is not None:
                sq_m = _leaf_sq(cfg, lay, state.opt.m, m_path, dev)
        peak = _peak(dev)
        del m, rows, batches
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        oracle = tree_leaves(_laid_out(cfg, lay, oracle_path))
        pairs = []
        tree_map_with_path(lambda path, b, spec: pairs.append(
            (path, b, spec)), state.params, lay.specs)
        worst, n_cut, sq = 0.0, 0, {}
        for (path, blk, spec), want in zip(pairs, oracle):
            cut = NamedSharding(mesh, spec)
            one = cut.gather(blk)
            if not torch.equal(cut.block(one), blk):
                raise AssertionError(f"rank {rank}: a block differs from its"
                                     " cut of the gathered leaf")
            copies = mesh.size * blk.numel() / one.numel()
            del one
            n_cut += any(e is not None for e in spec)
            # every rank checks its own block: together, the whole tree
            diff = blk - cut.block(want).to(dev)
            worst = max(worst, float(diff.abs().max()))
            sq[path] = float(torch.linalg.vector_norm(diff)) ** 2 / copies
            del diff
        check_s = time.perf_counter() - t0
    out = {"rank": rank, "losses": losses, "wall_ms": walls,
           "b3_launches": launches, "collectives_per_step": per_step,
           "log": first_log, "peak_bytes": peak, "backend": mesh.backend,
           "staging": mesh.staging, "params_max_abs_vs_oracle": worst,
           "leaves": len(pairs), "leaves_cut": n_cut, "check_s": check_s,
           "block_params": sum(b.numel() for _, b, _ in pairs),
           "sq_vs_oracle": sq}
    if m_path is not None:
        out["sq_m1_vs_oracle"] = sq_m
    del state, oracle, pairs
    return out


def _laid_out(cfg, lay, path):
    """The whole tree saved at ``path`` (memory-mapped) laid out as the
    blocks are (``models.transformer._repad``)."""
    return tfm._repad(cfg, lay, torch.load(path, mmap=True,
                                           map_location="cpu"),
                      inverse=False)


def _leaf_sq(cfg, lay, blocks, path, dev) -> dict:
    """Per leaf of this rank's ``blocks``: the sum of squared differences
    to its cut of the tree saved at ``path``, divided by the number of
    ranks that hold each entry."""
    from repro_torch.dist.sharding import NamedSharding
    mesh = lay.mesh
    out = {}

    def leaf(path, blk, spec, whole):
        cut = NamedSharding(mesh, spec)
        n = mesh.size
        for entry in spec:
            for axis in (() if entry is None else (entry,)
                         if isinstance(entry, str) else entry):
                n //= mesh.shape[axis]
        out[path] = float(torch.linalg.vector_norm(
            blk - cut.block(whole).to(dev))) ** 2 / n
    tree_map_with_path(leaf, blocks, lay.specs, _laid_out(cfg, lay, path))
    return out


def fsdp_tp_phase(dev) -> dict:
    """minicpm-2b at full width and depth trained FSDP × TP on a (data =
    2, model = 2) mesh of 4 gloo ranks sharing the card (CUDA-IPC
    mailboxes): the one-process oracle first (and alone: its 56 GB do not
    fit beside the ranks), then the ranks; held: each step's loss and the
    final params within the bf16 tolerances, every block equal to its cut
    of the gathered tree, B3 n_layers × n_micro per rank per step, and
    each rank's collective log of step 1 equal op for op to the cost
    counter's trace of that rank's step on meta tensors under
    ``ShapeMesh(data=2, model=2)``."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.mesh import launch_ranks
    t_phase = time.perf_counter()
    # the earlier rank launches' shared CUDA tensors are kept for their
    # consumers until collected, as is any garbage in reference cycles
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"fsdp x tp phase: this process holds "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"({torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved) "
          f"[{CARD}]", flush=True)
    cfg = _fsdp_cfg()
    (ROOT / "scratch").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=ROOT / "scratch", prefix="fsdp_")
    try:
        path = os.path.join(root, "oracle_params.pt")
        rec = {"oracle": fsdp_tp_oracle(cfg, dev, path)}
        rec["oracle_s"] = time.perf_counter() - t_phase
        n = FSDP_MESH["data"] * FSDP_MESH["model"]
        _reckon(f"fsdp x tp {cfg.name} L={cfg.n_layers} on {FSDP_MESH}",
                rec["oracle"]["params"] // n, 16, dev)
        t0 = time.perf_counter()
        ranks = launch_ranks(fsdp_tp_rank, n, (dev.type, path), device=dev,
                             timeout_s=FSDP_TIMEOUT_S)
        rec["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec.update(_check_fsdp_cell("fsdp x tp", cfg, ranks,
                                rec["oracle"]["losses"], FSDP_STEPS,
                                cfg.n_layers * FSDP_RANK_MICRO))
    rec["b3_launches"] += sum(rec["oracle"]["b3_launches"])
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"fsdp x tp phase: {rec['phase_s']:.1f}s (oracle "
          f"{rec['oracle_s']:.1f}, ranks {rec['ranks_s']:.1f}) [{CARD}]",
          flush=True)
    return rec


def _shape_mesh_log(cfg, rank, dtype=torch.bfloat16) -> list:
    """The collective log of the cost counter's trace of FSDP × TP rank
    ``rank``'s step (computed in ``dtype``) on meta tensors under
    ``ShapeMesh(data=2, model=2)``."""
    from repro_torch.dist.sharding import ShapeMesh, use_layout, use_mesh
    from repro_torch.launch.hlo_cost import count_costs
    from repro_torch.models import fsdp_tp_blocks, fsdp_tp_layout
    from repro_torch.train import init_train_state, make_train_step
    opt, _ = _fsdp_setup(cfg, torch.device("cpu"), 1)
    mesh = ShapeMesh(FSDP_MESH, rank=rank)
    lay = fsdp_tp_layout(cfg, mesh)
    state = init_train_state(fsdp_tp_blocks(
        cfg, init_params(cfg, device="meta"), lay))
    rows = {k: torch.empty((FSDP_BATCH // FSDP_MESH["data"], FSDP_SEQ),
                           dtype=torch.int32, device="meta")
            for k in ("tokens", "targets")}
    with use_mesh(mesh), use_layout(lay):
        count_costs(make_train_step(cfg, opt, n_micro=FSDP_RANK_MICRO,
                                    compute_dtype=dtype),
                    state, rows, mesh=mesh)
    return list(mesh.log)


def fsdp_family_traces(cells) -> dict:
    """:func:`_shape_mesh_log` of every rank of each (label, cfg, dtype)
    of ``cells``: label -> the 4 ranks' logs (run in a host process of
    its own beside the oracles, :func:`start_host_job`)."""
    n = FSDP_MESH["data"] * FSDP_MESH["model"]
    return {label: [_shape_mesh_log(cfg, r, dtype) for r in range(n)]
            for label, cfg, dtype in cells}


def _check_fsdp_cell(what, cfg, ranks, want, steps, b3_per_step,
                     dtype=torch.bfloat16,
                     tols=(FSDP_FIRST_LOSS_TOL, FSDP_LOSS_TOL),
                     traces=None) -> dict:
    """Hold each rank's run of one FSDP × TP cell: B3 ``b3_per_step``
    launches in every step, its collective log of step 1 equal op for op
    to the cost counter's trace of that rank's step 1 (computed in
    ``dtype``; :func:`_shape_mesh_log`, or the rank's log in ``traces``),
    its first and last losses within ``tols`` (relative) of the
    one-process run's ``want`` losses and its final blocks within 2·lr
    per step of the one-process params; print each rank's step ms
    (median of steps 2 on), collectives and bytes per step and peak.
    Returns the ranks' records (logs left out) and their B3 launches."""
    bound = 2 * FSDP_LR * steps
    for r in ranks:
        if set(r["b3_launches"]) != {b3_per_step}:
            raise AssertionError(f"{what} rank {r['rank']}: B3 launches "
                                 f"{r['b3_launches']} per step, expected "
                                 f"{b3_per_step}")
        log = _shape_mesh_log(cfg, r["rank"], dtype) if traces is None \
            else [tuple(x) for x in traces[r["rank"]]]
        if log != r["log"]:
            diff = next((i for i, (a, b) in enumerate(zip(log, r["log"]))
                         if a != b), min(len(log), len(r["log"])))
            raise AssertionError(
                f"{what} rank {r['rank']}: {len(r['log'])} collectives in "
                f"step 1, the ShapeMesh trace {len(log)}; first "
                f"difference at {diff}")
    for r in ranks:
        step_ms = statistics.median(r["wall_ms"][1:])
        n_coll, n_bytes = r["collectives_per_step"][0]
        print(f"{what} rank {r['rank']} ({r['backend']}, staging "
              f"{r['staging']}): step {step_ms:.1f} ms (median of steps "
              f"2-{steps}; all {', '.join(f'{w:.1f}' for w in r['wall_ms'])}"
              f"), {n_coll} collectives and {n_bytes / 1e9:.4f} GB per step "
              f"(equal op for op to the ShapeMesh trace), peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB, B3 {r['b3_launches'][0]} per "
              f"step, losses {', '.join(f'{x:.6f}' for x in r['losses'])} "
              f"(one process {', '.join(f'{x:.6f}' for x in want)}), params"
              f" within {r['params_max_abs_vs_oracle']:.3e} (bound "
              f"{bound:.1e}), {r['leaves_cut']} of {r['leaves']} leaves cut,"
              f" blocks equal to their cuts ({r['check_s']:.1f}s) [{CARD}]",
              flush=True)
    first_tol, last_tol = tols
    for r in ranks:
        got = r["losses"]
        if abs(got[0] - want[0]) > first_tol * abs(want[0]) \
                or abs(got[-1] - want[-1]) > last_tol * abs(want[-1]):
            raise AssertionError(f"{what} rank {r['rank']}: losses {got}"
                                 f" vs one process {want}")
        if r["params_max_abs_vs_oracle"] > bound:
            raise AssertionError(f"{what} rank {r['rank']}: params "
                                 f"{r['params_max_abs_vs_oracle']} from the "
                                 f"one-process step's (bound {bound})")
    return {"per_rank": {r["rank"]: {k: v for k, v in r.items()
                                     if k != "log"} for r in ranks},
            "b3_launches": sum(sum(r["b3_launches"]) for r in ranks)}


def _check_family_cell(what, ranks, oracle) -> dict:
    """The family cells' bounds beyond :func:`_check_fsdp_cell`'s, and
    their controls.  Every step's loss within FSDP_FAMILY_LOSS_TOL of
    one process's; each leaf's first moments after step 1 over the 4
    ranks' blocks within FSDP_FAMILY_M1_TOL of their size; its final
    params within FSDP_FAMILY_PARAM_TOL of how far the one process moved
    them.  Controls: the initial params (a rank that did not update) and
    zero moments (one that took no grads) lie at distance 1 by these
    measures, and the last batch's loss at the initial params must miss
    the loss bound; all by FSDP_CONTROL_MARGIN."""
    want = oracle["losses"]

    def relative(key, norms):
        dist = {p: sum(r[key][p] for r in ranks) for p in norms}
        rel = {p: (math.sqrt(dist[p] / n) if n > 0
                   else 0.0 if dist[p] == 0 else math.inf)
               for p, n in norms.items()}
        return rel, math.sqrt(sum(dist.values()) / sum(norms.values()))
    rel, whole = relative("sq_vs_oracle", oracle["sq_moved"])
    worst = max(rel, key=rel.get)
    rel_m, whole_m = relative("sq_m1_vs_oracle", oracle["sq_m1"])
    worst_m = max(rel_m, key=rel_m.get)
    loss_gap = max(abs(g - w) / abs(w) for r in ranks
                   for g, w in zip(r["losses"], want))
    ctrl_gap = abs(oracle["control_loss"] - want[-1]) / abs(want[-1])
    rec = {"params_rel_whole": whole, "params_rel_worst": rel[worst],
           "params_rel_worst_leaf": worst, "params_rel": rel,
           "m_rel_whole": whole_m, "m_rel_worst": rel_m[worst_m],
           "m_rel_worst_leaf": worst_m, "m_rel": rel_m,
           "loss_rel_worst": loss_gap,
           "control_loss": oracle["control_loss"],
           "control_loss_rel": ctrl_gap,
           "control_params_max_abs": oracle["moved_max_abs"]}
    print(f"{what}: every step's loss within {loss_gap:.3e} of one "
          f"process's (bound {FSDP_FAMILY_LOSS_TOL:.0e}); params at "
          f"{whole:.3e} of the one process's movement over the tree, "
          f"worst leaf {worst} {rel[worst]:.3e} (bound "
          f"{FSDP_FAMILY_PARAM_TOL:.0e}); step 1's first moments at "
          f"{whole_m:.3e} of their size, worst leaf {worst_m} "
          f"{rel_m[worst_m]:.3e} (bound {FSDP_FAMILY_M1_TOL:.0e}); controls:"
          f" the initial params and zero moments at"
          f" 1 (largest movement {oracle['moved_max_abs']:.3e}), the last "
          f"batch's loss at them {oracle['control_loss']:.6f} against "
          f"{want[-1]:.6f}, {ctrl_gap:.3e} relative "
          f"({ctrl_gap / FSDP_FAMILY_LOSS_TOL:.1f} x the bound) [{CARD}]",
          flush=True)
    if loss_gap > FSDP_FAMILY_LOSS_TOL:
        raise AssertionError(f"{what}: a step's loss {loss_gap} (relative)"
                             f" from one process's")
    if rel_m[worst_m] > FSDP_FAMILY_M1_TOL:
        raise AssertionError(f"{what}: leaf {worst_m}'s step-1 moments at "
                             f"{rel_m[worst_m]} of their size from the one "
                             f"process's")
    if rel[worst] > FSDP_FAMILY_PARAM_TOL:
        raise AssertionError(f"{what}: leaf {worst} at {rel[worst]} of the "
                             f"one process's movement from its params")
    if 1.0 < FSDP_CONTROL_MARGIN * max(FSDP_FAMILY_PARAM_TOL,
                                      FSDP_FAMILY_M1_TOL) \
            or ctrl_gap < FSDP_CONTROL_MARGIN * FSDP_FAMILY_LOSS_TOL:
        raise AssertionError(f"{what}: the control misses the bounds by "
                             f"less than {FSDP_CONTROL_MARGIN}x (loss "
                             f"{ctrl_gap})")
    return rec


def _save_unchecked(tree, path):
    """``torch.save`` without the zip records' CRC-32 (a third of the
    family oracles' save time): the file lives for one phase on this
    machine, read back by the ranks."""
    torch.serialization.set_crc32_options(False)
    try:
        torch.save(tree, path)
    finally:
        torch.serialization.set_crc32_options(True)


def _m_path(path):
    """Where a family oracle saves Adam's first moments beside its params
    at ``path``."""
    return path.replace(".pt", ".m.pt")


def fsdp_family_oracle(cfg, dev, path, dtype) -> dict:
    """The one-process run of a family cell from ``init_params(cfg, 0)``,
    computed in ``dtype``: FSDP_FAMILY_STEPS steps in FSDP_MICRO
    microbatches (each of the same rows as one rank's one microbatch: a
    MoE call's capacity and drops depend on its rows), timed; the final
    params saved to ``path``, and Adam's first moments after step 1
    beside them (:func:`_m_path`) with each leaf's sum of squares.  Also
    the controls: the last batch's loss at the initial params, and how
    far the steps moved each leaf (its sum of squares and the largest
    entry).  A float64 cell also measures why: the relative
    distance of the first batch's f32 grads at the initial params to
    its float64 grads, per leaf."""
    from repro_torch.train import (init_train_state, make_train_step,
                                   microbatch_grads)
    steps = FSDP_FAMILY_STEPS
    opt, batches = _fsdp_setup(cfg, dev, steps)
    torch.cuda.empty_cache()
    _reset_peak(dev)
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, 0, device=dev))
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    per = FSDP_BATCH // FSDP_MICRO
    with torch.no_grad():
        control = statistics.fmean(float(tfm.loss_fn(
            cfg, state.params, {k: v[i * per:(i + 1) * per]
                                for k, v in batches[-1].items()}))
            for i in range(FSDP_MICRO))
    f32_vs_f64 = None
    if dtype == torch.float64:
        grads = [dict(tree_leaves_with_path(microbatch_grads(
            cfg, state.params, batches[0], FSDP_MICRO, d)[1]))
            for d in (torch.float32, torch.float64)]
        f32_vs_f64 = {p: float(torch.linalg.vector_norm(g - grads[1][p])
                               / torch.linalg.vector_norm(grads[1][p]))
                      for p, g in grads[0].items()}
        del grads
    start = {p: t.clone() for p, t in tree_leaves_with_path(state.params)}
    step = make_train_step(cfg, opt, n_micro=FSDP_MICRO,
                           compute_dtype=dtype)
    losses, walls, launches = [], [], []
    for s in range(steps):
        _sync(dev)
        reset_flash_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        _sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        launches.append(flash_attention_cuda.launches)
        losses.append(_finite(m["loss"], f"{cfg.name} oracle step {s + 1} "
                              "loss"))
        if s == 0:
            t0 = time.perf_counter()
            _save_unchecked(state.opt.m, _m_path(path))
            save_s = time.perf_counter() - t0
            m_sq = {p: float(torch.linalg.vector_norm(t)) ** 2
                    for p, t in tree_leaves_with_path(state.opt.m)}
    peak = _peak(dev)
    moved, moved_max = {}, 0.0
    for p, t in tree_leaves_with_path(state.params):
        d = t - start.pop(p)
        moved[p] = float(torch.linalg.vector_norm(d)) ** 2
        moved_max = max(moved_max, float(d.abs().max()))
        del d
    t0 = time.perf_counter()
    _save_unchecked(state.params, path)
    save_s += time.perf_counter() - t0
    del state, m, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_ms": walls, "peak_bytes": peak,
            "b3_launches": launches, "params": n_params, "init_s": init_s,
            "save_s": save_s, "control_loss": control, "sq_moved": moved,
            "moved_max_abs": moved_max, "sq_m1": m_sq,
            "grads_f32_vs_f64": f32_vs_f64}


def fsdp_family_phase(dev) -> dict:
    """Phase 20's second part: the MoE, ssm and hybrid families of
    FSDP_FAMILIES at full width, cut in depth, trained FSDP × TP by the
    (data = 2, model = 2) mesh of 4 gloo ranks
    sharing the card.  Each model's one-process oracle runs first, alone,
    its final params saved; then ONE rank launch trains the models in
    turn; each rank's run of each model is held as the minicpm-2b cell's
    (:func:`_check_fsdp_cell`, at the family bounds) and by
    :func:`_check_family_cell`.  Every cell is checked before a failure
    is raised."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.mesh import launch_ranks
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    cells = [(label, dataclasses.replace(get_config(arch), n_layers=layers),
              per_layer, dtype)
             for label, arch, layers, per_layer, dtype in FSDP_FAMILIES]
    n = FSDP_MESH["data"] * FSDP_MESH["model"]
    # the ranks' ShapeMesh traces take the host ~20 s: beside the oracles
    trace_job = start_host_job("chip_smoke:fsdp_family_traces",
                               [(label, cfg, dtype)
                                for label, cfg, _, dtype in cells])
    (ROOT / "scratch").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=ROOT / "scratch", prefix="fsdp_fam_")
    rec, jobs = {}, []
    try:
        for label, cfg, _, dtype in cells:
            t0 = time.perf_counter()
            path = os.path.join(root, f"{label}.pt")
            # deterministic, as the ranks run (``_rank_device``)
            torch.use_deterministic_algorithms(True)
            try:
                oracle = fsdp_family_oracle(cfg, dev, path, dtype)
            finally:
                torch.use_deterministic_algorithms(False)
            rec[label] = {"arch": cfg.name, "n_layers": cfg.n_layers,
                          "dtype": str(dtype), "oracle": oracle}
            rec[label]["oracle_s"] = time.perf_counter() - t0
            o = rec[label]["oracle"]
            print(f"{label} {cfg.name} L={cfg.n_layers} oracle: "
                  f"{o['params']} params, {dtype}, "
                  f"losses {', '.join(f'{x:.6f}' for x in o['losses'])}; "
                  f"steps {', '.join(f'{w:.1f}' for w in o['wall_ms'])} ms;"
                  f" B3 {o['b3_launches']}; peak "
                  f"{o['peak_bytes'] / 1e9:.2f} GB; "
                  f"{rec[label]['oracle_s']:.1f}s (save {o['save_s']:.1f})"
                  f" [{CARD}]", flush=True)
            if o["grads_f32_vs_f64"]:
                g = o["grads_f32_vs_f64"]
                top = max(g, key=g.get)
                print(f"{label}: its f32 grads of batch 1 at the initial "
                      f"params from its float64 grads: median leaf "
                      f"{statistics.median(g.values()):.3e}, worst {top} "
                      f"{g[top]:.3e} (relative)", flush=True)
            jobs.append((label, cfg, path, dtype))
        t0 = time.perf_counter()
        ranks = launch_ranks(fsdp_family_rank, n, (dev.type, jobs),
                             device=dev, timeout_s=FSDP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    traces, traces_s = finish_host_job(trace_job)
    b3, failed = 0, []
    for label, cfg, per_layer, dtype in cells:
        what = f"{label} {cfg.name} L={cfg.n_layers}"
        per_rank = [r[label] for r in ranks]
        o = rec[label]["oracle"]
        checks = (lambda: _check_fsdp_cell(
            what, cfg, per_rank, o["losses"], FSDP_FAMILY_STEPS,
            cfg.n_layers * per_layer * FSDP_RANK_MICRO, dtype,
            (FSDP_FAMILY_FIRST_TOL, FSDP_FAMILY_LOSS_TOL), traces[label]),
            lambda: _check_family_cell(what, per_rank, o))
        for check in checks:
            try:
                rec[label].update(check())
            except AssertionError as e:
                failed.append(str(e))
                print(f"{what}: FAILED {e}", flush=True)
        b3 += sum(sum(r["b3_launches"]) for r in per_rank) \
            + sum(o["b3_launches"])
    if failed:
        raise AssertionError("; ".join(failed))
    rec["b3_launches"] = b3
    rec["ranks_s"], rec["traces_s"] = ranks_s, traces_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"fsdp x tp families phase: {rec['phase_s']:.1f}s (ranks "
          f"{ranks_s:.1f}; ShapeMesh traces {traces_s:.1f} on the host "
          f"beside them) [{CARD}]", flush=True)
    return rec


def cost_mesh_phase(cfg, mesh_rec) -> dict:
    """Cost phase (c): the counter's trace of one rank's int4 decode step
    of the mesh serve (the tree sharded 4 ways, 8 slots, max_len 64, f32
    cache) on meta tensors under ``ShapeMesh(data=1, model=4)`` must log
    what each real rank's ``HostMesh`` logged in its measured step."""
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.launch.hlo_cost import count_costs
    from repro_torch.serve import (build_sharded_decode_fns, local_view,
                                   shard_params_tree)
    tree = shard_params_tree(quantize_for_wbits(
        init_params(cfg, device="meta"), 4), MESH_RANKS)
    tok = torch.empty((8, 1), dtype=torch.long, device="meta")
    rec = {}
    for rank, log in sorted(mesh_rec["step_logs"].items()):
        mesh = ShapeMesh({"data": 1, "model": MESH_RANKS}, rank=rank)
        step_fn, _ = build_sharded_decode_fns(cfg, tree, mesh)
        cache = step_fn.init_cache(cfg, 8, 64, torch.float32, per_slot=True,
                                   device="meta")
        # on the per-layer views, as the engine calls its dispatch
        costs = count_costs(lambda p, c, t: step_fn(split_layers(p), c, t),
                            local_view(tree, mesh), cache, tok, mesh=mesh)
        if [tuple(r) for r in mesh.log] != [tuple(r) for r in log]:
            raise AssertionError(f"cost (c): rank {rank} logged {len(log)} "
                                 f"collectives, the ShapeMesh trace "
                                 f"{len(mesh.log)}, not the same")
        rec[rank] = {"collectives": costs.n_collectives,
                     "collective_bytes": costs.collective_bytes,
                     "b1": costs.kernel_launches}
    r0 = rec[0]
    print(f"cost (c) mesh serve {cfg.name} L={cfg.n_layers}, "
          f"{MESH_RANKS} ranks: the ShapeMesh trace logs "
          f"{r0['collectives']} with {r0['collective_bytes']:.0f} B per "
          f"rank per step, B1 {r0['b1']}: equal op for op to every rank's "
          f"HostMesh log [{CARD}]", flush=True)
    return rec


def start_dryrun_cells(out) -> subprocess.Popen:
    """Cost phase (d), started: the dry run's cells of minicpm-2b at full
    width traced on meta tensors under the production meshes (256 and 512
    ranks) by ``launch.dryrun.run_cell`` in a process of their own, on the
    host's CPU while the kernels build (it needs no card); stopped at exit
    if it still runs."""
    import atexit
    code = ("from repro_torch.launch.dryrun import run_cell\n"
            f"for shape, mesh in {DRY_CELLS!r}:\n"
            f"    run_cell({TRAIN_ARCH!r}, shape, mesh, out_dir={str(out)!r},"
            " force=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def cost_dryrun_phase(proc, out) -> dict:
    """Cost phase (d), read: each cell ``ok`` with its dominant term."""
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"cost (d): the dry run exited "
                             f"{proc.returncode}: {err[-3000:]}")
    rec = {}
    for shape, mesh in DRY_CELLS:
        r = json.loads((Path(out) / f"{TRAIN_ARCH}__{shape}__{mesh}.json")
                       .read_text())
        if r["status"] != "ok":
            raise AssertionError(f"cost (d): dry-run cell {shape} {mesh}: "
                                 f"{r.get('error')}")
        rec[f"{shape}__{mesh}"] = {
            k: r[k] for k in ("status", "dominant", "bound_time_s",
                              "roofline_fraction", "chips", "n_micro",
                              "collective_counts", "kernel_launches",
                              "memory_analysis", "elapsed_s") if k in r}
        print(f"cost (d) dry run {TRAIN_ARCH} {shape} {mesh} ({r['chips']} "
              f"ranks, traced on meta in {r['elapsed_s']}s): "
              f"{r['status']}, dominant {r['dominant']}, bound "
              f"{r['bound_time_s']:.4f} s, roofline fraction "
              f"{r['roofline_fraction']:.4f} (modeled, H100 SXM published "
              f"peaks)", flush=True)
    return rec


def tc_sass_check() -> dict:
    """HGMMA instructions (Hopper's warpgroup products) in the SASS of the
    tensor-core kernels of B1 and B2 (``kernel_bench.sass_counts``):
    fails on a source whose tensor-core kernels hold none."""
    import kernel_bench
    counts = {}
    for stem in ("dequant_int8", "dequant_packed"):
        lib = _build._target(_build.sources()[stem])
        per_fn = {fn: c for fn, c in kernel_bench.sass_counts(
            lib, opcode="HGMMA").items() if "tc_kernel" in fn}
        if not per_fn or min(per_fn.values()) == 0:
            raise AssertionError(f"{stem}: tensor-core kernels without "
                                 f"HGMMA in their SASS: {per_fn}")
        counts[stem] = per_fn
        print(f"sass {stem}: HGMMA per tensor-core kernel "
              f"{sorted(per_fn.values())}", flush=True)
    return counts


def sum_tc(node) -> dict:
    """Tensor-core launches by nbits summed over every ``tc_launches``
    record under ``node`` (the prefill, encode and serve runs')."""
    out = {}
    if isinstance(node, dict):
        for key, val in node.items():
            if key == "tc_launches" and isinstance(val, dict):
                for nb, c in val.items():
                    out[nb] = out.get(nb, 0) + c
            else:
                for nb, c in sum_tc(val).items():
                    out[nb] = out.get(nb, 0) + c
    elif isinstance(node, (list, tuple)):
        for val in node:
            for nb, c in sum_tc(val).items():
                out[nb] = out.get(nb, 0) + c
    return out


T_START = time.perf_counter()
#: each top-level phase's wall time, in the order run (``timed``)
PHASE_S: dict = {}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``; its wall time is kept in PHASE_S and printed
    beside the smoke's time so far."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f}s; smoke so far "
          f"{time.perf_counter() - T_START:.1f}s", flush=True)
    return out
#: ``nvidia-smi``'s name and power limit of the card, set by ``main``;
#: every report line of the slice-7 phases carries it
CARD = "card not read"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    global CARD
    CARD = smi.stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    dry = start_dryrun_cells(out / "dryrun_torch")
    took = timed("build", _build.build_all)
    print(f"build: {json.dumps(took)}", flush=True)
    for stem in _build.sources():
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}:", line.strip())
    hgmma = tc_sass_check()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # half a second of matmuls so the first timed case finds the clocks up
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        a = torch.tanh(a @ a)
    torch.cuda.synchronize(dev)
    del a

    cases = timed("kernel", kernel_phase, dev, gen)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    int8_cases = timed("int8 kernel", int8_phase, dev, gen, flush)
    prefill_kernels = timed("prefill kernel", prefill_kernel_phase, dev, gen,
                            flush)
    zsic = timed("zsic kernel", zsic_phase, dev, flush)
    flash_cases = timed("flash kernel", flash_phase, dev, gen, flush)
    del flush

    cfg = get_config("minicpm-2b")
    serve, params = timed("serve", serve_path, cfg, 4, dev, n_req=8,
                          prompt_len=32, new_tokens=16, max_len=64, slots=8,
                          chunk=16)
    serve.update(timed("step breakdown", step_breakdown, cfg, params, dev, 8,
                       64, cases))
    serve["cost"] = timed("cost (a)", cost_decode_phase, cfg, params, dev,
                          serve)
    busy = serve["device_busy_ms_per_step"]
    print(f"step breakdown: decode step {serve['decode_step_wall_ms']:.3f} "
          f"ms wall ({serve['decode_step_wall_ms_stacked']:.3f} ms with the "
          f"stacked tree), traced step {serve['traced_step_wall_ms']:.3f} ms "
          "wall, device busy "
          + ("not measured (no device activity in the trace)" if busy is None
             else f"{busy:.3f} ms (idle share "
                  f"{serve['device_idle_share']:.4f}; packed kernels "
                  f"{serve['traced_packed_ms_per_step']:.3f} ms device in "
                  f"{serve['traced_packed_kernels_per_step']:.0f} traced "
                  f"launches per step ({serve['graph_packed_kernels_per_step']}"
                  f" in a CUDA graph of the step), gemm "
                  f"{serve['traced_gemm_ms_per_step']:.3f}, other "
                  f"{serve['traced_other_ms_per_step']:.3f} ms; "
                  f"{serve['device_activities_per_step']:.0f} activities)")
          + f", unembed {serve['unembed_ms']:.5f} ms device, packed kernels "
          f"(kernel phase) {serve['packed_kernels_ms_per_step']:.5f} ms "
          "device", flush=True)
    serve["prefill"] = timed("prefill", prefill_phase, cfg, params, "int4",
                             dev)
    obs_serve = timed("obs serve", obs_serve_phase, cfg, params, dev, out,
                      n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                      slots=8, chunk=16, ladder_layers=4)
    if obs_serve["ladder"]["int4_packed"]["tokens"] != serve["tokens"]:
        raise AssertionError("the obs serve run's traffic differs from the "
                             "serve phase's")
    del params
    torch.cuda.empty_cache()
    traffic = dict(n_req=8, prompt_len=32, new_tokens=16, max_len=64,
                   slots=8, chunk=16)
    t0 = time.perf_counter()
    # the resilience layer and the int8 cache are per-layer seams: held at
    # a cut depth, the serve cell's traffic unchanged
    check_cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    params = quantize_for_wbits(init_params(check_cfg, 0, device=dev), 4)
    resilience = timed("resilience serve", resilience_serve_phase,
                       check_cfg, params, dev, **traffic)
    int8kv = timed("int8 kv", int8kv_phase, check_cfg, params, dev,
                   **traffic)
    phase_s = {"resilience_int8kv": time.perf_counter() - t0}
    del params
    torch.cuda.empty_cache()
    ladder = {}
    short = dataclasses.replace(cfg, n_layers=4)
    for wbits in (3, 2):
        ladder[wbits], p = timed(f"ladder int{wbits}", serve_path, short,
                                 wbits, dev, n_req=4, prompt_len=16,
                                 new_tokens=8, max_len=32, slots=4, chunk=16)
        # the format's prefill: B·S = 256 rows through the tensor cores
        ladder[wbits]["prefill"] = timed(f"ladder int{wbits} prefill",
                                         prefill_phase, short, p,
                                         f"int{wbits}", dev)
        del p
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    chaos_rows = timed("chaos", chaos_phase, cfg, dev, out)
    torch.cuda.empty_cache()
    degrade = timed("degrade", degrade_phase, cfg, dev)
    torch.cuda.empty_cache()
    phase_s["chaos_degrade"] = time.perf_counter() - t0
    print(f"chaos + degrade phases: {phase_s['chaos_degrade']:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    ptq_cfg = dataclasses.replace(cfg, n_layers=PTQ_LAYERS)
    ptq, results = timed("ptq", ptq_phase, ptq_cfg, dev)
    ptq["serve"] = timed("serve after ptq", serve_after_ptq, ptq_cfg,
                         *results["watersic"], dev)
    del results
    torch.cuda.empty_cache()
    print(f"ptq + serve-after-ptq phases: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    gptq = timed("gptq", gptq_phase, ptq_cfg, dev)
    torch.cuda.empty_cache()
    flash_grad = timed("flash grad", flash_grad_phase, ptq_cfg, dev, gen)
    torch.cuda.empty_cache()
    print(f"gptq + flash grad phases: {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    with shared_plan_model():
        plan, planned = timed("plan", plan_phase, dev, out)
    torch.cuda.empty_cache()
    planned["serve"] = timed("mixed serve", mixed_serve_phase, cfg, plan, dev)
    planned["phases_s"] = time.perf_counter() - t0
    print(f"plan + mixed-serve phases: {planned['phases_s']:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    quality = timed("quality + requant cells", quality_requant_phase, dev,
                    out)
    torch.cuda.empty_cache()
    requant_full = timed("requant full", requant_full_phase, cfg, dev)
    torch.cuda.empty_cache()
    phase_s["quality_requant"] = time.perf_counter() - t0
    print(f"quality + requant phases: {phase_s['quality_requant']:.1f}s; "
          f"slice-7 phases {sum(phase_s.values()):.1f}s; smoke so far "
          f"{time.perf_counter() - T_START:.1f}s", flush=True)
    moe_rec = timed("moe", moe_phases, dev, out, gen)
    recurrent = timed("recurrent", recurrent_phases, dev, gen)
    encdec = timed("encdec/vlm", encdec_vlm_phases, dev, gen)
    large = timed("large dense", large_dense_phases, dev, gen)
    training = timed("training", training_phases, dev)
    # before the phases that share CUDA tensors with their ranks: the
    # launcher keeps those for the ranks until they release them, which
    # ranks that exit do not always do (18 GB held after the mesh phases)
    fsdp = timed("fsdp x tp", fsdp_tp_phase, dev)
    fsdp_fam = timed("fsdp x tp families", fsdp_family_phase, dev)
    mesh = timed("mesh", mesh_phases, dev, gen)
    train_mesh = timed("training mesh", training_mesh_phases, dev)
    zsic = timed("zsic oracle (wait)", finish_zsic_oracle, zsic)
    gptq["frantar"] = timed("gptq oracle (wait)", finish_frantar,
                            gptq["frantar"])
    cost = {"decode": serve["cost"], "train": fsdp["oracle"]["cost"],
            "mesh": timed("cost (c)", cost_mesh_phase, dataclasses.replace(
                cfg, n_layers=mesh["n_layers"]), mesh),
            "dryrun": timed("cost (d)", cost_dryrun_phase, dry,
                            out / "dryrun_torch")}
    life = training["lifecycle"]
    rec_cases = [v["int4"] for v in recurrent["kernels"]] \
        + [v["int4"] for v in encdec["kernels"]["m8"]] \
        + encdec["kernels"]["prefill"] + large["kernels"]
    rec_int8 = [v["int8"] for v in recurrent["kernels"]] \
        + [v["int8"] for v in encdec["kernels"]["m8"]]
    # the recurrent and encoder–decoder / prefix-LM serve runs' B1
    # launches, their int8 steps' B2 and whisper's encode and prefill B3
    fams = [recurrent[a] for a in (RWKV_ARCH, RG_ARCH)] \
        + [encdec[a]["serve"] for a in (WHISPER_ARCH, PALIGEMMA_ARCH)]
    rec_b1 = sum(f["launches"].get(4, 0) for f in fams)
    rec_b2 = sum(f["int8_step"]["launches"].get(8, 0)
                 for f in [recurrent[a] for a in (RWKV_ARCH, RG_ARCH)]
                 + [encdec[a] for a in (WHISPER_ARCH, PALIGEMMA_ARCH)])
    whisper_b3 = sum(encdec[WHISPER_ARCH][k]["flash"]
                     for k in ("encode", "prefill"))
    # the training path's B3 (the driver's steps, the lifecycle's training,
    # model_ppl and fine-tune), B4 (hptq, gptq), B1 and B2 (the trained
    # codes served)
    train_b3 = training["train"]["main"]["flash_launches"] + sum(
        life[k]["flash_launches"] for k in ("train", "ptq", "finetune"))
    train_b4 = sum(life["ptq"]["methods"][k]["zsic_launches"]
                   for k in ("hptq", "gptq"))

    kernels, detail_mix = [], {}
    for nbits in (4, 3, 2):
        mix = {(c["k"], c["n"]): c for c in cases
               if c["nbits"] == nbits and c["m"] == 8 and "ms" in c}
        # one launch at the decode path's mix: per layer 7 launches over
        # the three shapes, at m = 8 (the 8-slot batch)
        per_launch = {key: sum(PER_LAYER[s] * mix[s][key] for s in mix) / 7
                      for key in ("ms", "plain_ms", "library_ms",
                                  "bound_ms", "bytes_ms", "operations_ms",
                                  "f32_cuda_core_ms")}
        kernels.append({
            "name": f"dequant_matmul_packed_int{nbits}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": serve["launches"][4] + rec_b1
            + life["serve_int4"]["launches"].get(4, 0)
            + mesh["b1_launches"] + serve["cost"]["b1_counted"]
            + large["b1_launches"] if nbits == 4
            else ladder[nbits]["launches"][nbits],
            "max_abs_err": max(c["max_abs_err"] for c in cases + rec_cases
                               if c["nbits"] == nbits
                               and not dq.uses_tensor_cores(c["m"])),
            "ms": per_launch["ms"], "plain_ms": per_launch["plain_ms"],
            "bound_ms": per_launch["bound_ms"],
            "bound_by": "bytes" if per_launch["bytes_ms"]
            >= per_launch["operations_ms"] else "operations",
            "library_ms": per_launch["library_ms"]})
        detail_mix[nbits] = per_launch
    # one int8 launch at the mixed serve's mix: its int8 types at m = 8
    shapes = [TYPE_SHAPES[tuple(k.split("/"))]
              for k in planned["serve"]["int8_types"]]
    by_shape = {(c["k"], c["n"]): c for c in int8_cases
                if c["m"] == 8 and "ms" in c}
    int8_mix = {key: sum(by_shape[sh][key] for sh in shapes) / len(shapes)
                for key in ("ms", "plain_ms", "library_ms", "before_ms",
                            "bound_ms", "bytes_ms", "operations_ms")}
    kernels.append({
        "name": "dequant_matmul_int8", "route": "cuda",
        "source": INT8_SOURCE, "replaces": INT8_REPLACES,
        "launches": planned["serve"]["launches"][8] + rec_b2
        + life["serve_int8"]["b2_launches"] + mesh["b2_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in int8_cases + rec_int8
                           if not dq.uses_tensor_cores(c["m"])),
        "ms": int8_mix["ms"], "plain_ms": int8_mix["plain_ms"],
        "bound_ms": int8_mix["bound_ms"],
        "bound_by": "bytes" if int8_mix["bytes_ms"]
        >= int8_mix["operations_ms"] else "operations",
        "library_ms": int8_mix["library_ms"]})
    # the tensor-core kernels (m >= TC_MIN_M): launches on the main path's
    # full-sequence runs (every tc_launches record: prefills, encodes; the
    # serve runs hold none), times at one prefill layer's mix of the
    # serving shapes at m = 256 (B2: the mixed serve's int8 types)
    tc_runs = sum_tc({"serve": serve, "ladder": ladder, "plan": planned,
                      "moe": moe_rec, "recurrent": recurrent,
                      "encdec": encdec, "large": large})
    tc_cases = [c for c in cases + rec_cases + prefill_kernels["int4"]
                if dq.uses_tensor_cores(c["m"])]
    tc_int8 = [c for c in int8_cases + prefill_kernels["int8"]
               if dq.uses_tensor_cores(c["m"])]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
            "operations_ms")
    for nbits in (4, 3, 2):
        at = {(c["k"], c["n"]): c for c in cases if c["nbits"] == nbits
              and c["m"] == PREFILL_M and "ms" in c}
        tmix = {key: sum(PER_LAYER[sh] * at[sh][key] for sh in at) / 7
                for key in keys}
        kernels.append({
            "name": f"dequant_matmul_packed_int{nbits}_tc", "route": "cuda",
            "source": TC_SOURCE, "replaces": REPLACES,
            "launches": tc_runs.get(nbits, 0),
            "max_abs_err": max(c["max_abs_err"] for c in tc_cases
                               if c["nbits"] == nbits),
            "ms": tmix["ms"], "plain_ms": tmix["plain_ms"],
            "bound_ms": tmix["bound_ms"],
            "bound_by": "bytes" if tmix["bytes_ms"] >= tmix["operations_ms"]
            else "operations", "library_ms": tmix["library_ms"]})
        detail_mix[f"int{nbits}_tc_m{PREFILL_M}"] = tmix
    at8 = {(c["k"], c["n"]): c for c in int8_cases
           if c["m"] == PREFILL_M and "ms" in c}
    t8 = {key: sum(at8[sh][key] for sh in shapes) / len(shapes)
          for key in keys}
    kernels.append({
        "name": "dequant_matmul_int8_tc", "route": "cuda",
        "source": TC_SOURCE, "replaces": INT8_REPLACES,
        "launches": tc_runs.get(8, 0),
        "max_abs_err": max(c["max_abs_err"] for c in tc_int8),
        "ms": t8["ms"], "plain_ms": t8["plain_ms"], "bound_ms": t8["bound_ms"],
        "bound_by": "bytes" if t8["bytes_ms"] >= t8["operations_ms"]
        else "operations", "library_ms": t8["library_ms"]})
    zsic_cases = list(zsic["cases"].values()) \
        + list(large["watersic"]["zsic_cases"].values())
    mix = ptq["hptq"]["zsic_launch_rows"]
    zmix = {key: sum(n * zsic["cases"][a][key] for a, n in mix.items())
            / sum(mix.values())
            for key in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                        "operations_ms")}
    kernels.append({
        "name": "zsic_block", "route": "cuda", "source": ZSIC_SOURCE,
        "replaces": ZSIC_REPLACES,
        "launches": ptq["hptq"]["zsic_launches"] + train_b4
        + large["watersic"]["zsic_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in zsic_cases),
        "code_mismatches": sum(c["code_mismatches"] for c in zsic_cases)
        + zsic["full_twin_code_mismatches"],
        "ms": zmix["ms"], "plain_ms": zmix["plain_ms"],
        "bound_ms": zmix["bound_ms"],
        "bound_by": "bytes" if zmix["bytes_ms"] >= zmix["operations_ms"]
        else "operations",
        "library_ms": None})
    path = next(c for c in flash_cases if c["s"] == 256 and c["d"] == 64
                and not c["window"] and "ms" in c)
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": sum(p["flash_launches"] for p in ptq["ppl"].values())
        + whisper_b3 + train_b3 + train_mesh["b3_launches"]
        + fsdp["b3_launches"] + fsdp_fam["b3_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in flash_cases
                           + [encdec["kernels"]["flash"]]),
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"]})
    detail = {"device": smi.stdout.strip(), "cases": cases, "serve": serve,
              "hgmma": hgmma, "tc_launches": tc_runs,
              "ladder": ladder, "kernels": kernels,
              "m8_decode_mix_per_launch": detail_mix, "zsic": zsic,
              "zsic_ptq_mix_per_launch": zmix, "flash": flash_cases,
              "ptq": ptq, "int8": int8_cases,
              "int8_mixed_serve_mix_per_launch": int8_mix, "plan": planned,
              "prefill_kernels": prefill_kernels, "gptq": gptq,
              "obs_serve": obs_serve, "flash_grad": flash_grad,
              "resilience_serve": resilience, "int8_kv": int8kv,
              "chaos": chaos_rows, "degrade": degrade, "quality": quality,
              "requant_full": requant_full, "slice7_phase_s": phase_s,
              "moe": moe_rec, "recurrent": recurrent,
              "encdec_vlm": encdec, "large_dense": large,
              "training": training, "mesh": mesh,
              "train_mesh": train_mesh, "fsdp_tp": fsdp,
              "fsdp_tp_families": fsdp_fam, "cost": cost,
              "phase_s": PHASE_S, "total_s": time.perf_counter() - T_START}
    (out / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1,
                                                           default=float))
    print("phases (s): " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in PHASE_S.items()), flush=True)
    print(f"chip_smoke total {detail['total_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
