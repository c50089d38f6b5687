#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # what the card check runs
    python3 chip_smoke.py --profile   # also: torch.profiler over one
                                      # decode block and one admission
                                      # per KV layout, over one train
                                      # step (CUDA events per phase),
                                      # and the CTR chunk's kernels
    python3 chip_smoke.py --serving-modes-layers 8,16,32
                                      # only: the build, the slice and
                                      # the serving-modes phase at each
                                      # depth, with its gates, then each
                                      # kv_quant's worst margin by depth
    python3 chip_smoke.py --mesh-only # only: the build, the mesh
                                      # shapes' kernel rows and the mesh
                                      # phase
    python3 chip_smoke.py --long-context-only
                                      # only: the build, the long_context
                                      # shapes' kernel rows and the local
                                      # and long_context phases

1. Builds every kernel of the serving and training paths from the
   sources in this checkout (``edl_tpu_torch/ops/csrc/*.cu``, one nvcc
   per source, all at once, sm_90a).
2. Kernel phase: the flash-attention forward kernel against its plain
   PyTorch version (``flash_attention_ref``) on the card, bf16, B=1,
   H=32, KV=8, d=128 (Llama-3-8B's attention), T in {8, 128, 1024,
   1536, 2048}, causal and not; d=64 at T=1024, causal and not,
   where the lse variant is held to its plain version too, so every
   instantiation of the forward template is checked; and the decode
   ladder's prefills (phase 8a), B in {1, 8, 32} at T=512, H=16, KV=8,
   d=128, causal (the flagship's attention), the llama predict's B64
   T512 H16 KV8 and the MoE predict's B64 T512 H8 KV4. Tolerance:
   |kernel - plain| <= 2e-2 + 2^-7 * |plain| elementwise — both round
   the output to bf16 (one ulp is 2^-8 relative) and sum in different
   orders; the plain version runs on the kernel's 128 x 128 tiles (one
   block below T=128) so P is rounded against the same running maxima.
   Times for the kernel and ``scaled_dot_product_attention`` (a
   yardstick only): device time a call, on CUDA events around calls the
   host has queued behind a sleep kernel (after warm-up, inputs left
   warm in L2 as a prefill leaves them), so the host's launch overhead
   is not in it; ``kernel_call_ms`` is the kernel's time a call with the
   host in the loop. The plain version, hundreds of small launches a
   call, is host-bound: its time is a call's on CUDA events with the
   host in the loop.
3. Training-kernel phase: the lse forward and the dQ and dK/dV backward
   kernels against ``flash_attention_lse_ref`` / ``flash_attention_bwd_ref``
   on the card, bf16, d=128: B=4 T=2048 H=16 KV=8 causal (the flagship's
   attention, the main shape), T in {100, 128, 1024} causal, T=1024
   non-causal (H=16, KV=8), H=32 KV=8 at T=1024, the ladder rungs'
   attention at the first batch of each ladder, B=16 T=2048 and B=4
   T=8192 H=16 KV=8 causal (the plain versions, host-bound at T=8192,
   take seconds; each shape prints them as ``plain_check_s``; a rung
   that steps down to a smaller batch has that shape checked after the
   ladder, phase 8); and d=64 at B=2 T=1024 H=16 KV=8 causal, so every
   instantiation of the three training kernels is checked (the
   non-causal d=64 backward by ``tests/test_torch_cuda.py``); and the
   MoE's attention, B=4 T=2048 H=8 KV=4 causal. Tolerances: the
   forward output as in 2; lse |kernel - plain| <= 1e-4 (f32 on both
   sides, the forward's 128 x 128 tiles, only the f32 summation order
   differs); dq/dk/dv <= 1e-2 * max|plain| + 2^-7 * |plain| (both
   round p and ds to bf16 before the same products, sum in f32 in
   different orders, and round the result to bf16; the absolute term
   covers entries whose sums cancel). The backward is compared from
   the kernel's own residuals. Times (as in 2) for each kernel, the
   plain versions, and SDPA (``enable_gqa=True``) forward and
   ``backward`` under autograd as the library yardstick (never called
   by the port).
3a. int8_products phase: ``ops/int8_matmul`` (``torch._int_mm``, no
   TPU kernel) at the flagship's seven projection shapes with M = 16 x
   2048 (K x N 2048x2048, 2048x1024, 2048x6144, 6144x2048): the
   forward, dgrad and wgrad of ``int8_matmul`` on the card against the
   same op sequence on the CPU for 512 output rows (forward, dgrad) and
   a 256-square block of wgrad, each a set of whole quantization
   slices. q, s and the int32 accumulators must be equal, the outputs
   within one rounding of the scale products (2^-8 relative in bf16,
   2^-22 in f32). Device ms of ``_int_mm``, the activation quantizer,
   bf16 ``torch.mm`` at the same shape (a yardstick), the op's forward
   and forward + backward beside bf16's, and the int8 bound (FLOPs over
   1979 TOPS, the H100 SXM's dense int8 spec; the summary row says
   whether the card's name is that card's).
4. Slice phase: Llama-3-8B at full width and depth, bf16,
   ``use_flash=True``, random weights from a seeded generator on the
   card, served through ``ContinuousBatchingEngine`` (8 slots x 2048
   positions, horizon 8): eight requests with prompts in the buckets
   8..1024, 32 new tokens each, half of them submitted after the first
   step. Checks: every outcome ``done``, zero recoveries, flash launches
   == prefills x 32 layers, and teacher-forced agreement — a dense
   forward over prompt + generated puts every chosen token within
   0.1 x (row std) of its row's maximum logit.
5. Serving-modes phase: the slice's model and weights, cut to its
   first 8 of 32 layers, through the
   PAGED engine (8 slots x 2048, horizon 8, block 16), once with float
   KV, then under ``kv_quant`` int8, then int4: (a) the prefix cache
   with chunked prefill (256) on the default pool — a cold 552-token
   request (512-token prefix + 40) runs first, then five warm ones with
   the same prefix and other tails beside a 1500-token prompt that
   shares nothing; (b) a pool of 129 blocks that 8 prompts of 250
   tokens fill at admission, so decode growth preempts; (c) ``spec_k``
   4 on prompts of a repeating 64-token pattern. Checks: every request
   done, zero recoveries, no flash launch in the phase, prefix hits ==
   5 x 32 blocks, the long prompt's ceil(1500/256) = 6 prefill
   dispatches, >= 1 preemption in (b), drafts in (c), int8 / int4 pool
   bytes <= 0.51 / 0.26 of float's, and the teacher-forced margin <= 0.1
   row std (float) or 0.25 (int8); int4 only finite logits. The margin
   is taken over the cold, a warm and the long (chunked) request of (a),
   every request preempted in (b) (restarted into reclaimed blocks) and
   two others, and three of (c).
5a. int8_serving phase: the slice's weights quantized on the card
   (``quantize_params_int8``), served with the slice's requests through
   the contiguous engine and the paged one (block 16). Checks: the int8
   tree (each projection and lm_head a record of int8 q8 in its
   weight's shape and f32 s8, the embedding and norms dense, its bytes
   <= 0.55 of the dense tree's), every request done, zero recoveries,
   flash launches == prefills x 32 (contiguous; none paged), no
   ``int8_matmul`` call, and the teacher-forced margin <= 0.1 row std
   against the quantized model's dense forward. Prints tokens/s beside
   the slice's float run.
6. Train phase: the flagship training config (bench.py:69
   ``flagship_train_config``: d2048/L16/H16/KV8/ff6144/v32768, bf16
   activations, f32 masters, ``use_flash``, full remat) at full width and
   depth, one ``synthetic_tokens`` batch [4, 2048+1] (seed 0),
   ``adamw(1e-3)`` through ``make_train_step``: one warm-up step, then
   5 timed steps on the same batch.
   Checks: finite losses, the last below the first; per step exactly
   32 ``flash_fwd_lse`` (two per layer: the forward and the remat
   recompute both run with grad on), 16 ``flash_bwd_dq``, 16
   ``flash_bwd_dkv`` and 0 ``flash_fwd`` launches; and at the first
   batch the flash loss and gradients against the dense (non-flash)
   path's: loss within 1e-4 relative, every leaf's gradient cosine
   >= 0.999.
7. Remat-policies phase: the same flagship, params and batch [4, 2048]
   under each remat policy ("full", "attn", "mlp", "dots"): one
   ``value_and_grad`` counted by a dispatch mode, then the best of 3
   uncounted ones (seconds, peak memory). Checks: ``flash_fwd_lse``
   launches (and ``edl_tpu_torch::flash_fwd`` ops) of 16 under "attn"
   (the flash op's outputs are saved, the recompute runs none) and 32
   under the others; the weight products (``aten.mm``) the backward
   recomputes: 6 a layer under "full" and "attn", 4 under "mlp" (w1 and
   w3 saved), 0 under "dots"; loss within 1e-6 relative and every
   gradient leaf within 1e-5 of its largest entry of "full"'s (the same
   ops on the same card: equal is expected; the largest difference is
   printed).
8. Train-ladder phase: bench.py:_llama_measure on the port. First three
   ``adafactor(1e-3)`` steps of a small f32 Llama (d256/L2, dense
   attention, batch [2, 64]) on the card and on the CPU: losses, params
   and the ``v_row`` / ``v_col`` / ``v`` statistics within 1e-4 of each
   leaf's largest entry. Then the flagship (full remat) with
   ``adafactor(1e-3)`` through ``make_train_multistep`` (2 steps a
   call): T=2048 at batch 16, 8, 4 or 2 (4 calls a loop) and T=8192 at
   batch 4, 2 or 1 (2 calls a loop), each the first batch that fits (a
   rung steps down only on ``torch.cuda.OutOfMemoryError``), one warm-up
   call, one timed loop (bench.py: best of 3). Prints tokens/s/chip, MFU
   (T=2048) and long MFU (T=8192) (``train_flops_per_token`` over 989
   TF/s), the batch,
   the state's GiB (``state_nbytes``) and every loss. Checks: finite
   losses that fall; per step 32 ``flash_fwd_lse``, 16 of each backward
   sweep and no primal forward. Then bench.py's int8 rungs
   (bench.py:205-212): the same config with ``int8_mxu``, the same
   ladders and loops: ``int8_mfu`` and
   ``int8_long_mfu`` over the bf16 peak, and ``int8_train_speedup`` /
   ``int8_long_speedup`` over the bf16 rung, -1 when the batches differ.
   Checks as the bf16 rungs', and per step 2 x 7 x 16 ``int8_matmul``
   forward calls (the forward and its recompute) and 7 x 16 backward
   calls.
8a. decode_ladder phase: bench.py's ``_llama_decode_bench``: the
   flagship's decode config (remat off) with bf16 params, greedy
   ``generate`` at (B, prompt) (1, 512), (8, 512), (32, 512), the
   decode rate by differencing 64 and 192 new tokens (one warm-up and
   one timed run a length: bench.py's reps cut), ``decode_pct_peak_bw`` =
   ``decode_step_bytes`` over the step over 3.35 TB/s; then the
   weight-only int8 rungs at B 1 and 8 on ``quantize_params_int8``'s
   tree (roofline against its own bytes) and ``decode_int8_b1_speedup``
   / ``decode_int8_speedup``. ``generate`` gets the config with
   ``int8_mxu`` on and must drop it. Checks: the int8 tree (as in 5a),
   no ``int8_matmul`` call, 16 primal flash launches a generate (its
   prefill) and no other, and at B 8 every int8 token within 0.1 row
   std of the quantized model's dense forward.
9. CTR phase: bench.py's headline (bench.py:1119-1230) on the port: the
   Criteo-shaped CTR model (vocab 2^20, emb 16, MLP 400-400-400,
   random weights from a seeded generator on the card), batch 16384 of
   ``synthetic_batch`` (4 raw batches cycled into 12-step chunks),
   ``adam(1e-3)``, bf16 compute, through ``stack_batches`` and
   ``make_train_multistep``: 2 warm-up chunks, then 3 loops of 240 steps
   (examples/s: best, median, spread). Then the reshard stalls, each the
   minimum of 2 runs: ``device_reshard`` (the fast path), and
   ``staged_reshard`` with f32 and int8 moment staging; the f32 run's
   rate gives ``host_stage_bw_gbs`` and ``stall_model_8b_1host_s`` as
   bench.py derives them. Checks: finite losses that fall over the run;
   on the trained state, f32 staging bit-identical to ``snapshot`` +
   ``restore``, int8 staging with params exact and moments within 1/127
   of their row's absmax, and the params one step after the int8-staged
   state within the bound those moment errors allow Adam's update
   around the same step from the unstaged state; one f32 step at vocab
   8192, batch 256 on the card against the same step on the CPU within
   1e-4 in loss and every param, and Adam's first moment after it
   ((1 - b1) * grad) within 1e-4 of each leaf's largest entry; no flash
   launch. It prints one chunk's
   device-busy share and launches a step (``torch.profiler``), and with
   ``--profile`` its top kernels and their families.

10. small_workloads phase: the small workloads trained on the card,
   exported and scored through ``runtime/predict.predict_batch``.
   fit_a_line: ``synthetic_dataset(4096, seed=0)``, batch 256 in order,
   ``adam(1e-2)``, 500 steps through ``make_train_multistep`` (20 a
   call); the final loss must be below 10 x noise^2 = 0.1, and 20 f32
   steps on the card within 1e-5 of each leaf's largest entry of the
   CPU's. ResNet-50 (``ResNetConfig.resnet50()``: widths 256-2048,
   blocks 3/4/6/3, stem 128, GroupNorm 32, bf16 over f32 masters, ~340 M
   params) on ``synthetic_batch`` at its own 32 x 32, batch 128, and
   BERT-base (``BertConfig.base()``, B32 T512), each ``adam(1e-3)`` on
   one batch: 2 warm-up steps, 3 timed loops of 6 steps (examples/s or
   tokens/s, best and median), one profiled step (launches), and the
   share of 989 TF/s from an analytic FLOP count (ResNet: 3 x the convs
   and head; BERT: 6 x matmul params + attention a token); losses finite
   and falling. Each model's gates at ``tiny()`` in f32, TF32 off: the
   forward against this script's NumPy float64 forward of the
   reference's math (``_np_resnet`` at 32 and 33 pixels, XLA's SAME
   padding; ``_np_bert``, tanh GELU) within 1e-4 / 2e-5 of the largest
   logit, and one Adam step on the card within 1e-4 of each leaf's
   largest entry of the CPU's (loss, params, first moments). Then each
   trained state is exported in bf16 (``export_params``), read back with
   ``load_export`` and held to the params cast to bf16 bit for bit, and
   256 rows are scored: ResNet's ``class`` and BERT's ``pred`` and
   ``masked_acc`` equal to a direct chunked forward on the loaded
   params. Last the flagship llama (bench.py:69, ``use_flash``, random
   bf16 weights) is exported and 64 rows x 512 tokens scored through
   ``lm_scan``: ``ppl`` finite, ``next_token`` equal to a direct
   forward's, ``ln ppl`` within LOSS_RTOL (relative) of the dense
   (``use_flash=False``) forward's, and exactly 16 primal flash
   launches (one chunk x 16 layers), which the kernels line lists
   under the primal forward's row at PREDICT_SHAPE (B64 T512 H16 KV8,
   held to its plain version in the kernel phase). Prints export,
   load and predict seconds.
10a. moe phase: the MoE family (``edl_tpu/models/moe.py``) at
   ``MoEConfig()``'s own width and depth (d1024/L8/H8/KV4, experts
   ff2816 x 8, top-2, capacity factor 1.25, v32768; 461.5 M params),
   random weights from a seeded generator on the card, bf16 over f32
   masters, ``use_flash``, one ``synthetic_tokens`` batch [4, 2048+1]
   (seed 0), ``adamw(1e-3)`` through ``make_train_step``: one warm-up
   step, then 5 timed ones on the same batch (tokens/s; MFU from the
   cost model's ``train_flops_per_token`` over 989 TF/s, which prices
   an expert as three matrices, and the same with the MoE's two; peak
   memory; flash launches a step; one profiled step's kernel launches
   and device ms by family). Checks: the flash loss within 1e-4
   (relative) of the dense (``use_flash=False``) loss on the batch with
   the dense forward routed as the flash forward was (bf16 rounds the
   two attentions differently, which flips near-tied router choices and
   moves those tokens' outputs whole: the loss without that replay and
   the choices that differ are printed); every routing of the flash
   forward against the same router
   probabilities routed on the CPU (experts, slots, kept choices
   equal; the share of choices dropped a layer is printed); the first
   2 layers in f32 (plain attention, TF32 off) on the batch's first row
   of 512 + 1 tokens on the card and on the CPU: loss within 1e-5
   relative, every gradient leaf's L2 difference within 1e-3 of its
   norm (the experts' ReLU kink makes an elementwise bound meaningless;
   see MOE_CPU_REL_L2); one
   ``value_and_grad`` without remat and one with each layer
   checkpointed whole: 8 ``flash_fwd_lse`` launches (16 under remat),
   8 of each backward sweep, no primal forward, and loss and grads
   equal (within 1e-6 / 1e-5 of the leaf's largest entry; bit-equal is
   expected, the largest difference is printed); finite losses that
   fall over the timed steps with 8 / 8 / 8 / 0 launches a step; the
   trained state's ``snapshot``, ``staged_reshard(stage="f32")`` and
   ``restore`` (each timed; the staged stall), the staged state equal
   to the restored one bit for bit, and two further steps from it
   giving the unresharded run's losses bit for bit; one ``int8_mxu``
   step with 4 + 2 x 8 ``int8_matmul`` ops a layer forward and
   backward; then the trained params exported in bf16 and 64 rows x
   512 tokens scored through ``predict_batch`` (one chunk: exactly 8
   primal flash launches), ``ln ppl`` within 1e-4 (relative) of the
   dense forward's under the same replayed routing.
11. serving_load phase: bench.py's serving-load rungs and the serving
   verbs under load, on the flagship decode config (bench.py:87: the
   flagship without remat, bf16, random weights from seed 4). (a) The
   horizon rung (bench.py:681-731): scripts/exp_serving.py's deep
   workload (12 requests, prompts 16-63, budgets 128-191,
   RandomState(7), step-indexed arrivals) through 8 slots x 256 at
   horizon 1 and then 8, each after a 2-request warm-up of 8 tokens:
   tokens/s, dispatches a token and the speedup. Gates: every request
   yields exactly its budget; at H=8, dispatches a token <= 1/8 plus the
   admission dispatches a token; H1 / H8 dispatches a token >= 4; primal
   launches == prefills x 16. (b) The goodput rung (bench.py:734-797):
   ``WorkloadSpec(seed=0, n_requests=48, rate_rps=8, arrival="burst")``
   with ``default_classes(1.0, 0.25)`` replayed on the wall clock at
   horizon 4 after a 2-request warm-up: goodput req/s, TTFT attainment,
   p99 queue wait. Gates: every request has an outcome and submitted +
   rejected == 48; queue wait + prefill + decode == total within 1e-9 s
   for every finished record; goodput <= finished / wall; launches ==
   prefills x 16. (c) The flagship exported; ``python -m edl_tpu_torch
   loadgen EXPORT --json --requests 16 --metrics-port 0 --tsdb-dir D``
   (the reference's report keys, an outcome for every request, a live
   ``/history`` listing recorded series, the recorded goodput and
   prefill counter in D) and ``fleet --export-dir EXPORT --replicas 2
   --requests 12 --swap`` (``ok``, ``min_ready`` >= 1) as subprocesses
   (the fleet verb first: the other parts start once its first replicas
   are bound), and meanwhile in this process a ``ServingFleet`` of 2
   replica subprocesses (8 slots x 128, 12 requests of 96 new tokens) whose
   first replica is SIGKILLed once every request is routed and some of
   its streams have begun: every request ends done/eos, >= 1 failover,
   the supervisor respawns to 2 READY, every completion within 0.1 row
   std of the dense forward (``_teacher_margin``). Primal launches of
   the subprocesses are their own wrappers' counts
   (``edl_kernel_launches``): each replica's from its ``/metrics`` (the
   victim's just before the kill), the loadgen verb's measured replay's
   from its recorded history; each equals its prefills x 16. Each
   replica's boot is split into stages (its log's boot stamps between
   the supervisor's spawn and ready events). While the loadgen verb
   serves, ``top ENDPOINT --polls 1`` exits 0 and ``profile ENDPOINT
   --json`` reports non-zero ``edl_mfu`` for the engine's phases
   (prefill and decode: the engine's labels in both packages) and the
   ledger's ``kv`` bytes; after it ``watch D --once --json`` exits with
   its page count and prints the reference's keys, and ``export-status
   EXPORT`` prints the reference's line. Then ``generate EXPORT
   --prompt <512 ids, seed 11> --max-new 32`` and the same with
   ``--int8``, both processes at once: each verb's greedy tokens equal
   ``llama.generate`` in this process on what the verb's loader
   (``_load_llama_serving``) reads from the export, and that generate
   launches ``flash_fwd`` exactly 16 times (1 prefill x 16 layers, the
   decode ladder's B1 T512 shape) and no other kernel; prints the
   verbs' wall seconds and the in-process tokens/s. The largest
   prefill of (a) and (b), B1 T64 H16 KV8 causal, is held to its plain
   version after the phase. Prints each part's seconds.

Elastic phase (after ``ctr``; runs no flash kernel): the elastic process
runtime (``runtime/{launcher,worker_main,dist_service}``) on the card.
First a dp step check: two gloo processes on the card take 3 SGD steps
of CTR at vocab 2^20 on their halves of 2 x 4096-row batches (the last
ragged: rank 1's rows all ``_w = 0``), held to one process on the whole
batches (params within 1e-6, losses within 1e-5, the ranks' params
bit-identical). Then bench.py's CTR headline (vocab 2^20, emb 16) as an
elastic job: worker processes that share cuda:0, joined by gloo, 4096
rows a worker a step, 1024 tasks, a commit (with export and the
held-out AUC) every 100 steps; start 2, grow to 3, drain to 2
(SIGTERM), SIGKILL w001, finish on w000; each event waits for 20 more
steps. Gates: succeeded, the exit codes, the queue's accounting, 3+
reshards, no restart (w000 booted once and came up in every epoch),
loss fell, AUC > 0.55, the final manifest at the final step, every
worker on cuda:0 with gloo, the commits' param digests agreed. Prints
each event's stall (with the part up to the new epoch's rendezvous and
the cold start of its store host, and ``restore_last``: how the new
world restored — the workers run the p2p shard plane, the reference's
default), w000's and the joiner's boots by stage, the commits' seconds
and bytes, examples/s and the all-reduce's share of a step per epoch,
and each process's peak memory.
Beside the job runs the fleet's read side: the workers push every
second (``EDL_METRICS_PUSH_S=1``, 512 spans a push) and
``coordinator_main.serve_fleet`` over the launcher's client serves the
fleet's ``/metrics``, ``/events`` and ``/trace`` and appends the union
to a history every second under the default alert rules. In each steady
window (2, 3, 2, 1 workers) ``/metrics`` labels the step histogram with
exactly the live members and carries ``dist_service``'s series, each
worker's counters equal its raw snapshot read in the same pass,
``/events`` is labeled by worker and ordered on the corrected clock,
and with 2+ workers ``/trace`` holds 2+ workers and flow links. After
the grow: the ``trace`` verb's critical path of the grow's reshard
epoch (the restore spans under the derived reshard root) and, in the
3-worker window, of the newest step whose ``train.step`` span every
member's window holds (``trace URL --step S --assert-critical-path
--json`` through the verb's entry in this process, so its scrape
follows the window it was chosen from), every member's ``worker.join`` of the grow epoch, and
``top URL --polls 1``. At the end ``job-status`` shows the queue done
with none dead and the job's reshard count, and two replays of the
fleet history by ``watch --once --json`` exit 0 with the same
document. Then ``coordinator_main`` as a process: a pushed series
carries ``worker="smoke0"`` on its ``/metrics``, its history gets
appends, SIGTERM ends it with 0. Prints the skew ratio each window, the
grow epoch's barrier waits, both critical paths (hops, total, longest
hop) and each scrape's seconds (``elastic_fleet`` row).

P2p phase (after ``elastic``): the peer-to-peer shard plane and the
chip-lease plane, one JSON line. (a) Migration: the elastic phase's CTR
job (2^20, 4096 rows a worker) on w000 + w001; after 20 steps w002 and
w003 start and both originals are SIGTERMed at once, so the new world
restores the state from the leavers' RAM while they linger. Gates:
``restore_last`` is ``p2p:``, each new worker's first restore came from
peers and opened no shard file, the state it brought up equals the
leavers' last snapshot (every piece, by digest, ``EDL_P2P_DIGEST=1``),
the queue done with none dead, the loss fell, all four exit 0. Prints
the restore's seconds and bytes and the stall. (b) Bandwidth,
bench.py:_p2p_bench's ``p2p_bw_gbs`` (a 512 MB snapshot from a separate
server process over the pooled FETCHN path, best of 3) and
``p2p_agg_bw_gbs`` (4 fetcher x 4 server processes, all to all). (c)
Warm start and handover: Llama-3-8B at full width, its first 8 of 32
layers, bf16, params from seed 7 on the card pushed from host RAM by
``serve_params``; a ``ServingFleet`` of ``--warm-from p2p`` replicas
and a ``ChipLeaseBroker`` + ``ElasticityController`` (pool 3: trainer
2, a replica 1) whose ``ServePort`` scales the fleet, over one
day -> night cycle of the diurnal curve (one grant to serving, one
recall). The trainer half of a handover waits for ROADMAP item 2b: the
``TrainPort`` records the chip count. Gates: lease conservation after
every tick, the pulled tree byte-equal to the pushed one, 8 requests
(96-120-token prompts, the 128 bucket, one at a time) done with the
tokens of an in-process engine on the pushed params with the replicas'
slots and horizon, each replica's primal launches (its ``/metrics``)
== its prefills x 8 and > 0. Prints ``elasticity_grant_ready_s``,
``elasticity_warm_fetch_s`` and ``elasticity_cold_load_s`` (export, then
``load_export``, of the same tree).

Control phase (ROADMAP items 9c and 9d): the control plane and
the in-process coordination plane, one JSON line. (a) The squeeze of
``examples/elastic_demo.py`` (10 hosts x 4 chips, max load 1.0, three
elastic jobs submitted in turn) through ``Controller``, ``Autoscaler(
use_native=True)``, ``FakeCluster`` and ``Collector(ClusterSource)``:
after every settle each job's running workers and parallelism and the
pending jobs equal ``CONTROL_SQUEEZE_TRACE`` (the reference's run;
``tests/test_torch_control.py`` holds it), pending ends at 0 and no
worker group is created twice. (b) A fleet of 256 hosts x 8 chips (96
cores, 384 GiB a host) and 64 seeded elastic jobs: 4 control ticks (host
ms of the reconcile, the autoscaler's tick and the updaters' step), then
the Python and the native planner on one snapshot (host ms each), the
native plan not None and equal to the Python one; chips requested and
total. (c) The job verbs through ``cli.main`` in this process on the
JSON forms of ``examples/ctr/job.yaml`` and ``examples/llama/job.yaml``:
``validate``, ``submit``, ``controller --iterations 6 --tick-s 0``,
``list``, ``status``, ``monitor --json --polls 1``, ``delete``, equal to
``CONTROL_VERBS_EXPECT`` (the reference's verbs; without PyYAML the jobs
are written to the store directly and ``validate`` / ``submit`` are
reported as held on the CPU only). (d) The flagship (as in 6) trained
from ``ElasticDataQueue(64, chunk 6)`` + ``QueueBatcher`` at B4 T2048 on
``synthetic_tokens`` until the queue is done, ``w1`` leasing a task at
step 2 and released at step 3: every sample trained once (``w1``'s after
its release), each step's loss equal to a run fed the recorded sample
ranges directly from the same init, launches of ``flash_fwd_lse`` /
``flash_bwd_dq`` / ``flash_bwd_dkv`` equal to steps x (32, 16, 16) and
no primal forward; ``make_coordinator()`` is the ``NativeCoordinator``
and a membership / KV / barrier / queue script gives it the answers of
``PyCoordinator``. (e) ``Collector(ServingSource(...))`` over the slice
phase's serving metrics: the sample's serving block equals their
snapshot and carries the efficiency block. The phase fails above
``CONTROL_MAX_S`` (90 s).

kube_check phase (ROADMAP items 9d-kube and 9f): the in-cluster
backend and the project's own checkers, host work only, one JSON line.
(a) ``tests/fake_kube.py``'s ``FakeKubeServer`` with 256 nodes x 8 chips
(the control phase's fleet) and its 64 seeded jobs as ``TrainingJob``
CRDs, its pod reconciler running; ``controller --kube-url URL
--iterations 8 --tick-s 0`` through ``cli.main`` in this process, once
with the Python planner (``--no-native-scheduler``) and once with the
native one: per tick, the host ms of the CRD poll, the autoscaler's
tick, the updaters' step and the status writes, with chips requested
and pods. Gates: exit 0, every CRD has a status with a phase, chips
requested <= the fleet's 2048, and in the native run ``plan_native``
returned a plan every time it was called (never None). (b) ``check``
over ``edl_tpu_torch/`` with ``edl_tpu_torch/analysis/baseline.json``:
findings by rule, files read, seconds; exit 0. (c) ``schedcheck`` with
every harness at its own budget, seed 0: each harness's schedules,
distinct traces, races and seconds, and each static site's verdict;
exit 0 and no site ``REGRESSED``. The phase fails above
``KUBE_CHECK_MAX_S`` (240 s). It launches no kernel.

mesh phase (after kube_check; ROADMAP item 2b's first half): a
``utils/platform.ProcessPool`` of 4 processes on the card(s), which the
local and long_context phases reuse, gloo on a
shared ``cuda:0`` (every collective staged through pinned host memory
and counted), NCCL with a card a rank; the row prints the backend and
why, the card count and the card. (a) The flagship at full width (cut
to ``MESH["layers"]`` of its 16 layers, printed as the row's ``cut``),
f32 masters, adamw, B4 T2048, on fsdp2 x tp2, dp2 x tp2 and dp2 x fsdp2
in the same 4 processes, each held to the one-rank step from the same
params and batches: the first loss within 1e-3 relative, the loss of
the 4th step within 1e-2, every rank's losses equal, each leaf's
gathered gradient of the first batch within 1e-2 relative L2 and that
batch's loss within 1e-3, both in f32 with the dense attention on both
sides (``mesh_check.grad_cfg``), and 2L/L/L flash launches a step on
every rank; each plan's step seconds, collective share, staged bytes
and peak memory a rank. (b) ``ElasticTrainer(MeshSpec(tp=2),
chips_per_worker=2, per_chip_batch=1)`` 1 -> 2 -> 1 workers, 2 steps
each: the state's digests equal across each rescale, the step never
resets, two events on the device path, and the first loss after each
rescale within 1e-3 of the one-rank loss of the gathered params.

local phase (after mesh, in the same pool; ROADMAP item 9e): the CTR
twin's rank program (``edl_tpu_torch.examples.ctr.train``) through
``runtime/local.LocalJobRunner`` on the pool's 4 ranks: a ``FakeCluster``
of 4 hosts x 1 chip, ``examples/ctr/job.yaml`` (min 2, max 8), bench.py's
vocab 2^20 and emb 16, adam 1e-3, 4096 rows a rank a step, rows read
from shards on disk through the lease queue (one pass). The job starts
on 2 workers, an autoscaler tick grows it to 4 (in place), a host dies
and the runtime shrinks it to the 3 live workers, the queue drains and
the job is SUCCEEDED. Gates: the phases in order, the workers of every
step, two reshards on the device path, the job's ``reshard_count`` 1
with ``last_reshard_stall_s`` the grow's ``stall_s``, the state's step
the steps run (no restart), and each step's loss within 1e-5 relative
of one process fed the same global batch from the pool's previous state
(f32). Prints examples/s and the whole run's losses against one process
trained from the init (``LOCAL_LOSS_RTOL`` says why not gated).

long_context phase (last, in the same pool; items 2c and 2d): the
flagship at full width cut to ``LONG["layers"]`` of its 16 layers, f32
masters, adamw, full remat: (a) sp4 ring attention at B1 T8192, (b) sp4
Ulysses at B1 T8192 (the flash kernels at B1 T8192 H4 KV2 on each
rank), (c) pp2 x dp2 at B4 T2048 with 2 microbatches (the flash kernels
at B1 T2048 H16 KV8 in each stage); each an f32 dense-attention
gradient pass held leaf by leaf to the one-rank gradient within 1e-5
relative L2 (at ``grad_seq`` positions, printed) and its f32 loss within
1e-5, then 3 bf16 steps whose first loss is within 1e-3 of the one-rank
loss, with every rank's losses equal and 2L/L/L flash launches a rank
a step on the flash plans; (d) ``ElasticTrainer(MeshSpec(sp=2),
chips_per_worker=2, per_chip_batch=1)`` 1 -> 2 -> 1 workers at T2048,
2 steps each, gated as the mesh phase's (b). Prints each plan's step s,
collectives' share and staged bytes and peak GiB a rank.

Prints one JSON line per phase, then ``{"kernels": [...]}`` (each
kernel's device ms, its bound, TF/s and bound share at its main-path
shape, and its launches on the main path; the three training kernels
four times, at B4 T2048 with the train and control phases' launches, at each
ladder rung's shape (the batch that fit) with that rung's launches
and at the MoE's B4 T2048 H8 KV4 with the moe phase's 5 steps,
each with its launches on every training path, the int8 rungs' too;
the primal forward eight times, at B1 T1024 H32 with the slice's
launches, at each decode rung's prefill shape with that rung's bf16
and int8 launches, at the llama predict's B64 T512 and the moe
predict's B64 T512 H8 KV4 with their launches and at the serving-load
rungs' largest prefill with their launches, and at the warm-started
replicas' B1 T128 H32 KV8 with their launches,
each with its launches on the slice, the int8 serving runs, every
decode rung, the llama and moe predicts, both serving-load rungs, the
loadgen
verb and the failover fleet's replicas (the last two from their
``serve.prefill`` events x 16)), then the
card's name and power limit, then ``{"ok": true, "device": ...}`` as
the last line. Any failure raises (non-zero exit); without CUDA it
exits 1 before printing any result. Needs one card.
"""

import dataclasses
import faulthandler
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the card's dense bf16 and HBM peaks: set in main() from the port's one
# peak table (edl_tpu_torch/obs/costmodel.py detect_peak; H100 SXM 989
# TF/s and 3.35 TB/s), which raises on a card it does not name
PEAK_BF16_FLOPS = PEAK_HBM_BYTES = None
TEACHER_EPS = 0.1  # chosen logit within EPS x row std of the row max
# primal forward: (B, T, H, KV, causal, head dim); Llama-3-8B's
# attention (the slice's prefills) at d=128, and d=64 so that every
# instantiation of the template is checked; the decode ladder's
# prefills are DECODE_SHAPES, below
KERNEL_SHAPES = ([(1, t, 32, 8, c, 128) for t in (8, 128, 1024, 1536, 2048)
                  for c in (True, False)]
                 + [(1, 1024, 32, 8, True, 64), (1, 1024, 32, 8, False, 64)])
SLICE_MAIN = (1, 1024, 32, 8, True, 128)  # the slice's largest prefill
# training kernels: (B, T, H, KV, causal, head dim); the first is the
# main shape (the flagship's attention at B4 T2048, the train phase's),
# the last two the ladder's rungs' attention at the first batch of each
# ladder (B16 T2048; B4 T8192, where the plain versions, ~2000 block
# pairs of small launches each, are host-bound); the one before them
# holds the d=64 instantiations of all three. A rung that steps down
# has its own batch's shape checked after the ladder.
TRAIN_MAIN = (4, 2048, 16, 8, True, 128)
TRAIN_SHAPES = [TRAIN_MAIN, (4, 100, 16, 8, True, 128),
                (4, 128, 16, 8, True, 128), (4, 1024, 16, 8, True, 128),
                (4, 1024, 16, 8, False, 128), (1, 1024, 32, 8, True, 128),
                (2, 1024, 16, 8, True, 64), (16, 2048, 16, 8, True, 128),
                (4, 8192, 16, 8, True, 128)]
LSE_ATOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-2
TRAIN_STEPS = 5
# flash vs dense at the first batch (H100, first runs: loss rel diff
# 5.7e-6, worst leaf cosine 0.99949 on wq -- the dense path's bf16
# scores are the coarser of the two)
LOSS_RTOL = 1e-4
GRAD_MIN_COS = 0.999
# serving-modes phase: the slice's engine (8 slots, horizon 8) paged, on
# the first SM_LAYERS of the slice's 32 layers (cut to fit the script's
# time: 16 layers took 20.6-21.1 s, 8 took 10.7 s with the same worst
# margins; `--serving-modes-layers 8,16,32` prints each kv_quant's
# margin at each depth)
SM_LAYERS = 8
SM_MAX_LEN = 2048
SM_BLOCK = 16
SM_CHUNK = 256  # prefill chunk of part (a)
SM_PREFIX = 512  # shared prefix of part (a)
SM_TAIL = 40
SM_LONG = 1500  # the long prompt of part (a): ceil(1500/256) dispatches
SM_NEW = 16  # new tokens a request (32 in part (c))
# part (b): 8 prompts of 250 tokens take 16 blocks each, the whole
# usable pool of 128 (one full-length sequence, the least the engine
# allows), so the first decode growth past a block boundary preempts
SM_PRESSURE_PROMPT = 250
SM_PRESSURE_POOL = 129
SM_REPEATS = 4  # part (c): a 64-token pattern repeated
# teacher-forced worst margin (row std) against the dense float forward;
# int4 is gated on completion and finite logits only, as in the
# reference
SM_TEACHER_EPS = {"off": TEACHER_EPS, "int8": 0.25, "int4": None}
# ctr phase: bench.py's CTR headline (bench.py:45-56, 1119-1230) as it is
CTR = {"vocab": 2 ** 20, "batch": 16384, "raw_batches": 4, "chunk": 12,
       "warmup": 2, "measure": 240, "loops": 3}
# one f32 step on the card against the same step on the CPU (small size):
# loss and params within CTR_CPU_ATOL; Adam's first moment after the step,
# (1 - b1) * grad, within CTR_CPU_GRAD_RTOL of each leaf's largest entry
# (both sum in f32 in different orders; a bf16 gradient is off by 2^-9)
CTR_SMALL = {"vocab": 8192, "batch": 256}
CTR_CPU_ATOL = 1e-4
CTR_CPU_GRAD_RTOL = 1e-4
# remat_policies phase: per layer, the weight products (aten.mm) the
# backward recomputes, reckoned from the layer's graph (models/llama.py
# _remat_policy: wq wk wv wo w1 w3 under "full" and "attn", w1 and w3
# saved under "mlp", every product saved under "dots"; the w2 product is
# never recomputed), and the flash_fwd_lse launches of a step (forward,
# plus the recompute unless "attn" saved the flash op's outputs)
REMAT_POLICIES = ("full", "attn", "mlp", "dots")
REMAT_RECOMPUTED_MM = {"full": 6, "attn": 6, "mlp": 4, "dots": 0}
REMAT_LSE_PER_LAYER = {"full": 2, "attn": 1, "mlp": 2, "dots": 2}
# every policy runs the same ops on the same inputs, so loss and
# gradients are expected equal to "full"'s; the bound admits only f32
# summation order (the embedding gradient's scatter-add)
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_OF_MAX = 1e-5
# train_ladder phase: bench.py:_llama_measure on the port (bench.py:
# 95-260): (T, batch ladder, multistep calls a loop), 2 steps a call.
# bench.py takes the best of 3 loops; here one loop (after the warm-up
# call), bf16 and int8 rungs alike, to fit the script's time with the
# serving_load phase (the best of 2 until then; the loops of one rung
# were within 1.5% of each other on the H100)
LADDER_RUNGS = ((2048, (16, 8, 4, 2), 4), (8192, (4, 2, 1), 2))
LADDER_STEPS = 2
LADDER_LOOPS = 1
# three adafactor(1e-3) steps of a small f32 Llama (dense attention) on
# the card against the CPU: losses, params and second-moment statistics
# within AF_CPU_OF_MAX of each leaf's largest entry (f32 on both sides,
# sums in other orders; the unfactored update ~ lr * sign(grad) makes a
# params-only check blind to the gradient's size)
AF_SMALL = {"vocab": 1024, "d_model": 256, "n_layers": 2, "n_heads": 4,
            "n_kv_heads": 2, "d_ff": 512}
AF_SMALL_BATCH = (2, 64)
AF_CPU_OF_MAX = 1e-4
# int8_products phase: the int8 products of the flagship's seven
# projections at the int8 ladder rung's M (B16 x T2048): (K, N) of
# wq/wo, wk/wv, w1/w3 and w2. The CPU holds I8_ROWS output rows of the
# forward and dgrad and an I8_COLS-square block of wgrad (each a slice
# of whole quantization slices), since its int8 products over the
# whole M take minutes; the quantizers' q and s and the int32
# accumulators must be equal, the outputs within one rounding of the
# scale products.
I8_M = 16 * 2048
I8_SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
I8_ROWS = 512
I8_COLS = 256
I8_BF16_REL = 2 ** -8  # one bf16 rounding (forward, dgrad)
I8_F32_REL = 2 ** -22  # one f32 rounding (wgrad)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8, the spec figure
I8_PER_LAYER = 7  # int8 products a layer: wq wk wv wo w1 w3 w2
# decode_ladder phase: bench.py _llama_decode_bench (bench.py:539-679):
# (batch, prompt, max_new), the headline batch, and the int8 tree's
# bytes over the bf16 tree's (predicted 0.537). Cut to fit the script's
# time: bench.py times each generation length best of 5 reps at b=1
# and 3 otherwise, each after a warm-up of that length; here one
# warm-up a rung (the short length) and one timed run a length. With
# bench.py's counts the new phases took ~210 s more (decode 11-19 ms a
# step, an int8 B16 T2048 step 2.2 s; H100 80GB HBM3, 700 W).
DECODE_LADDER = ((1, 512, 128), (8, 512, 128), (32, 512, 128))
DECODE_HEADLINE = 8
INT8_TREE_MOST = 0.55
# each decode rung's prefill: the flagship's attention (as TRAIN_MAIN's)
# at the rung's batch and prompt, held to its plain version in the
# kernel phase
DECODE_SHAPES = tuple((b, t0) + TRAIN_MAIN[2:] for b, t0, _ in DECODE_LADDER)
# the llama predict's forward: one chunk of LM_PREDICT's 64 rows x 512
# tokens through the flagship's attention, held to its plain version in
# the kernel phase
PREDICT_SHAPE = (64, 512) + TRAIN_MAIN[2:]
# the MoE phase's attention (H8 KV4 d128, MoEConfig()'s): training at
# MOE_BATCH and predict's one chunk of MOE_PREDICT, each held to its
# plain versions in the kernel phases
MOE_TRAIN_SHAPE = (4, 2048, 8, 4, True, 128)
MOE_PREDICT_SHAPE = (64, 512, 8, 4, True, 128)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _plain_block(t):
    """The forward kernel's 128 x 128 tiles where T divides them, else
    one block (the reference's own blocking below T=128)."""
    return 128 if t % 128 == 0 else t


def _bound(b, t, h, kv, d, causal, flops_per_pair=4, q_like=2, kv_like=2,
           rows_f32=0):
    """Least time on the card: the larger of the FLOPs over the bf16 peak
    and the bytes over the HBM rate. ``flops_per_pair`` x d FLOPs per
    live (query, key) pair per query head (4 for the forward's two
    products, 2 more per further product); ``q_like`` bf16 [B,T,H,d]
    and ``kv_like`` bf16 [B,T,KV,d] tensors each read or written once,
    plus ``rows_f32`` f32 [B,H,T] rows (lse, delta). Returns (ms, what
    bounds it, FLOPs)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = float(flops_per_pair) * d * h * b * pairs
    nbytes = (2.0 * (q_like * b * t * h * d + kv_like * b * t * kv * d)
              + 4.0 * rows_f32 * b * h * t)
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"),
            flops)


def _check_out(got, want, what):
    """Max abs error; raises past 2e-2 + 2^-7 * |plain| elementwise."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol_ok = bool((diff <= 2e-2 + 2 ** -7 * want.float().abs()).all())
    if not (torch.isfinite(got.float()).all() and tol_ok):
        raise AssertionError(f"{what}: max abs err {err}")
    return err


def kernel_phase(card):
    """The primal forward against its plain version at KERNEL_SHAPES,
    DECODE_SHAPES, PREDICT_SHAPE and MOE_PREDICT_SHAPE
    (:func:`primal_kernel_row`); returns the rows by shape."""
    return {shape: primal_kernel_row(shape, card)
            for shape in (*KERNEL_SHAPES, *DECODE_SHAPES, PREDICT_SHAPE,
                          MOE_PREDICT_SHAPE)}


def primal_kernel_row(shape, card):
    """The primal forward kernel at one shape (B, T, H, KV, causal, d):
    held against its plain version (and at d=64 the lse variant too),
    then timed beside the plain version, SDPA and the bound. Prints and
    returns the row."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

    b, t, h, kv, causal, d = shape
    where = f"B={b} T={t} H={h} KV={kv} causal={causal} d={d}"
    gen = torch.Generator(device="cuda").manual_seed(b * t + causal + d)
    q, k, v = (
        torch.randn(b, t, n, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
        for n in (h, kv, kv)
    )
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    blk = _plain_block(t)
    want_out, want_lse = fa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                    blk)
    err = _check_out(got, want_out, f"flash_fwd at {where}")
    row = {"phase": "kernel", "kernel": "flash_fwd", "B": b, "T": t,
           "H": h, "KV": kv, "causal": causal, "d": d, "max_abs_err": err}
    if d == 64:  # the lse instantiations the training phase skips
        out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        row["lse_out_max_abs_err"] = _check_out(
            out, want_out, f"flash_fwd_lse at {where}")
        lse_err = float((lse - want_lse).abs().max())
        if not (torch.isfinite(lse).all() and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash_fwd_lse lse disagrees at "
                                 f"{where}: max abs err {lse_err}")
        row["lse_max_abs_err"] = lse_err
    del want_out, want_lse
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal), 20)
    bound_ms, bound_by, flops = _bound(b, t, h, kv, d, causal)
    row.update({
        "tol": "2e-2 + 2^-7*|plain|", "kernel_ms": kernel_ms,
        "kernel_call_ms": _time_ms(
            lambda: fa.flash_attention(q, k, v, causal), 20),
        "ref_ms": _time_ms(lambda: fa.flash_attention_ref(
            q, k, v, causal, blk, blk), 2, 1),
        "library_ms": device_ms(lib, 20),
        "bound_us": bound_ms * 1e3, "bound_ms": bound_ms,
        "bound_by": bound_by, "flops": flops,
        "tflops": flops / kernel_ms / 1e9,
        "card": card,
    })
    print(json.dumps(row), flush=True)
    return row


def _grad_err(got, want, name, where):
    """Max abs error; raises past 1e-2 * max|plain| + 2^-7 * |plain|."""
    import torch

    want = want.float()
    diff = (got.float() - want).abs()
    tol = GRAD_ATOL_OF_MAX * want.abs().max() + 2 ** -7 * want.abs()
    if not (torch.isfinite(got.float()).all() and bool((diff <= tol).all())):
        raise AssertionError(f"{name} disagrees at {where}: max abs err "
                             f"{float(diff.max())}, max |plain| "
                             f"{float(want.abs().max())}")
    return float(diff.max())


def train_kernel_phase(card):
    """lse forward, dQ and dK/dV kernels against their plain versions at
    TRAIN_SHAPES and MOE_TRAIN_SHAPE; returns the rows by shape."""
    return {shape: train_kernel_row(shape, card)
            for shape in (*TRAIN_SHAPES, MOE_TRAIN_SHAPE, MESH_TP_SHAPE,
                          MESH_FSDP_SHAPE)}


def train_kernel_row(shape, card):
    """The lse forward, dQ and dK/dV kernels at one training shape (B, T,
    H, KV, causal, d): held against their plain versions, then timed
    beside them, SDPA and the bound. Prints and returns the row."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

    b, t, h, kv, causal, d = shape
    where = f"B={b} T={t} H={h} KV={kv} causal={causal} d={d}"
    gen = torch.Generator(device="cuda").manual_seed(b * t + h + causal)
    q, do = (torch.randn(b, t, h, d, generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    blk = _plain_block(t)
    want_out, want_lse = fa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                    blk)
    _check_out(out, want_out, f"flash_fwd_lse output at {where}")
    lse_err = float((lse - want_lse).abs().max())
    if not (torch.isfinite(lse).all() and lse_err <= LSE_ATOL):
        raise AssertionError(f"flash_fwd_lse lse disagrees at {where}: "
                             f"max abs err {lse_err}")

    def plain_bwd():
        return fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                          blk, blk)

    wdq, wdk, wdv = plain_bwd()
    errs = {"dq": _grad_err(dq, wdq, "flash_bwd_dq", where),
            "dk": _grad_err(dk, wdk, "flash_bwd_dkv dk", where),
            "dv": _grad_err(dv, wdv, "flash_bwd_dkv dv", where)}
    del wdq, wdk, wdv
    plain_check_s = time.perf_counter() - t_plain

    # the library yardstick: SDPA forward (grad on, so it keeps its
    # logsumexp) and its backward, dq, dk and dv in one call
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def lib_fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    lib_out = lib_fwd()
    lib_fwd_ms = device_ms(lib_fwd, 10)
    lib_bwd_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 10)
    del lib_out
    delta = fa._delta(out, do).contiguous()
    fwd_ms = device_ms(
        lambda: fa.flash_attention_lse_cuda(q, k, v, causal), 10)
    dq_ms = device_ms(lambda: fa.flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, causal), 10)
    dkv_ms = device_ms(lambda: fa.flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, causal), 10)
    plain_fwd_ms = _time_ms(lambda: fa.flash_attention_lse_ref(
        q, k, v, causal, blk, blk), 1, 1)
    plain_bwd_ms = _time_ms(plain_bwd, 1, 1)
    bounds = {
        "flash_fwd_lse": _bound(b, t, h, kv, d, causal, 4, 2, 2, 1),
        "flash_bwd_dq": _bound(b, t, h, kv, d, causal, 6, 3, 2, 2),
        "flash_bwd_dkv": _bound(b, t, h, kv, d, causal, 8, 2, 4, 2),
        # the whole backward: FA2's five products, q k v o dO lse
        # delta read once, dq dk dv written once
        "backward": _bound(b, t, h, kv, d, causal, 10, 4, 4, 2),
    }
    row = {
        "phase": "train_kernels", "B": b, "T": t, "H": h, "KV": kv,
        "causal": causal, "d": d, "lse_max_abs_err": lse_err,
        "dq_max_abs_err": errs["dq"], "dk_max_abs_err": errs["dk"],
        "dv_max_abs_err": errs["dv"],
        "tol": {"lse": LSE_ATOL,
                "grads": "1e-2*max|plain| + 2^-7*|plain|"},
        "flash_fwd_lse_ms": fwd_ms, "flash_bwd_dq_ms": dq_ms,
        "flash_bwd_dkv_ms": dkv_ms, "plain_fwd_lse_ms": plain_fwd_ms,
        "plain_bwd_ms": plain_bwd_ms, "plain_check_s": plain_check_s,
        "library_fwd_ms": lib_fwd_ms,
        "library_bwd_ms": lib_bwd_ms,
        "bound_ms": {n: v[0] for n, v in bounds.items()},
        "bound_by": {n: v[1] for n, v in bounds.items()},
        "flops": {n: v[2] for n, v in bounds.items()},
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


def _slice_requests(vocab):
    """The slice phase's prompts (lengths in the buckets 8..1024) and
    new tokens a request."""
    rng = np.random.RandomState(0)
    lens = [5, 12, 30, 60, 100, 250, 500, 1000]
    return [rng.randint(0, vocab, n).tolist() for n in lens], 32


def slice_phase(card):
    """Returns the flash launches of the run, the model's (params, cfg),
    which the serving-modes and int8_serving phases reuse, the run's
    tokens/s and its ``ServingMetrics`` (the control phase's serving
    sample)."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash=True)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    metrics = ServingMetrics(registry=MetricsRegistry())
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=2048, horizon=8,
        metrics=metrics, device="cuda",
    )
    prompts, max_new = _slice_requests(cfg.vocab)
    lens = [len(p) for p in prompts]

    # warm-up request (cuBLAS handles, allocator), outside the counts
    eng.submit("warmup", prompts[0], 2)
    eng.run()

    prefills0 = metrics.dispatches["prefill"]
    fa.reset_launches()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for i in range(4):
        eng.submit(f"r{i}", prompts[i], max_new)
    eng.step()
    for i in range(4, 8):
        eng.submit(f"r{i}", prompts[i], max_new)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = fa.launch_counts()
    launches = counts["flash_fwd"]
    prefills = metrics.dispatches["prefill"] - prefills0
    if any(counts[k] for k in fa.KERNELS if k != "flash_fwd"):
        raise AssertionError(f"serving launched a training kernel: {counts}")

    if eng.recoveries:
        raise AssertionError(f"engine recovered {eng.recoveries} times")
    for i in range(8):
        r = res[f"r{i}"]
        if r.outcome != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"r{i}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= x < cfg.vocab for x in r.tokens):
            raise AssertionError(f"r{i}: token outside the vocab")
    if launches != prefills * cfg.n_layers or prefills < 8:
        raise AssertionError(f"flash launches {launches} != prefills "
                             f"{prefills} x {cfg.n_layers} layers")

    # teacher-forced agreement on the dense (non-flash) path
    dense = dataclasses.replace(cfg, use_flash=False)
    worst = 0.0
    for i in range(8):
        seq = prompts[i] + res[f"r{i}"].tokens
        toks = torch.tensor([seq[:-1]], device="cuda")
        logits = llama.forward(params, toks, dense)[0, len(prompts[i]) - 1:]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"r{i}: non-finite logits")
        chosen = logits.gather(
            1, torch.tensor(res[f"r{i}"].tokens, device="cuda")[:, None])[:, 0]
        margin = (logits.max(dim=1).values - chosen) / logits.std(dim=1)
        worst = max(worst, float(margin.max()))
        del logits
    if worst > TEACHER_EPS:
        raise AssertionError(f"teacher-forced margin {worst:.4f} row std "
                             f"> {TEACHER_EPS}")
    ttfts = [metrics.request_stats(f"r{i}")["ttft_s"] for i in range(8)]
    snap = metrics.snapshot()
    blk = metrics.block_hist.stats()
    row = {
        "phase": "slice", "model": "llama3_8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", "requests": 8, "prompt_lens": lens,
        "max_new": max_new, "prefills": prefills,
        "flash_launches": launches, "recoveries": eng.recoveries,
        "tokens_out": 8 * max_new, "wall_s": wall,
        "tokens_per_s": 8 * max_new / wall,
        "ttft_s": ttfts, "ttft_max_s": max(ttfts),
        # warm-up request included in these two
        "decode_blocks": snap["dispatches_decode"],
        "block_mean_s": blk["sum"] / max(blk["count"], 1),
        "teacher_forced_worst_margin_std": worst,
        "teacher_forced_eps_std": TEACHER_EPS,
        "init_params_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    print(json.dumps(row), flush=True)
    # the serving metrics: the control phase samples them at the end
    return launches, params, cfg, row["tokens_per_s"], metrics


OBS_FAULT_PLAN = "serve.dispatch:raise@n=2;serve.drain:raise@n=5"
OBS_EFF_MAX = 1.05  # every efficiency gauge in (0, OBS_EFF_MAX]
OBS_LEDGER_RTOL = 0.02  # ledger kv + slot_state vs the allocator's growth


def _obs_serve(params, cfg, metrics, prefix, plan=None):
    """The slice's feed (8 requests, half after the first step) on a
    fresh engine of the slice's shape; returns (engine, {i: tokens},
    fault counts)."""
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.utils import faults

    eng = ContinuousBatchingEngine(params, cfg, max_slots=8, max_len=2048,
                                   horizon=8, metrics=metrics, device="cuda")
    prompts, max_new = _slice_requests(cfg.vocab)
    if plan:
        faults.arm(plan, seed=0)
    try:
        for i in range(4):
            eng.submit(f"{prefix}{i}", prompts[i], max_new)
        eng.step()
        for i in range(4, 8):
            eng.submit(f"{prefix}{i}", prompts[i], max_new)
        res = eng.run()
        counts = faults.counts()
    finally:
        faults.disarm()
    for i in range(8):
        r = res[f"{prefix}{i}"]
        if r.outcome != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"obs {prefix}{i}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
    return eng, {i: res[f"{prefix}{i}"].tokens for i in range(8)}, counts


def obs_phase(card, params, cfg, slice_tps):
    """The engine's observability on the slice's model (Llama-3-8B, 32
    layers, bf16, flash; 8 slots x 2048, horizon 8): warm an engine on a
    private registry with the slice's requests, ``mark_warm``, then
    replay them on a fresh engine publishing into the default registry
    behind the HTTP exporter, and a third time under a fault plan.
    Gates: zero ``obs.recompile`` in the replay; ``edl_mfu`` and
    ``edl_bw_util_ratio`` for prefill and decode in (0, 1.05]; the
    ledger's ``params`` equal to the tree's bytes and its ``kv`` +
    ``slot_state`` within 2% of ``torch.cuda.memory_allocated``'s growth
    across an engine's construction; the replay's tokens equal the warm
    run's; both faults fire, and the faulted run's tokens keep the
    slice's teacher-forced margin (each request's first divergence from
    the replay is printed: bf16 recovery is not bit-exact); the scrape
    of ``/metrics``
    parses and declares every core family, ``/trace`` holds the
    ``serving.*`` spans and ``/events?rid=`` that request's events; the
    flight recorder's dump of the warm run and the replay passes
    ``postmortem DUMP --assert-no-incidents``, and its dump of the fault
    plan's run alone ``postmortem DUMP --assert-recovered`` (the fault
    -> recover -> re-prefill -> finish chains). Returns the replay's
    flash launches."""
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch import obs
    from edl_tpu_torch.obs import compilewatch, costmodel, memledger
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs import metrics as om
    from edl_tpu_torch.obs import profile
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics
    from edl_tpu_torch.utils import tracing
    from edl_tpu_torch.utils.tree import leaves

    t_phase = time.perf_counter()
    rec = flight.reset_default_recorder()
    tracing.tracer().clear()
    reg = om.default_registry()
    ledger = memledger.default_ledger()
    # warm: every program key of the feed meets its first call here (or
    # met it in the slice phase)
    warm, warm_tokens, _ = _obs_serve(params, cfg, ServingMetrics(
        registry=om.MetricsRegistry()), "w")
    del warm
    compilewatch.mark_warm()
    # the ledger against the allocator, across one engine's construction
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    probe = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=2048, horizon=8,
        metrics=ServingMetrics(registry=om.MetricsRegistry()),
        device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - alloc0
    owned = {c: ledger.owner_total(probe._ledger_owner, c)
             for c in ("params", "kv", "slot_state")}
    del probe
    tree_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    if owned["params"] != tree_bytes:
        raise AssertionError(f"ledger params {owned['params']} != the "
                             f"tree's {tree_bytes} bytes")
    held = owned["kv"] + owned["slot_state"]
    if abs(grown - held) > OBS_LEDGER_RTOL * held:
        raise AssertionError(
            f"ledger kv + slot_state {held} vs the allocator's growth "
            f"{grown} across construction (> {OBS_LEDGER_RTOL:.0%})")
    listener = obs.bridge_tracer()
    exporter = obs.start_exporter(port=0)
    try:
        rec0 = rec.counts().get("obs.recompile", 0)
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, want, _ = _obs_serve(params, cfg, ServingMetrics(registry=reg),
                                  "o")
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        launches = fa.launch_counts()["flash_fwd"]
        prefills = eng.metrics.dispatches["prefill"]
        recompiles = rec.counts().get("obs.recompile", 0) - rec0
        if recompiles:
            raise AssertionError(f"{recompiles} obs.recompile events in the "
                                 "warm replay")
        if want != warm_tokens:  # the engine is deterministic run to run
            raise AssertionError("the replay's tokens differ from the warm "
                                 "run's")
        if launches != prefills * cfg.n_layers:
            raise AssertionError(f"replay flash launches {launches} != "
                                 f"{prefills} prefills x {cfg.n_layers}")
        gauges = {}
        for metric in ("edl_mfu", "edl_bw_util_ratio"):
            for phase in ("prefill", "decode"):
                v = reg.get(metric).value(phase=phase)
                gauges[f"{metric}{{{phase}}}"] = v
                if not 0.0 < v <= OBS_EFF_MAX:
                    raise AssertionError(f"{metric}{{phase={phase}}} = {v} "
                                         f"outside (0, {OBS_EFF_MAX}]")
        step_bytes = costmodel.decode_step_bytes(
            cfg, eng._cost.param_bytes, 8, 2048)
        slice_share = slice_tps / 8 * step_bytes / PEAK_HBM_BYTES
        crosscheck = ledger.crosscheck()
        # the scrape, while the replay engine still holds its entries
        text = obs.scrape(exporter.url)
        fams = om.parse_prometheus_text(text)
        typed = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        core = {f.name for f in om.ensure_core_series(
            om.MetricsRegistry()).families()}
        if not core <= typed or not fams:
            raise AssertionError(f"/metrics lacks {sorted(core - typed)}")
        report = profile.report_from_fams(fams, source=exporter.url)
        doc = json.loads(obs.scrape(exporter.url, "/trace"))
        span_counts = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e["name"].startswith("serving."):
                span_counts[e["name"]] = span_counts.get(e["name"], 0) + 1
        for name in ("serving.dispatch", "serving.drain", "serving.prefill"):
            if not span_counts.get(name):
                raise AssertionError(f"/trace has no {name} span")
        recs = [json.loads(x) for x in
                obs.scrape(exporter.url, "/events?rid=o3").splitlines()]
        kinds = [r["kind"] for r in recs]
        if (any(r["corr"].get("rid") != "o3" for r in recs)
                or kinds[:1] != ["serve.submit"]
                or kinds[-1:] != ["serve.finish"]):
            raise AssertionError(f"/events?rid=o3 gave {kinds}")
        del eng
    finally:
        exporter.stop()
        tracing.tracer().remove_listener(listener)
    # the fault-free timeline (the warm run and the replay) for the
    # postmortem verb; the fault plan's run records alone after it
    pm_dir = tempfile.mkdtemp(prefix="edl_postmortem_")
    clean_dump = os.path.join(pm_dir, "replay.jsonl")
    rec.dump(clean_dump)
    rec.clear()
    # the fault plan: recovery re-prefills from prompt + generated
    fault_eng, got, counts = _obs_serve(params, cfg, ServingMetrics(
        registry=om.MetricsRegistry()), "o", plan=OBS_FAULT_PLAN)
    recoveries = fault_eng.recoveries
    del fault_eng
    fault_dump = os.path.join(pm_dir, "faults.jsonl")
    rec.dump(fault_dump)
    postmortem = {}
    try:
        for name, path, flag in (
                ("replay", clean_dump, "--assert-no-incidents"),
                ("fault_plan", fault_dump, "--assert-recovered")):
            out, secs = _run_verb(["postmortem", path, flag])
            if "postmortem assertions OK" not in out:
                raise AssertionError(f"postmortem {flag}: {out[-2000:]}")
            with open(path) as f:
                n_events = sum(1 for _ in f) - 1  # the meta line
            postmortem[name] = {"assert": flag, "events": n_events,
                                "seconds": secs}
    finally:
        shutil.rmtree(pm_dir, ignore_errors=True)
    if counts != {"serve.dispatch": 1, "serve.drain": 1} or not recoveries:
        raise AssertionError(f"fault plan fired {counts}, {recoveries} "
                             "recoveries")
    # a recovery re-prefills in one pass what the decode steps built one
    # position at a time; bf16 rounds the two differently, so after a
    # recovery a near-tie may resolve the other way. Each request's first
    # divergence is recorded, and the faulted tokens are held to the
    # slice's bf16 criterion: every chosen token within TEACHER_EPS row
    # std of its row's maximum on the dense forward over its own prefix
    # (exact identity is held in f32: the card test
    # test_cuda_fault_plan_recovery_gives_the_same_tokens, and the CPU
    # tests against the JAX engine)
    diverged = {i: next(j for j, (a, b) in enumerate(zip(got[i], want[i]))
                        if a != b) for i in range(8) if got[i] != want[i]}
    prompts = _slice_requests(cfg.vocab)[0]
    fault_margin = max(_teacher_margin(params, cfg, prompts[i], got[i],
                                       "cuda") for i in range(8))
    if fault_margin > TEACHER_EPS:
        raise AssertionError(f"faulted run's teacher-forced margin "
                             f"{fault_margin:.4f} row std > {TEACHER_EPS}")
    cs = reg.get("edl_compile_seconds")
    compiles = {}
    for (program,), _ in reg.get("edl_compiles_total").samples():
        st = cs.stats(program=program)
        compiles[program] = {"programs": st["count"], "seconds": st["sum"]}
    print("# " + profile.render_report(report).replace("\n", "\n# "),
          flush=True)
    row = {
        "phase": "obs", "model": "llama3_8b", "layers": cfg.n_layers,
        "requests": 8, "replay_s": replay_s,
        "replay_tokens_per_s": 8 * _slice_requests(cfg.vocab)[1] / replay_s,
        "recompiles_after_warm": recompiles, "compiles": compiles,
        "efficiency": gauges, "efficiency_max": OBS_EFF_MAX,
        "slice_decode_bw_share": slice_share,
        "decode_step_bytes": step_bytes,
        "ledger": {**owned, "tree_bytes": tree_bytes,
                   "alloc_growth_bytes": grown,
                   "held_over_growth_minus_1": held / grown - 1.0},
        "crosscheck": crosscheck, "fault_plan": OBS_FAULT_PLAN,
        "faults": counts, "recoveries": recoveries,
        "postmortem": postmortem,
        "replay_equals_warm": True,
        "faulted_tokens_equal": not diverged,
        "faulted_first_divergence": diverged,
        "faulted_teacher_forced_worst_margin_std": fault_margin,
        "teacher_forced_eps_std": TEACHER_EPS, "flash_launches": launches,
        "prefills": prefills, "trace_spans": span_counts,
        "scrape_families": len(typed), "events_o3": kinds,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    print(json.dumps(row), flush=True)
    return launches


def _teacher_margin(params, cfg, prompt, tokens, device):
    """Worst (row max - chosen logit) / row std over the generated
    tokens, on the dense (non-flash) forward over prompt + generated;
    raises on non-finite logits."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama

    dense = dataclasses.replace(cfg, use_flash=False)
    seq = prompt + tokens
    toks = torch.tensor([seq[:-1]], device=device)
    logits = llama.forward(params, toks, dense)[0, len(prompt) - 1:]
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    chosen = logits.gather(
        1, torch.tensor(tokens, device=device)[:, None])[:, 0]
    margin = (logits.max(dim=1).values - chosen) / logits.std(dim=1)
    return float(margin.max())


def _block_mean(metrics):
    """Mean dispatch-to-drain seconds of a run's decode / verify blocks."""
    st = metrics.block_hist.stats()
    return st["sum"] / max(st["count"], 1)


def _serve_modes_part(params, cfg, kv_quant, device, reqs, waves=None,
                      **kw):
    """One engine run of the serving-modes phase: ``reqs`` [(rid,
    prompt, max_new)] submitted in ``waves`` (lists of rids, each run to
    completion before the next), on the paged engine with ``kw``.
    Returns (engine, results, wall seconds, the rids preempted, in
    order: the run's ``serve.preempt`` flight events)."""
    import torch

    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    rec = flight.default_recorder()
    seen = rec.events()
    seq0 = seen[-1].seq if seen else 0
    n0 = rec.counts().get("serve.preempt", 0)
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=SM_MAX_LEN, horizon=8,
        block_size=SM_BLOCK, kv_quant=kv_quant,
        metrics=ServingMetrics(registry=MetricsRegistry()), device=device,
        **kw)
    prompts = {rid: (p, n) for rid, p, n in reqs}
    res = {}
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves or [list(prompts)]:
        for rid in wave:
            eng.submit(rid, prompts[rid][0], prompts[rid][1])
        res.update(eng.run())
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    preempted = [e.corr["rid"] for e in rec.events(kind="serve.preempt")
                 if e.seq > seq0]
    if len(preempted) != rec.counts().get("serve.preempt", 0) - n0:
        raise AssertionError("the flight ring dropped serve.preempt events")
    if eng.recoveries:
        raise AssertionError(f"{kv_quant}: engine recovered "
                             f"{eng.recoveries} times")
    for rid, (_, n) in prompts.items():
        r = res[rid]
        if r.outcome != "done" or len(r.tokens) != n:
            raise AssertionError(f"{kv_quant} {rid}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= x < cfg.vocab for x in r.tokens):
            raise AssertionError(f"{kv_quant} {rid}: token outside the vocab")
    return eng, res, wall, preempted


def serving_modes_phase(card, params, cfg, device="cuda"):
    """The paged engine at the slice's width (Llama-3-8B, 8 slots x
    SM_MAX_LEN, horizon 8, block SM_BLOCK) under each kv_quant: (a) the
    prefix cache with chunked prefill, (b) preemption in a tight pool,
    (c) speculative decoding. No flash kernel runs on this path."""
    from edl_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(1)
    vocab = cfg.vocab
    # (a) a cold request with a shared prefix runs first (a prompt's
    # blocks enter the prefix cache after its last prefill dispatch),
    # then warm ones with other tails beside a long prompt that shares
    # nothing with the prefix and prefills in chunks
    prefix = rng.randint(0, vocab // 2, SM_PREFIX).tolist()
    tails = rng.randint(0, vocab // 2, (6, SM_TAIL))
    tails[:, 0] = np.arange(6)  # every tail's first block differs
    long_p = rng.randint(vocab // 2, vocab, SM_LONG).tolist()
    a_reqs = ([("cold", prefix + tails[0].tolist(), SM_NEW)]
              + [(f"warm{j}", prefix + tails[j].tolist(), SM_NEW)
                 for j in range(1, 6)]
              + [("long", long_p, SM_NEW)])
    a_waves = [["cold"], [f"warm{j}" for j in range(1, 6)] + ["long"]]
    # (b) prompts that fill the pool at admission, so decode growth
    # preempts
    b_reqs = [(f"p{j}", rng.randint(0, vocab, SM_PRESSURE_PROMPT).tolist(),
               SM_NEW) for j in range(8)]
    # (c) prompts of a repeating 64-token pattern, for the n-gram drafter
    c_reqs = [(f"s{j}", rng.randint(0, vocab, 64).tolist() * SM_REPEATS,
               2 * SM_NEW) for j in range(8)]
    hit_blocks = SM_PREFIX // SM_BLOCK
    long_dispatches = -(-SM_LONG // SM_CHUNK)
    rows, pool_bytes = [], {}
    fa.reset_launches()
    for kv_quant in ("off", "int8", "int4"):
        row = {"phase": "serving_modes", "kv_quant": kv_quant,
               "model": "llama3_8b", "layers": cfg.n_layers,
               "max_len": SM_MAX_LEN, "block_size": SM_BLOCK}
        # (a)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, a_reqs, a_waves,
            prefix_cache=True, prefill_chunk=SM_CHUNK)
        m = eng.metrics
        ttft = {rid: m.request_stats(rid)["ttft_s"] for rid in res}
        prefill_s = {rid: m.phase_breakdown(rid)["prefill_s"] for rid in res}
        hits = eng._prefix.hits
        # the cold prompt's own hits are 0: its blocks were not cached
        if hits != 5 * hit_blocks:
            raise AssertionError(f"{kv_quant}: prefix hits {hits} != 5 x "
                                 f"{hit_blocks}")
        # cold: its chunks + final; warm: one each; long: its chunks
        cold_dispatches = -(-(SM_PREFIX + SM_TAIL) // SM_CHUNK)
        pf = m.dispatches["prefill"]
        if pf != cold_dispatches + 5 + long_dispatches:
            raise AssertionError(
                f"{kv_quant}: {pf} prefill dispatches, want {cold_dispatches}"
                f" + 5 + {long_dispatches} (the long prompt's chunks)")
        pool_bytes[kv_quant] = eng.kv_nbytes
        worst_a = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device)
                      for rid, p, _ in a_reqs if rid in ("cold", "warm1",
                                                         "long"))
        row["prefix_chunk"] = {
            "requests": len(a_reqs), "tokens_per_s": sum(
                len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "prefix_hit_blocks": hits,
            "prefill_dispatches": pf,
            "long_prefill_dispatches": long_dispatches,
            "ttft_cold_s": ttft["cold"],
            "ttft_warm_s": [ttft[f"warm{j}"] for j in range(1, 6)],
            "prefill_cold_s": prefill_s["cold"],
            "prefill_warm_s": [prefill_s[f"warm{j}"] for j in range(1, 6)],
            "ttft_long_s": ttft["long"], "preemptions": len(pre),
            "block_mean_s": _block_mean(m), "pool_mb": eng.kv_nbytes / 2**20,
        }
        del eng
        # (b)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, b_reqs,
            pool_blocks=SM_PRESSURE_POOL)
        if not pre:
            raise AssertionError(f"{kv_quant}: no preemption in a pool of "
                                 f"{SM_PRESSURE_POOL} blocks")
        # the preempted requests restarted by recomputation into blocks
        # that others held: their tokens are the ones to hold
        sample = sorted(set(pre)) + [r for r, _, _ in b_reqs[:2]
                                     if r not in pre]
        worst_b = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device)
                      for rid, p, _ in b_reqs if rid in sample)
        row["preempt"] = {
            "requests": len(b_reqs), "pool_blocks": SM_PRESSURE_POOL,
            "tokens_per_s": sum(len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "preemptions": len(pre), "preempted": pre,
            "margin_sample": sample,
            "prefill_dispatches": eng.metrics.dispatches["prefill"],
            "block_mean_s": _block_mean(eng.metrics),
            "pool_mb": eng.kv_nbytes / 2**20,
        }
        del eng
        # (c)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, c_reqs, spec_k=4)
        snap = eng.metrics.snapshot()
        if snap["spec_drafted"] <= 0:
            raise AssertionError(f"{kv_quant}: speculation drafted nothing")
        worst_c = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device) for rid, p, _ in c_reqs[:3])
        row["spec"] = {
            "requests": len(c_reqs), "spec_k": 4,
            "tokens_per_s": sum(len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "drafted": snap["spec_drafted"],
            "accepted": snap["spec_accepted"],
            "acceptance": snap["spec_acceptance_rate"],
            "verify_dispatches": snap["dispatches_verify"],
            "decode_dispatches": snap["dispatches_decode"],
            "block_mean_s": _block_mean(eng.metrics), "preemptions": len(pre),
        }
        del eng
        worst = max(worst_a, worst_b, worst_c)
        gate = SM_TEACHER_EPS[kv_quant]
        if gate is not None and worst > gate:
            raise AssertionError(f"{kv_quant}: teacher-forced margin "
                                 f"{worst:.4f} row std > {gate}")
        row.update({"teacher_forced_worst_margin_std": worst,
                    "teacher_forced_eps_std": gate, "card": card})
        rows.append(row)
        print(json.dumps(row), flush=True)
    counts = fa.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the paged engine launched kernels: {counts}")
    for kv_quant, most in (("int8", 0.51), ("int4", 0.26)):
        ratio = pool_bytes[kv_quant] / pool_bytes["off"]
        if ratio > most:
            raise AssertionError(f"{kv_quant} pool {ratio:.4f} of float's "
                                 f"> {most}")
    print(json.dumps({
        "phase": "serving_modes_summary", "flash_launches": counts,
        "pool_mb": {k: v / 2**20 for k, v in pool_bytes.items()},
        "pool_ratio": {k: pool_bytes[k] / pool_bytes["off"]
                       for k in ("int8", "int4")},
        "card": card}), flush=True)
    return rows


def _flagship_train_config():
    """bench.py:69 ``flagship_train_config``, as a literal: d2048/L16/
    H16/KV8/ff6144/v32768, bf16 activations (f32 masters), flash
    attention, full per-layer remat."""
    import torch

    from edl_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=6144, dtype=torch.bfloat16, use_flash=True, remat=True)


def _dense_agreement(params, cfg, batch):
    """Flash vs dense (use_flash=False, plain autograd attention) loss
    and gradients at the same params and batch."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    f_loss, f_grads = trainer.value_and_grad(llama.make_loss_fn(cfg))(
        params, batch)
    dense = dataclasses.replace(cfg, use_flash=False)
    d_loss, d_grads = trainer.value_and_grad(llama.make_loss_fn(dense))(
        params, batch)
    cos = {}
    for (name, a), b in zip(_named_leaves(f_grads), trainer.leaves(d_grads)):
        cos[name] = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
    del f_grads, d_grads
    rel = abs(float(f_loss) - float(d_loss)) / abs(float(d_loss))
    worst = min(cos, key=cos.get)
    if not (rel <= LOSS_RTOL and cos[worst] >= GRAD_MIN_COS):
        raise AssertionError(
            f"flash vs dense: loss {float(f_loss)} vs {float(d_loss)} "
            f"(rel {rel:.3g} > {LOSS_RTOL}?), worst grad cosine "
            f"{cos[worst]:.5f} on {worst} (< {GRAD_MIN_COS}?)")
    return {"flash_loss": float(f_loss), "dense_loss": float(d_loss),
            "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
            "grad_min_cos": cos[worst], "grad_min_cos_leaf": worst,
            "grad_cos_gate": GRAD_MIN_COS}


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix, tree)]


def train_phase(card, profile: bool):
    """The flagship at full width and depth through make_train_step."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.train import trainer

    cfg = _flagship_train_config()
    b, t = 4, 2048
    # one batch, every step: the loss must fall on it
    batch = {"tokens": torch.from_numpy(llama.synthetic_tokens(
        np.random.RandomState(0), b, t, cfg.vocab)["tokens"]).cuda()}
    params = trainer.trainable(
        llama.init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
    agree = _dense_agreement(params, cfg, batch)
    torch.cuda.empty_cache()

    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
    state, m = step(state, batch)  # warm-up (allocator, cuBLAS)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()

    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # per step: the forward and the remat recompute both run with grad
    # on, so each runs the lse forward once per layer; each backward
    # sweep runs once per layer; the primal (no-grad) forward never
    L = cfg.n_layers
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L}
    if counts != {k: TRAIN_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps {counts}, "
                             f"want {want} per step")
    step_s = wall / TRAIN_STEPS
    tok_s = b * t / step_s
    flops_tok = llama.train_flops_per_token(cfg, t)
    row = {
        "phase": "train", "model": "flagship_train (bench.py:69)",
        "layers": L, "batch": b, "seq": t, "params_f32": True,
        "remat": "full", "optimizer": "adamw(1e-3)", "steps": TRAIN_STEPS,
        "losses": losses, "launches": counts, "launches_per_step": want,
        "step_s": step_s, "tokens_per_s": tok_s,
        "train_flops_per_token": flops_tok,
        "mfu": flops_tok * tok_s / PEAK_BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **agree, "card": card,
    }
    print(json.dumps(row), flush=True)
    if profile:
        _profile_step(card, step, state, batch, llama, cfg, step_s)
    return counts


def _counter():
    """A TorchDispatchMode that counts the flash forward ops
    (``edl_tpu_torch::flash_fwd``, one ``flash_fwd_lse`` launch each on
    the card) and the weight products that run with grad on, or (under
    ``int8_mxu``) every ``edl_tpu_torch::int8_matmul`` op, whose
    autograd runs its forward with grad off: under a backward, those
    are the remat's recompute (the backward's own products run with
    grad off and none is an int8_matmul op)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import edl_tpu_torch.ops.int8_matmul  # noqa: F401 (registers the op)

    mm = torch.ops.aten.mm.default
    i8 = torch.ops.edl_tpu_torch.int8_matmul.default
    flash = torch.ops.edl_tpu_torch.flash_fwd.default

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flash_fwd = self.mm_grad_on = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == flash:
                self.flash_fwd += 1
            elif func == i8 or (func == mm and torch.is_grad_enabled()):
                self.mm_grad_on += 1
            return func(*args, **(kwargs or {}))

    return Counter()


def _remat_step(params, cfg, batch):
    """One ``value_and_grad`` of the Llama loss under ``cfg``, counted:
    returns (loss, grads in leaf order, {"flash_fwd_ops": the flash
    forward ops of the step, "recomputed_mm": the weight products its
    backward recomputed})."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    fwd, bwd = _counter(), _counter()
    with fwd:
        loss = llama.make_loss_fn(cfg)(params, batch)
    ps = [p for p in trainer.leaves(params) if p.requires_grad]
    with bwd:
        grads = list(torch.autograd.grad(loss, ps))
    return loss.detach(), grads, {"flash_fwd_ops": fwd.flash_fwd
                                  + bwd.flash_fwd,
                                  "recomputed_mm": bwd.mm_grad_on}


def _remat_check(policy, n_layers, counts, lse_launches, loss, grads,
                 ref_loss, ref_grads):
    """The remat_policies gates for one policy: the flash forward ops,
    the ``flash_fwd_lse`` launches and the recomputed weight products
    equal the reckoned counts; loss and every gradient leaf equal
    "full"'s (``ref_*``) within REMAT_LOSS_RTOL and REMAT_GRAD_OF_MAX of
    the leaf's largest entry. Raises; returns the differences."""
    lse = REMAT_LSE_PER_LAYER[policy] * n_layers
    want = {"flash_fwd_ops": lse, "flash_fwd_lse_launches": lse,
            "recomputed_mm": REMAT_RECOMPUTED_MM[policy] * n_layers}
    got = {**counts, "flash_fwd_lse_launches": lse_launches}
    if got != want:
        raise AssertionError(f"remat {policy!r}: counts {got}, want {want}")
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst = diff = 0.0
    for g, r in zip(grads, ref_grads, strict=True):
        d = float((g - r).abs().max())
        diff = max(diff, d)
        worst = max(worst, d / max(float(r.abs().max()), 1e-30))
    if not (loss_rel <= REMAT_LOSS_RTOL and worst <= REMAT_GRAD_OF_MAX):
        raise AssertionError(
            f"remat {policy!r} vs 'full': loss rel diff {loss_rel} (limit "
            f"{REMAT_LOSS_RTOL}), worst gradient leaf {worst} of its max "
            f"(limit {REMAT_GRAD_OF_MAX})")
    return {"counts": got, "loss_rel_diff_vs_full": loss_rel,
            "grad_worst_of_leaf_max_vs_full": worst,
            "grad_max_abs_diff_vs_full": diff}


def remat_policies_phase(card):
    """The flagship (full width and depth) at B4 T2048, the same params
    and batch under each remat policy: one counted ``value_and_grad``
    (the gates, :func:`_remat_check`), then the best of 3 uncounted
    ones for the step time and the peak memory. Returns the
    ``flash_fwd_lse`` launches of each policy's step."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.train import trainer

    cfg0 = _flagship_train_config()
    b, t = 4, 2048
    batch = {"tokens": torch.from_numpy(llama.synthetic_tokens(
        np.random.RandomState(0), b, t, cfg0.vocab)["tokens"]).cuda()}
    params = trainer.trainable(
        llama.init_params(cfg0, seed=0, device="cuda", dtype=torch.float32))
    vg = trainer.value_and_grad
    vg(llama.make_loss_fn(cfg0))(params, batch)  # warm-up (allocator, cuBLAS)
    ref = None
    launches = {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        fa.reset_launches()
        loss, grads, counts = _remat_step(params, cfg, batch)
        torch.cuda.synchronize()
        lse = fa.launch_counts()["flash_fwd_lse"]
        launches[policy] = lse
        if ref is None:
            ref = (loss, grads)
        gates = _remat_check(policy, cfg.n_layers, counts, lse, loss, grads,
                             *ref)
        del grads
        loss_fn = llama.make_loss_fn(cfg)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = vg(loss_fn)(params, batch)
            torch.cuda.synchronize()
            step_s = min(step_s, time.perf_counter() - t0)
            del out
        print(json.dumps({
            "phase": "remat_policies", "policy": policy,
            "model": "flagship_train (bench.py:69)", "layers": cfg.n_layers,
            "batch": b, "seq": t, "loss": float(loss),
            "recomputed_mm_per_layer": REMAT_RECOMPUTED_MM[policy],
            "flash_fwd_lse_per_layer": REMAT_LSE_PER_LAYER[policy], **gates,
            "loss_rtol": REMAT_LOSS_RTOL, "grad_of_max": REMAT_GRAD_OF_MAX,
            "value_and_grad_s": step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_above_start_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9,
            "card": card,
        }), flush=True)
    del ref, params
    return launches


def _adafactor_small_run(device):
    """Three ``adafactor(1e-3)`` steps of a small f32 Llama (AF_SMALL,
    dense attention) on ``device``, from the same params and batches on
    every device: returns (losses, state)."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    cfg = llama.LlamaConfig(**AF_SMALL, dtype=torch.float32)
    params = llama.init_params(cfg, seed=2, device="cpu")
    params = trainer.replace_leaves(
        params, [p.to(device) for p in trainer.leaves(params)])
    rng = np.random.RandomState(2)
    tx = trainer.adafactor(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
    losses = []
    for _ in range(3):
        nb = llama.synthetic_tokens(rng, *AF_SMALL_BATCH, cfg.vocab)
        state, m = step(state, trainer.global_batch(nb, device=device))
        losses.append(float(m["loss"]))
    return losses, state


def _adafactor_agreement(cpu, card):
    """Two :func:`_adafactor_small_run` results: losses, params and the
    second-moment statistics (``v_row``, ``v_col``, ``v``) within
    AF_CPU_OF_MAX of each leaf's largest entry (the losses: of the
    loss). Raises; returns the worst ratio and the statistics' count."""
    from edl_tpu_torch.train import trainer

    (lc, sc), (ld, sd) = cpu, card

    def keyed(st):
        out = {f"p{i}": p.detach().cpu()
               for i, p in enumerate(trainer.leaves(st.params))}
        out.update({f"o{i}/{n}": t.cpu()
                    for i, n, t, _ in trainer.optimizer_tensors(st)
                    if n != "step"})
        return out

    a, b = keyed(sc), keyed(sd)
    if a.keys() != b.keys():
        raise AssertionError(f"adafactor states differ in keys: "
                             f"{sorted(a.keys() ^ b.keys())}")
    worst = max(abs(x - y) / abs(x) for x, y in zip(lc, ld, strict=True))
    for k in a:
        den = max(float(a[k].abs().max()), 1e-30)
        worst = max(worst, float((a[k] - b[k]).abs().max()) / den)
    if not worst <= AF_CPU_OF_MAX:
        raise AssertionError(f"adafactor steps on the card vs the CPU: off "
                             f"by {worst} of a leaf's largest entry (limit "
                             f"{AF_CPU_OF_MAX})")
    return worst, sum(k.startswith("o") for k in a)


def _ladder_check(losses, counts, n_layers, steps, int8_calls=None,
                  int8=False):
    """A ladder rung's gates: finite losses that fall from the first step
    to the last, and per step 2L ``flash_fwd_lse`` (the forward and the
    full remat's recompute), L of each backward sweep and no primal
    forward launch; with ``int8_calls`` (the ``int8_matmul`` op's
    forward and backward calls), per step 2 x 7L forward calls (7 a
    layer in the forward and again in its recompute) and 7L backward
    calls on an ``int8`` rung, none on a bf16 one. Raises."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ladder loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ladder loss did not fall: {losses}")
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    if counts != {k: steps * v for k, v in want.items()}:
        raise AssertionError(f"ladder launches over {steps} steps {counts}, "
                             f"want {want} a step")
    if int8_calls is not None:
        per = I8_PER_LAYER * n_layers if int8 else 0
        want = {"fwd": 2 * per, "bwd": per}
        if int8_calls != {k: steps * v for k, v in want.items()}:
            raise AssertionError(f"ladder int8_matmul calls over {steps} "
                                 f"steps {int8_calls}, want {want} a step")


def _ladder_rung(cfg, t, ladder, lreps, rng):
    """bench.py:_llama_measure on the port: adafactor(1e-3) through
    ``make_train_multistep`` (LADDER_STEPS steps a call), one warm-up
    call, then the best of LADDER_LOOPS loops of ``lreps`` calls, at the
    first batch of ``ladder`` that fits. A rung steps down only when the
    card runs out of memory; any other failure raises."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.train import trainer

    tx = trainer.adafactor(1e-3)
    tried = []
    for per_chip in ladder:
        try:
            state = trainer.TrainState.create(llama.init_params(
                cfg, seed=1, device="cuda", dtype=torch.float32), tx)
            toks = trainer.stack_batches(
                [llama.synthetic_tokens(rng, per_chip, t, cfg.vocab)
                 for _ in range(LADDER_STEPS)], device="cuda")
            multi = trainer.make_train_multistep(llama.make_loss_fn(cfg), tx)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            im.reset_calls()
            t0 = time.perf_counter()
            state, m = multi(state, toks)
            losses = [m["losses"]]
            float(m["loss"])  # warm-up fence
            first_s = time.perf_counter() - t0
            rate = 0.0
            for _ in range(LADDER_LOOPS):
                t0 = time.perf_counter()
                for _ in range(lreps):
                    state, m = multi(state, toks)
                    losses.append(m["losses"])
                float(m["loss"])
                rate = max(rate, lreps * LADDER_STEPS * per_chip * t
                           / (time.perf_counter() - t0))
        except torch.cuda.OutOfMemoryError as e:
            if per_chip == ladder[-1]:
                raise
            tried.append({"batch": per_chip, "error": str(e)[:160]})
        else:
            steps = LADDER_STEPS * (1 + LADDER_LOOPS * lreps)
            counts = fa.launch_counts()
            calls = dict(im.calls)
            losses = [float(x) for x in torch.cat(losses)]
            _ladder_check(losses, counts, cfg.n_layers, steps, calls,
                          cfg.int8_mxu)
            return {"T": t, "batch": per_chip, "out_of_memory": tried,
                    "tokens_per_s_per_chip": rate, "steps": steps,
                    "first_call_s": first_s, "losses": losses,
                    "launches": counts, "int8_matmul_calls": calls,
                    "state_gb": ckpt.state_nbytes(state) / 2 ** 30,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        finally:
            state = toks = multi = m = None
            torch.cuda.empty_cache()
        print(f"# train_ladder: batch {per_chip} at T={t} ran out of "
              f"memory, stepping down", flush=True)
    raise AssertionError("unreachable: the last rung returns or raises")


def train_ladder_phase(card):
    """bench.py's flagship ladder (``_llama_flagship_bench``) on the
    port: three small adafactor steps on the card against the CPU
    (:func:`_adafactor_agreement`), then the bf16 rungs at T=2048 and
    T=8192 (:func:`_ladder_rung`), tokens/s/chip and MFU of each, then
    the int8 rungs (bench.py:205-212: the same config with
    ``int8_mxu``, the same ladders): their tokens/s/chip, ``int8_mfu``
    and ``int8_long_mfu`` over the bf16 peak, as bench.py publishes
    them, and ``int8_train_speedup`` / ``int8_long_speedup`` over the
    bf16 rung, or -1 when the two settled on different batches
    (bench.py:227-247). Returns each rung's batch and launches by
    (T, "bf16" or "int8")."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama

    worst, n_stats = _adafactor_agreement(_adafactor_small_run("cpu"),
                                          _adafactor_small_run("cuda"))
    cfg = _flagship_train_config()
    rng = np.random.RandomState(0)
    rows = {}
    for kind, rcfg in (("bf16", cfg),
                       ("int8", dataclasses.replace(cfg, int8_mxu=True))):
        for i, (t, ladder, lreps) in enumerate(LADDER_RUNGS):
            r = _ladder_rung(rcfg, t, ladder, lreps, rng)
            fpt = llama.train_flops_per_token(cfg, t)
            rows[t, kind] = r
            rate = r["tokens_per_s_per_chip"]
            mfu = ("long_mfu" if i else "mfu")
            extra = {mfu: rate * fpt / PEAK_BF16_FLOPS}
            if kind == "int8":
                base = rows[t, "bf16"]
                speedup = ("int8_long_speedup" if i
                           else "int8_train_speedup")
                extra = {
                    "int8_tokens_per_sec_per_chip": rate,
                    f"int8_{mfu}": rate * fpt / PEAK_BF16_FLOPS,
                    speedup: (rate / base["tokens_per_s_per_chip"]
                              if r["batch"] == base["batch"] else -1.0),
                    "bf16_batch": base["batch"]}
            print(json.dumps({
                "phase": "train_ladder", "kind": kind,
                "model": "flagship_train (bench.py:69)",
                "int8_mxu": rcfg.int8_mxu,
                "optimizer": "adafactor(1e-3)", "remat": "full",
                "ladder": ladder, "steps_per_call": LADDER_STEPS,
                "calls_per_loop": lreps, "loops": LADDER_LOOPS, **r,
                "train_flops_per_token": fpt, **extra,
                "small_steps_vs_cpu_worst_of_leaf_max": worst,
                "small_steps_statistics": n_stats,
                "small_steps_of_max": AF_CPU_OF_MAX, "card": card,
            }), flush=True)
            torch.cuda.empty_cache()
    return {key: (r["batch"], r["launches"]) for key, r in rows.items()}


def _int8_product_row(k, n, m, device, card):
    """One int8 product shape [m, k] x [k, n]: ``int8_matmul``'s
    forward, dgrad and wgrad on ``device`` held against the same op
    sequence on the CPU (I8_ROWS rows of the forward and dgrad, an
    I8_COLS block of wgrad), then timed beside bf16 ``torch.mm``.
    Raises on a disagreement; prints and returns the row."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(k + n)
    a = torch.randn(m, k, generator=gen, device=device).to(bf16)
    w = torch.randn(k, n, generator=gen, device=device) * k ** -0.5
    g = torch.randn(m, n, generator=gen, device=device).to(bf16)
    a.requires_grad_()
    w.requires_grad_()
    y = im.int8_matmul(a, w)
    da, dw = torch.autograd.grad(y, (a, w), g)
    a, w = a.detach(), w.detach()
    where = f"M{m} K{k} N{n}"

    def cpu(x):
        return x.detach().cpu()

    def equal(name, got, want):
        if not torch.equal(cpu(got), want):
            raise AssertionError(f"int8 {name} at {where}: the card's != "
                                 f"the CPU's")

    def close(name, got, want, rel):
        diff = (cpu(got).float() - want.float()).abs()
        if not bool((diff <= rel * want.float().abs()).all()):
            raise AssertionError(f"int8 {name} at {where}: max abs err "
                                 f"{float(diff.max())} past {rel} relative")
        return float(diff.max())

    r, c, q = I8_ROWS, I8_COLS, im.absmax_quant
    errs = {}
    with torch.no_grad():
        # forward: rows of a (per-row scales) by every column of w
        qa, sa = q(a, 1)
        qw, sw = q(w, 0)
        qa_c, sa_c = q(cpu(a[:r]), 1)
        qw_c, sw_c = q(cpu(w), 0)
        for name, got, want in (("qa", qa[:r], qa_c), ("sa", sa[:r], sa_c),
                                ("qw", qw, qw_c), ("sw", sw, sw_c)):
            equal(name, got, want)
        acc_c = im._dot8(qa_c, qw_c)
        equal("forward int32", im._dot8(qa, im._k_inner(qw))[:r], acc_c)
        errs["forward"] = close("forward", y[:r], im._scaled(
            acc_c, sa_c, sw_c).to(bf16), I8_BF16_REL)
        del qa, sa
        # dgrad: rows of g (per-row scales) by every row of w
        qg, sg = q(g, 1)
        qwn, swn = q(w, 1)
        qg_c, sg_c = q(cpu(g[:r]), 1)
        qwn_c, swn_c = q(cpu(w), 1)
        for name, got, want in (("qg", qg[:r], qg_c), ("sg", sg[:r], sg_c),
                                ("qwn", qwn, qwn_c), ("swn", swn, swn_c)):
            equal(name, got, want)
        acc_c = im._dot8(qg_c, qwn_c.t())
        equal("dgrad int32", im._dot8(qg, qwn.t())[:r], acc_c)
        errs["dgrad"] = close("dgrad", da[:r], im._scaled(
            acc_c, sg_c, swn_c.t()).to(bf16), I8_BF16_REL)
        del qg, sg
        # wgrad: columns of a by columns of g, each over the whole M
        qam, sam = q(a, 0)
        qgm, sgm = q(g, 0)
        qam_c, sam_c = q(cpu(a[:, :c]), 0)
        qgm_c, sgm_c = q(cpu(g[:, :c]), 0)
        for name, got, want in (("qam", qam[:, :c], qam_c),
                                ("sam", sam[:, :c], sam_c),
                                ("qgm", qgm[:, :c], qgm_c),
                                ("sgm", sgm[:, :c], sgm_c)):
            equal(name, got, want)
        acc_c = im._dot8(qam_c.t(), qgm_c)
        equal("wgrad int32", im._dot8(qam.t().contiguous(),
                                      im._k_inner(qgm))[:c, :c], acc_c)
        errs["wgrad"] = close("wgrad", dw[:c, :c], im._scaled(
            acc_c, sam_c.t(), sgm_c), I8_F32_REL)
        del qam, qgm, y, da, dw
        row = {"phase": "int8_products", "M": m, "K": k, "N": n,
               "max_abs_err": errs, "card": card}
        if device == "cuda":
            row.update(_int8_product_times(a, w, g, qw))
    print(json.dumps(row), flush=True)
    return row


def _int8_product_times(a, w, g, qw):
    """Device ms of the int8 product (``_int_mm``, the forward's
    layout), the activation quantizer, bf16 ``torch.mm`` at the same
    shape (a yardstick), and the op's forward and forward + backward
    beside bf16's three products; the int8 bound."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.ops.bench_flash import device_ms

    (m, k), n = a.shape, w.shape[1]
    qa, _ = im.absmax_quant(a, 1)
    qwk = im._k_inner(qw)
    wb = w.to(torch.bfloat16)
    ops = 2.0 * m * k * n
    op_ms = ops / PEAK_INT8_OPS * 1e3
    byte_ms = (m * k + k * n + 4.0 * m * n) / PEAK_HBM_BYTES * 1e3
    ai, wi = a.detach().requires_grad_(), w.detach().requires_grad_()
    ab, wbg = a.detach().requires_grad_(), wb.detach().requires_grad_()

    def i8_step():
        torch.autograd.grad(im.int8_matmul(ai, wi), (ai, wi), g)

    def bf16_step():
        torch.autograd.grad(ab @ wbg, (ab, wbg), g)

    with torch.enable_grad():
        step_ms = {"int8_fwd_bwd_ms": device_ms(i8_step, 3),
                   "bf16_fwd_bwd_ms": device_ms(bf16_step, 3)}
    return {
        "int_mm_ms": device_ms(lambda: im._dot8(qa, qwk), 10),
        "quantizer_ms": device_ms(lambda: im.absmax_quant(a, 1), 10),
        "bf16_mm_ms": device_ms(lambda: a @ wb, 10),
        "int8_fwd_ms": device_ms(lambda: im.int8_matmul(a, w), 10),
        **step_ms,
        "int8_bound_ms": max(op_ms, byte_ms),
        "int8_bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "int8_peak_tops": PEAK_INT8_OPS / 1e12,
    }


def int8_products_phase(card):
    """The flagship's int8 products at the int8 ladder rung's M, each
    shape held against the CPU (:func:`_int8_product_row`) and timed.
    The int8 peak is the H100 SXM's spec figure: the row says whether
    the card's name is that card's."""
    import torch

    for k, n in I8_SHAPES:
        _int8_product_row(k, n, I8_M, "cuda", card)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({
        "phase": "int8_products_summary", "card": card,
        "int8_peak_tops": PEAK_INT8_OPS / 1e12,
        "peak_is_this_cards": "H100" in name and "HBM3" in name,
    }), flush=True)


def _int8_tree_check(qparams, params):
    """The weight-only int8 tree: each of the seven projection weights
    and ``lm_head`` a record of int8 ``q8`` in its weight's shape and
    f32 ``s8`` of its output columns; the embedding and norms dense
    and unchanged; the tree's bytes at most INT8_TREE_MOST of the
    dense tree's. Raises; returns (int8 bytes, dense bytes)."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.utils.tree import leaves

    recs = {f"layers/{k}": (qparams["layers"][k], params["layers"][k])
            for k in llama._INT8_WEIGHTS}
    recs["lm_head"] = (qparams["lm_head"], params["lm_head"])
    for name, (rec, w) in recs.items():
        if not (isinstance(rec, dict) and set(rec) == {"q8", "s8"}):
            raise AssertionError(f"int8 tree: {name} is not a q8/s8 record")
        if (rec["q8"].dtype != torch.int8 or rec["q8"].shape != w.shape
                or rec["s8"].dtype != torch.float32
                or rec["s8"].shape != w.shape[:-2] + w.shape[-1:]):
            raise AssertionError(
                f"int8 tree: {name} q8 {rec['q8'].dtype} "
                f"{tuple(rec['q8'].shape)}, s8 {rec['s8'].dtype} "
                f"{tuple(rec['s8'].shape)} for a {tuple(w.shape)} weight")
    for name in ("embed", "ln_f", "layers/ln1", "layers/ln2"):
        parts = name.split("/")
        got, want = qparams, params
        for p in parts:
            got, want = got[p], want[p]
        if got is not want:
            raise AssertionError(f"int8 tree: {name} is not the dense leaf")
    q_bytes = sum(x.nbytes for x in leaves(qparams))
    d_bytes = sum(x.nbytes for x in leaves(params))
    if q_bytes > INT8_TREE_MOST * d_bytes:
        raise AssertionError(f"int8 tree: {q_bytes} bytes, "
                             f"{q_bytes / d_bytes:.4f} of the dense tree's "
                             f"> {INT8_TREE_MOST}")
    return q_bytes, d_bytes


def _generate_timed(params, prompt, cfg, n):
    """One ``generate`` of ``n`` new tokens, fenced by reading a token:
    (seconds, tokens)."""
    from edl_tpu_torch.models import llama

    t1 = time.perf_counter()
    toks = llama.generate(params, prompt, cfg, max_new=n)
    int(toks[0, -1])
    return time.perf_counter() - t1, toks


def _measure_decode(params, cfg, b, t0, max_new, device):
    """bench.py ``measure_decode`` (bench.py:489-536) on the port: the
    decode rate by differencing two generation lengths (max_new/2 and
    3 max_new/2), one run each after one warm-up generate of the short
    length (bench.py's reps cut: see DECODE_LADDER). Returns
    (prefill s or -1, s a token or None, prompt, the long run's
    tokens). Holds that ``generate`` ran no ``int8_matmul``: ``cfg``
    may carry int8_mxu, which generate must drop."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im

    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (b, t0))).to(device)
    short, long_ = max_new // 2, max_new + max_new // 2
    im.reset_calls()
    _generate_timed(params, prompt, cfg, short)  # warm-up
    t_short, _ = _generate_timed(params, prompt, cfg, short)
    t_long, toks = _generate_timed(params, prompt, cfg, long_)
    if any(im.calls.values()):
        raise AssertionError(f"generate ran int8_matmul {im.calls}: "
                             f"int8_mxu was left on")
    if t_long <= t_short * 1.02:
        return -1.0, None, prompt, toks
    per_tok = (t_long - t_short) / (long_ - short)
    prefill_s = t_short - short * per_tok
    return (prefill_s if prefill_s >= 0 else -1.0), per_tok, prompt, toks


def decode_ladder_phase(card):
    """bench.py ``_llama_decode_bench`` on the port: the flagship's
    decode config (``flagship_decode_config``: the train config with
    remat off) with bf16 params from a seeded generator, greedy
    ``generate`` over DECODE_LADDER, ``decode_pct_peak_bw`` =
    ``decode_step_bytes`` over the step time over 3.35 TB/s; then the
    weight-only int8 rungs (b=1 and the headline b=8) on
    ``quantize_params_int8``'s tree, their roofline against that
    tree's own bytes, and their speedups. ``generate`` is handed the
    int8 training rung's config (int8_mxu on, as a job trained on the
    int8 path hands it to serving): it must drop the flag. Gates: the
    int8 tree (:func:`_int8_tree_check`), no ``int8_matmul`` call in
    any generate, and at b=8 every greedy int8 token within
    TEACHER_EPS row std of the quantized model's dense forward, and at
    every rung one primal flash launch a layer a generate (its prefill)
    and no other flash launch. Returns the flash launches by (tree,
    batch)."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.utils.tree import leaves

    cfg = dataclasses.replace(_flagship_train_config(), remat=False)
    gen_cfg = dataclasses.replace(cfg, int8_mxu=True)
    params = llama.init_params(cfg, seed=2, device="cuda",
                               dtype=torch.bfloat16)
    param_bytes = sum(x.nbytes for x in leaves(params))
    out, rungs, launches = {}, {}, {}

    def rung(tree, tree_bytes, b, t0, max_new, weights):
        fa.reset_launches()
        prefill_s, per_tok, prompt, toks = _measure_decode(
            tree, gen_cfg, b, t0, max_new, "cuda")
        counts = fa.launch_counts()
        want = {**dict.fromkeys(fa.KERNELS, 0),
                "flash_fwd": 3 * cfg.n_layers}  # three generates
        if counts != want:
            raise AssertionError(f"decode_ladder {weights} b={b}: flash "
                                 f"launches {counts}, want {want}")
        launches[weights, b] = counts["flash_fwd"]
        s_pad = t0 + max_new + max_new // 2  # the long run's cache
        step_bytes = costmodel.decode_step_bytes(cfg, tree_bytes, b, s_pad)
        ok = per_tok is not None
        return {"b": b, "t0": t0, "new": [max_new // 2,
                                         max_new + max_new // 2],
                "prefill_s": prefill_s,
                "per_token_ms": per_tok * 1e3 if ok else -1.0,
                "decode_tokens_per_sec": b / per_tok if ok else -1.0,
                "step_bytes": step_bytes,
                "bound_ms": step_bytes / PEAK_HBM_BYTES * 1e3,
                "decode_pct_peak_bw": (step_bytes / per_tok / PEAK_HBM_BYTES
                                       if ok else -1.0)}, prompt, toks

    for b, t0, max_new in DECODE_LADDER:
        r, _, _ = rung(params, param_bytes, b, t0, max_new, "bfloat16")
        rungs[b] = r
        print(json.dumps({"phase": "decode_ladder", "weights": "bfloat16",
                          **r, "card": card}), flush=True)
    head = rungs[DECODE_HEADLINE]
    out.update({"prefill_s": head["prefill_s"],
                "decode_tokens_per_sec": head["decode_tokens_per_sec"],
                "decode_pct_peak_bw": head["decode_pct_peak_bw"]})

    qparams = llama.quantize_params_int8(params)
    q_bytes, _ = _int8_tree_check(qparams, params)
    del params
    worst = 0.0
    for b, t0, max_new in DECODE_LADDER:
        if b not in (1, DECODE_HEADLINE):
            continue
        r, prompt, toks = rung(qparams, q_bytes, b, t0, max_new, "int8")
        suffix = "" if b == DECODE_HEADLINE else "_b1"
        base = rungs[b]["decode_tokens_per_sec"]
        rate = r["decode_tokens_per_sec"]
        out.update({
            f"decode_int8{suffix}_tokens_per_sec": rate,
            f"decode_int8{suffix}_pct_peak_bw": r["decode_pct_peak_bw"],
            f"decode_int8{suffix}_speedup": (rate / base if rate > 0
                                             and base > 0 else -1.0)})
        if b == DECODE_HEADLINE:
            for i in range(b):
                worst = max(worst, _teacher_margin(
                    qparams, cfg, prompt[i].tolist(), toks[i].tolist(),
                    "cuda"))
        print(json.dumps({"phase": "decode_ladder", "weights": "int8",
                          **r, "card": card}), flush=True)
    if worst > TEACHER_EPS:
        raise AssertionError(f"decode_ladder int8 b={DECODE_HEADLINE}: "
                             f"teacher-forced margin {worst:.4f} row std > "
                             f"{TEACHER_EPS}")
    print(json.dumps({
        "phase": "decode_ladder_summary",
        "model": "flagship_decode (bench.py:87)", "layers": cfg.n_layers,
        "headline_batch": DECODE_HEADLINE, **out,
        "param_bytes": param_bytes, "int8_param_bytes": q_bytes,
        "int8_tree_ratio": q_bytes / param_bytes,
        "int8_tree_most": INT8_TREE_MOST,
        "int8_teacher_forced_worst_margin_std": worst,
        "teacher_forced_eps_std": TEACHER_EPS,
        "flash_launches": {f"{w} b{b}": n for (w, b), n in launches.items()},
        "card": card}), flush=True)
    return launches


def int8_serving_phase(card, params, cfg, float_tps):
    """The slice's model and weights quantized on the card
    (``quantize_params_int8``), served through the contiguous and the
    paged (block SM_BLOCK) engine with the slice's requests (8 slots x
    2048, horizon 8). Gates: the int8 tree, every request done, zero
    recoveries, flash launches == prefills x layers on the contiguous
    engine (none on the paged one, as in the reference), no
    ``int8_matmul`` call, and every token within TEACHER_EPS row std of
    the quantized model's dense forward. Prints tokens/s beside the
    slice's float run (``float_tps``). Returns the flash launches by
    layout."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    t0 = time.perf_counter()
    qparams = llama.quantize_params_int8(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    q_bytes, d_bytes = _int8_tree_check(qparams, params)
    prompts, max_new = _slice_requests(cfg.vocab)
    launches = {}
    for layout, kw in (("contiguous", {}), ("paged", {"block_size":
                                                      SM_BLOCK})):
        metrics = ServingMetrics(registry=MetricsRegistry())
        eng = ContinuousBatchingEngine(
            qparams, cfg, max_slots=8, max_len=2048, horizon=8,
            metrics=metrics, device="cuda", **kw)
        eng.submit("warmup", prompts[0], 2)
        eng.run()
        prefills0 = metrics.dispatches["prefill"]
        fa.reset_launches()
        im.reset_calls()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        for i in range(4):
            eng.submit(f"r{i}", prompts[i], max_new)
        eng.step()
        for i in range(4, 8):
            eng.submit(f"r{i}", prompts[i], max_new)
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        counts = fa.launch_counts()
        prefills = metrics.dispatches["prefill"] - prefills0
        want = prefills * cfg.n_layers if layout == "contiguous" else 0
        if counts != {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd": want}:
            raise AssertionError(f"int8 {layout}: launches {counts}, want "
                                 f"{want} flash_fwd ({prefills} prefills)")
        if eng.recoveries or any(im.calls.values()):
            raise AssertionError(f"int8 {layout}: {eng.recoveries} "
                                 f"recoveries, int8_matmul {im.calls}")
        for i in range(8):
            r = res[f"r{i}"]
            if r.outcome != "done" or len(r.tokens) != max_new:
                raise AssertionError(f"int8 {layout} r{i}: outcome "
                                     f"{r.outcome}, {len(r.tokens)} tokens")
        worst = max(_teacher_margin(qparams, cfg, prompts[i],
                                    res[f"r{i}"].tokens, "cuda")
                    for i in range(8))
        if worst > TEACHER_EPS:
            raise AssertionError(f"int8 {layout}: teacher-forced margin "
                                 f"{worst:.4f} row std > {TEACHER_EPS}")
        launches[layout] = counts["flash_fwd"]
        print(json.dumps({
            "phase": "int8_serving", "layout": layout, "model": "llama3_8b",
            "layers": cfg.n_layers, "block_size": kw.get("block_size", 0),
            "requests": 8, "max_new": max_new, "prefills": prefills,
            "flash_launches": counts["flash_fwd"], "wall_s": wall,
            "tokens_per_s": 8 * max_new / wall,
            "float_tokens_per_s": float_tps,
            "block_mean_s": _block_mean(metrics),
            "teacher_forced_worst_margin_std": worst,
            "teacher_forced_eps_std": TEACHER_EPS,
            "quantize_s": quantize_s, "int8_param_bytes": q_bytes,
            "param_bytes": d_bytes, "int8_tree_ratio": q_bytes / d_bytes,
            "card": card}), flush=True)
        del eng
    return launches


def _kernel_family(name):
    n = name.lower()
    for keys, fam in (
            (("flash_bwd_dq",), "flash_bwd_dq"),
            (("flash_bwd_dkv",), "flash_bwd_dkv"),
            (("flash_fwd",), "flash_fwd_lse"),
            (("nvjet", "gemm", "xmma", "cutlass"), "matmul"),
            (("multi_tensor", "adam"), "optimizer"),
            (("softmax", "nll_loss", "cross_entropy"), "cross_entropy"),
            (("copy",), "cast/copy"),
            (("reduce",), "reduction")):
        if any(k in n for k in keys):
            return fam
    return "elementwise/other"


def _profiled(fn):
    """A torch.profiler session (host and device) around ``fn()`` and a
    device sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_kernels(prof):
    """({kernel name: device ms}, kernel launches) of a profiler
    session."""
    from torch.autograd import DeviceType

    kernels, calls = {}, 0
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or re.fullmatch(r"[\w.]+#[\w.]+", ev.key)):
            # CPU ops and annotated ranges (Optimizer.step#AdamW.step):
            # the kernels inside them are listed on their own. Kernel
            # names may hold a '#' too ({lambda()#3}), never this form.
            continue
        ms = getattr(ev, "self_device_time_total", 0) / 1e3
        if ms > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ms
            calls += ev.count
    return kernels, calls


def _top(kernels, n, width):
    return [(k[:width], ms) for k, ms in
            sorted(kernels.items(), key=lambda kv: -kv[1])[:n]]


# the serving profile's KV layouts: the slice's contiguous cache and the
# serving-modes phase's paged pool under each kv_quant
SERVE_LAYOUTS = {
    "contiguous": {},
    "paged_off": {"block_size": SM_BLOCK},
    "paged_int8": {"block_size": SM_BLOCK, "kv_quant": "int8"},
    "paged_int4": {"block_size": SM_BLOCK, "kv_quant": "int4"},
}
PROFILE_PREFILL = 256  # tokens of the profiled admission


def _profile_serving(card, params, cfg):
    """Where a decode block and an admission of the slice's engine (8
    slots x 2048, horizon 8) spend their time, per KV layout: six
    250-token prompts are admitted and decoded for two blocks; then one
    decode block (dispatch + drain) and the admission of one
    PROFILE_PREFILL-token prompt into a free slot (one prefill dispatch,
    the contiguous cache's on the flash kernel) each run once on the
    host clock through a device sync and once under torch.profiler. One
    line per layout: host seconds, device kernel ms and launches of
    each, and the top kernels."""
    import torch

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, _device_kernels(_profiled(fn))

    for name, kw in SERVE_LAYOUTS.items():
        eng = ContinuousBatchingEngine(
            params, cfg, max_slots=8, max_len=SM_MAX_LEN, horizon=8,
            metrics=ServingMetrics(registry=MetricsRegistry()),
            device="cuda", **kw)
        rng = np.random.RandomState(0)
        for j in range(6):  # two slots stay free for the admissions
            eng.submit(f"r{j}", rng.randint(0, cfg.vocab, 250).tolist(), 256)
        for _ in range(3):  # admit the six, then two decode blocks
            eng.step()
        eng._drain_all()

        def block():
            eng._dispatch_block()
            eng._drain_all()

        admitted = []

        def admit():
            admitted.append(f"a{len(admitted)}")
            eng.submit(admitted[-1],
                       rng.randint(0, cfg.vocab, PROFILE_PREFILL).tolist(), 2)
            eng._admit()

        block_s, (b_k, b_calls) = timed(block)
        prefill_s, (p_k, p_calls) = timed(admit)
        b_ms = sum(b_k.values())
        print(json.dumps({
            "phase": "serving_profile", "layout": name,
            "layers": cfg.n_layers, "horizon": 8, "slots": 8,
            "block_host_s": block_s, "block_device_ms": b_ms,
            "block_kernel_launches": b_calls,
            "block_device_busy_share": b_ms / (block_s * 1e3),
            "block_top_kernels_ms": _top(b_k, 6, 60),
            "prefill_tokens": PROFILE_PREFILL, "prefill_host_s": prefill_s,
            "prefill_device_ms": sum(p_k.values()),
            "prefill_kernel_launches": p_calls,
            "prefill_top_kernels_ms": _top(p_k, 6, 60),
            "kv_mb": eng.kv_nbytes / 2**20, "card": card,
        }), flush=True)
        del eng
        torch.cuda.empty_cache()


def _profile_step(card, step, state, batch, llama, cfg, step_s):
    """Where one train step's device time goes: torch.profiler's device
    kernels summed by name and by family, against the unprofiled step
    time; and CUDA events around the forward, the backward (with the
    remat recompute) and the optimizer."""
    import torch

    kernels, calls = _device_kernels(_profiled(lambda: step(state, batch)))
    fams = {}
    for name, ms in kernels.items():
        fam = _kernel_family(name)
        fams[fam] = fams.get(fam, 0.0) + ms
    device_ms = sum(kernels.values())

    opt = state.opt_state
    loss_fn = llama.make_loss_fn(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    loss = loss_fn(state.params, batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    ev[3].synchronize()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "train_profile.json"), "w") as f:
        json.dump({"kernels_ms": kernels, "card": card}, f, indent=1)
    print(json.dumps({
        "phase": "train_profile", "kernel_launches": calls,
        "device_kernel_ms": device_ms, "step_ms": step_s * 1e3,
        "device_busy_share": device_ms / (step_s * 1e3),
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": _top(kernels, 12, 90),
        "events_ms": {"forward": ev[0].elapsed_time(ev[1]),
                      "backward_with_recompute": ev[1].elapsed_time(ev[2]),
                      "optimizer": ev[2].elapsed_time(ev[3])},
        "card": card,
    }), flush=True)


def _ctr_gates_reshard(state, step, batch, ckpt, trainer, device):
    """The reshard gates: f32 staging bit-identical to snapshot +
    restore; int8 staging keeps params exact and moments within 1/127 of
    their row's absmax; one step from the int8-staged state moves every
    param within what those moment errors can move Adam's update
    (:func:`_ctr_resume_check`) of the same step from the unstaged state.
    Returns the worst moment error (in row absmax), the resumed step's
    check, and the share of live second moments (first moment nonzero)
    that staged to 0."""
    import torch

    def keyed(st):
        ps = trainer.leaves(st.params)
        out = {f"p{i}": p for i, p in enumerate(ps)}
        out.update({f"o{i}/{n}": t
                    for i, n, t, _ in trainer.optimizer_tensors(st)})
        return out

    staged = keyed(ckpt.staged_reshard(state, stage="f32", device=device))
    ref = keyed(ckpt.restore(ckpt.snapshot(state), device=device))
    if staged.keys() != ref.keys() or not all(
            staged[k].dtype == ref[k].dtype and torch.equal(staged[k], ref[k])
            for k in ref):
        raise AssertionError("f32 staged reshard differs from snapshot + "
                             "restore")
    del staged, ref
    q8 = ckpt.staged_reshard(state, stage="int8", device=device)
    before, after = keyed(state), keyed(q8)
    worst = 0.0
    for k, x in before.items():
        y = after[k]
        if k.startswith("p") or x.numel() < 4096 or x.dim() == 0:
            if not torch.equal(x, y):
                raise AssertionError(f"int8 staging changed {k}")
            continue
        den = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
        worst = max(worst, float(((x - y).abs() / den).max()))
    if worst > 1 / 127 + 1e-6:
        raise AssertionError(f"int8-staged moments off by {worst} of their "
                             f"row absmax > 1/127")
    # second moments staged to 0 under a live first moment: their next
    # update is exp_avg / eps (ROADMAP Queue C)
    live = zeroed = 0
    for k, v in after.items():
        if k.endswith("/exp_avg_sq") and v.numel() >= 4096:
            m = before[k[:-len("_sq")]] != 0
            live += int(m.sum())
            zeroed += int((m & (v == 0)).sum())
    del before, after
    plain = ckpt.restore(ckpt.snapshot(state), device=device)
    q8, m8 = step(q8, batch)
    plain, mf = step(plain, batch)
    resumed = _ctr_resume_check(state, q8, plain, trainer)
    resumed["losses_int8_vs_unstaged"] = [float(m8["loss"]),
                                          float(mf["loss"])]
    return worst, resumed, zeroed / max(live, 1)


def _ctr_resume_check(state, staged, plain, trainer):
    """Params after one Adam step from ``staged`` (``state`` staged
    through int8: params exact, moments within 1/127 of their row's
    absmax) against the same step from an unstaged copy ``plain``.

    Adam moves a param by lr/bc1 * m / D, D = sqrt(v/bc2) + eps, with
    m, v the moments after the step. With e_m, e_v the staging bound
    (1/127 of the row absmax of ``state``'s moments; 0 for leaves staged
    exactly) and g~, g the two steps' gradients (the table's f32
    ``index_add_`` may sum in another order):
      |m~ - m| <= dm = b1 e_m + (1 - b1) |g~ - g|
      |v~ - v| <= dv = b2 e_v + (1 - b2) |g~^2 - g^2|
      |D~ - D| <= dD = min(sqrt(dv / bc2),
                           (dv / bc2) / (sqrt(v / bc2) + sqrt(v_lo / bc2)))
      |p~ - p| <= lr / bc1 * (dm + |m| dD / D) / D_lo
    where v_lo = max(v - dv, 0), D_lo = sqrt(v_lo / bc2) + eps <= D~,
    and m, v, D are the unstaged step's. The first moment enters the
    update linearly; a second moment that staged to 0 (ROADMAP Queue C)
    leaves D_lo near eps there, so the bound is loose on those entries
    and tight where v is near its row's absmax. f32 rounding adds 2^-22
    of each term of m and v and of |p|, and 2^-21 of the update. Raises
    where a param exceeds bound + rounding; returns the worst ratio and
    the largest difference."""
    import torch

    group = plain.opt_state.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    r = 2.0 ** -22
    worst = diff = 0.0
    for p0, pu, ps in zip(trainer.leaves(state.params),
                          trainer.leaves(plain.params),
                          trainer.leaves(staged.params)):
        st0, stu = state.opt_state.state[p0], plain.opt_state.state[pu]
        t = float(stu["step"])
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        m0, v0 = st0["exp_avg"].double(), st0["exp_avg_sq"].double()
        g, gs = pu.grad.double(), ps.grad.double()
        m, v = stu["exp_avg"].double(), stu["exp_avg_sq"].double()
        if m0.numel() >= 4096:
            e_m = m0.abs().amax(dim=-1, keepdim=True) / 127
            e_v = v0.abs().amax(dim=-1, keepdim=True) / 127
        else:
            e_m = e_v = 0.0
        dm = (b1 * e_m + (1 - b1) * (gs - g).abs()
              + r * (b1 * m0.abs() + (1 - b1) * g.abs()))
        dv = (b2 * e_v + (1 - b2) * (gs * gs - g * g).abs()
              + r * (b2 * v0 + (1 - b2) * g * g))
        v_lo = (v - dv).clamp_min(0)
        den = (v / bc2).sqrt() + (v_lo / bc2).sqrt()
        d_d = torch.minimum((dv / bc2).sqrt(),
                            torch.where(den > 0, dv / bc2 / den,
                                        float("inf")))
        big_d, d_lo = (v / bc2).sqrt() + eps, (v_lo / bc2).sqrt() + eps
        bound = (lr / bc1 * (dm + m.abs() * d_d / big_d) / d_lo
                 + 2 * r * lr / bc1 * m.abs() / d_lo
                 + r * pu.detach().double().abs())
        got = (ps.detach().double() - pu.detach().double()).abs()
        worst = max(worst, float((got / bound).max()))
        diff = max(diff, float(got.max()))
    if not worst <= 1.0:
        raise AssertionError(f"params one step after int8 staging: "
                             f"{worst} of the bound the staged moments "
                             f"allow")
    return {"param_worst_of_bound": worst, "param_max_abs_diff": diff}


def _ctr_small_step_agrees():
    """One f32 CTR step at CTR_SMALL on the card against the same step of
    the port on the CPU: loss and every param within CTR_CPU_ATOL, and
    every leaf's first moment after the step ((1 - b1) * its gradient:
    a one-step Adam update is about lr * sign(grad), so the params alone
    hardly see the gradient's size) within CTR_CPU_GRAD_RTOL of the
    leaf's largest entry. Returns the worst differences."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.train import trainer

    gen = torch.Generator().manual_seed(1)
    host = ctr.init_params(gen, vocab=CTR_SMALL["vocab"], device="cpu")
    nb = ctr.synthetic_batch(np.random.RandomState(1), CTR_SMALL["batch"],
                             vocab=CTR_SMALL["vocab"])
    out = []
    for dev in ("cpu", "cuda"):
        tx = trainer.adam(1e-3)
        params = trainer.replace_leaves(
            host, [p.to(dev, copy=True) for p in trainer.leaves(host)])
        st = trainer.TrainState.create(params, tx)
        st, m = trainer.make_train_step(ctr.make_loss_fn(), tx)(
            st, trainer.global_batch(nb, device=dev))
        out.append((float(m["loss"]),
                    [p.detach().cpu() for p in trainer.leaves(st.params)],
                    [t.cpu() for _, n, t, _ in trainer.optimizer_tensors(st)
                     if n == "exp_avg"]))
    (lc, pc, mc), (ld, pd, md) = out
    worst = max([abs(lc - ld)] + [float((a - b).abs().max())
                                  for a, b in zip(pc, pd)])
    grad_rel = max(float((a - b).abs().max() / a.abs().max().clamp_min(
        1e-30)) for a, b in zip(mc, md))
    if not (worst <= CTR_CPU_ATOL and grad_rel <= CTR_CPU_GRAD_RTOL):
        raise AssertionError(
            f"CTR step on the card vs the CPU: loss/params off by {worst} "
            f"(limit {CTR_CPU_ATOL}), first moments by {grad_rel} of their "
            f"leaf's largest entry (limit {CTR_CPU_GRAD_RTOL})")
    return worst, grad_rel


def ctr_phase(card, profile: bool):
    """bench.py's CTR headline on the port (bench.py:1119-1230): the
    Criteo-shaped model (vocab 2^20, emb 16, MLP 400-400-400) at batch
    16384, adam(1e-3), bf16 compute, 12 steps a chunk over 4 raw batches
    cycled; 2 warm-up chunks, then 3 loops of 240 steps (best, median,
    spread); then the reshard stalls, each the minimum of 2 runs (the
    device fast path, host staging in f32 and in int8) and the models
    derived from them; then the gates."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime import elastic
    from edl_tpu_torch.train import trainer

    c = CTR
    device = "cuda"

    def fence(st):
        return float(st.params["out"]["b"].detach().sum())  # a scalar fetch

    gen = torch.Generator(device=device).manual_seed(0)
    params = ctr.init_params(gen, vocab=c["vocab"], device=device)
    tx = trainer.adam(1e-3)
    state = trainer.TrainState.create(params, tx)
    rng = np.random.RandomState(0)
    raw = [ctr.synthetic_batch(rng, c["batch"], vocab=c["vocab"])
           for _ in range(c["raw_batches"])]
    stacked = trainer.stack_batches(
        [raw[i % len(raw)] for i in range(c["chunk"])], device=device)
    loss_fn = ctr.make_loss_fn(torch.bfloat16)
    multi = trainer.make_train_multistep(loss_fn, tx)
    fa.reset_launches()

    t0 = time.perf_counter()
    state, m = multi(state, stacked)
    first_loss = float(m["losses"][0])  # fence: first chunk
    compile_s = time.perf_counter() - t0
    for _ in range(c["warmup"]):
        state, m = multi(state, stacked)
    float(m["loss"])
    chunks = c["measure"] // c["chunk"]
    rates, loop_s = [], []
    for _ in range(c["loops"]):
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, m = multi(state, stacked)
        float(m["loss"])  # fence once a loop: chunks stay pipelined
        dt = time.perf_counter() - t0
        loop_s.append(dt)
        rates.append(c["batch"] * chunks * c["chunk"] / dt)
    final_loss = float(m["loss"])
    rates = np.asarray(rates)
    if not all(math.isfinite(x) for x in (first_loss, final_loss)):
        raise AssertionError(f"non-finite CTR loss: {first_loss}, "
                             f"{final_loss}")
    if not final_loss < first_loss:
        raise AssertionError(f"CTR loss did not fall: {first_loss} -> "
                             f"{final_loss}")

    kernels, calls = _device_kernels(_profiled(
        lambda: multi(state, stacked)))
    dev_ms = sum(kernels.values())
    chunk_ms = min(loop_s) / chunks * 1e3
    busy = {"chunk_device_ms": dev_ms, "chunk_host_ms": chunk_ms,
            "chunk_device_busy_share": dev_ms / chunk_ms,
            "launches_per_step": calls / c["chunk"]}
    if profile:
        busy["chunk_top_kernels_ms"] = _top(kernels, 12, 70)
        fams = {}
        for name, ms in kernels.items():
            fam = _ctr_family(name)
            fams[fam] = fams.get(fam, 0.0) + ms
        busy["chunk_by_family_ms"] = dict(
            sorted(fams.items(), key=lambda kv: -kv[1]))

    # the gates run on the trained state, before the stall runs stage it
    # (a state already staged through int8 re-quantizes onto itself)
    step = trainer.make_train_step(loss_fn, tx)
    worst_q8, resumed, nu_zeroed = _ctr_gates_reshard(
        state, step, trainer.global_batch(raw[0], device=device), ckpt,
        trainer, device)
    stall_fast = stall_f32 = stall_int8 = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        state = elastic.device_reshard(state, device=device)
        fence(state)
        stall_fast = min(stall_fast, time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        state = ckpt.staged_reshard(state, stage="f32", device=device)
        fence(state)
        stall_f32 = min(stall_f32, time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        state = ckpt.staged_reshard(state, stage="int8", device=device)
        fence(state)
        stall_int8 = min(stall_int8, time.perf_counter() - t0)
    state_b = ckpt.state_nbytes(state)
    moment_b = ckpt.state_nbytes(state.opt_state)
    host_bw = state_b / stall_f32  # one host: the f32 run's raw rate
    model_8b = ckpt.host_fallback_stall_model(
        17 * (1 << 30), hosts_after=1, host_bw_bytes_s=host_bw,
        moment_bytes=1 << 30, stage="int8")

    small_err, small_grad_rel = _ctr_small_step_agrees()
    counts = fa.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the CTR path launched flash kernels: {counts}")
    row = {
        "phase": "ctr", "model": "ctr (bench.py:1119)", "vocab": c["vocab"],
        "emb": ctr.DEFAULT_EMBEDDING, "mlp": list(ctr.MLP_DIMS),
        "batch": c["batch"], "chunk": c["chunk"], "optimizer": "adam(1e-3)",
        "compute": "bfloat16",
        "ctr_examples_per_sec_per_chip": float(rates.max()),
        "ctr_median": float(np.median(rates)),
        "ctr_spread_pct": float(100 * (rates.max() - rates.min())
                                / rates.max()),
        "loop_rates": rates.tolist(), "compile_s": compile_s,
        "first_loss": first_loss, "final_loss": final_loss,
        "train_flops_per_example": costmodel.ctr_train_flops_per_example(),
        "ctr_state_mb": state_b / 2 ** 20, "ctr_moment_mb": moment_b / 2 ** 20,
        "reshard_stall_s": stall_fast,
        "reshard_stall_host_f32_s": stall_f32,
        "reshard_stall_host_fallback_s": stall_int8,
        "reshard_stage": "int8",
        "host_stage_bw_gbs": host_bw / 2 ** 30,
        "stall_model_8b_1host_s": model_8b,
        "int8_moment_worst_of_row_absmax": worst_q8,
        "int8_resumed_step": resumed,
        "int8_nu_zeroed_share": nu_zeroed,
        "small_step_vs_cpu_worst": small_err, "small_step_atol": CTR_CPU_ATOL,
        "small_step_grad_vs_cpu_of_leaf_max": small_grad_rel,
        "small_step_grad_rtol": CTR_CPU_GRAD_RTOL,
        "flash_launches": counts, **busy, "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


# the elastic phase: bench.py's CTR headline (vocab 2^20, emb 16,
# bench.py:1124) as an elastic job of worker processes that share the
# card (runtime/worker_main.py), 2 -> 3 -> 2 -> 1 workers. Tasks of
# 4096 rows: the events took from 259 to over 500 of them in runs on an
# H100 (2 workers step at 100-280 ms, the all-reduce 80-90% of it, while
# a joiner boots for 15-30 s); 1024 leave margin, and the last worker a
# tail of 5-8 ms steps. The phase fails if the queue runs low before an
# event.
# tasks: 1536 since the fleet windows (below) run while the job steps
ELASTIC = {"vocab": 2 ** 20, "per_device_batch": 4096, "tasks": 1536,
           "ckpt_every": 100, "gap_steps": 20, "member_ttl_s": 3.0,
           "lease_timeout_s": 10.0, "eval_rows": 4096, "timeout_s": 600,
           "push_s": 1.0}
# the dp step check: 2 gloo processes on the card vs this process, CTR
# at 2^20, 2 x 4096 rows, 3 SGD steps, the last ragged (rank 1 all
# _w = 0). SGD's update is linear in the gradient, so the params differ
# by the all-reduce's f32 rounding only (a tail averaged as local means
# would miss by ~1e-4). Adam is not checked here: its normalized update
# of an entry whose gradient cancels to ~0 is lr x the sign of that
# rounding, so any gradient, right or wrong, stays within steps x lr
# (dp_check.dp_step_check; the CPU tests hold Adam to the reference)
ELASTIC_CHECK = {"vocab": 2 ** 20, "rows": 4096, "world": 2, "steps": 3}
ELASTIC_PARAM_ATOL = 1e-6
ELASTIC_LOSS_ATOL = 1e-5
ELASTIC_AUC_MIN = 0.55  # the reference test's bar (tests/test_multiproc.py)
_KV = re.compile(r"(\w+)=('(?:[^'\\]|\\.)*'|\S+)")
# the fleet read side beside the job: coordinator_main's supervised body
# (serve_fleet) over the launcher's client, its history appended every
# FLEET_WATCH_S; each steady window waits at most FLEET_WAIT_S for the
# fleet's /metrics to label exactly the live members (a joiner's first
# push) in a pass whose snapshots did not change while it was scraped
FLEET_WATCH_S = 1.0
FLEET_WAIT_S = 20.0
FLEET_VERB_TIMEOUT_S = 120


def _log_records(text, msg):
    """The ``key=value`` fields (values as the worker's ``repr``) of
    every line of a worker log whose message is ``msg``."""
    import ast

    out = []
    for line in text.splitlines():
        head = line.split("] ", 1)
        if len(head) == 2 and head[1].startswith(msg + " "):
            out.append({k: ast.literal_eval(v)
                        for k, v in _KV.findall(head[1][len(msg):])})
    return out


def _elastic_wait(launcher, key, at_least, timeout_s):
    deadline = time.monotonic() + timeout_s
    while int(launcher.kv(key) or "0") < at_least:
        if time.monotonic() > deadline:
            raise AssertionError(f"elastic: {key} stayed below {at_least}")
        if not launcher.live_workers():
            raise AssertionError(f"elastic: every worker exited before "
                                 f"{key} reached {at_least}")
        time.sleep(0.05)


def _elastic_steady(launcher, c):
    """Wait until the job has taken ``gap_steps`` more steps. Fails
    when the queue runs too low for another event."""
    p = launcher.progress()
    launcher.wait_progress(p + c["gap_steps"], timeout_s=c["timeout_s"])
    todo = launcher.client.queue_stats()["todo"]
    if todo < c["gap_steps"] * 3:
        raise AssertionError(f"elastic: the queue ran low ({todo} tasks) "
                             f"before the schedule's next event")


def _elastic_event(launcher, c, n_reshards, act, last=False, then=None):
    """Fire one membership event and wait until the regrouped job is
    steady again (after the ``last`` event: until it has taken
    ``gap_steps`` steps); the wall time it fired at. ``then()`` runs once
    the job has counted the reshard, before the wait for steady steps."""
    t = time.time()
    act()
    _elastic_wait(launcher, "reshards", n_reshards, c["timeout_s"])
    if then is not None:
        then()
    if last:
        launcher.wait_progress(launcher.progress() + c["gap_steps"],
                               timeout_s=c["timeout_s"])
    else:
        _elastic_steady(launcher, c)
    return t


def _elastic_report(logs, hosts, events, spawned):
    """Stalls, the boots of the workers in ``spawned`` ({worker: the
    wall time it was spawned}), the commits, examples/s per epoch and
    peak memory, from the workers' logs and the store hosts' (``hosts``:
    {epoch: log text})."""
    stats = {w: _log_records(t, "epoch stats") for w, t in logs.items()}
    lead = [r for r in stats["w000"] if r["steps"]]
    up = {r["epoch"]: r["t"] for r in _log_records(logs["w000"], "epoch up")}
    host_spawned = {r["epoch"]: r["t"] for r in _log_records(
        logs["w000"], "store host spawned")}
    stalls = []
    for a, b in zip(lead, lead[1:]):
        e = b["epoch"]
        host_up = [float(dict(_KV.findall(line))["t"])
                   for line in hosts.get(e, "").splitlines()
                   if line.startswith("dist_service up ")]
        stalls.append({
            "worlds": [a["world"], b["world"]],
            "epochs": [a["epoch"], e],
            "stall_s": b["first_t"] - a["last_t"],
            # the commit, the teardown and the rendezvous
            "last_step_to_epoch_up_s": up[e] - a["last_t"],
            # the store host's cold start, inside the rendezvous
            "store_host_boot_s": (host_up[0] - host_spawned[e]
                                  if host_up and e in host_spawned
                                  else None)})
    for st, (name, t), b in zip(stalls, events, lead[1:]):
        st["event"] = name
        st["event_to_first_step_s"] = b["first_t"] - t
    by_epoch = {}
    for recs in stats.values():
        for r in recs:
            e = by_epoch.setdefault(r["epoch"], {"rows": 0, "first": [],
                                                 "last": [], "logged": 0})
            e["rows"] += r["rows"]
            e["logged"] += 1
            if r["steps"]:
                e["first"].append(r["first_t"])
                e["last"].append(r["last_t"])
    epochs = []
    for r0 in lead:
        e = by_epoch[r0["epoch"]]
        dt = max(e["last"]) - min(e["first"])
        # a SIGKILLed worker logs no stats for its last epoch: its rows
        # are w000's (every worker leases one task a step)
        rows = e["rows"] + r0["rows"] * (r0["world"] - e["logged"])
        epochs.append({
            "epoch": r0["epoch"], "world": r0["world"], "steps": r0["steps"],
            "examples": rows, "seconds": dt,
            "examples_per_s": rows / dt if dt > 0 else None,
            "allreduce_share_of_step": (r0["allreduce_s"] / r0["step_s"]
                                        if r0["step_s"] else None),
            "step_ms": 1e3 * r0["step_s"] / r0["steps"]})
    boots = {w: _boot_stages(logs[w], stats[w], t)
             for w, t in spawned.items()}
    commits = [dict(r, kind="reshard") for r in
               _log_records(logs["w000"], "commit") if not r["background"]]
    commits += [dict(r, kind="crash", worker=w) for w, t in logs.items()
                for r in _log_records(t, "crash commit")]
    peaks = {w: max((r["peak_mem_bytes"] for r in recs), default=0)
             for w, recs in stats.items()}
    return stalls, boots, commits, epochs, peaks


def _boot_stages(log, stats, spawned):
    """A worker's boot by stage, from its spawn at wall time ``spawned``
    to its first step (the log's ``boot``, first ``epoch up``, restore
    and ``epoch stats`` records)."""
    boot = _log_records(log, "boot")[0]
    joined = _log_records(log, "epoch up")[0]
    rest = _log_records(log, "restore done")[0]
    loaded = _log_records(log, "restored")
    first = next(r for r in stats if r["steps"])["first_t"]
    return {"spawn_to_main_s": boot["main"] - spawned,
            "imports_s": boot["imports"] - boot["main"],
            "device_s": boot["device_ready"] - boot["imports"],
            "model_register_s": boot["registered"] - boot["device_ready"],
            "rendezvous_s": joined["t"] - boot["registered"],
            "process_group_s": rest["dist_s"] - joined["t"],
            "restore_s": rest["t"] - rest["dist_s"],
            "restore_load_s": loaded[0]["load_s"] if loaded else None,
            "first_step_s": first - rest["t"],
            "total_s": first - spawned}


def _checkout_env():
    """(this checkout's directory, the environment a process started
    from it runs with: the checkout first on PYTHONPATH)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return here, dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))


def _run_verb(args, expect=0, timeout=FLEET_VERB_TIMEOUT_S):
    """``python -m edl_tpu_torch ARGS`` from this checkout: (stdout,
    seconds). Raises with its stderr unless it exits ``expect``."""
    here, env = _checkout_env()
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch", *args],
                         cwd=here, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != expect:
        raise AssertionError(f"{' '.join(args[:2])} exited "
                             f"{out.returncode}, not {expect}: "
                             f"{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t


def _trace_verb(url, *flags):
    """``trace URL FLAGS --assert-critical-path --json`` through the
    verb's entry (``edl_tpu_torch.cli.main``, what ``python -m
    edl_tpu_torch`` runs) in this process, so its scrape of the fleet's
    ``/trace`` follows the one the filter was chosen from by
    milliseconds. Its document; raises unless it exits 0 with a hop."""
    import contextlib
    import io

    from edl_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["trace", url, *flags, "--assert-critical-path",
                       "--json"])
    docs = [ln for ln in out.getvalue().splitlines()
            if ln.startswith('{"hops"')]
    if rc != 0 or not docs or not json.loads(docs[-1])["hops"]:
        raise AssertionError(f"trace {' '.join(flags)} exited {rc}: "
                             f"{err.getvalue()[-2000:]}")
    hops = json.loads(docs[-1])["hops"]
    longest = max(hops, key=lambda h: h["dur_s"])
    return {"hops": len(hops), "total_s": sum(h["dur_s"] for h in hops),
            "longest_hop": longest["name"], "longest_hop_s": longest["dur_s"],
            "longest_hop_worker": longest["worker"],
            "workers": sorted({h["worker"] for h in hops})}


def _reshard_path(url, world, timeout_s):
    """Once the fleet's ``/trace`` holds a regroup's restore spans at
    ``world`` workers (the ``worker.restore`` span under the derived
    reshard root), the critical path of that reshard epoch through the
    ``trace`` verb: (epoch, workers with restore spans, path)."""
    from edl_tpu_torch.obs.exporter import scrape

    deadline = time.monotonic() + timeout_s
    while True:
        doc = json.loads(scrape(url, "/trace"))
        eps = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e["name"] == "worker.restore" \
                    and e["args"].get("world") == world:
                eps.setdefault(e["args"]["reshard_epoch"], set()).add(
                    e["args"]["worker"])
        if eps:
            ep = max(eps)
            return ep, sorted(eps[ep]), _trace_verb(
                url, "--reshard-epoch", str(ep))
        if time.monotonic() > deadline:
            raise AssertionError(f"elastic fleet: no restore span at "
                                 f"world {world} in /trace")
        time.sleep(0.1)


def _fleet_window(launcher, url, world, grow_epoch=None):
    """One steady window's read of the fleet endpoint. Gates, met by
    one pass within FLEET_WAIT_S: ``/metrics`` labels
    ``edl_train_step_seconds`` with exactly the live members (``world``
    of them) and carries ``dist_service``'s series, the raw snapshots
    ({job}/metrics/{worker}) did not change while it was scraped, and
    with 2+ workers ``/trace`` holds spans from 2+ workers with flow
    links (with ``grow_epoch``: and a step whose ``train.step`` span
    every member's window holds).
    Then each worker's counters in that union equal its
    snapshot's, and ``/events`` is labeled by worker and ordered by the
    corrected wall clock. With ``grow_epoch``: every member's
    ``worker.join`` of that epoch is in ``/events``, it is the newest
    epoch joined (the one the barrier gauge reads), and the critical
    path of the newest such step comes out of the ``trace`` verb.
    Returns the window's figures."""
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs import fleet
    from edl_tpu_torch.obs import metrics as om
    from edl_tpu_torch.obs.exporter import scrape

    cl, job = launcher.client, launcher.job
    deadline = time.monotonic() + FLEET_WAIT_S
    while True:
        members = sorted(m.name for m in cl.members())
        raw = {w: cl.kv_get(fleet.metrics_key(job, w)) for w in members}
        t = time.perf_counter()
        text = scrape(url)
        metrics_s = time.perf_counter() - t
        again = {w: cl.kv_get(fleet.metrics_key(job, w)) for w in members}
        t = time.perf_counter()
        doc = json.loads(scrape(url, "/trace"))
        trace_s = time.perf_counter() - t
        fams = om.parse_prometheus_text(text)
        labeled = sorted({lb.get("worker") for lb, _ in
                          fams.get("edl_train_step_seconds_count", ())})
        sources = {lb.get("worker") for samples in fams.values()
                   for lb, _ in samples}
        workers = [w for w in doc["workers"] if w != "coordinator"]
        # each worker's window is its newest spans as of its last push:
        # the workers' pushes interleave, so a link needs a step that
        # both windows still hold
        linked = world < 2 or (len(workers) >= 2 and doc["flow_links"] > 0)
        steps = {}  # the steps whose train.step span a worker's window holds
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e["name"] == "train.step":
                steps.setdefault(e["args"]["worker"], set()).add(
                    e["args"]["step"])
        common = set.intersection(*(steps.get(w, set()) for w in members))
        if grow_epoch is not None and not common:
            linked = False  # no step every member's window holds yet
        if raw == again and len(members) == world and labeled == members \
                and "dist_service" in sources and linked:
            break
        if time.monotonic() > deadline:
            raise AssertionError(
                f"elastic fleet: /metrics labels {labeled} (sources "
                f"{sorted(map(str, sources))}) for members {members}, "
                f"want {world} and dist_service; /trace has workers "
                f"{workers}, {doc['flow_links']} flow links, steps in "
                f"every member's window: {sorted(common)[-3:]}")
        time.sleep(0.2)
    for w, snap in raw.items():
        for fam in json.loads(snap)["families"]:
            if fam["kind"] != "counter":
                continue
            for smp in fam["samples"]:
                labels = dict(zip(fam["labelnames"], smp["labels"]),
                              worker=w)
                got = [v for lb, v in fams.get(fam["name"], ())
                       if lb == labels]
                if got != [float(smp["value"])]:
                    raise AssertionError(
                        f"elastic fleet: {fam['name']}{labels} is {got} in "
                        f"the union, {smp['value']} in {w}'s snapshot")
    t = time.perf_counter()
    evs = [json.loads(x) for x in scrape(url, "/events").splitlines()]
    events_s = time.perf_counter() - t
    stamps = [e["t_wall"] for e in evs]
    if not evs or stamps != sorted(stamps) or any(
            not (e.get("corr") or {}).get("worker") for e in evs):
        raise AssertionError("elastic fleet: /events is empty, unlabeled "
                             "or out of order")
    one = lambda name: [v for _, v in fams.get(name, ())]  # noqa: E731
    row = {"world": world, "members": members,
           "skew_ratio": one("edl_step_skew_ratio"),
           "reporting_workers": one("edl_fleet_reporting_workers"),
           "scrape_s": {"metrics": metrics_s, "events": events_s,
                        "trace": trace_s},
           "events": len(evs), "trace_workers": workers,
           "trace_spans": sum(1 for e in doc["traceEvents"]
                              if e.get("ph") == "X"),
           "flow_links": doc["flow_links"],
           # straggler_pass runs in this process (the fleet's scrapes and
           # appends): its straggler.detected events so far
           "straggler_events": flight.default_recorder().counts().get(
               "straggler.detected", 0)}
    if grow_epoch is not None:
        joins = {}
        for e in evs:
            if e["kind"] == "worker.join":
                joins.setdefault(e["attrs"]["epoch"], set()).add(
                    e["corr"]["worker"])
        if joins.get(grow_epoch) != set(members) or max(joins) != grow_epoch:
            raise AssertionError(f"elastic fleet: joins by epoch {joins}, "
                                 f"want {members} at {grow_epoch}")
        row["barrier_wait_s"] = {
            lb["worker"]: v
            for lb, v in fams.get("edl_barrier_wait_seconds", ())}
        if sorted(row["barrier_wait_s"]) != members:
            raise AssertionError(f"elastic fleet: barrier waits "
                                 f"{row['barrier_wait_s']}")
        row["step"] = max(common)
        row["step_critical_path"] = _trace_verb(url, "--step",
                                                str(row["step"]))
    return row


def _flight_records(kind):
    """This process's flight-recorder records of ``kind``."""
    from edl_tpu_torch.obs import events as flight

    return flight.default_recorder().records(kind)


def _start_fleet(launcher, tsdb_dir):
    """coordinator_main's supervised body (``serve_fleet``) over the
    launcher's client in a thread: the fleet's ``/metrics``, ``/events``
    and ``/trace`` on an ephemeral port, the aggregated snapshot
    appended to ``tsdb_dir`` every FLEET_WATCH_S with the default alert
    rules. Returns (url, stop); ``stop()`` ends it and re-raises what
    ended it early."""
    import threading

    from edl_tpu_torch.runtime import coordinator_main

    stop, ready, got = threading.Event(), threading.Event(), {}

    def announce(url):
        got["url"] = url
        ready.set()

    def run():
        try:
            coordinator_main.serve_fleet(
                launcher.client, launcher.job, 0, tsdb_dir=tsdb_dir,
                watch_interval=FLEET_WATCH_S, stop=stop, announce=announce)
        except BaseException as e:  # handed to the phase by stop()
            got["error"] = e
            ready.set()

    th = threading.Thread(target=run, name="fleet-endpoint", daemon=True)
    th.start()
    ready.wait(30)

    def close():
        stop.set()
        th.join(30)
        if "error" in got:
            raise got["error"]

    if "url" not in got:
        close()
        raise AssertionError("the fleet endpoint did not come up")
    return got["url"], close


def _coordinator_process_check(workdir):
    """``python -m edl_tpu_torch.runtime.coordinator_main --metrics-port
    0 --tsdb-dir D --watch-interval 1`` as a process, with a
    ``MetricsPusher`` here pushing a registry under the member
    ``smoke0``. Gates: the bound-URL line, ``worker="smoke0"`` on the
    pushed series in the scraped ``/metrics``, appends in D, and SIGTERM
    ending the process with 0. Returns its figures."""
    import signal
    import socket

    from edl_tpu_torch.obs import fleet
    from edl_tpu_torch.obs import metrics as om
    from edl_tpu_torch.obs.exporter import scrape
    from edl_tpu_torch.obs.tsdb import TSDB
    from edl_tpu_torch.runtime.coordinator import CoordinatorClient

    here, env = _checkout_env()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    db = os.path.join(workdir, "coordinator_tsdb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.coordinator_main",
         "--port", str(port), "--metrics-port", "0", "--job", "smoke",
         "--tsdb-dir", db, "--watch-interval", "1"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        up_s = time.perf_counter() - t0
        m = re.match(r"coordinator on :(\d+); fleet metrics at (\S+)/metrics"
                     r" \(fleet event log at /events, merged fleet trace at "
                     r"/trace\)$", line.strip())
        if not m or int(m.group(1)) != port:
            raise AssertionError(f"coordinator_main printed {line!r}")
        cl = CoordinatorClient("127.0.0.1", port)
        cl.register("smoke0", 1)
        reg = om.MetricsRegistry()
        reg.counter("edl_train_examples_total", "rows").inc(4096)
        key = fleet.metrics_key("smoke", "smoke0")
        pusher = fleet.MetricsPusher(lambda v: cl.kv_put(key, v),
                                     registry=reg)
        if not pusher.push_once():
            raise AssertionError("the push into coordinator_main failed")
        text = scrape(m.group(2))
        if 'edl_train_examples_total{worker="smoke0"} 4096' not in text:
            raise AssertionError(f"coordinator_main /metrics: {text[:2000]}")
        deadline = time.monotonic() + 15
        while not (os.path.isdir(db) and TSDB(db).raw_times()):
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError("coordinator_main appended no history")
            time.sleep(0.1)
        appends = len(TSDB(db).raw_times())
        cl.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        raise AssertionError(f"coordinator_main exited {rc} on SIGTERM: "
                             f"{proc.stderr.read()[-2000:]}")
    return {"up_s": up_s, "appends": appends, "sigterm_rc": rc,
            "seconds": time.perf_counter() - t0}


def elastic_phase(card, device="cuda", c=ELASTIC, check=ELASTIC_CHECK):
    """The elastic process runtime on the card (runtime/worker_main.py
    under runtime/launcher.py): the dp step check, then the CTR job at
    2^20 vocab, ``per_device_batch`` rows a worker, with periodic
    commits, exports and the held-out AUC, over worker processes that
    share the card, each joined to the others by gloo. The schedule:
    start 2, grow to 3, drain back to 2 (SIGTERM), SIGKILL one, and
    finish on the last; each event waits for ``gap_steps`` more steps
    (:func:`_elastic_steady`)."""
    import concurrent.futures
    import glob
    import tempfile

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.obs.tsdb import TSDB
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime import shards
    from edl_tpu_torch.runtime.launcher import ProcessJobLauncher
    from edl_tpu_torch.train import dp_check

    t_check = time.perf_counter()
    step_check = dp_check.dp_step_check(device, **check)
    step_check["seconds"] = time.perf_counter() - t_check
    if not (step_check["max_abs_err"] <= ELASTIC_PARAM_ATOL
            and step_check["loss_abs_err"] <= ELASTIC_LOSS_ATOL
            and step_check["rank_spread"] == 0.0):
        raise AssertionError(f"elastic: the dp step disagrees with one "
                             f"process: {step_check}")

    local = 0 if device == "cuda" else 1
    n = c["tasks"] * c["per_device_batch"]
    with tempfile.TemporaryDirectory(prefix="elastic") as work:
        eval_dir = os.path.join(work, "eval")
        shards.write_shards(eval_dir, ctr.synthetic_batch(
            np.random.RandomState(7), c["eval_rows"], vocab=c["vocab"]))
        launcher = ProcessJobLauncher(
            job="elastic", model="ctr", min_workers=2, max_workers=3,
            n_samples=n, per_device_batch=c["per_device_batch"],
            local_devices=local, work_dir=work, ckpt_every=c["ckpt_every"],
            export=True, member_ttl_s=c["member_ttl_s"],
            lease_timeout_s=c["lease_timeout_s"],
            extra_env={"EDL_VOCAB": str(c["vocab"]), "EDL_EVAL_DIR": eval_dir,
                       "EDL_EVAL_MAX_ROWS": str(c["eval_rows"]),
                       "EDL_METRICS_PUSH_S": str(c["push_s"])})
        fleet_tsdb = os.path.join(work, "fleet_tsdb")
        with launcher:
            url, stop_fleet = _start_fleet(launcher, fleet_tsdb)
            try:
                t0 = time.time()
                launcher.start(2)
                _elastic_steady(launcher, c)
                windows = [_fleet_window(launcher, url, 2)]
                grow = {}

                def reshard_path():
                    grow.update(zip(("epoch", "restored", "path"),
                                    _reshard_path(url, 3, c["timeout_s"])))

                events = [("grow 2->3", _elastic_event(
                    launcher, c, 1, lambda: launcher.scale_to(3),
                    then=reshard_path))]
                windows.append(_fleet_window(launcher, url, 3,
                                             grow_epoch=grow["epoch"]))
                top_out, top_s = _run_verb(["top", url, "--polls", "1"])
                events.append(("drain 3->2 (SIGTERM)", _elastic_event(
                    launcher, c, 2, lambda: launcher.scale_to(2))))
                windows.append(_fleet_window(launcher, url, 2))
                events.append(("kill w001 (SIGKILL) 2->1", _elastic_event(
                    launcher, c, 3, lambda: launcher.kill("w001"),
                    last=True)))
                windows.append(_fleet_window(launcher, url, 1))
                rcs = launcher.wait(timeout_s=c["timeout_s"])
                job_s = time.time() - t0
                status, _ = _run_verb(
                    ["job-status", "elastic", "--coordinator",
                     f"127.0.0.1:{launcher.server.port}"])
            finally:
                stop_fleet()
            logs = {w.worker_id: launcher.log_tail(w.worker_id, 10 ** 8)
                    for w in launcher.workers}
            hosts = {}
            for path in glob.glob(os.path.join(launcher.log_dir,
                                               "dist_service_e*.log")):
                with open(path, errors="replace") as f:
                    hosts[int(path.rsplit("_e", 1)[1][:-4])] = f.read()
            kv = {k: launcher.kv(k) for k in (
                "phase", "reshards", "progress", "loss_first", "loss_last",
                "eval_metric", "ckpt_step", "digests_agreed",
                "digest_mismatches", "ckpt_aborts", "restore_last")}
            queue = launcher.client.queue_stats()
            manifest = ckpt.latest_manifest(launcher.ckpt_dir)
            pids = {w.worker_id: w.proc.pid for w in launcher.workers}
        # the fleet's recorded history replayed twice by the watch verb
        # (two processes at once)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            (watch, watch_s), (replay, _) = pool.map(
                _run_verb, [["watch", fleet_tsdb, "--once", "--json"]] * 2)
        fleet_appends = len(TSDB(fleet_tsdb).raw_times())
        coord_proc = _coordinator_process_check(work)
    # w000's first boot (beside w001's) and the joiner's (beside two
    # stepping workers)
    stalls, boots, commits, epochs, peaks = _elastic_report(
        logs, hosts, events, {"w000": t0, "w002": events[0][1]})
    # how each event's new world restored (rank 0's decision, the
    # job's ``restore_last`` at that epoch: p2p:<step> with the plane on)
    restored = {r["epoch"]: r["source"]
                for r in _log_records(logs["w000"], "restore done")}
    for st in stalls:
        st["restore_last"] = restored.get(st["epochs"][1])
    auc = float(kv["eval_metric"].split(":")[1]) if kv["eval_metric"] else 0
    dev_name = "cuda:0" if device == "cuda" else "cpu"
    gates = {
        "succeeded": kv["phase"] == "succeeded",
        "exit_codes": (rcs.get("w000") == 0 and rcs.get("w002") == 0
                       and rcs.get("w001") not in (0, None)),
        "queue": (queue["done"] == c["tasks"] and queue["dead"] == 0
                  and queue["todo"] == 0),
        "reshards": int(kv["reshards"] or 0) >= 3,
        "no_restart": (len(pids) == 3 and logs["w000"].count("boot ") == 1
                       and logs["w000"].count("epoch up") >= 4),
        "loss_fell": float(kv["loss_last"]) < float(kv["loss_first"]),
        "auc": auc > ELASTIC_AUC_MIN,
        "manifest_step": (manifest is not None
                          and manifest["step"] == int(kv["progress"])),
        "device_backend": all(f"device='{dev_name}' backend='gloo'" in t
                              for t in logs.values()),
        "digests": (kv["digest_mismatches"] is None
                    and int(kv["digests_agreed"] or 0) >= 1),
        # the fleet read side (each window's gates raise in place)
        "job_status": (f"todo=0 leased=0 done={c['tasks']} dead=0" in status
                       and re.search(rf"^reshards\s+{kv['reshards']}$",
                                     status, re.M) is not None),
        "watch_replay": watch == replay and watch.strip() != "",
        "fleet_history": fleet_appends >= 2,
        "top": top_out.startswith(f"EDL TOP  {url}"),
    }
    row = {
        "phase": "elastic", "model": "ctr (bench.py:1124)",
        "vocab": c["vocab"], "per_device_batch": c["per_device_batch"],
        "tasks": c["tasks"], "schedule": [e for e, _ in events],
        "backend": "gloo", "device": dev_name, "job_s": job_s,
        "step_check": step_check, "stalls": stalls, "boots": boots,
        "commits": commits, "epochs": epochs, "peak_mem_bytes": peaks,
        "exit_codes": rcs, "queue": queue, "kv": kv, "gates": gates,
        "card": card,
    }
    watched = json.loads(watch.strip().splitlines()[-1])
    fleet_row = {
        "phase": "elastic_fleet", "push_s": c["push_s"], "windows": windows,
        "grow_reshard": grow, "top_s": top_s,
        "job_status": status.strip().splitlines(),
        "fleet_history_appends": fleet_appends,
        "watch": {"rules": len(watched["rules"]),
                  "fired_total": watched["fired_total"],
                  "pages": watched["pages"],
                  "transitions": len(watched["transitions"]),
                  "seconds": watch_s},
        "coordinator_process": coord_proc,
        "stragglers": [{**e["corr"], **e["attrs"]} for e in
                       _flight_records("straggler.detected")],
        "card": card,
    }
    print(json.dumps(fleet_row), flush=True)
    row["fleet"] = fleet_row
    print(json.dumps(row), flush=True)
    if not all(gates.values()):
        bad = [k for k, v in gates.items() if not v]
        raise AssertionError(f"elastic: gates failed {bad}; logs: " + json.dumps(
            {w: t[-3000:] for w, t in logs.items()}))
    return row


# the p2p phase (the peer-to-peer shard plane and the chip-lease plane).
# (a) migration: ELASTIC's CTR job (2^20 vocab, 4096 rows a worker) on
# w000 + w001; after ``steps_before`` steps w002 and w003 are spawned
# and both originals SIGTERMed at once (the reference's
# tests/test_multiproc.py:615 under dp), so the new world holds nothing
# of the state and restores it from the leavers' RAM while they linger
# (EDL_P2P_LINGER_S covers the joiners' boot on the card, 15-30 s)
P2P_MIGRATION = {"vocab": 2 ** 20, "per_device_batch": 4096, "tasks": 200,
                 "steps_before": 20, "ckpt_every": 50, "member_ttl_s": 3.0,
                 "lease_timeout_s": 10.0, "linger_s": 120.0,
                 "timeout_s": 600}
# (b) the shard plane's bandwidth, bench.py:_p2p_bench's two numbers: a
# ~512 MB snapshot (16 pieces of 8192 x 1024 f32) served by a separate
# process, fetched through the pooled FETCHN path (best of 3); and 4
# fetcher processes x 4 server processes (4 pieces each), every fetcher
# draining every server, aggregate bytes over the slowest fetcher
P2P_BENCH = {"pieces": 16, "rows": 8192, "reps": 3, "agg_servers": 4,
             "agg_fetchers": 4, "agg_pieces": 4, "agg_reps": 2}
# (c) warm start and handover (scripts/exp_elasticity.py:528-600 on the
# card): Llama-3-8B at full width, the first 8 of its 32 layers (the
# serving_modes depth), bf16, params from seed 7 on the card pushed from
# host RAM; a fleet whose replicas warm-start from the push; one
# day -> night cycle of the diurnal curve (bench.py / the elasticity
# verb's) over a pool of 3 chips: the trainer holds 2, one replica 1;
# the day's load grants a replica's chip to serving, the night's
# recalls it. Requests run one at a time (so every engine sees the
# same batches): prompts of 96-120 tokens (the 128 bucket), 16 new
# tokens, 2 before the day, 4 in it, 2 after the night
WARM = {"layers": 8, "push_seed": 7, "spec_seed": 1, "slots": 4,
        "max_len": 256, "horizon": 4, "prompt": (96, 121), "max_new": 16,
        "requests": (2, 4, 2), "pool": 3, "train_chips": 2, "hours": 24}
WARM_SHAPE = (1, 128, 32, 8, True, 128)  # the replicas' prefills


def p2p_migration(card, device="cuda", c=P2P_MIGRATION):
    """The dp job moves to a disjoint set of workers from its peers'
    RAM. Gates: the new world's restore decision (``restore_last``) is
    ``p2p:``, each new worker's first restore came from peers and read
    no shard file, the state it brought up equals the leavers' last
    snapshot (every piece, by digest), every queue task done and none
    dead, the loss fell and all four workers exited 0. Returns the row
    (the restore's seconds and bytes, the stall)."""
    import signal
    import tempfile

    from edl_tpu_torch.runtime.launcher import ProcessJobLauncher

    local = 0 if device == "cuda" else 1
    with tempfile.TemporaryDirectory(prefix="p2p") as work:
        launcher = ProcessJobLauncher(
            job="migrate", model="ctr", min_workers=2, max_workers=4,
            n_samples=c["tasks"] * c["per_device_batch"],
            per_device_batch=c["per_device_batch"], local_devices=local,
            work_dir=work, ckpt_every=c["ckpt_every"],
            member_ttl_s=c["member_ttl_s"],
            lease_timeout_s=c["lease_timeout_s"],
            extra_env={"EDL_VOCAB": str(c["vocab"]),
                       "EDL_P2P_LINGER_S": str(c["linger_s"]),
                       "EDL_P2P_DIGEST": "1"})
        with launcher:
            launcher.start(2)
            launcher.wait_progress(c["steps_before"], timeout_s=c["timeout_s"])
            t_event = time.time()
            launcher.spawn()
            launcher.spawn()
            launcher.kill("w000", sig=signal.SIGTERM)
            launcher.kill("w001", sig=signal.SIGTERM)
            rcs = launcher.wait(timeout_s=c["timeout_s"])
            logs = {w.worker_id: launcher.log_tail(w.worker_id, 10 ** 8)
                    for w in launcher.workers}
            kv = {k: launcher.kv(k) for k in (
                "phase", "restore_last", "reshards", "progress", "loss_first",
                "loss_last", "restored_step")}
            queue = launcher.client.queue_stats()
    old, new = ("w000", "w001"), ("w002", "w003")
    linger = {w: _log_records(logs[w], "lingering") for w in old}
    departed = {w: _log_records(logs[w], "departed") for w in old}
    states = {w: _log_records(logs[w], "p2p state") for w in new}
    restores = {w: _log_records(logs[w], "restore done") for w in new}
    via = {w: _log_records(logs[w], "restored via p2p") for w in new}
    reads = {w: _log_records(logs[w], "pieces read") for w in new}
    stats = {w: _log_records(logs[w], "epoch stats") for w in logs}
    # each leaver's last snapshot (step, digest): one each, the same
    left = [(r["step"], r["state_digest"]) for w in old for r in linger[w]]
    step, digest = left[0] if left else (None, None)
    firsts = {w: restores[w][0] if restores[w] else None for w in new}
    moved = {w: next((r for r in states[w] if r["step"] == step), None)
             for w in new}
    old_last = max(r["last_t"] for w in old for r in stats[w] if r["steps"])
    new_first = min(r["first_t"] for w in new for r in stats[w] if r["steps"])
    gates = {
        "succeeded": kv["phase"] == "succeeded",
        "restore_last_p2p": (kv["restore_last"] or "").startswith("p2p:"),
        "first_restore_from_peers": all(
            f is not None and f["source"] == f"p2p:{step}"
            for f in firsts.values()),
        "no_shard_file_read": all(
            r and r[0]["disk"] == 0 and r[0]["disk_files"] == 0
            and r[0]["peer"] > 0 and r[0]["ram"] == 0
            for r in reads.values()),
        "state_bit_equal": (len(left) == 2 and len(set(left)) == 1
                            and all(m is not None
                                    and m["state_digest"] == digest
                                    for m in moved.values())),
        "leavers_lingered": all(linger[w] and departed[w] for w in old),
        "queue": (queue["done"] == c["tasks"] and queue["dead"] == 0
                  and queue["todo"] == 0),
        "loss_fell": float(kv["loss_last"]) < float(kv["loss_first"]),
        "exit_codes": sorted(rcs) == sorted(old + new)
        and all(v == 0 for v in rcs.values()),
    }
    row = {
        "part": "migration", "model": "ctr (bench.py:1124)",
        "vocab": c["vocab"], "per_device_batch": c["per_device_batch"],
        "tasks": c["tasks"], "steps_before": c["steps_before"],
        "leavers_step": step,
        "restore_s": {w: v[0]["load_s"] if v else None
                      for w, v in via.items()},
        "restore_bytes": {w: v[0]["fetched_bytes"] if v else None
                          for w, v in via.items()},
        "pieces_read": {w: r[0] if r else None for w, r in reads.items()},
        # the old world's last step to the new world's first: the
        # joiners' boot (spawned at the SIGTERM), rendezvous and restore
        "stall_s": new_first - old_last,
        "event_to_first_step_s": new_first - t_event,
        "restore_done_after_event_s": {
            w: f["t"] - t_event if f else None for w, f in firsts.items()},
        "linger_s": {w: departed[w][0]["t"] - linger[w][0]["t"]
                     if linger[w] and departed[w] else None for w in old},
        "exit_codes": rcs, "queue": queue, "kv": kv, "gates": gates,
    }
    if not all(gates.values()):
        bad = [k for k, v in gates.items() if not v]
        raise AssertionError(f"p2p migration: gates failed {bad}; row "
                             f"{json.dumps(row)}; logs: " + json.dumps(
                                 {w: t[-3000:] for w, t in logs.items()}))
    return row


_P2P_SERVER_SRC = """
import sys, time
import numpy as np
from edl_tpu_torch.runtime.checkpoint import LocalSnapshot
from edl_tpu_torch.runtime.shard_server import ShardServer
seed, n_pieces, rows = (int(a) for a in sys.argv[1:4])
piece = np.random.RandomState(seed).rand(rows, 1024).astype(np.float32)
pieces = {"p:w": [((i * rows, 0), piece) for i in range(n_pieces)]}
snap = LocalSnapshot(step=1, pieces=pieces,
                     primary={"p:w": [o for o, _ in pieces["p:w"]]},
                     shapes={"p:w": (n_pieces * rows, 1024)},
                     dtypes={"p:w": "float32"})
srv = ShardServer(lambda: snap)
print(srv.port, flush=True)
sys.stdin.read()  # serve until the parent closes the pipe
"""

_P2P_FETCHER_SRC = """
import sys, time
from edl_tpu_torch.runtime.shard_server import RemotePieces, fetch_index
ports = [int(p) for p in sys.argv[1].split(",")]
best = float("inf")
for _ in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    total = 0
    for port in ports:
        _, entries = fetch_index(f"127.0.0.1:{port}")
        rp = RemotePieces(f"127.0.0.1:{port}", entries)
        total += sum(a.nbytes for a in rp.get_many(list(entries)).values())
        rp.close()
    best = min(best, time.perf_counter() - t0)
print(total, best, flush=True)
"""


def _p2p_env():
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))


def _p2p_servers(n, pieces, rows):
    """``n`` shard-server processes of ``pieces`` x [rows, 1024] f32
    each; (processes, ports)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _P2P_SERVER_SRC, str(i), str(pieces),
         str(rows)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        env=_p2p_env(), text=True) for i in range(n)]
    try:
        return procs, [int(p.stdout.readline()) for p in procs]
    except Exception:
        _p2p_stop(procs)
        raise


def _p2p_stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def p2p_bandwidth(c=P2P_BENCH):
    """bench.py:_p2p_bench on the port's shard plane: ``p2p_bw_gbs``
    (one fetcher, this process, one server process) and
    ``p2p_agg_bw_gbs`` (fetcher processes x server processes, all to
    all), GiB/s as bench.py reports them, and the migration stall model
    at 17 GiB a host it gives."""
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime.shard_server import RemotePieces, fetch_index

    procs, ports = _p2p_servers(1, c["pieces"], c["rows"])
    try:
        _, entries = fetch_index(f"127.0.0.1:{ports[0]}")
        best, total = float("inf"), 0
        for _ in range(c["reps"]):
            rp = RemotePieces(f"127.0.0.1:{ports[0]}", entries)
            t0 = time.perf_counter()
            got = rp.get_many(list(entries))
            best = min(best, time.perf_counter() - t0)
            total = sum(a.nbytes for a in got.values())
            rp.close()
            del got
    finally:
        _p2p_stop(procs)
    procs, ports = _p2p_servers(c["agg_servers"], c["agg_pieces"], c["rows"])
    fetchers = []
    try:
        fetchers = [subprocess.Popen(
            [sys.executable, "-c", _P2P_FETCHER_SRC,
             ",".join(map(str, ports)), str(c["agg_reps"])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_p2p_env(),
            text=True) for _ in range(c["agg_fetchers"])]
        agg, worst = 0, 0.0
        for f in fetchers:
            out, err = f.communicate(timeout=SL_SUBPROCESS_TIMEOUT_S)
            if f.returncode != 0 or len(out.split()) != 2:
                raise AssertionError(f"p2p fetcher exited {f.returncode}: "
                                     f"{err[-1000:]}")
            agg += int(out.split()[0])
            worst = max(worst, float(out.split()[1]))
    finally:
        _p2p_stop(procs + fetchers)
    bw = total / best
    return {"part": "bandwidth", "snapshot_bytes": total, "best_s": best,
            "p2p_bw_gbs": bw / (1 << 30),
            "agg_bytes": agg, "agg_slowest_s": worst,
            "p2p_agg_bw_gbs": agg / worst / (1 << 30),
            "servers_x_fetchers": [c["agg_servers"], c["agg_fetchers"]],
            "stall_model_8b_migrate_s": ckpt.p2p_migrate_stall_model(
                17 * (1 << 30), 1, bw)}


def _warm_requests(vocab, c=WARM):
    rng = np.random.RandomState(11)
    return [[rng.randint(1, vocab, rng.randint(*c["prompt"])).tolist()
             for _ in range(n)] for n in c["requests"]]


def _reference_tokens(params, cfg, prompts, c, device):
    """Each prompt through an in-process engine on the pushed params,
    one request at a time, with the replicas' slots, length and
    horizon."""
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.scheduler import RequestQueue

    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=c["slots"], max_len=c["max_len"],
        horizon=c["horizon"], device=device,
        queue=RequestQueue(max_total_len=c["max_len"], max_depth=64))
    out = []
    for i, p in enumerate(prompts):
        eng.submit(f"ref{i}", p, c["max_new"])
        res = eng.run()[f"ref{i}"]
        if res.outcome not in ("done", "eos"):
            raise AssertionError(f"in-process engine: ref{i} {res.outcome}")
        out.append(res.tokens)
    return out


def _cold_vs_p2p(host, cfg, addr, workdir):
    """scripts/exp_elasticity.py:475 measure_cold_vs_p2p: the p2p pull
    of the tree from live RAM against the cold disk round trip (export
    publish, then ``load_export``) of the same tree; the pulled tree
    must equal the pushed one byte for byte. Host RAM on both ends."""
    import torch

    from edl_tpu_torch.elasticity import weightpush
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime import export

    t0 = time.perf_counter()
    fetched, doc, _ = weightpush.fetch_params(addr)
    warm_s = time.perf_counter() - t0
    want = dict(ckpt._leaf_keys(host))
    got = dict(ckpt._leaf_keys(fetched))
    equal = (doc == cfg.to_meta() and set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        for k in want))
    nbytes = sum(t.nbytes for t in got.values())
    del fetched, got
    exp_dir = os.path.join(workdir, "export")
    t0 = time.perf_counter()
    export.export_params(exp_dir, host, step=0, dtype="none",
                         model_meta=cfg.to_meta())
    loaded, _ = export.load_export(exp_dir, device="cpu")
    cold_s = time.perf_counter() - t0
    del loaded
    return warm_s, cold_s, equal, nbytes


def warm_handover(card, device="cuda", c=WARM, cfg=None):
    """The chip-lease plane over a live fleet of warm-started replicas
    (``cfg``: the slice's Llama-3-8B at full width cut to ``c["layers"]``
    unless given). Gates: lease conservation after every tick, one
    grant to serving and one recall back, the pulled tree byte-equal to
    the pushed one, every request done with the in-process engine's
    tokens, and each replica's primal launches (its own wrapper's
    count) equal to its prefills x layers and above 0. Returns the row
    (grant -> READY, warm fetch, cold load, the replicas' boots)."""
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch.elasticity import weightpush
    from edl_tpu_torch.elasticity.broker import ChipLeaseBroker
    from edl_tpu_torch.elasticity.controller import (ElasticityController,
                                                     ServePort, TrainPort)
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.fleet import (ReplicaSpec, ReplicaSupervisor,
                                             ServingFleet)
    from edl_tpu_torch.serving.router import (HttpTransport, ReplicaTable,
                                              Router)
    from edl_tpu_torch.serving.scheduler import Request
    from edl_tpu_torch.utils.tree import leaves, replace_leaves

    if cfg is None:
        cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                  n_layers=c["layers"], use_flash=True)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=c["push_seed"], device=device)
    host = replace_leaves(params, [t.cpu() for t in leaves(params)])
    srv = weightpush.serve_params(host, cfg.to_meta())
    push_s = time.perf_counter() - t0
    addr = f"127.0.0.1:{srv.port}"
    waves = _warm_requests(cfg.vocab, c)
    prompts = [p for w in waves for p in w]
    ref = _reference_tokens(params, cfg, prompts, c, device)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="warm")
    spec = ReplicaSpec(workdir=workdir, slots=c["slots"],
                       max_len=c["max_len"], horizon=c["horizon"],
                       seed=c["spec_seed"], warm_from="p2p", warm_addr=addr,
                       device=device)
    reg = MetricsRegistry()
    table = ReplicaTable(registry=reg)
    sup = ReplicaSupervisor(table, spec, spawn_retries=0)
    router = Router(table, transport=HttpTransport(), seed=0, registry=reg)
    fleet = ServingFleet(sup, router)
    state = {"train_chips": c["train_chips"], "load": 0.25}
    counted = {}

    def add_replica():
        t = time.perf_counter()
        fleet.scale_up()
        return time.perf_counter() - t

    def remove_replica():
        for rid in table.ids():  # the victim's counts before it goes
            counted[rid] = _replica_counts(sup.handle(rid).url)
        fleet.scale_down()

    broker = ChipLeaseBroker(c["pool"], registry=reg)
    ctl = ElasticityController(
        broker,
        TrainPort(chips=lambda: state["train_chips"],
                  apply_chips=lambda n: state.update(train_chips=n),
                  min_chips=1),
        ServePort(replicas=lambda: len(table.ids()),
                  load=lambda: state["load"], slo_breached=lambda: False,
                  add_replica=add_replica, remove_replica=remove_replica,
                  min_replicas=1),
        chips_per_replica=1, load_high=4.0, load_low=0.5, cooldown_s=0.0,
        registry=reg)
    results, order, rows = {}, [], []
    conserved = []

    def drive(wave):
        for p in waves[wave]:
            rid = f"w{len(order)}"
            order.append(rid)
            results[rid] = fleet.generate(Request(rid=rid, prompt=p,
                                                  max_new=c["max_new"]))

    try:
        t_boot = time.perf_counter()
        fleet.start(1)
        boot_s = time.perf_counter() - t_boot
        ctl.bootstrap()
        conserved.append(broker.check_conservation())
        drive(0)
        wave = 1
        for hour in range(c["hours"]):
            h = hour % 24
            state["load"] = (6.0 if 10 <= h <= 17 else
                             2.0 if h in (8, 9, 18, 19) else 0.25)
            action = ctl.tick()
            conserved.append(broker.check_conservation())
            rows.append({"hour": hour, "load": state["load"],
                         "action": action,
                         "train_chips": state["train_chips"],
                         "replicas": len(table.ids()),
                         "free": broker.free_chips, "epoch": broker.epoch})
            if action is not None:
                drive(wave)
                wave += 1
        for rid in table.ids():
            counted[rid] = _replica_counts(sup.handle(rid).url)
        boots = _boot_breakdown(workdir, flight.default_recorder().records())
        warm_s, cold_s, equal, nbytes = _cold_vs_p2p(host, cfg, addr,
                                                      workdir)
    except Exception:
        print(_replica_logs(workdir), file=sys.stderr, flush=True)
        raise
    finally:
        fleet.stop()
        srv.close()
        shutil.rmtree(workdir, ignore_errors=True)
    outcomes = {r.outcome for r in results.values()}
    identical = [results[rid].tokens == want
                 for rid, want in zip(order, ref)]
    ledger = [dataclasses.asdict(h) for h in ctl.ledger]
    gates = {
        "conserved_every_tick": all(conserved),
        "one_cycle": [h["direction"] for h in ledger]
        == ["to_serve", "to_train"],
        "pushed_tree_equal": equal,
        "requests_done": len(results) == len(prompts)
        and outcomes <= {"done", "eos"},
        "tokens_identical": all(identical),
        "replicas_launched": len(counted) == 2 and all(
            v["launches"] > 0 and v["launches"] == v["prefills"] * cfg.n_layers
            for v in counted.values()),
    }
    grant = next(h for h in ledger if h["direction"] == "to_serve")
    row = {
        "part": "warm_handover",
        "model": f"llama3_8b width, {cfg.n_layers} of 32 layers, bf16",
        "push_bytes": nbytes, "push_s": push_s,
        "elasticity_grant_ready_s": grant["ramp_s"],
        "elasticity_warm_fetch_s": warm_s, "elasticity_cold_load_s": cold_s,
        "first_replica_boot_s": boot_s, "boot_stages_s": boots,
        "handovers": ledger, "rows": [r for r in rows if r["action"]],
        "requests": len(prompts), "tokens_identical": identical,
        "replica_prefills": {k: v["prefills"] for k, v in counted.items()},
        "replica_launches": {k: v["launches"] for k, v in counted.items()},
        "primal_launches": sum(v["launches"] for v in counted.values()),
        "prefill_shape": WARM_SHAPE,
        "trainer": "TrainPort records the chip count only: the trainer "
                   "half of the handover (in-process reshard across "
                   "devices) waits for ROADMAP item 2b",
        "gates": gates,
    }
    if not all(gates.values()):
        bad = [k for k, v in gates.items() if not v]
        raise AssertionError(f"p2p warm handover: gates failed {bad}; "
                             f"{json.dumps(row)}")
    return row


def p2p_phase(card):
    """The migration, the shard plane's bandwidth and the warm-start
    handover, as one JSON line; the replicas' primal launches."""
    t = time.perf_counter()
    mig = p2p_migration(card)
    bw = p2p_bandwidth()
    warm = warm_handover(card)
    row = {"phase": "p2p", "migration": mig, "bandwidth": bw,
           "warm_handover": warm, "seconds": time.perf_counter() - t,
           "card": card}
    print(json.dumps(row), flush=True)
    return warm["primal_launches"]


def _ctr_family(name):
    n = name.lower()
    for keys, fam in (
            (("gemm", "nvjet", "xmma", "cutlass", "splitk"), "matmul (MLP)"),
            (("multi_tensor", "adam"), "adam"),
            (("indexfunc", "index_add", "scatter"),
             "embedding backward (index_add)"),
            (("index_select", "indexselect", "gather"), "embedding forward"),
            (("copy", "cast", "convert"), "cast/copy (table, params)"),
            (("reduce",), "reduction"),
            (("fill",), "fill (zero grads)")):
        if any(k in n for k in keys):
            return fam
    return "elementwise/other"


# -- small_workloads phase -----------------------------------------------------

# the card's f32 forward against _np_resnet / _np_bert (float64), of the
# logits' largest magnitude: cuBLAS and cuDNN in f32 (TF32 off) sum in
# other orders than NumPy (~1e-6 measured on the CPU); cuDNN's conv
# algorithms are given 1e-4. An erf GELU moves the tiny BERT's logits
# by ~2e-4 of their largest, a symmetric SAME pad the ResNet's by ~0.1.
SMALL_REF_OF_MAX = {"resnet": 1e-4, "bert": 2e-5}
# one f32 step (fit_a_line: 20) on the card against the CPU: the loss,
# every param and Adam's first moment within these of each leaf's
# largest entry
SMALL_STEP_OF_MAX = {"fit_a_line": 1e-5, "resnet": 1e-4, "bert": 1e-4}
FAL = {"n": 4096, "batch": 256, "steps": 500, "chunk": 20, "lr": 1e-2,
       "noise": 0.1}
RESNET = {"batch": 128, "size": 32, "warmup": 2, "steps": 6, "loops": 3}
BERT = {"batch": 32, "seq": 512, "warmup": 2, "steps": 6, "loops": 3}
PREDICT_ROWS = 256
LM_PREDICT = (64, 512)  # rows x tokens of the flagship llama predict


class _no_tf32:
    """TF32 off in cuBLAS and cuDNN for an f32 agreement check (cuDNN's
    default is on), restored after."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _np_conv(x, w, stride=1):
    """NHWC x HWIO in float64 with XLA's SAME padding: (ceil(n/s) - 1) *
    s + k - n in all, the low side the floor of half."""
    n, h, wd, _ = x.shape
    kh, kw, _, co = w.shape

    def pads(size, k):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return (total // 2, total - total // 2), out

    ph, oh = pads(h, kh)
    pw, ow = pads(wd, kw)
    xp = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    y = np.zeros((n, oh, ow, co))
    for i in range(kh):
        for j in range(kw):
            y += xp[:, i:i + stride * (oh - 1) + 1:stride,
                    j:j + stride * (ow - 1) + 1:stride, :] @ w[i, j]
    return y


def _np_gn(x, gn, groups, eps=1e-5):
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, groups, c // groups)
    mu = xg.mean(axis=(1, 2, 4), keepdims=True)
    var = ((xg - mu) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    y = ((xg - mu) / np.sqrt(var + eps)).reshape(n, h, w, c)
    return y * gn["g"] + gn["b"]


def _np_resnet(p, images, groups):
    """The reference's ResNet forward (edl_tpu/models/resnet.py:153) in
    NumPy float64: logits [B, classes]."""
    p = _np64(p)
    x = np.maximum(_np_gn(_np_conv(np.float64(images), p["stem"]),
                          p["stem_gn"], groups), 0)
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            s = 2 if bi == 0 and si > 0 else 1
            y = np.maximum(_np_gn(_np_conv(x, blk["conv1"], s), blk["gn1"],
                                  groups), 0)
            y = _np_gn(_np_conv(y, blk["conv2"]), blk["gn2"], groups)
            sc = (_np_conv(x, blk["proj"], s) if "proj" in blk
                  else x[:, ::s, ::s])
            x = np.maximum(y + sc, 0)
    return x.mean(axis=(1, 2)) @ p["head"]["w"] + p["head"]["b"]


def _np_ln(x, g, b, eps):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * g + b


def _np_bert(p, tokens, n_heads, eps):
    """The reference's BERT forward (edl_tpu/models/bert.py:155) in
    NumPy float64, tanh GELU: logits [B, T, vocab]."""
    p = _np64(p)
    b, t = tokens.shape
    x = p["embed"][tokens] + p["pos_embed"][None, :t]
    layers = p["layers"]
    for i in range(layers["wqkv"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        d = x.shape[-1]
        hd = d // n_heads
        a = _np_ln(x, lp["ln1_g"], lp["ln1_b"], eps)
        qkv = (a @ lp["wqkv"]).reshape(b, t, 3, n_heads, hd)
        s = np.einsum("bthd,bshd->bhts", qkv[:, :, 0], qkv[:, :, 1])
        s = np.exp(s / np.sqrt(hd) - (s / np.sqrt(hd)).max(-1, keepdims=True))
        probs = s / s.sum(-1, keepdims=True)
        o = np.einsum("bhts,bshd->bthd", probs, qkv[:, :, 2])
        x = x + o.reshape(b, t, d) @ lp["wo"]
        u = _np_ln(x, lp["ln2_g"], lp["ln2_b"], eps) @ lp["w_up"] + lp["b_up"]
        u = 0.5 * u * (1 + np.tanh(np.sqrt(2 / np.pi) * (u + 0.044715 * u ** 3)))
        x = x + u @ lp["w_down"] + lp["b_down"]
    return _np_ln(x, p["ln_f_g"], p["ln_f_b"], eps) @ p["mlm_head"]


def _np64(tree):
    if isinstance(tree, dict):
        return {k: _np64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np64(v) for v in tree]
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree, np.float64)


def _small_reference_check(model, device):
    """The port's tiny ``model`` in f32 on ``device`` against the
    reference's math in NumPy float64 (``_np_resnet`` at 32 x 32 and 33
    x 33, ``_np_bert`` at B3 T24): the logits within
    SMALL_REF_OF_MAX[model] of their largest magnitude. Returns the
    errors; raises AssertionError naming the model."""
    import torch

    from edl_tpu_torch.models import bert, resnet

    gen = torch.Generator().manual_seed(7)
    errs = {}
    with _no_tf32(), torch.no_grad():
        if model == "resnet":
            cfg = resnet.ResNetConfig.tiny()
            params = resnet.init_params(gen, cfg, device="cpu")
            dev_params = _to(params, device)
            for size in (32, 33):
                x = resnet.synthetic_batch(np.random.RandomState(size), 3,
                                           size=size)["images"]
                got = resnet.forward(dev_params, torch.from_numpy(x).to(device),
                                     cfg).cpu().numpy()
                want = _np_resnet(params, x, cfg.groups)
                errs[f"size{size}"] = float(np.abs(got - want).max()
                                            / np.abs(want).max())
        else:
            cfg = bert.BertConfig.tiny()
            params = bert.init_params(gen, cfg, device="cpu")
            toks = bert.synthetic_mlm_batch(np.random.RandomState(0), 3, 24,
                                            cfg.vocab)["tokens"]
            got = bert.forward(_to(params, device),
                               torch.from_numpy(toks).to(device),
                               cfg).cpu().numpy()
            want = _np_bert(params, toks, cfg.n_heads, cfg.norm_eps)
            errs["logits"] = float(np.abs(got - want).max()
                                   / np.abs(want).max())
    if not max(errs.values()) <= SMALL_REF_OF_MAX[model]:
        raise AssertionError(
            f"{model} tiny f32 on {device} vs the NumPy reference: {errs} "
            f"of the largest logit (limit {SMALL_REF_OF_MAX[model]})")
    return errs


def _to(tree, device):
    from edl_tpu_torch.utils.tree import leaves, replace_leaves

    return replace_leaves(tree, [p.to(device, copy=True)
                                 for p in leaves(tree)])


def _small_model(model, device):
    """(params on the CPU, loss_fn, host batch) of a small f32 case:
    fit_a_line's first 256 rows, or tiny ResNet / BERT."""
    import torch

    from edl_tpu_torch.models import bert, linreg, resnet

    gen = torch.Generator().manual_seed(3)
    if model == "fit_a_line":
        x, y = linreg.synthetic_dataset(256, seed=3)
        return (linreg.init_params(gen, device="cpu"), linreg.loss_fn,
                {"x": x, "y": y})
    if model == "resnet":
        cfg = resnet.ResNetConfig.tiny()
        return (resnet.init_params(gen, cfg, device="cpu"),
                resnet.make_loss_fn(cfg),
                resnet.synthetic_batch(np.random.RandomState(3), 8))
    cfg = bert.BertConfig.tiny()
    return (bert.init_params(gen, cfg, device="cpu"), bert.make_loss_fn(cfg),
            bert.synthetic_mlm_batch(np.random.RandomState(3), 4, 32,
                                     cfg.vocab))


def _small_step_agreement(model, device):
    """f32 Adam steps of a small ``model`` case on ``device`` and on the
    CPU (fit_a_line: 20 at adam(1e-2); ResNet and BERT tiny: one at
    adam(1e-3)): the worst difference of the loss, every param and
    every first moment, of each leaf's largest entry. Raises beyond
    SMALL_STEP_OF_MAX[model]."""
    import torch

    from edl_tpu_torch.train import trainer

    host, loss_fn, nb = _small_model(model, device)
    steps, lr = (20, FAL["lr"]) if model == "fit_a_line" else (1, 1e-3)
    out = []
    with _no_tf32():
        for dev in ("cpu", device):
            tx = trainer.adam(lr)
            st = trainer.TrainState.create(_to(host, dev), tx)
            step = trainer.make_train_step(loss_fn, tx)
            batch = trainer.global_batch(nb, device=dev)
            for _ in range(steps):
                st, m = step(st, batch)
            out.append(([m["loss"].detach().reshape(1).cpu()]
                        + [p.detach().cpu() for p in trainer.leaves(st.params)]
                        + [t.cpu() for _, n, t, _ in
                           trainer.optimizer_tensors(st) if n == "exp_avg"]))
    worst = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                for a, b in zip(*out))
    if not worst <= SMALL_STEP_OF_MAX[model]:
        raise AssertionError(
            f"{model}: {steps} f32 step(s) on {device} vs the CPU differ by "
            f"{worst} of a leaf's largest entry (limit "
            f"{SMALL_STEP_OF_MAX[model]})")
    return worst


def _fit_a_line(device, steps=FAL["steps"]):
    """The fit_a_line recipe: ``synthetic_dataset(4096, seed=0)``, batch
    256 in order (step i takes rows 256 (i mod 16) onward), ``adam(1e-2)``
    through ``make_train_multistep``, FAL["chunk"] steps a call."""
    import torch

    from edl_tpu_torch.models import linreg
    from edl_tpu_torch.train import trainer

    x, y = linreg.synthetic_dataset(FAL["n"], seed=0, noise=FAL["noise"])
    nb = FAL["n"] // FAL["batch"]
    batches = [{"x": x[(i % nb) * FAL["batch"]:(i % nb + 1) * FAL["batch"]],
                "y": y[(i % nb) * FAL["batch"]:(i % nb + 1) * FAL["batch"]]}
               for i in range(steps)]
    stacked = trainer.stack_batches(batches, device=device)
    tx = trainer.adam(FAL["lr"])
    state = trainer.TrainState.create(
        linreg.init_params(torch.Generator().manual_seed(0), device=device),
        tx)
    multi = trainer.make_train_multistep(linreg.loss_fn, tx)
    losses = []
    t0 = time.perf_counter()
    for s in range(0, steps, FAL["chunk"]):
        state, m = multi(state, {k: v[s:s + FAL["chunk"]]
                                 for k, v in stacked.items()})
        losses.append(m["losses"])
    losses = [float(v) for v in torch.cat(losses)]
    wall = time.perf_counter() - t0
    return {"losses": losses[::50] + [losses[-1]], "final_loss": losses[-1],
            "steps": steps, "steps_per_s": steps / wall}


def _small_train(loss_fn, params, batch, spec, per_step, unit):
    """``adam(1e-3)`` through ``make_train_step`` on one batch (the loss
    must fall on it): spec["warmup"] steps, then spec["loops"] timed
    loops of spec["steps"] steps, then one step under torch.profiler.
    Returns the state, every loss, ``unit``/s (``per_step`` a step; best,
    median and each loop) and launches a step."""
    import torch

    from edl_tpu_torch.train import trainer

    tx = trainer.adam(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(loss_fn, tx)
    losses = []
    for _ in range(spec["warmup"]):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    rates = []
    for _ in range(spec["loops"]):
        t0 = time.perf_counter()
        for _ in range(spec["steps"]):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        rates.append(per_step * spec["steps"] / (time.perf_counter() - t0))
    holder = {}

    def one():
        holder["state"], holder["m"] = step(state, batch)

    kernels, launches = _device_kernels(_profiled(one))
    state = holder["state"]
    losses = [float(v) for v in losses + [holder["m"]["loss"]]]
    _falling(losses)
    families = {}
    for name, ms in kernels.items():
        fam = _small_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    step_ms = 1e3 * per_step / float(np.median(rates))
    device_ms = sum(kernels.values())
    return state, {"losses": losses, f"{unit}_per_s_best": max(rates),
                   f"{unit}_per_s_median": float(np.median(rates)),
                   f"{unit}_per_s_loops": rates,
                   "launches_per_step": launches, "step_ms": step_ms,
                   # the profiled step's kernel time over the median
                   # step's wall time
                   "device_ms_per_step": device_ms,
                   "busy_share": device_ms / step_ms,
                   "device_ms_by_family": families,
                   "top_kernels": _top(kernels, 5, 60)}


def _small_family(name):
    """The train profile's kernel families, with the small models' own:
    norms (Group/LayerNorm, their moments) and softmax (BERT's attention
    beside the loss's)."""
    n = name.lower()
    if "norm" in n or "moments" in n:
        return "norm"
    if "softmax" in n:
        return "softmax"
    return _kernel_family(name)


def _falling(losses):
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def _export_roundtrip(root, params, meta):
    """Export ``params`` as bf16 with ``export_params``, read the latest
    export back with ``load_export`` onto the card and hold it to the
    trained params cast to bf16, bit for bit. Returns (the loaded
    params, manifest, export seconds, load seconds)."""
    import torch

    from edl_tpu_torch.runtime import checkpoint, export
    from edl_tpu_torch.utils.device import tree_device

    t0 = time.perf_counter()
    export.export_params(root, params, step=7, dtype="bfloat16",
                         model_meta=meta)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        loaded, doc = export.load_export(root, device=tree_device(params))
    except Exception as e:  # a missing, torn or unreadable export
        raise AssertionError(f"export under {root} does not load: {e!r}")
    t_load = time.perf_counter() - t0
    want = dict(checkpoint._leaf_keys(params))
    got = dict(checkpoint._leaf_keys(loaded))
    if got.keys() != want.keys() or doc.get("model") != meta:
        raise AssertionError(f"export keys or record differ: "
                             f"{sorted(set(got) ^ set(want))}, {doc.get('model')}")
    for k, w in want.items():
        w = w.detach().to(torch.bfloat16)
        if got[k].dtype != torch.bfloat16 or not torch.equal(got[k], w):
            raise AssertionError(f"export leaf {k} is not the bf16 params")
    return loaded, doc, t_export, t_load


def _chunked(fn, x):
    """``fn`` over CHUNK-row slices of host rows ``x``, on the card,
    with grad off: the outputs concatenated on the host."""
    import torch

    from edl_tpu_torch.models.evals import CHUNK

    with torch.no_grad():
        return np.concatenate([
            fn(torch.from_numpy(x[s:s + CHUNK]).cuda()).cpu().numpy()
            for s in range(0, len(x), CHUNK)])


def small_workloads_phase(card):
    """fit_a_line, ResNet-50 and BERT-base trained on the card, each
    exported and scored through ``predict_batch``, and the flagship llama
    exported and scored through ``lm_scan``. Returns the flash launches
    of the llama predict."""
    import dataclasses
    import tempfile

    import torch

    from edl_tpu_torch.models import bert, evals, llama, resnet
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import export, predict
    from edl_tpu_torch.utils.tree import leaves

    t_phase = time.perf_counter()
    rows = []

    # fit_a_line
    t_part = time.perf_counter()
    fal = _fit_a_line("cuda")
    if not fal["final_loss"] < 10 * FAL["noise"] ** 2:
        raise AssertionError(f"fit_a_line final loss {fal['final_loss']} "
                             f">= {10 * FAL['noise'] ** 2}")
    rows.append({"phase": "small_workloads", "model": "fit_a_line",
                 "recipe": "synthetic_dataset(4096), batch 256, adam(1e-2)",
                 **fal, "loss_gate": 10 * FAL["noise"] ** 2,
                 "card_vs_cpu_20_steps_of_max": _small_step_agreement(
                     "fit_a_line", "cuda"),
                 "part_s": time.perf_counter() - t_part, "card": card})
    print(json.dumps(rows[-1]), flush=True)

    with tempfile.TemporaryDirectory(prefix="edl_small_") as tmp:
        # ResNet-50 at full width
        t_part = time.perf_counter()
        ref_err = _small_reference_check("resnet", "cuda")
        agree = _small_step_agreement("resnet", "cuda")
        cfg = resnet.ResNetConfig.resnet50()
        params = resnet.init_params(torch.Generator(device="cuda").manual_seed(0),
                                    cfg, device="cuda")
        nparams = sum(p.numel() for p in leaves(params))
        nb = resnet.synthetic_batch(np.random.RandomState(0), RESNET["batch"],
                                    size=RESNET["size"])
        batch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
        state, run = _small_train(resnet.make_loss_fn(cfg), params, batch,
                                  RESNET, RESNET["batch"], "examples")
        flops = 3 * resnet.forward_flops(cfg, RESNET["size"])
        del batch
        loaded, doc, t_exp, t_load = _export_roundtrip(
            os.path.join(tmp, "resnet"), state.params, cfg.to_meta())
        del state, params
        torch.cuda.empty_cache()
        pr = resnet.synthetic_batch(np.random.RandomState(1), PREDICT_ROWS,
                                    size=RESNET["size"])
        t0 = time.perf_counter()
        out = predict.predict_batch(loaded, doc, pr)
        t_pred = time.perf_counter() - t0
        direct = _chunked(lambda x: resnet.forward(loaded, x, cfg).argmax(-1),
                          pr["images"])
        if not np.array_equal(out["class"], direct):
            raise AssertionError("resnet predict class != a direct forward's")
        del loaded
        rows.append({
            "phase": "small_workloads", "model": "resnet50 (ResNetConfig."
            "resnet50)", "params": nparams, "batch": RESNET["batch"],
            "image": RESNET["size"], "dtype": "bfloat16 over f32 masters",
            "optimizer": "adam(1e-3)", **run,
            "train_flops_per_example": flops,
            "conv_flop_share": (flops * run["examples_per_s_best"]
                                / PEAK_BF16_FLOPS),
            "tiny_vs_numpy_of_max": ref_err,
            "tiny_card_vs_cpu_step_of_max": agree,
            "export_s": t_exp, "load_export_s": t_load,
            "predict_s": t_pred, "predict_rows": PREDICT_ROWS,
            "predict_acc": out["acc"],
            "part_s": time.perf_counter() - t_part, "card": card})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()

        # BERT-base at full width
        t_part = time.perf_counter()
        ref_err = _small_reference_check("bert", "cuda")
        agree = _small_step_agreement("bert", "cuda")
        cfg = bert.BertConfig.base()
        params = bert.init_params(torch.Generator(device="cuda").manual_seed(0),
                                  cfg, device="cuda")
        nparams = sum(p.numel() for p in leaves(params))
        nb = bert.synthetic_mlm_batch(np.random.RandomState(0), BERT["batch"],
                                      BERT["seq"], cfg.vocab)
        batch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
        tokens = BERT["batch"] * BERT["seq"]
        state, run = _small_train(bert.make_loss_fn(cfg), params, batch, BERT,
                                  tokens, "tokens")
        flops_tok = bert.train_flops_per_token(cfg, BERT["seq"])
        del batch
        loaded, doc, t_exp, t_load = _export_roundtrip(
            os.path.join(tmp, "bert"), state.params, cfg.to_meta())
        del state, params
        torch.cuda.empty_cache()
        pr = bert.synthetic_mlm_batch(np.random.RandomState(1), PREDICT_ROWS,
                                      BERT["seq"], cfg.vocab)
        t0 = time.perf_counter()
        out = predict.predict_batch(loaded, doc, pr)
        t_pred = time.perf_counter() - t0
        direct = _chunked(lambda x: bert.forward(loaded, x, cfg).argmax(-1)
                          .to(torch.int32), pr["tokens"])
        mask = pr["mask"] > 0
        acc = float((direct[mask] == pr["targets"][mask]).sum() / mask.sum())
        if not (np.array_equal(out["pred"], direct)
                and out["masked_acc"] == acc):
            raise AssertionError(
                f"bert predict != a direct forward's (masked_acc "
                f"{out['masked_acc']} vs {acc})")
        del loaded
        rows.append({
            "phase": "small_workloads", "model": "bert_base (BertConfig.base)",
            "params": nparams, "batch": BERT["batch"], "seq": BERT["seq"],
            "dtype": "bfloat16 over f32 masters", "optimizer": "adam(1e-3)",
            **run, "train_flops_per_token": flops_tok,
            "mfu": flops_tok * run["tokens_per_s_best"] / PEAK_BF16_FLOPS,
            "tiny_vs_numpy_of_max": ref_err,
            "tiny_card_vs_cpu_step_of_max": agree,
            "export_s": t_exp, "load_export_s": t_load,
            "predict_s": t_pred, "predict_rows": PREDICT_ROWS,
            "predict_masked_acc": out["masked_acc"],
            "part_s": time.perf_counter() - t_part, "card": card})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()

        # the flagship llama: exported with random weights, scored
        t_part = time.perf_counter()
        cfg = dataclasses.replace(_flagship_train_config(), remat=False)
        params = llama.init_params(cfg, seed=0, device="cuda")
        root = os.path.join(tmp, "llama")
        t0 = time.perf_counter()
        export.export_params(root, params, step=1, model_meta=cfg.to_meta())
        t_exp = time.perf_counter() - t0
        del params
        t0 = time.perf_counter()
        loaded, doc = predict.load_params_for_predict(root, device="cuda")
        t_load = time.perf_counter() - t0
        n, t = LM_PREDICT
        toks = llama.synthetic_tokens(np.random.RandomState(2), n, t - 1,
                                      cfg.vocab)["tokens"]
        fa.reset_launches()
        t0 = time.perf_counter()
        out = predict.predict_batch(loaded, doc, {"tokens": toks})
        t_pred = time.perf_counter() - t0
        counts = fa.launch_counts()
        want = {k: 0 for k in counts}
        want["flash_fwd"] = cfg.n_layers * -(-n // predict._CHUNK)
        if counts != want:
            raise AssertionError(f"llama predict launches {counts}, want "
                                 f"{want}")
        lcfg = llama.LlamaConfig.from_meta(doc["model"])
        direct = _chunked(lambda x: llama.forward(loaded, x, lcfg)
                          [:, -1].argmax(-1).to(torch.int32), toks)
        # the same CE through plain attention: the one check of this
        # path that does not run the flash kernel on both sides
        dense = dataclasses.replace(lcfg, use_flash=False)
        with torch.no_grad():
            dense_ppl = evals.lm_ppl(
                lambda p, x: llama.forward(p, x, dense), loaded, toks)
        rel = abs(math.log(out["ppl"]) - math.log(dense_ppl)) / abs(
            math.log(dense_ppl))
        if not (math.isfinite(out["ppl"]) and rel <= LOSS_RTOL
                and np.array_equal(out["next_token"], direct)):
            raise AssertionError(
                f"llama predict: ppl {out['ppl']} vs dense {dense_ppl} "
                f"(ln rel {rel:.3g} > {LOSS_RTOL}?), next_token equal to "
                f"a direct forward's: "
                f"{np.array_equal(out['next_token'], direct)}")
        del loaded
        rows.append({
            "phase": "small_workloads", "model": "llama flagship (bench.py:69,"
            " use_flash)", "export": "bfloat16", "rows": n, "tokens": t,
            "export_s": t_exp, "load_export_s": t_load, "predict_s": t_pred,
            "ppl": out["ppl"], "dense_ppl": dense_ppl,
            "ln_ppl_rel_diff": rel, "ln_ppl_rtol": LOSS_RTOL,
            "flash_launches": counts,
            "part_s": time.perf_counter() - t_part, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "small_workloads_summary",
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return counts["flash_fwd"]


# moe phase: the MoE family (edl_tpu/models/moe.py) at MoEConfig()'s own
# defaults, the full width (d1024/L8/H8/KV4/ff2816/E8/top-2/capacity
# 1.25/v32768, 461.5 M params), bf16 over f32 masters, flash attention,
# B4 x T2048, adamw(1e-3), one warm-up and MOE_STEPS timed steps. The
# card is held to the port on the CPU in f32 (TF32 off, plain attention)
# at the first MOE_CPU_LAYERS layers on the first row's first
# MOE_CPU_TOKENS tokens: loss within MOE_CPU_LOSS_RTOL, every gradient
# leaf's L2 difference within MOE_CPU_REL_L2 of its norm. Not
# elementwise: the experts' ReLU has a kink, and an f32 product summed
# in another order can put an input near 0 on the other side of it,
# which moves one token's whole term of a gradient. On the H100 that
# put w_in's gradient 2.2e-3 of its largest entry off the CPU's and the
# small ln2 leaf (2 x 1024) 1.0e-4 of its norm off, while the loss
# agreed to 8.7e-8; the bound admits a few such flips, and a wrong
# route, expert product or gather would move whole tokens' outputs and
# the loss with them. The routing, fed bit-equal router probabilities
# on both sides, is checked equal on its own. Then an export scored by
# predict on MOE_PREDICT rows x tokens.
MOE_BATCH = (4, 2048)
MOE_STEPS = 5
MOE_CPU_LAYERS = 2
MOE_CPU_TOKENS = 512
MOE_CPU_LOSS_RTOL = 1e-5
MOE_CPU_REL_L2 = 1e-3
MOE_PREDICT = (64, 512)


def _moe_flash_per_step(n_layers, remat=False):
    """Flash launches of one MoE training step: the lse forward once a
    layer (twice under remat, whose recompute runs with grad on too),
    each backward sweep once, the primal forward never."""
    return {"flash_fwd": 0, "flash_fwd_lse": (2 if remat else 1) * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}


def _moe_launch_check(counts, n_layers, steps, remat=False, what="moe"):
    want = {k: steps * v
            for k, v in _moe_flash_per_step(n_layers, remat).items()}
    if counts != want:
        raise AssertionError(f"{what}: flash launches {counts} over {steps} "
                             f"step(s), want {want}")


def _moe_int8_check(calls, cfg):
    """int8 ops of one int8_mxu step: a layer's 4 attention products and
    2 x E expert products (one op an expert), forward and backward; the
    router, the combine and lm_head stay dense."""
    n = (4 + 2 * cfg.n_experts) * cfg.n_layers
    if calls != {"fwd": n, "bwd": n}:
        raise AssertionError(f"int8_mxu step: int8 op calls {calls}, want "
                             f"{n} forward and {n} backward")
    return n


class _moe_routes:
    """Records every ``route`` call of ``parallel/moe.py`` made inside
    the block: (probs, k, capacity, its four outputs)."""

    def __enter__(self):
        from edl_tpu_torch.parallel import moe as pm

        self.pm, self.real, self.calls = pm, pm.route, []

        def spy(probs, k, cap):
            out = self.real(probs, k, cap)
            self.calls.append((probs, k, cap, out))
            return out

        pm.route = spy
        return self.calls

    def __exit__(self, *exc):
        self.pm.route = self.real


class _moe_replay:
    """Routes the ``route`` calls made inside the block as the recorded
    ``calls`` (of :class:`_moe_routes`) did, in order: the same experts,
    slots and kept choices, with the choice probabilities gathered from
    the block's own router probabilities. A forward that differs from
    the recorded one only in rounding then differs from it in nothing
    discrete."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        from edl_tpu_torch.parallel import moe as pm

        self.pm, self.real, self.used = pm, pm.route, 0

        def replay(probs, k, cap):
            p0, k0, cap0, (_, idx, slot, keep) = self.calls[self.used]
            if (k0, cap0, p0.shape) != (k, cap, probs.shape):
                raise AssertionError(f"routing replay {self.used}: k, "
                                     f"capacity or shape differ")
            self.used += 1
            return probs.gather(1, idx), idx, slot, keep

        pm.route = replay

    def __exit__(self, exc_type, *exc):
        self.pm.route = self.real
        if exc_type is None and self.used != len(self.calls):
            raise AssertionError(f"routing replay used {self.used} of "
                                 f"{len(self.calls)} recorded calls")


def _moe_dense_agreement(flash, dense, what):
    """``flash()`` and ``dense()`` (the same function with the flash
    kernels and with plain attention) each give a loss-like value. In
    bf16 the two round differently, and a choice whose router
    probabilities nearly tie can flip between them and move its
    token's output whole (and, through the capacity queue, later
    tokens' slots). So the dense value is taken twice: free, and under
    the flash forward's routing (:class:`_moe_replay`); the latter must
    be within LOSS_RTOL (relative) of the flash value. Returns the
    figures."""
    with _moe_routes() as routes:
        f = flash()
    with _moe_routes() as d_routes:
        d = dense()
    with _moe_replay(routes):
        r = dense()
    differ = sum(int((a[3][1] != b[3][1]).sum())
                 for a, b in zip(routes, d_routes))
    choices = sum(a[3][1].numel() for a in routes)
    rel_free = abs(f - d) / abs(d)
    rel = abs(f - r) / abs(r)
    if not (math.isfinite(f) and rel <= LOSS_RTOL):
        raise AssertionError(
            f"{what}: flash {f} vs dense under its routing {r} (rel "
            f"{rel:.3g} > {LOSS_RTOL}); dense free {d} (rel "
            f"{rel_free:.3g}), {differ} of {choices} choices differ")
    return {"flash": f, "dense": d, "dense_flash_routing": r,
            "rel_diff": rel, "rel_diff_free_routing": rel_free,
            "rtol": LOSS_RTOL, "choices_differ": differ,
            "choices": choices}, routes


def _moe_route_check(calls):
    """Each recorded routing against the same router probabilities
    routed on the CPU: the experts, slots and kept choices must be
    equal. Returns the share of choices dropped, a layer."""
    import torch

    from edl_tpu_torch.parallel import moe as pm

    dropped = []
    for i, (probs, k, cap, (_, idx, slot, keep)) in enumerate(calls):
        _, c_idx, c_slot, c_keep = pm.route(probs.detach().cpu(), k, cap)
        if not (torch.equal(idx.cpu(), c_idx)
                and torch.equal(slot.cpu(), c_slot)
                and torch.equal(keep.cpu(), c_keep)):
            raise AssertionError(f"routing {i} differs from the CPU's on "
                                 f"the same router probabilities")
        dropped.append(1.0 - float(c_keep.float().mean()))
    return dropped


def _moe_cpu_agreement(params, cfg, tokens, device):
    """The first MOE_CPU_LAYERS layers in f32 (plain attention) on
    ``device`` and on the CPU, one value_and_grad on the first row's
    first MOE_CPU_TOKENS + 1 tokens. Raises past the tolerances; returns
    the loss's relative difference, the worst gradient leaf's relative
    L2 difference and its name, and the largest elementwise difference
    of any leaf as a share of that leaf's largest entry."""
    import torch

    from edl_tpu_torch.models import moe
    from edl_tpu_torch.train import trainer
    from edl_tpu_torch.utils.tree import replace_leaves

    cut = {k: (v if k != "layers" else
               {n: x[:MOE_CPU_LAYERS] for n, x in v.items()})
           for k, v in params.items()}
    cfg = dataclasses.replace(cfg, n_layers=MOE_CPU_LAYERS,
                              dtype=torch.float32, use_flash=False,
                              remat=False, int8_mxu=False)
    row = tokens[:1, :MOE_CPU_TOKENS + 1]
    out = []
    with _no_tf32():
        for dev in (device, "cpu"):
            p = replace_leaves(cut, [x.detach().to(dev).clone()
                                     for x in trainer.leaves(cut)])
            out.append(trainer.value_and_grad(moe.make_loss_fn(cfg))(
                trainer.trainable(p), {"tokens": row.to(dev)}))
    (loss, grads), (c_loss, c_grads) = out
    rel = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    worst, worst_leaf, of_max = 0.0, None, 0.0
    for (name, g), c in zip(_named_leaves(grads), trainer.leaves(c_grads)):
        d = g.cpu() - c
        l2 = float(d.norm()) / max(float(c.norm()), 1e-30)
        if l2 >= worst:
            worst, worst_leaf = l2, name
        of_max = max(of_max, float(d.abs().max()) / max(
            float(c.abs().max()), 1e-30))
    if not (rel <= MOE_CPU_LOSS_RTOL and worst <= MOE_CPU_REL_L2):
        raise AssertionError(
            f"moe card vs CPU at {MOE_CPU_LAYERS} layers: loss rel diff "
            f"{rel} (limit {MOE_CPU_LOSS_RTOL}), worst gradient leaf "
            f"{worst_leaf} off by {worst} of its norm (limit "
            f"{MOE_CPU_REL_L2})")
    return rel, worst, worst_leaf, of_max


def _moe_remat_check(params, cfg, batch):
    """One value_and_grad without remat and one with each layer
    checkpointed whole, each counted: the flash launches as reckoned,
    the loss and every gradient leaf equal (within REMAT_LOSS_RTOL and
    REMAT_GRAD_OF_MAX of the leaf's largest entry; bit-equal is
    expected). Returns the largest differences."""
    from edl_tpu_torch.models import moe
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.train import trainer

    out = []
    for remat in (False, True):
        fa.reset_launches()
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads = trainer.value_and_grad(moe.make_loss_fn(c))(params,
                                                                  batch)
        _moe_launch_check(fa.launch_counts(), cfg.n_layers, 1, remat,
                          f"moe value_and_grad (remat={remat})")
        out.append((loss, trainer.leaves(grads)))
    (loss, grads), (r_loss, r_grads) = out
    loss_rel = abs(float(loss) - float(r_loss)) / abs(float(loss))
    worst = diff = 0.0
    for g, r in zip(grads, r_grads, strict=True):
        d = float((g - r).abs().max())
        diff = max(diff, d)
        worst = max(worst, d / max(float(g.abs().max()), 1e-30))
    if not (loss_rel <= REMAT_LOSS_RTOL and worst <= REMAT_GRAD_OF_MAX):
        raise AssertionError(
            f"moe remat vs none: loss rel diff {loss_rel} (limit "
            f"{REMAT_LOSS_RTOL}), worst gradient leaf {worst} of its max "
            f"(limit {REMAT_GRAD_OF_MAX})")
    return {"remat_loss_rel_diff": loss_rel,
            "remat_grad_max_abs_diff": diff,
            "remat_grad_worst_of_leaf_max": worst,
            "remat_bit_equal": diff == 0.0 and loss_rel == 0.0}


def _moe_reshard_check(state, step, batch, device):
    """The one-device reshard of the trained state: ``snapshot`` (device
    to host), ``staged_reshard(stage="f32")`` (the overlapped round
    trip, the stall) and ``restore`` of the snapshot, each timed. The
    staged state must equal the restored one bit for bit, and two steps
    from it must give the losses two steps from the state itself give,
    bit for bit. Returns the seconds and losses."""
    import torch

    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.train import trainer

    def keyed(st):
        out = {f"p{i}": p for i, p in enumerate(trainer.leaves(st.params))}
        out.update({f"o{i}/{n}": t
                    for i, n, t, _ in trainer.optimizer_tensors(st)})
        return out

    def timed(fn, *args, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(device)
        return out, time.perf_counter() - t0

    host, snapshot_s = timed(ckpt.snapshot, state)
    staged, stall_s = timed(ckpt.staged_reshard, state, stage="f32",
                            device=device)
    back, restore_s = timed(ckpt.restore, host, device=device)
    del host
    a, b = keyed(staged), keyed(back)
    if a.keys() != b.keys() or not all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("moe: f32 staged reshard differs from "
                             "snapshot + restore")
    del a, b, back
    losses = {}
    for name, st in (("resharded", staged), ("unresharded", state)):
        losses[name] = []
        for _ in range(2):
            st, m = step(st, batch)
            losses[name].append(float(m["loss"]))
    if losses["resharded"] != losses["unresharded"]:
        raise AssertionError(f"moe: losses after the reshard {losses}")
    return {"snapshot_s": snapshot_s, "reshard_stall_host_f32_s": stall_s,
            "restore_s": restore_s,
            "state_gb": ckpt.state_nbytes(state) / 1e9,
            "losses_after_reshard": losses["resharded"],
            "losses_without_reshard": losses["unresharded"]}, st


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _moe_predict(params, cfg, root, device):
    """Export ``params`` (bf16), score MOE_PREDICT rows x tokens through
    ``predict_batch`` (one chunk: every layer's primal flash forward
    once) and the same CE through plain attention. Raises unless the
    primal launches are one chunk's and ``ln ppl`` is within LOSS_RTOL
    (relative) of the dense forward's under the same routing
    (:func:`_moe_dense_agreement`)."""
    import torch

    from edl_tpu_torch.models import evals, moe
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import predict

    loaded, doc, t_exp, t_load = _export_roundtrip(root, params,
                                                   cfg.to_meta())
    n, t = MOE_PREDICT
    toks = moe.synthetic_tokens(np.random.RandomState(2), n, t - 1,
                                cfg.vocab)["tokens"]
    dense = dataclasses.replace(moe.MoEConfig.from_meta(doc["model"]),
                                use_flash=False)
    scored = {}

    def flash():
        fa.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        scored.update(predict.predict_batch(loaded, doc, {"tokens": toks}))
        scored["predict_s"] = time.perf_counter() - t0
        scored["counts"] = fa.launch_counts()
        return math.log(scored["ppl"])

    def plain():
        with torch.no_grad():
            return math.log(evals.lm_ppl(
                lambda p, x: moe.forward(p, x, dense)[0], loaded, toks))

    agree, _ = _moe_dense_agreement(flash, plain, "moe predict ln ppl")
    counts = scored["counts"]
    want = {k: 0 for k in counts}
    want["flash_fwd"] = cfg.n_layers * -(-n // predict._CHUNK)
    if counts != want or scored["next_token"].shape != (n,):
        raise AssertionError(f"moe predict launches {counts}, want {want}")
    return {"rows": n, "tokens": t, "export_s": t_exp, "load_export_s":
            t_load, "predict_s": scored["predict_s"], "ppl": scored["ppl"],
            **{f"ln_ppl_{k}": v for k, v in agree.items()},
            "flash_launches": counts}


def moe_phase(card):
    """The MoE at full width on the card (see the constants above):
    flash vs dense loss (:func:`_moe_dense_agreement`); the routing
    against the CPU's on the same
    router probabilities and the share of choices dropped; the card
    against the CPU at MOE_CPU_LAYERS layers in f32; remat's gradients
    against none's; 1 + MOE_STEPS adamw steps (tokens/s, MFU, peak
    memory, flash launches a step by kind, a profiled step's kernel
    launches); the one-device reshard; one int8_mxu step; an export
    scored by predict. Returns the flash launches by path."""
    import tempfile

    import torch

    from edl_tpu_torch.models import moe
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.train import trainer
    from edl_tpu_torch.utils.tree import replace_leaves

    t_phase = time.perf_counter()
    cfg = moe.MoEConfig(use_flash=True)
    L = cfg.n_layers
    b, t = MOE_BATCH
    tokens = torch.from_numpy(moe.synthetic_tokens(
        np.random.RandomState(0), b, t, cfg.vocab)["tokens"]).cuda()
    batch = {"tokens": tokens}
    params = trainer.trainable(moe.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"))
    row = {"phase": "moe", "model": "MoEConfig() (edl_tpu/models/moe.py:"
           "35-50)",
           "n_params": sum(p.numel() for p in trainer.leaves(params)),
           "n_params_costmodel": costmodel.n_params(cfg),
           "batch": b, "seq": t, "card": card}

    # the routing of the flash forward against the CPU's, and flash vs
    # dense on one batch
    dense = dataclasses.replace(cfg, use_flash=False)
    with torch.no_grad():
        agree, routes = _moe_dense_agreement(
            lambda: float(moe.make_loss_fn(cfg)(params, batch)),
            lambda: float(moe.make_loss_fn(dense)(params, batch)),
            "moe loss")
    dropped = _moe_route_check(routes)
    row.update({"capacity": routes[0][2], "dropped_share_by_layer": dropped,
                "routing_equal_cpu": True,
                **{f"loss_{k}": v for k, v in agree.items()}})
    del routes
    row.update(dict(zip(("cpu_loss_rel_diff", "cpu_grad_worst_rel_l2",
                         "cpu_grad_worst_leaf", "cpu_grad_worst_of_max"),
                        _moe_cpu_agreement(params, cfg, tokens, "cuda"))))
    row.update({"cpu_layers": MOE_CPU_LAYERS, "cpu_tokens": MOE_CPU_TOKENS,
                "cpu_tol": {"loss_rtol": MOE_CPU_LOSS_RTOL,
                            "grad_rel_l2": MOE_CPU_REL_L2}})
    row.update(_moe_remat_check(params, cfg, batch))
    torch.cuda.empty_cache()

    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(moe.make_loss_fn(cfg), tx)
    state, m = step(state, batch)  # warm-up
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(MOE_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _falling(losses)
    _moe_launch_check(counts, L, MOE_STEPS)
    kernels, launches = _device_kernels(_profiled(
        lambda: step(state, batch)))
    step_s = wall / MOE_STEPS
    tok_s = b * t / step_s
    flops_tok = costmodel.train_flops_per_token(cfg, t)
    # the cost model prices an expert as SwiGLU's three matrices; the
    # MoE's ReLU expert has two
    flops_two = flops_tok - 6.0 * L * cfg.d_model * cfg.d_ff * cfg.top_k
    fams = {}
    for name, ms in kernels.items():
        fams[_kernel_family(name)] = fams.get(_kernel_family(name), 0) + ms
    row.update({
        "optimizer": "adamw(1e-3)", "steps": MOE_STEPS, "losses": losses,
        "flash_launches": counts,
        "flash_launches_per_step": _moe_flash_per_step(L),
        "step_s": step_s, "tokens_per_s": tok_s,
        "train_flops_per_token": flops_tok,
        "mfu": flops_tok * tok_s / PEAK_BF16_FLOPS,
        "mfu_two_matrix_experts": flops_two * tok_s / PEAK_BF16_FLOPS,
        "peak_mem_gb": peak / 1e9,
        "profiled_step_launches": launches,
        "profiled_step_device_ms": sum(kernels.values()),
        "profiled_step_ms_by_family": fams,
        "profiled_step_top_kernels": _top(kernels, 6, 70),
    })

    reshard, state = _moe_reshard_check(state, step, batch, "cuda")
    row.update(reshard)
    torch.cuda.empty_cache()

    i8 = dataclasses.replace(cfg, int8_mxu=True)
    step8 = trainer.make_train_step(moe.make_loss_fn(i8), tx)
    im.reset_calls()
    fa.reset_launches()
    t0 = time.perf_counter()
    state, m = step8(state, batch)
    torch.cuda.synchronize()
    row["int8_step_s"] = time.perf_counter() - t0
    row["int8_loss"] = float(m["loss"])
    if not math.isfinite(row["int8_loss"]):
        raise AssertionError(f"moe int8_mxu step loss {row['int8_loss']}")
    row["int8_calls_per_step"] = _moe_int8_check(dict(im.calls), cfg)
    i8_counts = fa.launch_counts()
    _moe_launch_check(i8_counts, L, 1, what="moe int8_mxu step")

    with tempfile.TemporaryDirectory() as tmp:
        params = replace_leaves(
            state.params, [p.detach() for p in trainer.leaves(state.params)])
        del state
        torch.cuda.empty_cache()
        pred = _moe_predict(params, cfg, os.path.join(tmp, "moe"), "cuda")
    row.update({f"predict_{k}": v for k, v in pred.items()})
    row["seconds"] = time.perf_counter() - t_phase
    print(json.dumps(row), flush=True)
    return {"train": counts, "int8": i8_counts,
            "predict": pred["flash_launches"]["flash_fwd"]}


# serving_load phase: bench.py's serving-load rungs on the port and the
# verbs that serve under load. bench.py's horizon rung (bench.py:681-731)
# on its card branch: 12 deep requests, 8 slots x 256, horizon 1 then 8;
# a run's dispatches a token at H=8 within 1/8 plus its admissions', and
# H=1's at least SL_DISPATCH_REDUCTION times H=8's (the reference's CI
# lane). bench.py's goodput rung (bench.py:734-797): the seeded burst
# workload, 8 slots x 256, horizon 4, replayed on the wall clock. Cut:
# bench.py runs one whole warm pass before each measured run (it pays
# jit compiles); eager PyTorch compiles nothing, so a warm-up of
# SL_WARM_REQUESTS requests (SL_WARM_NEW new tokens each in the horizon
# rung) serves.
SL_SLOTS = 8
SL_MAX_LEN = 256
SL_HORIZON_REQUESTS = 12
SL_DISPATCH_REDUCTION = 4.0
SL_GOODPUT = {"seed": 0, "n_requests": 48, "rate_rps": 8.0,
              "arrival": "burst"}
SL_GOODPUT_HORIZON = 4
SL_SLO = (1.0, 0.25)  # default_classes(ttft, itl): bench.py:766
SL_WARM_REQUESTS = 2
SL_WARM_NEW = 8
SL_PHASE_SUM_ATOL = 1e-9  # queue wait + prefill + decode == total_s
# part (c): the verbs as subprocesses on the flagship's export, and a
# 2-replica ServingFleet whose first replica is SIGKILLed mid-traffic
SL_LOADGEN_REQUESTS = 16
SL_FLEET_VERB = {"replicas": 2, "requests": 12}
# (each replica takes its 6 requests at once; 96 new tokens keep the
# victim streaming for 24 blocks, so the SIGKILL lands mid-stream)
SL_KILL_FLEET = {"replicas": 2, "requests": 12, "slots": 8, "max_len": 128,
                 "horizon": 4, "max_new": 96}
SL_SUBPROCESS_TIMEOUT_S = 300
# what a replica or a serving verb imports, compiled to bytecode once,
# beside the build, into SL_BYTECODE_DIR: where Python runs with
# PYTHONDONTWRITEBYTECODE and torch ships no .pyc (the H100 machine),
# each replica compiled torch anew, ~7-10 s of its ~12-14 s boot; the
# verbs and replicas read the bytecode through PYTHONPYCACHEPREFIX
SL_BYTECODE_MODULES = (
    "torch", "numpy", "edl_tpu_torch.cli", "edl_tpu_torch.serving.engine",
    "edl_tpu_torch.serving.replica", "edl_tpu_torch.serving.fleet",
    "edl_tpu_torch.serving.loadgen", "edl_tpu_torch.obs.exporter",
    "edl_tpu_torch.obs.slo", "edl_tpu_torch.obs.tsdb",
    "edl_tpu_torch.runtime.export",
    # the elastic phase's worker processes, store hosts and step check
    # (torch._dynamo: torch.optim's first step imports it)
    "torch.distributed", "torch._dynamo",
    "edl_tpu_torch.runtime.worker_main",
    "edl_tpu_torch.runtime.dist_service", "edl_tpu_torch.runtime.workloads",
    "edl_tpu_torch.runtime.checkpoint", "edl_tpu_torch.runtime.eval_hook",
    "edl_tpu_torch.runtime.epoch_gc", "edl_tpu_torch.runtime.shards",
    "edl_tpu_torch.parallel.mesh", "edl_tpu_torch.models.ctr",
    "edl_tpu_torch.train.trainer", "edl_tpu_torch.train.dp_check",
    "edl_tpu_torch.obs.fleet", "edl_tpu_torch.obs.costmodel",
    # the p2p phase's shard plane, its bandwidth processes and the warm
    # replicas' weight pull
    "edl_tpu_torch.runtime.shard_server",
    "edl_tpu_torch.runtime.p2p_restore",
    "edl_tpu_torch.elasticity.weightpush",
    # the operator verbs and the coordinator process
    "edl_tpu_torch.obs.top", "edl_tpu_torch.obs.postmortem",
    "edl_tpu_torch.obs.profile", "edl_tpu_torch.obs.alerts",
    "edl_tpu_torch.runtime.coordinator_main")
SL_BYTECODE_DIR = os.path.join("edl_tpu_torch", "_build", "pycache")
# the generate verb on the flagship export: a 512-token prompt (the
# decode ladder's b1 prefill, B1 T512 H16 KV8) from this seed, 32 new
# tokens, bf16 and --int8
SL_GENERATE = {"seed": 11, "prompt": 512, "max_new": 32}
# the keys of the reference's `edl watch --json` document
WATCH_KEYS = frozenset(("rules", "time_scale", "transitions", "active",
                        "pages", "fired_total"))
# the reference's export-status line (edl_tpu/cli/main.py)
EXPORT_STATUS_LINE = re.compile(r"^step=\d+ dtype=\S+ leaves=\d+ "
                                r"params=\d+ dir=\S+ source=\S+$")
# the report keys of the reference's `edl loadgen --json`
# (edl_tpu/cli/main.py run_loadgen; held to it in
# tests/test_torch_loadgen.py)
LOADGEN_REPORT_KEYS = frozenset((
    "classes", "failed", "good", "goodput_fraction", "goodput_rps",
    "itl_slo_attainment", "phases", "requests", "served", "shed", "steps",
    "tenants", "throughput_rps", "timeout", "tokens_out",
    "ttft_slo_attainment", "wall_s", "workload"))


def build_workload(n_requests, vocab, rng):
    """scripts/exp_serving.py:64 ``build_workload`` on its card branch,
    ``deep=True`` (the horizon rung's): short prompts, long budgets,
    step-indexed arrivals."""
    from edl_tpu_torch.serving import loadgen

    return loadgen.step_indexed_workload(
        n_requests, vocab, rng, prompt_range=(16, 64),
        max_new_range=(128, 192))


def _run_workload(params, cfg, reqs, horizon, device):
    """scripts/exp_serving.py ``run_workload``: serve the step-indexed
    workload (request i joins at engine iteration ``arrive``). Returns
    (elapsed_s, tokens, metrics, engine)."""
    import torch

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    metrics = ServingMetrics(registry=MetricsRegistry())
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=SL_SLOTS, max_len=SL_MAX_LEN,
        horizon=horizon, metrics=metrics, device=device)
    pending = sorted(reqs, key=lambda r: r["arrive"])
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = i = 0
    while i < len(pending) or eng.has_work:
        while i < len(pending) and pending[i]["arrive"] <= step:
            r = pending[i]
            eng.submit(r["rid"], r["prompt"], r["max_new"])
            i += 1
        eng.step()
        step += 1
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tokens = sum(len(v.tokens) for v in eng.results.values())
    return elapsed, tokens, metrics, eng


def _prefill_buckets(rids):
    """The prefill buckets (padded prompt lengths) the flight recorder
    holds for ``rids``."""
    from edl_tpu_torch.obs import events as flight

    rids = set(rids)
    return [int(e["attrs"]["bucket"])
            for e in flight.default_recorder().records()
            if e["kind"] == "serve.prefill"
            and e.get("corr", {}).get("rid") in rids]


def _horizon_check(reqs, runs):
    """The horizon rung's gates over ``runs`` {horizon: {"results":
    {rid: (outcome, tokens)}, "snap": the metrics snapshot, "tokens":
    n, "elapsed": s}}: every request yields exactly its budget (no EOS),
    the H=8 run's dispatches a token at most 1/8 plus its admission
    dispatches a token, and H=1's at least SL_DISPATCH_REDUCTION times
    H=8's. Returns bench.py's five figures."""
    for h, run in runs.items():
        for r in reqs:
            got = run["results"].get(r["rid"])
            if got is None or got[0] != "done" or got[1] != r["max_new"]:
                raise AssertionError(f"horizon {h}: {r['rid']} gave {got}, "
                                     f"want ('done', {r['max_new']})")
    s8 = runs[8]["snap"]
    dpt8 = s8["dispatches_per_token"]
    most = 1 / 8 + s8["dispatches_prefill"] / runs[8]["tokens"]
    if not dpt8 <= most:
        raise AssertionError(f"H=8 dispatches a token {dpt8} > 1/8 + "
                             f"admissions a token = {most}")
    reduction = runs[1]["snap"]["dispatches_per_token"] / dpt8
    if not reduction >= SL_DISPATCH_REDUCTION:
        raise AssertionError(f"H1/H8 dispatch reduction {reduction:.3f} < "
                             f"{SL_DISPATCH_REDUCTION}")
    rate = {h: run["tokens"] / run["elapsed"] for h, run in runs.items()}
    out = {}
    for h in (1, 8):
        out[f"serving_tokens_per_sec_h{h}"] = rate[h]
        out[f"serving_dispatches_per_token_h{h}"] = (
            runs[h]["snap"]["dispatches_per_token"])
    out["serving_horizon_speedup"] = rate[8] / rate[1]
    out["serving_dispatch_reduction"] = reduction
    out["serving_config"] = f"slots{SL_SLOTS}/req{len(reqs)}"
    return out


def horizon_rung(params, cfg, device="cuda"):
    """bench.py's horizon rung on the port: the deep workload at horizon
    1 and 8, each after a warm-up of SL_WARM_REQUESTS requests. Returns
    bench.py's five figures, the primal launches of each measured run
    and the largest prefill bucket they hit."""
    from edl_tpu_torch.ops import flash_attention as fa

    reqs = build_workload(SL_HORIZON_REQUESTS, cfg.vocab,
                          np.random.RandomState(7))
    runs, launches = {}, {}
    for h in (1, 8):
        warm = [dict(r, rid=f"warm-{r['rid']}", arrive=0,
                     max_new=SL_WARM_NEW)
                for r in reqs[:SL_WARM_REQUESTS]]
        _run_workload(params, cfg, warm, h, device)
        fa.reset_launches()
        elapsed, tokens, metrics, eng = _run_workload(params, cfg, reqs, h,
                                                      device)
        counts = fa.launch_counts()
        prefills = metrics.dispatches["prefill"]
        if eng.recoveries or counts["flash_fwd"] != prefills * cfg.n_layers \
                or any(counts[k] for k in counts if k != "flash_fwd"):
            raise AssertionError(
                f"horizon {h}: launches {counts}, prefills {prefills} x "
                f"{cfg.n_layers} layers, recoveries {eng.recoveries}")
        launches[h] = counts["flash_fwd"]
        runs[h] = {"results": {k: (v.outcome, len(v.tokens))
                               for k, v in eng.results.items()},
                   "snap": metrics.snapshot(), "tokens": tokens,
                   "elapsed": elapsed}
    return (_horizon_check(reqs, runs), launches,
            max(_prefill_buckets(r["rid"] for r in reqs)))


def _goodput_check(n, replay, records, report, launches, prefills,
                   n_layers):
    """The goodput rung's gates: every one of the ``n`` requests has an
    outcome and submitted + rejected == n; for every finished record,
    queue wait + prefill + decode == total_s within SL_PHASE_SUM_ATOL;
    goodput <= finished / wall; primal launches == prefills x layers."""
    if replay["submitted"] + replay["rejected"] != n:
        raise AssertionError(f"submitted {replay['submitted']} + rejected "
                             f"{replay['rejected']} != {n}")
    missing = [r["rid"] for r in records if not r["outcome"]]
    if len(records) != n or missing:
        raise AssertionError(f"{len(records)} records of {n}, without an "
                             f"outcome: {missing}")
    for r in records:
        if r["outcome"] in ("done", "eos"):
            err = abs(r["queue_wait_s"] + r["prefill_s"] + r["decode_s"]
                      - r["total_s"])
            if not err <= SL_PHASE_SUM_ATOL:
                raise AssertionError(f"{r['rid']}: phases sum to total_s "
                                     f"within {err}")
    finished = sum(r["outcome"] in ("done", "eos") for r in records)
    if not report["goodput_rps"] <= finished / replay["wall_s"]:
        raise AssertionError(f"goodput {report['goodput_rps']} > finished "
                             f"{finished} / wall {replay['wall_s']}")
    if launches != prefills * n_layers or prefills < 1:
        raise AssertionError(f"primal launches {launches} != prefills "
                             f"{prefills} x {n_layers} layers")


def goodput_rung(params, cfg, device="cuda"):
    """bench.py's goodput rung on the port: the seeded burst workload
    replayed on the wall clock (one warm-up of SL_WARM_REQUESTS
    requests, then the measured pass), scored by ``obs/slo``. Returns
    bench.py's four figures, the report, the replay's accounting, the
    launches and the largest prefill bucket."""
    import dataclasses

    from edl_tpu_torch.obs import slo
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving import loadgen
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    spec = loadgen.WorkloadSpec(
        vocab=cfg.vocab, classes=slo.default_classes(*SL_SLO), **SL_GOODPUT)
    reqs = loadgen.build(spec)

    def run(rq):
        metrics = ServingMetrics(registry=MetricsRegistry())
        eng = ContinuousBatchingEngine(
            params, cfg, max_slots=SL_SLOTS, max_len=SL_MAX_LEN,
            horizon=SL_GOODPUT_HORIZON, metrics=metrics, device=device)
        return loadgen.replay(eng, rq), metrics, eng

    run([dataclasses.replace(r, rid=f"warm-{r.rid}")
         for r in reqs[:SL_WARM_REQUESTS]])
    fa.reset_launches()
    replay, metrics, eng = run(reqs)
    counts = fa.launch_counts()
    records = slo.request_records(metrics)
    report = slo.compute_goodput(records, spec.class_map(), replay["wall_s"])
    prefills = metrics.dispatches["prefill"]
    if any(counts[k] for k in counts if k != "flash_fwd") or eng.recoveries:
        raise AssertionError(f"goodput rung: launches {counts}, recoveries "
                             f"{eng.recoveries}")
    _goodput_check(len(reqs), replay, records, report, counts["flash_fwd"],
                   prefills, cfg.n_layers)
    figures = {
        "serving_goodput_rps": report["goodput_rps"],
        "serving_ttft_slo_attainment": report["ttft_slo_attainment"],
        "serving_queue_wait_p99_s": report["phases"]["queue_wait_s"]["p99"],
        "serving_goodput_config": (
            f"slots{SL_SLOTS}/req{spec.n_requests}/rate{spec.rate_rps:g}/"
            f"{spec.arrival}"),
    }
    return (figures, report, replay, counts["flash_fwd"],
            max(_prefill_buckets(r.rid for r in reqs)))


def _warm_bytecode():
    """Start the process that writes SL_BYTECODE_MODULES' bytecode under
    SL_BYTECODE_DIR (it prints its seconds), and point every process
    this one starts from now on at that directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(here, SL_BYTECODE_DIR)
    env = dict(os.environ, PYTHONPYCACHEPREFIX=cache, PYTHONPATH=os.pathsep
               .join(p for p in (here, os.environ.get("PYTHONPATH")) if p))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    code = ("import importlib, time; t = time.perf_counter()\n"
            f"for m in {SL_BYTECODE_MODULES!r}: importlib.import_module(m)\n"
            "print(time.perf_counter() - t)")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    return proc


def _bytecode_seconds(proc):
    """Wait for :func:`_warm_bytecode`'s process; its seconds."""
    out, err = proc.communicate(timeout=SL_SUBPROCESS_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"bytecode warm-up exited {proc.returncode}: "
                           f"{err[-2000:]}")
    return float(out.strip().splitlines()[-1])


def _verb(args, env, out):
    """Start ``python -m edl_tpu_torch ARGS`` from this checkout in a
    session of its own (so :func:`_stop_group` also stops the replicas
    it spawns), and a thread (``out["reader"]``) that reads its stdout
    into ``out["stdout"]``; ``out["start"]`` and ``out["end"]`` stamp
    the start and the close of its stdout."""
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)

    out["start"] = time.perf_counter()

    def read():
        out["stdout"] = proc.stdout.read()
        out["end"] = time.perf_counter()

    out["reader"] = threading.Thread(target=read, daemon=True)
    out["reader"].start()
    return proc


def _stop_group(proc):
    """SIGKILL a verb's whole session if it is still running."""
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _watch_loadgen(proc, out):
    """Reads the loadgen verb's stderr; once it prints its metrics
    endpoint, polls ``/history`` until the endpoint lists recorded
    series (``out["history"]``). Runs in a thread."""
    import threading
    import urllib.request

    lines = out.setdefault("stderr", [])
    url = {}

    def poll():
        while proc.poll() is None and "history" not in out:
            try:
                with urllib.request.urlopen(url["u"] + "/history",
                                            timeout=2) as r:
                    doc = json.loads(r.read().decode())
                if doc.get("series"):
                    out["history"] = doc
                    return
            except (OSError, ValueError):
                pass
            time.sleep(0.2)

    def live_verbs():
        # top and profile against the endpoint while the verb serves:
        # top at once, then profile until its report has the engine's
        # efficiency gauges and the ledger's kv bytes
        try:
            top, secs = _run_verb(["top", url["u"], "--polls", "1"])
            out["top"] = {"lines": len(top.splitlines()), "seconds": secs}
            while proc.poll() is None:
                text, secs = _run_verb(["profile", url["u"], "--json"])
                rep = json.loads(text)
                mfu = {ph: (rep["phases"].get(ph) or {}).get("mfu", 0.0)
                       for ph in ("prefill", "decode")}
                if all(mfu.values()) and rep["hbm_bytes"].get("kv"):
                    out["profile"] = {"mfu": mfu, "seconds": secs,
                                      "kv_bytes": rep["hbm_bytes"]["kv"]}
                    return
                time.sleep(0.2)
        except AssertionError as e:
            out["live_verbs_error"] = str(e)

    for line in proc.stderr:
        lines.append(line)
        m = re.match(r"# metrics endpoint (\S+)/metrics", line)
        if m and "u" not in url:
            url["u"] = m.group(1)
            threading.Thread(target=poll, daemon=True).start()
            out["live_verbs"] = threading.Thread(target=live_verbs,
                                                 daemon=True)
            out["live_verbs"].start()


def _replica_counts(url):
    """A replica's ``serve.prefill`` flight events, primal flash launches
    (its wrapper's count, ``edl_kernel_launches``), emitted tokens and
    completed requests so far, from its ``/metrics`` (read, like
    ``/healthz``, without the engine lock)."""
    from edl_tpu_torch.obs.exporter import scrape
    from edl_tpu_torch.obs.metrics import parse_prometheus_text

    fams = parse_prometheus_text(scrape(url, "/metrics"))

    def total(name, **match):
        return int(sum(v for labels, v in fams.get(name, ())
                       if all(labels.get(k) == x for k, x in match.items())))

    return {"prefills": total("edl_events_total", kind="serve.prefill"),
            "launches": total("edl_kernel_launches", kernel="flash_fwd"),
            "tokens": total("edl_serving_tokens_total"),
            "completed": total("edl_serving_requests_total",
                               event="completed")}


def _recorded_launches(db):
    """The primal launches and prefill dispatches at the last point of a
    verb's recorded metric history (``obs/tsdb``): its own wrapper's
    ``edl_kernel_launches`` and its engine's prefill dispatches, None
    where a series was never recorded."""
    out = {}
    for key, name, labels in (
            ("launches", "edl_kernel_launches", {"kernel": "flash_fwd"}),
            ("prefills", "edl_serving_dispatch_total", {"kind": "prefill"})):
        pts = db.points(name, labels)
        out[key] = int(pts[-1][1]) if pts else None
    return out


def _launch_check(counted, n_layers):
    """Each process's primal launches, as its own wrapper counted them,
    equal its prefills x ``n_layers``: ``counted`` {process: {"launches":
    n, "prefills": n}}."""
    for who, c in counted.items():
        if c["launches"] is None or c["prefills"] is None \
                or c["launches"] != c["prefills"] * n_layers:
            raise AssertionError(f"{who}: {c['launches']} primal launches "
                                 f"!= {c['prefills']} prefills x "
                                 f"{n_layers} layers")


def _replica_boots(workdir):
    """Each replica's boot stamps (the ``# replica ID boot {...}`` line
    of its log), by replica id."""
    boots = {}
    for n in sorted(os.listdir(workdir)):
        if n.endswith(".log"):
            with open(os.path.join(workdir, n)) as f:
                for line in f:
                    m = re.match(r"# replica (\S+) boot (\{.*\})$", line)
                    if m:
                        boots[m.group(1)] = json.loads(m.group(2))
    return boots


def _boot_breakdown(workdir, records):
    """Seconds of each replica's boot by stage: from the supervisor's
    ``replica.spawn`` event (``records``: this process's flight events)
    to the replica's ``main``, then its imports, device context, params
    (the export's load), engine and bind stamps, and on to the
    supervisor's ``replica.ready``."""
    spawn, ready = {}, {}
    for e in records:
        who = e["corr"].get("worker")
        if e["kind"] == "replica.spawn":
            spawn[who] = e["t_wall"]
        elif e["kind"] == "replica.ready":
            ready[who] = e["t_wall"]
    out = {}
    for rid, b in _replica_boots(workdir).items():
        if rid not in spawn or rid not in ready:
            continue
        stamps = [("start", spawn[rid]), *b.items(), ("ready", ready[rid])]
        out[rid] = {f"{name}_s": t - prev for (_, prev), (name, t)
                    in zip(stamps, stamps[1:])}
        out[rid]["total_s"] = ready[rid] - spawn[rid]
    return out


def _replica_logs(workdir):
    out = []
    for n in sorted(os.listdir(workdir)):
        if n.endswith(".log"):
            with open(os.path.join(workdir, n)) as f:
                out.append(f"--- {n}\n" + f.read()[-2000:])
    return "\n".join(out)


def fleet_failover(params, cfg, export_dir, workdir, device="cuda"):
    """A ServingFleet of SL_KILL_FLEET["replicas"] replica subprocesses
    of the export; the first is SIGKILLed while it streams. Gates: every
    request ends done/eos, >= 1 failover, the supervisor respawns to
    target, each completion within TEACHER_EPS row std of the dense
    forward's row maximum, and each replica's primal launches (its own
    wrapper's count, scraped from its ``/metrics``; the victim's just
    before the kill) equal to its prefills x layers. Returns the row."""
    import threading

    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.fleet import (ReplicaSpec, ReplicaSupervisor,
                                             ServingFleet)
    from edl_tpu_torch.serving.router import (READY, HttpTransport,
                                              ReplicaTable, Router)
    from edl_tpu_torch.serving.scheduler import Request

    kf = SL_KILL_FLEET
    spec = ReplicaSpec(workdir=workdir, slots=kf["slots"],
                       max_len=kf["max_len"], horizon=kf["horizon"],
                       export_dir=export_dir, device=device)
    reg = MetricsRegistry()
    table = ReplicaTable(registry=reg)
    sup = ReplicaSupervisor(table, spec, spawn_retries=0)
    router = Router(table, transport=HttpTransport(), seed=0, registry=reg)
    fleet = ServingFleet(sup, router)
    rng = np.random.RandomState(5)
    reqs = [Request(rid=f"f{i}",
                    prompt=rng.randint(1, cfg.vocab, 4 + i % 5).tolist(),
                    max_new=kf["max_new"])
            for i in range(kf["requests"])]
    results = {}
    t0 = time.perf_counter()
    try:
        ids = fleet.start(kf["replicas"])
        boot_s = time.perf_counter() - t0
        victim = sup.handle(ids[0])
        threads = [threading.Thread(
            target=lambda r=r: results.__setitem__(r.rid, fleet.generate(r)))
            for r in reqs]
        for t in threads:
            t.start()
        fwd = reg.get("edl_fleet_forwards_total")
        t_wait = time.perf_counter()
        while True:
            # every request routed, each of the victim's admitted, some
            # streamed and some not finished: no prefill can land on it
            # after this read, and the kill cuts live streams
            routed = {k[0]: v[0] for k, v in fwd.samples()}
            got = _replica_counts(victim.url)
            if sum(routed.values()) >= len(reqs) \
                    and got["prefills"] == routed.get(ids[0]) \
                    and got["tokens"] > 0 \
                    and got["completed"] < got["prefills"]:
                break
            if time.perf_counter() - t_wait > 60:
                raise AssertionError(f"victim never streamed: {got}, "
                                     f"routed {routed}")
            time.sleep(0.005)
        counted = {ids[0]: got}
        victim.proc.kill()  # SIGKILL
        victim.proc.wait()
        t_kill = time.perf_counter()
        for t in threads:
            t.join(timeout=SL_SUBPROCESS_TIMEOUT_S)
        serve_s = time.perf_counter() - t_kill
        while True:
            reps = table.snapshot()
            if len(reps) == kf["replicas"] and all(
                    r.state == READY for r in reps) \
                    and ids[0] not in table.ids():
                break
            if time.perf_counter() - t_kill > SL_SUBPROCESS_TIMEOUT_S:
                raise AssertionError(f"fleet never healed: {reps}")
            time.sleep(0.05)
        heal_s = time.perf_counter() - t_kill
        for rid in table.ids():
            counted[rid] = _replica_counts(sup.handle(rid).url)
        boots = _boot_breakdown(workdir, flight.default_recorder().records())
    except Exception:
        print(_replica_logs(workdir), file=sys.stderr, flush=True)
        raise
    finally:
        fleet.stop()
    outcomes = {}
    for res in results.values():
        outcomes[res.outcome] = outcomes.get(res.outcome, 0) + 1
    failovers = sum(r.failovers for r in results.values())
    if len(results) != len(reqs) or set(outcomes) - {"done", "eos"} \
            or failovers < 1:
        raise AssertionError(f"fleet failover: {len(results)} results, "
                             f"outcomes {outcomes}, failovers {failovers}")
    worst = 0.0
    for r in reqs:
        worst = max(worst, _teacher_margin(params, cfg, r.prompt,
                                           results[r.rid].tokens, device))
    if worst > TEACHER_EPS:
        raise AssertionError(f"fleet teacher-forced margin {worst:.4f} row "
                             f"std > {TEACHER_EPS}")
    _launch_check(counted, cfg.n_layers)
    return {
        "replicas": kf["replicas"], "requests": len(reqs),
        "outcomes": outcomes, "failovers": failovers,
        "failed_over": sorted(r.rid for r in results.values()
                              if r.failovers),
        "killed": ids[0], "after_heal": sorted(set(counted) - {ids[0]}),
        "replica_prefills": {k: c["prefills"] for k, c in counted.items()},
        "replica_launches": {k: c["launches"] for k, c in counted.items()},
        "primal_launches": sum(c["launches"] for c in counted.values()),
        "teacher_forced_worst_margin_std": worst,
        "boot_s": boot_s, "after_kill_s": serve_s, "heal_s": heal_s,
        "boot_stages_s": boots,
    }

def _generate_check(root, vocab, device="cuda"):
    """The generate verb on an export, bf16 and ``--int8``, through its
    entry (``edl_tpu_torch.cli.main``, what ``python -m edl_tpu_torch``
    runs) in this process, so the wrapper counts its launches; then
    ``llama.generate`` in this process, after one warm-up call, on what
    ``_load_llama_serving`` (the verb's loader: ``load_export``, then
    ``quantize_params_int8`` for int8) reads from the same export. The
    card runs nothing else meanwhile. Gates: the verb exits 0, launches
    ``flash_fwd`` once a layer (its prefill) and no other kernel, and
    prints the in-process greedy tokens. Returns (rows, the verb's
    launches by tree)."""
    import contextlib
    import io

    import torch

    from edl_tpu_torch import cli
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa

    c = SL_GENERATE
    ids = np.random.RandomState(c["seed"]).randint(0, vocab, c["prompt"])
    args = ["generate", root, "--prompt", ",".join(map(str, ids)),
            "--max-new", str(c["max_new"]), "--device", device]
    rows, launches = [], {}
    for tree, extra in (("bf16", []), ("int8", ["--int8"])):
        out, err = io.StringIO(), io.StringIO()
        fa.reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([*args, *extra])
        verb_s = time.perf_counter() - t
        counts = fa.launch_counts()
        if rc != 0:
            raise AssertionError(f"generate {tree} exited {rc}: "
                                 f"{err.getvalue()[-3000:]}")
        got = [int(x) for x in out.getvalue().strip().splitlines()[-1]
               .split(",")]
        params, cfg = cli._load_llama_serving(root, device, tree == "int8")
        if params is None:
            raise AssertionError(f"generate: {cfg}")
        if counts != {**dict.fromkeys(fa.KERNELS, 0),
                      "flash_fwd": cfg.n_layers}:
            raise AssertionError(f"generate {tree}: launches {counts}, "
                                 f"want flash_fwd x {cfg.n_layers}")
        prompt = torch.from_numpy(ids[None].astype(np.int32)).to(device)
        warm = llama.generate(params, prompt, cfg, max_new=c["max_new"])
        _sync(device)
        t = time.perf_counter()
        toks = llama.generate(params, prompt, cfg, max_new=c["max_new"])
        want = toks[0].tolist()
        gen_s = time.perf_counter() - t
        del params
        if got != want or warm[0].tolist() != want:
            raise AssertionError(f"generate {tree}: the verb's tokens "
                                 f"{got} != in-process {want}")
        launches[tree] = counts["flash_fwd"]
        rows.append({"part": f"generate verb ({tree})",
                     "prompt": c["prompt"], "max_new": c["max_new"],
                     "tokens_equal": True, "verb_wall_s": verb_s,
                     "in_process_s": gen_s,
                     "in_process_tokens_per_s": c["max_new"] / gen_s,
                     "flash_fwd_launches": counts["flash_fwd"]})
    return rows, launches


def serving_verbs(params, cfg, workdir, device="cuda"):
    """Part (c): the flagship exported; ``fleet --swap`` started as a
    subprocess, and once its first replicas are bound, ``loadgen``
    (``--json --metrics-port 0 --tsdb-dir``) as another and, while they
    run, :func:`fleet_failover` in this process. Gates: the loadgen
    report has the reference's keys and every request an outcome; its
    live ``/history`` listed recorded series and the directory holds the
    final ``edl_slo_goodput_rps``; the fleet report says ``ok`` with ``min_ready >= 1``; the verb's
    primal launches in its measured replay (its own wrapper's count,
    ``edl_kernel_launches``, which the verb resets after its warm pass;
    read from the recorded history) equal its prefill dispatches x
    layers. Returns the part's rows and those launches."""
    import threading

    from edl_tpu_torch.obs.tsdb import TSDB
    from edl_tpu_torch.runtime import export

    root = os.path.join(workdir, "export")
    t0 = time.perf_counter()
    export.export_params(root, params, step=1, model_meta=cfg.to_meta())
    export_s = time.perf_counter() - t0
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    tsdb_dir = os.path.join(workdir, "tsdb")
    fleet_dir = os.path.join(workdir, "fleet_verb")
    procs, lg_out, fl_out = [], {}, {}
    try:
        # the fleet verb, whose three rounds of boots are the longest
        # part, boots its first replicas before the other parts start
        # their four processes (on an H100 80GB HBM3 machine, 700 W,
        # five boots at once took 32 s each and one alone 4.8 s)
        fl = _verb(["fleet", "--export-dir", root,
                    "--replicas", str(SL_FLEET_VERB["replicas"]),
                    "--requests", str(SL_FLEET_VERB["requests"]), "--swap",
                    "--workdir", fleet_dir, "--device", device], env, fl_out)
        procs.append(fl)
        fl_err = threading.Thread(
            target=lambda: fl_out.__setitem__("stderr", fl.stderr.read()),
            daemon=True)
        fl_err.start()
        first = [os.path.join(fleet_dir, f"r{i}.port.json")
                 for i in range(SL_FLEET_VERB["replicas"])]
        t_wait = time.perf_counter()
        while not all(os.path.exists(f) for f in first) \
                and fl.poll() is None \
                and time.perf_counter() - t_wait < SL_SUBPROCESS_TIMEOUT_S:
            time.sleep(0.05)
        lg = _verb(["loadgen", root, "--json", "--requests",
                    str(SL_LOADGEN_REQUESTS), "--metrics-port", "0",
                    "--tsdb-dir", tsdb_dir, "--device", device], env, lg_out)
        procs.append(lg)
        watch = threading.Thread(target=_watch_loadgen, args=(lg, lg_out),
                                 daemon=True)
        watch.start()
        kill = fleet_failover(params, cfg, root,
                              os.path.join(workdir, "fleet_kill"), device)
        for p in procs:
            p.wait(timeout=SL_SUBPROCESS_TIMEOUT_S)
        for t in (watch, fl_err, lg_out["reader"], fl_out["reader"]):
            t.join(timeout=10)
    finally:
        for p in procs:
            _stop_group(p)
    lg_s, fl_s = (out.get("end", time.perf_counter()) - out["start"]
                  for out in (lg_out, fl_out))

    # the loadgen verb
    if lg.returncode != 0:
        raise AssertionError(f"loadgen exited {lg.returncode}: "
                             f"{''.join(lg_out.get('stderr', []))[-3000:]}")
    report = json.loads(lg_out["stdout"].strip().splitlines()[-1])
    if set(report) != LOADGEN_REPORT_KEYS:
        raise AssertionError(f"loadgen report keys {sorted(report)} != the "
                             f"reference's {sorted(LOADGEN_REPORT_KEYS)}")
    decided = (report["served"] + report["shed"] + report["timeout"]
               + report["failed"])
    if report["requests"] != SL_LOADGEN_REQUESTS or \
            decided != SL_LOADGEN_REQUESTS:
        raise AssertionError(f"loadgen: {decided} of {report['requests']} "
                             f"requests have an outcome")
    live = lg_out.get("history")
    db = TSDB(tsdb_dir)
    names = db.series_names()
    goodput_pts = db.points("edl_slo_goodput_rps")
    prefill_pts = db.points("edl_events_total", {"kind": "serve.prefill"})
    if not (live and live["series"] and goodput_pts and prefill_pts
            and set(live["series"]) <= set(names)):
        raise AssertionError(
            f"loadgen /history: live {live and live['series'][:5]}, "
            f"recorded {len(names)} series, goodput points "
            f"{len(goodput_pts)}, prefill points {len(prefill_pts)}")
    lg = _recorded_launches(db)
    _launch_check({"loadgen": lg}, cfg.n_layers)
    lg_launches, lg_prefills = lg["launches"], lg["prefills"]
    lg_row = {
        "part": "loadgen verb", "requests": report["requests"],
        "served": report["served"], "goodput_rps": report["goodput_rps"],
        "ttft_slo_attainment": report["ttft_slo_attainment"],
        "queue_wait_p99_s": report["phases"]["queue_wait_s"]["p99"],
        "wall_s": report["wall_s"], "tokens_out": report["tokens_out"],
        "history_live_series": len(live["series"]),
        "history_recorded_series": len(names),
        "history_appends": len(goodput_pts),
        "prefills_warm_and_measured": int(prefill_pts[-1][1]),
        "prefills_measured": lg_prefills, "primal_launches": lg_launches,
        "seconds": lg_s}

    # the fleet verb
    fl_lines = (fl_out.get("stdout") or "").strip().splitlines()
    if fl.returncode != 0 or not fl_lines:
        raise AssertionError(f"fleet exited {fl.returncode}: "
                             f"{(fl_out.get('stderr') or '')[-3000:]}\n"
                             f"{_replica_logs(fleet_dir)}")
    fl_report = json.loads(fl_lines[-1])
    if not (fl_report.get("ok") is True and (fl_report.get("min_ready") or 0)
            >= 1 and fl_report.get("swapped") is True):
        raise AssertionError(f"fleet report {fl_report}")
    fl_row = {"part": "fleet verb (--swap)", **fl_report, "seconds": fl_s}
    kill_row = {"part": "fleet failover (SIGKILL)", **kill}

    # top and profile ran against loadgen's endpoint while it served
    if "live_verbs" in lg_out:
        lg_out["live_verbs"].join(timeout=SL_SUBPROCESS_TIMEOUT_S)
    if "profile" not in lg_out or "top" not in lg_out:
        raise AssertionError(
            "top/profile against the loadgen endpoint: "
            f"{lg_out.get('live_verbs_error', 'loadgen ended first')}")
    live_row = {"part": "top + profile (live loadgen endpoint)",
                "profile": lg_out["profile"], "top": lg_out["top"]}
    # watch over loadgen's recorded history exits with its page count
    t0 = time.perf_counter()
    w = subprocess.run([sys.executable, "-m", "edl_tpu_torch", "watch",
                        tsdb_dir, "--once", "--json"], cwd=here, env=env,
                       capture_output=True, text=True,
                       timeout=SL_SUBPROCESS_TIMEOUT_S)
    doc = json.loads(w.stdout.strip().splitlines()[-1]) if w.stdout else {}
    if set(doc) != WATCH_KEYS or w.returncode != min(doc["pages"], 100):
        raise AssertionError(f"watch exited {w.returncode} with "
                             f"{sorted(doc)}: {w.stderr[-2000:]}")
    watch_row = {"part": "watch (loadgen history)", "rc": w.returncode,
                 "pages": doc["pages"], "fired_total": doc["fired_total"],
                 "transitions": len(doc["transitions"]),
                 "seconds": time.perf_counter() - t0}
    status, status_s = _run_verb(["export-status", root])
    if not EXPORT_STATUS_LINE.match(status.strip()):
        raise AssertionError(f"export-status printed {status!r}")
    gen_rows, gen_launches = _generate_check(root, cfg.vocab, device)
    return ([{"part": "export", "export_s": export_s}, lg_row, fl_row,
             kill_row, live_row, watch_row,
             {"part": "export-status", "line": status.strip(),
              "seconds": status_s}, *gen_rows], lg_launches, gen_launches)


def serving_load_phase(card):
    """bench.py's horizon and goodput rungs and the serving verbs under
    load, on the flagship decode config (bench.py:87
    ``flagship_decode_config``: bench.py:69's model without remat, bf16,
    random weights from seed 4). Returns the primal launches by path and
    the largest prefill shape the in-process rungs ran."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import events as flight

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(_flagship_train_config(), remat=False)
    params = llama.init_params(cfg, seed=4, device="cuda")
    flight.reset_default_recorder()

    t0 = time.perf_counter()
    h_fig, h_launches, h_bucket = horizon_rung(params, cfg)
    print(json.dumps({"phase": "serving_load", "part": "horizon rung",
                      **h_fig, "primal_launches": h_launches,
                      "largest_prefill_bucket": h_bucket,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)

    t0 = time.perf_counter()
    g_fig, report, replay, g_launches, g_bucket = goodput_rung(params, cfg)
    print(json.dumps({"phase": "serving_load", "part": "goodput rung",
                      **g_fig, "requests": report["requests"],
                      "served": report["served"], "good": report["good"],
                      "shed": report["shed"], "wall_s": replay["wall_s"],
                      "submitted": replay["submitted"],
                      "rejected": replay["rejected"],
                      "phases_p50_p99_s": {
                          k: (v["p50"], v["p99"])
                          for k, v in report["phases"].items()},
                      "primal_launches": g_launches,
                      "largest_prefill_bucket": g_bucket,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)

    workdir = tempfile.mkdtemp(prefix="edl_serving_load_")
    try:
        rows, lg_launches, gen_launches = serving_verbs(params, cfg, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for row in rows:
        print(json.dumps({"phase": "serving_load", **row, "card": card}),
              flush=True)
    del params
    torch.cuda.empty_cache()
    launches = {
        "serving_load horizon rung h1": h_launches[1],
        "serving_load horizon rung h8": h_launches[8],
        "serving_load goodput rung": g_launches,
        "loadgen verb (measured replay)": lg_launches,
        "fleet failover replicas": next(
            r for r in rows
            if r["part"] == "fleet failover (SIGKILL)")["primal_launches"],
        "generate verb (flagship export, B1 T512)": gen_launches["bf16"],
        "generate verb --int8 (flagship export, B1 T512)":
            gen_launches["int8"],
    }
    shape = (1, max(h_bucket, g_bucket)) + TRAIN_MAIN[2:]
    print(json.dumps({"phase": "serving_load_summary",
                      "primal_launches": launches,
                      "largest_prefill_shape": shape,
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return launches, shape


def serving_modes_depths(card, depths):
    """The slice, then the serving-modes phase (every gate) on the first
    L of its 32 layers for each L in ``depths``; prints each kv_quant's
    teacher-forced worst margin by depth. What the phase's cut of depth
    does to the margins it gates."""
    import dataclasses

    _, params, cfg, _ = slice_phase(card)
    margins = {}
    for n in depths:
        cut = {**params, "layers": {k: v[:n] for k, v in
                                    params["layers"].items()}}
        t0 = time.perf_counter()
        rows = serving_modes_phase(card, cut,
                                   dataclasses.replace(cfg, n_layers=n))
        margins[n] = {r["kv_quant"]: r["teacher_forced_worst_margin_std"]
                      for r in rows}
        margins[n]["seconds"] = time.perf_counter() - t0
        del cut
    print(json.dumps({"phase": "serving_modes_depths",
                      "worst_margin_std_by_layers": margins,
                      "eps_std": SM_TEACHER_EPS, "card": card}), flush=True)
    return 0


# -- 12. control phase --------------------------------------------------------
# The control plane (ROADMAP items 9c and 9d): the TrainingJob API, the
# fake cluster, the autoscaler with its native planner, the controller,
# the job verbs, the in-process coordinators and the lease/ack data
# queue. Parts (a)-(c) and (e) are host work; (d) trains the flagship
# on the card from the queue.

# (a) examples/elastic_demo.py: 10 hosts x 4 chips, max load 1.0, three
# elastic jobs submitted in turn (name, min, max, chips a worker)
CONTROL_SQUEEZE = {"hosts": 10, "chips_per_host": 4, "cpu_milli": 16000,
                   "mem_mega": 32000, "max_load": 1.0, "ticks": 6,
                   "jobs": (("example", 2, 10, 4), ("example1", 2, 8, 4),
                            ("example2", 2, 4, 4))}
# after each settle (idle, then each submission): {job: [running
# workers, parallelism]} and the pending jobs — the reference's run
# (tests/test_torch_control.py holds this literal to it)
CONTROL_SQUEEZE_TRACE = (
    ({}, []),
    ({"example": [10, 10]}, []),
    ({"example": [8, 8], "example1": [2, 2]}, []),
    ({"example": [6, 6], "example1": [2, 2], "example2": [2, 2]}, []),
)
# (b) the fleet at the controller verb's host shape (96 cores, 384 GiB)
CONTROL_FLEET = {"hosts": 256, "chips_per_host": 8, "cpu_milli": 96_000,
                 "mem_mega": 393_216, "jobs": 64, "seed": 0, "ticks": 4,
                 "max_load": 0.97}
# (c) the JSON forms of examples/ctr/job.yaml and examples/llama/job.yaml
CONTROL_MANIFESTS = {
    "ctr": {
        "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
        "metadata": {"name": "ctr", "namespace": "default"},
        "spec": {
            "fault_tolerant": True, "passes": 1, "data_dir": "/data/ctr",
            "checkpoint_dir": "/ckpt/ctr", "checkpoint_every": 200,
            "volumes": [
                {"name": "dataset",
                 "persistentVolumeClaim": {"claimName": "ctr-dataset"}},
                {"name": "ckpt",
                 "persistentVolumeClaim": {"claimName": "ctr-ckpt"}}],
            "volume_mounts": [
                {"name": "dataset", "mount_path": "/data",
                 "read_only": True},
                {"name": "ckpt", "mount_path": "/ckpt"}],
            "worker": {
                "entrypoint": "python examples/ctr/train.py",
                "min_replicas": 2, "max_replicas": 8,
                "resources": {"requests": {"cpu": "2", "memory": "8Gi",
                                           "tpu": 1},
                              "limits": {"tpu": 1}}}}},
    "llama-fsdp": {
        "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
        "metadata": {"name": "llama-fsdp", "namespace": "default"},
        "spec": {
            "fault_tolerant": True, "passes": 1, "accelerator_type": "v5e",
            "mesh": {"fsdp": 2, "tp": 2},
            "worker": {
                "entrypoint": "python examples/llama/train.py",
                "min_replicas": 1, "max_replicas": 4,
                "resources": {"requests": {"cpu": "8", "memory": "64Gi",
                                           "tpu": 4},
                              "limits": {"tpu": 4}}}}},
}
CONTROL_VERB_ITERATIONS = 6
# what the reference's verbs give on these manifests (validate / submit
# / delete exit codes; after `controller --iterations 6 --tick-s 0`:
# each job's phase, parallelism and running workers from `status`, the
# rows of `list`, the census `monitor --json` polls; `list` after the
# deletes) — tests/test_torch_control.py holds it to the reference
CONTROL_VERBS_EXPECT = {
    "validate": [
        [0, "valid: default/ctr workers=2-8 chips_per_worker=1 "
            "elastic=True\n"],
        [0, "valid: default/llama-fsdp workers=1-4 chips_per_worker=4 "
            "elastic=True\n"]],
    "submit": [[0, "trainingjob default/ctr submitted\n"],
               [0, "trainingjob default/llama-fsdp submitted\n"]],
    "controller": 0,
    "list": [0, "NAMESPACE  NAME        PHASE    WORKERS  TARGET  RANGE  "
                "RESHARDS\n"
                "default    ctr         running  8        8       2-8    1\n"
                "default    llama-fsdp  running  4        4       1-4    "
                "1\n"],
    # [exit code, phase, parallelism, running, pending]
    "status": {"ctr": [0, "running", 8, 8, 0],
               "llama-fsdp": [0, "running", 4, 4, 0]},
    # [exit code, running workers, parallelism, pending jobs, chips
    # requested, chips total]
    "monitor": [0, {"ctr": 8, "llama-fsdp": 4}, {"ctr": 8, "llama-fsdp": 4},
                [], 24, 32],
    "delete": [[0, "trainingjob default/ctr deleted\n"],
               [0, "trainingjob default/llama-fsdp deleted\n"]],
    "delete_again": 1,
    "list_after": [0, "NAMESPACE  NAME  PHASE  WORKERS  TARGET  RANGE  "
                      "RESHARDS\n"],
}
# (d) the lease/ack queue feeding the flagship: 64 samples in chunks of
# 6 (not a multiple of the batch), B4 x T2048; w1 leases a task at step
# 2 and is released at step 3
CONTROL_QUEUE = {"n_samples": 64, "chunk": 6, "batch": 4, "seq": 2048,
                 "seed": 0, "w1_lease_step": 2, "w1_release_step": 3}
CONTROL_MAX_S = 90.0


def _control_modules(pkg):
    """The control-plane modules of ``pkg`` (this script passes the
    port's; the CPU tests pass the reference's to compare)."""
    import importlib
    import types

    names = {"job": "api.job", "fake": "cluster.fake",
             "controller": "controller.controller",
             "autoscaler": "scheduler.autoscaler",
             "native": "scheduler.native", "collector": "monitor.collector"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


def _elastic_job(m, name, lo, hi, chips, cpu="1", memory="1Gi"):
    return m.job.TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {"fault_tolerant": True, "worker": {
            "entrypoint": "python train.py", "min_replicas": lo,
            "max_replicas": hi,
            "resources": {"requests": {"cpu": cpu, "memory": memory,
                                       "tpu": chips},
                          "limits": {"tpu": chips}}}}})


def _counting_groups(cluster):
    """Count each worker group's creations on ``cluster``."""
    created = {}
    create = cluster.create_worker_group

    def counted(plan):
        created[plan.name] = created.get(plan.name, 0) + 1
        return create(plan)

    cluster.create_worker_group = counted
    return created


def control_squeeze(pkg="edl_tpu_torch", use_native=True, c=CONTROL_SQUEEZE):
    """(a) The elastic squeeze: returns the trace (after each settle,
    {job: [running, parallelism]} and the pending jobs) and the worker
    groups' creation counts."""
    m = _control_modules(pkg)
    cluster = m.fake.FakeCluster(hosts=[
        m.fake.FakeHost(f"h{i}", c["cpu_milli"], c["mem_mega"],
                        c["chips_per_host"]) for i in range(c["hosts"])])
    created = _counting_groups(cluster)
    ctl = m.controller.Controller(cluster, autoscaler=m.autoscaler.Autoscaler(
        cluster, max_load_desired=c["max_load"], use_native=use_native))
    collector = m.collector.Collector(
        m.collector.ClusterSource(cluster), interval_s=0)
    trace = []

    def settle(ticks):
        for _ in range(ticks):
            cluster.reconcile()
            ctl.autoscaler.tick()
            ctl.step()
        s = collector.poll()
        trace.append(({k: [s.running_workers[k], s.parallelism[k]]
                       for k in s.submitted_jobs}, list(s.pending_jobs)))
        return s

    settle(1)
    for name, lo, hi, chips in c["jobs"]:
        cluster.submit_job(_elastic_job(m, name, lo, hi, chips))
        s = settle(c["ticks"])
    return trace, created, s


def _squeeze_check(trace, created):
    if [list(x) for x in trace] != [list(x) for x in CONTROL_SQUEEZE_TRACE]:
        raise AssertionError(f"squeeze trace {trace} != "
                             f"{CONTROL_SQUEEZE_TRACE}")
    if trace[-1][1]:
        raise AssertionError(f"squeeze left jobs pending: {trace[-1][1]}")
    if sorted(created.values()) != [1] * len(CONTROL_SQUEEZE["jobs"]):
        raise AssertionError(f"worker groups recreated: {created}")


def _fleet_jobs(m, c):
    """64 seeded elastic jobs: min 1-4 workers, max 2-32, 1-8 chips a
    worker, 4 cores and 16 GiB a chip."""
    rng = np.random.RandomState(c["seed"])
    jobs = []
    for i in range(c["jobs"]):
        lo = int(rng.randint(1, 5))
        hi = max(lo + 1, int(rng.randint(2, 33)))
        chips = int(rng.randint(1, 9))
        jobs.append(_elastic_job(m, f"job{i:02d}", lo, hi, chips,
                                 cpu=str(4 * chips),
                                 memory=f"{16 * chips}Gi"))
    return jobs


def _planner_snapshot(a, cluster):
    """The census and candidates ``Autoscaler.tick`` plans over."""
    a.drain_events()
    r = cluster.inquiry_resource()
    for j in a.jobs.values():
        try:
            j.group = cluster.get_worker_group(j.config)
        except KeyError:
            j.group = None
    return r, a._reschedulable(a._find_pending_job())


def control_fleet(pkg="edl_tpu_torch", c=CONTROL_FLEET):
    """(b) The fleet: ``c["ticks"]`` control ticks (host ms each: the
    fake cluster's reconcile, the autoscaler's tick with the native
    planner, the updaters' step), then both planners on the same
    snapshot, timed, with their plans asserted equal."""
    import logging

    m = _control_modules(pkg)
    cluster = m.fake.FakeCluster(hosts=[
        m.fake.FakeHost(f"host{i}", c["cpu_milli"], c["mem_mega"],
                        c["chips_per_host"]) for i in range(c["hosts"])])
    a = m.autoscaler.Autoscaler(cluster, max_load_desired=c["max_load"],
                                use_native=True)
    ctl = m.controller.Controller(cluster, autoscaler=a)
    # the jobs whose coordinators wait for room warn every tick
    quiet = logging.getLogger(pkg)
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        for job in _fleet_jobs(m, c):
            cluster.submit_job(job)
        ticks, retargeted = [], []
        for _ in range(c["ticks"]):
            t0 = time.perf_counter()
            cluster.reconcile()
            t1 = time.perf_counter()
            target = a.tick()
            t2 = time.perf_counter()
            ctl.step()
            t3 = time.perf_counter()
            ticks.append({"reconcile_ms": 1e3 * (t1 - t0),
                          "autoscaler_ms": 1e3 * (t2 - t1),
                          "step_ms": 1e3 * (t3 - t2)})
            retargeted.append(len(target))
        r, cands = _planner_snapshot(a, cluster)
    finally:
        quiet.setLevel(level)
    resolved = [m.autoscaler.resolve_policy(a.slice_policy, j) for j in cands]
    t0 = time.perf_counter()
    py = m.autoscaler.scale_all_jobs_dry_run(cands, r.copy(), c["max_load"],
                                             a.slice_policy)
    t1 = time.perf_counter()
    nat = m.native.plan_native(cands, r, c["max_load"], resolved)
    t2 = time.perf_counter()
    _fleet_check(py, nat, r, cands)
    return {"ticks_host_ms": ticks, "retargeted_per_tick": retargeted,
            "planner_python_host_ms": 1e3 * (t1 - t0),
            "planner_native_host_ms": 1e3 * (t2 - t1),
            "candidates": len(cands),
            "plan_changes": sum(1 for d in py.values() if d),
            "chips_requested": r.chip_request, "chips_total": r.chip_total}


def _fleet_check(py, nat, r, cands):
    if nat is None:
        raise AssertionError("plan_native returned None: the native "
                             "planner did not plan")
    # the Python plan names the elastic jobs it touched, the native one
    # every candidate: a job either leaves out moves by 0
    diff = {k: (py.get(k, 0), nat.get(k, 0)) for k in set(py) | set(nat)
            if py.get(k, 0) != nat.get(k, 0)}
    if diff:
        raise AssertionError(f"native plan != Python plan: {diff}")
    if not cands or r.chip_request > r.chip_total:
        raise AssertionError(f"{len(cands)} candidates, chips "
                             f"{r.chip_request} / {r.chip_total}")


def _call_verb(main, argv):
    """One verb through ``main`` in this process: (exit code, stdout)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def control_verbs(main, workdir, have_yaml=True, store_cls=None,
                  job_cls=None):
    """(c) The job verbs through ``main`` on the two manifests:
    validate, submit, controller, list, status, monitor --json, delete,
    list. Without PyYAML (``from_yaml`` raises, as the reference's does)
    the jobs are written with ``store_cls(DIR).submit(job_cls.from_dict(
    ...))`` and validate / submit are not run. Returns the record
    :data:`CONTROL_VERBS_EXPECT` holds."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    paths = {}
    for name, doc in CONTROL_MANIFESTS.items():
        paths[name] = os.path.join(workdir, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    rec = {}
    if have_yaml:
        rec["validate"] = [_call_verb(main, ["validate", paths[n]])
                           for n in CONTROL_MANIFESTS]
        rec["submit"] = [_call_verb(main, ["submit", paths[n], "--store",
                                           store])
                         for n in CONTROL_MANIFESTS]
    else:
        st = store_cls(store)
        for doc in CONTROL_MANIFESTS.values():
            st.submit(job_cls.from_dict(doc))
    rc, _ = _call_verb(main, ["controller", "--store", store, "--iterations",
                              str(CONTROL_VERB_ITERATIONS), "--tick-s", "0"])
    rec["controller"] = rc
    rec["list"] = _call_verb(main, ["list", "--store", store])
    status = {}
    for n in CONTROL_MANIFESTS:
        rc, out = _call_verb(main, ["status", n, "--store", store])
        doc = json.loads(out)
        status[n] = [rc, doc["phase"], doc["parallelism"], doc["running"],
                     doc["pending"]]
    rec["status"] = status
    rc, out = _call_verb(main, ["monitor", "--store", store, "--json",
                                "--polls", "1"])
    s = json.loads(out)
    rec["monitor"] = [rc, s["running_workers"], s["parallelism"],
                      s["pending_jobs"], s["chip_request"], s["chip_total"]]
    rec["delete"] = [_call_verb(main, ["delete", n, "--store", store])
                     for n in CONTROL_MANIFESTS]
    rec["delete_again"] = _call_verb(main, ["delete", "ctr", "--store",
                                            store])[0]
    rec["list_after"] = _call_verb(main, ["list", "--store", store])
    # tuples as lists, so the record compares with its JSON form
    return json.loads(json.dumps(rec))


def _verbs_check(rec):
    want = {k: v for k, v in CONTROL_VERBS_EXPECT.items() if k in rec}
    if rec != want:
        bad = {k: (rec.get(k), want.get(k)) for k in set(rec) | set(want)
               if rec.get(k) != want.get(k)}
        raise AssertionError(f"the job verbs differ from the reference's: "
                             f"{bad}")


def _coordinator_script(coord):
    """One membership, KV, barrier and queue script; every answer, with
    tasks as (id, start, end, epoch)."""
    def task(t):
        return None if t is None else [t.task_id, t.start, t.end, t.epoch]

    out = [coord.register("w0", 1), coord.register("w1", 1),
           coord.register("w1", 1), coord.register("w1", 0),
           coord.heartbeat("w0"), coord.heartbeat("ghost"), coord.epoch(),
           [(x.name, x.incarnation, x.rank) for x in coord.members()]]
    coord.kv_put("k", "v 1")
    out += [coord.kv_get("k"), coord.kv_get("none")]
    coord.kv_del("k")
    out += [coord.kv_get("k"), coord.barrier_arrive("b", "w0"),
            coord.barrier_arrive("b", "w1"), coord.barrier_arrive("b", "w0"),
            coord.barrier_count("b"), coord.barrier_count("none")]
    coord.queue_init(20, 6, passes=2)
    leased = [coord.lease("w0"), coord.lease("w1"), coord.lease("w1")]
    out += [task(t) for t in leased]
    out += [coord.ack(leased[0].task_id), coord.nack(leased[1].task_id),
            coord.release_worker("w1"), coord.queue_stats()]
    while True:
        t = coord.lease("w0")
        if t is None:
            break
        out += [task(t), coord.ack(t.task_id)]
    out += [coord.queue_done(), coord.queue_stats(), coord.leave("w1"),
            coord.leave("w1"), coord.epoch(),
            [(x.name, x.incarnation, x.rank) for x in coord.members()]]
    return json.loads(json.dumps(out))


def _coordinator_check():
    """``make_coordinator()`` is the native one, and it answers the
    script as ``PyCoordinator`` does."""
    from edl_tpu_torch.runtime import coordinator as co

    made = co.make_coordinator()
    if type(made) is not co.NativeCoordinator:
        raise AssertionError(f"make_coordinator() gave {type(made).__name__}"
                             f", not the native coordinator")
    native = _coordinator_script(made)
    made.close()
    python = _coordinator_script(co.PyCoordinator())
    if native != python:
        raise AssertionError(f"native coordinator {native} != Python "
                             f"{python}")
    return len(native)


def _ranges(idx):
    """Contiguous [start, end) runs of a batch's sample indices."""
    runs = []
    for i in idx.tolist():
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return runs


def _queue_check(seen, n_samples, losses, direct, counts, steps, n_layers,
                 released):
    got = sorted(seen)
    if got != list(range(n_samples)):
        dup = sorted({i for i in seen if seen.count(i) > 1})
        raise AssertionError(f"samples trained {len(seen)} of {n_samples}, "
                             f"repeated {dup}, missing "
                             f"{sorted(set(range(n_samples)) - set(seen))}")
    if released != 1:
        raise AssertionError(f"release_worker('w1') released {released} "
                             f"tasks, not 1")
    if losses != direct:
        raise AssertionError(f"queue-fed losses {losses} != directly fed "
                             f"{direct}")
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * n_layers * steps,
            "flash_bwd_dq": n_layers * steps,
            "flash_bwd_dkv": n_layers * steps}
    if counts != want or not steps:
        raise AssertionError(f"flash launches {counts} over {steps} steps, "
                             f"want {want}")


def control_queue(card, cfg=None, device="cuda", c=CONTROL_QUEUE):
    """(d) The flagship (``cfg``: bench.py:69 unless given) trained on
    ``device`` from ``ElasticDataQueue`` + ``QueueBatcher`` until the
    queue is done, then the same steps fed the recorded sample ranges
    directly from the same init. Returns the queue run's launches."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime.data import ElasticDataQueue, QueueBatcher
    from edl_tpu_torch.train import trainer

    cfg = cfg or _flagship_train_config()
    data = llama.synthetic_tokens(np.random.RandomState(c["seed"]),
                                  c["n_samples"], c["seq"],
                                  cfg.vocab)["tokens"]

    def run(batches):
        params = trainer.trainable(llama.init_params(
            cfg, seed=0, device=device, dtype=torch.float32))
        tx = trainer.adamw(1e-3)
        state = trainer.TrainState.create(params, tx)
        step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
        losses = []
        for tokens in batches:
            state, met = step(state, {"tokens": torch.from_numpy(
                tokens).to(device)})
            losses.append(float(met["loss"]))
        del state, params
        return losses

    queue = ElasticDataQueue(c["n_samples"], c["chunk"])
    batcher = QueueBatcher(queue, lambda t: {
        "tokens": data[t.start:t.end],
        "idx": np.arange(t.start, t.end)}, worker="w0")
    ranges, seen, released, w1_task = [], [], None, None

    def fed():
        nonlocal released, w1_task
        n = 0
        while not queue.done():
            if n == c["w1_lease_step"]:
                w1_task = queue.get_task("w1")
            if n == c["w1_release_step"]:
                released = queue.release_worker("w1")
            batch = batcher.next_batch(c["batch"])
            ranges.append(_ranges(batch["idx"]))
            seen.extend(batch["idx"].tolist())
            n += 1
            yield batch["tokens"]

    fa.reset_launches()
    t0 = time.perf_counter()
    losses = run(fed())
    _sync(device)
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    steps = len(losses)
    direct = run(np.concatenate([data[s:e] for s, e in r]) for r in ranges)
    _queue_check(seen, c["n_samples"], losses, direct, counts, steps,
                 cfg.n_layers, released)
    later = {i for rs in ranges[c["w1_release_step"]:] for s, e in rs
             for i in range(s, e)}
    if w1_task is None or not set(range(w1_task.start,
                                        w1_task.end)) <= later:
        raise AssertionError(f"w1's task {w1_task} was not redelivered "
                             f"after its release")
    row = {"steps": steps, "batch": c["batch"], "seq": c["seq"],
           "n_samples": c["n_samples"], "chunk": c["chunk"],
           "w1_task": [w1_task.start, w1_task.end], "ranges": ranges,
           "losses": losses, "losses_equal_direct": losses == direct,
           "launches": counts, "queue_run_s": wall,
           "queue_stats": queue.progress(),
           "coordinator_script_answers": _coordinator_check()}
    return counts, row


def control_serving(metrics):
    """(e) ``Collector(ServingSource(metrics))`` over the slice phase's
    serving metrics: the sample's serving block is the snapshot, and it
    carries the efficiency block."""
    from edl_tpu_torch.monitor.collector import Collector, ServingSource

    s = Collector(ServingSource(metrics), interval_s=0).poll()
    snap = metrics.snapshot()
    if s.serving != snap:
        raise AssertionError(f"serving sample {s.serving} != snapshot {snap}")
    if not any(k.startswith("mfu_") for k in s.efficiency):
        raise AssertionError(f"no efficiency block: {s.efficiency}")
    return {"serving_keys": len(s.serving), "efficiency": s.efficiency,
            "render_lines": len(s.render().splitlines())}


def control_phase(card, slice_metrics, device="cuda", cfg=None,
                  fleet_c=CONTROL_FLEET, queue_c=CONTROL_QUEUE):
    """The control phase, (a)-(e); one JSON row. ``cfg``, ``fleet_c``
    and ``queue_c`` cut the phase for a CPU rehearsal."""
    import importlib.util
    import tempfile

    from edl_tpu_torch import cli, cli_store
    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.scheduler import native

    marks = [time.perf_counter()]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    if not native.available():
        raise AssertionError("the native planner did not build")
    trace, created, last = control_squeeze()
    _squeeze_check(trace, created)
    squeeze = {"trace": trace, "groups_created": created,
               "chip_util": last.chip_util, "host_s": lap()}
    fleet = control_fleet(c=fleet_c)
    fleet["host_s"] = lap()
    have_yaml = importlib.util.find_spec("yaml") is not None
    with tempfile.TemporaryDirectory() as d:
        record = control_verbs(cli.main, d, have_yaml, cli_store.JobStore,
                               TrainingJob)
    _verbs_check(record)
    verbs = {"have_yaml": have_yaml,
             "held_on_cpu_only": [] if have_yaml else ["validate", "submit"],
             "record": record, "host_s": lap()}
    counts, queue = control_queue(card, cfg, device=device, c=queue_c)
    queue["s"] = lap()
    serving = control_serving(slice_metrics)
    wall = marks[-1] - marks[0] + lap()
    print(json.dumps({
        "phase": "control", "squeeze": squeeze,
        # host numbers: the control plane does no device work
        "fleet_host": fleet, "verbs": verbs, "queue": queue,
        "serving": serving, "phase_s": wall, "max_s": CONTROL_MAX_S,
        "card": card}), flush=True)
    if wall > CONTROL_MAX_S:
        raise AssertionError(f"control phase took {wall:.1f} s > "
                             f"{CONTROL_MAX_S}")
    return counts


# -- 13. kube_check phase -----------------------------------------------------
# The in-cluster backend (cluster/kube.py behind `controller --kube`) and
# the project's own checkers (analysis/, the `check` and `schedcheck`
# verbs), all host work: (a) the kube loop over tests/fake_kube.py at the
# control phase's fleet, both planners; (b) check; (c) schedcheck.
KUBE_CHECK = {"nodes": 256, "chips_per_node": 8, "cpu": "96",
              "memory": "384Gi", "jobs": 64, "seed": 0, "iterations": 8,
              "max_load": 0.97}
# schedcheck's every harness at its own budget took 50-110 s on an x86
# CPU host (mut-lease-broker's schedule minimization most of it, the
# reference's as the port's): the phase's bound leaves that room
KUBE_CHECK_MAX_S = 240.0


def _kube_census(server, chip_key):
    """Pods and chips requested on the fake API server, read from its
    state (no request)."""
    with server.state.lock:
        pods = list(server.state.objects[("v1", "pods")].values())
    chips = 0
    for pod in pods:
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        for ct in pod.get("spec", {}).get("containers", []):
            res = ct.get("resources", {})
            chips += int(res.get("limits", {}).get(
                chip_key, res.get("requests", {}).get(chip_key, 0)))
    return len(pods), chips


def _kube_run(c, native):
    """One ``controller --kube`` run over a fresh fake API server: its
    exit code, per-tick host ms and census, the native planner's
    answers, each CRD's phase and the final census."""
    import collections
    import importlib.util
    import logging

    from edl_tpu_torch import cli
    from edl_tpu_torch.cluster import kube
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.scheduler import native as native_mod
    from edl_tpu_torch.scheduler.autoscaler import Autoscaler

    # the test suite's in-memory API server, loaded by path (no
    # `tests` package is imported)
    spec = importlib.util.spec_from_file_location("fake_kube", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "fake_kube.py"))
    fake_kube = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake_kube)
    m = _control_modules("edl_tpu_torch")
    server = fake_kube.FakeKubeServer()
    ticks, plans, sources = [], collections.Counter(), []
    tick = {}

    def close_tick():
        if tick:
            tick["pods"], tick["chips_requested"] = _kube_census(
                server, kube.CHIP_RESOURCE_KEY)
            ticks.append(dict(tick))
            tick.clear()

    def timed(cls, name, key, first=False):
        fn = getattr(cls, name)

        def wrapper(self, *a, **k):
            if first:
                close_tick()
                tick.update(poll_ms=0.0, tick_ms=0.0, step_ms=0.0,
                            status_ms=0.0, status_writes=0)
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                tick[key] += 1e3 * (time.perf_counter() - t0)
                if key == "status_ms":
                    tick["status_writes"] += 1
        return fn, wrapper

    def planned(*a, **k):
        out = plan_native(*a, **k)
        plans["plan" if out is not None else "none"] += 1
        return out

    def source_init(self, *a, **k):
        init(self, *a, **k)
        sources.append(self)

    plan_native, init = native_mod.plan_native, kube.KubeJobSource.__init__
    patches = [(kube.KubeJobSource, "poll", "poll_ms", True),
               (Autoscaler, "tick", "tick_ms", False),
               (Controller, "step", "step_ms", False),
               (kube.KubeCluster, "update_training_job_status", "status_ms",
                False)]
    saved = []
    quiet = logging.getLogger("edl_tpu_torch")
    level = quiet.level
    quiet.setLevel(logging.ERROR)  # jobs waiting for room warn every tick
    try:
        for i in range(c["nodes"]):
            server.add_node(f"node{i:03d}", cpu=c["cpu"], memory=c["memory"],
                            tpu=c["chips_per_node"])
        for job in _fleet_jobs(m, {"jobs": c["jobs"], "seed": c["seed"]}):
            server.create_training_job(job.to_dict())
        server.start_reconciler()
        for cls, name, key, first in patches:
            fn, wrapper = timed(cls, name, key, first)
            saved.append((cls, name, fn))
            setattr(cls, name, wrapper)
        native_mod.plan_native = planned
        kube.KubeJobSource.__init__ = source_init
        argv = ["controller", "--kube-url", server.url, "--iterations",
                str(c["iterations"]), "--tick-s", "0", "--max-load-desired",
                str(c["max_load"])]
        if not native:
            argv.append("--no-native-scheduler")
        t0 = time.perf_counter()
        rc, _ = _call_verb(cli.main, argv)
        wall = time.perf_counter() - t0
        close_tick()
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
        native_mod.plan_native = plan_native
        kube.KubeJobSource.__init__ = init
        for src in sources:  # the verb leaves its watch thread running
            src.close()
        quiet.setLevel(level)
        with server.state.lock:
            crds = {n: (o.get("status") or {}).get("phase")
                    for (_, n), o in sorted(server.state.objects[
                        ("edl-tpu.org/v1", "trainingjobs")].items())}
        pods, chips = _kube_census(server, kube.CHIP_RESOURCE_KEY)
        server.close()
    return {"planner": "native" if native else "python", "rc": rc,
            "verb_s": wall, "ticks": ticks, "native_plans": plans["plan"],
            "native_declined": plans["none"], "jobs": len(crds),
            "phases": dict(collections.Counter(crds.values())),
            "statuses": crds, "pods": pods, "chips_requested": chips,
            "chips_total": c["nodes"] * c["chips_per_node"]}


def _kube_check_gate(row):
    if row["rc"] != 0:
        raise AssertionError(f"controller --kube ({row['planner']}) exited "
                             f"{row['rc']}")
    if row["planner"] == "native" and (row["native_plans"] == 0
                                       or row["native_declined"]):
        raise AssertionError(
            f"the native run did not plan natively: plan_native returned "
            f"{row['native_plans']} plans and {row['native_declined']} None")
    missing = [n for n, ph in row["statuses"].items() if not ph]
    if missing or not row["statuses"]:
        raise AssertionError(f"CRDs without a status phase: {missing}")
    if row["chips_requested"] > row["chips_total"]:
        raise AssertionError(f"{row['chips_requested']} chips requested of "
                             f"{row['chips_total']}")


def kube_check_kube(c=KUBE_CHECK):
    """(a) ``controller --kube`` with the Python planner, then the native
    one; a row each, gated."""
    rows = []
    for native in (False, True):
        row = _kube_run(c, native)
        _kube_check_gate(row)
        del row["statuses"]
        rows.append(row)
    return rows


def kube_check_check():
    """(b) ``check`` over the port with its baseline."""
    from edl_tpu_torch import cli

    baseline = os.path.join(os.path.dirname(os.path.abspath(cli.__file__)),
                            "analysis", "baseline.json")
    rc, out = _call_verb(cli.main, ["check", "--baseline", baseline,
                                    "--json"])
    doc = json.loads(out)
    if rc != 0:
        raise AssertionError(f"check exited {rc}: {doc['findings']} "
                             f"{doc['errors']}")
    return {"rc": rc, "rules": doc["rules"], "files": doc["files"],
            "suppressed": doc["suppressed"],
            "baselined": len(doc["baselined"]),
            "duration_s": doc["duration_s"]}


def kube_check_schedcheck(harnesses=()):
    """(c) ``schedcheck`` at every harness's own budget, seed 0 (or only
    ``harnesses``, for a rehearsal)."""
    from edl_tpu_torch import cli

    rc, out = _call_verb(cli.main, ["schedcheck", *harnesses, "--seed", "0",
                                    "--json"])
    doc = json.loads(out)
    verdicts = {v["site"]: v["verdict"] for v in doc["verdicts"]}
    bad = {k: v for k, v in verdicts.items()
           if v not in ("CONFIRMED", "UNWITNESSED")}
    if rc != 0 or (not harnesses and bad):
        raise AssertionError(f"schedcheck exited {rc}; verdicts {bad}; "
                             f"failed {[h['harness'] for h in doc['harnesses'] if not h['ok']]}")
    return {"rc": rc, "elapsed_s": doc["elapsed_s"], "verdicts": verdicts,
            "harnesses": {h["harness"]: {
                "schedules": h["schedules"],
                "distinct_traces": h["distinct_traces"],
                "races": len(h["races"]),
                "failure": (h["failure"] or {}).get("kind"),
                "s": h["elapsed_s"], "ok": h["ok"]}
                for h in doc["harnesses"]}}


def kube_check_phase(card, c=KUBE_CHECK, harnesses=()):
    """The kube_check phase, (a)-(c); one JSON row. ``c`` and
    ``harnesses`` cut it for a CPU rehearsal."""
    marks = [time.perf_counter()]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    kube_rows = kube_check_kube(c)
    kube_s = lap()
    check = kube_check_check()
    check["s"] = lap()
    sched = kube_check_schedcheck(harnesses)
    sched["s"] = lap()
    wall = marks[-1] - marks[0]
    print(json.dumps({
        "phase": "kube_check",
        # host numbers: the phase does no device work
        "kube": kube_rows, "kube_s": kube_s, "check": check,
        "schedcheck": sched, "phase_s": wall, "max_s": KUBE_CHECK_MAX_S,
        "card": card}), flush=True)
    if wall > KUBE_CHECK_MAX_S:
        raise AssertionError(f"kube_check phase took {wall:.1f} s > "
                             f"{KUBE_CHECK_MAX_S}")


# the mesh phase: a pool of 4 processes on the machine's card(s) (gloo on
# a shared cuda:0, NCCL with a card a rank), the flagship at full width
# over three plans, then ElasticTrainer 1 -> 2 -> 1 workers of 2 ranks
# depth cut 16 -> 4 for time: on an H100 80GB HBM3 at 700 W the phase
# took 278.1 s at 16 layers and 154.7-222.7 s at 8 (the 4 ranks'
# gloo-staged collectives 0.94-0.98 of a step), in a script of up to
# 946 s; widths stay the flagship's
MESH = {"world": 4, "batch": 4, "seq": 2048, "steps": 4, "lr": 1e-3,
        "seed": 0, "layers": 4,
        "plans": ({"fsdp": 2, "tp": 2}, {"dp": 2, "tp": 2},
                  {"dp": 2, "fsdp": 2}),
        "elastic": ((1, 2), (2, 2), (1, 2)), "timeout_s": 900}
MESH_LOSS_RTOL = 1e-3  # first loss vs the one-rank step (bf16, flash)
# each leaf's gathered gradient of the first batch, in f32 with the dense
# attention on both sides (mesh_check.grad_cfg: the same math, so only
# the collectives' summation order differs), within 1e-2 relative L2 of
# the one-rank gradient; the f32 loss of that batch within MESH_LOSS_RTOL
MESH_GRAD_REL_L2 = 1e-2
MESH_LAST_RTOL = 1e-2  # the loss after 3 steps (the 4th step's)
# each rank's attention: tp 2 of the flagship's heads at 2 rows (fsdp2 x
# tp2, dp2 x tp2 and the elastic job), and all heads at 1 row (dp2 x fsdp2)
MESH_TP_SHAPE = (2, 2048, 8, 4, True, 128)
MESH_FSDP_SHAPE = (1, 2048, 16, 8, True, 128)


def _mesh_plan_name(sizes):
    return "x".join(f"{a}{n}" for a, n in sizes.items())


def mesh_pool(device="cuda", c=MESH):
    """The pool the mesh, local and long_context phases share."""
    from edl_tpu_torch.utils.platform import ProcessPool

    return ProcessPool(c["world"], device=device, timeout_s=c["timeout_s"])


def mesh_phase(card, device="cuda", cfg_kw=None, c=MESH,
               expect_launches=True, pool=None):
    """The mesh phase (see the module doc) on ``pool`` (a new one of
    ``c["world"]`` ranks by default): returns the flash launches of each
    rank attention shape, summed over the pool's ranks."""
    import contextlib

    import numpy as np
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import mesh_check

    t0 = time.perf_counter()
    cfg_kw = cfg_kw or dict(
        vocab=32768, d_model=2048, n_layers=c["layers"], n_heads=16,
        n_kv_heads=8, d_ff=6144, dtype="bfloat16", use_flash=True,
        remat=True)
    n_layers = cfg_kw["n_layers"]
    rng = np.random.RandomState(c["seed"])
    batches = [llama.synthetic_tokens(rng, c["batch"], c["seq"],
                                      cfg_kw["vocab"])
               for _ in range(c["steps"])]
    own = pool is None
    with (mesh_pool(device, c) if own
          else contextlib.nullcontext(pool)) as pool:
        # the pool's boot, when this phase starts it (None: a shared pool)
        boot_s = time.perf_counter() - t0 if own else None
        backend, why = pool.backend, pool.why
        ta = time.perf_counter()
        a = pool.run(mesh_check.plan_checks, cfg_kw, batches, c["plans"],
                     c["lr"], c["seed"], device)
        a_s = time.perf_counter() - ta
        tb = time.perf_counter()
        b = pool.run(mesh_check.elastic_check, cfg_kw, c["elastic"],
                     c["seq"], c["lr"], c["seed"], device)
        b_s = time.perf_counter() - tb
    gates = {}
    ref = a[0]["one_rank"]["losses"]
    plans = {}
    per_step = {"flash_fwd_lse": 2 * n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers}
    n_steps = len(batches)  # the gradient check runs the dense attention
    for sizes in c["plans"]:
        name = _mesh_plan_name(sizes)
        rk = [r["plans"][name] for r in a]
        got = rk[0]["losses"]
        errs = rk[0]["grad_rel_l2"]
        worst = max(errs, key=errs.get)
        g_loss, g_ref = rk[0]["grad_loss"]
        share = [sum(v["seconds"] for v in r["collectives"].values())
                 / sum(r["step_s"]) for r in rk]
        plans[name] = {
            "losses": got, "one_rank_losses": ref,
            "loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
            "last_loss_rel_err": abs(got[-1] - ref[-1]) / abs(ref[-1]),
            "grad_rel_l2": errs, "grad_worst_leaf": worst,
            "grad_f32_loss": g_loss, "grad_f32_one_rank_loss": g_ref,
            "step_s": rk[0]["step_s"], "grad_step_s": rk[0]["grad_s"],
            "collective_share": share,
            "collectives_rank0": rk[0]["collectives"],
            "staged_bytes": [sum(v["staged_bytes"] for v in
                                 r["collectives"].values()) for r in rk],
            "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in rk],
            "launches": [r["launches"] for r in rk]}
        gates[f"{name} loss"] = plans[name]["loss_rel_err"] <= MESH_LOSS_RTOL
        gates[f"{name} f32 grads"] = errs[worst] <= MESH_GRAD_REL_L2
        gates[f"{name} f32 loss"] = \
            abs(g_loss - g_ref) / abs(g_ref) <= MESH_LOSS_RTOL
        gates[f"{name} loss after 3 steps"] = \
            plans[name]["last_loss_rel_err"] <= MESH_LAST_RTOL
        gates[f"{name} same losses on every rank"] = all(
            r["losses"] == got for r in rk)
        if expect_launches:
            gates[f"{name} launches {per_step} a step"] = all(
                r["launches"][k] == v * n_steps for r in rk
                for k, v in per_step.items())
    e0 = b[0]
    evs = e0["events"]
    gates["elastic events (1, 2), (2, 1) on the device path"] = [
        (e["from_workers"], e["to_workers"], e["fallback"]) for e in evs
    ] == [(1, 2, False), (2, 1, False)]
    gates["elastic state bit-equal across each rescale"] = bool(
        e0["digests"]) and all(x == y for x, y in e0["digests"])
    total = sum(n for _, n in c["elastic"])
    steps = [s for s in e0["state_steps"] if s is not None]
    gates["elastic step never resets"] = (
        steps == sorted(steps) and steps[-1] == total
        and e0["steps"] == total)
    gates["elastic first loss after each rescale"] = len(
        e0["first_losses"]) == 2 and all(
        abs(x - y) / abs(y) <= MESH_LOSS_RTOL for x, y in e0["first_losses"])
    if expect_launches:
        gates["elastic flash launches on every rank"] = all(
            r["launches"][k] > 0 for r in b for k in per_step)
    tp_launch = {k: sum(r["plans"][_mesh_plan_name(s)]["launches"][k]
                        for r in a for s in c["plans"] if "tp" in s)
                 + sum(r["launches"][k] for r in b) for k in per_step}
    fsdp_launch = {k: sum(r["plans"][_mesh_plan_name(s)]["launches"][k]
                          for r in a for s in c["plans"] if "tp" not in s)
                   for k in per_step}
    row = {
        "phase": "mesh", "card": card, "backend": backend, "why": why,
        "device_count": (torch.cuda.device_count()
                         if device != "cpu" else 0),
        "world": c["world"], "layers": n_layers,
        "batch": [c["batch"], c["seq"]], "boot_s": boot_s,
        "plans": plans,
        "one_rank_step_s": a[0]["one_rank"]["step_s"],
        "cut": (f"depth {n_layers} of the flagship's 16 layers for time"
                if n_layers < 16 else None),
        "elastic": {"events": evs, "losses": e0["losses"],
                    "first_losses": e0["first_losses"],
                    "state_steps": e0["state_steps"],
                    "stall_s": [e["stall_s"] for e in evs],
                    "launches": [r["launches"] for r in b],
                    "plan_at_end": e0["plans"]},
        "launches": {"B2 T2048 H8 KV4": tp_launch,
                     "B1 T2048 H16 KV8": fsdp_launch},
        "plans_s": a_s, "elastic_s": b_s, "gates": gates,
        "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not all(gates.values()):
        raise AssertionError(
            f"mesh gates failed: {[k for k, v in gates.items() if not v]}")
    return {MESH_TP_SHAPE: tp_launch, MESH_FSDP_SHAPE: fsdp_launch}


# the local phase: the CTR twin on the pool (see the module doc). Rows:
# 7 steps at 2 workers and 14 at 4 (8192 and 16384 rows a step), then
# about 8 at 3 workers until the one pass of 385024 rows drains
LOCAL = {"vocab": 2 ** 20, "batch": 4096, "steps": 21, "samples": 385024}
# each step's loss vs one process's step from the pool's previous state on
# the same global batch (f32). The whole run's losses against one process
# trained from the init are printed, not gated: Adam turns the summation
# order of the pool's all-reduce into updates of up to lr on entries
# whose gradient cancels to about zero, and that drift grows with the
# steps (after 29 steps at this size: 7.1e-5 on an H100, 8.8e-5 on a CPU)
LOCAL_LOSS_RTOL = 1e-5
# the long_context phase (see the module doc)
LONG = {"layers": 4, "lr": 1e-3, "seed": 0,
        "plans": (
            {"name": "sp4 ring", "sizes": {"sp": 4},
             "cfg": {"sp_impl": "ring"}, "batch": 1, "seq": 8192,
             "grad_seq": 8192, "steps": 3},
            {"name": "sp4 ulysses", "sizes": {"sp": 4},
             "cfg": {"sp_impl": "ulysses"}, "batch": 1, "seq": 8192,
             "grad_seq": 8192, "steps": 3},
            {"name": "pp2 x dp2", "sizes": {"dp": 2, "pp": 2},
             "cfg": {"pp_microbatches": 2}, "batch": 4, "seq": 2048,
             "grad_seq": 2048, "steps": 3}),
        "elastic": ((1, 2), (2, 2), (1, 2)), "elastic_seq": 2048}
LONG_GRAD_REL_L2 = 1e-5  # f32 dense gradients, sharded vs one rank
LONG_LOSS_RTOL = 1e-3  # the first bf16 loss vs the one rank's
LONG_F32_LOSS_RTOL = 1e-5
# each rank's attention: Ulysses' 16/4 heads and 8/4 KV heads at the whole
# sequence; the pp stages' microbatch rows (MESH_FSDP_SHAPE)
LONG_ULYSSES_SHAPE = (1, 8192, 4, 2, True, 128)


def local_phase(card, pool, device="cuda", c=LOCAL):
    """The local phase (see the module doc) on ``pool``'s ranks."""
    from edl_tpu_torch.examples.ctr import train as ctr_train

    t0 = time.perf_counter()
    a = dict(devices=pool.world, device=device, steps=c["steps"],
             batch=c["batch"], vocab=c["vocab"], ckpt_every=0,
             ckpt_dir="", export_dir="", sync_every=1,
             passes=1, kill_one_worker=True, drain=True,
             check_one_rank=True,
             data_dir=tempfile.mkdtemp(prefix="edl_local_shards_"))
    a["prepared"] = ctr_train.prepare(a["data_dir"], c["samples"],
                                      c["vocab"])
    prep_s = time.perf_counter() - t0
    out = pool.run(ctr_train.train, a)
    r0 = out[0]
    third = max(c["steps"] // 3, 1)
    grown = c["steps"] - third
    w = r0["workers"]
    ev = r0["reshards"]
    gates = {
        "phases in order": [p for _, p in r0["phases"]] == [
            "running", "scaling"] + ["running"] * (
                len(r0["phases"]) - 3) + ["succeeded"],
        "workers: 2, then 4, then 3 until the queue drained": (
            w[:third] == [2] * third and w[third:c["steps"]] == [4] * grown
            and len(w) > c["steps"] and set(w[c["steps"]:]) == {3}),
        "reshards 2 -> 4 -> 3 on the device path": [
            (e["from_workers"], e["to_workers"], e["path"]) for e in ev] == [
            (2, 4, "device"), (4, 3, "device")],
        "status stall is the grow's": (
            r0["reshard_count"] == 1
            and r0["last_reshard_stall_s"] == ev[0]["stall_s"]),
        "no restart: the state's step is the steps run":
            r0["state_step"] == r0["steps"] == len(w),
        "every rank's losses and steps equal": all(
            o["losses"] == r0["losses"] and o["steps"] == r0["steps"]
            for o in out[1:]),
        "each step's loss within 1e-5 of one process's step from the "
        "pool's previous state on the same global batch":
            r0["one_step_max_rel"] <= LOCAL_LOSS_RTOL,
        "job SUCCEEDED": r0["final_phase"] == "succeeded",
    }
    row = {"phase": "local", "card": card, "config": c,
           "phases": r0["phases"], "workers": w, "reshards": ev,
           "reshard_count": r0["reshard_count"],
           "last_reshard_stall_s": r0["last_reshard_stall_s"],
           "steps": r0["steps"], "examples": r0["examples"],
           "examples_per_sec": r0["examples_per_sec"],
           "train_seconds": r0["train_seconds"],
           "losses": [r0["losses"][0], r0["losses"][-1]],
           "one_step_max_rel": r0["one_step_max_rel"],
           "one_step_rel": r0["one_step_rel"],
           "one_rank_max_rel": r0["one_rank_max_rel"],
           "one_rank_rel": r0["one_rank_rel"],
           "lines": r0["lines"], "prepare_s": prep_s, "gates": gates,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not all(gates.values()):
        raise AssertionError(
            f"local gates failed: {[k for k, v in gates.items() if not v]}")
    return row


def long_context_phase(card, pool, device="cuda", cfg_kw=None, c=LONG,
                       expect_launches=True):
    """The long_context phase (see the module doc) on ``pool``'s ranks:
    returns the flash launches of each rank attention shape, summed
    over the ranks."""
    from edl_tpu_torch.train import mesh_check

    t0 = time.perf_counter()
    cfg_kw = cfg_kw or dict(
        vocab=32768, d_model=2048, n_layers=c["layers"], n_heads=16,
        n_kv_heads=8, d_ff=6144, dtype="bfloat16", use_flash=True,
        remat=True)
    n_layers = cfg_kw["n_layers"]
    ta = time.perf_counter()
    a = pool.run(mesh_check.long_context_checks, cfg_kw, c["plans"],
                 c["lr"], c["seed"], device)
    a_s = time.perf_counter() - ta
    tb = time.perf_counter()
    b = pool.run(mesh_check.elastic_check,
                 {**cfg_kw, "sp_impl": "ring"}, c["elastic"],
                 c["elastic_seq"], c["lr"], c["seed"], device, {"sp": 2})
    b_s = time.perf_counter() - tb
    gates, plans = {}, {}
    per_step = {"flash_fwd_lse": 2 * n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers}
    launched = {}
    for pc in c["plans"]:
        name = pc["name"]
        rk = [r["plans"][name] for r in a]
        got = rk[0]["losses"]
        errs = rk[0]["grad_rel_l2"]
        worst = max(errs, key=errs.get)
        g_loss, g_ref = rk[0]["grad_loss"]
        one = rk[0]["one_rank_first_loss"]
        share = [sum(v["seconds"] for v in r["collectives"].values())
                 / sum(r["step_s"]) for r in rk]
        plans[name] = {
            "sizes": pc["sizes"], "cfg": pc["cfg"],
            "batch": [pc["batch"], pc["seq"]], "grad_seq": pc["grad_seq"],
            "losses": got, "one_rank_first_loss": one,
            "loss_rel_err": abs(got[0] - one) / abs(one),
            "grad_rel_l2": errs, "grad_worst_leaf": worst,
            "grad_f32_loss": g_loss, "grad_f32_one_rank_loss": g_ref,
            "step_s": rk[0]["step_s"], "grad_pass_s": rk[0]["grad_s"],
            "collective_share": share,
            "collectives_rank0": rk[0]["collectives"],
            "staged_bytes": [sum(v["staged_bytes"] for v in
                                 r["collectives"].values()) for r in rk],
            "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in rk],
            "launches": [r["launches"] for r in rk]}
        gates[f"{name} f32 grads"] = errs[worst] <= LONG_GRAD_REL_L2
        gates[f"{name} f32 loss"] =             abs(g_loss - g_ref) / abs(g_ref) <= LONG_F32_LOSS_RTOL
        gates[f"{name} first loss"] =             plans[name]["loss_rel_err"] <= LONG_LOSS_RTOL
        gates[f"{name} same losses on every rank"] = all(
            r["losses"] == got for r in rk)
        flash = pc["cfg"].get("sp_impl") != "ring"
        if expect_launches and flash:
            gates[f"{name} launches {per_step} a step"] = all(
                r["launches"][k] == v * pc["steps"] for r in rk
                for k, v in per_step.items())
        if expect_launches and not flash:
            gates[f"{name} launches no flash kernel"] = all(
                not any(r["launches"].values()) for r in rk)
        if flash:
            launched[name] = {k: sum(r["launches"][k] for r in rk)
                              for k in per_step}
    e0 = b[0]
    evs = e0["events"]
    gates["elastic events (1, 2), (2, 1) on the device path"] = [
        (e["from_workers"], e["to_workers"], e["fallback"]) for e in evs
    ] == [(1, 2, False), (2, 1, False)]
    gates["elastic state bit-equal across each rescale"] = bool(
        e0["digests"]) and all(x == y for x, y in e0["digests"])
    total = sum(n for _, n in c["elastic"])
    steps = [s for s in e0["state_steps"] if s is not None]
    gates["elastic step never resets"] = (
        steps == sorted(steps) and steps[-1] == total
        and e0["steps"] == total)
    gates["elastic first loss after each rescale"] = len(
        e0["first_losses"]) == 2 and all(
        abs(x - y) / abs(y) <= LONG_LOSS_RTOL
        for x, y in e0["first_losses"])
    row = {
        "phase": "long_context", "card": card, "layers": n_layers,
        "cut": (f"depth {n_layers} of the flagship's 16 layers for time"
                if n_layers < 16 else None),
        "plans": plans,
        "elastic": {"spec": {"sp": 2}, "seq": c["elastic_seq"],
                    "events": evs, "losses": e0["losses"],
                    "first_losses": e0["first_losses"],
                    "state_steps": e0["state_steps"],
                    "stall_s": [e["stall_s"] for e in evs],
                    "plan_at_end": e0["plans"]},
        "launches": launched, "plans_s": a_s, "elastic_s": b_s,
        "gates": gates, "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    if not all(gates.values()):
        raise AssertionError(
            f"long_context gates failed: "
            f"{[k for k, v in gates.items() if not v]}")
    return {LONG_ULYSSES_SHAPE: launched.get("sp4 ulysses", {}),
            MESH_FSDP_SHAPE: launched.get("pp2 x dp2", {})}


def main() -> int:
    # a crash in native code (a kernel's host side, ctypes) prints every
    # thread's Python stack before the process dies
    faulthandler.enable(all_threads=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import flash_attention as fa

    global PEAK_BF16_FLOPS, PEAK_HBM_BYTES
    peak = costmodel.detect_peak("cuda")
    PEAK_BF16_FLOPS, PEAK_HBM_BYTES = peak.flops, peak.hbm_bytes_s
    card = _smi()
    print(f"# card {card}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"# peak {peak.kind}: {PEAK_BF16_FLOPS / 1e12:g} TF/s bf16, "
          f"{PEAK_HBM_BYTES / 1e12:g} TB/s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    profile = "--profile" in sys.argv[1:]
    argv = sys.argv[1:]
    sm_depths = (argv[argv.index("--serving-modes-layers") + 1]
                 if "--serving-modes-layers" in argv else None)

    sources = ["flash_fwd", "flash_bwd"]
    t0 = time.perf_counter()
    bytecode = _warm_bytecode()  # one process beside the nvcc builds
    _build.build_all(sources)  # one nvcc each, all at once
    for entry in ("flash_fwd_bf16", "flash_fwd_lse_bf16", "flash_bwd_dq_bf16",
                  "flash_bwd_dkv_bf16"):
        fa._kernel(entry)
    print(json.dumps({
        "phase": "build", "kernels": list(fa.KERNELS),
        "sources": [f"{n}.cu" for n in sources],
        "build_s": time.perf_counter() - t0,
        # <head dim, causal[, with lse]>: registers a thread, spill bytes,
        # whether ptxas serialized the kernel's wgmma
        "ptxas": {k: v for n in sources
                  for k, v in _build.ptxas_info(n).items()},
    }), flush=True)

    if sm_depths is not None:
        _bytecode_seconds(bytecode)
        return serving_modes_depths(
            card, [int(x) for x in sm_depths.split(",")])
    if "--mesh-only" in argv:
        _bytecode_seconds(bytecode)
        for shape in (MESH_TP_SHAPE, MESH_FSDP_SHAPE):
            train_kernel_row(shape, card)
        print(json.dumps({"phase": "mesh_launches", **{
            str(k): v for k, v in mesh_phase(card).items()}}), flush=True)
        return 0
    if "--long-context-only" in argv:
        _bytecode_seconds(bytecode)
        for shape in (LONG_ULYSSES_SHAPE, MESH_FSDP_SHAPE):
            train_kernel_row(shape, card)
        seconds = {}
        with mesh_pool() as pool:
            t = time.perf_counter()
            local_phase(card, pool)
            seconds["local"] = time.perf_counter() - t
            t = time.perf_counter()
            long_launches = long_context_phase(card, pool)
            seconds["long_context"] = time.perf_counter() - t
        print(json.dumps({"phase": "long_context_launches", **{
            str(k): v for k, v in long_launches.items()}}), flush=True)
        print(json.dumps({"phase": "seconds", **seconds,
                          "total": time.perf_counter() - t0}), flush=True)
        return 0

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernel", kernel_phase, card)
    train_rows = timed("train_kernels", train_kernel_phase, card)
    timed("int8_products", int8_products_phase, card)
    launches, params, cfg, float_tps, slice_metrics = timed(
        "slice", slice_phase, card)
    obs_launches = timed("obs", obs_phase, card, params, cfg, float_tps)
    # serving_modes at the first SM_LAYERS of the slice's 32 layers (the
    # same weights; a cut of depth that keeps the script's time)
    sm_params = {**params, "layers": {k: v[:SM_LAYERS] for k, v in
                                      params["layers"].items()}}
    timed("serving_modes", serving_modes_phase, card, sm_params,
          dataclasses.replace(cfg, n_layers=SM_LAYERS))
    del sm_params
    if profile:
        _profile_serving(card, params, cfg)
    int8_serve = timed("int8_serving", int8_serving_phase, card, params,
                       cfg, float_tps)
    del params
    torch.cuda.empty_cache()
    train_counts = timed("train", train_phase, card, profile)
    remat_lse = timed("remat_policies", remat_policies_phase, card)
    ladder_runs = timed("train_ladder", train_ladder_phase, card)
    # each rung's attention, at the batch that fit, held to its plain
    # versions (TRAIN_SHAPES holds each ladder's first batch)
    ladder_shapes = {key: (b, key[0]) + TRAIN_MAIN[2:]
                     for key, (b, _) in ladder_runs.items()}
    for shape in ladder_shapes.values():
        if shape not in train_rows:
            train_rows[shape] = train_kernel_row(shape, card)
    torch.cuda.empty_cache()
    decode_launches = timed("decode_ladder", decode_ladder_phase, card)
    timed("ctr", ctr_phase, card, profile)
    # the workers and store hosts read the bytecode the warm-up wrote
    print(json.dumps({"phase": "bytecode", "modules": SL_BYTECODE_MODULES,
                      "seconds": _bytecode_seconds(bytecode)}), flush=True)
    timed("elastic", elastic_phase, card)
    warm_launches = timed("p2p", p2p_phase, card)
    predict_launches = timed("small_workloads", small_workloads_phase, card)
    moe_launches = timed("moe", moe_phase, card)
    load_launches, load_shape = timed("serving_load", serving_load_phase,
                                      card)
    # the largest prefill the serving-load rungs ran, held to its plain
    # version
    if load_shape not in rows:
        rows[load_shape] = primal_kernel_row(load_shape, card)
    control_counts = timed("control", control_phase, card, slice_metrics)
    timed("kube_check", kube_check_phase, card)
    # the mesh, local and long_context phases share one pool of 4 ranks
    t = time.perf_counter()
    with mesh_pool() as pool:
        seconds["mesh_pool_boot"] = time.perf_counter() - t
        mesh_launches = timed("mesh", mesh_phase, card, "cuda", None, MESH,
                              True, pool)
        timed("local", local_phase, card, pool)
        long_launches = timed("long_context", long_context_phase, card,
                              pool)
    # the Ulysses ranks' attention, held to its plain versions
    train_rows[LONG_ULYSSES_SHAPE] = train_kernel_row(LONG_ULYSSES_SHAPE,
                                                      card)
    print(json.dumps({"phase": "seconds", **seconds,
                      "total": time.perf_counter() - t0}), flush=True)

    src = "edl_tpu_torch/ops/csrc/"
    ref = "edl_tpu/ops/flash_attention.py:"

    def entry(name, source, replaces, launched, err, ms, plain, bound,
              library, shape):
        return {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": ref + replaces, "launches": launched,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library, "tflops": bound[2] / ms / 1e9,
            "bound_share": bound[0] / ms, "shape": shape,
        }

    def shape_name(b, t, h, kv, causal, d):
        return (f"B{b} T{t} H{h} KV{kv} d{d} "
                f"{'causal' if causal else 'full'} bf16")

    # each training kernel three times: at the flagship's B4 T2048
    # (launches: the train phase's 5 steps and the control phase's
    # queue-fed steps) and at each ladder rung's
    # shape (launches: that rung's run); launches of every training path
    # beside them
    by_path = {"train (adamw, full remat, 5 steps)": train_counts,
               "control (queue-fed, adamw, full remat)": control_counts,
               **{f"train_ladder {kind} T{t}": c
                  for (t, kind), (_, c) in ladder_runs.items()},
               f"moe (adamw, {MOE_STEPS} steps)": moe_launches["train"],
               "moe int8_mxu (1 step)": moe_launches["int8"]}
    remat = {f"remat_policies {p} (1 step)": n for p, n in remat_lse.items()}
    trainers = []
    # B4 T2048 is the train phase's shape and the control phase's
    at_main = {k: train_counts[k] + control_counts[k] for k in train_counts}
    by_path["mesh (4 ranks, 3 plans and the elastic job)"] = {
        k: sum(v[k] for v in mesh_launches.values())
        for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}
    by_path["long_context (4 ranks: sp4 ulysses, pp2 x dp2)"] = {
        k: sum(v.get(k, 0) for v in long_launches.values())
        for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}
    # the pp stages run the dp2 x fsdp2 ranks' shape: one row, both paths
    on_mesh = dict(mesh_launches)
    on_mesh[MESH_FSDP_SHAPE] = {
        k: n + long_launches[MESH_FSDP_SHAPE].get(k, 0)
        for k, n in mesh_launches[MESH_FSDP_SHAPE].items()}
    on_mesh[LONG_ULYSSES_SHAPE] = long_launches[LONG_ULYSSES_SHAPE]
    for shape, launched in ((TRAIN_MAIN, at_main),
                            *((ladder_shapes[key], c)
                              for key, (_, c) in ladder_runs.items()
                              if key[1] == "bf16"),
                            (MOE_TRAIN_SHAPE, moe_launches["train"]),
                            *on_mesh.items()):
        tr = train_rows[shape]
        for name, source, replaces, errs, ms, plain, library in (
                # with_lse=True: the fwd rule _flash_fwd (:363) of the
                # same kernel
                ("flash_fwd_lse", "flash_fwd.cu", "100", ["lse_max_abs_err"],
                 "flash_fwd_lse_ms", "plain_fwd_lse_ms", "library_fwd_ms"),
                # the plain backward and SDPA's backward each compute dq,
                # dk and dv in one call: their times stand beside both
                ("flash_bwd_dq", "flash_bwd.cu", "226", ["dq_max_abs_err"],
                 "flash_bwd_dq_ms", "plain_bwd_ms", "library_bwd_ms"),
                ("flash_bwd_dkv", "flash_bwd.cu", "287",
                 ["dk_max_abs_err", "dv_max_abs_err"], "flash_bwd_dkv_ms",
                 "plain_bwd_ms", "library_bwd_ms")):
            err = max(r[e] for r in list(train_rows.values())
                      + list(rows.values()) for e in errs if e in r)
            e = entry(name, source, replaces, launched[name], err, tr[ms],
                      tr[plain], (tr["bound_ms"][name], tr["bound_by"][name],
                                  tr["flops"][name]),
                      tr[library], shape_name(*shape))
            e["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            if name == "flash_fwd_lse":
                e["launches_by_path"].update(remat)
            trainers.append(e)

    # the primal forward: at the slice's largest prefill (the
    # 1000-token prompt's bucket; launches: the slice's requests), at
    # each decode rung's prefill shape (launches: that rung's bf16 and
    # int8 generates) and at the llama predict's chunk (launches: its
    # 16 layers); launches of every serving path beside them
    primal_paths = {
        "slice (bf16)": launches,
        "obs (bf16, warm replay)": obs_launches,
        **{f"int8_serving {k}": n for k, n in int8_serve.items()},
        **{f"decode_ladder {w} b{b}": n
           for (w, b), n in decode_launches.items()},
        "predict llama (flagship export, 64 x 512)": predict_launches,
        "predict moe (MoEConfig() export, 64 x 512)": moe_launches["predict"],
        **load_launches,
        "p2p warm-started replicas (8B width, 8 layers)": warm_launches}
    # the serving-load rungs' in-process launches (counted by the
    # wrapper) stand beside their largest prefill's shape
    load_counted = sum(n for k, n in load_launches.items()
                       if "rung" in k)
    # the generate verb's prefills (its launches, counted by the
    # wrapper) are the decode ladder's b1 shape, B1 T512 H16 KV8
    gen_counted = sum(n for k, n in load_launches.items()
                      if k.startswith("generate verb"))
    primals = []
    for shape in (SLICE_MAIN, *DECODE_SHAPES, PREDICT_SHAPE,
                  MOE_PREDICT_SHAPE, load_shape, WARM_SHAPE):
        r = rows[shape]
        launched = (warm_launches if shape is WARM_SHAPE else
                    launches if shape == SLICE_MAIN else
                    predict_launches if shape == PREDICT_SHAPE else
                    moe_launches["predict"] if shape == MOE_PREDICT_SHAPE else
                    load_counted if shape == load_shape else
                    sum(n for (_, b), n in decode_launches.items()
                        if b == shape[0])
                    + (gen_counted if shape == DECODE_SHAPES[0] else 0))
        err = (max(rows[k]["max_abs_err"] for k in KERNEL_SHAPES)
               if shape == SLICE_MAIN else r["max_abs_err"])
        e = entry("flash_fwd", "flash_fwd.cu", "100", launched, err,
                  r["kernel_ms"], r["ref_ms"],
                  (r["bound_ms"], r["bound_by"], r["flops"]),
                  r["library_ms"], shape_name(*shape))
        e["launches_by_path"] = primal_paths
        primals.append(e)
    summary = {"kernels": [*primals, *trainers]}
    print(json.dumps(summary), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
