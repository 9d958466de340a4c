#!/usr/bin/env python3
"""Drive the PyTorch port (simlingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one GPU
    python3 chip_smoke.py --kernels     # build + kernel checks only
    python3 chip_smoke.py --kernels flash_attn_bwd   # ... of the named kernels
    python3 chip_smoke.py --int8-sweep  # the int8 forward at forced splits S and the
                                        # GEMV at forced plans
    python3 chip_smoke.py --ce-sweep    # the fused CE backward at forced segments S
    python3 chip_smoke.py --attn-sweep  # the attention forward at forced plans
    python3 chip_smoke.py --norm-sweep  # the norm kernels at forced plans
    python3 chip_smoke.py --disk        # training from disk with checkpoints, the
                                        # leaderboard plugin, the evaluation, the
                                        # microsim and the expert collection only
    python3 chip_smoke.py --mesh        # the multi-GPU training phase only
    python3 chip_smoke.py --lora-fused  # phase 5's ungated run and train_lora_fused
    python3 chip_smoke.py --fp32        # the fp32 builds' phase-2 cases, the small
                                        # fp32 steps, phase 5's ungated run,
                                        # train_fp32 / _ln / _gated / _int8
                                        # beside it, then serve_fp32
    python3 chip_smoke.py --microsim    # the closed-loop microsim phase only
    python3 chip_smoke.py --collect     # the expert-collection phase (10b) only
    python3 chip_smoke.py --base [CELL ...]  # the small SimLingo-Base agreement and
                                        # the base cells' phases only (base,
                                        # base_wide, base_resnet)
    python3 chip_smoke.py --parent DIR  # ... and the CE forward's, the tiled
                                        # attention forward's, the attention
                                        # backward's, the norm forward's and
                                        # the bf16 int8 forward's bits against
                                        # the tree at DIR, with both trees'
                                        # times of those and of the norm
                                        # backward (scripts/fwd_digest.py)

Phases, in order; any failure exits non-zero:
  1. build: compile csrc/*.cu with nvcc (all in parallel), print seconds;
  2. kernels: every hand-written kernel at every shape the serving and the
     training paths give it (SimLingo-Base's too: attention `clip`
     [32,577,16,64] and `base_llm` [16,333,8,64] causal, LayerNorm
     [18464,1024], RMSNorm [5328,512] with dscale; the offline
     evaluation's attention at batch 8 over left-padded prompts as
     eval_language_torch.py collates phase 7's validation route:
     `eval_prefill` q[8,T,14,64], `eval_decode` q[8,1,14,64] and
     `eval_queries` q[8,30,14,64] against T + 130 cache slots, and
     `eval_vit` [16,1025,16,64] on the batch's tiles; and the attention at
     the other head dims, HEAD_DIM_ATTENTION: SimLingo-Base's LLaMA `large`
     [16,333,16,128] causal, the split path and GQA at 128, JAX's tiny()
     at 16 and presets.small_shardable at 32, each through its own
     instance, forward and backward; and a tp = 2 rank's shapes,
     TP_ATTENTION: Qwen2's 7 query heads over 1 kv head and 8 of the ViT's
     16, forward and backward, the int8 base's halved N / K,
     INT8_TP_SHAPES, forward and dx; SimLingo-Base's at tp = 2,
     BASE_TP_ATTENTION: CLIP [32,577,8,64] and the LLaMA [16,333,4,64]
     causal, forward and backward; and the sp = 2 ring's chunks,
     RING_ATTENTION, q[6,399,14,64] kv[6,399,2,64], the causal diagonal
     and the non-causal earlier chunk with its key validity, and in
     `run_ring_checks` both ranks' chunks merged by lse against the whole
     sequence's attention, the backward of rank 1's chunks fed the ring's
     global o / lse, and the ring's summed dq / dk / dv), against its plain
     PyTorch version on the same bf16 inputs (fp32 math) at |err| <= ATOL + RTOL |ref| (the attention
     forward also with its lse, bit-identical across two calls, its path
     -- tiled or split, the splits -- its kernel's ptxas registers and
     sha256 digests of out and lse; the attention
     backward: within the bf16 rounding bound of each gradient element,
     see BF16_U, and so pass by pass -- its dS^T scratch against
     attention_ds_reference, its dq against attention_dq_from_ds_reference
     of that scratch -- bit-identical across two calls, with the device ms
     of its three kernels, their ptxas registers, the dK/dV instantiation
     and the scratch bytes; dropout: bit-equal, keep rate 0.9 +- 0.002, identity at
     p = 0, the one-process layout's digests equal to DROPOUT_DIGESTS, and
     at a rank's blocks (DROPOUT_CASES: dp's rows, tp's columns, sp's
     slabs of 399 of every 798 rows) the one-process mask cut to the
     block, and the unsegmented blocks' digests equal to DROPOUT_DIGESTS; LayerNorm / RMSNorm forward and backward at the ViT, projector
     and LLM-training rows (the LLM's also dx only, its frozen scale), the
     forward at the serving rows (ViT 2 x 1025, projector 2 x 256, LLM 1 /
     16 / 30 / 640), the backward bit-identical across two calls, with the
     device ms of each of its kernels, its plan and its ptxas registers,
     the library's backward as device time beside its eager time; the
     fused CE forward, backward and
     dW backward at the training shape and a ragged one, each against the
     tolerance stated at BF16_SPACING (the backward also pass by pass: its
     dlogits scratch against ce_dlogits_reference, its dh and dW against
     the plain products of its own scratch; bit-identical across two calls;
     with the device ms of its four kernels, their ptxas registers and the
     scratch bytes); the int8 forward at the serving
     and the int8-base training rows (decode and those again with a bf16
     scale; at M = 1 with the GEMV's plan and registers),
     against the bound stated at FWD_U, and its activation gradient
     int8_matmul_dx at every linear and the tied head of that path,
     against the bound stated at DX_SUM_U, both bit-identical across two
     calls, with their grid: tile, reduction segments S and blocks);
     prints max error (absolute and over the output's rms, or over the
     tolerance), kernel / plain / library ms and the bound from bytes or
     operations on this card; and, for the record, the int4 product
     (plain PyTorch, as JAX's is XLA: `run_int4_checks`) at the int8 rows'
     serving shapes, its error against the dequantized product and its ms
     beside the int8 kernel's; and the fp32 builds of precision=fp32
     training (`run_fp32_checks`): the attention forward (with lse) and
     backward at FP32_ATTENTION's cases (the ViT's and the LLM's training
     shapes, the queries' q offset with masks, head dims 128 / 16 / 32)
     against the plain version in fp64 on the same fp32 inputs, within the
     fp32 form of their rounding bounds (`fp32_unit`; err/rms, the fp32
     plain version's and a TF32 plain version's readings beside), the dS^T
     scratch (fp32) and dq from it pass by pass, bit-identical across two
     calls, with the device ms of the three kernels, their registers and
     the scratch bytes; dropout at DROPOUT_CASES, bit-equal, its keep mask
     equal to the bf16 instance's; the norms at the training rows within
     FP32_SUM_U's bound; the fused CE at FP32_CE_CASES (`run_fp32_ce_checks`:
     ce / logz, dh, dW and the fp32 dlogits scratch pass by pass, each
     within its fp32 bound against the fp64 plain version, a width of 100
     zero-padded) and the int8 forward and gradient at the int8 base's
     training rows, K 100 and an odd N (`run_fp32_int8_checks`; `--fp32`
     adds serving's rows); each with kernel / plain / library (fp32) ms and
     the bound at 67 TFLOP/s fp32 or 3.35 TB/s;
  3. small-model agreement: a small D=128 model's drive_only waypoints on
     the GPU (bf16, kernels) against the CPU plain path (fp32), and one
     training step of the same model with LoRA r=4, dropout 0.1 (losses to
     2e-2, grad norm to 5e-2 relative), then that step again with both
     fused-kernel gates on (SIMLINGO_CE_IMPL=pallas, SIMLINGO_LN_IMPL=pallas),
     and again on an int8 base LLM (which must launch int8_matmul_dx);
     the same step at fp32 on the GPU (`fp32_small_agreements`: the fp32
     instances, every launch theirs) against the CPU's, gates off, with
     SIMLINGO_LN_IMPL=pallas, with both gates (the fused CE) and on the
     int8 base, losses and grad norm within FP32_STEP_TOL;
     the same step on the GPU with remat (`small_remat_agreement`:
     SMALL_REMAT_MODES), whose losses must equal the remat-off step's on
     the GPU, launches exact; a small int4 model (`small_int4_cfg`, LLM
     widths 256 / 512) whose drive_only waypoints GPU bf16 must agree with
     CPU fp32; then JAX's SimLingoBaseConfig.tiny() (head dim 16 in both towers) and
     the same with a ResNet-18 encoder (`small_base_cfgs`): their waypoints
     and one two-group training step each, GPU bf16 vs CPU fp32, each
     attention kernel launched once a layer;
  4. full width, serving: the default LingoAgent (CoT, int8 LLM,
     speculative) on SimLingoConfig() with seeded random bf16 weights,
     FRAMES frames on a seeded 1024x512 frame, then one use_cot=False
     frame; launch counts of every kernel are reset just before and read
     just after (and each frame's); then the same frames again with SIMLINGO_LN_IMPL=pallas
     (`gated_serving`: frame ms beside the ungated frames', the norm
     kernels' launches a frame, tokens equal and waypoints within 2 % of
     the ungated frames', a profile of one gated speculative frame); with
     a profile of one speculative frame (device time by
     kernel class and by hand kernel; int8_matmul's calls in that frame
     against its forward kernels' launches, one each), and the plain
     generator profiled at 1 and GEN_PROFILE_TOKENS new tokens (device
     busy, gemv_kernel's ms and launches a decoded token); then
     `serve_int4`: the default AgentConfig with int4_llm=True on the same
     weights and CoT frames (frame ms, tokens and decode ms/token beside
     int8's, the LLM's weight bytes, flash_attn_fwd a frame exactly as
     reckoned and no int8 launch);
  5. full width, training: train_torch's trainer on
     presets.internvl2_1b(lora=True) with remat off, as `bench.py` runs it
     (seed 0), and synthetic_example(batch 6,
     seq_len 768, 2 tiles): 1 warm-up step, then TRAIN_STEPS timed steps
     with the launch counts reset after the warm-up; peak memory, and a
     profile of one more step (device time by kernel class); then the
     same at precision=fp32 (`fp32_training`): `train_fp32` (gates off) and
     `train_fp32_gated` (both gates: the norms 49 + 49 a step and the fused
     CE 1 + 1, `fp32_per_step`), every attention, dropout, norm and CE
     launch an fp32 instance's and held exactly, step 1's loss within 2e-2
     of the bf16 run's and the gated run's losses within FP32_STEP_TOL of
     the ungated fp32 run's (`compare_fp32`; `--fp32` adds `train_fp32_ln`,
     `train_fp32_int8` on the int8 base, its int8 launches held to
     INT8_PER_STEP, and `serve_fp32`); then the
     same run with both gates set in the process environment (restored
     afterwards), which must launch the six norm and CE kernels (their
     counts are logged against GATED_PER_STEP), and the two runs side by
     side (losses to 2e-2 relative); then the ungated run again with the
     base LLM quantized to int8 (`bench.py` BENCH_INT8_BASE=1), which must
     launch int8_matmul and int8_matmul_dx (counts logged against
     INT8_PER_STEP), its losses beside the bf16 base's (information only);
     every run's attention and dropout launches held exactly to
     `train_launches_per_step`; then `bench.py`'s remat modes (REMAT_MODES:
     vision, llm, mlp, and both, JAX's default) ungated, each beside the
     remat-off run (`compare_remat`: ms/step, peak memory, losses within
     2e-2 and whether bit-identical, a profiled step each); then
     `train_lora_fused`, the ungated run with SIMLINGO_LORA_FUSED=1 (the
     q / k / v and gate / up adapters as groups, one dropout launch a
     group: 24 x 4 x 3 = 288 dropout launches a step against 504, held
     exactly), beside the ungated run (ms/step, busy, peak memory by
     `log_side_by_side`), and its dropout-off pair (`lora_fused_pair`: the
     loss and grad norm on the run's state with the groups fused and
     unfused, within PAIR_TOL);
  5b. multi-GPU training (`mesh_training`): multihost.initialize at world
     1 over NCCL with one all-reduce; the one-process runs at global batch
     6: the trainer, ungated and gated, and two controls, each the
     one-process step with a run's reductions: `halves` (the batch as two
     accumulated halves of 3 rows, as dp and fsdp split it) and `tp` (the
     gated step with every tp-split product cut in two as tp = 2 cuts it:
     row-parallel linears as two bf16 partial products summed in bf16);
     then 2 ranks (`--mesh-rank`, one a GPU over NCCL where there are two,
     else both on this GPU over gloo, named explicitly, with every
     collective staged through host memory, which they print) run
     MESH_RUNS in turn, MESH_STEPS steps each, dropout on: `mesh_dp2` and
     `mesh_fsdp2` (batch 3 a rank) held to `halves`, `mesh_tp2` (batch 6,
     both gates) to `tp`, `mesh_sp2` (the 798 positions as two slabs of
     399, attention the ring) to `seq_halves` (the two sequence halves in
     one process, `seq_halves_losses`: the ring's chunk kernels merged by
     lse, each gradient the halves' sum), `mesh_pp2` (two GPipe stages of
     12 layers, 2 microbatches of 3 rows, stage remat on) to `halves`,
     and in the same spawn `base_tp2` (SimLingo-Base's `base` cell, global
     batch 16, CLIP and the LLaMA split over tp = 2, ungated) to its own
     `tp` control (`base_tp_control`: the one-process base trainer with
     every split product cut as tp = 2 cuts it) and the one-process
     `train_base` (`base_mesh_reference`): step 1's loss and grad norm
     (the base model's: both group norms) and the trained leaves after
     the last step within MESH_MULT x the control's own difference from the
     one-process run, measured in the same call; each rank's launches
     exactly as `mesh_launches_per_step` reckons them from the schedule
     (`base_tp2`: attention 35 forward and 35 backward a step, at CLIP
     q[32,577,8,64] and the LLaMA q[16,333,4,64]); with
     ms/step, peak memory, collective and send / receive bytes and ms a
     step by group (staged: host ms; NCCL: its kernels' device ms,
     torch.profiler) and launches per rank; then the ring-off run
     (`mesh_sp2` on 767 + 30 positions, which do not divide) must raise
     the trainer's RuntimeError on both ranks; a rank's failure or
     MESH_TIMEOUT fails the script;
  6. SimLingo-Base at full width, three cells (BASE_CELLS, overrides of
     configs/simlingo_base.yaml, seed 0): `base` (CLIP ViT-L/14-336 with
     LLaVA-NeXT features, the tiny LLaMA), `base_wide` (the same with the
     LLaMA `large`, 22 x 2048 at 16 heads of 128) and `base_resnet` (the
     ResNet-18 encoder, the tiny LLaMA). Each: one counted forward at batch
     16 (flash_attn_fwd 35 / 45 / 12 launches, `base_launches`, and by head
     dim), BASE_FWD_ITERS timed forwards at batch 1 and at batch 16 and one
     profiled; then train_base_torch's trainer at batch 16: 1 warm-up step
     and TRAIN_STEPS timed steps, launches counted over them exactly, peak
     memory, a profiled step (with the ResNet, one more step whose running
     statistics must move exactly as AdamW moves them from their own
     gradients, `bn_state_follows_adamw`); for `base` and `base_wide` the
     same with SIMLINGO_LN_IMPL=pallas (LayerNorm 47, RMSNorm 25 / 45 a
     step, forward and backward), the losses side by side within 2e-2;
  7. training from a dataset on disk (`disk_training`): the host probe
     (Python modules, g++, libjpeg's and nvJPEG's headers, free space) and
     the JPEG decoder in use; two training routes of 40 frames and a
     validation route of 30 written under build/ (measurements, results,
     commentary, VQA, dreamer, frames copied from tests/data/torch_frames);
     trainer.train on configs/simlingo.yaml (JAX's default model,
     SimLingoConfig(): remat on, no LoRA) at full width (batch 6, 768
     tokens, the 16 driving buckets and the dreamer mix, 8 prefetch
     threads) for 1 + 5 steps with an async checkpoint at step 3,
     validation and a final checkpoint: ms a step (median of steps 2-5),
     host batch ms, prefetch wait ms, peak memory, the hand kernels'
     launches a step over steps 2-5 against the count reckoned from the
     model (train_launches_per_step), exactly; a run resumed from step 3
     whose losses, validation loss and final parameters must equal the
     straight run's bit for bit, with one of its steps profiled (device
     busy and idle); the checkpoint's bytes, blocking and async save and
     restore times; a random trained-SimLingo torch checkpoint
     (InternVL2-1B remote-code names, peft LoRA on q/v) loaded through
     hf_checkpoint= into presets.internvl2_1b(lora=True) (a qkv slice and
     a merged LoRA leaf checked against the written tensors) and trained 2
     steps to a final checkpoint;
  8. the CARLA leaderboard plugin (`carla_plugin`, in phase 7's workspace):
     agent/carla_agent.py under the test doubles of tests/carla_stubs.py,
     setup() on phase 7's trained-SimLingo checkpoint (the default
     AgentConfig), PLUGIN_TICKS ticks on phase 4's frame along a straight
     plan (the first plain CoT, then speculative): tick ms, each tick's
     launches (flash_attn_fwd and int8_matmul exactly as reckoned from its
     work, no other kernel; phase 4's frame beside), the metric file
     (SIMLINGO_METRIC_INFO: a line a tick, equal to the agent's outputs),
     the scenario record's length and destroy()'s latency stats;
  9. the offline evaluation (`eval_language`): eval_language_torch.py's
     main on phase 7's validation route and the final checkpoint of its
     2-step run from the .pt, QA, commentary and Dreaming at batch 8, 100 new tokens,
     bf16: samples/s, each batch's ms, one-token ms and decode ms/token,
     flash_attn_fwd launches a batch exactly as reckoned from its work, the
     first QA batch's prompt validity equal to phase 2's eval cases', the
     JSONs written, the metrics;
 10. closed-loop evaluation in the microsim (`microsim`, in phase 7's
     workspace, on its trained-SimLingo .pt): sim/suite.load_model_agent
     (presets.internvl2_1b(), the default AgentConfig, bf16) driving
     MICROSIM_ROUTE through sim/runner.run_route for MICROSIM_TICKS ticks
     with the replay recorder on: each tick's ms split into camera, agent
     (synchronised) and world (tick, scripted scenarios, criteria), p50 /
     max beside phase 8's ticks, each tick's launches exactly as reckoned
     from its work, one speculative tick profiled (launches by hand
     kernel), the record through driving_score.merge_route_results and
     b2d_benchmarks.ability_benchmark; then one job that
     start_eval_torch.py --microsim builds (MICROSIM_JOB) run by the
     babysitter and merged by start_eval_torch.summarize (merge_route_dir,
     merged.json), failing on a failed or retried job;
 10b. expert data collection (`collect`, in phase 7's workspace, on its
     .pt): the port's sim/runner.ExpertDriver collects COLLECT_ROUTES (a
     parked obstacle; an NPC ahead in the ego's lane) with the default
     1024x512 camera, data_save_freq 5, seed 0, into the trainer's Town*
     layout: each route's ticks, saved frames, status (Completed or
     Perfect) and tick ms p50 / max split into expert, camera and write,
     both routes through data/index's quality gate; the port's label
     generators over them (collect_dataset_torch.run_label_generation:
     per route the ms of commentary, VQA and dreamer and the files each
     wrote, the buckets' classes; failing where a route has no VQA or no
     commentary file, or no buckets file: `collect_label`); trainer.train
     on them (configs/simlingo.yaml as it stands, JAX's default model,
     batch 6; commentary, QA, the dreamer mix and the 16 buckets on, the
     generated buckets as bucket_path; a 1024-token window for the
     byte-level tokenizer's prompts) for COLLECT_STEPS steps: the
     buckets, datasets and answer tokens of each step's batch, the
     language and waypoint losses, ms a step, peak memory, finite losses,
     attention launches a step exactly as train_launches_per_step reckons
     them, the trainer's final checkpoint and the trained model written
     as a trained-SimLingo .pt (`collect_train`); that .pt through
     sim/suite.load_model_agent (the trained model's configuration, the
     default AgentConfig, bf16) in closed loop on LOOP_ROUTE for LOOP_TICKS ticks: each tick's ms split into
     camera, agent and world, launches exactly as serve_launches reckons
     them, the record's scores finite (`collect_loop`); then
     agent/replay.replay_route of the first route through
     sim/suite.load_model_agent (the default AgentConfig, bf16) for
     REPLAY_FRAMES frames: each frame's ms and launches exactly as
     serve_launches reckons them, beside phase 8's ticks, and the agent's
     controls beside the expert's (`collect_replay`);
 11. the {"kernels": [...]} line (eleven kernels, launches per path: serve,
     serve_gated, serve_int4, train, train_fp32, train_fp32_gated,
     train_gated, train_int8,
     train_remat_<mode>, train_lora_fused, mesh_dp2 / mesh_fsdp2 /
     mesh_tp2 / mesh_sp2 / mesh_pp2 / base_tp2 (both ranks'),
     the base cells' <cell>_fwd,
     <cell>_train and <cell>_train_gated, train_disk, carla_plugin,
     eval_language, microsim, collect_train, collect_loop, collect_replay; the attention
     kernels also each built head dim's
     instance at a phase-2 case and the base paths' launches by head dim;
     the kernels with an fp32 build also their fp32 instance under "fp32":
     its representative case, FP32_LINE_CASES, and its launches on
     FP32_PATHS: the fp32 cells run and phase 3's small fp32 steps),
     the nvidia-smi line, and the last line {"ok": true, "device": {...}}.
Per-case results also go to chiprun_out/chip_smoke_cases.json, the paths'
statistics to chip_smoke_agent.json (serve_int4's under "int4"),
chip_smoke_train.json, chip_smoke_train_fp32.json, chip_smoke_train_fp32_gated.json,
chip_smoke_train_gated.json,
chip_smoke_train_int8.json, chip_smoke_train_remat_<mode>.json,
chip_smoke_train_lora_fused.json, chip_smoke_mesh_training.json (the ranks'
logs chip_smoke_mesh_rank*.log),
chip_smoke_<cell>_{fwd,train,train_gated}.json, chip_smoke_train_disk.json,
chip_smoke_carla_plugin.json, chip_smoke_eval_language.json,
chip_smoke_microsim.json and chip_smoke_collect.json. `--disk` runs the
build and phases 7-10b alone,
`--base` the build, the small SimLingo-Base agreement and phase 6, `--fp32`
the build, phase 2's fp32 cases (to chip_smoke_cases_fp32.json), the
small fp32 steps, phase 5's ungated run, the four fp32 training cells and
`serve_fp32` (each to chip_smoke_<cell>.json), `--mesh`
the build and phase 5b, `--lora-fused` the build, phase 5's ungated run
and `train_lora_fused`, `--microsim` the build and phase 10 on a random
trained-SimLingo checkpoint written as phase 7 writes it, `--collect` the
build and phase 10b on such a checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
# bf16 attention vs the fp32 plain version: |err| <= atol + RTOL |ref|
# (outputs of rms ~0.05 for rows that see hundreds of keys).
ATOL = {"flash_attn_fwd": 2e-3}
RTOL = 2e-2
# The backward rounds P and dS to bf16 (unit roundoff 2^-8) before its
# products, and its output to bf16: each gradient element is held to
# |err| <= 2^-8 (sum |terms| + |ref|) + 1e-5 rms(ref), the rounding bound
# (`attention_bwd_bound`: dS's terms are P (|dO| |V| + |delta|), as in the
# dS pass's own bound, and not |dS|, which omits the fp32 error of the
# nearly cancelling dP - delta).
# An rms-scaled atol does not fit: in early causal rows a few large terms
# cancel to a small gradient, and their rounding shows against it.
BF16_U = 2.0 ** -8
# The norm kernels and their plain versions round the same fp32 math to
# bf16, summed in another order: y and dx are held to one bf16 spacing,
# |err| <= 2^-7 |ref| + 1e-5 rms(ref); dscale / dbias (sums over all rows)
# to 2^-7 |ref| + 1e-5 sum_rows |term|. The fused CE's ce (fp32) to
# 2e-3 + 1e-5 |ref|: two logits' worth of fp32 accumulation error over
# H = 896 products (896 * 2^-23 * sum |h w| ~ 1e-3); its dh and dW to
# 2^-7 (sum |terms| + |ref|) + 1e-6 rms(ref): kernel and plain version
# round dlogits to bf16 at the same point, so a flip costs one spacing.
BF16_SPACING = 2.0 ** -7
CE_ATOL = 2e-3
# The int8 activation gradient: kernel and plain version round g * scale
# to bf16 identically (the same fp32 product, round to nearest even), sum
# in fp32 in another order, and round dx once: |err| <= 2^-7 |ref| (one
# spacing) + DX_SUM_U sqrt(N) sum|terms| (the order: a random walk of N
# fp32 roundings of 2^-24, with a margin of 16) + 1e-6 rms(ref). A looser
# 2^-7 sum|terms| would pass a kernel that dropped the output at N = 151674.
DX_SUM_U = 2.0 ** -20
# The int8 forward against its plain version in fp32 (unrounded): the
# kernel rounds its fp32 sum times the scale once to bf16 (unit roundoff
# 2^-8) and sums in another order, reduction segments included: |err| <=
# 2^-8 |ref| + DX_SUM_U sqrt(K) sum|terms| + 1e-6 rms(ref). PR 7's atol /
# rtol 2e-2 would pass a dropped segment of K = 4864.
FWD_U = 2.0 ** -8
PEAK_FP32 = 67e12           # non-tensor fp32 FLOP/s (norm arithmetic)
FRAMES = 4                  # CoT frames: the first plain, then speculative
TRAIN_STEPS = 3             # timed full-width training steps (after 1 warm-up)
L2_BYTES = 64 << 20         # rotate operand sets past the 50 MB L2


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops, peak=PEAK_BF16):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def warm_up(torch, dev, seconds=0.5):
    """Keep the card busy for `seconds` (bf16 products), so that the first
    timings of a process do not meet its clocks still rising from idle."""
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def time_ms(torch, fn, sets, iters=20):
    """Device ms per call: `iters` calls, cycling through operand sets (so
    repeated calls do not find their operands in L2), captured in one CUDA
    graph and replayed -- host launch overhead is excluded."""
    for args in sets[:2]:
        fn(*args)                                  # warm up (and build)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(torch, fn, sets, iters=20):
    """ms per call launched eagerly from Python (includes host overhead;
    the only way to time a call that cannot be captured in a graph)."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(torch, fn, sets, iters):
    """[(kernel name, device ms, launches)] of `iters` eager calls of fn
    cycling through the operand sets (torch.profiler; kernels only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    events = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        events.append((e.key, dev_us / 1e3, e.count))
    return events


def kernel_split_ms(torch, fn, sets, names, iters=10):
    """Device ms a launch of each named kernel of one wrapper, from
    torch.profiler over `iters` eager calls cycling through the operand
    sets (a kernel's device time does not depend on how it was launched)."""
    total = {name: [0.0, 0] for name in names}
    for key, ms, count in _device_events(torch, fn, sets, iters):
        for name in names:
            if re.search(rf"(^|[:\s]){name}\b", key):
                total[name][0] += ms
                total[name][1] += count
    # per launch (one a call): the tracer may drop events of some calls
    return {name: ms / max(n, 1) for name, (ms, n) in total.items()}


def device_sum_ms(torch, fn, sets, iters=10):
    """Device ms a call summed over every kernel that one call launches:
    the library's device time, launch gaps and host excluded."""
    return sum(ms for _, ms, _ in _device_events(torch, fn, sets, iters)) / iters


def ptxas_usage(stem):
    """{kernel: (registers, spill store bytes)} of csrc/<stem>.cu from the
    `nvcc -Xptxas -v` log that phase 1 wrote beside the library, a template's
    arguments spelled out (e.g. flash_fwd_kernel<128,0>)."""
    from simlingo_tpu_torch.kernels import _build
    path = _build.BUILD_ROOT / _build._digest() / f"{stem}.build.log"
    usage, name, spill = {}, None, 0
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = name
            for k in HAND_KERNELS:                   # the mangled name, template args
                t = re.search(rf"{len(k)}{k}(?:I(\w*?)EEv)?", name)
                if t:
                    short = k + (f"<{','.join(_template_args(t.group(1)))}>"
                                 if t.group(1) else "")
                    break
            usage[short] = (int(m.group(1)), spill)
            name = None
    return usage


def sha12(torch, x):
    """The first 12 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:12]


def n_sets(nbytes):
    return max(1, min(64, math.ceil(L2_BYTES / max(nbytes, 1))))


def max_violation(kernel, out, ref):
    """(max |out - ref|, that over rms(ref), whether |out - ref| <=
    ATOL[kernel] + RTOL |ref| holds everywhere)."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    ok = bool((diff <= ATOL[kernel] + RTOL * ref.abs()).all())
    rms = float(ref.square().mean().sqrt())
    return float(diff.max()), float(diff.max()) / max(rms, 1e-30), ok


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_cases():
    """(name, B, T, S, HQ, HK, causal, q_offset, valid ranges or None, strided)."""
    pad = 40
    return [
        ("vit", 2, 1025, 1025, 16, 16, False, None, None, True),
        ("llm_prefill", 1, 640, 770, 14, 2, True, 0, [(pad, 640)], False),
        ("llm_decode", 1, 1, 770, 14, 2, True, 700, [(pad, 701)], False),
        ("llm_verify", 1, 16, 770, 14, 2, True, 690, [(pad, 706)], False),
        ("llm_queries", 1, 30, 770, 14, 2, True, 740,
         [(pad, 700), (740, 770)], False),
        ("drive_only", 1, 670, 670, 14, 2, True, None, [(pad, 670)], False),
    ]


# SimLingo-Base at batch 16 (training; group 1, no key mask): the CLIP
# tower's 2 tiles a sample, 577 tokens (24 x 24 patches + CLS), and the
# tiny LLaMA's 300 + 1 + 2 + 30 = 333 tokens, causal
BASE_ATTENTION = [("clip", 32, 577, 577, 16, 16, False, None, None, False),
                  ("base_llm", 16, 333, 333, 8, 8, True, None, None, False)]

# The attention cases at head dims other than 64 (every other case has 64),
# appended after the others so that those keep their inputs: the LLaMA
# `large` of `base_wide` (16 heads of 128) at batch 16; at D = 128 also the
# split path (16 query rows against the 333 keys: one block a head with
# 3 splits, and GQA 16 / 2 packed into 2 row blocks with 6 splits) and the
# tiled path with GQA 16 / 2; JAX's SimLingoBaseConfig.tiny() at batch 2
# (CLIP tiny: 4 tiles of 17 tokens, 4 heads of 16; the `debug` LLaMA: 43
# tokens, 2 heads of 16); presets.small_shardable's ViT (4 tiles of 17
# tokens, 4 heads of 32, read from its qkv projection) and LLM (8 / 2 heads
# of 32, 128 tokens, the first 8 keys masked).
HEAD_DIM_ATTENTION = [
    ("base_large", 16, 333, 333, 16, 16, True, None, None, False, 128),
    ("d128_split", 2, 16, 333, 16, 16, True, 317, [(10, 333)], False, 128),
    ("d128_gqa_split", 2, 16, 333, 16, 2, True, 317, [(10, 333)], False, 128),
    ("d128_gqa", 2, 333, 333, 16, 2, True, None, None, False, 128),
    ("tiny_clip", 4, 17, 17, 4, 4, False, None, None, False, 16),
    ("tiny_llm", 2, 43, 43, 2, 2, True, None, None, False, 16)]


def head_dim_attention():
    """HEAD_DIM_ATTENTION, then presets.small_shardable's two cases, their
    shapes read from the preset: the ViT's 4 tiles of (S / P)^2 + 1
    tokens, and the LLM at 128 tokens, the first 8 keys masked."""
    from simlingo_tpu_torch.core.presets import small_shardable
    m = small_shardable()
    v, l = m.vit, m.llm
    n = (v.image_size // v.patch_size) ** 2 + 1
    return HEAD_DIM_ATTENTION + [
        ("shardable_vit", 4, n, n, v.num_heads, v.num_heads, False, None, None, True,
         v.hidden_size // v.num_heads),
        ("shardable_llm", 2, 128, 128, l.num_heads, l.num_kv_heads, True, None, [(8, 128)],
         False, l.head_dim)]

# tp = 2 (`mesh_tp2`): a rank's half of the heads, Qwen2's 7 query heads over
# its 1 kv head (the GQA group of 7 kept) and 8 of the ViT's 16; last in
# every list, so every other case keeps its inputs
TP_ATTENTION = [("llm_train_tp2", 6, 798, 798, 7, 1, True, None, "train", False),
                ("vit_train_tp2", 12, 1025, 1025, 8, 8, False, None, None, True)]

# sp = 2 (`mesh_sp2`): the ring's chunks of the training sequence, q[6,399]
# against one rank's keys: the causal diagonal, and the non-causal earlier
# chunk (rank 1's queries against rank 0's keys), each with the chunk's key
# validity (the first 399 slots of the training batch); last in the list
RING_ATTENTION = [("ring_diag", 6, 399, 399, 14, 2, True, None, ("slab", 0), False),
                  ("ring_prev", 6, 399, 399, 14, 2, False, None, ("slab", 0), False)]
RING_SLAB = 399

# SimLingo-Base at tp = 2 (`base_tp2`): a rank's half of the heads, CLIP's 8
# of 16 and the tiny LLaMA's 4 of 8; last in every list, so every other
# case keeps its inputs
BASE_TP_ATTENTION = [("clip_tp2", 32, 577, 577, 8, 8, False, None, None, False),
                     ("base_llm_tp2", 16, 333, 333, 4, 4, True, None, None, False)]


def head_dim(case):
    """The head dim of a phase-2 attention case (64 unless listed in
    `head_dim_attention`)."""
    return {c[0]: c[10] for c in head_dim_attention()}.get(case[0], 64)


# the offline evaluation (phase 9): greedy batches of 8, 100 new tokens,
# then the 30 driving queries, through Qwen2-0.5B's cache
EVAL_BATCH = 8
EVAL_NEW_TOKENS = 100
EVAL_QUERIES = 30
EVAL_MODES = ("QA", "commentary", "Dreaming")


# the prompt key validity of the evaluation's first QA batch on phase 7's
# validation route (DISK_ROUTES[2]), as `eval_language_torch.py` collates
# it: EVAL_BATCH prompts left-padded to EVAL_PROMPT_LEN slots, with these
# valid tokens a row. Phase 9 holds its first QA batch to it;
# tests/test_torch_cuda.py reads it.
EVAL_PROMPT_LEN = 768
EVAL_PROMPT_TOKENS = (655, 617, 612, 612, 605, 617, 605, 605)


def eval_prompt_valid(np):
    """[EVAL_BATCH, EVAL_PROMPT_LEN] numpy bool: each row's last
    EVAL_PROMPT_TOKENS slots valid."""
    valid = np.zeros((EVAL_BATCH, EVAL_PROMPT_LEN), dtype=bool)
    for b, n in enumerate(EVAL_PROMPT_TOKENS):
        valid[b, EVAL_PROMPT_LEN - n:] = True
    return valid


def eval_attention_cases(prompt_valid):
    """Phase 2's cases at the evaluation's shapes: the prefill of the
    left-padded prompts, the last decode step and the queries, against the
    cache of T_prompt + EVAL_NEW_TOKENS + EVAL_QUERIES slots ("eval", n: the
    prompt's validity and the first n slots after it); and the ViT on the
    batch's 2 tiles a sample."""
    B, T = prompt_valid.shape
    S = T + EVAL_NEW_TOKENS + EVAL_QUERIES
    return [("eval_prefill", B, T, S, 14, 2, True, 0, ("eval", 0), False),
            ("eval_decode", B, 1, S, 14, 2, True, T + EVAL_NEW_TOKENS - 1,
             ("eval", EVAL_NEW_TOKENS), False),
            ("eval_queries", B, EVAL_QUERIES, S, 14, 2, True, T + EVAL_NEW_TOKENS,
             ("eval", EVAL_NEW_TOKENS + EVAL_QUERIES), False),
            ("eval_vit", 2 * B, 1025, 1025, 16, 16, False, None, None, True)]


def train_llm_valid(torch, dev):
    """kv_valid of the full-width training batch: [text | 30 queries] of
    synthetic_example(batch 6, seq_len 768, 2 tiles, seed 0)."""
    from simlingo_tpu_torch.core import presets
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    ex = synthetic_example(presets.internvl2_1b(), batch=6, seq_len=768,
                           num_patches=2, seed=0, device=dev)
    valid = ex.driving_input.prompt.valid
    return torch.cat([valid, torch.ones(6, 30, dtype=torch.bool, device=dev)], 1)


def visible_pairs(torch, dev, B, T, S, causal, q_off, valid):
    """(row, key) pairs the data makes visible, summed over the batch, and
    the number of rows that see no key."""
    off = S - T if q_off is None else q_off
    mask = torch.ones(T, S, dtype=torch.bool, device=dev)
    if causal:
        mask &= (torch.arange(S, device=dev)[None, :]
                 <= torch.arange(T, device=dev)[:, None] + off)
    mask = mask[None] & valid[:, None, :] if valid is not None else mask[None].expand(B, T, S)
    return int(mask.sum()), int((~mask.any(-1)).sum()), mask


def phase2_attention_cases():
    """Every phase-2 attention case, in the order `attention_inputs` draws
    their inputs: `attention_cases`, the two training shapes, SimLingo-Base's,
    the evaluation's, the other head dims', tp = 2's, the ring's, the base's
    at tp = 2."""
    import numpy as np
    return attention_cases() + [
        ("llm_train", 6, 798, 798, 14, 2, True, None, "train", False),
        ("vit_train", 12, 1025, 1025, 16, 16, False, None, None, True)] + BASE_ATTENTION \
        + eval_attention_cases(eval_prompt_valid(np)) \
        + [c[:10] for c in head_dim_attention()] \
        + TP_ATTENTION + RING_ATTENTION + BASE_TP_ATTENTION


def attention_inputs(torch, dev):
    """For each phase-2 attention case (`phase2_attention_cases`): the
    case, its first inputs (q, k, v, kv_valid) and the timing sets, all
    drawn from one generator seeded 0. kv_valid is bool, so a timed call
    includes the wrapper's conversion to uint8, so times compare with
    earlier trees'. `scripts/fwd_digest.py` takes its inputs from here."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt_valid = torch.from_numpy(eval_prompt_valid(np)).to(dev)
    train_valid = train_llm_valid(torch, dev)
    for case in phase2_attention_cases():
        B, T, S, HQ, HK, _, _, ranges, strided = case[1:]
        D = head_dim(case)

        def make():
            if strided:      # ViT: heads are views of one [B, T, 3*H*D] projection
                qkv = torch.randn(B, T, 3 * HQ * D, generator=gen, device=dev,
                                  dtype=torch.bfloat16)
                q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D)
                           for i in range(3))
            else:
                q = torch.randn(B, T, HQ, D, generator=gen, device=dev,
                                dtype=torch.bfloat16)
                k = torch.randn(B, S, HK, D, generator=gen, device=dev,
                                dtype=torch.bfloat16)
                v = torch.randn(B, S, HK, D, generator=gen, device=dev,
                                dtype=torch.bfloat16)
            valid = None
            if ranges == "train":
                valid = train_valid
            elif isinstance(ranges, tuple) and ranges[0] == "slab":     # a ring chunk's keys
                valid = train_valid[:, ranges[1] * S:(ranges[1] + 1) * S].contiguous()
            elif isinstance(ranges, tuple):          # ("eval", generated slots valid)
                T_prompt = prompt_valid.shape[1]
                valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
                valid[:, :T_prompt] = prompt_valid
                valid[:, T_prompt:T_prompt + ranges[1]] = True
            elif ranges is not None:
                valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
                for lo, hi in ranges:
                    valid[:, lo:hi] = True
            return q, k, v, valid

        first = make()
        yield case, first, [make() for _ in range(n_sets(attention_bytes(case)))]


def attention_bytes(case):
    """Bytes a call must move: q, out, k, v (bf16) and kv_valid."""
    _, B, T, S, HQ, HK, _, _, ranges, _ = case
    D = head_dim(case)
    return 2 * (B * T * HQ * D * 2 + 2 * B * S * HK * D) + (B * S if ranges else 0)


def attention_call(FA, case):
    """The timed call of a phase-2 attention case."""
    causal, q_off = case[6], case[7]
    return lambda q_, k_, v_, m_: FA.flash_attn_fwd(q_, k_, v_, m_, causal, None, q_off)


def run_attention_checks(torch, dev, results):
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import _build
    regs_all = ptxas_usage("flash_attn_fwd")
    for case, (q, k, v, valid), sets in attention_inputs(torch, dev):
        name, B, T, S, HQ, HK, causal, q_off, _, _ = case
        D = head_dim(case)
        out, lse = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off,
                                     return_lse=True)
        again = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        off = S - T if q_off is None else q_off
        plan = FA._fwd_plan(B, T, S, HQ, HK, causal, off, sms=_build.sm_count(dev.index or 0),
                            D=D)
        kname = ("flash_fwd_split_kernel" if plan.path == "split" else "flash_fwd_kernel") \
            + f"<{plan.head_dim},{int(plan.remainder)}>"
        regs = regs_all.get(kname, (0, 0))
        ref = FA.attention_reference(q.float(), k.float(), v.float(), valid,
                                     causal, None, q_off)
        err, rel, ok = max_violation("flash_attn_fwd", out, ref)
        ref_lse = FA.attention_lse_reference(q.float(), k.float(), valid, causal,
                                             None, q_off)
        fin = torch.isfinite(ref_lse)
        lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() else 0.0
        ok = ok and torch.equal(torch.isfinite(lse), fin) and lse_err <= 1e-2 and same
        # visible (row, key) pairs: the work this data needs
        pairs, empty_rows, mask = visible_pairs(torch, dev, B, T, S, causal,
                                                q_off, valid)
        # the row nearest its bound, and how many keys it sees
        slack = ((out.float() - ref).abs() - ATOL["flash_attn_fwd"]
                 - RTOL * ref.abs()).amax(-1)                        # [B, T, HQ]
        wb, wt = divmod(int(slack.amax(-1).argmax()), T)
        worst_keys, worst_slack = int(mask[wb, wt].sum()), float(slack.max())
        del slack
        flops = 4 * D * pairs * HQ
        bms, bby = bound(attention_bytes(case), flops)
        kernel = attention_call(FA, case)
        kernel_ms = time_ms(torch, kernel, sets)
        launch_ms = eager_ms(torch, kernel, sets)
        plain_ms = time_ms(torch, lambda q_, k_, v_, m_: FA.attention_reference(
            q_, k_, v_, m_, causal, None, q_off), sets[:2], iters=4)

        def sdpa(q_, k_, v_, m_):
            am = mask[:, None] if causal or m_ is not None else None
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=am, enable_gqa=HQ != HK)
        library_ms = time_ms(torch, sdpa, sets)
        row = dict(kernel="flash_attn_fwd", case=name,
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{S},{HK},{D}]", head_dim=D,
                   causal=causal, q_offset=q_off, empty_rows=empty_rows,
                   max_abs_err=err, err_over_rms=rel, lse_err=lse_err, ok=ok,
                   bit_identical=same, worst_row_keys=worst_keys,
                   worst_slack=worst_slack, path=plan.path,
                   splits=plan.splits, tiles_per_split=plan.tiles_per_split,
                   grid=plan.grid, registers=regs[0], spill_bytes=regs[1],
                   sha_out=sha12(torch, out), sha_lse=sha12(torch, lse),
                   kernel_ms=kernel_ms,
                   launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] flash_attn_fwd {name:12s} {row['shape']:32s} "
            f"err={err:.3e} err/rms={rel:.3e} (atol {ATOL['flash_attn_fwd']} "
            f"rtol {RTOL}) lse_err={lse_err:.2e} {'OK' if ok else 'FAIL'} "
            f"bit-identical across calls={same} empty_rows={empty_rows} "
            f"worst row: {worst_keys} keys, |err| - tol {worst_slack:.2e} "
            f"kernel_ms={kernel_ms:.4f} "
            f"launch_ms={launch_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bms:.4f} ({bby})")
        log(f"[kernel] flash_attn_fwd {name:12s} path={plan.path} splits={plan.splits} "
            f"tiles/split={plan.tiles_per_split} grid={plan.grid} "
            f"{kname} registers={regs[0]} spill={regs[1]} "
            f"sha256 out {row['sha_out']} lse {row['sha_lse']}")


INT8_SHAPES = [("qo", 896, 896), ("kv", 896, 128), ("gate_up", 896, 4864),
               ("down", 4864, 896), ("head", 896, 151674)]      # (case, K, N)
# a tp = 2 rank's int8-base linears (column-parallel N halved, row-parallel
# K halved), at the training rows with the bf16 scale, last in the list
INT8_TP_SHAPES = [("q_tp2", 896, 448), ("kv_tp2", 896, 64), ("o_tp2", 448, 896),
                  ("gate_up_tp2", 896, 2432), ("down_tp2", 2432, 896)]


def int8_cases():
    """(case, K, N, M, scale dtype) of phase 2's int8 forward: every serving
    row (decode 1, verify 16, queries 30, prefill 640) and the int8-base
    training rows (6 x 798 for the linears, one 32-position CE chunk x 6
    for the tied head) with an fp32 scale; the decode row, the training
    rows and the head again with a bf16 scale; a tp = 2 rank's linears
    (INT8_TP_SHAPES) at the training rows, bf16 scale."""
    import torch
    lin, head = INT8_SHAPES[:4], INT8_SHAPES[4]
    cases = [(n, K, N, M, torch.float32) for (n, K, N) in lin for M in (1, 16, 30, 640, 4788)]
    cases += [(*head, M, torch.float32) for M in (1, 16, 192)]
    cases += [(n, K, N, M, torch.bfloat16) for (n, K, N) in lin for M in (1, 4788)]
    cases += [(*head, M, torch.bfloat16) for M in (1, 16, 192)]
    cases += [(n, K, N, 4788, torch.bfloat16) for (n, K, N) in INT8_TP_SHAPES]
    return cases


def int8_nbytes(K, N, M, sdt):
    """Bytes an int8 forward call must move: x, w_q, the scale and y."""
    return M * K * 2 + N * K + N * sdt.itemsize + M * N * 2


def int8_inputs(torch, dev, index):
    """The inputs of int8_cases()[index]: its first (x, w_q, scale) and its
    timing sets, from a generator seeded by the case's index, so that one
    case's inputs can be drawn alone. `scripts/fwd_digest.py` takes the
    M = 1 cases' from here."""
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    _, K, N, M, sdt = int8_cases()[index]
    gen = torch.Generator(device=dev).manual_seed(100 + index)

    def make():
        x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
        w = torch.randn(N, K, generator=gen, device=dev) * 0.02
        w_q, scale = QM.quantize_weight(w, axis=0)
        return x, w_q, scale.to(sdt)
    first = make()
    return first, [make() for _ in range(n_sets(int8_nbytes(K, N, M, sdt)))]


def run_int8_checks(torch, dev, results):
    """int8_matmul at int8_cases(), against int8_matmul_reference on the
    same bf16 x in fp32, held to the bound stated at FWD_U and
    bit-identical across two calls, with the plan's tile, reduction
    segments S and blocks (the GEMV: rows a warp, warps a block and
    blocks, with gemv_kernel's ptxas registers). Library: dequantize +
    torch.matmul, timed only."""
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regs = ptxas_usage("int8_matmul")
    for index, (name, K, N, M, sdt) in enumerate(int8_cases()):
        (x, w_q, scale), sets = int8_inputs(torch, dev, index)
        out = QM.int8_matmul(x, w_q, scale)
        same = torch.equal(QM.int8_matmul(x, w_q, scale), out)   # no atomics: bit-identical
        torch.cuda.synchronize()
        ref = QM.int8_matmul_reference(x.float(), w_q, scale)
        terms = QM.int8_matmul_reference(x.float(), w_q, scale, abs_terms=True)
        rms = float(ref.square().mean().sqrt())
        err, ratio = _ratio(out, ref, FWD_U * ref.abs() + DX_SUM_U * K ** 0.5 * terms
                            + 1e-6 * rms)
        del terms
        bms, bby = bound(int8_nbytes(K, N, M, sdt), 2 * M * N * K)
        kernel_ms = time_ms(torch, QM.int8_matmul, sets)
        launch_ms = eager_ms(torch, QM.int8_matmul, sets)
        plain_ms = time_ms(torch, QM.int8_matmul_reference, sets[:2], iters=4)

        def dequant_matmul(x_, w_, s_):
            return x_ @ (w_.to(torch.bfloat16) * s_[:, None].to(torch.bfloat16)).t()
        library_ms = time_ms(torch, dequant_matmul, sets)
        del sets
        extra = {}
        if M == 1:
            plan = QM._gemv_plan(N, K, sms)
            tile, S, blocks = f"gemv R={plan.rows} warps={plan.warps}", 1, plan.blocks
            extra = dict(rows=plan.rows, warps=plan.warps,
                         registers=regs.get(f"gemv_kernel<{plan.rows},"
                                            f"{'float' if sdt == torch.float32 else 'bf16'},"
                                            f"bf16>", (0, 0))[0])
        else:
            (bm, bn), S, _ = QM._fwd_plan(M, N, K, sms)
            tile, blocks = f"{bm}x{bn}", -(-M // bm) * -(-N // bn) * S
        ok = ratio <= 1.0 and same
        row = dict(kernel="int8_matmul", case=name, shape=f"M={M} K={K} N={N}",
                   M=M, K=K, N=N, scale=str(sdt).replace("torch.", ""),
                   max_abs_err=err, err_over_rms=err / max(rms, 1e-30),
                   err_over_tol=ratio, bit_identical=same, ok=ok, kernel_ms=kernel_ms,
                   launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby,
                   tile=tile, segments=S, blocks=blocks, **extra)
        results.append(row)
        log(f"[kernel] int8_matmul    {name:8s} M={M:4d} K={K:5d} N={N:6d} "
            f"scale={row['scale']:8s} err={err:.3e} err/rms={row['err_over_rms']:.3e} "
            f"err/tol={ratio:.3f} (tol 2^-8 |ref| + 2^-20 sqrt(K) sum|terms|) "
            f"bit-identical={same} {'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} "
            f"launch_ms={launch_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bms:.4f} ({bby}) tile={tile} S={S} blocks={blocks}"
            + (f" registers={extra['registers']}" if extra else ""))
    torch.cuda.empty_cache()


INT4_SERVE_M = (1, 16, 30, 640)    # decode, verify, queries, prefill
INT4_HEAD_M = (1, 16)


def int4_cases():
    """(case, K, N, M) of phase 2's int4 product: the int8 rows' serving
    shapes (gate,up / down / q,o / k,v at INT4_SERVE_M, the tied head at
    INT4_HEAD_M)."""
    lin, head = INT8_SHAPES[:4], INT8_SHAPES[4]
    return ([(n, K, N, M) for (n, K, N) in lin for M in INT4_SERVE_M]
            + [(*head, M) for M in INT4_HEAD_M])


def int4_nbytes(K, N, M):
    """Bytes an int4 call must move: x, the packed codes, the fp32 group
    scales and y."""
    from simlingo_tpu_torch.kernels.quantized_matmul import INT4_GROUP
    return M * K * 2 + N * K // 2 + N * (K // INT4_GROUP) * 4 + M * N * 2


def run_int4_checks(torch, dev, results):
    """int4_matmul at int4_cases(), for the record: plain PyTorch (JAX
    computes int4 in XLA, `_int4_matmul_impl`, no Pallas kernel), so no
    launch is counted. Its error against the fp32 product of the same bf16
    x and the dequantized weight, held to 2^-8 (|ref| + sum|terms|) (the
    M > 64 branch rounds the weight to bf16 once); its ms (CUDA-graph
    replay, and launched eagerly) beside the int8 kernel's at the same
    shape (fp32 scale; phase 2's int8 rows, where they ran), and the bound
    of its bytes."""
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    int8_ms = {(c["case"], c["M"]): c["kernel_ms"] for c in results
               if c["kernel"] == "int8_matmul" and c["scale"] == "float32"}
    for index, (name, K, N, M) in enumerate(int4_cases()):
        gen = torch.Generator(device=dev).manual_seed(300 + index)

        def make():
            x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
            w = torch.randn(N, K, generator=gen, device=dev) * 0.02
            return (x, *QM.quantize_weight4(w))
        nbytes = int4_nbytes(K, N, M)
        sets = [make() for _ in range(n_sets(nbytes))]
        x, w_q, scale = sets[0]
        out = QM.int4_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        wd = QM.dequantize_weight4(w_q, scale, torch.float32)
        ref = x.float() @ wd.t()
        terms = x.float().abs() @ wd.abs().t()
        rms = float(ref.square().mean().sqrt())
        err, ratio = _ratio(out, ref, 2.0 ** -8 * (ref.abs() + terms) + 1e-6 * rms)
        del wd, terms, ref
        ms = time_ms(torch, QM.int4_matmul, sets)
        launch_ms = eager_ms(torch, QM.int4_matmul, sets)
        del sets
        bms, bby = bound(nbytes, 2 * M * N * K)
        ok = ratio <= 1.0 and bool(torch.isfinite(out).all())
        row = dict(kernel="int4_matmul", route="plain", case=name,
                   shape=f"M={M} K={K} N={N}", M=M, K=K, N=N, max_abs_err=err,
                   err_over_rms=err / max(rms, 1e-30), err_over_tol=ratio, ok=ok,
                   plain_ms=ms, launch_ms=launch_ms, int8_kernel_ms=int8_ms.get((name, M)),
                   bound_ms=bms, bound_by=bby,
                   branch="grouped" if M <= QM.INT4_GROUPED_MAX_M else "dense")
        results.append(row)
        i8 = row["int8_kernel_ms"]
        log(f"[kernel] int4_matmul    {name:8s} M={M:4d} K={K:5d} N={N:6d} "
            f"({row['branch']}) err={err:.3e} err/rms={row['err_over_rms']:.3e} "
            f"err/tol={ratio:.3f} (tol 2^-8 (|ref| + sum|terms|)) {'OK' if ok else 'FAIL'} "
            f"plain_ms={ms:.4f} launch_ms={launch_ms:.4f} int8 kernel_ms="
            f"{'not run' if i8 is None else f'{i8:.4f}'} bound_ms={bms:.4f} ({bby})")
    torch.cuda.empty_cache()


def int8_dx_cases():
    """(case, M, N, K) of int8_matmul_dx on the int8-base training path:
    g [M, N] through w_q [N, K]; the linears at 6 x 798 rows, the tied head
    per 32-position CE chunk (6 x 32 rows), then a tp = 2 rank's linears."""
    return [("qo", 4788, 896, 896), ("kv", 4788, 128, 896), ("gate_up", 4788, 4864, 896),
            ("down", 4788, 896, 4864), ("head", 192, 151674, 896),
            *((n, 4788, N, K) for n, K, N in INT8_TP_SHAPES)]


def run_int8_dx_checks(torch, dev, results):
    """int8_matmul_dx against int8_matmul_dx_reference on the same bf16 g
    and a bf16 scale (the training step's frozen cast), held to the bound
    stated at DX_SUM_U; library: (g.float() * scale).to(bf16) @
    w_q.to(bf16), timed only."""
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, M, N, K in int8_dx_cases():
        def make():
            g = torch.randn(M, N, generator=gen, device=dev, dtype=torch.bfloat16)
            w = torch.randn(N, K, generator=gen, device=dev) * 0.02
            w_q, scale = QM.quantize_weight(w, axis=0)
            return g, w_q, scale.bfloat16()
        g, w_q, scale = make()
        dx = QM.int8_matmul_dx(g, w_q, scale)
        same = torch.equal(QM.int8_matmul_dx(g, w_q, scale), dx)   # no atomics: bit-identical
        torch.cuda.synchronize()
        ref = QM.int8_matmul_dx_reference(g, w_q, scale)
        terms = QM.int8_matmul_dx_reference(g, w_q, scale, abs_terms=True)
        rms = float(ref.float().square().mean().sqrt())
        tol = (BF16_SPACING * ref.float().abs() + DX_SUM_U * N ** 0.5 * terms
               + 1e-6 * rms)
        err, ratio = _ratio(dx, ref, tol)
        del terms, tol
        nbytes = M * N * 2 + N * K + N * 2 + M * K * 2
        bms, bby = bound(nbytes, 2 * M * N * K)
        sets = [make() for _ in range(n_sets(nbytes))]
        kernel_ms = time_ms(torch, QM.int8_matmul_dx, sets)
        plain_ms = time_ms(torch, QM.int8_matmul_dx_reference, sets[:2], iters=4)

        def library(g_, w_, s_):
            return (g_.float() * s_).to(torch.bfloat16) @ w_.to(torch.bfloat16)
        library_ms = time_ms(torch, library, sets)
        del sets
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        (bm, bn), S, _ = QM._dx_plan(M, N, K, sms)
        ok = ratio <= 1.0 and same
        row = dict(kernel="int8_matmul_dx", case=name, shape=f"M={M} N={N} K={K}",
                   M=M, N=N, K=K, max_abs_err=err, err_over_rms=err / max(rms, 1e-30),
                   err_over_tol=ratio, bit_identical=same, ok=ok, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=bby,
                   tile=[bm, bn], segments=S, blocks=-(-M // bm) * -(-K // bn) * S)
        results.append(row)
        log(f"[kernel] int8_matmul_dx {name:8s} M={M:4d} N={N:6d} K={K:5d} "
            f"err={err:.3e} err/rms={row['err_over_rms']:.3e} err/tol={ratio:.3f} "
            f"(tol 2^-7 |ref| + 2^-20 sqrt(N) sum|terms|) bit-identical={same} "
            f"{'OK' if ok else 'FAIL'} "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bms:.4f} ({bby}) tile={bm}x{bn} S={S} blocks={row['blocks']}")
    torch.cuda.empty_cache()


def attention_bwd_cases():
    """(name, B, T, HQ, HK, causal, strided, D) of phase 2's attention
    backward: the four training shapes of head dim 64 (the LoRA step's LLM
    and ViT, SimLingo-Base's CLIP and LLaMA), then the self-attention
    cases of `head_dim_attention`, then TP_ATTENTION's and BASE_TP_ATTENTION's."""
    return [("llm_train", 6, 798, 14, 2, True, False, 64),
            ("vit_train", 12, 1025, 16, 16, False, True, 64),
            *((c[0], c[1], c[2], c[4], c[5], c[6], c[9], head_dim(c)) for c in BASE_ATTENTION
              + [c for c in head_dim_attention() if c[2] == c[3]] + TP_ATTENTION
              + BASE_TP_ATTENTION)]


def bwd_readings(torch, FA, got, args, ref):
    """err/tol of each backward gradient in `got` (dq, dk, dv) about `ref`
    = attention_bwd_reference(*args): "terms" against the kernel's rounding
    bound `attention_bwd_bound` (held: 2^-8 (sum |terms| + |ref|) + 1e-5
    rms(ref), dS's terms P (|dO| |V| + |delta|), the bound of phase 2's dS
    pass carried through the products), "ds" against the same with |dS| in
    their place (`attention_bwd_reference(abs_terms=True)`, printed
    beside: it omits the fp32 error of dP - delta, and one kernel can
    exceed it); with the largest |err| and |err| / rms(ref)."""
    out = {"terms": [], "ds": [], "err": 0.0, "rel": 0.0}
    for a, b, m, t in zip(got, ref, FA.attention_bwd_reference(*args, abs_terms=True),
                          FA.attention_bwd_bound(*args, ref)):
        diff = (a.float() - b).abs()
        rms = float(b.square().mean().sqrt())
        out["terms"].append(float((diff / t).max()))
        out["ds"].append(float((diff / (BF16_U * (m + b.abs()) + 1e-5 * rms)).max()))
        out["err"] = max(out["err"], float(diff.max()))
        out["rel"] = max(out["rel"], float(diff.max()) / max(rms, 1e-30))
    return out


def attention_bwd_bytes(B, T, HQ, HK, D, masked):
    """Bytes the backward must move: q, k, v, o, dout, lse and kv_valid
    read, dq, dk, dv written."""
    qsz, ksz = B * T * HQ * D, B * T * HK * D
    return 2 * (3 * qsz + 2 * ksz) + 2 * (qsz + 2 * ksz) + 4 * B * HQ * T + (
        B * T if masked else 0)


def attention_bwd_inputs(torch, dev, dims=None):
    """For each phase-2 backward case (`attention_bwd_cases`, those of head
    dims `dims` if given: the others come last, so skipping them changes no
    other case's inputs): the case, its kv_valid, its first inputs (q, k, v,
    out, dout, lse; out and lse from the forward kernel) and its timing
    sets, all drawn from one generator seeded 3. `scripts/fwd_digest.py`
    takes its inputs from here."""
    from simlingo_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(3)
    train_valid = train_llm_valid(torch, dev)
    for case in attention_bwd_cases():
        name, B, T, HQ, HK, causal, strided, D = case
        if dims is not None and D not in dims:
            continue
        valid = train_valid if name in ("llm_train", "llm_train_tp2") else None

        def make():
            if strided:
                qkv = torch.randn(B, T, 3 * HQ * D, generator=gen, device=dev,
                                  dtype=torch.bfloat16)
                q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D)
                           for i in range(3))
            else:
                q = torch.randn(B, T, HQ, D, generator=gen, device=dev, dtype=torch.bfloat16)
                k, v = (torch.randn(B, T, HK, D, generator=gen, device=dev,
                                    dtype=torch.bfloat16) for _ in range(2))
            out, lse = FA.flash_attn_fwd(q, k, v, valid, causal, return_lse=True)
            dout = torch.randn(B, T, HQ, D, generator=gen, device=dev, dtype=torch.bfloat16)
            return q, k, v, out, dout, lse

        first = make()
        nbytes = attention_bwd_bytes(B, T, HQ, HK, D, valid is not None)
        yield case, valid, first, [make() for _ in range(n_sets(nbytes))]


def run_attention_bwd_checks(torch, dev, results):
    """flash_attn_bwd at every `attention_bwd_cases` shape, against
    attention_bwd_reference on the same bf16 inputs (and the kernel
    forward's o and lse), and pass by pass against attention_ds_reference
    and attention_dq_from_ds_reference; bit-identical across two calls;
    device ms of its three kernels and their ptxas registers; library:
    autograd through SDPA's backward."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    regs_all = {k: v for k, v in ptxas_usage("flash_attn_bwd").items()
                if k.split("<")[0] in BWD_KERNELS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, valid, first, sets in attention_bwd_inputs(torch, dev):
        name, B, T, HQ, HK, causal, _, D = case
        # the instantiations of this head dim: bwd_dkdv_kernel<D,blocks>, ...
        regs = {k: v for k, v in regs_all.items() if k.split("<")[1].split(",")[0].rstrip(">")
                == str(FA._instance_dim(D))}
        q, k, v, out, dout, lse = first
        *got, ds = FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, return_ds=True)
        same = all(torch.equal(a, b) for a, b in zip(       # no atomics: bit-identical
            FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal), got))
        torch.cuda.synchronize()
        args = (q.float(), k.float(), v.float(), valid, out.float(), dout.float(),
                lse, causal)
        reads = bwd_readings(torch, FA, got, args, FA.attention_bwd_reference(*args))
        err, rel, ratio, ratio_ds = (reads["err"], reads["rel"], max(reads["terms"]),
                                     max(reads["ds"]))
        ok = same and ratio <= 1.0
        # the scratch path, pass by pass: the kernel's dS^T on the pairs it
        # writes against the plain first pass, and its dq against the plain
        # second pass over the kernel's own scratch (same bound)
        plan = FA._bwd_plan(B, T, T, HQ, HK, causal, 0, D)
        written = FA._pair_mask(plan.written, plan, FA._live_key_tiles(valid, B, T, dev))
        pass_ratio = []
        for want, terms, have in (
                (FA.attention_ds_reference(*args), FA.attention_ds_reference(
                    *args, abs_terms=True), ds),
                (FA.attention_dq_from_ds_reference(ds, k.float(), valid, T, causal),
                 FA.attention_dq_from_ds_reference(ds, k.float(), valid, T, causal,
                                                   abs_terms=True), got[0])):
            if want.shape == ds.shape:                 # the first pass: written pairs only
                want, terms, have = (torch.where(written, x.float(), 0.0)
                                     for x in (want, terms, have))
            rms = float(want.square().mean().sqrt())
            tol = BF16_U * (terms + want.abs()) + 1e-5 * rms
            pass_ratio.append(float(((have.float() - want).abs() / tol).max()))
            del want, terms, have, tol
        ok &= max(pass_ratio) <= 1.0
        del written, ds
        # the bits of (dq, dk, dv) for this seed: equal digests across trees
        # on one card mean equal results
        digest = [sha12(torch, x) for x in got]
        pairs, empty_rows, mask = visible_pairs(torch, dev, B, T, T, causal, None, valid)
        flops = 10 * D * pairs * HQ          # S, dP, dV, dQ, dK: 2*D per pair each
        bms, bby = bound(attention_bwd_bytes(B, T, HQ, HK, D, valid is not None), flops)

        def kernel(q_, k_, v_, o_, d_, l_):
            return FA.flash_attn_bwd(q_, k_, v_, valid, o_, d_, l_, causal)
        kernel_ms = time_ms(torch, kernel, sets)
        split = kernel_split_ms(torch, kernel, sets, BWD_KERNELS)
        plain_ms = time_ms(torch, lambda q_, k_, v_, o_, d_, l_: FA.attention_bwd_reference(
            q_, k_, v_, valid, o_, d_, l_, causal), sets[:2], iters=2)
        # library: the backward of SDPA with the same mask (eager, events)
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in xs),
            attn_mask=mask[:, None] if causal else None, enable_gqa=HQ != HK)
        lib_do = dout.transpose(1, 2)
        library_ms = eager_ms(torch, lambda: torch.autograd.grad(
            lib_out, xs, lib_do, retain_graph=True), [()], iters=10)
        del lib_out, xs, sets
        row = dict(kernel="flash_attn_bwd", case=name,
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{T},{HK},{D}]", head_dim=D,
                   causal=causal, empty_rows=empty_rows, max_abs_err=err, err_over_rms=rel,
                   err_over_tol=ratio, err_over_tol_ds=ratio_ds, bit_identical=same, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=bby, split_ms=split, ptxas=regs,
                   ds_bytes=plan.ds_bytes, ds_floor_ms=2 * plan.ds_bytes / PEAK_BYTES * 1e3,
                   pairs_per_head=[len(plan.written), plan.n_qt * plan.n_kt],
                   ds_pass_err_over_tol=pass_ratio[0], dq_pass_err_over_tol=pass_ratio[1],
                   dkdv_blocks=plan.n_kt * HK * B, dq_blocks=plan.n_qt * HQ * B,
                   dkdv_kernel=f"bwd_dkdv_kernel<{plan.head_dim},"
                               f"{FA._dkdv_blocks(B, T, HK, sms, D)}>",
                   query_pass=plan.query_pass, dkdv_smem=plan.dkdv_smem,
                   digest=digest)
        results.append(row)
        log(f"[kernel] flash_attn_bwd {name:12s} {row['shape']:32s} err={err:.3e} "
            f"err/rms={rel:.3e} err/tol={ratio:.3f} (attention_bwd_bound; |dS| terms "
            f"{ratio_ds:.3f}) bit-identical={same} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA backward) bound_ms={bms:.4f} ({bby}) "
            f"dK/dV blocks={row['dkdv_blocks']} ({row['dkdv_kernel']}) "
            f"dQ blocks={row['dq_blocks']}")
        log(f"[kernel] flash_attn_bwd {name:12s} device ms a call by kernel: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + " | ptxas registers (spill bytes): "
            + ", ".join(f"{k} {r} ({sp})" for k, (r, sp) in regs.items()))
        log(f"[kernel] flash_attn_bwd {name:12s} dS^T scratch {plan.ds_shape} bf16 "
            f"{plan.ds_bytes} bytes (written + read once: {row['ds_floor_ms']:.4f} ms at "
            f"{PEAK_BYTES / 1e12} TB/s), pairs a head {len(plan.written)} of "
            f"{plan.n_qt * plan.n_kt}; err/tol of the dS pass {pass_ratio[0]:.3f}, "
            f"of dq from the kernel's dS {pass_ratio[1]:.3f}; sha256 of dq, dk, dv "
            f"{' '.join(digest)}")
    run_ring_checks(torch, dev, results)


def run_ring_checks(torch, dev, results):
    """The ring of `mesh_sp2` (sp = 2, `parallel/sequence.py`) at the training
    batch's shapes, both ranks in one process: the forward's two key
    chunks merged by their lse (`_merge`, the kernel's chunks) against
    attention_reference of the whole sequence ("ring_merge"); and the
    backward of rank 1's query slab, chunk by chunk (the causal diagonal,
    the earlier chunk), fed the ring's global o and lse, against
    attention_bwd_reference on the same inputs (err/tol as the backward's
    other cases; times, bound by the chunk's visible pairs, SDPA's backward
    on the chunk as the library); and the whole ring's backward
    ("ring_bwd_sum": `_Ring` itself, its two ranks on threads of this
    process as tests/torch_ranks.ring_threads runs them), each chunk's
    fp32 partials (`out_dtype=torch.float32`) summed and rounded once,
    against attention_bwd_reference of the whole sequence fed the ring's
    o / lse, held with one kernel on the whole sequence and the same o /
    lse to the single-kernel rows' bound over the whole sequence's terms
    (`bwd_readings`: `attention_bwd_bound`, err/tol <= 1; the |dS|-terms
    reading beside); times: the ring's three chunk
    backwards and sums in one stream, the fp32 instance beside the bf16
    one on the earlier chunk."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.parallel import sequence as SQ
    gen = torch.Generator(device=dev).manual_seed(5)
    B, T, HQ, HK, D, n = 6, 2 * RING_SLAB, 14, 2, 64, RING_SLAB
    valid = train_llm_valid(torch, dev)

    def make():
        q = torch.randn(B, T, HQ, D, generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(B, T, HK, D, generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        dout = torch.randn(B, T, HQ, D, generator=gen, device=dev, dtype=torch.bfloat16)
        return q, k, v, dout

    def sl(x, i):
        return x[:, i * n:(i + 1) * n].contiguous()

    def ring_forward(q, k, v):
        """Each rank's (o, lse): rank i folds its diagonal, then the earlier
        chunks, as the ring meets them."""
        outs = []
        for i in range(2):
            o = torch.zeros(B, n, HQ, D, device=dev)
            lse = torch.full((B, HQ, n), float("-inf"), device=dev)
            for src in range(i, -1, -1):
                o_c, lse_c = FA.flash_attn_fwd(sl(q, i), sl(k, src), sl(v, src), sl(valid, src),
                                               src == i, None, None, return_lse=True)
                o, lse = SQ._merge(o, lse, o_c, lse_c)
            outs.append((o.to(torch.bfloat16), lse))
        return outs

    q, k, v, dout = make()
    outs = ring_forward(q, k, v)
    torch.cuda.synchronize()
    o = torch.cat([x[0] for x in outs], 1)
    lse = torch.cat([x[1] for x in outs], 2)
    ref = FA.attention_reference(q.float(), k.float(), v.float(), valid, True)
    err, rel, ok = max_violation("flash_attn_fwd", o, ref)
    ref_lse = FA.attention_lse_reference(q.float(), k.float(), valid, True)
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse[fin] - ref_lse[fin]).abs().max())
    ok = ok and torch.equal(torch.isfinite(lse), fin) and lse_err <= 1e-2
    results.append(dict(kernel="flash_attn_fwd", case="ring_merge",
                        shape=f"q[{B},{T},{HQ},{D}] as 2 slabs of {n}", max_abs_err=err,
                        err_over_rms=rel, lse_err=lse_err, ok=ok))
    log(f"[kernel] flash_attn_fwd ring_merge   q[{B},{T},{HQ},{D}] as 2 slabs of {n}: the "
        f"chunks merged by lse against attention_reference of the whole sequence err={err:.3e} "
        f"err/rms={rel:.3e} lse_err={lse_err:.2e} {'OK' if ok else 'FAIL'}")

    # the backward of rank 1's slab, chunk by chunk
    o1, lse1 = outs[1]
    q1, d1 = sl(q, 1), sl(dout, 1)
    for name, src, causal in (("ring_bwd_diag", 1, True), ("ring_bwd_prev", 0, False)):
        kc, vc, vac = sl(k, src), sl(v, src), sl(valid, src)
        got = FA.flash_attn_bwd(q1, kc, vc, vac, o1, d1, lse1, causal)
        same = all(torch.equal(a, b) for a, b in zip(
            FA.flash_attn_bwd(q1, kc, vc, vac, o1, d1, lse1, causal), got))
        args = (q1.float(), kc.float(), vc.float(), vac, o1.float(), d1.float(), lse1, causal)
        reads = bwd_readings(torch, FA, got, args, FA.attention_bwd_reference(*args))
        err, rel, ratio, ratio_ds = (reads["err"], reads["rel"], max(reads["terms"]),
                                     max(reads["ds"]))
        ok = same and ratio <= 1.0
        pairs, empty_rows, mask = visible_pairs(torch, dev, B, n, n, causal, 0, vac)
        bms, bby = bound(attention_bwd_bytes(B, n, HQ, HK, D, True), 10 * D * pairs * HQ)

        def chunk_sets():
            out = []
            for _ in range(n_sets(attention_bwd_bytes(B, n, HQ, HK, D, True))):
                qq, kk, vv, dd = make()
                out.append((sl(qq, 1), sl(kk, src), sl(vv, src), o1, sl(dd, 1), lse1))
            return out
        sets = chunk_sets()

        def kernel(q_, k_, v_, o_, d_, l_):
            return FA.flash_attn_bwd(q_, k_, v_, vac, o_, d_, l_, causal)
        kernel_ms = time_ms(torch, kernel, sets)
        plain_ms = time_ms(torch, lambda q_, k_, v_, o_, d_, l_: FA.attention_bwd_reference(
            q_, k_, v_, vac, o_, d_, l_, causal), sets[:2], iters=2)
        xs = [x.detach().clone().requires_grad_(True) for x in (q1, kc, vc)]
        lib_out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in xs), attn_mask=mask[:, None], enable_gqa=True)
        library_ms = eager_ms(torch, lambda: torch.autograd.grad(
            lib_out, xs, d1.transpose(1, 2), retain_graph=True), [()], iters=10)
        del lib_out, xs, sets
        row = dict(kernel="flash_attn_bwd", case=name,
                   shape=f"q[{B},{n},{HQ},{D}] kv[{B},{n},{HK},{D}]", head_dim=D, causal=causal,
                   empty_rows=empty_rows, max_abs_err=err, err_over_rms=rel, err_over_tol=ratio,
                   err_over_tol_ds=ratio_ds, bit_identical=same, ok=ok, kernel_ms=kernel_ms,
                   plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby,
                   digest=[sha12(torch, x) for x in got])
        results.append(row)
        log(f"[kernel] flash_attn_bwd {name:12s} {row['shape']:32s} the ring's global o / lse "
            f"err={err:.3e} err/rms={rel:.3e} err/tol={ratio:.3f} (attention_bwd_bound; |dS| "
            f"terms {ratio_ds:.3f}) bit-identical={same} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA backward on the chunk) bound_ms={bms:.4f} "
            f"({bby})")

    # the ring's summed gradients, through `_Ring` on two threads
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(ROOT, "tests", "torch_ranks.py"))
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    q, k, v, dout = make()
    b0 = FA.flash_attn_bwd.launches
    got = ranks.ring_threads(*([sl(x, i) for i in range(2)] for x in (q, k, v, valid, dout)),
                             True)
    torch.cuda.synchronize()
    launched = FA.flash_attn_bwd.launches - b0
    o = torch.cat([r[0] for r in got], 1)
    lse = torch.cat([r[2] for r in got], 2)
    grads = [torch.cat([r[1][j] for r in got], 1) for j in range(3)]
    args = (q.float(), k.float(), v.float(), valid, o.float(), dout.float(), lse, True)
    ref = FA.attention_bwd_reference(*args)
    # the ring's sum and one kernel on the whole sequence with the same o /
    # lse, held alike: to the single-kernel rows' bound over the whole
    # sequence's terms
    reads = bwd_readings(torch, FA, grads, args, ref)
    single = bwd_readings(torch, FA, FA.flash_attn_bwd(q, k, v, valid, o, dout, lse, True),
                          args, ref)
    ratios, err, rel = reads["terms"], reads["err"], reads["rel"]
    readings = {"ring_terms": ratios, "ring_ds": reads["ds"], "single_terms": single["terms"],
                "single_ds": single["ds"]}
    ok = (launched == 3 and all(a.dtype == torch.bfloat16 for a in grads)
          and max(ratios) <= 1.0 and max(single["terms"]) <= 1.0)
    del ref
    pairs, empty_rows, mask = visible_pairs(torch, dev, B, T, T, True, 0, valid)
    bms, bby = bound(attention_bwd_bytes(B, T, HQ, HK, D, True), 10 * D * pairs * HQ)
    vas = [sl(valid, i) for i in range(2)]

    def ring_bwd(q_, k_, v_, o_, d_, l_):
        """The ring's arithmetic without its passes: rank 0's diagonal, rank
        1's diagonal and earlier chunk, their fp32 partials summed by slab
        (dq of slab 1 from two chunks, dk / dv of slab 0 from two)."""
        qs, ks, vs, os_, ds_ = ([sl(x, i) for i in range(2)] for x in (q_, k_, v_, o_, d_))
        ls = [l_[:, :, i * n:(i + 1) * n].contiguous() for i in range(2)]
        g = {(i, src): SQ.chunk_grads(qs[i], ks[src], vs[src], vas[src], os_[i], ds_[i],
                                      ls[i], i == src)
             for i, src in ((0, 0), (1, 1), (1, 0))}
        return (g[0, 0][0], g[1, 1][0] + g[1, 0][0], g[0, 0][1] + g[1, 0][1],
                g[0, 0][2] + g[1, 0][2], g[1, 1][1], g[1, 1][2])
    sets = [(q, k, v, o, dout, lse)]
    for _ in range(n_sets(attention_bwd_bytes(B, T, HQ, HK, D, True)) - 1):
        qq, kk, vv, dd = make()
        sets.append((qq, kk, vv, o, dd, lse))
    kernel_ms = time_ms(torch, ring_bwd, sets)
    prev = (sl(q, 1), sl(k, 0), sl(v, 0), vas[0], sl(o, 1), sl(dout, 1),
            lse[:, :, n:].contiguous(), False)
    chunk_ms = {str(dt).split(".")[1]: time_ms(
        torch, lambda *a, dt=dt: FA.flash_attn_bwd(*a, out_dtype=dt), [prev])
        for dt in (torch.bfloat16, torch.float32)}
    plain_ms = time_ms(torch, lambda q_, k_, v_, o_, d_, l_: FA.attention_bwd_reference(
        q_, k_, v_, valid, o_, d_, l_, True), sets[:2], iters=2)
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in xs), attn_mask=mask[:, None], enable_gqa=True)
    library_ms = eager_ms(torch, lambda: torch.autograd.grad(
        lib_out, xs, dout.transpose(1, 2), retain_graph=True), [()], iters=10)
    del lib_out, xs, sets
    row = dict(kernel="flash_attn_bwd", case="ring_bwd_sum",
               shape=f"q[{B},{T},{HQ},{D}] kv[{B},{T},{HK},{D}] as 2 slabs of {n}",
               head_dim=D, causal=True, empty_rows=empty_rows, max_abs_err=err,
               err_over_rms=rel, err_over_tol=max(ratios), err_over_tol_dq_dk_dv=ratios,
               readings_dq_dk_dv=readings,
               launches=launched, ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bms, bound_by=bby,
               chunk_ms_by_out_dtype=chunk_ms, digest=[sha12(torch, x) for x in grads])
    results.append(row)
    log(f"[kernel] flash_attn_bwd ring_bwd_sum {row['shape']}: _Ring's summed fp32 partials "
        f"({launched} chunk launches), rounded once, against the whole sequence's plain "
        f"backward err={err:.3e} err/rms={rel:.3e} err/tol dq / dk / dv "
        f"{' / '.join(f'{r:.3f}' for r in ratios)} (attention_bwd_bound over the whole "
        f"sequence, as the single-kernel rows) {'OK' if ok else 'FAIL'}; one kernel on the "
        f"whole sequence and the same o / lse "
        f"{' / '.join(f'{r:.3f}' for r in readings['single_terms'])}; with |dS| terms the "
        f"ring {' / '.join(f'{r:.3f}' for r in readings['ring_ds'])}, the one kernel "
        f"{' / '.join(f'{r:.3f}' for r in readings['single_ds'])}; "
        f"kernel_ms={kernel_ms:.4f} (three chunk backwards + sums) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (SDPA backward, whole sequence) bound_ms={bms:.4f} "
        f"({bby}); the earlier chunk bf16 "
        f"{chunk_ms['bfloat16']:.4f} ms, fp32 partials {chunk_ms['float32']:.4f} ms")


# dropout at a rank's block of a multi-GPU step (`block` = row0, col0, width
# of the one-process [rows, width] tensor): dp = 2's second rank (the rows
# 3 x 798 on), and tp = 2's second rank at the row-parallel inputs of o
# (448 of 896 columns) and down (2432 of 4864)
# and sp = 2's two slabs (`block` + (seg, stride): each rank's 399 positions
# of every 798-position row), at both LoRA input widths, last in the list
DROPOUT_CASES = (("lora_x_896", (6, 798, 896), None), ("lora_h_4864", (6, 798, 4864), None),
                 ("lora_x_896_dp2", (3, 798, 896), (3 * 798, 0, 896)),
                 ("lora_x_448_tp2", (6, 798, 448), (0, 448, 896)),
                 ("lora_h_2432_tp2", (6, 798, 2432), (0, 2432, 4864)),
                 *((f"lora_{w}_sp2_{i}", (6, 399, n), (399 * i, 0, n, 399, 798))
                   for w, n in (("x", 896), ("h", 4864)) for i in range(2)))
# sha12 of the outputs on these inputs, recorded on an H100: the
# zero-offset ones from the tree before the blocks (commit c489a34,
# `--kernels dropout --parent`), the dp / tp blocks' from commit 97fed2a
# (its full run): the one-process mask and the unsegmented blocks keep
# their bits
DROPOUT_DIGESTS = {"lora_x_896": "6ba5e5e7cad2", "lora_h_4864": "31b358bad4c2",
                   "lora_x_896_dp2": "001bd854b171", "lora_x_448_tp2": "2ef793699634",
                   "lora_h_2432_tp2": "a04f884a8346"}


def run_dropout_checks(torch, dev, results):
    """dropout at the LoRA inputs of the training path and at a rank's
    blocks (DROPOUT_CASES): bit-equal to dropout_plain (which, for a block,
    must equal the one-process mask cut to it), keep rate 0.9 +- 0.002,
    identity at p = 0, the zero-offset outputs' digests equal to
    DROPOUT_DIGESTS; library: F.dropout."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import dropout as DO
    gen = torch.Generator(device=dev).manual_seed(4)
    seed, rate = 0x243F6A8885A308D3, 0.1
    for name, shape, block in DROPOUT_CASES:
        def make():
            return (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),)
        (x,) = make()
        out = DO.dropout(x, seed, rate, block)
        torch.cuda.synchronize()
        ref = DO.dropout_plain(x, seed, rate, block)
        keep = DO.dropout(torch.ones_like(x), seed, rate, block) != 0
        keep_ref = DO.keep_mask(x.numel(), seed, rate, dev, block, shape[-1]).view(shape)
        cut = True
        if block is not None:       # the one-process mask restricted to the block
            rows = torch.arange(x.numel() // shape[-1], device=dev)
            if len(block) == 5:     # segments of seg rows, stride apart
                rows = (rows // block[3]) * block[4] + rows % block[3]
            rows = rows + block[0]
            whole = DO.keep_mask((int(rows.max()) + 1) * block[2], seed, rate, dev).view(
                -1, block[2])[rows, block[1]:block[1] + shape[-1]]
            cut = torch.equal(whole.reshape(shape), keep_ref)
        rate_kept = float(keep.float().mean())
        identity = torch.equal(DO.dropout(x, seed, 0.0, block), x)
        digest = sha12(torch, out)
        recorded = DROPOUT_DIGESTS.get(name)
        ok = (torch.equal(out, ref) and torch.equal(keep, keep_ref) and identity and cut
              and abs(rate_kept - (1 - rate)) <= 0.002
              and (recorded is None or digest == recorded))
        err = float((out.float() - ref.float()).abs().max())
        nbytes = 2 * 2 * x.numel()
        bms, bby = bound(nbytes, 0)
        sets = [make() for _ in range(n_sets(nbytes))]
        kernel_ms = time_ms(torch, lambda x_: DO.dropout(x_, seed, rate, block), sets)
        plain_ms = time_ms(torch, lambda x_: DO.dropout_plain(x_, seed, rate, block), sets[:2],
                           iters=2)
        library_ms = time_ms(torch, lambda x_: F.dropout(x_, rate, training=True), sets)
        row = dict(kernel="dropout", case=name,
                   shape=f"[{','.join(map(str, shape))}] bf16 p={rate}" + (
                       f" block {block}" if block else ""),
                   max_abs_err=err, err_over_rms=0.0, bit_equal=torch.equal(out, ref),
                   keep_rate=rate_kept, identity_at_0=identity, block=block,
                   one_process_mask_cut=cut, sha_out=digest, recorded_digest=recorded, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] dropout        {name:16s} {row['shape']:44s} bit_equal="
            f"{row['bit_equal']} keep_rate={rate_kept:.5f} identity_at_0={identity} "
            f"one-process mask cut to the block={cut} sha256 {digest} (recorded "
            f"{recorded}) {'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (F.dropout) "
            f"bound_ms={bms:.4f} ({bby})")


def _ratio(got, ref, tol):
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff / tol).max())


# the norm kernels of csrc/layernorm.cu, as the profiler names them
NORM_KERNELS = ("norm_fwd_kernel", "norm_bwd_kernel", "norm_colsum_kernel")


def norm_cases():
    """(kernel family, case, rows, d, eps, directions): the ViT's 48
    LayerNorms and the projector's and the LLM's 49 RMSNorms in training
    (the LLM's also as the gated step runs them: a frozen scale, dx only),
    SimLingo-Base's in training (CLIP's 47 LayerNorms over 32 x 577 rows,
    the tiny LLaMA's 25 RMSNorms over 16 x 333 rows at d = 512, every
    scale trained), and the serving rows: the ViT's 2 tiles x 1025 and the
    projector's 2 x 256, the LLM's decode 1, verify 16, queries 30 and
    prefill 640."""
    both, fwd, dx_only = ("fwd", "bwd"), ("fwd",), ("bwd_dx",)
    return [("layernorm", "vit", 12 * 1025, 1024, 1e-6, both),
            ("layernorm", "projector", 12 * 256, 4096, 1e-5, both),
            ("rmsnorm", "llm_train", 6 * 798, 896, 1e-6, both),
            ("rmsnorm", "llm_train_frozen", 6 * 798, 896, 1e-6, dx_only),
            ("rmsnorm", "serve_decode", 1, 896, 1e-6, both),
            ("rmsnorm", "serve_prefill", 640, 896, 1e-6, both),
            ("layernorm", "clip", 32 * 577, 1024, 1e-5, both),
            ("rmsnorm", "base_llm", 16 * 333, 512, 1e-6, both),
            ("layernorm", "serve_vit", 2 * 1025, 1024, 1e-6, fwd),
            ("layernorm", "serve_projector", 2 * 256, 4096, 1e-5, fwd),
            ("rmsnorm", "serve_verify", 16, 896, 1e-6, fwd),
            ("rmsnorm", "serve_queries", 30, 896, 1e-6, fwd)]


def _template_args(mangled):
    """['4', '1', '1', 'bf16'] from the Itanium-mangled template arguments
    'Li4ELi1ELb1E13__nv_bfloat16' (ints, bools, bf16 or float)."""
    out = []
    while mangled:
        m = re.match(r"L[ib](\d+)E", mangled)
        if m:
            out.append(m.group(1))
            mangled = mangled[m.end():]
        elif mangled.startswith("13__nv_bfloat16"):
            out.append("bf16")
            mangled = mangled[len("13__nv_bfloat16"):]
        elif mangled[0] == "f":
            out.append("float")
            mangled = mangled[1:]
        elif re.match(r"S\d*_", mangled):        # a repeated type: the last one named
            out.append([a for a in out if a in ("bf16", "float")][-1])
            mangled = mangled[re.match(r"S\d*_", mangled).end():]
        else:
            out.append(mangled)
            break
    return out


def norm_ptxas():
    """{instantiation: (registers, spill store bytes, stack frame bytes)} of
    csrc/layernorm.cu's kernels from phase 1's `nvcc -Xptxas -v` log, the
    template arguments spelled out (e.g. norm_bwd_kernel<4,1,1,bf16>)."""
    from simlingo_tpu_torch.kernels import _build
    path = _build.BUILD_ROOT / _build._digest() / "layernorm.build.log"
    usage, name, spill, stack = {}, None, 0, 0
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill, stack = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for k in NORM_KERNELS:
                t = re.search(rf"{len(k)}{k}I(\w*?)EEv", name)
                if t:
                    usage[f"{k}<{','.join(_template_args(t.group(1)))}>"] = (
                        int(m.group(1)), spill, stack)
                    break
            name = None
    return usage


def norm_make(torch, dev, gen, fam, n, d, eps):
    """A function that draws one operand set of a norm case: bf16 x, dy,
    scale and bias (as the compute copies of the path) and the plain
    forward's fp32 statistics."""
    from simlingo_tpu_torch.kernels import layernorm as TL

    def make():
        x = (2 * torch.randn(n, d, generator=gen, device=dev) + 0.3).bfloat16()
        dy = torch.randn(n, d, generator=gen, device=dev).bfloat16()
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        bias = (0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
        if fam == "layernorm":
            _, mean, rstd = TL.layernorm_fwd_plain(x, scale, bias, eps)
        else:
            _, rstd = TL.rmsnorm_fwd_plain(x, scale, eps)
            mean = None
        return x, scale, bias, dy, mean, rstd
    return make


def norm_calls(fam, eps, need_ds, fwd_plan=None, bwd_plan=None):
    """(forward, backward, plain forward, plain backward), each taking one
    operand set; the kernels through their wrappers, or at a forced plan."""
    from simlingo_tpu_torch.kernels import layernorm as TL
    ln = fam == "layernorm"

    def kf(x, s, b, dy, m, r):
        if fwd_plan is not None:
            return TL._fwd_cuda(f"{fam}_fwd", x, s, b if ln else None, eps, not ln, fwd_plan)
        return TL.layernorm_fwd(x, s, b, eps) if ln else TL.rmsnorm_fwd(x, s, eps)

    def kb(x, s, b, dy, m, r):
        if bwd_plan is not None:
            return TL._bwd_cuda(f"{fam}_bwd", x, s, m, r, dy, need_ds, ln and need_ds,
                                not ln, bwd_plan)
        return (TL.layernorm_bwd(x, s, m, r, dy) if ln
                else TL.rmsnorm_bwd(x, s, r, dy, need_ds))

    def pf(x, s, b, dy, m, r):
        return TL.layernorm_fwd_plain(x, s, b, eps) if ln else TL.rmsnorm_fwd_plain(x, s, eps)

    def pb(x, s, b, dy, m, r):
        return (TL.layernorm_bwd_plain(x, s, m, r, dy) if ln
                else TL.rmsnorm_bwd_plain(x, s, r, dy, need_ds))
    return kf, kb, pf, pb


def norm_errors(fam, need_ds, args, y, got):
    """(max |err|, err/tol) of a forward's y and of a backward's outputs
    against the plain versions on the same operand set: y and dx within one
    bf16 spacing, dscale / dbias within one spacing plus 1e-5 of the sum of
    |terms| over the rows (BF16_SPACING)."""
    x, scale, bias, dy, mean, rstd = args
    pb = norm_calls(fam, None, need_ds)[3]

    def spacing_tol(r):
        r = r.float()
        return BF16_SPACING * r.abs() + 1e-5 * float(r.square().mean().sqrt())
    out = []
    if y is not None:                            # (kernel's y, plain y)
        out.append(_ratio(y[0], y[1], spacing_tol(y[1])))
    if got is not None:
        ref = pb(*args)
        xhat = ((x.float() - mean[:, None]) * rstd[:, None] if fam == "layernorm"
                else x.float() * rstd[:, None])
        terms = [(dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0)]
        bwd = [_ratio(got[0], ref[0], spacing_tol(ref[0]))]
        bwd += [_ratio(a, b, BF16_SPACING * b.float().abs() + 1e-5 * t)
                for a, b, t in zip(got[1:], ref[1:], terms) if b is not None]
        out.append((max(e for e, _ in bwd), max(r for _, r in bwd)))
    return out


def run_norm_checks(torch, dev, results):
    """layernorm / rmsnorm forward and backward against their plain
    versions on the same bf16 inputs (bf16 scale and bias, as the compute
    copies of the path); the backward bit-identical across two calls;
    the device ms of each kernel of a call (torch.profiler), the plan, and
    the ptxas registers, spills and stack of every instantiation; library:
    F.layer_norm / F.rms_norm (CUDA-graph replay, as the kernels) and
    their autograd backward, as device time (the profiler's sum over its
    kernels) and eager (host included)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import layernorm as TL
    for inst, (regs, spill, stack) in sorted(norm_ptxas().items()):
        log(f"[ptxas] {inst}: {regs} registers, {spill} bytes spill stores, "
            f"{stack} bytes stack frame")
    sms = _build.sm_count(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for fam, name, n, d, eps, dirs in norm_cases():
        ln = fam == "layernorm"
        need_ds = "bwd" in dirs
        make = norm_make(torch, dev, gen, fam, n, d, eps)
        kf, kb, pf, pb = norm_calls(fam, eps, need_ds)
        args = make()
        y = kf(*args)[0], pf(*args)[0]
        got, again = kb(*args), kb(*args)
        torch.cuda.synchronize()
        same = all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))
        (fwd_err, fwd_ratio), (bwd_err, bwd_ratio) = norm_errors(fam, need_ds, args, y, got)

        # bytes each input read once, each output written once
        stat_b = (8 if ln else 4) * n
        par_b = (2 if ln else 1) * 2 * d
        fwd_bytes = 2 * n * d * 2 + par_b + stat_b
        bwd_bytes = 3 * n * d * 2 + 2 * d + stat_b + (par_b if need_ds else 0)
        fb = bound(fwd_bytes, (8 if ln else 4) * n * d, PEAK_FP32)
        bb = bound(bwd_bytes, (16 if ln else 12) * n * d, PEAK_FP32)
        sets = [make() for _ in range(n_sets(bwd_bytes))]
        lf = ((lambda x_, s_, b_, d_, m_, r_: F.layer_norm(x_, (d,), s_, b_, eps)) if ln
              else (lambda x_, s_, b_, d_, m_, r_: F.rms_norm(x_, (d,), s_, eps)))

        # library backward: autograd through the library forward of each
        # operand set (the scale's gradient only where the kernel gives it)
        def lib_graph(x_, s_, b_, d_, m_, r_):
            leaves = [x_.detach().clone().requires_grad_(True)]
            leaves += [p.detach().clone().requires_grad_(True)
                       for p in ((s_, b_) if ln else (s_,))] if need_ds else []
            s_in = leaves[1] if need_ds else s_
            out = (F.layer_norm(leaves[0], (d,), s_in, leaves[2] if need_ds else b_, eps)
                   if ln else F.rms_norm(leaves[0], (d,), s_in, eps))
            return out, leaves, d_
        lib_sets = [lib_graph(*s) for s in sets]
        lb = lambda o_, l_, d_: torch.autograd.grad(o_, l_, d_, retain_graph=True)  # noqa: E731
        plans = {"fwd": TL._norm_fwd_plan(n, d, sms),
                 "bwd": TL._norm_bwd_plan(n, d, sms, sums=need_ds)}
        rows = []
        for kernel, fn, plain, err, ratio, (bms, bby) in (
                (f"{fam}_fwd", kf, pf, fwd_err, fwd_ratio, fb),
                (f"{fam}_bwd", kb, pb, bwd_err, bwd_ratio, bb)):
            fwd = kernel.endswith("_fwd")
            if not (("fwd" in dirs) if fwd else ("bwd" in dirs or "bwd_dx" in dirs)):
                continue
            kernel_ms = time_ms(torch, fn, sets)
            plain_ms = time_ms(torch, plain, sets[:2], iters=4)
            split = {k: v for k, v in kernel_split_ms(torch, fn, sets, NORM_KERNELS).items()
                     if v > 0}
            row = dict(kernel=kernel, case=name, shape=f"[{n},{d}] bf16 eps={eps}"
                       + ("" if fwd or need_ds else " dx only"),
                       max_abs_err=err, err_over_tol=ratio, ok=ratio <= 1.0,
                       kernel_ms=kernel_ms, plain_ms=plain_ms, split_ms=split,
                       plan=plans["fwd" if fwd else "bwd"]._asdict(),
                       bound_ms=bms, bound_by=bby)
            if fwd:
                row.update(library_ms=time_ms(torch, lf, sets), library_timing="graph")
            else:
                row.update(library_ms=device_sum_ms(torch, lb, lib_sets),
                           library_timing="device",
                           library_eager_ms=eager_ms(torch, lb, lib_sets),
                           bit_identical=same)
                row["ok"] = row["ok"] and same
            rows.append(row)
        del lib_sets, sets
        for row in rows:
            results.append(row)
            extra = ("" if row["kernel"].endswith("_fwd") else
                     f"; eager {row['library_eager_ms']:.4f}; bit_identical={row['bit_identical']}")
            log(f"[kernel] {row['kernel']:14s} {name:16s} {row['shape']:36s} "
                f"err={row['max_abs_err']:.3e} err/tol={row['err_over_tol']:.3f} "
                f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}{extra}) bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) plan={tuple(row['plan'].values())} split_ms="
                + " ".join(f"{k} {v:.4f}" for k, v in row["split_ms"].items()))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 2, fp32: the fp32 builds of training at precision=fp32
# ---------------------------------------------------------------------------

# The fp32 builds against their plain versions. Attention: the kernels
# compute the logits, P V and the five backward products as fp32 FMAs (no
# TF32, no bf16 rounding). The plain version is evaluated in fp64 on the
# same fp32 inputs (`attention_reference` and the backward's plain passes
# promote fp64 inputs), so the bound holds the kernel's own rounding: the
# bf16 bounds' form with fp32's unit, `fp32_unit(n)` for a sum of n
# products (`attention_fwd_bound_fp32`; the backward's
# `attention_bwd_bound` at those units; the passes likewise). max|err| /
# rms(ref) is printed beside: fp32 arithmetic does not reach 1e-5 of rms
# at these shapes (the fp32 plain version reads 1.5-3.5e-5 against fp64 at
# the ViT's and the LLaMA's on an H100: PERF.md), so it is not the bound. The
# fp32 plain version's and a TF32 plain version's err/tol are printed too:
# TF32's rounding (2^-11) must exceed the bound, the fp32 kernel must not.
# Norms: kernel and plain version compute the same fp32 arithmetic; the
# row statistics (mean, variance, and the backward's two row means) sum d
# values in another order, a random walk of d roundings of 2^-24 each,
# with a margin of 4: y and dx are held to 2^-22 sqrt(d) (|ref| + rms(ref))
# (the fp32 form of the bf16 bound's one spacing of |ref| plus a term of
# rms(ref)); dscale / dbias, sums over n rows, to 2^-22 sqrt(n) sum|terms|
# + 2^-23 |ref|. The margin: a numpy model of the fp32 kernels read at
# most 0.07 of these bounds at the training shapes, and inputs rounded to
# TF32 at least 2.8 (margin 16 would pass TF32 at 1025 keys).
FP32_SUM_U = 2.0 ** -22


def _case(name):
    """The phase-2 attention case named `name`, with its head dim last."""
    case = [c for c in phase2_attention_cases() if c[0] == name][0]
    return (*case, head_dim(case))


# Attention at fp32: the training shapes of the LoRA step (the ViT's
# non-causal [12,1025,16,64] read from its qkv projection, the LLM's causal
# GQA with the training batch's key validity), a causal case with key masks
# and a q_offset (the queries against a 770-slot cache), and each built
# head dim (128: the LLaMA `large`; 16: JAX's tiny(); 32:
# small_shardable's LLM), forward and backward.
FP32_ATTENTION = ("vit_train", "llm_train", "llm_queries", "base_large", "tiny_llm",
                  "shardable_llm")
FP32_ATTN_INSTANCES = {16: "tiny_llm_fp32", 32: "shardable_llm_fp32", 64: "llm_train_fp32",
                       128: "base_large_fp32"}
BWD_F32_KERNELS = ("bwd_prep_f32_kernel", "bwd_dkdv_f32_kernel", "bwd_dq_f32_kernel")


def fp32_attention_inputs(torch, dev):
    """For each FP32_ATTENTION case: the case, its kv_valid, its first fp32
    inputs (q, k, v, dout; the ViT's q/k/v strided views of one [B, T, 3 H
    D] projection) and its timing sets, from one generator seeded 11."""
    gen = torch.Generator(device=dev).manual_seed(11)
    train_valid = train_llm_valid(torch, dev)
    for name in FP32_ATTENTION:
        case = _case(name)
        _, B, T, S, HQ, HK, causal, q_off, ranges, strided, D = case
        valid = None
        if ranges == "train":
            valid = train_valid
        elif ranges is not None:
            valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
            for lo, hi in ranges:
                valid[:, lo:hi] = True

        def make():
            if strided:
                qkv = torch.randn(B, T, 3 * HQ * D, generator=gen, device=dev)
                q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D)
                           for i in range(3))
            else:
                q = torch.randn(B, T, HQ, D, generator=gen, device=dev)
                k, v = (torch.randn(B, S, HK, D, generator=gen, device=dev) for _ in range(2))
            return q, k, v, torch.randn(B, T, HQ, D, generator=gen, device=dev)
        first = make()
        nbytes = 4 * (2 * B * T * HQ * D + 2 * B * S * HK * D)
        yield case, valid, first, [make() for _ in range(min(8, n_sets(nbytes)))]


def _rel(got, ref, mask=None):
    """(max |got - ref|, that over rms(ref)), over `mask` where given."""
    diff = (got.double() - ref.double()).abs()
    ref = ref.double()
    if mask is not None:
        diff, ref = diff[mask], ref[mask]
    rms = float(ref.square().mean().sqrt()) if ref.numel() else 0.0
    err = float(diff.max()) if diff.numel() else 0.0
    return err, err / max(rms, 1e-30)


def fp32_unit(n):
    """The fp32 form of a rounding bound's unit for a sum of n products: a
    random walk of n roundings of 2^-24 each, with a margin of 4
    (FP32_SUM_U sqrt(n))."""
    return FP32_SUM_U * math.sqrt(n)


def _logit_mags(torch, FA, q, k, valid, causal, q_off):
    """(P, A) [B, HQ, T, S] in fp64: the softmax and scale sum_d |q_d| |k_d|
    (what the fp32 rounding of a logit scales with), 0 on hidden pairs."""
    HQ, HK = q.shape[2], k.shape[2]
    scale, off = FA._defaults(q, k, None, q_off)
    logits, mask = FA._scaled_logits(q, k, valid, causal, scale, off)
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1).nan_to_num(0.0)
    a = scale * torch.einsum("bthd,bshd->bhts", q.abs(),
                             k.abs().repeat_interleave(HQ // HK, dim=2))
    return p, a.masked_fill(~mask, 0.0)


def attention_fwd_bound_fp32(torch, FA, q, k, v, valid, causal, q_off, ref):
    """Per output element, the fp32 form of the forward's rounding bound
    about `ref` (the plain version in fp64 on the same inputs): each logit
    carries fp32_unit(D) A (A = scale sum |q| |k|), so P a relative error
    of that, and O = sum P V the sum's own fp32_unit(S): |err| <= u (sum_s
    P |V| (1 + A) + |ref| (1 + max_s A)) + 1e-6 rms(ref), u =
    fp32_unit(S + D). A TF32 product (2^-11) or a bf16 P (2^-9) exceeds
    it."""
    HQ, HK, D, S = q.shape[2], k.shape[2], q.shape[3], k.shape[1]
    p, a = _logit_mags(torch, FA, q, k, valid, causal, q_off)
    terms = torch.einsum("bhts,bshd->bthd", p * (1 + a),
                         v.abs().repeat_interleave(HQ // HK, dim=2))
    amax = a.amax(-1).transpose(1, 2)[..., None]
    rms = float(ref.square().mean().sqrt())
    return fp32_unit(S + D) * (terms + ref.abs() * (1 + amax)) + 1e-6 * rms


def _err_over_tol(got, ref, tol, mask=None):
    """(max |got - ref|, max |got - ref| / tol), over `mask` where given."""
    diff = (got.double() - ref.double()).abs()
    ratio = diff / tol
    if mask is not None:
        diff, ratio = diff[mask], ratio[mask]
    return (float(diff.max()) if diff.numel() else 0.0,
            float(ratio.max()) if ratio.numel() else 0.0)


def run_fp32_attention_checks(torch, dev, results):
    """The fp32 builds of flash_attn_fwd / flash_attn_bwd, against the
    plain versions in fp64 on the same fp32 inputs, each within the fp32
    form of its rounding bound (`attention_fwd_bound_fp32`,
    `attention_bwd_bound` at fp32_unit, the passes likewise); err/rms, the
    fp32 plain version's and a TF32 plain version's readings beside."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    regs_f = ptxas_usage("flash_attn_fwd")
    regs_b = ptxas_usage("flash_attn_bwd")

    def tf32(fn, *a):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn(*a)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for case, valid, first, sets in fp32_attention_inputs(torch, dev):
        name, B, T, S, HQ, HK, causal, q_off, _, _, D = case
        name = f"{name}_fp32"
        q, k, v, dout = first
        d = FA._instance_dim(D)
        off = S - T if q_off is None else q_off
        f64 = [x.double() for x in (q, k, v)]
        pairs, empty_rows, mask = visible_pairs(torch, dev, B, T, S, causal, q_off, valid)
        # forward
        out, lse = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off, return_lse=True)
        again = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ref = FA.attention_reference(*f64, valid, causal, None, q_off)
        tol = attention_fwd_bound_fp32(torch, FA, *f64, valid, causal, q_off, ref)
        err, ratio = _err_over_tol(out, ref, tol)
        rel = _rel(out, ref)[1]
        plain32 = _err_over_tol(FA.attention_reference(q, k, v, valid, causal, None, q_off),
                                ref, tol)[1]
        tf32_ratio = _err_over_tol(tf32(FA.attention_reference, q, k, v, valid, causal, None,
                                        q_off), ref, tol)[1]
        del tol
        ref_lse = FA.attention_lse_reference(f64[0], f64[1], valid, causal, None, q_off)
        fin = torch.isfinite(ref_lse)
        # the lse: a logit's bound in base 2, relative to 1 + |lse|
        lse_rel = float(((lse.double() - ref_lse).abs() / (1 + ref_lse.abs()))[fin].max()) \
            if fin.any() else 0.0
        ok = (out.dtype == torch.float32 and same and ratio <= 1.0
              and lse_rel <= fp32_unit(S + D) and torch.equal(torch.isfinite(lse), fin))
        del ref, ref_lse
        plan = FA._fwd_plan(B, T, S, HQ, HK, causal, off, D=D, dtype=torch.float32)
        kname = f"flash_fwd_f32_kernel<{d}>"
        fwd_bytes = 4 * (2 * B * T * HQ * D + 2 * B * S * HK * D) + (B * S if valid is not None
                                                                     else 0)
        bms, bby = bound(fwd_bytes, 4 * D * pairs * HQ, PEAK_FP32)
        fsets = [s[:3] for s in sets]
        kernel_ms = time_ms(torch, lambda q_, k_, v_: FA.flash_attn_fwd(
            q_, k_, v_, valid, causal, None, q_off), fsets)
        plain_ms = time_ms(torch, lambda q_, k_, v_: FA.attention_reference(
            q_, k_, v_, valid, causal, None, q_off), fsets[:2], iters=2)
        am = mask[:, None] if causal or valid is not None else None
        library_ms = time_ms(torch, lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2), attn_mask=am,
            enable_gqa=HQ != HK), fsets)
        row = dict(kernel="flash_attn_fwd", dtype="fp32", case=name,
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{S},{HK},{D}] fp32", head_dim=D,
                   causal=causal, q_offset=q_off, empty_rows=empty_rows, max_abs_err=err,
                   err_over_tol=ratio, err_over_rms=rel, lse_err_rel=lse_rel,
                   plain_fp32_err_over_tol=plain32, tf32_err_over_tol=tf32_ratio,
                   ok=ok, bit_identical=same, path=plan.path, grid=plan.grid,
                   smem_bytes=plan.smem_bytes, registers=regs_f.get(kname, (0, 0))[0],
                   spill_bytes=regs_f.get(kname, (0, 0))[1], kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] flash_attn_fwd {name:20s} {row['shape']:38s} err={err:.3e} "
            f"err/tol={ratio:.3f} (the fp32 bound about the fp64 plain version; the fp32 "
            f"plain version {plain32:.3f}, a TF32 one {tf32_ratio:.1f}) err/rms={rel:.3e} "
            f"lse err/(1+|lse|)={lse_rel:.2e} bit-identical={same} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA fp32) bound_ms={bms:.4f} ({bby}) {kname} "
            f"registers={row['registers']} spill={row['spill_bytes']} smem={plan.smem_bytes}")
        # backward, from the fp32 forward's o and lse
        *grads, ds = FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, None, q_off,
                                       return_ds=True)
        again = FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, None, q_off)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        args64 = (*f64, valid, out.double(), dout.double(), lse, causal, None, q_off)
        refs = FA.attention_bwd_reference(*args64)
        # dq sums over the keys, dk / dv over the group's rows; dS's terms over D
        units = (fp32_unit(S + D),) + (fp32_unit(T * HQ // HK + D),) * 2
        tols = FA.attention_bwd_bound(*args64[:8], refs, None, q_off, u=units, rms_slack=1e-6)
        reads = [_err_over_tol(a, b, t) for a, b, t in zip(grads, refs, tols)]
        rels = [_rel(a, b)[1] for a, b in zip(grads, refs)]
        plain32 = [_err_over_tol(a, b, t)[1] for a, b, t in zip(
            FA.attention_bwd_reference(q, k, v, valid, out, dout, lse, causal, None, q_off),
            refs, tols)]
        tf32s = [_err_over_tol(a, b, t)[1] for a, b, t in zip(
            tf32(FA.attention_bwd_reference, q, k, v, valid, out, dout, lse, causal, None,
                 q_off), refs, tols)]
        del refs, tols
        # the passes: the dS^T scratch on the pairs it writes (dS's terms P (|dO| |V| +
        # |delta|) and its logit's A), dq from the kernel's own scratch (scale |dS| |K|)
        bplan = FA._bwd_plan(B, T, S, HQ, HK, causal, off, D, torch.float32)
        written = FA._pair_mask(bplan.written, bplan, FA._live_key_tiles(valid, B, S, dev))
        written = written.expand(ds.shape)
        ds_ref = FA.attention_ds_reference(*args64)
        ds_tol = FA.attention_ds_reference(*args64, abs_terms=True)
        _, a = _logit_mags(torch, FA, f64[0], f64[1], valid, causal, q_off)
        a = _to_scratch(torch, a, bplan)
        ds_tol = fp32_unit(3 * D) * (ds_tol + ds_ref.abs() * (1 + a))
        del a
        ds_ratio = _err_over_tol(ds, ds_ref, ds_tol + 1e-6 * float(
            ds_ref[written].square().mean().sqrt()), written)[1]
        del ds_ref, ds_tol
        dq_ref = FA.attention_dq_from_ds_reference(ds.double(), f64[1], valid, T, causal,
                                                   None, q_off)
        dq_terms = FA.attention_dq_from_ds_reference(ds.double(), f64[1], valid, T, causal,
                                                     None, q_off, abs_terms=True)
        dq_ratio = _err_over_tol(grads[0], dq_ref, fp32_unit(S) * (dq_terms + dq_ref.abs())
                                 + 1e-6 * float(dq_ref.square().mean().sqrt()))[1]
        del written, ds, dq_ref, dq_terms
        ratios = [r for _, r in reads]
        ok_b = (all(g.dtype == torch.float32 for g in grads) and same
                and max(ratios + [ds_ratio, dq_ratio]) <= 1.0)
        bwd_bytes = 4 * (4 * B * T * HQ * D + 4 * B * S * HK * D + B * HQ * T) + (
            B * S if valid is not None else 0)
        bms, bby = bound(bwd_bytes, 10 * D * pairs * HQ, PEAK_FP32)

        def kernel(q_, k_, v_, d_, o_=out, l_=lse):
            return FA.flash_attn_bwd(q_, k_, v_, valid, o_, d_, l_, causal, None, q_off)
        kernel_ms = time_ms(torch, kernel, sets)
        split = kernel_split_ms(torch, kernel, sets, BWD_F32_KERNELS)
        plain_ms = time_ms(torch, lambda q_, k_, v_, d_: FA.attention_bwd_reference(
            q_, k_, v_, valid, out, d_, lse, causal, None, q_off), sets[:2], iters=2)
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in xs),
                                                 attn_mask=am, enable_gqa=HQ != HK)
        library_ms = eager_ms(torch, lambda: torch.autograd.grad(
            lib_out, xs, dout.transpose(1, 2), retain_graph=True), [()], iters=10)
        del lib_out, xs
        regs = {k_: v_ for k_, v_ in regs_b.items()
                if k_.split("<")[0] in BWD_F32_KERNELS and k_.endswith(f"<{d}>")}
        row = dict(kernel="flash_attn_bwd", dtype="fp32", case=name,
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{S},{HK},{D}] fp32", head_dim=D,
                   causal=causal, q_offset=q_off, empty_rows=empty_rows,
                   max_abs_err=max(e for e, _ in reads), err_over_tol=max(ratios),
                   err_over_tol_dq_dk_dv=ratios, err_over_rms_dq_dk_dv=rels,
                   err_over_rms=max(rels), plain_fp32_err_over_tol=plain32,
                   tf32_err_over_tol=tf32s, ds_pass_err_over_tol=ds_ratio,
                   dq_pass_err_over_tol=dq_ratio, bit_identical=same, ok=ok_b,
                   kernel_ms=kernel_ms, split_ms=split, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby,
                   ds_bytes=bplan.ds_bytes, ds_dtype=str(bplan.ds_dtype),
                   dkdv_smem=bplan.dkdv_smem, ptxas=regs)
        results.append(row)
        log(f"[kernel] flash_attn_bwd {name:20s} {row['shape']:38s} err/tol dq dk dv "
            f"{' '.join(f'{r:.3f}' for r in ratios)} (the fp32 plain version "
            f"{' '.join(f'{r:.3f}' for r in plain32)}, a TF32 one "
            f"{' '.join(f'{r:.1f}' for r in tf32s)}); err/rms "
            f"{' '.join(f'{r:.2e}' for r in rels)}; dS^T pass {ds_ratio:.3f}, dq from the "
            f"kernel's dS {dq_ratio:.3f} bit-identical={same} {'OK' if ok_b else 'FAIL'} "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"(SDPA fp32 backward) bound_ms={bms:.4f} ({bby})")
        log(f"[kernel] flash_attn_bwd {name:20s} device ms a call by kernel: "
            + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in split.items())
            + f" | fp32 dS^T scratch {bplan.ds_bytes} bytes, dK/dV smem {bplan.dkdv_smem}"
            + " | ptxas registers (spill bytes): "
            + ", ".join(f"{k_} {r} ({sp})" for k_, (r, sp) in regs.items()))
        del sets, out, lse, grads
        torch.cuda.empty_cache()


def _to_scratch(torch, x, plan):
    """x [B, HQ, T, S] in the dS^T scratch's layout (`attention_ds_reference`:
    key-major tiles, 0 past S and T)."""
    B, HQ, T, S = x.shape
    out = torch.zeros((B, HQ, plan.n_kt * 64, plan.n_qt * 64), dtype=x.dtype, device=x.device)
    out[:, :, :S, :T] = x.transpose(2, 3)
    return out.view(B, HQ, plan.n_kt, 64, plan.n_qt, 64).permute(0, 1, 2, 4, 3, 5).contiguous()


def run_fp32_dropout_checks(torch, dev, results):
    """dropout's fp32 instances at DROPOUT_CASES: bit-equal to dropout_plain
    on fp32 inputs, the keep mask equal to the bf16 instance's at the same
    seed and flat index, keep rate 0.9 +- 0.002; library: F.dropout fp32."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import dropout as DO
    gen = torch.Generator(device=dev).manual_seed(12)
    seed, rate = 0x243F6A8885A308D3, 0.1
    for name, shape, block in DROPOUT_CASES:
        def make():
            return (torch.randn(shape, generator=gen, device=dev),)
        (x,) = make()
        out = DO.dropout(x, seed, rate, block)
        ref = DO.dropout_plain(x, seed, rate, block)
        # the keep masks of both instances at this seed, from inputs of ones
        keep = DO.dropout(torch.ones_like(x), seed, rate, block) != 0
        keep16 = DO.dropout(torch.ones_like(x, dtype=torch.bfloat16), seed, rate, block) != 0
        torch.cuda.synchronize()
        same_mask = torch.equal(keep, keep16)
        keep_rate = float(keep.float().mean())
        ok = (out.dtype == torch.float32 and torch.equal(out, ref) and same_mask
              and abs(keep_rate - (1 - rate)) <= 0.002)
        nbytes = 2 * 4 * x.numel()
        bms, bby = bound(nbytes, 0)
        sets = [make() for _ in range(n_sets(nbytes))]
        kernel_ms = time_ms(torch, lambda x_: DO.dropout(x_, seed, rate, block), sets)
        plain_ms = time_ms(torch, lambda x_: DO.dropout_plain(x_, seed, rate, block), sets[:2],
                           iters=2)
        library_ms = time_ms(torch, lambda x_: F.dropout(x_, rate, training=True), sets)
        row = dict(kernel="dropout", dtype="fp32", case=f"{name}_fp32",
                   shape=f"[{','.join(map(str, shape))}] fp32 p={rate}" + (
                       f" block {block}" if block else ""),
                   max_abs_err=float((out - ref).abs().max()), err_over_rms=0.0,
                   bit_equal=torch.equal(out, ref), mask_equals_bf16=same_mask,
                   keep_rate=keep_rate, ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] dropout        {name + '_fp32':20s} {row['shape']:44s} bit_equal="
            f"{row['bit_equal']} mask equal to the bf16 instance's={same_mask} keep_rate="
            f"{keep_rate:.5f} {'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (F.dropout fp32) "
            f"bound_ms={bms:.4f} ({bby})")


# The norms at fp32: the LoRA step's training rows (the ViT's LayerNorm,
# the projector's, the LLM's RMSNorm with its scale trained and frozen)
FP32_NORMS = (("layernorm", "vit", 12 * 1025, 1024, 1e-6, ("fwd", "bwd")),
              ("layernorm", "projector", 12 * 256, 4096, 1e-5, ("fwd", "bwd")),
              ("rmsnorm", "llm_train", 6 * 798, 896, 1e-6, ("fwd", "bwd")),
              ("rmsnorm", "llm_train_frozen", 6 * 798, 896, 1e-6, ("bwd_dx",)))


def run_fp32_norm_checks(torch, dev, results):
    """The norm kernels' fp32 instances (fp32 x, dy and scale, as the
    compute copies at precision=fp32) against their plain versions on the
    same inputs, within FP32_SUM_U's bound; the backward bit-identical
    across two calls; library: F.layer_norm / F.rms_norm fp32 (graph) and
    their autograd backward (device time)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import layernorm as TL
    sms = _build.sm_count(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    for fam, name, n, d, eps, dirs in FP32_NORMS:
        ln = fam == "layernorm"
        need_ds = "bwd" in dirs

        def make():
            x = 2 * torch.randn(n, d, generator=gen, device=dev) + 0.3
            dy = torch.randn(n, d, generator=gen, device=dev)
            scale = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            bias = 0.1 * torch.randn(d, generator=gen, device=dev)
            if ln:
                _, mean, rstd = TL.layernorm_fwd_plain(x, scale, bias, eps)
            else:
                (_, rstd), mean = TL.rmsnorm_fwd_plain(x, scale, eps), None
            return x, scale, bias, dy, mean, rstd
        kf, kb, pf, pb = norm_calls(fam, eps, need_ds)
        args = make()
        x, scale, bias, dy, mean, rstd = args
        row_tol = FP32_SUM_U * math.sqrt(d)

        def tol_rows(r):
            return row_tol * (r.abs() + float(r.square().mean().sqrt()))
        y, yp = kf(*args)[0], pf(*args)[0]
        got, again = kb(*args), kb(*args)
        torch.cuda.synchronize()
        same = all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))
        ref = pb(*args)
        xhat = (x - mean[:, None]) * rstd[:, None] if ln else x * rstd[:, None]
        terms = [(dy * xhat).abs().sum(0), dy.abs().sum(0)]
        fwd_read = _ratio(y, yp, tol_rows(yp))
        bwd_reads = [_ratio(got[0], ref[0], tol_rows(ref[0]))]
        bwd_reads += [_ratio(a, b, FP32_SUM_U * math.sqrt(n) * t + 2.0 ** -23 * b.abs())
                      for a, b, t in zip(got[1:], ref[1:], terms) if b is not None]
        fwd_bytes = 2 * n * d * 4 + (2 if ln else 1) * 4 * d + (8 if ln else 4) * n
        bwd_bytes = 3 * n * d * 4 + 4 * d + (8 if ln else 4) * n + (
            (2 if ln else 1) * 4 * d if need_ds else 0)
        fb = bound(fwd_bytes, (8 if ln else 4) * n * d, PEAK_FP32)
        bb = bound(bwd_bytes, (16 if ln else 12) * n * d, PEAK_FP32)
        sets = [make() for _ in range(min(8, n_sets(bwd_bytes)))]
        lf = ((lambda x_, s_, b_, d_, m_, r_: F.layer_norm(x_, (d,), s_, b_, eps)) if ln
              else (lambda x_, s_, b_, d_, m_, r_: F.rms_norm(x_, (d,), s_, eps)))

        def lib_graph(x_, s_, b_, d_, m_, r_):
            leaves = [x_.detach().clone().requires_grad_(True)]
            leaves += [p.detach().clone().requires_grad_(True)
                       for p in ((s_, b_) if ln else (s_,))] if need_ds else []
            s_in = leaves[1] if need_ds else s_
            out = (F.layer_norm(leaves[0], (d,), s_in, leaves[2] if need_ds else b_, eps)
                   if ln else F.rms_norm(leaves[0], (d,), s_in, eps))
            return out, leaves, d_
        lib_sets = [lib_graph(*s) for s in sets]
        lb = lambda o_, l_, d_: torch.autograd.grad(o_, l_, d_, retain_graph=True)  # noqa: E731
        plans = {"fwd": TL._norm_fwd_plan(n, d, sms, torch.float32),
                 "bwd": TL._norm_bwd_plan(n, d, sms, sums=need_ds, dtype=torch.float32)}
        for kernel, fn, plain, (err, ratio), (bms, bby) in (
                (f"{fam}_fwd", kf, pf, fwd_read, fb),
                (f"{fam}_bwd", kb, pb, (max(e for e, _ in bwd_reads),
                                        max(r for _, r in bwd_reads)), bb)):
            fwd = kernel.endswith("_fwd")
            if not (("fwd" in dirs) if fwd else ("bwd" in dirs or "bwd_dx" in dirs)):
                continue
            out_t = y if fwd else got[0]
            row = dict(kernel=kernel, dtype="fp32", case=f"{name}_fp32",
                       shape=f"[{n},{d}] fp32 eps={eps}" + ("" if fwd or need_ds
                                                            else " dx only"),
                       max_abs_err=err, err_over_tol=ratio,
                       ok=ratio <= 1.0 and out_t.dtype == torch.float32 and (fwd or same),
                       kernel_ms=time_ms(torch, fn, sets),
                       plain_ms=time_ms(torch, plain, sets[:2], iters=4),
                       split_ms={k_: v_ for k_, v_ in kernel_split_ms(
                           torch, fn, sets, NORM_KERNELS).items() if v_ > 0},
                       plan=plans["fwd" if fwd else "bwd"]._asdict(), bound_ms=bms,
                       bound_by=bby)
            if fwd:
                row.update(library_ms=time_ms(torch, lf, sets), library_timing="graph")
            else:
                row.update(library_ms=device_sum_ms(torch, lb, lib_sets),
                           library_timing="device", bit_identical=same)
            results.append(row)
            log(f"[kernel] {kernel:14s} {name + '_fp32':20s} {row['shape']:36s} "
                f"err={err:.3e} err/tol={ratio:.3f} (FP32_SUM_U) "
                f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}) bound_ms={bms:.4f} ({bby}) "
                f"plan={tuple(row['plan'].values())} split_ms="
                + " ".join(f"{k_} {v_:.4f}" for k_, v_ in row["split_ms"].items()))
        del lib_sets, sets
    torch.cuda.empty_cache()


# The fused CE at fp32: the training shape (6 x 160 answer positions, the
# tied 151674-row head), with and without dW; a ragged one (N, V off the
# tiles, labels out of range); a width that is zero-padded (H 100)
FP32_CE_CASES = (("train", 960, 896, 151674, False), ("train_dw", 960, 896, 151674, True),
                 ("ragged", 100, 128, 1111, True), ("width_100", 100, 100, 1111, True))
CE_F32_KERNELS = ("ce_fwd_tile_f32_kernel", "ce_fwd_finalize_kernel", "ce_dlogits_f32_kernel",
                  "ce_dh_f32_kernel", "f32_reduce_kernel", "ce_dw_f32_kernel")
CE_BWD_F32_KERNELS = ("ce_dlogits_f32_kernel", "ce_dh_f32_kernel", "f32_reduce_kernel",
                      "ce_dw_f32_kernel")


def _rms(x):
    return float(x.double().square().mean().sqrt())


def run_fp32_ce_checks(torch, dev, results):
    """fused_ce's fp32 build at FP32_CE_CASES against the plain versions in
    fp64 on the same fp32 inputs: ce and logz within fp32_unit(H) times
    their |h| |w| sums (`fused_ce_fwd_plain(abs_terms=True)`) plus
    fp32_unit(V) (the V exponentials' sum) and 2^-22 |ref|; dh within
    fp32_unit(H + V) (sum |terms| + |ref|), dW within fp32_unit(H + N) of
    the same, each + 1e-6 rms(ref); pass by pass, the fp32 dlogits scratch
    within fp32_unit(H) (|ref| + g p A) (A the logit's |h| |w| sum) and
    exactly 0 past V, dh and dW within fp32_unit(V) / fp32_unit(N) of the
    plain products of the kernel's own scratch; bit-identical across two
    calls. Library: F.cross_entropy(F.linear(h, w)) at fp32, TF32 off, and
    its autograd backward (eager)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import fused_ce as TC
    gen = torch.Generator(device=dev).manual_seed(14)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regs = {k: v for k, v in ptxas_usage("fused_ce").items()
            if k.split("<")[0] in CE_F32_KERNELS}
    for name, N, H, V, with_dw in FP32_CE_CASES:
        case = f"{name}_fp32"
        h = torch.randn(N, H, generator=gen, device=dev)
        w = 0.02 * torch.randn(V, H, generator=gen, device=dev)
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if not name.startswith("train"):
            labels[0], labels[-1] = -100, V
        g = (torch.rand(N, generator=gen, device=dev) < 0.8).float() / (0.8 * N)
        h64, w64, g64 = h.double(), w.double(), g.double()
        # forward
        logz, ce = TC.fused_ce_fwd(h, labels, w)
        again = TC.fused_ce_fwd(h, labels, w)
        torch.cuda.synchronize()
        same_f = torch.equal(again[0], logz) and torch.equal(again[1], ce)
        rlogz, rce = TC.fused_ce_fwd_plain(h64, labels, w64)
        lz_terms, ce_terms = TC.fused_ce_fwd_plain(h64, labels, w64, abs_terms=True)

        def fwd_tol(ref, terms):
            return fp32_unit(H) * terms + fp32_unit(V) + 2.0 ** -22 * ref.abs()
        ce_tol, lz_tol = fwd_tol(rce, ce_terms), fwd_tol(rlogz, lz_terms)
        del lz_terms, ce_terms
        fwd_reads = [_err_over_tol(ce, rce, ce_tol), _err_over_tol(logz, rlogz, lz_tol)]
        lz32, ce32 = TC.fused_ce_fwd_plain(h, labels, w)
        fwd_plain32 = max(_err_over_tol(ce32, rce, ce_tol)[1],
                          _err_over_tol(lz32, rlogz, lz_tol)[1])
        fwd_rel = _rel(ce, rce)[1]
        fwd_digest = {"ce": sha12(torch, ce), "logz": sha12(torch, logz)}
        del rlogz, rce, ce_tol, lz_tol, ce32
        # backward, from the fp32 plain logz on both sides
        dh, dwk, dl = TC.fused_ce_bwd(h, labels, w, lz32, g, with_dw, return_scratch=True)
        again = TC.fused_ce_bwd(h, labels, w, lz32, g, with_dw)
        torch.cuda.synchronize()
        same_b = torch.equal(again[0], dh) and (not with_dw or torch.equal(again[1], dwk))
        del again
        args64 = (h64, labels, w64, lz32.double(), g64)
        rdh, rdw = TC.fused_ce_bwd_plain(*args64, with_dw)
        mdh, mdw = TC.fused_ce_bwd_plain(*args64, with_dw, abs_terms=True)
        p32dh, p32dw = TC.fused_ce_bwd_plain(h, labels, w, lz32, g, with_dw)
        bwd_reads, bwd_plain32, bwd_rels = [], [], []
        for got, ref, terms, n, plain in ((dh, rdh, mdh, H + V, p32dh),
                                          (dwk, rdw, mdw, H + N, p32dw)):
            if got is None:
                continue
            tol = fp32_unit(n) * (terms + ref.abs()) + 1e-6 * _rms(ref)
            bwd_reads.append(_err_over_tol(got, ref, tol))
            bwd_plain32.append(_err_over_tol(plain, ref, tol)[1])
            bwd_rels.append(_rel(got, ref)[1])
            del tol
        del rdh, rdw, mdh, mdw, p32dh, p32dw
        # the passes: the fp32 scratch, then dh / dW from the kernel's own scratch
        plan = TC._bwd_plan(N, -(-H // TC.WIDTH_STEP) * TC.WIDTH_STEP, V, sms, torch.float32)
        ref_dl = TC.ce_dlogits_reference(*args64, plan)[:, :V]
        pa = (torch.exp(h64 @ w64.t() - args64[3][:, None]) * (h64.abs() @ w64.abs().t())
              * g64.abs()[:, None])
        pass_ratio = {"dl": _err_over_tol(dl[:, :V], ref_dl,
                                          fp32_unit(H) * (ref_dl.abs() + pa) + 1e-30)[1]}
        pad_zero = bool((dl[:, V:] == 0).all())
        del ref_dl, pa
        dl64 = dl.double()
        want = TC.ce_dh_from_scratch_reference(dl64, w64, plan)
        terms = TC.ce_dh_from_scratch_reference(dl64, w64, plan, abs_terms=True)
        pass_ratio["dh"] = _err_over_tol(dh, want, fp32_unit(V) * (terms + want.abs())
                                         + 1e-6 * _rms(want))[1]
        if with_dw:
            want = TC.ce_dw_from_scratch_reference(dl64, h64, V)
            terms = TC.ce_dw_from_scratch_reference(dl64, h64, V, abs_terms=True)
            pass_ratio["dw"] = _err_over_tol(dwk, want, fp32_unit(N) * (terms + want.abs())
                                             + 1e-6 * _rms(want))[1]
        del want, terms, dl64, dl
        bwd_digest = {k: sha12(torch, x) for k, x in (("dh", dh), ("dw", dwk)) if x is not None}
        # times
        nhv = 2 * N * H * V
        fb = bound(4 * (N * H + V * H) + 8 * N + 8 * N, nhv, PEAK_FP32)
        bb = bound(4 * (N * H + V * H) + 16 * N + 4 * N * H + (4 * V * H if with_dw else 0),
                   (3 if with_dw else 2) * nhv, PEAK_FP32)
        sets = [(h, labels, w, lz32, g)]
        lib_labels = labels.clamp(0, V - 1)
        rows = []
        if name != "train_dw":          # the forward is the same for both train cases
            rows.append(dict(
                kernel="fused_ce_fwd", err=max(e for e, _ in fwd_reads),
                ratio=max(r for _, r in fwd_reads), plain32=fwd_plain32, rel=fwd_rel,
                same=same_f, digest=fwd_digest, bound=fb, library_timing="graph",
                kernel_ms=time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_fwd(
                    h_, l_, w_), sets, iters=10),
                plain_ms=time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_fwd_plain(
                    h_, l_, w_), sets, iters=2),
                library_ms=time_ms(torch, lambda h_, l_, w_, z_, g_: F.cross_entropy(
                    F.linear(h_, w_), lib_labels, reduction="none"), sets, iters=10),
                split_ms=kernel_split_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_fwd(
                    h_, l_, w_), sets, CE_F32_KERNELS[:2], iters=3)))

        def bwd(h_, l_, w_, z_, g_):
            return TC.fused_ce_bwd(h_, l_, w_, z_, g_, with_dw)
        hx = h.detach().clone().requires_grad_(True)
        wx = w.detach().clone().requires_grad_(with_dw)
        lib_out = F.cross_entropy(F.linear(hx, wx), lib_labels, reduction="none")
        lib_in = [hx, wx] if with_dw else [hx]
        rows.append(dict(
            kernel="fused_ce_bwd", err=max(e for e, _ in bwd_reads),
            ratio=max(r for _, r in bwd_reads), plain32=max(bwd_plain32), rel=max(bwd_rels),
            same=same_b, digest=bwd_digest, bound=bb, library_timing="eager",
            pass_err_over_tol=pass_ratio, scratch_pad_zero=pad_zero,
            kernel_ms=time_ms(torch, bwd, sets, iters=10),
            plain_ms=time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_bwd_plain(
                h_, l_, w_, z_, g_, with_dw), sets, iters=2),
            library_ms=eager_ms(torch, lambda: torch.autograd.grad(
                lib_out, lib_in, g, retain_graph=True), [()], iters=5),
            split_ms=kernel_split_ms(torch, bwd, sets, CE_BWD_F32_KERNELS, iters=3),
            scratch_bytes=plan.scratch_bytes, S=plan.S))
        del lib_out, hx, wx, sets
        for r in rows:
            bms, bby = r.pop("bound")
            with_w = with_dw and r["kernel"] == "fused_ce_bwd"
            ok = (r["ratio"] <= 1.0 and r["same"]
                  and all(x <= 1.0 for x in r.get("pass_err_over_tol", {}).values())
                  and r.get("scratch_pad_zero", True))
            row = dict(kernel=r["kernel"], dtype="fp32", case=case,
                       shape=f"N={N} H={H} V={V}{' +dW' if with_w else ''} fp32",
                       max_abs_err=r["err"], err_over_tol=r["ratio"], err_over_rms=r["rel"],
                       plain_fp32_err_over_tol=r["plain32"], bit_identical=r["same"], ok=ok,
                       kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                       library_ms=r["library_ms"], library_timing=r["library_timing"],
                       bound_ms=bms, bound_by=bby, split_ms=r["split_ms"], digest=r["digest"],
                       ptxas=regs, **{k: r[k] for k in ("pass_err_over_tol", "scratch_pad_zero",
                                                        "scratch_bytes", "S") if k in r})
            results.append(row)
            log(f"[kernel] {row['kernel']:14s} {case:18s} {row['shape']:34s} "
                f"err={row['max_abs_err']:.3e} err/tol={row['err_over_tol']:.3f} (the fp32 "
                f"bound about the fp64 plain version; the fp32 plain version "
                f"{r['plain32']:.3f}) err/rms={r['rel']:.3e} bit-identical={r['same']} "
                f"{'OK' if ok else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}, fp32) bound_ms={bms:.4f} ({bby})")
            log(f"[kernel] {row['kernel']:14s} {case:18s} device ms a call by kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["split_ms"].items())
                + (f" | err/tol by pass: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r["pass_err_over_tol"].items())
                   + f", scratch zero past V {r['scratch_pad_zero']} | fp32 dlogits scratch "
                   f"{r['scratch_bytes']} bytes, S={r['S']}"
                   if "pass_err_over_tol" in r else "")
                + " | sha256 " + " ".join(f"{k} {v}" for k, v in r["digest"].items())
                + " | ptxas registers (spill bytes): "
                + ", ".join(f"{k} {n} ({sp})" for k, (n, sp) in regs.items()))
        del h, w, h64, w64, dh, dwk
        torch.cuda.empty_cache()


INT8_F32_KERNELS = ("gemv_kernel", "gemm_f32_kernel", "dx_f32_kernel", "f32_reduce_kernel")
# serving's rows (decode, verify, queries, prefill), run by `--fp32`
FP32_SERVE_M = (1, 16, 30, 640)


def fp32_int8_cases(serving):
    """(case, K, N, M, scale dtype) of the int8 forward at fp32: the int8
    base's training rows (6 x 798 at the linears, a 32-position CE chunk x
    6 at the tied head) with the training step's bf16 scale, and a K of
    100 (zero-padded to 112); with `serving`, also serving's rows
    (FP32_SERVE_M; the head at 1 and 16) with the agent's fp32 scale."""
    import torch
    lin, head = INT8_SHAPES[:4], INT8_SHAPES[4]
    cases = [(f"{n}_fp32", K, N, 4788, torch.bfloat16) for n, K, N in lin]
    cases += [("head_fp32", *head[1:], 192, torch.bfloat16), ("k100_fp32", 100, 896, 640,
                                                              torch.float32)]
    if serving:
        cases += [(f"{n}_fp32", K, N, M, torch.float32) for n, K, N in lin for M in FP32_SERVE_M]
        cases += [("head_fp32", *head[1:], M, torch.float32) for M in (1, 16)]
    return cases


def fp32_int8_dx_cases():
    """(case, M, N, K) of int8_matmul_dx at fp32: the int8 base's training
    path (int8_dx_cases without the tp = 2 ranks), and an odd N with a K of
    100 (zero-padded)."""
    return [(f"{n}_fp32", M, N, K) for n, M, N, K in int8_dx_cases()[:5]] + [
        ("n101_k100_fp32", 640, 101, 100)]


def run_fp32_int8_checks(torch, dev, results, serving=False):
    """int8_matmul and int8_matmul_dx at fp32 (`fp32_int8_cases`,
    `fp32_int8_dx_cases`) against their plain versions in fp64 on the same
    fp32 inputs: within fp32_unit(K) (forward) or fp32_unit(N) (dx) times
    (sum |terms| + |ref|) + 1e-6 rms(ref), bit-identical across two calls,
    with the plan (`_f32_plan`'s segments; the GEMV's at M = 1). Library:
    dequantize + F.linear (forward) or (g * scale) @ w_q (dx) at fp32, TF32
    off."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regs = {k: v for k, v in ptxas_usage("int8_matmul").items()
            if k.split("<")[0] in INT8_F32_KERNELS and (not k.startswith("gemv")
                                                         or k.endswith(",float>"))}
    gen = torch.Generator(device=dev).manual_seed(15)

    def weights(N, K, sdt):
        w_q, scale = QM.quantize_weight(0.02 * torch.randn(N, K, generator=gen, device=dev))
        return w_q, scale.to(sdt)
    for name, K, N, M, sdt in fp32_int8_cases(serving):
        nbytes = M * K * 4 + N * K + N * sdt.itemsize + M * N * 4

        def make():
            return (torch.randn(M, K, generator=gen, device=dev), *weights(N, K, sdt))
        x, w_q, scale = make()
        out = QM.int8_matmul(x, w_q, scale)
        same = torch.equal(QM.int8_matmul(x, w_q, scale), out)
        torch.cuda.synchronize()
        ref = QM.int8_matmul_reference(x.double(), w_q, scale)
        tol = (fp32_unit(K) * (QM.int8_matmul_reference(x.double(), w_q, scale, abs_terms=True)
                               + ref.abs()) + 1e-6 * _rms(ref))
        err, ratio = _err_over_tol(out, ref, tol)
        plain32 = _err_over_tol(QM.int8_matmul_reference(x, w_q, scale), ref, tol)[1]
        rel = _rel(out, ref)[1]
        del ref, tol
        sets = [(x, w_q, scale)] + [make() for _ in range(n_sets(nbytes) - 1)]
        bms, bby = bound(nbytes, 2 * M * N * K, PEAK_FP32)
        if M == 1:
            plan = QM._gemv_plan(N, -(-K // 16) * 16, sms)
            grid = f"gemv R={plan.rows} warps={plan.warps} blocks={plan.blocks}"
        else:
            S, seg = QM._f32_plan(M, N, -(-K // 16) * 16, sms)
            grid = f"128x128 S={S} seg={seg} blocks={-(-M // 128) * -(-N // 128) * S}"
        row = dict(kernel="int8_matmul", dtype="fp32", case=name, shape=f"M={M} K={K} N={N} fp32",
                   M=M, K=K, N=N, scale=str(sdt).replace("torch.", ""), max_abs_err=err,
                   err_over_tol=ratio, err_over_rms=rel, plain_fp32_err_over_tol=plain32,
                   bit_identical=same, ok=ratio <= 1.0 and same and out.dtype == torch.float32,
                   kernel_ms=time_ms(torch, QM.int8_matmul, sets),
                   plain_ms=time_ms(torch, QM.int8_matmul_reference, sets[:2], iters=4),
                   library_ms=time_ms(torch, lambda x_, w_, s_: F.linear(
                       x_, w_.float() * s_.float()[:, None]), sets),
                   bound_ms=bms, bound_by=bby, grid=grid, ptxas=regs)
        del sets
        results.append(row)
        log(f"[kernel] int8_matmul    {name:14s} M={M:4d} K={K:5d} N={N:6d} scale="
            f"{row['scale']:8s} err={err:.3e} err/tol={ratio:.3f} (fp32_unit(K); the fp32 "
            f"plain version {plain32:.3f}) err/rms={rel:.3e} bit-identical={same} "
            f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} (dequantize + "
            f"F.linear fp32) bound_ms={bms:.4f} ({bby}) {grid}")
    for name, M, N, K in fp32_int8_dx_cases():
        nbytes = M * N * 4 + N * K + N * 2 + M * K * 4

        def make():
            return (torch.randn(M, N, generator=gen, device=dev), *weights(N, K, torch.bfloat16))
        g, w_q, scale = make()
        dx = QM.int8_matmul_dx(g, w_q, scale)
        same = torch.equal(QM.int8_matmul_dx(g, w_q, scale), dx)
        torch.cuda.synchronize()
        ref = QM.int8_matmul_dx_reference(g.double(), w_q, scale)
        tol = (fp32_unit(N) * (QM.int8_matmul_dx_reference(g.double(), w_q, scale,
                                                            abs_terms=True) + ref.abs())
               + 1e-6 * _rms(ref))
        err, ratio = _err_over_tol(dx, ref, tol)
        plain32 = _err_over_tol(QM.int8_matmul_dx_reference(g, w_q, scale), ref, tol)[1]
        rel = _rel(dx, ref)[1]
        del ref, tol
        sets = [(g, w_q, scale)] + [make() for _ in range(n_sets(nbytes) - 1)]
        bms, bby = bound(nbytes, 2 * M * N * K, PEAK_FP32)
        S, seg = QM._f32_plan(M, -(-K // 16) * 16, N, sms)
        grid = f"128x128 S={S} seg={seg} blocks={-(-M // 128) * -(-K // 128) * S}"
        row = dict(kernel="int8_matmul_dx", dtype="fp32", case=name,
                   shape=f"M={M} N={N} K={K} fp32", M=M, N=N, K=K, max_abs_err=err,
                   err_over_tol=ratio, err_over_rms=rel, plain_fp32_err_over_tol=plain32,
                   bit_identical=same, ok=ratio <= 1.0 and same and dx.dtype == torch.float32,
                   kernel_ms=time_ms(torch, QM.int8_matmul_dx, sets),
                   plain_ms=time_ms(torch, QM.int8_matmul_dx_reference, sets[:2], iters=4),
                   library_ms=time_ms(torch, lambda g_, w_, s_: (g_ * s_.float()) @ w_.float(),
                                      sets),
                   bound_ms=bms, bound_by=bby, grid=grid, ptxas=regs)
        del sets
        results.append(row)
        log(f"[kernel] int8_matmul_dx {name:14s} M={M:4d} N={N:6d} K={K:5d} err={err:.3e} "
            f"err/tol={ratio:.3f} (fp32_unit(N); the fp32 plain version {plain32:.3f}) "
            f"err/rms={rel:.3e} bit-identical={same} {'OK' if row['ok'] else 'FAIL'} "
            f"kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} ((g * scale) @ w_q fp32) bound_ms={bms:.4f} "
            f"({bby}) {grid}")
    log("[kernel] int8 fp32 build ptxas registers (spill bytes): "
        + ", ".join(f"{k} {n} ({sp})" for k, (n, sp) in regs.items()))
    torch.cuda.empty_cache()


def run_fp32_checks(torch, dev, results, serving=False):
    """Phase 2 at fp32: the fp32 instances of the attention, dropout and
    norm kernels (precision=fp32 training), the fused CE's and the int8
    products' (with `serving`, also at serving's rows)."""
    run_fp32_attention_checks(torch, dev, results)
    run_fp32_dropout_checks(torch, dev, results)
    run_fp32_norm_checks(torch, dev, results)
    run_fp32_ce_checks(torch, dev, results)
    run_fp32_int8_checks(torch, dev, results, serving)


def norm_forced_plans(n, d, sms, sums):
    """The plans `norm_sweep` launches at one case, the plans' own among
    them: forward blocks of one row group up to 256 threads, each with the
    scale loaded early and late (blocks as `_norm_fwd_plan` counts them);
    backward grids of 1 .. the co-resident blocks an SM."""
    from simlingo_tpu_torch.kernels import layernorm as TL
    tpr = 32 * TL._norm_width(d)[1]
    fwd, threads = [], TL._THREADS
    while threads >= tpr:
        for early in (True, False):
            fwd.append(TL.NormFwdPlan(threads, min(-(-n // (threads // tpr)),
                                                   TL._FWD_BLOCKS_PER_SM * sms), early))
        threads //= 2
    rpb = TL._THREADS // tpr
    bwd = [TL.NormBwdPlan(min(-(-n // rpb), per_sm * sms))
           for per_sm in range(1, TL._bwd_resident(d, sums) + 1)]
    return fwd, list(dict.fromkeys(bwd))


def norm_sweep(torch, dev) -> int:
    """The norm kernels at every forced plan of `norm_forced_plans`, at
    every phase-2 norm case: ms a call (CUDA-graph replay of 20 calls, as
    phase 2 times; 200 below 1 MB of operands), the device ms of each
    kernel of a backward call (torch.profiler), err/tol against the plain
    version (phase 2's bound) and which plan the plans pick; rows also to
    chiprun_out/norm_sweep.json. Information for the plans."""
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import layernorm as TL
    sms = _build.sm_count(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    warm_up(torch, dev)
    for fam, name, n, d, eps, dirs in norm_cases():
        ln = fam == "layernorm"
        need_ds = "bwd" in dirs
        make = norm_make(torch, dev, gen, fam, n, d, eps)
        nbytes = 3 * n * d * 2
        sets = [make() for _ in range(n_sets(nbytes))]
        iters = 200 if nbytes < 1 << 20 else 20
        fwd_plans, bwd_plans = norm_forced_plans(n, d, sms, need_ds)
        todo = ([("fwd", p) for p in fwd_plans] if "fwd" in dirs else [])
        todo += ([("bwd", p) for p in bwd_plans] if "bwd" in dirs or "bwd_dx" in dirs else [])
        mine = {"fwd": TL._norm_fwd_plan(n, d, sms),
                "bwd": TL._norm_bwd_plan(n, d, sms, sums=need_ds)}
        for direction, plan in todo:
            kf, kb, pf, _ = norm_calls(fam, eps, need_ds,
                                       plan if direction == "fwd" else None,
                                       plan if direction == "bwd" else None)
            fn = kf if direction == "fwd" else kb
            try:
                out = fn(*sets[0])
                torch.cuda.synchronize()
            except RuntimeError as e:           # a plan the device refuses
                log(f"[sweep] {fam}_{direction} {name:16s} {tuple(plan)} REFUSED: {e}")
                rows.append(dict(kernel=f"{fam}_{direction}", case=name, plan=plan._asdict(),
                                 refused=str(e), chosen=plan == mine[direction]))
                continue
            if direction == "fwd":
                (err, ratio), = norm_errors(fam, need_ds, sets[0], (out[0], pf(*sets[0])[0]),
                                            None)
                split = {}
            else:
                (err, ratio), = norm_errors(fam, need_ds, sets[0], None, out)
                split = {k: v for k, v in kernel_split_ms(torch, fn, sets, NORM_KERNELS).items()
                         if v > 0}
            ms = time_ms(torch, fn, sets, iters=iters)
            chosen = plan == mine[direction]
            rows.append(dict(kernel=f"{fam}_{direction}", case=name, shape=[n, d],
                             plan=plan._asdict(), ms=ms, split_ms=split, err_over_tol=ratio,
                             chosen=chosen))
            log(f"[sweep] {fam}_{direction} {name:16s} [{n},{d}] {tuple(plan)} ms={ms:.4f} "
                f"err/tol={ratio:.3f}"
                + ("" if not split else " split " + " ".join(f"{k} {v:.4f}"
                                                             for k, v in split.items()))
                + ("  <- plan" if chosen else ""))
        del sets
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "norm_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    bad = [r for r in rows if r.get("err_over_tol", 0.0) > 1.0 or
           ("refused" in r and r["chosen"])]
    return 0 if not bad else 1


CE_SEED = 6


def ce_cases():
    """(case, N, H, V, compute_dw): the training shape (6 x 160 answer
    positions, the tied 151674-row head), with and without dW, and a
    ragged small one."""
    return [("train", 960, 896, 151674, False), ("train_dw", 960, 896, 151674, True),
            ("ragged", 100, 128, 1111, True)]


def ce_inputs(torch, dev, gen, N, H, V):
    """h [N, H] and the head w [V, H] (bf16), labels [N]: the CE cases'
    inputs (the first case's also `scripts/fwd_digest.py`'s)."""
    h = torch.randn(N, H, generator=gen, device=dev).bfloat16()
    w = (0.02 * torch.randn(V, H, generator=gen, device=dev)).bfloat16()
    return h, w, torch.randint(0, V, (N,), generator=gen, device=dev)


def run_ce_checks(torch, dev, results):
    """fused_ce forward and backward (dh; dh + dW) against their plain
    versions on the same bf16 inputs, at the training shape and a ragged
    one (N not a multiple of 128 rows, V not of 128 columns, labels out of
    range); library: F.cross_entropy(F.linear(h, w).float(), labels) and
    its autograd backward (eager)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import fused_ce as TC
    gen = torch.Generator(device=dev).manual_seed(CE_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regs = {k: v for k, v in ptxas_usage("fused_ce").items()
            if k.split("<")[0] in CE_BWD_KERNELS}
    for name, N, H, V, dw in ce_cases():
        h, w, labels = ce_inputs(torch, dev, gen, N, H, V)
        if name == "ragged":
            labels[0], labels[-1] = -100, V
        # the loss's cotangent: 1 / (valid answer tokens) on valid rows
        g = (torch.rand(N, generator=gen, device=dev) < 0.8).float() / (0.8 * N)
        logz, ce = TC.fused_ce_fwd(h, labels, w)
        rlogz, rce = TC.fused_ce_fwd_plain(h, labels, w)
        dh, dwk, dl = TC.fused_ce_bwd(h, labels, w, rlogz, g, dw, return_scratch=True)
        again = TC.fused_ce_bwd(h, labels, w, rlogz, g, dw)      # no atomics: same bits
        same = torch.equal(again[0], dh) and (not dw or torch.equal(again[1], dwk))
        del again
        torch.cuda.synchronize()
        fwd_digest = {"ce": sha12(torch, ce), "logz": sha12(torch, logz)}
        bwd_digest = {k: sha12(torch, x) for k, x in (("dh", dh), ("dw", dwk)) if x is not None}
        fwd_err, fwd_ratio = _ratio(ce, rce, CE_ATOL + 1e-5 * rce.abs())
        lz_err, lz_ratio = _ratio(logz, rlogz, CE_ATOL + 1e-5 * rlogz.abs())
        rdh, rdw = TC.fused_ce_bwd_plain(h, labels, w, rlogz, g, dw)
        mdh, mdw = TC.fused_ce_bwd_plain(h, labels, w, rlogz, g, dw, abs_terms=True)
        bwd = []
        for a, b, m in ((dh, rdh, mdh), (dwk, rdw, mdw)):
            if a is None:
                continue
            rms = float(b.float().square().mean().sqrt())
            bwd.append(_ratio(a, b, BF16_SPACING * (m + b.float().abs()) + 1e-6 * rms))
        del rdh, rdw, mdh, mdw
        # the passes one by one: the kernel's scratch against the plain
        # first pass (both round the fp32 dlogits to bf16: within a
        # spacing, 2^-6 |ref| with margin), its dh and dW against the plain
        # products of that scratch (2^-8 (sum|terms| + |ref|): one rounding)
        plan = TC._bwd_plan(N, H, V, sms)
        pass_ratio = {}
        ref_dl = TC.ce_dlogits_reference(h, labels, w, rlogz, g, plan)
        pass_ratio["dl"] = _ratio(dl, ref_dl, BF16_SPACING * 2 * ref_dl.float().abs() + 1e-30)[1]
        del ref_dl
        for key, got, want, terms in (
                ("dh", dh, TC.ce_dh_from_scratch_reference(dl, w, plan),
                 TC.ce_dh_from_scratch_reference(dl, w, plan, abs_terms=True)),
                ("dw", dwk, *((TC.ce_dw_from_scratch_reference(dl, h, V),
                               TC.ce_dw_from_scratch_reference(dl, h, V, abs_terms=True))
                              if dw else (None, None)))):
            if got is None:
                continue
            rms = float(want.square().mean().sqrt())
            pass_ratio[key] = _ratio(got, want, BF16_U * (terms + want.abs()) + 1e-6 * rms)[1]
            del want, terms
        del dl
        bwd_err, bwd_ratio = max(e for e, _ in bwd), max(r for _, r in bwd)
        fwd_ratio = max(fwd_ratio, lz_ratio)
        nhv = 2 * N * H * V
        fb = bound(2 * N * H + 2 * V * H + 8 * N + 8 * N, nhv)
        bb = bound(2 * N * H + 2 * V * H + 16 * N + 2 * N * H + (2 * V * H if dw else 0),
                   (3 if dw else 2) * nhv)
        sets = [(h, labels, w, rlogz, g)]
        lib_labels = labels.clamp(0, V - 1)
        lib_fwd = lambda h_, l_, w_, z_, g_: F.cross_entropy(            # noqa: E731
            F.linear(h_, w_).float(), lib_labels, reduction="none")
        rows = []
        if name != "train_dw":          # the forward is the same for both train cases
            kernel_ms = time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_fwd(h_, l_, w_), sets)
            plain_ms = time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_fwd_plain(
                h_, l_, w_), sets, iters=2)
            library_ms, how = time_ms(torch, lib_fwd, sets), "graph"
            rows.append(dict(kernel="fused_ce_fwd", case=name, err=fwd_err, ratio=fwd_ratio,
                             kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             how=how, bound=fb, digest=fwd_digest))
        kernel_ms = time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_bwd(
            h_, l_, w_, z_, g_, dw), sets)
        split = kernel_split_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_bwd(
            h_, l_, w_, z_, g_, dw), sets, CE_BWD_KERNELS)
        plain_ms = time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_bwd_plain(
            h_, l_, w_, z_, g_, dw), sets, iters=2)
        hx = h.detach().clone().requires_grad_(True)
        wx = w.detach().clone().requires_grad_(dw)
        lib_out = F.cross_entropy(F.linear(hx, wx).float(), lib_labels, reduction="none")
        lib_in = [hx, wx] if dw else [hx]
        library_ms = eager_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_in, g, retain_graph=True), [()], iters=10)
        rows.append(dict(kernel="fused_ce_bwd", case=name, err=bwd_err, ratio=bwd_ratio,
                         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         how="eager", bound=bb, digest=bwd_digest,
                         extra=dict(split_ms=split, bit_identical=same, ptxas=regs,
                                    pass_err_over_tol=pass_ratio,
                                    scratch_shape=list(plan.scratch_shape),
                                    scratch_bytes=plan.scratch_bytes,
                                    scratch_floor_ms=2 * plan.scratch_bytes / PEAK_BYTES * 1e3,
                                    S=plan.S, seg_steps=plan.seg_steps,
                                    dlogits_blocks=plan.dlogits_blocks,
                                    dh_blocks=plan.dh_blocks,
                                    dw_blocks=plan.dw_blocks if dw else 0)))
        del lib_out, hx, wx, sets
        for r in rows:
            bms, bby = r["bound"]
            with_dw = dw and r["kernel"] == "fused_ce_bwd"
            extra = r.get("extra", {})
            ok = r["ratio"] <= 1.0 and extra.get("bit_identical", True) and all(
                x <= 1.0 for x in extra.get("pass_err_over_tol", {}).values())
            row = dict(kernel=r["kernel"], case=name,
                       shape=f"N={N} H={H} V={V}{' +dW' if with_dw else ''}",
                       max_abs_err=r["err"], err_over_tol=r["ratio"], ok=ok,
                       kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                       library_ms=r["library_ms"], library_timing=r["how"],
                       bound_ms=bms, bound_by=bby, digest=r["digest"], **extra)
            results.append(row)
            log(f"[kernel] {row['kernel']:14s} {name:13s} {row['shape']:28s} "
                f"err={row['max_abs_err']:.3e} err/tol={row['err_over_tol']:.3f} "
                f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}) bound_ms={bms:.4f} ({bby})")
            if extra:
                log(f"[kernel] fused_ce_bwd   {name:13s} device ms a call by kernel: "
                    + ", ".join(f"{k} {v:.4f}" for k, v in extra["split_ms"].items())
                    + f" | bit-identical={extra['bit_identical']} | err/tol by pass: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in extra["pass_err_over_tol"].items())
                    + " | ptxas registers (spill bytes): "
                    + ", ".join(f"{k} {n} ({sp})" for k, (n, sp) in regs.items()))
                log(f"[kernel] fused_ce_bwd   {name:13s} dlogits scratch "
                    f"{extra['scratch_shape']} bf16 {extra['scratch_bytes']} bytes (written + "
                    f"read once: {extra['scratch_floor_ms']:.4f} ms at {PEAK_BYTES / 1e12} "
                    f"TB/s; bound {bms:.4f} ms ({bby})); S={extra['S']} segments of "
                    f"{extra['seg_steps']} steps; blocks dlogits {extra['dlogits_blocks']}, "
                    f"dh {extra['dh_blocks']}, dW {extra['dw_blocks']}")
            log(f"[kernel] {row['kernel']:14s} {name:13s} sha256 "
                + " ".join(f"{k} {v}" for k, v in r["digest"].items()))
        torch.cuda.empty_cache()


# the int8 forward's splittable path shapes: (case, M, N, K)
SWEEP_SHAPES = [("qo", 16, 896, 896), ("gate_up", 16, 4864, 896), ("down", 16, 896, 4864),
                ("qo", 640, 896, 896), ("kv", 640, 128, 896), ("down", 640, 896, 4864),
                ("gate_up", 640, 4864, 896), ("qo", 4788, 896, 896), ("kv", 4788, 128, 896),
                ("down", 4788, 896, 4864), ("gate_up", 4788, 4864, 896)]


def gemv_forced_plans(N, K, sms):
    """The GEMV plans that `gemv_sweep` times at one shape: the plan's
    warps a block at every rows-a-warp R (2, 4, 8), on the blocks of one
    wave of the plan's warps an SM as `_gemv_plan` spreads them; and at the
    plan's own R, waves of 8, 16 and 64 warps an SM (at least one block an
    SM) and one block a row group (no walk). The plan's own is among them."""
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    chosen = QM._gemv_plan(N, K, sms)

    def grid(R, wave):
        groups = -(-N // R)
        rounds = -(-groups // (max(1, wave // chosen.warps) * sms)) if wave else 1
        return QM.GemvPlan(R, chosen.warps, -(-groups // rounds))
    plans = [grid(R, QM._GEMV_SM_WARPS) for R in QM._GEMV_ROWS]
    plans += [grid(chosen.rows, wave) for wave in (8, 16, 64, 0)]
    return list(dict.fromkeys(plans))


def gemv_sweep(torch, dev, lib, sms, rows):
    """The GEMV (M = 1) at the five path shapes, at `gemv_forced_plans`:
    ms a call (CUDA-graph replay of 200 calls), blocks, err/tol (FWD_U's
    bound) and which plan `_gemv_plan` picks. Appends to `rows`."""
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, K, N in INT8_SHAPES:
        chosen = QM._gemv_plan(N, K, sms)

        def make():
            x = torch.randn(1, K, generator=gen, device=dev, dtype=torch.bfloat16)
            w_q, scale = QM.quantize_weight(torch.randn(N, K, generator=gen, device=dev) * 0.02)
            return x, w_q, scale
        sets = [make() for _ in range(n_sets(K * 2 + N * K + N * 4 + N * 2))]
        x, w_q, scale = sets[0]
        ref = QM.int8_matmul_reference(x.float(), w_q, scale)
        tol = (FWD_U * ref.abs() + DX_SUM_U * K ** 0.5
               * QM.int8_matmul_reference(x.float(), w_q, scale, abs_terms=True)
               + 1e-6 * float(ref.square().mean().sqrt()))
        for plan in gemv_forced_plans(N, K, sms):
            def run(x_, w_, s_, plan=plan):
                y = torch.empty(1, N, dtype=torch.bfloat16, device=dev)
                _build.check(lib.simlingo_int8_gemv(
                    x_.data_ptr(), w_.data_ptr(), s_.data_ptr(), y.data_ptr(), N, K, 0, 0, *plan,
                    torch.cuda.current_stream(dev).cuda_stream), "int8_gemv")
                return y
            ratio = _ratio(run(x, w_q, scale), ref, tol)[1]
            ms = time_ms(torch, run, sets, iters=200)
            mine = plan == chosen
            rows.append(dict(case=name, M=1, N=N, K=K, tile="gemv", rows=plan.rows,
                             warps=plan.warps, blocks=plan.blocks,
                             walk=plan.blocks < -(-N // plan.rows), ms=ms,
                             err_over_tol=ratio, plan=mine))
            log(f"[sweep] int8_gemv   {name:8s} M=    1 N={N:6d} K={K:5d} R={plan.rows} "
                f"warps={plan.warps} blocks={plan.blocks:5d} "
                f"ms={ms:.4f} err/tol={ratio:.3f}{'  <- plan' if mine else ''}")
        del sets, ref, tol
        torch.cuda.empty_cache()


def sass_ops(lib_path, kernel="gemv_kernel"):
    """{instantiation: [opcode, ...] in program order} of `kernel` in a
    built library, from `cuobjdump -sass`: its bf16-activation instances
    (gemv_kernel<R, ST> in a tree with no fp32 build, <R, ST, bf16> since),
    named <R, ST>."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    ops, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = None
            t = re.search(rf"{len(kernel)}{kernel}I(\w*?)EEv", m.group(1))
            args = _template_args(t.group(1)) if t else []
            if t and not (len(args) > 2 and args[2] == "float"):
                name = f"{kernel}<{','.join(args[:2])}>"
                ops[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            ops[name].append(m.group(1))
    return ops


def log_sass(tree, lib_path):
    """gemv_kernel's static SASS counts in one tree's library, per 16 bytes
    of weight: the dot's FFMAs are 16 a 16-byte load of codes, so code that
    holds F FFMAs handles F / 16 such loads. Counted over the whole kernel
    and over its hot span: from its first global load to its first warp
    shuffle, the loads and dot products of a warp's first rows before their
    reduction (the parent's whole loop: two chunks unrolled and one)."""
    key = ("LDG", "PRMT", "I2F", "I2FP", "FADD", "FFMA", "LOP3", "SHF", "IMAD", "F2FP")
    for name, ops in sorted(sass_ops(lib_path).items()):
        loads = max(ops.count("FFMA") / 16, 1e-9)
        first = next((i for i, op in enumerate(ops) if op == "LDG"), 0)
        shfl = next((i for i, op in enumerate(ops) if op == "SHFL" and i > first), len(ops))
        span = ops[first:shfl]
        hot = max(span.count("FFMA") / 16, 1e-9)
        hist = {op: ops.count(op) for op in sorted(set(ops))}
        log(f"[sass] {tree} {name}: {len(ops)} instructions, {loads:.0f} 16-byte code "
            f"loads in its loop bodies; per 16 bytes of weight: whole kernel "
            f"{len(ops) / loads:.1f}, hot span {len(span) / hot:.1f} ({hot:.0f} loads: "
            + ", ".join(f"{k} {span.count(k) / hot:.2f}" for k in key)
            + ") | " + " ".join(f"{k}:{v}" for k, v in hist.items()))


def int8_sweep(torch, dev) -> int:
    """int8_matmul's kernels launched at every reduction split S the cluster
    cap allows (whole steps, as the plan cuts them), at SWEEP_SHAPES, and
    the GEMV at every plan of `gemv_sweep`: ms per call (CUDA-graph
    replay, as phase 2 times), blocks, the worst err/tol (FWD_U's bound)
    and which plan `_fwd_plan` / `_gemv_plan` picks; rows also to
    chiprun_out/int8_fwd_sweep.json; then gemv_kernel's SASS counts.
    Information for the plan."""
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    lib, sms = QM._lib(), _build.sm_count(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    warm_up(torch, dev)
    gemv_sweep(torch, dev, lib, sms, rows)
    for name, M, N, K in SWEEP_SHAPES:
        tile, plan_S, _ = QM._fwd_plan(M, N, K, sms)
        steps = -(-K // QM._fwd_geometry(M)[1])
        tiles = -(-M // tile[0]) * -(-N // tile[1])

        def make():
            x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
            w_q, scale = QM.quantize_weight(torch.randn(N, K, generator=gen, device=dev) * 0.02)
            return x, w_q, scale
        sets = [make() for _ in range(n_sets(M * K * 2 + N * K + M * N * 2))]
        for S in sorted({-(-steps // -(-steps // s)) for s in range(1, QM._FWD_CLUSTER + 1)}):
            per = -(-steps // S)

            def run(x, w_q, scale, S=S, per=per):
                y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                _build.check(lib.simlingo_int8_matmul(
                    x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, N, K, 0,
                    S, per, torch.cuda.current_stream(dev).cuda_stream), "int8_matmul")
                return y
            x, w_q, scale = sets[0]
            ref = QM.int8_matmul_reference(x.float(), w_q, scale)
            terms = QM.int8_matmul_reference(x.float(), w_q, scale, abs_terms=True)
            _, ratio = _ratio(run(x, w_q, scale), ref, FWD_U * ref.abs()
                              + DX_SUM_U * K ** 0.5 * terms + 1e-6 * float(ref.square().mean().sqrt()))
            ms = time_ms(torch, run, sets)
            rows.append(dict(case=name, M=M, N=N, K=K, tile=list(tile), S=S, blocks=tiles * S,
                             ms=ms, err_over_tol=ratio, plan=S == plan_S))
            log(f"[sweep] int8_matmul {name:8s} M={M:5d} N={N:6d} K={K:5d} "
                f"tile={tile[0]}x{tile[1]} S={S} blocks={tiles * S:5d} ms={ms:.4f} "
                f"err/tol={ratio:.3f}{'  <- plan' if S == plan_S else ''}")
        del sets
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int8_fwd_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    log_sass("this tree", _build.BUILD_ROOT / _build._digest() / "libint8_matmul.so")
    return 0 if all(r["err_over_tol"] <= 1.0 for r in rows) else 1


def ce_sweep(torch, dev) -> int:
    """fused_ce_bwd (dh) at the training shape, launched at forced segment
    counts S of the dh product (whole 128-column steps, as the plan cuts
    them): ms a call (CUDA-graph replay), the device ms of each kernel
    (torch.profiler), blocks, the err/tol of dh against the plain version
    (the bound of run_ce_checks) and which S `_bwd_plan` picks; rows also to
    chiprun_out/ce_bwd_sweep.json. Information for the plan."""
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import fused_ce as TC
    lib, sms = TC._lib(), torch.cuda.get_device_properties(dev).multi_processor_count
    N, H, V = 960, 896, 151674
    gen = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn(N, H, generator=gen, device=dev).bfloat16()
    w = (0.02 * torch.randn(V, H, generator=gen, device=dev)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=gen, device=dev)
    g = (torch.rand(N, generator=gen, device=dev) < 0.8).float() / (0.8 * N)
    logz = TC.fused_ce_fwd(h, labels, w)[0]
    plan = TC._bwd_plan(N, H, V, sms)
    steps = plan.vpad // TC._VSTEP
    rdh = TC.fused_ce_bwd_plain(h, labels, w, logz, g, False)[0].float()
    mdh = TC.fused_ce_bwd_plain(h, labels, w, logz, g, False, abs_terms=True)[0]
    tol = BF16_SPACING * (mdh + rdh.abs()) + 1e-6 * float(rdh.square().mean().sqrt())
    del mdh
    sets = [(h, labels, w, logz, g)]
    rows = []
    tiles = plan.dh_blocks // plan.S
    for S in sorted({TC._segments(steps, s)[0] for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12,
                                                         14, 16, 20, 24, 28, 32)}):
        per = TC._segments(steps, S)[1]

        def run(h_, l_, w_, z_, g_, S=S, per=per):
            dl = torch.empty(plan.scratch_shape, dtype=torch.bfloat16, device=dev)
            part = torch.empty((S, N, H), dtype=torch.float32, device=dev)
            dh = torch.empty_like(h_)
            _build.check(lib.simlingo_fused_ce_bwd(
                h_.data_ptr(), w_.data_ptr(), l_.data_ptr(), z_.data_ptr(), g_.data_ptr(),
                dl.data_ptr(), part.data_ptr(), dh.data_ptr(), None, N, H, V, S, per, 0,
                torch.cuda.current_stream(dev).cuda_stream), "fused_ce_bwd")
            return dh
        ratio = _ratio(run(*sets[0]), rdh, tol)[1]
        ms = time_ms(torch, run, sets)
        split = kernel_split_ms(torch, run, sets, CE_BWD_KERNELS[:3])
        mine = S == plan.S
        rows.append(dict(S=S, seg_steps=per, blocks=tiles * S, ms=ms, split_ms=split,
                         err_over_tol=ratio, plan=mine))
        log(f"[sweep] fused_ce_bwd dh N={N} H={H} V={V} S={S:2d} blocks={tiles * S:4d} "
            f"ms={ms:.4f} (" + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f") err/tol={ratio:.3f}{'  <- plan' if mine else ''}")
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ce_bwd_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0 if all(r["err_over_tol"] <= 1.0 for r in rows) else 1


def fwd_digests(torch, dev, kernel):
    """{case: {output: sha12}} and {case: device ms a call} of one forward
    kernel (or the attention backward) of the tree whose
    `simlingo_tpu_torch` is imported, on phase 2's inputs and timed calls:
    "flash_attn_fwd" and "flash_attn_bwd" at every attention case of the
    head dims the tree builds,
    "fused_ce_fwd" at the training shape, "int8_fwd" at every phase-2 int8
    forward case (200 calls a replay at M = 1, the GEMV); "norms" at
    every norm case, "<case>_fwd" and "<case>_bwd" apart (200 calls a
    replay below 1 MB of operands); "dropout" at phase 2's zero-offset
    cases, 200 calls a replay."""
    digests, ms = {}, {}
    warm_up(torch, dev)
    if kernel == "dropout":
        from simlingo_tpu_torch.kernels import dropout as DO
        gen = torch.Generator(device=dev).manual_seed(4)
        seed, rate = 0x243F6A8885A308D3, 0.1
        for name, shape, block in DROPOUT_CASES:
            x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
            sets = [(torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),)
                    for _ in range(n_sets(4 * x.numel()))]
            if block is None:        # a tree before the offsets has only these
                digests[name] = {"out": sha12(torch, DO.dropout(x, seed, rate))}
                ms[name] = time_ms(torch, lambda x_: DO.dropout(x_, seed, rate), sets,
                                   iters=200)
            del sets
        return digests, ms
    if kernel == "int8_fwd":
        from simlingo_tpu_torch.kernels import quantized_matmul as QM
        for index, (name, K, N, M, sdt) in enumerate(int8_cases()):
            case = f"{name}_{M}_{str(sdt).replace('torch.', '')}"
            (x, w_q, scale), sets = int8_inputs(torch, dev, index)
            digests[case] = {"y": sha12(torch, QM.int8_matmul(x, w_q, scale))}
            # 200 calls a replay: these kernels are ~0.002-0.005 ms, and the
            # replay's own start costs a share of 20
            ms[case] = time_ms(torch, QM.int8_matmul, sets, iters=200 if M == 1 else 20)
            del sets
            torch.cuda.empty_cache()
        return digests, ms
    if kernel == "norms":
        gen = torch.Generator(device=dev).manual_seed(5)
        for fam, name, n, d, eps, dirs in norm_cases():
            need_ds = "bwd" in dirs
            make = norm_make(torch, dev, gen, fam, n, d, eps)
            kf, kb, _, _ = norm_calls(fam, eps, need_ds)
            args = make()
            sets = [make() for _ in range(n_sets(3 * n * d * 2))]
            iters = 200 if 3 * n * d * 2 < 1 << 20 else 20
            for direction, fn in (("fwd", kf), ("bwd", kb)):
                if not ((direction in dirs) or (direction == "bwd" and "bwd_dx" in dirs)):
                    continue
                digests[f"{name}_{direction}"] = {
                    str(i): sha12(torch, t) for i, t in enumerate(fn(*args)) if t is not None}
                ms[f"{name}_{direction}"] = time_ms(torch, fn, sets, iters=iters)
            del sets
            torch.cuda.empty_cache()
        return digests, ms
    if kernel == "flash_attn_fwd":
        from simlingo_tpu_torch.kernels import flash_attention as FA
        dims = getattr(FA, "HEAD_DIMS", (64,))       # a tree before them built 64 only
        for case, (q, k, v, valid), sets in attention_inputs(torch, dev):
            if head_dim(case) not in dims:
                continue
            out, lse = FA.flash_attn_fwd(q, k, v, valid, case[6], None, case[7],
                                         return_lse=True)
            digests[case[0]] = {"out": sha12(torch, out), "lse": sha12(torch, lse)}
            ms[case[0]] = time_ms(torch, attention_call(FA, case), sets)
            del sets
            torch.cuda.empty_cache()
    elif kernel == "flash_attn_bwd":
        from simlingo_tpu_torch.kernels import flash_attention as FA
        for case, valid, first, sets in attention_bwd_inputs(
                torch, dev, getattr(FA, "HEAD_DIMS", (64,))):
            causal = case[5]
            digests[case[0]] = dict(zip(("dq", "dk", "dv"), (
                sha12(torch, g) for g in FA.flash_attn_bwd(*first[:3], valid, *first[3:],
                                                           causal))))
            ms[case[0]] = time_ms(torch, lambda q_, k_, v_, o_, d_, l_: FA.flash_attn_bwd(
                q_, k_, v_, valid, o_, d_, l_, causal), sets)
            del sets
            torch.cuda.empty_cache()
    elif kernel == "fused_ce_fwd":
        from simlingo_tpu_torch.kernels import fused_ce as TC
        name, N, H, V, _ = ce_cases()[0]
        gen = torch.Generator(device=dev).manual_seed(CE_SEED)
        h, w, labels = ce_inputs(torch, dev, gen, N, H, V)
        logz, ce = TC.fused_ce_fwd(h, labels, w)
        digests[name] = {"ce": sha12(torch, ce), "logz": sha12(torch, logz)}
        ms[name] = time_ms(torch, lambda h_, l_, w_: TC.fused_ce_fwd(h_, l_, w_),
                           [(h, labels, w)])
    else:
        raise ValueError(f"fwd_digests: no kernel {kernel!r}")
    return digests, ms


# the cases whose bits must equal the parent's: the CE forward (its loop
# keeps each accumulator's order), the attention forward's tiled path (its
# loop keeps each row's order) and every bf16 int8 forward case (the fp32
# build left the bf16 kernels' arithmetic as it was; "*": every case; a PR
# that reorders a sum takes its cases out)
MUST_EQUAL = {"fused_ce_fwd": ("train",), "dropout": ("lora_x_896", "lora_h_4864"),
              "int8_fwd": "*",
              "flash_attn_fwd": ("vit", "vit_train", "llm_prefill", "llm_train", "clip",
                                 "base_llm"),
              "flash_attn_bwd": ("llm_train", "vit_train", "clip", "base_llm"),
              "norms": tuple(f"{c[1]}_fwd" for c in norm_cases() if "fwd" in c[5])}


def compare_fwd(parent, kernel) -> bool:
    """One forward kernel of this tree and of the tree at `parent`
    (scripts/fwd_digest.py, one process each, in turns: parent, this,
    this, parent, on this card): device ms of every case side by side, and
    True if the bits of the MUST_EQUAL cases are equal."""
    script = os.path.join(ROOT, "scripts", "fwd_digest.py")
    parent = os.path.abspath(parent)
    runs = {}
    for tree in (parent, ROOT, ROOT, parent):
        run = subprocess.run([sys.executable, script, kernel], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        line = next((x for x in run.stdout.splitlines() if x.startswith("FWD_DIGEST")), None)
        if run.returncode or line is None:
            log(f"[digest] {tree}: exit {run.returncode}\n{run.stdout[-3000:]}{run.stderr[-3000:]}")
            return False
        runs.setdefault(tree, []).append(json.loads(line.split(" ", 3)[3]))
    mine, theirs = runs[ROOT], runs[parent]
    equal = True
    for case in [c for c in mine[0]["ms"] if c in theirs[0]["ms"]]:
        a = [r["ms"][case] for r in mine]
        b = [r["ms"][case] for r in theirs]
        same = mine[0]["digests"][case] == theirs[0]["digests"][case]
        must = MUST_EQUAL.get(kernel) == "*" or case in MUST_EQUAL.get(kernel, ())
        equal &= same or not must
        log(f"[ab] {kernel} {case:12s} ms this tree {a[0]:.4f} {a[1]:.4f} | parent "
            f"{b[0]:.4f} {b[1]:.4f} | ratio {sum(a) / sum(b):.3f} | bits "
            f"{'EQUAL' if same else 'DIFFERENT'}{' (must be equal)' if must else ''} "
            f"{mine[0]['digests'][case]} / {theirs[0]['digests'][case]}")
    if kernel in MUST_EQUAL:
        log(f"[digest] {kernel} cases {MUST_EQUAL[kernel]} against {parent}: "
            f"{'EQUAL' if equal else 'DIFFERENT'}")
    if kernel == "int8_fwd":
        for run, what in ((theirs[0], "parent"), (mine[0], "this tree")):
            log_sass(what, os.path.join(run["build"], "libint8_matmul.so"))
    return equal


def attn_sweep(torch, dev) -> int:
    """flash_attn_fwd at forced plans: the tiled path, and the split path
    at most 4 / 8 splits, at the serving shapes and at T = 64 / 128 /
    256 against the 770-key cache (group 7: 448 / 896 / 1792 packed rows);
    the tiled path at the ViT, prefill and training shapes; each against
    the plain version."""
    from simlingo_tpu_torch.kernels import _build
    from simlingo_tpu_torch.kernels import flash_attention as FA
    sms = _build.sm_count(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    small = [(f"kv770_T{T}", 1, T, 770, 14, 2, True, 770 - T) for T in (1, 16, 30, 64, 128, 256)]
    large = [("vit", 2, 1025, 1025, 16, 16, False, 0), ("llm_prefill", 1, 640, 770, 14, 2, True, 0),
             ("llm_train", 6, 798, 798, 14, 2, True, 0), ("vit_train", 12, 1025, 1025, 16, 16, False, 0)]
    rows, bad = [], 0
    for name, B, T, S, HQ, HK, causal, off in small + large:
        knobs = [(0, FA.SPLIT_MAX)] + [(1 << 30, n) for n in (4, 8) if T <= 256]
        plans = {}                                   # distinct plans, with their knobs
        for srows, n in knobs:
            plan = FA._fwd_plan(B, T, S, HQ, HK, causal, off, sms=sms, split_rows=srows,
                                max_splits=n)
            plans.setdefault(plan, (srows, n))
        def make():
            return tuple(torch.randn(B, L, H, 64, generator=gen, device=dev, dtype=torch.bfloat16)
                         for L, H in ((T, HQ), (S, HK), (S, HK)))
        nbytes = 2 * (B * T * HQ * 64 * 2 + 2 * B * S * HK * 64)
        sets = [make() for _ in range(n_sets(nbytes))]
        q, k, v = sets[0]
        ref = FA.attention_reference(q.float(), k.float(), v.float(), None, causal, None, off)
        chosen = FA._fwd_plan(B, T, S, HQ, HK, causal, off, sms=sms)
        for plan, (srows, n) in plans.items():
            out = FA.flash_attn_fwd(q, k, v, None, causal, None, off, split_rows=srows,
                                    max_splits=n)
            torch.cuda.synchronize()
            # causal rows see as few as one key here (no padding): the
            # kernel's bf16 probabilities weigh values of |v| up to ~4, so
            # the atol of tests/test_torch_cuda.py's causal cases, 4e-3
            err = float((out.float() - ref).abs().max())
            ok = bool(((out.float() - ref).abs()
                       <= (4e-3 if causal else ATOL["flash_attn_fwd"]) + RTOL * ref.abs()).all())
            bad += not ok
            ms = time_ms(torch, lambda q_, k_, v_, srows=srows, n=n: FA.flash_attn_fwd(
                q_, k_, v_, None, causal, None, off, split_rows=srows, max_splits=n), sets)
            mine = (plan.path, plan.splits) == (chosen.path, chosen.splits)
            rows.append(dict(case=name, path=plan.path, splits=plan.splits,
                             tiles_per_split=plan.tiles_per_split,
                             grid=plan.grid, ms=ms, max_abs_err=err, ok=ok, plan=mine))
            log(f"[sweep] flash_attn_fwd {name:12s} {plan.path:5s} "
                f"splits={plan.splits:2d} tiles/split={plan.tiles_per_split} grid={plan.grid} "
                f"ms={ms:.4f} err={err:.2e} {'OK' if ok else 'FAIL'}{'  <- plan' if mine else ''}")
        del sets
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "attn_fwd_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 1 if bad else 0


# ---------------------------------------------------------------------------
# Phases 3-4: the serving path
# ---------------------------------------------------------------------------

def _frame(AgentFrame, np, seed=0):
    rgb = np.random.RandomState(seed).randint(0, 256, (512, 1024, 3), np.uint8)
    return AgentFrame(rgb=rgb, speed=4.0, target_point=np.array([8.0, 0.5]),
                      next_target_point=np.array([16.0, 1.5]))


def small_model_agreement(torch, dev):
    """A small model at head_dim 64, as at full width: drive_only waypoints on
    the GPU (bf16, kernels) against the CPU plain path (fp32)."""
    import numpy as np
    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    tok = SimLingoTokenizer()
    cfg = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=256, image_size=448, patch_size=56,
                      projector_out=128),
        llm=Qwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=128,
                        num_layers=2, num_heads=2, num_kv_heads=1, head_dim=64,
                        intermediate_size=256),
        img_context_token_id=tok.img_context_id)
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    acfg = dict(use_cot=False, initial_frames_delay=0, jpeg_roundtrip=False,
                warmup_compile=False)
    outs = []
    for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
        agent = LingoAgent(params, cfg, AgentConfig(**acfg), tokenizer=tok,
                           max_prompt_len=256, compute_dtype=dtype, device=device)
        outs.append(agent.run_step(_frame(AgentFrame, np)))
    ref, got = outs
    scale = max(float(np.abs(ref["route"]).max()), float(np.abs(ref["speed_wps"]).max()))
    err = max(float(np.abs(got["route"] - ref["route"]).max()),
              float(np.abs(got["speed_wps"] - ref["speed_wps"]).max()))
    ok = err <= 0.05 * scale and np.isfinite(got["route"]).all()
    log(f"[small] drive_only waypoints GPU bf16 vs CPU fp32: max err {err:.3e} "
        f"(tol 0.05 x max|ref| = {0.05 * scale:.3e}) {'OK' if ok else 'FAIL'}")
    return ok


def full_width(torch, dev, gated_pass=False, int4_pass=False):
    """The default LingoAgent at SimLingoConfig() width; returns (ok, stats,
    the CoT agent, the frame). `gated_pass`: then the same agents again
    with the norm gate on (`gated_serving`), its statistics under
    stats["gated"]. `int4_pass`: then the default AgentConfig with
    int4_llm=True on the same weights and CoT frames (`serve_int4`), its
    statistics under stats["int4"]."""
    import numpy as np
    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.infer import runner
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    from simlingo_tpu_torch.models import simlingo

    cfg = simlingo.SimLingoConfig()
    t0 = time.perf_counter()
    params = simlingo.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                  device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[full] SimLingoConfig(): ViT {cfg.vit.num_layers}x{cfg.vit.hidden_size} "
        f"({cfg.vit.num_heads} heads), Qwen2 {cfg.llm.num_layers}x"
        f"{cfg.llm.hidden_size} vocab {cfg.llm.vocab_size}; {n_params / 1e6:.1f} M "
        f"random bf16 params (seed 0) in {time.perf_counter() - t0:.1f} s")
    acfg = AgentConfig(initial_frames_delay=0, jpeg_roundtrip=False)
    log(f"[full] AgentConfig defaults (use_cot={acfg.use_cot}, int8_llm="
        f"{acfg.int8_llm}, speculative_cot={acfg.speculative_cot}, spec_k="
        f"{acfg.spec_k}, max_new_tokens={acfg.max_new_tokens}) except "
        f"initial_frames_delay=0 and jpeg_roundtrip=False (no cv2 here)")
    t0 = time.perf_counter()
    agent = LingoAgent(params, cfg, acfg, device=dev)          # warm-up inside
    drive_agent = LingoAgent(params, cfg, AgentConfig(
        use_cot=False, initial_frames_delay=0, jpeg_roundtrip=False), device=dev)
    torch.cuda.synchronize()
    log(f"[full] agents built + warmed up in {time.perf_counter() - t0:.1f} s")
    frame = _frame(AgentFrame, np)

    # the counted main path: CoT frames (plain, then speculative) + drive_only,
    # with each frame's launches
    FA.flash_attn_fwd.launches = 0
    QM.int8_matmul.launches = 0
    results, per_frame = [], []
    for run in [agent.run_step] * FRAMES + [drive_agent.run_step]:
        before = (FA.flash_attn_fwd.launches, QM.int8_matmul.launches)
        results.append(run(frame))
        per_frame.append({"flash_attn_fwd": FA.flash_attn_fwd.launches - before[0],
                          "int8_matmul": QM.int8_matmul.launches - before[1]})
    launches = {"flash_attn_fwd": FA.flash_attn_fwd.launches,
                "int8_matmul": QM.int8_matmul.launches}

    ok = True
    for i, r in enumerate(results):
        kind = "drive_only" if i == len(results) - 1 else (
            "cot_plain" if i == 0 else "cot_spec")
        fin = (np.isfinite(r["route"]).all() and np.isfinite(r["speed_wps"]).all()
               and r["route"].shape == (20, 2) and r["speed_wps"].shape == (10, 2)
               and all(np.isfinite([r["steer"], r["throttle"]]))
               and -1 <= r["steer"] <= 1 and 0 <= r["throttle"] <= 1)
        ok &= bool(fin)
        log(f"[full] frame {i} {kind:10s} {r['latency_s'] * 1e3:9.2f} ms  "
            f"tokens={len(r.get('language_tokens', []))}  steer={r['steer']:.3f} "
            f"throttle={r['throttle']:.3f} brake={r['brake']}  "
            f"route[-1]={np.round(r['route'][-1], 4).tolist()}  "
            f"finite={'OK' if fin else 'FAIL'}")
    log(f"[full] speculative (rounds, gen_len) per frame: {agent.spec_stats}")
    log(f"[full] launches on the main path: {launches}; a frame: {per_frame}")
    for name, n in launches.items():
        if n <= 0:
            log(f"[full] FAIL: kernel {name} was not launched on the main path")
            ok = False
    for i in range(FRAMES):
        want = serve_launches(cfg, len(results[i].get("language_tokens", [])),
                              None if i == 0 else agent.spec_stats[i - 1][0])
        if per_frame[i] != want:
            log(f"[full] FAIL: frame {i} launches {per_frame[i]}, reckoned {want}")
            ok = False
    cot_spec =[r["latency_s"] * 1e3 for r in results[1:-1]]

    # decode ms/token: the same frame through the plain generator with 100
    # vs 1 new tokens (prefill and queries cancel out)
    di = agent._preprocessed(agent.make_input(frame))
    gen_ms = {}
    for n_new in (1, acfg.max_new_tokens):
        gcfg = runner.GenerateConfig(max_new_tokens=n_new,
                                     eos_token_id=agent.tok.eos_token_id)
        runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)
        n_tok = int(out.language_lengths[0])
        gen_ms[n_new] = ((time.perf_counter() - t0) * 1e3, n_tok)
    (t1, _), (tn, ntok) = gen_ms[1], gen_ms[acfg.max_new_tokens]
    decode_ms = (tn - t1) / max(ntok - 1, 1)
    log(f"[full] plain generate: 1 token {t1:.2f} ms, {ntok} tokens {tn:.2f} ms "
        f"-> decode {decode_ms:.3f} ms/token")
    gen_profile = profile_generate(torch, agent, di, runner)
    gated = None
    if gated_pass:
        good, gated = gated_serving(torch, agent, drive_agent, frame, results)
        ok &= good
    int4 = None
    if int4_pass:
        del drive_agent
        torch.cuda.empty_cache()
        good, int4 = serve_int4(torch, dev, params, cfg, agent, frame, results[:FRAMES],
                                decode_ms)
        ok &= good
    del params
    stats = dict(frame_ms_cot_plain=results[0]["latency_s"] * 1e3,
                 frame_ms_cot_spec=cot_spec,
                 frame_ms_drive_only=results[-1]["latency_s"] * 1e3,
                 tokens_per_frame=[len(r.get("language_tokens", [])) for r in results[:-1]],
                 spec_stats=agent.spec_stats, decode_ms_per_token=decode_ms,
                 generate_profile=gen_profile, launches=launches,
                 launches_per_frame=per_frame, gated=gated, int4=int4)
    return ok, stats, agent, frame


def llm_weight_bytes(params):
    """Bytes of an agent's LLM tree (codes, scales, norms)."""
    return sum(t.numel() * t.element_size() for t in _leaves(params["llm"]))


def serve_int4(torch, dev, params, cfg, int8_agent, frame, int8_results, int8_decode_ms):
    """Phase 4's int4 pass (`serve_int4`): the default AgentConfig with
    int4_llm=True at full width on the same seed-0 weights, FRAMES CoT
    frames on phase 4's frame (the first plain, then speculative): each
    frame's ms and tokens beside the int8 agent's (the tokens differ:
    another rounding of every LLM weight), the LLM's weight bytes int4 vs
    int8, flash_attn_fwd a frame exactly as `serve_launches(bits=4)`
    reckons it and no int8_matmul launch, and decode ms/token (the plain
    generator at 1 and max_new_tokens new tokens) beside int8's."""
    import numpy as np
    from simlingo_tpu_torch.agent.agent import LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.infer import runner
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    tag = "[serve_int4]"
    acfg = AgentConfig(initial_frames_delay=0, jpeg_roundtrip=False, int4_llm=True)
    t0 = time.perf_counter()
    agent = LingoAgent(params, cfg, acfg, device=dev)              # warm-up inside
    torch.cuda.synchronize()
    b4, b8 = llm_weight_bytes(agent.params), llm_weight_bytes(int8_agent.params)
    log(f"{tag} int4 agent (group {QM.INT4_GROUP}) built + warmed up in "
        f"{time.perf_counter() - t0:.1f} s; LLM weight bytes int4 {b4} vs int8 {b8} "
        f"({b4 / b8:.3f})")
    FA.flash_attn_fwd.launches = 0
    QM.int8_matmul.launches = 0
    results, per_frame = [], []
    for _ in range(FRAMES):
        before = (FA.flash_attn_fwd.launches, QM.int8_matmul.launches)
        results.append(agent.run_step(frame))
        per_frame.append({"flash_attn_fwd": FA.flash_attn_fwd.launches - before[0],
                          "int8_matmul": QM.int8_matmul.launches - before[1]})
    launches = {"flash_attn_fwd": FA.flash_attn_fwd.launches,
                "int8_matmul": QM.int8_matmul.launches}
    ok = launches["flash_attn_fwd"] > 0 and launches["int8_matmul"] == 0
    for i, (r, r8) in enumerate(zip(results, int8_results)):
        toks, toks8 = r.get("language_tokens", []), r8.get("language_tokens", [])
        fin = (np.isfinite(r["route"]).all() and np.isfinite(r["speed_wps"]).all()
               and r["route"].shape == (20, 2) and -1 <= r["steer"] <= 1)
        want = serve_launches(cfg, len(toks), None if i == 0 else agent.spec_stats[i - 1][0],
                              bits=4)
        good = bool(fin) and per_frame[i] == want
        ok &= good
        log(f"{tag} frame {i} {'cot_plain' if i == 0 else 'cot_spec':9s} "
            f"{r['latency_s'] * 1e3:9.2f} ms (int8 {r8['latency_s'] * 1e3:9.2f}) tokens "
            f"{len(toks)} (int8 {len(toks8)}, equal {toks == toks8}) launches {per_frame[i]}"
            f" reckoned {want} finite {bool(fin)} {'OK' if good else 'FAIL'}")
    log(f"{tag} int4 tokens, frame 0: {results[0].get('language_tokens', [])}")
    log(f"{tag} int8 tokens, frame 0: {int8_results[0].get('language_tokens', [])}")
    log(f"{tag} speculative (rounds, gen_len) per frame: {agent.spec_stats}")
    di = agent._preprocessed(agent.make_input(frame))
    gen_ms = {}
    for n_new in (1, acfg.max_new_tokens):
        gcfg = runner.GenerateConfig(max_new_tokens=n_new, eos_token_id=agent.tok.eos_token_id)
        runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)
        gen_ms[n_new] = ((time.perf_counter() - t0) * 1e3, int(out.language_lengths[0]))
    (t1, _), (tn, ntok) = gen_ms[1], gen_ms[acfg.max_new_tokens]
    decode_ms = (tn - t1) / max(ntok - 1, 1)
    log(f"{tag} plain generate: 1 token {t1:.2f} ms, {ntok} tokens {tn:.2f} ms -> decode "
        f"{decode_ms:.3f} ms/token (int8 {int8_decode_ms:.3f}); launches over the "
        f"{FRAMES} frames {launches} {'OK' if ok else 'FAIL'}")
    spec = agent.spec_stats
    del agent
    torch.cuda.empty_cache()
    stats = dict(frame_ms=[r["latency_s"] * 1e3 for r in results],
                 int8_frame_ms=[r["latency_s"] * 1e3 for r in int8_results],
                 tokens_per_frame=[len(r.get("language_tokens", [])) for r in results],
                 tokens_equal_int8=[r.get("language_tokens") == r8.get("language_tokens")
                                    for r, r8 in zip(results, int8_results)],
                 spec_stats=spec,
                 decode_ms_per_token=decode_ms, int8_decode_ms_per_token=int8_decode_ms,
                 llm_weight_bytes=b4, int8_llm_weight_bytes=b8,
                 launches=launches, launches_per_frame=per_frame)
    return ok, stats


# launches of the norm kernels a pass: the ViT's 24 x 2 LayerNorms and the
# projector's; the LLM's 24 x 2 RMSNorms and the final one
NORMS_PER_VIT_PASS = 49
NORMS_PER_LLM_PASS = 49
SERVE_GATE = {"SIMLINGO_LN_IMPL": "pallas"}


def gated_serving(torch, agent, drive_agent, frame, ungated):
    """The full-width agents of `full_width` again with SIMLINGO_LN_IMPL=
    pallas set in the process environment (restored afterwards; the port
    reads its gates at each call), from the state the ungated frames
    started from (an empty draft corpus), so frame i is of the same kind:
    frame ms by kind beside the ungated frames', the norm kernels'
    launches a frame (NORMS_PER_VIT_PASS a frame; a multiple of
    NORMS_PER_LLM_PASS), the tokens (equal to the ungated frames') and the
    waypoints' max |diff| to the ungated frames' (at most 2 % of their max
    |value|); then a profile of one gated speculative frame. Returns (ok,
    statistics) with the launches of every kernel over the gated frames."""
    import numpy as np
    fns = kernel_fns()
    norms = ("layernorm_fwd", "rmsnorm_fwd")
    agent._spec_corpus, agent._draft_tables = [], None
    ok, frames = True, []
    with gates_set(SERVE_GATE):
        for fn in fns.values():
            fn.launches = 0
        for i, ref in enumerate(ungated):
            last = i == len(ungated) - 1
            before = {k: fns[k].launches for k in norms}
            r = (drive_agent if last else agent).run_step(frame)
            n = {k: fns[k].launches - before[k] for k in norms}
            kind = "drive_only" if last else "cot_plain" if i == 0 else "cot_spec"
            scale = max(float(np.abs(ref["route"]).max()), float(np.abs(ref["speed_wps"]).max()))
            diff = {w: float(np.abs(r[w] - ref[w]).max()) for w in ("route", "speed_wps")}
            same_tokens = r.get("language_tokens", []) == ref.get("language_tokens", [])
            good = (same_tokens and max(diff.values()) <= 0.02 * scale
                    and n["layernorm_fwd"] == NORMS_PER_VIT_PASS
                    and n["rmsnorm_fwd"] > 0 and n["rmsnorm_fwd"] % NORMS_PER_LLM_PASS == 0)
            ok &= good
            frames.append(dict(kind=kind, ms=r["latency_s"] * 1e3,
                               ungated_ms=ref["latency_s"] * 1e3, launches=n,
                               llm_passes=n["rmsnorm_fwd"] / NORMS_PER_LLM_PASS,
                               tokens=len(r.get("language_tokens", [])),
                               tokens_equal=same_tokens, max_abs_diff=diff,
                               max_abs_ref=scale))
            log(f"[gated] frame {i} {kind:10s} {r['latency_s'] * 1e3:9.2f} ms (ungated "
                f"{ref['latency_s'] * 1e3:.2f})  launches layernorm_fwd "
                f"{n['layernorm_fwd']} (expected {NORMS_PER_VIT_PASS}), rmsnorm_fwd "
                f"{n['rmsnorm_fwd']} = {n['rmsnorm_fwd'] / NORMS_PER_LLM_PASS:g} LLM passes "
                f"x {NORMS_PER_LLM_PASS}; tokens {len(r.get('language_tokens', []))} "
                f"{'EQUAL' if same_tokens else 'DIFFERENT'} to the ungated frame's; "
                f"route / speed max |diff| {diff['route']:.3e} / {diff['speed_wps']:.3e} "
                f"(tol 0.02 x {scale:.3f}) {'OK' if good else 'FAIL'}")
        launches = {k: fn.launches for k, fn in fns.items()}
        profile = device_profile(torch, lambda: agent.run_step(frame),
                                 "one gated speculative frame")
    norm_ms = {k: profile["hand"].get(k, {"ms": 0.0, "count": 0})
               for k in ("norm_fwd_kernel",)}
    log(f"[gated] launches over the gated frames: {launches}")
    log(f"[gated] the profiled gated speculative frame: norm_fwd_kernel "
        f"{norm_ms['norm_fwd_kernel']['ms']:.4f} ms in {norm_ms['norm_fwd_kernel']['count']} "
        f"launches; device busy {profile['device_busy_ms']:.2f} of {profile['wall_ms']:.2f} ms")
    for name in norms:
        if launches[name] <= 0:
            log(f"[gated] FAIL: kernel {name} was not launched on the gated serving path")
            ok = False
    return ok, dict(frames=frames, launches=launches, profile=profile,
                    spec_stats=agent.spec_stats[-len(ungated):])


GEN_PROFILE_TOKENS = 11     # the profiled plain generate: 10 decode steps past the first token


def profile_generate(torch, agent, di, runner):
    """The plain generator profiled with 1 and GEN_PROFILE_TOKENS new
    tokens (the same frame: prefill and queries cancel out): device busy
    ms, and gemv_kernel's device ms and launches, a decoded token."""
    prof, tokens = {}, {}
    for n_new in (1, GEN_PROFILE_TOKENS):
        gcfg = runner.GenerateConfig(max_new_tokens=n_new, eos_token_id=agent.tok.eos_token_id)
        runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)

        def run(gcfg=gcfg, n_new=n_new):
            out = runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg)
            tokens[n_new] = int(out.language_lengths[0])
        prof[n_new] = device_profile(torch, run, f"plain generate, {n_new} new token(s)")
    steps = max(tokens[GEN_PROFILE_TOKENS] - tokens[1], 1)
    a, b = prof[1], prof[GEN_PROFILE_TOKENS]
    gemv = [p["hand"].get("gemv_kernel", {"ms": 0.0, "count": 0}) for p in (a, b)]
    per = dict(tokens=tokens[GEN_PROFILE_TOKENS],
               busy_ms=(b["device_busy_ms"] - a["device_busy_ms"]) / steps,
               wall_ms=(b["wall_ms"] - a["wall_ms"]) / steps,
               gemv_ms=(gemv[1]["ms"] - gemv[0]["ms"]) / steps,
               gemv_launches=(gemv[1]["count"] - gemv[0]["count"]) / steps)
    log(f"[profile] plain generate, a decoded token ({tokens[1]} vs "
        f"{tokens[GEN_PROFILE_TOKENS]} tokens): device busy {per['busy_ms']:.4f} ms of "
        f"{per['wall_ms']:.3f} ms wall (profiled); gemv_kernel {per['gemv_ms']:.4f} ms in "
        f"{per['gemv_launches']:.1f} launches")
    return dict(per_token=per, one_token=a, n_tokens=b)


def kernel_busy_ms(prof):
    """The summed device time of the kernels in a profile (operator rows and
    user annotations repeat their kernels' time, so they are left out)."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        total += max(dev_us if dev_us is not None else getattr(e, "self_cuda_time_total", 0), 0)
    return total / 1e3


def device_profile(torch, fn, what):
    """Device time by kernel over one call of fn (torch.profiler): wall,
    busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's row, and a user annotation's device
        # range (e.g. the optimizer step), repeat the time of the kernels
        # inside them, so summing those too would count it twice
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    classes, hand = {}, {}
    for ms, n, key in rows:
        cls = kernel_class(key)
        ms0, n0 = classes.get(cls, (0.0, 0))
        classes[cls] = (ms0 + ms, n0 + n)
        if cls == "hand":
            name = next(k for k in HAND_KERNELS if re.search(rf"(^|[:\s]){k}\b", key))
            ms0, n0 = hand.get(name, (0.0, 0))
            hand[name] = (ms0 + ms, n0 + n)
    log(f"[profile] {what}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    log(f"[profile] device ms (launches) by class: "
        + ", ".join(f"{c} {ms:.2f} ({n})" for c, (ms, n) in sorted(classes.items())))
    log(f"[profile] hand kernels, device ms (launches): "
        + ", ".join(f"{k} {ms:.2f} ({n})" for k, (ms, n) in sorted(hand.items())))
    for ms, n, key in rows[:15]:
        log(f"[profile] {ms:9.3f} ms  x{n:5d}  {key[:90]}")
    return dict(wall_ms=wall, device_busy_ms=busy,
                classes={c: dict(ms=ms, count=n) for c, (ms, n) in classes.items()},
                hand={k: dict(ms=ms, count=n) for k, (ms, n) in hand.items()},
                top=[dict(ms=ms, count=n, name=key) for ms, n, key in rows[:25]])


HAND_KERNELS = ("flash_fwd_kernel", "flash_fwd_split_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_prep_kernel",
                "flash_fwd_f32_kernel", "bwd_prep_f32_kernel", "bwd_dkdv_f32_kernel",
                "bwd_dq_f32_kernel",
                "dropout_kernel", "gemm_kernel", "gemm64_kernel", "gemv_kernel", "dx_kernel",
                "dx_reduce_kernel",
                "norm_fwd_kernel", "norm_bwd_kernel", "norm_colsum_kernel", "ce_fwd_tile_kernel",
                "ce_fwd_finalize_kernel", "ce_dlogits_kernel", "ce_dh_kernel",
                "ce_dh_reduce_kernel", "ce_dw_kernel", "ce_fwd_tile_f32_kernel",
                "ce_dlogits_f32_kernel", "ce_dh_f32_kernel", "ce_dw_f32_kernel",
                "gemm_f32_kernel", "dx_f32_kernel", "f32_reduce_kernel")


INT8_FWD_KERNELS = ("gemv_kernel", "gemm_kernel", "gemm64_kernel")
BWD_KERNELS = ("bwd_prep_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")
CE_BWD_KERNELS = ("ce_dlogits_kernel", "ce_dh_kernel", "ce_dh_reduce_kernel", "ce_dw_kernel")


def kernel_class(name):
    """hand (this repo's CUDA kernels), gemm (cuBLAS / CUTLASS), elementwise,
    reduce, copy or other (PyTorch's own kernels, by their names)."""
    if re.search(r"(^|[:\s])(" + "|".join(HAND_KERNELS) + r")\b", name):
        return "hand"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")):
        return "gemm"
    if "elementwise" in low or "foreach" in low:
        return "elementwise"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduce"
    if "copy" in low or "memcpy" in low or "memset" in low or "cat" in low:
        return "copy"
    return "other"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Phases 3 and 5: the training path
# ---------------------------------------------------------------------------

GATES_ON = {"SIMLINGO_CE_IMPL": "pallas", "SIMLINGO_LN_IMPL": "pallas"}
# the fused LoRA groups (`train_lora_fused`): q / k / v and gate / up each
# one dropout launch; every gate `gates_set` sets or clears
LORA_FUSED = {"SIMLINGO_LORA_FUSED": "1"}
GATE_NAMES = (*GATES_ON, *LORA_FUSED)
# the dropout-off pair of `train_lora_fused` (`lora_fused_pair`): fused
# against unfused, relative, each 2^-6 (four bf16 roundings)
PAIR_TOL = {"loss": 2.0 ** -6, "grad_norm": 2.0 ** -6}
NEW_KERNELS = ("layernorm_fwd", "layernorm_bwd", "rmsnorm_fwd", "rmsnorm_bwd",
               "fused_ce_fwd", "fused_ce_bwd")
# launches per training step with both gates on: the ViT's 24 x 2 LayerNorms
# and the projector's; the LLM's 24 x 2 RMSNorms and the final one; one CE
GATED_PER_STEP = {"layernorm_fwd": 49, "layernorm_bwd": 49, "rmsnorm_fwd": 49,
                  "rmsnorm_bwd": 49, "fused_ce_fwd": 1, "fused_ce_bwd": 1}
INT8_KERNELS = ("int8_matmul", "int8_matmul_dx")
# launches per training step on the int8 base: the 24 x 7 linears forward
# and dx; the tied head per 32-position chunk of the 160 answer positions
# (5 chunks, each checkpointed): forward, recompute and dx
INT8_PER_STEP = {"int8_matmul": 24 * 7 + 5 * 2, "int8_matmul_dx": 24 * 7 + 5}


class gates_set:
    """Set the gates in the process environment -- both fused-kernel gates
    (on=True), those of a dict {name: value}, or none -- clearing every
    other of GATE_NAMES, and restore the environment afterwards."""

    def __init__(self, on):
        self.env = GATES_ON if on is True else (on or {})

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in GATE_NAMES}
        for k in GATE_NAMES:
            os.environ.pop(k, None)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_fns():
    from simlingo_tpu_torch.kernels import dropout as DO
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import fused_ce as TC
    from simlingo_tpu_torch.kernels import layernorm as TL
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    return {"flash_attn_fwd": FA.flash_attn_fwd, "flash_attn_bwd": FA.flash_attn_bwd,
            "dropout": DO.dropout, "int8_matmul": QM.int8_matmul,
            "int8_matmul_dx": QM.int8_matmul_dx,
            "layernorm_fwd": TL.layernorm_fwd, "layernorm_bwd": TL.layernorm_bwd,
            "rmsnorm_fwd": TL.rmsnorm_fwd, "rmsnorm_bwd": TL.rmsnorm_bwd,
            "fused_ce_fwd": TC.fused_ce_fwd, "fused_ce_bwd": TC.fused_ce_bwd}


def small_train_cfg(remat_vision=False, remat_llm=False):
    """Phase 3's small training model: head dim 64 as at full width, LoRA
    r=4 with dropout 0.1, remat as given (off unless asked)."""
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    return simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=256, image_size=448, patch_size=56,
                      projector_out=128, gelu_approximate=True),
        llm=Qwen2Config(vocab_size=2048, hidden_size=128, num_layers=2, num_heads=2,
                        num_kv_heads=1, head_dim=64, intermediate_size=256,
                        lora_r=4, lora_alpha=8, lora_dropout=0.1),
        img_context_token_id=2000, remat_vision=remat_vision, remat_llm=remat_llm)


def small_train_params(torch, cfg):
    """Its seed-0 weights on the CPU, every LoRA B nonzero (every adapter
    in play)."""
    from simlingo_tpu_torch.models import simlingo
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for ab in _leaves(params["lora"]):
        ab.add_(0.01)
    return params


SMALL_REMAT_MODES = ((True, True), ("mlp", True))


def small_remat_steps(torch, dev, modes=SMALL_REMAT_MODES, batch_seed=1, step_seed=1234):
    """train_step of the small model on `dev` without remat and under each
    (remat_vision, remat_llm) of `modes`, from the same params, batch and
    seed; returns {mode: metrics (floats)}, mode (False, False) first."""
    import copy
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.train import train_step as ts
    params = small_train_params(torch, small_train_cfg())
    opt = ts.OptimizerConfig(lr=1e-4, total_steps=10)
    out = {}
    for mode in ((False, False),) + tuple(modes):
        cfg = small_train_cfg(*mode)
        state = ts.init_train_state(_to(copy.deepcopy(params), dev), opt)
        batch = synthetic_example(cfg, batch=2, seq_len=96, num_patches=2, seed=batch_seed,
                                  device=dev)
        step = ts.make_train_step(cfg, opt, compute_dtype=torch.bfloat16 if dev.type == "cuda"
                                  else torch.float32)
        out[mode] = {k: float(v) for k, v in step(state, batch, step_seed).items()}
    return out


def small_remat_agreement(torch, dev):
    """The small step with remat (SMALL_REMAT_MODES) on the GPU: its losses
    equal the step without remat on the same device (the forward's ops are
    the same; recomputation happens in the backward, with the same dropout
    masks), its grad norm within 1e-3 relative."""
    fns = kernel_fns()
    before = {k: fns[k].launches for k in ATTN_DROPOUT}
    runs = small_remat_steps(torch, dev)
    new = {k: fns[k].launches - n for k, n in before.items()}
    ref = runs[(False, False)]
    ok = True
    for mode, got in runs.items():
        if mode == (False, False):
            continue
        same = all(got[k] == ref[k] for k in ref if k != "grad_norm")
        rel = abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        good = same and rel <= 1e-3
        ok &= good
        log(f"[small] remat {mode} train_step loss {got['loss']:.6f} vs remat off "
            f"{ref['loss']:.6f}: losses equal {same}; grad_norm {got['grad_norm']:.6f} vs "
            f"{ref['grad_norm']:.6f} (rel {rel:.2e}, tol 1e-3) {'OK' if good else 'FAIL'}")
    want = {k: sum(train_launches_per_step(small_train_cfg(*mode))[k] for mode in runs)
            for k in new}
    good = new == want
    ok &= good
    log(f"[small] remat steps' launches (off, {', '.join(map(str, SMALL_REMAT_MODES))}): "
        f"{new}, reckoned {want} {'OK' if good else 'FAIL'}")
    return ok


def small_int4_cfg(tok):
    """A small model whose LLM reduction widths are multiples of 128 (the
    LLM of presets.small_shardable: 256 / 512, head dim 32, over the
    tokenizer's vocabulary)."""
    import dataclasses
    from simlingo_tpu_torch.core.presets import small_shardable
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.vit import ViTConfig
    return simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                      image_size=448, patch_size=56, projector_out=256),
        llm=dataclasses.replace(small_shardable().llm, vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id)


def small_int4_agreement(torch, dev):
    """The small int4 model (`small_int4_cfg`): drive_only waypoints of a
    LingoAgent with int4_llm=True on the GPU (bf16; the prompt's prefill
    takes the dense branch, the queries the grouped one) against the CPU
    (fp32)."""
    import numpy as np
    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    tok = SimLingoTokenizer()
    cfg = small_int4_cfg(tok)
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    acfg = dict(use_cot=False, int4_llm=True, initial_frames_delay=0, jpeg_roundtrip=False,
                warmup_compile=False)
    outs = []
    for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
        agent = LingoAgent(params, cfg, AgentConfig(**acfg), tokenizer=tok,
                           max_prompt_len=256, compute_dtype=dtype, device=device)
        outs.append(agent.run_step(_frame(AgentFrame, np)))
    q = agent.params["llm"]["layers"]["0"]["attn"]["q"]
    ref, got = outs
    scale = max(float(np.abs(ref["route"]).max()), float(np.abs(ref["speed_wps"]).max()))
    err = max(float(np.abs(got["route"] - ref["route"]).max()),
              float(np.abs(got["speed_wps"] - ref["speed_wps"]).max()))
    ok = (err <= 0.05 * scale and np.isfinite(got["route"]).all()
          and q["scale"].dim() == 2 and q["w_q"].shape[1] * 2 == cfg.llm.hidden_size)
    log(f"[small] int4 LLM (w_q {tuple(q['w_q'].shape)}, scale {tuple(q['scale'].shape)}) "
        f"drive_only waypoints GPU bf16 vs CPU fp32: max err {err:.3e} (tol 0.05 x "
        f"max|ref| = {0.05 * scale:.3e}) {'OK' if ok else 'FAIL'}")
    return ok


# The small step at fp32 on the card against the CPU's: the same fp32
# arithmetic (TF32 off), summed in other orders, relative
FP32_STEP_TOL = 1e-4
FP32_LN_GATE = {"SIMLINGO_LN_IMPL": "pallas"}
# the small steps' launches by tag (`small_training_agreement`)
SMALL_LAUNCHES = {}


def small_training_agreement(torch, dev, gated=False, int8_base=False, fp32=False):
    """One train_step of the small model (`small_train_cfg`, no remat) on
    the GPU (bf16, kernels) and on the CPU (fp32, plain versions), from the
    same params, batch and seed: the dropout masks are the same on both
    sides (Philox of the flat index), so the losses and grad norm agree.
    `gated`: with both fused-kernel gates on, on both sides (or a dict of
    gates). `int8_base`: the base LLM quantized to int8
    (core/quantize.quantize_llm) first. `fp32`: the GPU step at fp32 too
    (the kernels' fp32 instances, every launch theirs), held to
    FP32_STEP_TOL. Each run's launches go to SMALL_LAUNCHES under its tag."""
    import copy
    from simlingo_tpu_torch.core.quantize import quantize_llm
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.train import train_step as ts
    cfg = small_train_cfg()
    params = small_train_params(torch, cfg)
    if int8_base:
        params["llm"] = quantize_llm(params["llm"])
    opt = ts.OptimizerConfig(lr=1e-4, total_steps=10)
    metrics = {}
    fns = kernel_fns()
    watched = NEW_KERNELS + INT8_KERNELS + ATTN_DROPOUT
    tag = ("fp32 " if fp32 else "") + ("gated " if gated is True else "ln-gated " if gated
                                       else "int8-base " if int8_base else "")
    gpu_dtype = torch.float32 if fp32 else torch.bfloat16
    with gates_set(gated):
        for device, dtype in (("cpu", torch.float32), (dev, gpu_dtype)):
            state = ts.init_train_state(_to(copy.deepcopy(params), device), opt)
            batch = synthetic_example(cfg, batch=2, seq_len=96, num_patches=2, seed=1,
                                      device=device)
            step = ts.make_train_step(cfg, opt, compute_dtype=dtype)
            before = {k: fns[k].launches for k in watched}
            before32 = {k: getattr(fns[k], "launches_fp32", 0) for k in watched}
            metrics[str(device)] = {k: float(v) for k, v in step(state, batch, 1234).items()}
    new = {k: fns[k].launches - before[k] for k in watched}
    new32 = {k: getattr(fns[k], "launches_fp32", 0) - before32[k] for k in watched}
    ref, got = metrics["cpu"], metrics[str(dev)]
    ok = True
    for key, want in ref.items():
        tol = FP32_STEP_TOL if fp32 else 5e-2 if key == "grad_norm" else 2e-2
        good = math.isfinite(got[key]) and abs(got[key] - want) <= tol * abs(want)
        ok &= good
        log(f"[small] {tag}train_step {key:15s} GPU {'fp32' if fp32 else 'bf16'} "
            f"{got[key]:.7f} vs CPU fp32 {want:.7f} (rel diff "
            f"{abs(got[key] - want) / max(abs(want), 1e-30):.2e}, tol {tol}) "
            f"{'OK' if good else 'FAIL'}")
    log(f"[small] {tag}train_step launches on the GPU: {new}"
        + (f"; of them fp32 instances: {new32}" if fp32 else ""))
    SMALL_LAUNCHES["small_" + ("fp32_" if fp32 else "") + (
        "gated" if gated is True else "ln" if gated else "int8" if int8_base else "plain")] = dict(
        launches=new, launches_fp32=new32)
    must = (NEW_KERNELS if gated is True else ()) + (INT8_KERNELS if int8_base else ())
    if fp32:
        must = ATTN_DROPOUT + (NEW_KERNELS if gated is True else NEW_KERNELS[:4] if gated
                               else ()) + (INT8_KERNELS if int8_base else ())
    for name in must:
        if new[name] <= 0 or (fp32 and new32[name] != new[name]):
            log(f"[small] FAIL: kernel {name} was not launched (at fp32: only its fp32 "
                f"instance) in the {tag}step")
            ok = False
    return ok


# bench.py's BENCH_REMAT modes (:221-235) -> (remat_vision, remat_llm);
# "both" is SimLingoConfig()'s and presets.internvl2_1b's own (JAX's default)
REMAT_MODES = {"vision": (True, False), "llm": (False, True), "mlp": ("mlp", False),
               "both": (True, True)}
ATTN_DROPOUT = ("flash_attn_fwd", "flash_attn_bwd", "dropout")


def dropped_inputs_per_layer():
    """The LoRA inputs an LLM layer drops out, each by its own mask: the 7
    adapters', or with SIMLINGO_LORA_FUSED=1 (read now) 4: the q / k / v
    group's, o's, the gate / up group's and down's."""
    from simlingo_tpu_torch.core import gates
    return 4 if gates.lora_fused() else 7


def train_launches_per_step(m):
    """The attention and dropout kernels' launches of one training step,
    reckoned from the model: one attention forward and one backward a ViT
    layer (all 2 x batch tiles in one call) and an LLM layer, the forward
    once more a layer that remat recomputes whole (a ViT layer under
    remat_vision=True, whose first region re-runs the attention for its
    lse; an LLM layer under remat_llm); with LoRA dropout, three dropout
    launches (forward, the backward's regenerated mask, dx) for each input
    an LLM layer drops (`dropped_inputs_per_layer`: 7, or 4 with the fused
    LoRA groups), and one more each where the layer is recomputed."""
    V, L = m.vit.num_layers, m.llm.num_layers
    drop = m.llm.lora_r > 0 and m.llm.lora_dropout > 0
    return {"flash_attn_fwd": V * (2 if m.remat_vision is True else 1)
            + L * (2 if m.remat_llm else 1),
            "flash_attn_bwd": V + L,
            "dropout": dropped_inputs_per_layer() * L * (4 if m.remat_llm else 3)
            if drop else 0}


# the norm kernels' launches a step with SIMLINGO_LN_IMPL=pallas alone
LN_PER_STEP = {k: GATED_PER_STEP[k] for k in NEW_KERNELS[:4]}
CE_PER_STEP = {k: GATED_PER_STEP[k] for k in NEW_KERNELS[4:]}


def fp32_cell(gates, int8_base=False):
    """The name of a precision=fp32 training cell with `gates` set."""
    return ("train_fp32_int8" if int8_base else "train_fp32_gated"
            if "SIMLINGO_CE_IMPL" in gates else "train_fp32_ln" if gates else "train_fp32")


def fp32_per_step(gates, int8_base=False):
    """The norm, CE and int8 kernels' launches a step of a precision=fp32
    cell (the others' 0)."""
    per_step = dict(LN_PER_STEP) if "SIMLINGO_LN_IMPL" in gates else {}
    per_step.update(CE_PER_STEP if "SIMLINGO_CE_IMPL" in gates else {})
    per_step.update(INT8_PER_STEP if int8_base else {})
    return per_step


def full_width_training(torch, dev, gated=False, int8_base=False, remat=None,
                        lora_fused=False, fp32_gates=None):
    """presets.internvl2_1b(lora=True) through the trainer, with remat off
    unless `remat` names a REMAT_MODES mode (as `bench.py` runs it): 1
    warm-up step and TRAIN_STEPS timed steps; launches counted over the
    timed steps, the attention and dropout kernels' held exactly to
    `train_launches_per_step`. `gated`: with both fused-kernel gates set in
    the process environment (restored afterwards). `int8_base`: the same
    seed-0 params with the frozen base LLM quantized to int8 before the
    trainer takes them (`bench.py` BENCH_INT8_BASE=1). `lora_fused`: with
    SIMLINGO_LORA_FUSED=1 set instead (`train_lora_fused`), then the
    dropout-off pair on the run's state (`lora_fused_pair`). `fp32_gates`
    (a dict of gates, maybe empty): the run at precision=fp32 with those
    gates, on the int8 base with `int8_base` (`fp32_cell` names it): every
    launch of the attention, dropout, norm, CE and int8 kernels must be its
    fp32 instance's, the norms' held exactly to LN_PER_STEP where the LN
    gate is set, the CE's to GATED_PER_STEP where the CE gate is, the int8
    products' to INT8_PER_STEP on the int8 base, and none elsewhere."""
    if fp32_gates is not None:
        with gates_set(fp32_gates):
            return _full_width_training(torch, dev, False, int8_base, None, fp32=fp32_gates)
    with gates_set(LORA_FUSED if lora_fused else gated):
        return _full_width_training(torch, dev, gated, int8_base, remat, lora_fused)


def _full_width_training(torch, dev, gated, int8_base, remat, lora_fused=False, fp32=None):
    import dataclasses
    from simlingo_tpu_torch.core import presets
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.core.quantize import quantize_llm
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import trainer

    kernels = kernel_fns()
    tag = (f"[{fp32_cell(fp32, int8_base)}]" if fp32 is not None
           else "[train_gated]" if gated else "[train_int8]" if int8_base
           else f"[train_remat_{remat}]" if remat
           else "[train_lora_fused]" if lora_fused
           else "[train]")

    def reset_after_warmup(step, _):
        if step == 0:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
                if hasattr(fn, "launches_fp32"):
                    fn.launches_fp32 = 0

    cfg = compose([f"max_steps={1 + TRAIN_STEPS}", "data.batch_size=6",
                   "data.max_text_len=768", "seed=0", "output_dir="]
                  + (["precision=fp32"] if fp32 is not None else []))
    rv, rl = REMAT_MODES[remat] if remat else (False, False)
    cfg.model = dataclasses.replace(presets.internvl2_1b(lora=True), remat_vision=rv,
                                    remat_llm=rl)
    m = cfg.model
    log(f"{tag} presets.internvl2_1b(lora=True): ViT {m.vit.num_layers}x"
        f"{m.vit.hidden_size} ({m.vit.num_heads} heads, tanh GELU), Qwen2 "
        f"{m.llm.num_layers}x{m.llm.hidden_size} vocab {m.llm.vocab_size}, LoRA r="
        f"{m.llm.lora_r} alpha={m.llm.lora_alpha} dropout={m.llm.lora_dropout}; "
        f"batch {cfg.data.batch_size}, seq {cfg.data.max_text_len} + "
        f"{m.num_queries} queries, 2 tiles; remat_vision={m.remat_vision} "
        f"remat_llm={m.remat_llm}; "
        f"AdamW {dataclasses.asdict(cfg.optimizer)}{'; int8 base LLM' if int8_base else ''}"
        f"{'; SIMLINGO_LORA_FUSED=1' if lora_fused else ''}; precision {cfg.precision}"
        + (f", gates {fp32}" if fp32 else ""))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = None
    if int8_base:                 # the trainer's own init, then the int8 base
        params = simlingo.init_params(m, torch.Generator(device=dev).manual_seed(cfg.seed),
                                      device=dev)
        params["llm"] = quantize_llm(params["llm"])
    res = trainer.train(cfg, make_synthetic=True, params=params, device=dev,
                        after_step=reset_after_warmup)
    del params
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches_fp32 = {k: fn.launches_fp32 for k, fn in kernels.items()
                     if hasattr(fn, "launches_fp32")}
    peak = torch.cuda.max_memory_allocated()
    timed = res["records"][1:]
    ms = [r["ms"] for r in timed]
    ok = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
             for r in res["records"])
    mean_ms = sum(ms) / len(ms)
    log(f"{tag} timed steps: ms {[round(x, 2) for x in ms]} -> mean {mean_ms:.2f} "
        f"ms/step, {cfg.data.batch_size * 1e3 / mean_ms:.3f} samples/s")
    log(f"{tag} loss {[round(r['loss'], 5) for r in res['records']]} grad_norm "
        f"{[round(r['grad_norm'], 5) for r in res['records']]} finite="
        f"{'OK' if ok else 'FAIL'}")
    log(f"{tag} peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    log(f"{tag} launches over the {TRAIN_STEPS} timed steps: {launches}")
    for name, n in train_launches_per_step(m).items():
        good = launches[name] == n * TRAIN_STEPS
        ok &= good
        log(f"{tag} {name}: {launches[name]} launches, reckoned {n} a step x {TRAIN_STEPS} "
            f"= {n * TRAIN_STEPS} {'OK' if good else 'FAIL'}")
    must = list(ATTN_DROPOUT)
    if fp32 is not None:
        per_step = fp32_per_step(fp32, int8_base)
        must += list(per_step)
        log(f"{tag} fp32 instances' launches over the timed steps: {launches_fp32}")
        for name, n in launches_fp32.items():
            good = n == launches[name]
            ok &= good
            log(f"{tag} {name}: {n} of {launches[name]} launches by the fp32 instance "
                f"{'OK' if good else 'FAIL'}")
        for name in NEW_KERNELS + INT8_KERNELS:
            want = per_step.get(name, 0) * TRAIN_STEPS
            good = launches[name] == want
            ok &= good
            log(f"{tag} {name}: {launches[name]} launches, expected {want} "
                f"{'OK' if good else 'FAIL'}")
    elif gated:
        must += list(NEW_KERNELS)
        for name, per_step in GATED_PER_STEP.items():
            want = per_step * TRAIN_STEPS
            log(f"{tag} {name}: {launches[name]} launches, expected {per_step} per "
                f"step x {TRAIN_STEPS} = {want} "
                f"{'OK' if launches[name] == want else 'DIFFERS'}")
    else:
        log(f"{tag} fused kernels with the gates off: "
            f"{ {k: launches[k] for k in NEW_KERNELS} } (expected 0)")
    if int8_base and fp32 is None:
        must += list(INT8_KERNELS)
        for name, per_step in INT8_PER_STEP.items():
            want = per_step * TRAIN_STEPS
            log(f"{tag} {name}: {launches[name]} launches, expected {per_step} per "
                f"step x {TRAIN_STEPS} = {want} "
                f"{'OK' if launches[name] == want else 'DIFFERS'}")
    elif fp32 is None:
        log(f"{tag} int8 kernels on the bf16 base: "
            f"{ {k: launches[k] for k in INT8_KERNELS} } (expected 0)")
    for name in must:
        if launches[name] <= 0:
            log(f"{tag} FAIL: kernel {name} was not launched on the training path")
            ok = False
    stats = dict(step_ms=ms, mean_step_ms=mean_ms,
                 samples_per_s=cfg.data.batch_size * 1e3 / mean_ms,
                 records=res["records"], peak_bytes=peak, launches=launches,
                 launches_fp32=launches_fp32, precision=cfg.precision,
                 remat_vision=m.remat_vision, remat_llm=m.remat_llm)
    state, step_fn, batch = res["state"], res["step_fn"], res["batch"]
    stats["profile"] = device_profile(torch, lambda: step_fn(state, batch, 99),
                                      f"one training step {tag}")
    if lora_fused:
        good, stats["dropout_off_pair"] = lora_fused_pair(torch, state, batch, m)
        ok &= good
    return ok, stats


def lora_fused_pair(torch, state, batch, m):
    """The dropout-off pair of `train_lora_fused`: on the run's state after
    its steps (the LoRA B factors are zero at step 1, so a step-1 forward
    would not reach the group's B products) and its batch, the loss and
    the global norm of the trainable gradients without dropout, with the
    LoRA groups fused and unfused; held within PAIR_TOL relative (bf16
    products of one A, then the n B, against n pairs of products)."""
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import train_step as ts
    bf16 = torch.bfloat16
    got = {}
    for name, env in (("unfused", None), ("fused", LORA_FUSED)):
        with gates_set(env):
            state.optimizer.zero_grad(set_to_none=True)
            out, _ = simlingo.forward_loss(ts.cast_for_compute(state.params, bf16), batch, m,
                                           compute_dtype=bf16)
            out.loss.backward()
            grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                     for x in state.trainable.values()]
            got[name] = {"loss": float(out.loss.detach()),
                         "grad_norm": float(torch.linalg.vector_norm(
                             torch.stack(torch._foreach_norm(grads))))}
            del out, grads
            state.optimizer.zero_grad(set_to_none=True)
    ok = True
    for key, tol in PAIR_TOL.items():
        a, b = got["unfused"][key], got["fused"][key]
        good = math.isfinite(b) and abs(b - a) <= tol * abs(a)
        ok &= good
        log(f"[train_lora_fused] dropout-off pair {key}: fused {b:.6f} vs unfused {a:.6f} "
            f"(rel diff {abs(b - a) / abs(a):.3e}, tol {tol:.3e}; bit-identical {a == b}) "
            f"{'OK' if good else 'FAIL'}")
    return ok, got


def compare_lora_fused(plain, fused):
    """The fused LoRA groups' full-width steps beside phase 5's ungated run
    (same seed-0 params and batch; the masks differ by design, so the
    losses are information only): ms/step, peak memory, device time by
    kernel class, and the dropout launches a step."""
    n = {k: st["launches"]["dropout"] // TRAIN_STEPS for k, st in
         (("plain", plain), ("fused", fused))}
    log(f"[train_lora_fused] dropout launches a step {n['fused']} vs phase 5's {n['plain']}")
    for a, b in zip(plain["records"], fused["records"]):
        log(f"[train_lora_fused] step {a['step']}: loss {b['loss']:.5f} vs unfused "
            f"{a['loss']:.5f}; grad_norm {b['grad_norm']:.5f} vs {a['grad_norm']:.5f}; "
            f"ms {b['ms']:.2f} vs {a['ms']:.2f}")
    log_side_by_side("[train_lora_fused]", "fused", plain, fused)


def compare_remat(plain, remat, mode):
    """A remat mode's full-width steps beside the remat-off run's, from the
    same seed-0 params, batch and dropout seeds: losses within 2e-2
    relative (remat recomputes in the backward; the forward's ops are the
    same, so step 1's loss should be bit-identical), whether each is
    bit-identical, ms/step, peak memory and the profiled step's device
    time by kernel class side by side."""
    ok = True
    for a, b in zip(plain["records"], remat["records"]):
        good = abs(b["loss"] - a["loss"]) <= 2e-2 * abs(a["loss"])
        ok &= good
        log(f"[train_remat_{mode}] step {a['step']}: loss {b['loss']:.6f} vs remat off "
            f"{a['loss']:.6f} (rel tol 2e-2; bit-identical {b['loss'] == a['loss']}) "
            f"{'OK' if good else 'FAIL'}; grad_norm {b['grad_norm']:.6f} vs "
            f"{a['grad_norm']:.6f} (bit-identical {b['grad_norm'] == a['grad_norm']}); "
            f"ms {b['ms']:.2f} vs {a['ms']:.2f}")
    log(f"[train_remat_{mode}] peak {remat['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{plain['peak_bytes'] / 2 ** 30:.2f} GiB (saves "
        f"{(plain['peak_bytes'] - remat['peak_bytes']) / 2 ** 30:.2f} GiB)")
    log_side_by_side(f"[train_remat_{mode}]", f"remat {mode}", plain, remat)
    return ok


def compare_fp32(plain, fp32, others):
    """The precision=fp32 cells beside phase 5's bf16 run `plain`, from the
    same seed-0 params, batch and dropout seeds: `train_fp32`'s step-1 loss
    (same params) within the bf16 agreement's 2e-2 of the bf16 run's; each
    gated cell of `others` ({cell: stats}: `train_fp32_ln`,
    `train_fp32_gated`) with its losses and grad norms within
    FP32_STEP_TOL of `train_fp32`'s (the same fp32 math, the norms' and
    the CE's sums in another order); `train_fp32_int8`'s step-1 loss beside
    `train_fp32`'s (information only: int8 rounds the frozen LLM); ms/step,
    peak memory and device time by kernel class side by side."""
    ok = True
    a, b = plain["records"][0], fp32["records"][0]
    good = abs(b["loss"] - a["loss"]) <= 2e-2 * abs(a["loss"])
    ok &= good
    log(f"[train_fp32] step 1 loss {b['loss']:.6f} vs phase 5's bf16 {a['loss']:.6f} (rel "
        f"diff {abs(b['loss'] - a['loss']) / abs(a['loss']):.2e}, tol 2e-2) "
        f"{'OK' if good else 'FAIL'}; grad_norm {b['grad_norm']:.6f} vs {a['grad_norm']:.6f}")
    log_side_by_side("[train_fp32]", "fp32", plain, fp32)
    for cell, other in others.items():
        if cell == "train_fp32_int8":
            a, b = fp32["records"][0], other["records"][0]
            log(f"[{cell}] step 1 loss {b['loss']:.6f} vs train_fp32 {a['loss']:.6f} (rel diff "
                f"{abs(b['loss'] - a['loss']) / abs(a['loss']):.2e}; the int8 base: "
                f"information only); grad_norm {b['grad_norm']:.6f} vs {a['grad_norm']:.6f}")
        else:
            for a, b in zip(fp32["records"], other["records"]):
                for key in ("loss", "grad_norm"):
                    good = abs(b[key] - a[key]) <= FP32_STEP_TOL * abs(a[key])
                    ok &= good
                    log(f"[{cell}] step {a['step']} {key} {b[key]:.7f} vs train_fp32 "
                        f"{a[key]:.7f} (rel diff {abs(b[key] - a[key]) / abs(a[key]):.2e}, "
                        f"tol {FP32_STEP_TOL}) {'OK' if good else 'FAIL'}")
        log_side_by_side(f"[{cell}]", cell, fp32, other)
    return ok


def compare_training(plain, gated):
    """The ungated and the gated full-width step side by side; the losses
    agree to 2e-2 relative (the gated CE does not round the logits to bf16
    as the chunked CE's logits_fn(...).float() does)."""
    ok = True
    for a, b in zip(plain["records"], gated["records"]):
        good = abs(b["loss"] - a["loss"]) <= 2e-2 * abs(a["loss"])
        ok &= good
        log(f"[train_ab] step {a['step']}: loss {a['loss']:.5f} vs gated {b['loss']:.5f} "
            f"(rel tol 2e-2) {'OK' if good else 'FAIL'}; grad_norm {a['grad_norm']:.5f} "
            f"vs {b['grad_norm']:.5f}; ms {a['ms']:.2f} vs {b['ms']:.2f}")
    log_side_by_side("[train_ab]", "gated", plain, gated)
    return ok


def log_side_by_side(tag, what, plain, other):
    """Mean ms/step, samples/s, peak memory and the profiled step's device
    time by kernel class of two full-width runs."""
    pp, op = plain["profile"], other["profile"]
    log(f"{tag} mean ms/step {plain['mean_step_ms']:.2f} vs {what} "
        f"{other['mean_step_ms']:.2f}; samples/s {plain['samples_per_s']:.3f} vs "
        f"{other['samples_per_s']:.3f}; peak {plain['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{other['peak_bytes'] / 2 ** 30:.2f} GiB; profiled step device busy "
        f"{pp['device_busy_ms']:.2f} of {pp['wall_ms']:.2f} ms vs "
        f"{op['device_busy_ms']:.2f} of {op['wall_ms']:.2f} ms")
    for cls in sorted(set(pp["classes"]) | set(op["classes"])):
        a = pp["classes"].get(cls, {"ms": 0.0, "count": 0})
        b = op["classes"].get(cls, {"ms": 0.0, "count": 0})
        log(f"{tag} {cls:12s} device ms {a['ms']:9.3f} ({a['count']:6d}) vs {what} "
            f"{b['ms']:9.3f} ({b['count']:6d})")


def compare_int8_base(plain, int8):
    """The bf16-base and the int8-base full-width step side by side, from
    the same seed-0 params: information only (int8 rounds every frozen
    weight of the LLM)."""
    for a, b in zip(plain["records"], int8["records"]):
        log(f"[train_int8_ab] step {a['step']}: loss {a['loss']:.5f} vs int8 base "
            f"{b['loss']:.5f} (rel diff {abs(b['loss'] - a['loss']) / abs(a['loss']):.2e}); "
            f"grad_norm {a['grad_norm']:.5f} vs {b['grad_norm']:.5f}; "
            f"ms {a['ms']:.2f} vs {b['ms']:.2f}")
    log_side_by_side("[train_int8_ab]", "int8 base", plain, int8)


# ---------------------------------------------------------------------------
# Phases 3 and 6: SimLingo-Base (CarLLaVA)
# ---------------------------------------------------------------------------

BASE_GATE = {"SIMLINGO_LN_IMPL": "pallas"}
BASE_FWD_ITERS = 3          # timed forwards at each batch size (after 1 warm-up)
# SimLingo-Base's cells past the default (`base`: CLIP and the tiny LLaMA),
# as overrides of configs/simlingo_base.yaml: `base_wide`, the LLaMA
# `large` (22 x 2048, 16 heads of 128) behind the CLIP tower; `base_resnet`,
# the ResNet-18 encoder (2 tiles of 11 x 11 tokens) and the tiny LLaMA
BASE_CELLS = {"base": [], "base_wide": ["model.llm_variant=large"],
              "base_resnet": ["model.encoder=resnet"]}
BASE_GATED_CELLS = ("base", "base_wide")       # also run with SIMLINGO_LN_IMPL=pallas


def base_launches(cfg, gated=False):
    """Hand-kernel launches of one base forward ({"flash_attn_fwd": ...})
    or, with `gated`, of one training step with SIMLINGO_LN_IMPL=pallas:
    attention in CLIP's layers_run layers (24 + feature layer -2 + 1 = 23)
    and the LLaMA's; with the gate, CLIP's pre-LN and 2 LayerNorms a layer
    and the LLaMA's 2 RMSNorms a layer and its final one, forward and
    backward (every scale trains). Reckoned from the config: 35 / 45 / 12
    attention launches a forward for `base` / `base_wide` / `base_resnet`."""
    clip = cfg.clip.layers_run if cfg.encoder == "llavanext" else 0
    attn = clip + cfg.llm.num_layers
    if not gated:
        return {"flash_attn_fwd": attn}
    ln, rms = (1 + 2 * clip if clip else 0), 2 * cfg.llm.num_layers + 1
    return {"flash_attn_fwd": attn, "flash_attn_bwd": attn, "layernorm_fwd": ln,
            "layernorm_bwd": ln, "rmsnorm_fwd": rms, "rmsnorm_bwd": rms}


def small_base_cfgs():
    """The small SimLingo-Base configurations run GPU against CPU: JAX's
    SimLingoBaseConfig.tiny() (CLIP 64 wide, 4 heads of 16, on 56-pixel
    tiles: 17 tokens; the `debug` LLaMA, 2 heads of 16: 10 + 33 = 43
    tokens) and the same with the ResNet-18 16 wide with 48-wide tokens
    (2 x 2 tokens a tile, 8 + 33 = 41; `language_projection` to 32)."""
    import dataclasses
    from simlingo_tpu_torch.models.resnet import ResNetConfig
    from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
    tiny = SimLingoBaseConfig.tiny()
    return {"tiny": tiny,
            "tiny_resnet": dataclasses.replace(tiny, encoder="resnet",
                                               resnet=ResNetConfig(width=16, token_size=48))}


def small_base_agreement(torch, dev):
    """Each of `small_base_cfgs` from one seed: the forward's waypoints on
    the GPU (bf16, kernels) against the CPU plain path (fp32), then one base
    training step on each (losses to 2e-2 relative, each group's grad norm
    to 5e-2), which must launch each attention kernel once a layer."""
    import copy
    import numpy as np
    from simlingo_tpu_torch.data.synthetic import base_batch
    from simlingo_tpu_torch.models import simlingo_base
    from simlingo_tpu_torch.train import base_step
    from simlingo_tpu_torch.train import train_step as ts
    ok = True
    for name, cfg in small_base_cfgs().items():
        tag = f"[small] {name}"
        params = simlingo_base.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = base_batch(np.random.RandomState(1), 2, cfg.clip.image_size, device="cpu")
        outs = []
        with torch.no_grad():
            for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
                p = ts.cast_for_compute(_to(params, device), dtype)
                outs.append(simlingo_base.forward(p, *(x.to(device) for x in batch[:3]), cfg))
        ref, got = ({k: v.float().cpu().numpy() for k, v in o.items()} for o in outs)
        scale = max(float(np.abs(ref[k]).max()) for k in ref)
        err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
        good = err <= 0.05 * scale and all(np.isfinite(got[k]).all() for k in got)
        ok &= good
        log(f"{tag} base forward waypoints GPU bf16 vs CPU fp32: max err {err:.3e} "
            f"(tol 0.05 x max|ref| = {0.05 * scale:.3e}) {'OK' if good else 'FAIL'}")
        opt = ts.OptimizerConfig(lr=1e-4, total_steps=10, grad_clip=1.0)
        fns = kernel_fns()
        metrics = {}
        for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
            state = base_step.init_base_state(_to(copy.deepcopy(params), device), opt)
            step = base_step.make_base_train_step(cfg, opt, compute_dtype=dtype)
            before = {k: fns[k].launches for k in ("flash_attn_fwd", "flash_attn_bwd")}
            metrics[str(device)] = {k: float(v) for k, v in
                                    step(state, [x.to(device) for x in batch]).items()}
        new = {k: fns[k].launches - before[k] for k in before}
        cpu, gpu = metrics["cpu"], metrics[str(dev)]
        for key, want in cpu.items():
            tol = 5e-2 if key.startswith("grad_norm") else 2e-2
            good = abs(gpu[key] - want) <= tol * abs(want)
            ok &= good
            log(f"{tag} base train_step {key:17s} GPU bf16 {gpu[key]:.6f} vs CPU fp32 "
                f"{want:.6f} (rel tol {tol}) {'OK' if good else 'FAIL'}")
        per = base_launches(cfg)["flash_attn_fwd"]
        good = all(n == per for n in new.values())      # one a layer, forward and backward
        ok &= good
        log(f"{tag} base train_step attention launches on the GPU {new} (expected {per} "
            f"each: head_dim {cfg.llm.head_dim}) {'OK' if good else 'FAIL'}")
    return ok


def _check_launches(tag, launches, per_unit, units, what):
    """Launch counts against per_unit x units, exactly; logs each."""
    ok = True
    for name, per in per_unit.items():
        want = per * units
        good = launches.get(name, 0) == want
        ok &= good
        log(f"{tag} {name}: {launches.get(name, 0)} launches, expected {per} {what} x "
            f"{units} = {want} {'OK' if good else 'FAIL'}")
    return ok


ATTN_KERNELS = ("flash_attn_fwd", "flash_attn_bwd")


def dim_launches(fns):
    """{attention kernel: {built head dim: launches so far}}."""
    return {k: dict(fns[k].launches_by_dim) for k in ATTN_KERNELS}


def dim_launches_since(fns, before):
    """The attention kernels' launches by head dim since `before`."""
    now = dim_launches(fns)
    return {k: {d: n - before[k].get(d, 0) for d, n in now[k].items()
                if n != before[k].get(d, 0)} for k in ATTN_KERNELS}


def _base_cfg(cell, *extra):
    """configs/simlingo_base.yaml with the cell's overrides (seed 0, nothing
    written)."""
    from simlingo_tpu_torch.core.config import compose_base
    return compose_base("configs/simlingo_base.yaml",
                        BASE_CELLS[cell] + ["seed=0", "output_dir=", *extra])


def base_forward(torch, dev, cell="base"):
    """The base model's `forward` at full width (the cell's config of
    configs/simlingo_base.yaml: CLIP ViT-L/14-336 with LLaVA-NeXT features,
    or the ResNet-18; the LLaMA `tiny` or `large`) from seed-0 fp32 weights
    in a bf16 compute copy: one counted forward at batch 16, then
    BASE_FWD_ITERS timed forwards at batch 1 (one frame, two 336 tiles)
    and at batch 16."""
    import numpy as np
    from simlingo_tpu_torch.data.synthetic import base_batch
    from simlingo_tpu_torch.models import simlingo_base
    from simlingo_tpu_torch.train import train_step as ts
    tag = f"[{cell}_fwd]"
    cfg = _base_cfg(cell).model
    S = cfg.clip.image_size
    params = simlingo_base.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                       device=dev)
    n = sum(t.numel() for t in _leaves(params))
    vision = (f"CLIP {cfg.clip.layers_run} of {cfg.clip.num_layers}x{cfg.clip.hidden_size} "
              f"({cfg.clip.num_heads} heads), projector {cfg.clip.projector_hidden}"
              if cfg.encoder == "llavanext" else
              f"ResNet-{cfg.resnet.depth} width {cfg.resnet.width}, tokens "
              f"{cfg.resnet.token_size}")
    log(f"{tag} {vision}, LLaMA '{cfg.llm_variant}' {cfg.llm.num_layers}x"
        f"{cfg.llm.hidden_size} ({cfg.llm.num_heads} heads of {cfg.llm.head_dim}); "
        f"{n / 1e6:.1f} M fp32 params (seed 0), bf16 compute copy")
    ok, stats = True, {}
    with torch.no_grad():
        cp = ts.cast_for_compute(params)
        del params
        batches = {B: base_batch(np.random.RandomState(B), B, S, device=dev) for B in (1, 16)}
        for B in (1, 16):                                   # warm-up
            simlingo_base.forward(cp, *batches[B][:3], cfg)
        torch.cuda.synchronize()
        fns = kernel_fns()
        for fn in fns.values():
            fn.launches = 0
        by_dim = dim_launches(fns)
        out = simlingo_base.forward(cp, *batches[16][:3], cfg)        # the counted run
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in fns.items()}
        by_dim = dim_launches_since(fns, by_dim)
        ok &= _check_launches(tag, launches, base_launches(cfg), 1, "a forward")
        log(f"{tag} attention launches by head dim: {by_dim['flash_attn_fwd']}")
        T = simlingo_base.vision_tokens(cp, batches[1][0], cfg).shape[1] + 33
        for key, shape in (("route", (16, 20, 2)), ("speed_wps", (16, 10, 2))):
            good = tuple(out[key].shape) == shape and bool(torch.isfinite(out[key]).all())
            ok &= good
            log(f"{tag} {key} {tuple(out[key].shape)} finite "
                f"{'OK' if good else 'FAIL'}; last waypoint of sample 0 "
                f"{out[key][0, -1].float().cpu().numpy().round(4).tolist()}")
        for B in (1, 16):
            ms = []
            for _ in range(BASE_FWD_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                simlingo_base.forward(cp, *batches[B][:3], cfg)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            stats[f"batch{B}_ms"] = ms
            log(f"{tag} batch {B:2d} ({2 * B} tiles, T = {T}): ms "
                f"{[round(x, 3) for x in ms]} -> mean {sum(ms) / len(ms):.3f} ms, "
                f"{B * 1e3 * len(ms) / sum(ms):.2f} samples/s")
        stats["profile_batch16"] = device_profile(
            torch, lambda: simlingo_base.forward(cp, *batches[16][:3], cfg),
            f"one {cell} forward at batch 16")
    del cp, batches
    torch.cuda.empty_cache()
    stats.update(launches=launches, launches_by_dim=by_dim, params=n, tokens=T)
    return ok, stats


def bn_state_follows_adamw(torch, state, step_fn, batch, tag):
    """One more step, checking the ResNet's running statistics: each moves
    exactly as AdamW moves a parameter of the "rest" group from its own
    (clipped) gradient, recomputed here from the optimizer's state before
    the step, and nothing else touches them (the encoder runs with
    training=False, so no batch statistic enters), as JAX's optax chain
    treats the `bn_state` leaves of its parameter tree."""
    from simlingo_tpu_torch.train import base_step
    from simlingo_tpu_torch.train import train_step as ts
    leaves = {p: x for p, x in ts.flatten(state.params).items() if p.startswith("bn_state/")}
    group = state.optimizer.param_groups[base_step.GROUPS.index("rest")]
    before = {p: (x.detach().clone(), {k: v.clone() for k, v in state.optimizer.state[x].items()})
              for p, x in leaves.items()}
    step_fn(state, batch)
    torch.cuda.synchronize()
    lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
    worst, grad = 0.0, 0.0
    for p, x in leaves.items():
        x0, st = before[p]
        g, t = x.grad, float(st["step"]) + 1
        m = b1 * st["exp_avg"] + (1 - b1) * g
        v = b2 * st["exp_avg_sq"] + (1 - b2) * g * g
        want = x0 * (1 - lr * wd) - (lr / (1 - b1 ** t)) * m / (
            v.sqrt() / math.sqrt(1 - b2 ** t) + eps)
        worst = max(worst, float(((x.detach() - want).abs() / (1e-6 * want.abs() + 1e-9)).max()))
        grad = max(grad, float(g.abs().max()))
    ok = worst <= 1.0 and grad > 0
    log(f"{tag} bn_state: {len(leaves)} leaves, one step against AdamW replayed from their "
        f"gradients (max |grad| {grad:.3e}, lr {lr:.3e}): err/tol {worst:.3f} (tol 1e-6 |x| "
        f"+ 1e-9) {'OK' if ok else 'FAIL'}")
    return ok


def base_training(torch, dev, cell="base", gated=False):
    """`train_base_torch`'s trainer on the cell's config of
    configs/simlingo_base.yaml (batch 16, a new synthetic batch a step from
    seed 0; nothing written): 1 warm-up step, TRAIN_STEPS timed steps
    (launches counted over them), peak memory, and a profile of one more
    step; with the ResNet, one step more checking its running statistics
    (`bn_state_follows_adamw`). `gated`: with SIMLINGO_LN_IMPL=pallas set in
    the process environment (restored afterwards)."""
    import dataclasses
    from simlingo_tpu_torch.train import trainer
    tag = f"[{cell}_train_gated]" if gated else f"[{cell}_train]"
    kernels = kernel_fns()
    by_dim = {}

    def reset_after_warmup(step, _):
        if step == 0:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
            by_dim.update(dim_launches(kernels))

    cfg = _base_cfg(cell, f"max_steps={1 + TRAIN_STEPS}")
    log(f"{tag} configs/simlingo_base.yaml + {BASE_CELLS[cell]}: batch "
        f"{cfg.data.batch_size}, 2 tiles of {cfg.model.clip.image_size}, encoder "
        f"{cfg.model.encoder}, LLaMA '{cfg.model.llm_variant}', vision lr x 0.1, no remat; "
        f"AdamW {dataclasses.asdict(cfg.optimizer)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with gates_set(BASE_GATE if gated else None):
        res = trainer.train_base(cfg, device=dev, after_step=reset_after_warmup)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        by_dim = dim_launches_since(kernels, by_dim)
        peak = torch.cuda.max_memory_allocated()
        state, step_fn, batch = res["state"], res["step_fn"], res["batch"]
        profile = device_profile(torch, lambda: step_fn(state, batch),
                                 f"one base training step {tag}")
        ok = (bn_state_follows_adamw(torch, state, step_fn, batch, tag)
              if cfg.model.encoder == "resnet" else True)
    del state, step_fn, batch
    timed = res["records"][1:]
    ms = [r["ms"] for r in timed]
    mean_ms = sum(ms) / len(ms)
    ok &= all(math.isfinite(r[k]) for r in res["records"]
              for k in ("loss", "grad_norm_vision", "grad_norm_rest"))
    log(f"{tag} timed steps: ms {[round(x, 2) for x in ms]} -> mean {mean_ms:.2f} ms/step, "
        f"{cfg.data.batch_size * 1e3 / mean_ms:.3f} samples/s (batch drawn and copied "
        f"before each: {[round(r['batch_ms'], 1) for r in timed]} ms)")
    log(f"{tag} loss {[round(r['loss'], 5) for r in res['records']]} grad norms vision "
        f"{[round(r['grad_norm_vision'], 4) for r in res['records']]} rest "
        f"{[round(r['grad_norm_rest'], 4) for r in res['records']]} finite="
        f"{'OK' if ok else 'FAIL'}")
    log(f"{tag} peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    per_step = base_launches(cfg.model, gated=True)
    if not gated:
        per_step = {k: per_step[k] for k in ("flash_attn_fwd", "flash_attn_bwd")}
    ok &= _check_launches(tag, launches, per_step, TRAIN_STEPS, "a step")
    log(f"{tag} attention launches by head dim over the timed steps: {by_dim}")
    if not gated:
        log(f"{tag} norm kernels with the gate off: "
            f"{ {k: launches[k] for k in NEW_KERNELS} } (expected 0)")
    stats = dict(step_ms=ms, mean_step_ms=mean_ms,
                 samples_per_s=cfg.data.batch_size * 1e3 / mean_ms, batch=cfg.data.batch_size,
                 records=res["records"], peak_bytes=peak, launches=launches,
                 launches_by_dim=by_dim,
                 launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
                 profile=profile)
    torch.cuda.empty_cache()
    return ok, stats


def compare_base_training(plain, gated, cell="base"):
    """The ungated and the gated base steps side by side from the same seed
    and batches: losses within 2e-2 relative."""
    ok = True
    for a, b in zip(plain["records"], gated["records"]):
        good = abs(b["loss"] - a["loss"]) <= 2e-2 * abs(a["loss"])
        ok &= good
        log(f"[{cell}_train_ab] step {a['step']}: loss {a['loss']:.5f} vs gated "
            f"{b['loss']:.5f} (rel tol 2e-2) {'OK' if good else 'FAIL'}; ms "
            f"{a['ms']:.2f} vs {b['ms']:.2f}")
    log_side_by_side(f"[{cell}_train_ab]", "gated", plain, gated)
    return ok


def run_base_phases(torch, dev, smi, cells=tuple(BASE_CELLS)):
    """Phase 6 over SimLingo-Base's cells: each cell's forward, its
    training steps and, for BASE_GATED_CELLS, the gated steps beside them;
    returns (ok, {path: launches}, {path: attention launches by head dim})
    and writes chiprun_out/chip_smoke_<cell>_{fwd,train,train_gated}.json."""
    launches, by_dim = {}, {}
    for cell in cells:
        runs = {}
        ok, runs[f"{cell}_fwd"] = base_forward(torch, dev, cell)
        if not ok:
            return False, None, None
        ok, runs[f"{cell}_train"] = base_training(torch, dev, cell)
        if not ok:
            return False, None, None
        if cell in BASE_GATED_CELLS:
            ok, runs[f"{cell}_train_gated"] = base_training(torch, dev, cell, gated=True)
            if not ok or not compare_base_training(runs[f"{cell}_train"],
                                                   runs[f"{cell}_train_gated"], cell):
                return False, None, None
        for name, st in runs.items():
            with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
                json.dump(dict(st, nvidia_smi=smi), f, indent=1)
            launches[name], by_dim[name] = st["launches"], st["launches_by_dim"]
    return True, launches, by_dim


# ---------------------------------------------------------------------------
# Phase 7: training from a dataset on disk, with checkpoints
# ---------------------------------------------------------------------------

DISK_ROUTES = (("routes_training/Town12_Rep0_0", 40), ("routes_training/Town12_Rep0_1", 40),
               ("routes_validation/Town13_Rep0_0", 30))
DISK_STEPS = 6              # 1 warm-up + 5 timed steps; the resumed run starts at 3
DISK_CKPT_EVERY = 3
COMMENTARY = ("Follow the route at a steady speed.", "Keep the lane, the road ahead is clear.",
              "Slow down slightly for the curve ahead.")
VQA = (("What should the ego vehicle do?", "Keep driving along the lane."),
       ("Is there a traffic light?", "There is no traffic light affecting the ego vehicle."),
       ("What is the navigation command?", "The navigation command is to follow the road."))
DREAMER = (("Drive a bit slower.", True, 0.8), ("Stop the car now.", False, 0.0),
           ("Speed up a little.", True, 1.2))


def host_probe():
    """What the card's machine offers the data path: the Python modules it
    may lack, g++, libjpeg's header, nvJPEG's header, and the free space of
    the temporary directory."""
    import importlib.util
    import tempfile
    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "PIL", "yaml", "safetensors", "matplotlib", "transformers")}
    gxx = shutil.which("g++")
    ver = subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout \
        .splitlines()[0] if gxx else None
    jpeglib = gxx is not None and subprocess.run(
        [gxx, "-x", "c++", "-E", "-"], input="#include <jpeglib.h>\n", capture_output=True,
        text=True).returncode == 0
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvjpeg = os.path.exists(os.path.join(cuda_home, "include", "nvjpeg.h"))
    df = subprocess.run(["df", "-h", tempfile.gettempdir()], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    return dict(modules=mods, gxx=ver, jpeglib_h=jpeglib, nvjpeg_h=nvjpeg, df_tmp=df)


def write_disk_routes(root, np, routes=DISK_ROUTES):
    """`routes` (by default two training routes of 40 frames and a
    validation route of 30) in the dataset's layout: gz JSON measurements
    (a gentle left curve at 5 m/s, 4 Hz), results.json.gz, commentary, VQA
    and dreamer files, and rgb/ and rgb_augmented/ frames copied from
    tests/data/torch_frames/."""
    import glob
    import gzip
    frames = [open(p, "rb").read() for p in
              sorted(glob.glob(os.path.join(ROOT, "tests", "data", "torch_frames", "*.jpg")))]
    if len(frames) != 4:
        raise RuntimeError(f"expected 4 frames in tests/data/torch_frames, found {len(frames)}")

    def gz(path, obj):
        with gzip.open(path, "wt") as f:
            json.dump(obj, f)

    for rel, n in routes:
        r = [rel_ for rel_, _ in DISK_ROUTES].index(rel)
        route = os.path.join(root, "data", "simlingo", "v1", "b0", rel)
        for sub in ("measurements", "rgb", "rgb_augmented", "commentary", "vqa", "dreamer"):
            os.makedirs(os.path.join(route, sub))
        for i in range(n):
            yaw = 0.01 * i
            x, y = 1.25 * i, 0.006 * i * i
            c, s = math.cos(yaw), math.sin(yaw)
            m = {"pos_global": [x, y], "theta": yaw, "speed": 5.0, "target_speed": 5.0,
                 "speed_limit": 30.0, "target_point": [20.0, 0.8 + 0.01 * i],
                 "target_point_next": [40.0, 2.5], "command": 4 if i % 10 else 1,
                 "next_command": 4, "route": [[float(j), 0.03 * j] for j in range(1, 40)],
                 "route_original": [[float(j), 0.02 * j] for j in range(1, 40)],
                 "changed_route": False, "augmentation_translation": 0.5,
                 "augmentation_rotation": 3.0,
                 "ego_matrix": [[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, 0], [0, 0, 0, 1]],
                 "steer": 0.01, "throttle": 0.5, "brake": False}
            stem = f"{i:04}"
            gz(os.path.join(route, "measurements", f"{stem}.json.gz"), m)
            for sub, k in (("rgb", i + r), ("rgb_augmented", i + r + 2)):
                with open(os.path.join(route, sub, f"{stem}.jpg"), "wb") as f:
                    f.write(frames[k % 4])
            text = COMMENTARY[i % 3]
            gz(os.path.join(route, "commentary", f"{stem}.json.gz"),
               {"commentary": text, "commentary_template": text, "placeholder": {}})
            q, a = VQA[i % 3]
            gz(os.path.join(route, "vqa", f"{stem}.json.gz"),
               {"QA": {"behaviour": [{"Q": q, "A": a}],
                       "navigation": [{"Q": VQA[2][0], "A": VQA[2][1]}]},
                "key_object_infos": {}})
            options = [{"mode": "target_speed", "route": "org",
                        "waypoints": [[1.25 * f * (k + 1), 0.0] for k in range(10)],
                        "dreamer_instruction": [instr], "safe_to_execute": safe,
                        "dreamer_answer_safety": "Ignore the instruction: it is unsafe. "
                                                 "Waypoints:"}
                       for instr, safe, f in DREAMER]
            gz(os.path.join(route, "dreamer", f"{stem}.json.gz"), {"target_speed": options})
        gz(os.path.join(route, "results.json.gz"),
           {"scores": {"score_composed": 100.0, "score_route": 100.0}, "num_infractions": 0,
            "infractions": {"min_speed_infractions": [], "outside_route_lanes": []}})


def simlingo_state_dict(cfg, torch, dev, lora_targets=("q_proj", "v_proj"), lora_r=32):
    """A random bf16 state dict of a trained SimLingo (RenzKa/simlingo's
    layout: InternVL2-1B's remote-code vision tower and mlp1 projector, a
    peft-wrapped Qwen2 with LoRA on `lora_targets`, the driving adaptors
    and the waypoint encoder), its names and shapes from `cfg`."""
    g = torch.Generator(device=dev).manual_seed(11)

    def t(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.02).to(torch.bfloat16)

    v, l = cfg.vit, cfg.llm
    H, I, P = v.hidden_size, v.intermediate_size, v.patch_size
    sd = {}
    vp = "vision_model.model.vision_model."
    sd[vp + "embeddings.patch_embedding.weight"] = t(H, 3, P, P)
    sd[vp + "embeddings.patch_embedding.bias"] = t(H)
    sd[vp + "embeddings.class_embedding"] = t(1, 1, H)
    sd[vp + "embeddings.position_embedding"] = t(1, (v.image_size // P) ** 2 + 1, H)
    for i in range(v.num_layers):
        lp = vp + f"encoder.layers.{i}."
        for name, shape in (("attn.qkv.weight", (3 * H, H)), ("attn.qkv.bias", (3 * H,)),
                            ("attn.proj.weight", (H, H)), ("attn.proj.bias", (H,)),
                            ("norm1.weight", (H,)), ("norm1.bias", (H,)),
                            ("norm2.weight", (H,)), ("norm2.bias", (H,)),
                            ("ls1", (H,)), ("ls2", (H,)), ("mlp.fc1.weight", (I, H)),
                            ("mlp.fc1.bias", (I,)), ("mlp.fc2.weight", (H, I)),
                            ("mlp.fc2.bias", (H,))):
            sd[lp + name] = t(*shape)
    pin = int(H / v.downsample_ratio ** 2)
    mp, O = "vision_model.model.mlp1.", v.projector_out
    for name, shape in (("0.weight", (pin,)), ("0.bias", (pin,)), ("1.weight", (O, pin)),
                        ("1.bias", (O,)), ("3.weight", (O, O)), ("3.bias", (O,))):
        sd[mp + name] = t(*shape)
    Hl, D = l.hidden_size, l.head_dim
    pre = "language_model.model.base_model.model.model."
    sd[pre + "embed_tokens.weight"] = t(l.vocab_size, Hl)
    sd[pre + "norm.weight"] = t(Hl)
    proj = {"q_proj": (l.num_heads * D, Hl, True), "k_proj": (l.num_kv_heads * D, Hl, True),
            "v_proj": (l.num_kv_heads * D, Hl, True), "o_proj": (Hl, l.num_heads * D, False)}
    for i in range(l.num_layers):
        lp = pre + f"layers.{i}."
        sd[lp + "input_layernorm.weight"] = t(Hl)
        sd[lp + "post_attention_layernorm.weight"] = t(Hl)
        mods = {f"self_attn.{k}": v_ for k, v_ in proj.items()}
        mods.update({"mlp.gate_proj": (l.intermediate_size, Hl, False),
                     "mlp.up_proj": (l.intermediate_size, Hl, False),
                     "mlp.down_proj": (Hl, l.intermediate_size, False)})
        for mod, (dout, din, bias) in mods.items():
            if mod.split(".")[1] in lora_targets:
                sd[f"{lp}{mod}.base_layer.weight"] = t(dout, din)
                sd[f"{lp}{mod}.lora_A.default.weight"] = t(lora_r, din)
                sd[f"{lp}{mod}.lora_B.default.weight"] = t(dout, lora_r)
                if bias:
                    sd[f"{lp}{mod}.base_layer.bias"] = t(dout)
            else:
                sd[f"{lp}{mod}.weight"] = t(dout, din)
                if bias:
                    sd[f"{lp}{mod}.bias"] = t(dout)
    M = cfg.adaptor_mlp_dim
    sd["adaptors.driving.query_embeds_wps"] = t(1, 20, Hl)
    sd["adaptors.driving.query_embeds_speed"] = t(1, 10, Hl)
    for i, (din, dout, bias) in enumerate(((Hl, 2 * M, True), (2 * M, M, True), (M, 2, False))):
        sd[f"adaptors.driving.route_head.{2 * i}.weight"] = t(dout, din)
        if bias:
            sd[f"adaptors.driving.route_head.{2 * i}.bias"] = t(dout)
    for i, (din, dout, bias) in enumerate(((Hl, M, True), (M, 2, False))):
        sd[f"adaptors.driving.speed_wps_head.{2 * i}.weight"] = t(dout, din)
        if bias:
            sd[f"adaptors.driving.speed_wps_head.{2 * i}.bias"] = t(dout)
    for i, (din, dout) in enumerate(((2, M), (M, 2 * M), (2 * M, Hl))):
        sd[f"wp_encoder.mlp.{2 * i}.weight"] = t(dout, din)
        sd[f"wp_encoder.mlp.{2 * i}.bias"] = t(dout)
    return {k: x.cpu() for k, x in sd.items()}


def host_batch_ms(cfg, torch, dev, steps=(0, 1, 2)):
    """A batch as the trainer's workers make it (picks, samples, collate,
    the pinned copy), timed on this thread alone: ms of each part."""
    import numpy as np
    from simlingo_tpu_torch.data.collate import CollateConfig, collate, to_device
    from simlingo_tpu_torch.data.sampler import WeightedBucketSampler
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.train import trainer
    buckets, datasets = trainer.build_buckets(cfg)
    sampler, tok = WeightedBucketSampler(buckets, seed=cfg.seed), SimLingoTokenizer()
    ccfg = CollateConfig(max_text_len=cfg.data.max_text_len,
                         num_image_tokens=cfg.model.vit.tokens_per_patch_image
                         * cfg.data.base.max_num_grid)
    out = []
    for step in steps:
        t0 = time.perf_counter()
        rng = np.random.RandomState(cfg.seed * 7919 + step)
        samples = [datasets[b].get(i, rng)
                   for b, i in sampler.batch_at(step, cfg.data.batch_size)]
        t1 = time.perf_counter()
        ex = collate(samples, tok, ccfg)
        t2 = time.perf_counter()
        to_device(ex, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.append(dict(samples_ms=(t1 - t0) * 1e3, collate_ms=(t2 - t1) * 1e3,
                        copy_ms=(t3 - t2) * 1e3))
    return out


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def disk_training(torch, dev, work):
    """`trainer.train` on routes on disk at full width (configs/simlingo.yaml
    composed as `train.py` composes it: JAX's default model
    SimLingoConfig(), remat on in both towers, no LoRA, the exact GELU,
    the base LLM frozen; batch 6, 768 tokens, the 16 driving buckets and
    the dreamer mix): 1 + 5 steps with an async checkpoint at step 3,
    validation and a final checkpoint; a second run resumed from step 3 to
    step 6 whose losses and final parameters must equal the straight
    run's; checkpoint size, save (blocking, async) and restore times; then
    a random trained-SimLingo state dict (InternVL2-1B remote-code names,
    peft LoRA) written as a .pt, loaded through `hf_checkpoint=` into
    presets.internvl2_1b(lora=True), the model it holds (a sliced qkv leaf
    and a LoRA-merged leaf checked against the written tensors), and
    trained 2 steps to a final checkpoint. All of it in `work`, which the
    caller removes; returns (ok, stats, {"final_checkpoint": that 2-step
    run's checkpoint, which `eval_language_torch.py`'s preset reads,
    "hf_checkpoint": the .pt}) for phases 8 and 9."""
    import numpy as np
    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core import presets
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data import imageio
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    tag = "[train_disk]"
    probe = host_probe()
    log(f"{tag} host: {json.dumps(probe)}")
    decoder = imageio.decoder()
    log(f"{tag} JPEG decoder: {decoder[0]}"
        + (f" (native loader unavailable: {decoder[1]})" if decoder[1] else ""))
    kernels = kernel_fns()
    t0 = time.perf_counter()
    write_disk_routes(os.path.join(work, "db"), np)
    log(f"{tag} routes written in {time.perf_counter() - t0:.2f} s: "
        f"{[f'{rel} ({n} frames)' for rel, n in DISK_ROUTES]}")

    def cfg_for(out, *extra):
        return compose("configs/simlingo.yaml", [
            f"data.data_root={os.path.join(work, 'db')}", "data.base.use_town13=false",
            f"max_steps={DISK_STEPS}", f"checkpoint_every_n_steps={DISK_CKPT_EVERY}",
            "val_max_batches=2", "data.num_workers=8", "log_every_n_steps=1",
            "visualise_every_n_steps=0", f"output_dir={out}", "name=disk", *extra])

    per_step = []

    def count_steps(step, _):
        if step == 0:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
        elif step == 4:                       # steps 2-5: no validation inside
            per_step.append({k: fn.launches / 4 for k, fn in kernels.items()})

    cfg = cfg_for(os.path.join(work, "straight"))
    m = cfg.model
    one_thread = host_batch_ms(cfg, torch, dev)
    log(f"{tag} one batch on one thread (no training running): samples "
        f"{[round(x['samples_ms'], 1) for x in one_thread]} ms, collate "
        f"{[round(x['collate_ms'], 1) for x in one_thread]} ms, pack + copy "
        f"{[round(x['copy_ms'], 1) for x in one_thread]} ms")
    log(f"{tag} configs/simlingo.yaml: seed {cfg.seed}, batch {cfg.data.batch_size}, "
        f"{cfg.data.max_text_len} tokens, {len(cfg.data.train_partitions)} driving buckets "
        f"+ dreamer, workers {cfg.data.num_workers}; model (JAX's default) ViT "
        f"{m.vit.num_layers}x{m.vit.hidden_size} (GELU {'tanh' if m.vit.gelu_approximate else 'exact'}"
        f"), Qwen2 {m.llm.num_layers}x{m.llm.hidden_size}, LoRA r={m.llm.lora_r} dropout "
        f"{m.llm.lora_dropout}, remat_vision={m.remat_vision} remat_llm={m.remat_llm}; "
        f"AdamW lr {cfg.optimizer.lr}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    straight = trainer.train(cfg, device=dev, after_step=count_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    recs = straight["records"]
    ok = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs)
    ok &= len(recs) == DISK_STEPS and math.isfinite(straight["metrics"].get("val_loss", math.nan))
    timed = recs[1:5]
    med = lambda xs: sorted(xs)[len(xs) // 2] if len(xs) % 2 else \
        sum(sorted(xs)[len(xs) // 2 - 1:len(xs) // 2 + 1]) / 2
    stats = dict(
        host=probe, decoder=decoder, one_thread_batch=one_thread, records=recs,
        metrics=straight["metrics"],
        run_s=run_s, median_step_ms=med([r["ms"] for r in timed]),
        median_host_batch_ms=med([r["host_ms"] for r in recs]),
        median_wait_ms=med([r["wait_ms"] for r in timed]), peak_bytes=peak,
        launches=launches)
    log(f"{tag} steps: ms {[round(r['ms'], 2) for r in recs]}; median of steps 2-5 "
        f"{stats['median_step_ms']:.2f} ms ({cfg.data.batch_size * 1e3 / stats['median_step_ms']:.3f} "
        f"samples/s); host batch ms {[round(r['host_ms'], 1) for r in recs]} (median "
        f"{stats['median_host_batch_ms']:.1f}, 8 threads); prefetch wait ms "
        f"{[round(r['wait_ms'], 2) for r in recs]} (median of steps 2-5 "
        f"{stats['median_wait_ms']:.2f})")
    log(f"{tag} loss {[round(r['loss'], 5) for r in recs]} grad_norm "
        f"{[round(r['grad_norm'], 4) for r in recs]} val_loss "
        f"{straight['metrics'].get('val_loss')} finite={'OK' if ok else 'FAIL'}; "
        f"whole run {run_s:.2f} s; peak {peak / 2 ** 30:.2f} GiB")
    want = train_launches_per_step(m)
    got = per_step[0] if per_step else {}
    for name, n in want.items():
        good = got.get(name) == n
        ok &= good
        log(f"{tag} {name}: {got.get(name)} launches a step over steps 2-5, reckoned "
            f"{n} from the shapes {'OK' if good else 'FAIL'}")
    log(f"{tag} launches over the whole run (warm-up, 5 steps, validation): {launches}")
    stats["launches_per_step"] = got

    # -- resume from step 3 in a fresh run directory --
    res_out = os.path.join(work, "resumed")
    src = os.path.join(work, "straight", "disk", "checkpoints",
                       f"step_{DISK_CKPT_EVERY:08d}")
    os.makedirs(os.path.join(res_out, "disk", "checkpoints"))
    shutil.copytree(src, os.path.join(res_out, "disk", "checkpoints",
                                      os.path.basename(src)))
    stats["checkpoint_bytes"] = _dir_bytes(src)
    prof = {}

    def profile_window(step, _):
        from torch.profiler import ProfilerActivity, profile
        if step == DISK_CKPT_EVERY:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        elif step == DISK_CKPT_EVERY + 1:
            torch.cuda.synchronize()
            prof["wall"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()

    resumed = trainer.train(cfg_for(res_out, "resume=true"), device=dev,
                            after_step=profile_window)
    rrecs = resumed["records"]
    same = [a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
            for a, b in zip(recs[DISK_CKPT_EVERY:], rrecs)]
    sp, rp = ts.flatten(straight["state"].params), ts.flatten(resumed["state"].params)
    differ = [p for p, x in sp.items() if not torch.equal(x, rp[p])]
    good = (len(rrecs) == DISK_STEPS - DISK_CKPT_EVERY and all(same) and not differ
            and resumed["metrics"].get("val_loss") == straight["metrics"].get("val_loss"))
    ok &= good
    log(f"{tag} resumed at step {DISK_CKPT_EVERY}: loss {[r['loss'] for r in rrecs]} vs "
        f"straight {[r['loss'] for r in recs[DISK_CKPT_EVERY:]]}; val_loss "
        f"{resumed['metrics'].get('val_loss')} vs {straight['metrics'].get('val_loss')}; "
        f"{len(differ)} of {len(sp)} parameter leaves differ {differ[:3]} "
        f"{'OK (bit-identical)' if good else 'FAIL'}")
    busy = kernel_busy_ms(prof["p"])
    stats["profile_step"] = dict(wall_ms=prof["wall"], device_busy_ms=busy)
    log(f"{tag} one resumed step from the prefetch queue to its loss (torch.profiler, "
        f"CUDA only): wall {prof['wall']:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / prof['wall']:.1f} %), idle {100 * (1 - busy / prof['wall']):.1f} %")

    # -- checkpoint save / restore times on the straight run's state --
    state = straight["state"]
    del resumed, rp
    cdir = os.path.join(work, "ckpt_timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(cdir, state, 100)
    stats["save_block_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.save_checkpoint(cdir, state, 101, block=False)
    stats["save_async_return_ms"] = (time.perf_counter() - t0) * 1e3
    ckpt.wait_for_checkpoints()
    stats["save_async_total_ms"] = (time.perf_counter() - t0) * 1e3
    before = {p: x.clone() for p, x in sp.items()}
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path, state)
    torch.cuda.synchronize()
    stats["restore_ms"] = (time.perf_counter() - t0) * 1e3
    good = all(torch.equal(before[p], x) for p, x in ts.flatten(state.params).items())
    ok &= good
    log(f"{tag} checkpoint {stats['checkpoint_bytes'] / 1e9:.3f} GB "
        f"({len(os.listdir(path))} files); save blocking {stats['save_block_ms']:.1f} ms, "
        f"async {stats['save_async_return_ms']:.1f} ms to return (host copy) and "
        f"{stats['save_async_total_ms']:.1f} ms to disk; restore {stats['restore_ms']:.1f} ms "
        f"{'OK' if good else 'FAIL (restored state differs)'}")
    del straight, state, sp, before
    shutil.rmtree(cdir)
    torch.cuda.empty_cache()

    # -- a trained-SimLingo torch checkpoint through hf_checkpoint= --
    m = presets.internvl2_1b(lora=True)         # the model such a checkpoint holds
    t0 = time.perf_counter()
    sd = simlingo_state_dict(m, torch, dev)
    hf_path = os.path.join(work, "pytorch_model.pt")
    torch.save(sd, hf_path)
    stats["hf_bytes"] = os.path.getsize(hf_path)
    log(f"{tag} random trained-SimLingo state dict: {len(sd)} tensors, "
        f"{stats['hf_bytes'] / 1e9:.3f} GB bf16, written in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    loaded = ts.flatten(ckpt.load_hf_checkpoint(hf_path, m))
    stats["hf_load_ms"] = (time.perf_counter() - t0) * 1e3
    H, lv, ll = m.vit.hidden_size, min(3, m.vit.num_layers - 1), min(5, m.llm.num_layers - 1)
    qkv = sd[f"vision_model.model.vision_model.encoder.layers.{lv}.attn.qkv.weight"].float()
    pre = f"language_model.model.base_model.model.model.layers.{ll}.self_attn.q_proj."
    merged = sd[pre + "base_layer.weight"].float() + (m.llm.lora_alpha / m.llm.lora_r) * (
        sd[pre + "lora_B.default.weight"].float() @ sd[pre + "lora_A.default.weight"].float())
    err = float((loaded[f"llm/layers/{ll}/attn/q/w"] - merged).abs().max())
    good = (torch.equal(loaded[f"vision/layers/{lv}/attn/k/w"], qkv[H:2 * H])
            and err <= 1e-6 * float(merged.abs().max()))
    ok &= good
    log(f"{tag} load_hf_checkpoint {stats['hf_load_ms']:.1f} ms: vision k slice of the "
        f"fused qkv equal, merged LoRA q_proj max err {err:.2e} "
        f"{'OK' if good else 'FAIL'}")
    frozen = loaded[f"llm/layers/{ll}/attn/q/w"].to(torch.bfloat16)
    del sd, loaded
    hf_cfg = cfg_for(os.path.join(work, "hf"), f"hf_checkpoint={hf_path}", "max_steps=2",
                     "val_every_n_epochs=0")
    hf_cfg.model = m
    hf = trainer.train(hf_cfg, device=dev)
    kept = torch.equal(hf["state"].params["llm"]["layers"][str(ll)]["attn"]["q"]["w"].cpu(),
                       frozen)
    good = kept and all(math.isfinite(r["loss"]) for r in hf["records"])
    ok &= good
    stats["hf_records"] = hf["records"]
    log(f"{tag} 2 steps from the checkpoint: loss {[round(r['loss'], 5) for r in hf['records']]}"
        f", frozen merged leaf kept {kept} {'OK' if good else 'FAIL'}")
    del hf
    torch.cuda.empty_cache()
    final = os.path.join(work, "hf", "disk", "checkpoints", f"step_{2:08d}")
    ok &= os.path.isdir(final)
    return ok, stats, {"final_checkpoint": final, "hf_checkpoint": hf_path}


# ---------------------------------------------------------------------------
# Phases 8-9: the evaluation entry points, in phase 7's workspace
# ---------------------------------------------------------------------------

PLUGIN_TICKS = 4            # the first plain CoT, then speculative


def serve_launches(m, gen_len, rounds=None, bits=8):
    """The hand kernels' launches of one serving frame of the int8 agent
    (bits=8) or the int4 agent (bits=4), reckoned from its work. LLM
    passes: the prefill, each decode step (plain: gen_len of them) or each
    speculative round and the flush, and the queries; a drive-only frame
    (gen_len None: no commentary) one pass, the prompt with the queries.
    flash_attn_fwd: a launch a ViT layer (both tiles in one call) and a
    launch an LLM layer a pass. int8_matmul: a launch a quantized linear of
    a layer a pass, and one for the head each time logits are taken
    (plain: before each decode step; speculative: after the prefill and
    each round; drive-only: never); none for int4, whose product is plain
    PyTorch."""
    from simlingo_tpu_torch.core.quantize import _LLM_LINEARS
    if gen_len is None:
        llm_passes, heads = 1, 0
    else:
        llm_passes = 1 + (gen_len if rounds is None else rounds + 1) + 1
        heads = gen_len if rounds is None else rounds + 1
    return {"flash_attn_fwd": m.vit.num_layers + m.llm.num_layers * llm_passes,
            "int8_matmul": (len(_LLM_LINEARS) * m.llm.num_layers * llm_passes + heads
                            if bits == 8 else 0)}


def carla_plugin(torch, dev, hf_path, work, per_frame=None):
    """Phase 8: the leaderboard plugin (`agent/carla_agent.py`) under the
    CARLA test doubles of tests/carla_stubs.py: `setup()` on the random
    trained-SimLingo checkpoint of phase 7 (presets.internvl2_1b(), the
    default AgentConfig: CoT, int8 LLM, speculative), the metric file and
    the scenario records on; PLUGIN_TICKS ticks on phase 4's frame (as the
    camera's BGRA) along a straight plan at 4 m/s. Each tick's ms and
    hand-kernel launches (held exactly to `serve_launches` of its work;
    phase 4's frame, `per_frame`, beside where it ran), the metric file's
    lines against the agent's outputs,
    the records' length and `destroy()`'s latency stats."""
    import gzip
    import importlib
    import importlib.util
    import numpy as np
    from simlingo_tpu_torch.agent.agent import AgentFrame
    # by path: another installed `tests` package may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "carla_stubs", os.path.join(ROOT, "tests", "carla_stubs.py"))
    stubs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stubs)
    tag = "[carla_plugin]"
    kernels = kernel_fns()
    env = {"SIMLINGO_METRIC_INFO": os.path.join(work, "plugin_metrics.jsonl"),
           "SIMLINGO_RECORD_DIR": os.path.join(work, "plugin_records")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    stubs.install_stubs()
    import simlingo_tpu_torch.agent.carla_agent as plugin_mod
    plugin_mod = importlib.reload(plugin_mod)
    try:
        plugin = plugin_mod.SimLingoTorchAgent()
        t0 = time.perf_counter()
        plugin.setup(hf_path, route_index=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        agent = plugin.agent
        m, acfg = agent.model_cfg, agent.cfg
        log(f"{tag} {plugin_mod.get_entry_point()}.setup({os.path.basename(hf_path)}) in "
            f"{setup_s:.1f} s (load_hf_checkpoint, LoRA merged, int8 LLM, warm-up): "
            f"AgentConfig() use_cot={acfg.use_cot} int8_llm={acfg.int8_llm} "
            f"speculative_cot={acfg.speculative_cot} spec_k={acfg.spec_k} jpeg_roundtrip="
            f"{acfg.jpeg_roundtrip}; initial_frames_delay {acfg.initial_frames_delay} set to 0 "
            f"(the settling ticks infer nothing)")
        acfg.initial_frames_delay = 0
        plugin._global_plan_world_coord = [((4.0 * i, 0.0, 0.0), 4) for i in range(60)]
        rgb = _frame(AgentFrame, np).rgb
        bgra = np.concatenate([rgb[:, :, ::-1], np.full((*rgb.shape[:2], 1), 255, np.uint8)], -1)
        outs, ticks = [], []
        inner = agent.run_step

        def capture(frame):
            outs.append(inner(frame))
            return outs[-1]
        agent.run_step = capture
        for i in range(PLUGIN_TICKS):
            data = {"rgb_front": (i, bgra), "gps": (i, stubs.gps_for_carla_xy(0.2 * i, 0.0)),
                    "imu": (i, np.zeros(7)), "speed": (i, {"speed": 4.0})}
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            ctrl = plugin.run_step(data, timestamp=0.05 * i)
            torch.cuda.synchronize()
            ticks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: fn.launches for k, fn in kernels.items()
                                        if fn.launches},
                              control=[ctrl.steer, ctrl.throttle, ctrl.brake]))
        spec = list(agent.spec_stats)
        latency = agent.latency_stats()
        plugin.destroy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for name in ("carla", "leaderboard", "leaderboard.autoagents",
                     "leaderboard.autoagents.autonomous_agent", "srunner",
                     "srunner.scenariomanager", "srunner.scenariomanager.carla_data_provider"):
            sys.modules.pop(name, None)
        importlib.reload(plugin_mod)

    ok = True
    for i, (t, out) in enumerate(zip(ticks, outs)):
        gen_len = len(out["language_tokens"])
        rounds = None if i == 0 else spec[i - 1][0]
        want = serve_launches(m, gen_len, rounds)
        good = t["launches"] == want and math.isfinite(sum(t["control"]))
        fin = (np.isfinite(out["route"]).all() and out["route"].shape == (20, 2)
               and out["speed_wps"].shape == (10, 2))
        ok &= good and bool(fin)
        t.update(tokens=gen_len, rounds=rounds, reckoned=want)
        same = "phase 4 not run"
        if per_frame is not None:
            p4_work = (per_frame["tokens"][i], None if i == 0 else per_frame["spec"][i - 1][0])
            same = (f"phase 4's frame {i} (tokens, rounds) {p4_work}: "
                    f"{per_frame['launches'][i]}")
        log(f"{tag} tick {i} {'cot_plain' if i == 0 else 'cot_spec':9s} {t['ms']:9.2f} ms "
            f"tokens={gen_len} rounds={rounds} control={[round(c, 4) for c in t['control']]} "
            f"launches {t['launches']} (reckoned {want} {'OK' if good else 'FAIL'}); {same}")
    with open(env["SIMLINGO_METRIC_INFO"]) as f:
        lines = [json.loads(x) for x in f]
    match = len(lines) == PLUGIN_TICKS and all(
        ln["language"] == agent.tok.decode(out["language_tokens"]) and ln["steer"] == out["steer"]
        and ln["throttle"] == out["throttle"] and ln["brake"] == out["brake"]
        for ln, out in zip(lines, outs))
    with gzip.open(os.path.join(env["SIMLINGO_RECORD_DIR"], "0", "records.json.gz"), "rt") as f:
        record = json.load(f)
    recorded = len(record["states"]) == len(record["ego_actions"]) == PLUGIN_TICKS
    ok &= match and recorded
    log(f"{tag} metric file: {len(lines)} lines for {PLUGIN_TICKS} ticks, each equal to the "
        f"agent's output (language from its tokens, steer, throttle, brake) "
        f"{'OK' if match else 'FAIL'}; latency_ms {[round(x['latency_ms'], 2) for x in lines]}")
    log(f"{tag} records.json.gz: {len(record['states'])} states, "
        f"{len(record['ego_actions'])} ego actions {'OK' if recorded else 'FAIL'}; "
        f"destroy(): latency {latency}; speculative (rounds, gen_len) {spec}")
    launches = {}
    for t in ticks:
        for k, n in t["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return ok, dict(setup_s=setup_s, ticks=ticks, spec_stats=spec, latency=latency,
                    metric_lines=lines, record_states=len(record["states"]),
                    launches=launches)


def eval_language(torch, dev, work, checkpoint):
    """Phase 9: `eval_language_torch.py`'s main on phase 7's validation
    route alone (a data root linking to it) and the final checkpoint of
    phase 7's 2-step run from the trained-SimLingo .pt (the model of
    `eval_language_torch.py`'s preset, LoRA unmerged), in each mode (QA, commentary, Dreaming) at batch
    EVAL_BATCH, EVAL_NEW_TOKENS new tokens, bf16. Each batch's
    `generate_and_drive` is timed (synchronised) with its flash_attn_fwd
    launches, held exactly to the count reckoned from its work (a ViT
    launch a layer, then an LLM launch a layer for the prefill, each
    decode step and the queries); then the same batch with one new token
    (the ViT, prefill, one step and the queries), so decode ms/token =
    (ms - one-token ms) / (steps - 1); the first batch also profiled at 1
    and GEN_PROFILE_TOKENS new tokens (device busy a decoded token). The
    JSONs written, the metrics and the dreamer results."""
    import dataclasses
    import numpy as np
    import eval_language_torch as ELT
    from simlingo_tpu_torch.infer import runner
    tag = "[eval_language]"
    rel = os.path.join("data", "simlingo", "v1", "b0", DISK_ROUTES[2][0])
    root = os.path.join(work, "eval_db")
    os.makedirs(os.path.dirname(os.path.join(root, rel)))
    os.symlink(os.path.join(work, "db", rel), os.path.join(root, rel))
    kernels = kernel_fns()
    generate = runner.generate_and_drive
    batches = []

    def timed(params, di, model_cfg, gen_cfg, compute_dtype=torch.bfloat16, generator=None):
        B = di.prompt_inference.ids.shape[0]
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        out = generate(params, di, model_cfg, gen_cfg, compute_dtype, generator)
        steps = int(out.language_lengths.max())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches - before[k] for k, fn in kernels.items()
                    if fn.launches - before[k]}
        t0 = time.perf_counter()
        generate(params, di, model_cfg, dataclasses.replace(gen_cfg, max_new_tokens=1),
                 compute_dtype, generator)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        m = model_cfg
        prompt_valid = di.prompt_inference.valid.cpu().numpy()
        batches.append(dict(ms=ms, one_token_ms=one_ms, steps=steps, launches=launches,
                            lengths=out.language_lengths.tolist(),
                            shape=list(di.prompt_inference.ids.shape),
                            prompt_tokens=prompt_valid.sum(1).tolist(),
                            phase2_prompt=bool(np.array_equal(prompt_valid,
                                                              eval_prompt_valid(np))),
                            flash_reckoned=m.vit.num_layers + m.llm.num_layers * (steps + 2)))
        if len(batches) == 1:        # the first batch: device time a decoded token
            prof = [device_profile(torch, lambda n=n: generate(
                params, di, model_cfg, dataclasses.replace(gen_cfg, max_new_tokens=n),
                compute_dtype, generator), f"eval generate at batch {B}, {n} new token(s)")
                for n in (1, GEN_PROFILE_TOKENS)]
            per = (GEN_PROFILE_TOKENS - 1)
            batches[0]["profile_per_token"] = dict(
                busy_ms=(prof[1]["device_busy_ms"] - prof[0]["device_busy_ms"]) / per,
                wall_ms=(prof[1]["wall_ms"] - prof[0]["wall_ms"]) / per,
                one_token=prof[0], n_tokens=prof[1])
            log(f"{tag} a decoded token at batch {B} (profiled, {GEN_PROFILE_TOKENS} vs 1 "
                f"new tokens): device busy {batches[0]['profile_per_token']['busy_ms']:.3f} ms "
                f"of {batches[0]['profile_per_token']['wall_ms']:.3f} ms wall")
        return out

    ok, modes = True, {}
    runner.generate_and_drive = timed
    try:
        for mode in EVAL_MODES:
            out_dir = os.path.join(work, f"eval_{mode}")
            first = len(batches)
            t0 = time.perf_counter()
            res = ELT.main(["--checkpoint", checkpoint, "--mode", mode, "--data-root", root,
                            "--output-dir", out_dir, "--batch-size", str(EVAL_BATCH)])
            wall = time.perf_counter() - t0
            mine = batches[first:]
            with open(os.path.join(out_dir, "language_preds_all.json")) as f:
                n = len(json.load(f))
            files = sorted(os.listdir(out_dir))
            gen_ms = sum(b["ms"] for b in mine)
            stat = dict(samples=n, wall_s=wall, batches=mine, files=files,
                        samples_per_s=n * 1e3 / gen_ms, metrics=res["metrics"],
                        dreamer=res.get("dreamer"))
            want = {"eval_results.json", "language_preds_all.json", "language_preds_cot.json",
                    "language_preds_qa.json"} | ({"dreamer_results.json"} if mode == "Dreaming"
                                                 else set())
            good = n > 0 and want <= set(files) and all(
                math.isfinite(v) for v in res["metrics"].values())
            for b in mine:
                flash = b["launches"].get("flash_attn_fwd", 0)
                b["decode_ms_per_token"] = (b["ms"] - b["one_token_ms"]) / max(b["steps"] - 1, 1)
                exact = flash == b["flash_reckoned"] and b["shape"][0] == EVAL_BATCH
                good &= exact
                log(f"{tag} {mode} batch {b['shape']}: {b['ms']:.2f} ms, {b['steps']} steps "
                    f"(lengths {b['lengths']}); one new token {b['one_token_ms']:.2f} ms -> "
                    f"decode {b['decode_ms_per_token']:.3f} ms/token at batch {b['shape'][0]}; "
                    f"launches {b['launches']} (flash_attn_fwd reckoned "
                    f"{b['flash_reckoned']} {'OK' if exact else 'FAIL'})")
            if mode == "QA":        # the prompts phase 2's eval cases stand for
                first_ok = bool(mine) and mine[0]["phase2_prompt"]
                good &= first_ok
                log(f"{tag} QA batch 0 prompt validity: {mine[0]['shape'] if mine else None}, "
                    f"valid tokens {mine[0]['prompt_tokens'] if mine else None} against "
                    f"phase 2's {[EVAL_BATCH, EVAL_PROMPT_LEN]}, {list(EVAL_PROMPT_TOKENS)} "
                    f"{'EQUAL' if first_ok else 'DIFFERS: FAIL'}")
            ok &= good
            log(f"{tag} {mode}: {n} samples, {stat['samples_per_s']:.3f} samples/s in "
                f"generate, main {wall:.2f} s (checkpoint restore, dataset, eval); files "
                f"{files} {'OK' if good else 'FAIL'}; metrics {res['metrics']}"
                + (f"; dreamer {res['dreamer']}" if "dreamer" in res else ""))
            modes[mode] = stat
    finally:
        runner.generate_and_drive = generate
    launches = {}
    for b in batches:
        for k, v in b["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return ok, dict(modes=modes, launches=launches)


# ---------------------------------------------------------------------------
# Phase 10: closed-loop evaluation in the microsim, in phase 7's workspace
# ---------------------------------------------------------------------------

MICROSIM_ROUTE = "micro_02_accident"     # straight town, Accident at 110 m, no NPCs
MICROSIM_TICKS = 20                      # 1 s of game time: the first plain CoT, then speculative
MICROSIM_PROFILE_TICK = 5                # a speculative tick, profiled (not timed)
# the babysat job: route, --max-steps. Past the default AgentConfig's 40
# settling ticks, so the model runs (plain CoT, then speculative); on a
# scenario route, so that merged.json carries the ability breakdown
MICROSIM_JOB = ("micro_02_accident", 42)
MICROSIM_JOB_INFERENCE = 2               # ticks of the job that run the model
MICROSIM_JOB_TIMEOUT = 600               # seconds the babysitter lets the job run


def _p50_max(xs):
    xs = sorted(xs)
    return (xs[len(xs) // 2], xs[-1]) if xs else (float("nan"), float("nan"))


def drive_closed_loop(torch, agent, spec, ticks, record_dir=None, profile_tick=None):
    """`sim/runner.run_route` of `spec` through `model_factory(agent)` for
    `ticks` ticks: each tick's host ms split into the camera's render, the
    agent's step (ending in a synchronize) and the rest (world tick,
    scripted scenarios, criteria, the recorder's log), with the tokens,
    the hand kernels' launches of its agent step and the control applied;
    tick `profile_tick`'s agent step runs under `device_profile`. Returns
    (record, ticks, that profile, wall s, launches over the route)."""
    from simlingo_tpu_torch.sim import runner as R
    kernels = kernel_fns()
    out_ticks, cur, prof = [], {}, {}
    inner, factory = agent.run_step, R.model_factory(agent)

    def run_step(frame):
        before = {k: fn.launches for k, fn in kernels.items()}
        t = time.perf_counter()
        if len(out_ticks) == profile_tick:
            box = []
            prof.update(device_profile(torch, lambda: box.append(inner(frame)),
                                       f"closed-loop tick {len(out_ticks)}"))
            out = box[0]
        else:
            out = inner(frame)
        torch.cuda.synchronize()
        cur.update(agent_ms=(time.perf_counter() - t) * 1e3,
                   tokens=len(out["language_tokens"]),
                   launches={k: fn.launches - before[k] for k, fn in kernels.items()
                             if fn.launches - before[k]})
        return out

    def make(world, route, scen):
        driver = factory(world, route, scen)
        render, step = driver.camera.render, driver.step

        def timed_render(w, **kw):
            t = time.perf_counter()
            out = render(w, **kw)
            cur["camera_ms"] = (time.perf_counter() - t) * 1e3
            return out

        def timed_step():
            cur.clear()
            cur["t0"] = time.perf_counter()
            out = step()
            cur["t_step"] = time.perf_counter()
            return out
        driver.camera.render, driver.step = timed_render, timed_step
        return driver

    def on_tick(world, criteria):
        t = time.perf_counter()
        out_ticks.append(dict(camera_ms=cur["camera_ms"], agent_ms=cur["agent_ms"],
                              world_ms=(t - cur["t_step"]) * 1e3, ms=(t - cur["t0"]) * 1e3,
                              tokens=cur["tokens"], launches=cur["launches"],
                              control=list(world.ego.control)))

    agent.run_step = run_step
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        rec = R.run_route(spec, make, max_steps=ticks, record_dir=record_dir, on_tick=on_tick)
        torch.cuda.synchronize()
    finally:
        agent.run_step = inner
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    return rec, out_ticks, prof, wall_s, launches


def held_ticks(tag, m, ticks, spec_stats, n_ticks, profile_tick=None):
    """Each tick of `drive_closed_loop` (the first plain CoT, then
    speculative: `spec_stats` holds a round count a speculative tick)
    logged, its launches held exactly to `serve_launches` of its work and
    its control finite; True if all are and there are `n_ticks`."""
    ok = len(ticks) == n_ticks == len(spec_stats) + 1
    for i, t in enumerate(ticks):
        rounds = None if i == 0 else spec_stats[i - 1][0]
        want = serve_launches(m, t["tokens"], rounds)
        good = t["launches"] == want and all(math.isfinite(c) for c in t["control"])
        ok &= good
        t.update(rounds=rounds, reckoned=want)
        kind = "cot_plain" if i == 0 else "profiled" if i == profile_tick else "cot_spec"
        log(f"{tag} tick {i:2d} {kind:9s} {t['ms']:9.2f} ms: "
            f"camera {t['camera_ms']:.2f}, agent {t['agent_ms']:.2f}, world {t['world_ms']:.2f}; "
            f"tokens={t['tokens']} rounds={rounds} control="
            f"{[round(c, 4) for c in t['control']]} launches {t['launches']} "
            f"({'= reckoned' if good else f'reckoned {want}: FAIL'})")
    return ok


def microsim(torch, dev, hf_path, work, plugin=None):
    """Phase 10: closed-loop evaluation in the microsim. (a) In process:
    `sim/suite.load_model_agent` on phase 7's trained-SimLingo .pt
    (presets.internvl2_1b() and the default AgentConfig: CoT, int8 LLM,
    speculative; bf16; initial_frames_delay set to 0, as phase 8 does),
    `sim/runner.run_route` on MICROSIM_ROUTE for MICROSIM_TICKS ticks with
    the replay recorder on: each tick's host ms split into the camera's
    render, the agent's step (ending in a synchronize) and the rest (world
    tick, scripted scenarios, criteria, the recorder's log), beside phase
    8's plugin ticks (`plugin`); each tick's launches held exactly to
    `serve_launches` of its work; the launches of one profiled speculative
    tick by hand kernel; the record's status, scores and infractions, run
    through `driving_score.merge_route_results` and
    `b2d_benchmarks.ability_benchmark`. (b) Through the babysitter: the one
    job `start_eval_torch.py --microsim --agent-kind model` builds for
    MICROSIM_JOB's route, with its --max-steps, under `Babysitter` +
    `LocalBackend`, then `start_eval_torch.summarize` (merge_route_dir, the
    ability breakdown, merged.json); a failed or retried job fails the
    phase, as do a job whose agent ran the model on fewer than
    MICROSIM_JOB_INFERENCE ticks or launched no attention or int8 kernel
    (the suite's `agent:` line), and a merged.json without the ability
    breakdown or whose breakdown differs from `ability_benchmark` /
    `driving_efficiency` of the job's records."""
    import start_eval_torch as SE
    from simlingo_tpu_torch.eval import b2d_benchmarks as B2D
    from simlingo_tpu_torch.eval import driving_score as DS
    from simlingo_tpu_torch.orchestration.babysitter import Babysitter, LocalBackend
    from simlingo_tpu_torch.sim import suite as SU
    tag = "[microsim]"
    t0 = time.perf_counter()
    agent = SU.load_model_agent(hf_path, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m, acfg = agent.model_cfg, agent.cfg
    log(f"{tag} load_model_agent({os.path.basename(hf_path)}) in {setup_s:.1f} s: "
        f"use_cot={acfg.use_cot} int8_llm={acfg.int8_llm} speculative_cot="
        f"{acfg.speculative_cot} spec_k={acfg.spec_k} compute {agent.compute_dtype}; "
        f"initial_frames_delay {acfg.initial_frames_delay} set to 0")
    acfg.initial_frames_delay = 0
    spec = next(s for s in SU.SUITES["micro"]() if s["route_id"] == MICROSIM_ROUTE)
    record_dir = os.path.join(work, "microsim_records")
    rec, ticks, prof, wall_s, launches = drive_closed_loop(
        torch, agent, spec, MICROSIM_TICKS, record_dir=record_dir,
        profile_tick=MICROSIM_PROFILE_TICK)
    spec_stats = list(agent.spec_stats)
    agent.close()
    del agent
    torch.cuda.empty_cache()
    ok = held_ticks(tag, m, ticks, spec_stats, MICROSIM_TICKS, MICROSIM_PROFILE_TICK)
    spec_ticks = [t for i, t in enumerate(ticks) if i not in (0, MICROSIM_PROFILE_TICK)]
    split = {k: _p50_max([t[k] for t in spec_ticks])
             for k in ("ms", "camera_ms", "agent_ms", "world_ms")}
    beside = "phase 8 not run"
    if plugin is not None:
        beside = (f"phase 8's speculative plugin ticks p50 / max "
                  f"{'%.2f / %.2f' % _p50_max([t['ms'] for t in plugin['ticks'][1:]])} ms")
    log(f"{tag} {len(spec_ticks)} speculative ticks (the profiled one left out) p50 / max: "
        f"tick {split['ms'][0]:.2f} / {split['ms'][1]:.2f} "
        f"ms = camera {split['camera_ms'][0]:.2f} / {split['camera_ms'][1]:.2f} + agent "
        f"{split['agent_ms'][0]:.2f} / {split['agent_ms'][1]:.2f} + world "
        f"{split['world_ms'][0]:.2f} / {split['world_ms'][1]:.2f}; the first (plain CoT) "
        f"{ticks[0]['ms']:.2f} ms (agent {ticks[0]['agent_ms']:.2f}); {beside}")
    if prof:
        per = {k: v["count"] for k, v in prof["hand"].items()}
        t = ticks[MICROSIM_PROFILE_TICK]
        log(f"{tag} launches in profiled tick {MICROSIM_PROFILE_TICK} by hand kernel {per} "
            f"(counted {t['launches']}; device busy {prof['device_busy_ms']:.2f} of "
            f"{prof['wall_ms']:.2f} ms)")
    rec_path = os.path.join(work, "microsim_route.json")
    with open(rec_path, "w") as f:
        json.dump({"_checkpoint": {"records": [rec]}}, f)
    merged = DS.merge_route_results([rec_path])
    ability = B2D.ability_benchmark([rec])
    import gzip
    with gzip.open(os.path.join(record_dir, MICROSIM_ROUTE, "records.json.gz"), "rt") as f:
        replay = json.load(f)
    good = (rec["route_id"] == MICROSIM_ROUTE and merged["num_routes"] == 1
            and math.isfinite(merged["driving_score"])
            and rec["meta"]["scenario_type"] == "Accident"
            and sum(ability["ability_counts"][k][1] for k in ability["ability_counts"]) >= 1
            and len(replay["states"]) == MICROSIM_TICKS
            and rec["meta"]["duration_game"] == round(MICROSIM_TICKS * 0.05, 3))
    ok &= good
    log(f"{tag} {MICROSIM_ROUTE} after {len(ticks)} ticks ({wall_s:.1f} s): status "
        f"{rec['status']!r}, scores {rec['scores']}, infractions "
        f"{ {k: v for k, v in rec['infractions'].items() if v} }; merge_route_results "
        f"driving_score {merged['driving_score']} success_rate {merged['success_rate']}; "
        f"ability_benchmark {ability['ability']} counts {ability['ability_counts']}; replay "
        f"record {len(replay['states'])} states {'OK' if good else 'FAIL'}")
    log(f"{tag} launches over the route {launches}")

    # (b) one babysat start_eval_torch job
    route, steps = MICROSIM_JOB
    out_dir = os.path.join(work, "microsim_eval")
    args = SE.parse_args(["--microsim", "--agent-kind", "model", "--checkpoint", hf_path,
                          "--output-dir", out_dir, "--max-jobs", "1"])
    os.makedirs(out_dir, exist_ok=True)
    job = next(j for j in SE.build_jobs(args) if j.name == route)
    job.cmd = job.cmd + ["--max-steps", str(steps)]
    log(f"{tag} babysat job: {' '.join(job.cmd)}")
    t0 = time.perf_counter()
    sitter = Babysitter([job], LocalBackend(), max_concurrent=1, poll_interval_s=0.5,
                        hang_timeout_s=MICROSIM_JOB_TIMEOUT)
    counts = sitter.run()
    job_s = time.perf_counter() - t0
    with open(job.log_path, errors="replace") as f:
        job_log = f.read()
    summary = SE.summarize(out_dir)
    with open(os.path.join(out_dir, "merged.json")) as f:
        written = json.load(f)
    with open(os.path.join(out_dir, f"{route}.json")) as f:
        job_records = json.load(f)["_checkpoint"]["records"]
    want_ability = B2D.ability_benchmark(job_records)
    want_eff = B2D.driving_efficiency(job_records)
    ran = re.search(r"^agent: (\d+) inference ticks of (\d+) on cuda; hand-kernel launches "
                    r"flash_attn_fwd (\d+) int8_matmul (\d+)$", job_log, re.M)
    ran = tuple(int(x) for x in ran.groups()) if ran else None
    good = (counts == {"running": 0, "finished": 1, "failed": 0, "pending": 0}
            and job.retries == 0 and summary["num_routes"] == 1 and written == summary
            and math.isfinite(summary["driving_score"])
            and ran is not None and ran[:2] == (MICROSIM_JOB_INFERENCE, steps)
            and min(ran[2:]) > 0
            and written.get("ability") == json.loads(json.dumps(want_ability["ability"]))
            and written.get("driving_efficiency") == want_eff)
    ok &= good
    log(f"{tag} job {route}: {job_s:.1f} s, counts {counts}, retries {job.retries}; the job's "
        f"agent (inference ticks, ticks, flash_attn_fwd, int8_matmul launches) {ran}; "
        f"merge_route_dir -> merged.json: driving_score {summary['driving_score']} "
        f"success_rate {summary['success_rate']} num_routes {summary['num_routes']} ability "
        f"{written.get('ability')} driving_efficiency {written.get('driving_efficiency')} "
        f"{'OK' if good else 'FAIL'}; the job's log ends:\n" + job_log[-1500:])
    return ok, dict(setup_s=setup_s, wall_s=wall_s, ticks=ticks, spec_stats=spec_stats,
                    split_p50_max=split, profile=prof, record=rec, merged=merged,
                    ability=ability, launches=launches,
                    job=dict(cmd=job.cmd, seconds=job_s, counts=counts, retries=job.retries,
                             summary=summary))


# ---------------------------------------------------------------------------
# Phase 10b: expert data collection in the microsim, trained on and replayed
# ---------------------------------------------------------------------------

# the two collected routes (seed 0, the default 1024x512 camera,
# data_save_freq 5): a parked obstacle the expert bypasses, and an NPC
# ahead in the ego's lane (lane 0) at 5 m/s
COLLECT_ROUTES = (
    {"town": "straight", "start_s": 5.0, "end_s": 120.0, "route_id": "collect_obstacle",
     "scenarios": [{"type": "ParkedObstacle", "at_s": 70.0}]},
    {"town": "straight", "start_s": 5.0, "end_s": 120.0, "route_id": "collect_npc",
     "npcs": [{"at_s": 35.0, "lane": 0, "speed": 5.0}]})
COLLECT_LAYOUT = "data/simlingo/v1/b0/routes_training"     # the trainer's Town* layout
COLLECT_STEPS = 3                        # training on them: 1 warm-up + 2 timed steps
# the labelled training's token window. Without the InternVL2 tokenizer
# (no download) the byte-level fallback spells a text byte a token, so
# prompts of the collected routes' labels run past the yaml's 768 beside
# the 512 image tokens (at 768 the first three steps drew one of 802, and
# JAX's collate raises on it as the port's does). The window is the one
# cut of the yaml's data.
COLLECT_TEXT_LEN = 1024
REPLAY_FRAMES = 4                        # the first plain CoT, then speculative
# the trained model's closed loop: a straight route without scenarios, as
# tests/test_microsim_full_loop.py drives its trained agent
LOOP_ROUTE = {"town": "straight", "start_s": 5.0, "end_s": 100.0, "route_id": "collect_loop"}
LOOP_TICKS = 8                           # the first plain CoT, then speculative


def collect_routes(work):
    """(ok, stats, dataset root): COLLECT_ROUTES through the port's
    `sim/runner.expert_factory` (ExpertDriver + DataCollector), each
    tick's host ms split into expert (the scenarios, AutoPilot and the
    observation), camera (the RGB and augmented renders of a save tick)
    and write (the collector's files), beside the world's own tick; then
    the index's quality gate."""
    from simlingo_tpu_torch.data.index import build_index, route_passes_quality_gate
    from simlingo_tpu_torch.sim import runner as R
    tag = "[collect]"
    root = os.path.join(work, "collect_db")
    ok, routes = True, {}
    for spec in COLLECT_ROUTES:
        name = f"Town12_{spec['route_id']}"
        ticks, cur = [], {}
        factory = R.expert_factory(save_root=os.path.join(root, COLLECT_LAYOUT), seed=0,
                                   dir_name_fmt=name)

        def timed(key, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    cur[key] = cur.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            return call

        def make(world, route, scen, factory=factory):
            driver = factory(world, route, scen)
            driver.camera.render = timed("camera_ms", driver.camera.render)
            driver.collector.expert.tick = timed("autopilot_ms", driver.collector.expert.tick)
            driver.collector.tick = timed("collector_ms", driver.collector.tick)
            step = driver.step

            def timed_step():
                cur.clear()
                cur["t0"] = time.perf_counter()
                out = step()
                cur["t_step"] = time.perf_counter()
                return out
            driver.step = timed_step
            return driver

        def on_tick(world, criteria):
            t = time.perf_counter()
            step_ms = (cur["t_step"] - cur["t0"]) * 1e3
            camera, write = cur.get("camera_ms", 0.0), cur["collector_ms"] - cur["autopilot_ms"]
            ticks.append(dict(ms=(t - cur["t0"]) * 1e3, expert_ms=step_ms - camera - write,
                              camera_ms=camera, write_ms=write, world_ms=(t - cur["t_step"]) * 1e3,
                              saved="camera_ms" in cur))

        t0 = time.perf_counter()
        rec = R.run_route(spec, make, seed=0, on_tick=on_tick)
        wall_s = time.perf_counter() - t0
        path = os.path.join(root, COLLECT_LAYOUT, name)
        frames = len(os.listdir(os.path.join(path, "rgb")))
        # tick 0 is left out of the split: it pays the process's first
        # imports (the IDM's scipy RK45 where an actor leads: ~1.7 s)
        saved = [t for t in ticks[1:] if t["saved"]]
        split = {k: _p50_max([t[k] for t in ticks[1:]]) for k in ("ms", "expert_ms", "world_ms")}
        split.update({k: _p50_max([t[k] for t in saved]) for k in ("camera_ms", "write_ms")})
        gate = route_passes_quality_gate(path)
        good = (rec["status"] in ("Completed", "Perfect") and gate
                and frames == len(saved) + ticks[0]["saved"]
                and frames == -(-len(ticks) // 5)
                and len(os.listdir(os.path.join(path, "rgb_augmented"))) == frames
                and len(os.listdir(os.path.join(path, "measurements"))) == frames)
        ok &= good
        routes[name] = dict(record=rec, ticks=len(ticks), frames=frames, wall_s=wall_s,
                            split_p50_max=split, first_tick=ticks[0], gate=gate,
                            totals={k: sum(t[k] for t in ticks)
                                    for k in ("expert_ms", "camera_ms", "write_ms", "world_ms")})
        log(f"{tag} {name}: {len(ticks)} ticks in {wall_s:.1f} s, {frames} frames saved, status "
            f"{rec['status']!r}, scores {rec['scores']}, infractions "
            f"{ {k: len(v) for k, v in rec['infractions'].items() if v} }, quality gate "
            f"{'passed' if gate else 'FAILED'} {'OK' if good else 'FAIL'}")
        first = ticks[0]
        log(f"{tag} {name} the first tick {first['ms']:.2f} ms (expert {first['expert_ms']:.2f}, "
            f"camera {first['camera_ms']:.2f}, write {first['write_ms']:.2f}) left out; the "
            f"others' p50 / max ms: tick {split['ms'][0]:.2f} / {split['ms'][1]:.2f} = "
            f"expert {split['expert_ms'][0]:.2f} / {split['expert_ms'][1]:.2f} (every tick) + "
            f"camera {split['camera_ms'][0]:.2f} / {split['camera_ms'][1]:.2f} + write "
            f"{split['write_ms'][0]:.2f} / {split['write_ms'][1]:.2f} (the {len(saved)} save "
            f"ticks; the others render and write nothing) + world {split['world_ms'][0]:.2f} / "
            f"{split['world_ms'][1]:.2f}; totals {json.dumps({k: round(v, 1) for k, v in routes[name]['totals'].items()})}")
    idx = build_index(root, split="train", use_town13=False, pred_len=11)
    kept = sorted({os.path.basename(os.fsdecode(r)) for r in idx.route_dirs})
    good = kept == sorted(routes)
    ok &= good
    log(f"{tag} build_index kept {kept}, {len(idx)} samples {'OK' if good else 'FAIL'}")
    return ok, dict(routes=routes, index_samples=len(idx), index_routes=kept), root


def collect_label(root):
    """(ok, stats): `collect_dataset_torch.run_label_generation` over the
    collected root: per route the ms of each generator (commentary, VQA,
    dreamer) and the files it wrote, then the buckets' classes and
    assignments. Fails where a route has no VQA or no commentary file, or
    where `bucketsv2_simlingo/buckets_paths.pkl` is missing."""
    import collect_dataset_torch as CDT
    tag = "[collect_label]"
    t0 = time.perf_counter()
    stats = CDT.run_label_generation(root)
    stats["seconds"] = time.perf_counter() - t0
    ok = len(stats["routes"]) == len(COLLECT_ROUTES)
    for route, gens in stats["routes"].items():
        good = gens["vqa"]["files"] > 0 and gens["commentary"]["files"] > 0
        ok &= good
        log(f"{tag} {os.path.basename(route)}: " + ", ".join(
            f"{name} {g['ms']:.1f} ms -> {g['files']} files" for name, g in gens.items())
            + f" {'OK' if good else 'FAIL: no VQA or no commentary'}")
    pkl = os.path.join(stats["bucket_dir"], "buckets_paths.pkl")
    good = os.path.isfile(pkl)
    ok &= good
    classes = stats["buckets"]
    log(f"{tag} buckets in {stats['buckets_ms']:.1f} ms: {len(classes)} classes, "
        f"{sum(classes.values())} assignments {json.dumps(dict(sorted(classes.items())))}; "
        f"{os.path.relpath(pkl, root)} {'written' if good else 'MISSING'}; labelling "
        f"{stats['seconds']:.2f} s in all")
    return ok, stats


def collect_training(torch, dev, root, work):
    """`trainer.train` on the labelled routes at full width:
    configs/simlingo.yaml as it stands (JAX's default model,
    SimLingoConfig(); batch 6; commentary, QA and the dreamer mix on; the
    16 driving buckets) with `data.bucket_path` the generated buckets, and
    only the data root, use_town13=false, the steps and the output
    directory overridden (and, under the byte-level fallback tokenizer, the
    token window: COLLECT_TEXT_LEN), COLLECT_STEPS steps: the buckets and
    datasets each step's batch drew from and its answer tokens (the
    trainer's own step records), the logged language and waypoint losses,
    ms a step over the timed ones, peak memory, finite losses, and the
    hand kernels' launches a step held exactly to
    `train_launches_per_step`. The trained parameters are then written as
    a trained-SimLingo .pt (`checkpoint.save_hf_checkpoint`), the form
    phase 7's .pt takes to phases 8-10; returns (ok, stats, the .pt, the
    trained model's configuration)."""
    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.train import trainer
    tag = "[collect_train]"
    kernels = kernel_fns()
    bucket_dir = os.path.join(root, "bucketsv2_simlingo")
    cfg = compose("configs/simlingo.yaml", [
        f"data.data_root={root}", f"data.bucket_path={bucket_dir}",
        "data.base.use_town13=false", f"max_steps={COLLECT_STEPS}",
        f"output_dir={os.path.join(work, 'collect_runs')}"])
    if SimLingoTokenizer(cfg.tokenizer_path).is_fallback:
        cfg.data.max_text_len = COLLECT_TEXT_LEN
    m, d = cfg.model, cfg.data
    per_step = []

    def count_steps(step, _):
        if step == 0:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
        elif step == COLLECT_STEPS - 1:
            per_step.append({k: fn.launches / (COLLECT_STEPS - 1) for k, fn in kernels.items()
                             if fn.launches})

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = trainer.train(cfg, device=dev, after_step=count_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    recs = out["records"]
    timed = recs[1:]
    ok = len(recs) == COLLECT_STEPS and all(
        math.isfinite(r[k]) for r in recs
        for k in ("loss", "grad_norm", "language_loss", "route_loss", "speed_wps_loss"))
    ms = sum(r["ms"] for r in timed) / len(timed)
    log(f"{tag} configs/simlingo.yaml: batch {d.batch_size}, {d.max_text_len} tokens, "
        f"commentary={d.base.use_commentary} qa={d.base.use_qa} dreamer={d.use_dreamer}, "
        f"bucket_path {os.path.relpath(d.bucket_path, root)}, {len(d.train_partitions)} driving "
        f"buckets; ViT {m.vit.num_layers}x{m.vit.hidden_size}, Qwen2 {m.llm.num_layers}x"
        f"{m.llm.hidden_size}, LoRA r={m.llm.lora_r}, remat_vision={m.remat_vision} "
        f"remat_llm={m.remat_llm}")
    good = (d.base.use_commentary and d.base.use_qa and d.use_dreamer
            and all(r.get("buckets") for r in recs))
    ok &= good
    draws = []
    for r in recs:
        dreamer = sum(n for k, n in r["buckets"].items() if k.endswith("_dreamer"))
        draws.append(dict(buckets=r["buckets"], answer_tokens=r["answer_tokens"],
                          longest_prompt=r["longest_prompt"],
                          datasets={"driving": sum(r["buckets"].values()) - dreamer,
                                    "dreamer": dreamer}))
        log(f"{tag} step {r['step']}: buckets {r['buckets']}, datasets "
            f"{draws[-1]['datasets']}, answer tokens {r['answer_tokens']}, longest prompt "
            f"{r['longest_prompt']} of {d.max_text_len}; loss {r['loss']:.5f} (language "
            f"{r['language_loss']:.5f}, route {r['route_loss']:.5f}, speed_wps "
            f"{r['speed_wps_loss']:.5f}), grad_norm {r['grad_norm']:.4f}")
    log(f"{tag} answer tokens over the run {sum(b['answer_tokens'] for b in draws)}; "
        f"dreamer samples drawn {sum(b['datasets']['dreamer'] for b in draws)} (reported, "
        f"not held: the draw is the seed's){'' if good else ': FAIL (language off or no draw)'}")
    log(f"{tag} steps: ms {[round(r['ms'], 2) for r in recs]}, the {len(timed)} timed "
        f"{ms:.2f} ms a step ({d.batch_size * 1e3 / ms:.3f} samples/s); host batch ms "
        f"{[round(r['host_ms'], 1) for r in recs]}; "
        f"{'finite' if ok else 'FAIL'}; peak {peak / 2 ** 30:.2f} GiB; whole run {run_s:.1f} s")
    want = {k: n for k, n in train_launches_per_step(m).items() if n}
    got = per_step[0] if per_step else {}
    good = got == want
    ok &= good
    log(f"{tag} launches a step over steps 2-{COLLECT_STEPS}: {got}, reckoned {want} "
        f"(train_launches_per_step) {'OK' if good else 'FAIL'}; over the run {launches}")
    t0 = time.perf_counter()
    trained = out["model_cfg"]
    pt = ckpt.save_hf_checkpoint(os.path.join(work, "collect_model.pt"), out["state"].params,
                                 trained)
    save_s = time.perf_counter() - t0
    ckpt.wait_for_checkpoints()
    final = ckpt.latest_checkpoint(os.path.join(work, "collect_runs", cfg.name, "checkpoints"))
    good = final is not None and final.endswith(f"step_{COLLECT_STEPS:08d}")
    ok &= good
    log(f"{tag} the trainer's final checkpoint {os.path.relpath(final, work) if final else None}; "
        f"the trained model as a trained-SimLingo .pt: {os.path.getsize(pt) / 1e9:.3f} GB "
        f"in {save_s:.2f} s {'OK' if good else 'FAIL'}")
    del out
    return ok, dict(records=recs, ms_per_step=ms, peak_bytes=peak, run_s=run_s,
                    launches=launches, launches_per_step=got, draws=draws,
                    pt_bytes=os.path.getsize(pt), pt_save_s=save_s), pt, trained


def collect_replay(torch, dev, hf_path, route_dir, plugin=None):
    """`agent/replay.replay_route` of the first collected route through
    `sim/suite.load_model_agent` (phase 7's .pt, the default AgentConfig:
    CoT, int8 LLM, speculative; bf16; initial_frames_delay set to 0, as
    phase 8 does) for REPLAY_FRAMES frames: each frame's ms and launches,
    held exactly to `serve_launches` of its work, beside phase 8's ticks;
    the agent's controls beside the expert's recorded ones (reported, not
    held: the weights are random)."""
    import numpy as np
    from simlingo_tpu_torch.agent.replay import replay_route
    from simlingo_tpu_torch.sim import suite as SU
    tag = "[collect_replay]"
    kernels = kernel_fns()
    t0 = time.perf_counter()
    agent = SU.load_model_agent(hf_path, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m = agent.model_cfg
    agent.cfg.initial_frames_delay = 0
    frames, inner = [], agent.run_step

    def run_step(frame):
        before = {k: fn.launches for k, fn in kernels.items()}
        t = time.perf_counter()
        out = inner(frame)
        torch.cuda.synchronize()
        frames.append(dict(ms=(time.perf_counter() - t) * 1e3, tokens=len(out["language_tokens"]),
                           launches={k: fn.launches - before[k] for k, fn in kernels.items()
                                     if fn.launches - before[k]}))
        return out
    agent.run_step = run_step
    for fn in kernels.values():
        fn.launches = 0
    outs = replay_route(agent, route_dir, max_frames=REPLAY_FRAMES)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    agent.run_step = inner
    spec_stats = list(agent.spec_stats)
    agent.close()
    del agent
    torch.cuda.empty_cache()
    ok = len(outs) == len(frames) == REPLAY_FRAMES == len(spec_stats) + 1
    for i, (f, out) in enumerate(zip(frames, outs)):
        rounds = None if i == 0 else spec_stats[i - 1][0]
        want = serve_launches(m, f["tokens"], rounds)
        fin = bool(np.isfinite(out["route"]).all() and np.isfinite(out["speed_wps"]).all())
        good = f["launches"] == want and fin and out["frame"] == i
        ok &= good
        exp = out["expert"]
        f.update(rounds=rounds, reckoned=want, control=[out["steer"], out["throttle"],
                                                        bool(out["brake"])], expert=exp)
        beside = "phase 8 not run"
        if plugin is not None and i < len(plugin["ticks"]):
            p = plugin["ticks"][i]
            beside = f"phase 8's tick {i} {p['ms']:.2f} ms, launches {p['launches']}"
        log(f"{tag} frame {out['frame']} {'cot_plain' if i == 0 else 'cot_spec':9s} "
            f"{f['ms']:9.2f} ms: tokens={f['tokens']} rounds={rounds} launches {f['launches']} "
            f"({'= reckoned' if good else f'reckoned {want}: FAIL'}); {beside}; agent steer / "
            f"throttle / brake {out['steer']:.4f} / {out['throttle']:.4f} / {bool(out['brake'])}, "
            f"the expert's {exp['steer']:.4f} / {exp['throttle']:.4f} / {exp['brake']}")
    log(f"{tag} load_model_agent in {setup_s:.1f} s; launches over the replay {launches}")
    return ok, dict(setup_s=setup_s, frames=frames, spec_stats=spec_stats, launches=launches)


def collect_loop(torch, dev, pt_path, model_cfg, microsim_ticks=None):
    """The trained model in closed loop: `sim/suite.load_model_agent` on
    `collect_training`'s .pt with the trained model's configuration
    (`model_cfg`, held equal to the agent's) and the default AgentConfig
    (CoT, int8 LLM, speculative; bf16; initial_frames_delay set to 0),
    `drive_closed_loop` of LOOP_ROUTE for LOOP_TICKS ticks: each tick's ms
    split into camera, agent and world, launches held exactly to
    `serve_launches`, beside phase 10's speculative ticks (`microsim_ticks`,
    the profiled one left out); the record's scores finite, not held to a
    value (the weights are nearly random)."""
    from simlingo_tpu_torch.sim import suite as SU
    tag = "[collect_loop]"
    t0 = time.perf_counter()
    agent = SU.load_model_agent(pt_path, device=dev, model_cfg=model_cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m = agent.model_cfg
    ok = m == model_cfg
    agent.cfg.initial_frames_delay = 0
    rec, ticks, _, wall_s, launches = drive_closed_loop(torch, agent, LOOP_ROUTE, LOOP_TICKS)
    spec_stats = list(agent.spec_stats)
    agent.close()
    del agent
    torch.cuda.empty_cache()
    ok &= held_ticks(tag, m, ticks, spec_stats, LOOP_TICKS)
    split = {k: _p50_max([t[k] for t in ticks[1:]])
             for k in ("ms", "camera_ms", "agent_ms", "world_ms")}
    beside = "phase 10 not run"
    if microsim_ticks:
        spec = [t["ms"] for i, t in enumerate(microsim_ticks)
                if i not in (0, MICROSIM_PROFILE_TICK)]
        beside = f"phase 10's speculative ticks p50 / max {'%.2f / %.2f' % _p50_max(spec)} ms"
    log(f"{tag} load_model_agent({os.path.basename(pt_path)}) in {setup_s:.1f} s, the "
        f"trained configuration (ViT gelu_approximate={m.vit.gelu_approximate}, LoRA "
        f"r={m.llm.lora_r}) {'OK' if m == model_cfg else 'FAIL: not the trained model'}; "
        f"{len(ticks) - 1} speculative ticks p50 / max: tick {split['ms'][0]:.2f} / "
        f"{split['ms'][1]:.2f} ms = camera {split['camera_ms'][0]:.2f} / "
        f"{split['camera_ms'][1]:.2f} + agent {split['agent_ms'][0]:.2f} / "
        f"{split['agent_ms'][1]:.2f} + world {split['world_ms'][0]:.2f} / "
        f"{split['world_ms'][1]:.2f}; the first (plain CoT) {ticks[0]['ms']:.2f} ms; {beside}")
    good = (all(math.isfinite(v) for v in rec["scores"].values())
            and rec["meta"]["duration_game"] == round(LOOP_TICKS * 0.05, 3))
    ok &= good
    log(f"{tag} {LOOP_ROUTE['route_id']} after {len(ticks)} ticks ({wall_s:.1f} s): status "
        f"{rec['status']!r}, scores {rec['scores']} {'finite' if good else 'FAIL'}; "
        f"launches over the route {launches}")
    return ok, dict(setup_s=setup_s, wall_s=wall_s, ticks=ticks, spec_stats=spec_stats,
                    split_p50_max=split, record=rec, launches=launches)


def collect(torch, dev, hf_path, work, plugin=None, microsim_ticks=None):
    """Phase 10b: collect COLLECT_ROUTES with the expert, label them
    (`collect_label`), train on them with language, dreamer and buckets on
    (`collect_train`), drive the trained model in closed loop
    (`collect_loop`), replay the first route through the default agent on
    `hf_path` (`collect_replay`); all in `work`, which the caller
    removes."""
    t0 = time.perf_counter()
    ok, routes, root = collect_routes(work)
    stats = dict(collect=routes)
    if ok:
        ok, stats["label"] = collect_label(root)
    if ok:
        ok, stats["train"], pt, trained = collect_training(torch, dev, root, work)
        torch.cuda.empty_cache()
    if ok:
        ok, stats["loop"] = collect_loop(torch, dev, pt, trained, microsim_ticks)
    if ok:
        first = os.path.join(root, COLLECT_LAYOUT, f"Town12_{COLLECT_ROUTES[0]['route_id']}")
        ok, stats["replay"] = collect_replay(torch, dev, hf_path, first, plugin)
    stats["seconds"] = time.perf_counter() - t0
    log(f"[collect] phase 10b {'OK' if ok else 'FAILED'} in {stats['seconds']:.1f} s")
    return ok, stats


# the attention kernels' representative phase-2 case at each built head dim
ATTN_INSTANCE_CASES = {"flash_attn_fwd": {16: "tiny_llm", 32: "shardable_llm", 64: "llm_prefill",
                                          128: "base_large"},
                       "flash_attn_bwd": {16: "tiny_llm", 32: "shardable_llm", 64: "llm_train",
                                          128: "base_large"}}


# the fp32 instances' representative phase-2 cases, and the paths that
# launch them (every launch of these kernels there is an fp32 instance's)
FP32_LINE_CASES = {"flash_attn_fwd": "vit_train_fp32", "flash_attn_bwd": "llm_train_fp32",
                   "dropout": "lora_x_896_fp32", "layernorm_fwd": "vit_fp32",
                   "layernorm_bwd": "vit_fp32", "rmsnorm_fwd": "llm_train_fp32",
                   "rmsnorm_bwd": "llm_train_fp32", "int8_matmul": "gate_up_fp32",
                   "int8_matmul_dx": "gate_up_fp32", "fused_ce_fwd": "train_fp32",
                   "fused_ce_bwd": "train_fp32"}
# the paths whose launches the fp32 entries count: phase 5's fp32 cells
# (`--fp32` also runs train_fp32_ln, train_fp32_int8 and serve_fp32) and
# phase 3's small fp32 steps (the int8 base's only there in the full run)
FP32_PATHS = ("train_fp32", "train_fp32_ln", "train_fp32_gated", "train_fp32_int8",
              "serve_fp32", "small_fp32_plain", "small_fp32_ln", "small_fp32_gated",
              "small_fp32_int8")


def kernel_line(cases, launches, by_dim=None, small=None):
    """One entry per ported kernel, at a representative shape of its path;
    launches: {path: {kernel: count}} from each path's counted run; small:
    the same of phase 3's small steps, counted only under "fp32"; by_dim:
    {path: {attention kernel: {head dim: count}}} where a path counted them
    (SimLingo-Base's). The attention kernels also list each built head
    dim's instance at its representative phase-2 case. A kernel with an
    fp32 build also lists it under "fp32" (its representative fp32 case,
    FP32_LINE_CASES, with the same keys, and its launches on FP32_PATHS),
    the attention kernels each head dim's fp32 instance too."""
    meta = {
        "flash_attn_fwd": ("simlingo_tpu_torch/csrc/flash_attn_fwd.cu",
                           [f"simlingo_tpu/kernels/flash_attention.py:{n}"
                            for n in (308, 786, 114)], "llm_prefill"),
        "int8_matmul": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                        "simlingo_tpu/kernels/quantized_matmul.py:49", "gate_up"),
        "int8_matmul_dx": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                           "simlingo_tpu/kernels/quantized_matmul.py:81", "gate_up"),
        "flash_attn_bwd": ("simlingo_tpu_torch/csrc/flash_attn_bwd.cu",
                           [f"simlingo_tpu/kernels/flash_attention.py:{n}"
                            for n in (382, 869, 205)], "llm_train"),
        "dropout": ("simlingo_tpu_torch/csrc/dropout.cu",
                    "simlingo_tpu/kernels/dropout.py:32", "lora_x_896"),
        "layernorm_fwd": ("simlingo_tpu_torch/csrc/layernorm.cu",
                          "simlingo_tpu/kernels/layernorm.py:54", "vit"),
        "layernorm_bwd": ("simlingo_tpu_torch/csrc/layernorm.cu",
                          "simlingo_tpu/kernels/layernorm.py:84", "vit"),
        "rmsnorm_fwd": ("simlingo_tpu_torch/csrc/layernorm.cu",
                        "simlingo_tpu/kernels/layernorm.py:71", "llm_train"),
        "rmsnorm_bwd": ("simlingo_tpu_torch/csrc/layernorm.cu",
                        "simlingo_tpu/kernels/layernorm.py:110", "llm_train"),
        "fused_ce_fwd": ("simlingo_tpu_torch/csrc/fused_ce.cu",
                         "simlingo_tpu/kernels/fused_ce.py:55", "train"),
        "fused_ce_bwd": ("simlingo_tpu_torch/csrc/fused_ce.cu",
                         "simlingo_tpu/kernels/fused_ce.py:85", "train"),
    }
    out = []
    for name, (src, replaces, case) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        rows = 4788 if name == "int8_matmul_dx" else 640    # int8: prefill; dx: training
        rep = [c for c in mine if c["case"] == case and c.get("M", rows) == rows][0]
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": max(c["max_abs_err"] for c in mine),
                    "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"], "shape": rep["shape"]})
        if name in FP32_LINE_CASES:
            f = [c for c in mine if c["case"] == FP32_LINE_CASES[name]][0]
            paths = {**(small or {}), **launches}
            fp32_paths = {p: paths[p].get(name, 0) for p in FP32_PATHS if p in paths}
            out[-1]["fp32"] = {
                "case": f["case"], "shape": f["shape"], "launches": sum(fp32_paths.values()),
                "launches_by_path": fp32_paths,
                "max_abs_err": max(c["max_abs_err"] for c in mine if c.get("dtype") == "fp32"),
                "ms": f["kernel_ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"], "library_ms": f["library_ms"]}
            if name in ATTN_INSTANCE_CASES:
                out[-1]["fp32"]["instances"] = {
                    str(d): {k: c[k] for k in ("case", "shape", "kernel_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms",
                                               "err_over_rms")}
                    for d, case_name in FP32_ATTN_INSTANCES.items()
                    for c in mine if c["case"] == case_name}
        if name in ATTN_INSTANCE_CASES:
            out[-1]["instances"] = {
                str(d): {k: c[k] for k in ("case", "shape", "kernel_ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                for d, case_name in ATTN_INSTANCE_CASES[name].items()
                for c in mine if c["case"] == case_name}
            out[-1]["launches_by_dim_by_path"] = {
                path: {str(d): n for d, n in dims[name].items()}
                for path, dims in (by_dim or {}).items()}
    return {"kernels": out}


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def disk_and_eval_phases(torch, dev, per_frame=None):
    """Phases 7, 8, 9, 10 and 10b in one workspace under build/, removed
    after; returns (ok, phase 7's stats, {"carla_plugin": ...,
    "eval_language": ..., "microsim": ..., "collect": ...}) with a phase's
    stats only where it ran."""
    import tempfile
    from simlingo_tpu_torch.core import checkpoint as ckpt
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="disk_training_", dir=os.path.join(ROOT, "build"))
    after = {}
    try:
        ok, disk_stats, written = disk_training(torch, dev, work)
        if ok:
            ok, after["carla_plugin"] = carla_plugin(torch, dev, written["hf_checkpoint"],
                                                     work, per_frame)
            torch.cuda.empty_cache()
        if ok:
            ok, after["eval_language"] = eval_language(torch, dev, work,
                                                       written["final_checkpoint"])
            torch.cuda.empty_cache()
        if ok:
            ok, after["microsim"] = microsim(torch, dev, written["hf_checkpoint"], work,
                                             after["carla_plugin"])
            torch.cuda.empty_cache()
        if ok:
            ok, after["collect"] = collect(torch, dev, written["hf_checkpoint"], work,
                                           after["carla_plugin"], after["microsim"]["ticks"])
            torch.cuda.empty_cache()
    finally:
        ckpt.wait_for_checkpoints()
        shutil.rmtree(work, ignore_errors=True)
    return ok, disk_stats, after


def microsim_only(torch, dev, phase=None):
    """`--microsim` / `--collect`: phase 10 (or `phase`, e.g. 10b's
    `collect`) alone, on a random trained-SimLingo .pt written as phase 7
    writes it (no training), in a workspace under build/, removed after."""
    import tempfile
    from simlingo_tpu_torch.core import presets
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="microsim_", dir=os.path.join(ROOT, "build"))
    try:
        hf_path = os.path.join(work, "pytorch_model.pt")
        torch.save(simlingo_state_dict(presets.internvl2_1b(lora=True), torch, dev), hf_path)
        torch.cuda.empty_cache()
        return (phase or microsim)(torch, dev, hf_path, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def fp32_small_agreements(torch, dev):
    """Phase 3 at fp32: the small step on the card's fp32 kernels against
    the CPU's fp32 plain step, gates off, with the LN gate, with both gates
    (the fused CE) and on the int8 base."""
    return (small_training_agreement(torch, dev, fp32=True)
            and small_training_agreement(torch, dev, gated=FP32_LN_GATE, fp32=True)
            and small_training_agreement(torch, dev, gated=True, fp32=True)
            and small_training_agreement(torch, dev, int8_base=True, fp32=True))


# phase 5's precision=fp32 cells after `train_fp32`: (gates, int8 base)
FP32_CELLS = {"train_fp32_ln": (FP32_LN_GATE, False), "train_fp32_gated": (GATES_ON, False),
              "train_fp32_int8": ({}, True)}


def fp32_training(torch, dev, plain, cells=("train_fp32_gated",)):
    """Phase 5 at fp32: `train_fp32` (gates off), then each of `cells`
    (FP32_CELLS), beside phase 5's bf16 run `plain` (`compare_fp32`);
    returns (ok, {cell: stats})."""
    torch.cuda.empty_cache()
    ok, fp32 = full_width_training(torch, dev, fp32_gates={})
    runs = {"train_fp32": fp32}
    for cell in cells:
        if not ok:
            return False, runs
        torch.cuda.empty_cache()
        gates, int8_base = FP32_CELLS[cell]
        ok, runs[cell] = full_width_training(torch, dev, int8_base=int8_base, fp32_gates=gates)
    ok = ok and compare_fp32(plain, fp32, {c: runs[c] for c in cells})
    torch.cuda.empty_cache()
    return ok, runs


def serve_fp32(torch, dev):
    """`serve_fp32`: LingoAgent(compute_dtype=torch.float32) at
    SimLingoConfig() width with the default AgentConfig (CoT, int8 LLM,
    speculative), seed-0 fp32 weights, FRAMES CoT frames on phase 4's frame
    (the first plain, then speculative): frame ms, tokens, decode ms/token
    (the plain generator at max_new_tokens vs 1 new token), peak memory;
    each frame's launches of flash_attn_fwd and int8_matmul held to
    `serve_launches`, every one an fp32 instance's; waypoints finite.
    Returns (ok, stats)."""
    import numpy as np
    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.infer import runner
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    from simlingo_tpu_torch.models import simlingo

    cfg = simlingo.SimLingoConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = simlingo.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                  device=dev, dtype=torch.float32)
    acfg = AgentConfig(initial_frames_delay=0, jpeg_roundtrip=False)
    t0 = time.perf_counter()
    agent = LingoAgent(params, cfg, acfg, compute_dtype=torch.float32, device=dev)
    del params
    torch.cuda.synchronize()
    log(f"[serve_fp32] SimLingoConfig(), LingoAgent(compute_dtype=torch.float32) on the "
        f"default AgentConfig (int8_llm={acfg.int8_llm}, speculative_cot="
        f"{acfg.speculative_cot}); built + warmed up in {time.perf_counter() - t0:.1f} s")
    frame = _frame(AgentFrame, np)
    fns = {"flash_attn_fwd": FA.flash_attn_fwd, "int8_matmul": QM.int8_matmul}
    for fn in fns.values():
        fn.launches = fn.launches_fp32 = 0
    ok, results, per_frame = True, [], []
    for i in range(FRAMES):
        before = {k: (fn.launches, fn.launches_fp32) for k, fn in fns.items()}
        r = agent.run_step(frame)
        results.append(r)
        got = {k: fn.launches - before[k][0] for k, fn in fns.items()}
        got32 = {k: fn.launches_fp32 - before[k][1] for k, fn in fns.items()}
        per_frame.append(got)
        want = serve_launches(cfg, len(r.get("language_tokens", [])),
                              None if i == 0 else agent.spec_stats[i - 1][0])
        fin = bool(np.isfinite(r["route"]).all() and np.isfinite(r["speed_wps"]).all()
                   and r["route"].shape == (20, 2))
        good = fin and got == want and got32 == got
        ok &= good
        log(f"[serve_fp32] frame {i} {'cot_plain' if i == 0 else 'cot_spec':9s} "
            f"{r['latency_s'] * 1e3:9.2f} ms tokens={len(r.get('language_tokens', []))} "
            f"route[-1]={np.round(r['route'][-1], 4).tolist()} launches {got} (fp32 "
            f"instances {got32}), reckoned {want} {'OK' if good else 'FAIL'}")
    di = agent._preprocessed(agent.make_input(frame))
    gen_ms = {}
    for n_new in (1, acfg.max_new_tokens):
        gcfg = runner.GenerateConfig(max_new_tokens=n_new, eos_token_id=agent.tok.eos_token_id)
        runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg,
                                  compute_dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.generate_and_drive(agent.params, di, agent.model_cfg, gcfg,
                                        compute_dtype=torch.float32)
        gen_ms[n_new] = ((time.perf_counter() - t0) * 1e3, int(out.language_lengths[0]))
    (t1, _), (tn, ntok) = gen_ms[1], gen_ms[acfg.max_new_tokens]
    decode_ms = (tn - t1) / max(ntok - 1, 1)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve_fp32] speculative (rounds, gen_len) per frame: {agent.spec_stats}; plain "
        f"generate: 1 token {t1:.2f} ms, {ntok} tokens {tn:.2f} ms -> decode {decode_ms:.3f} "
        f"ms/token; peak memory {peak / 2 ** 30:.2f} GiB")
    launches = {k: sum(f[k] for f in per_frame) for k in fns}
    stats = dict(frame_ms_cot_plain=results[0]["latency_s"] * 1e3,
                 frame_ms_cot_spec=[r["latency_s"] * 1e3 for r in results[1:]],
                 tokens_per_frame=[len(r.get("language_tokens", [])) for r in results],
                 spec_stats=agent.spec_stats, decode_ms_per_token=decode_ms, peak_bytes=peak,
                 launches=launches, launches_per_frame=per_frame)
    del agent
    torch.cuda.empty_cache()
    return ok, stats


class phase_clock:
    """Logs the seconds since the run began at each phase's end."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, what):
        now = time.perf_counter()
        log(f"[time] {what}: {now - self.last:.1f} s (at {now - self.t0:.1f} s)")
        self.last = now


def run_path_phases(torch, dev, cases, clock) -> int:
    if not (small_model_agreement(torch, dev) and small_training_agreement(torch, dev)
            and small_training_agreement(torch, dev, gated=True)
            and small_training_agreement(torch, dev, int8_base=True)
            and fp32_small_agreements(torch, dev)
            and small_remat_agreement(torch, dev) and small_int4_agreement(torch, dev)
            and small_base_agreement(torch, dev)):
        return 1
    clock("phase 3 (small-model agreements)")
    ok, stats, agent, frame = full_width(torch, dev, gated_pass=True, int4_pass=True)
    if not ok:
        return 1
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    QM.int8_matmul.launches = 0
    stats["profile"] = device_profile(torch, lambda: agent.run_step(frame),
                                      "one speculative frame")
    calls = QM.int8_matmul.launches
    fwd = sum(stats["profile"]["hand"].get(k, {"count": 0})["count"] for k in INT8_FWD_KERNELS)
    log(f"[profile] int8_matmul calls in the profiled frame {calls}, forward-kernel "
        f"launches {fwd} {'OK' if fwd == calls else 'DIFFERS'} (one launch a call)")
    del agent, frame
    clock("phase 4 (serving)")
    ok, train_stats = full_width_training(torch, dev)
    if not ok:
        return 1
    ok, fp32_runs = fp32_training(torch, dev, train_stats)
    if not ok:
        return 1
    clock("phase 5: train, train_fp32, train_fp32_gated")
    torch.cuda.empty_cache()
    ok, gated_stats = full_width_training(torch, dev, gated=True)
    if not ok or not compare_training(train_stats, gated_stats):
        return 1
    torch.cuda.empty_cache()
    ok, int8_stats = full_width_training(torch, dev, int8_base=True)
    if not ok:
        return 1
    compare_int8_base(train_stats, int8_stats)
    torch.cuda.empty_cache()
    remat_stats = {}
    for mode in REMAT_MODES:
        ok, remat_stats[mode] = full_width_training(torch, dev, remat=mode)
        if not ok or not compare_remat(train_stats, remat_stats[mode], mode):
            return 1
        torch.cuda.empty_cache()
    ok, fused_stats = full_width_training(torch, dev, lora_fused=True)
    if not ok:
        return 1
    compare_lora_fused(train_stats, fused_stats)
    torch.cuda.empty_cache()
    clock("phase 5: the gated, int8, remat and fused-LoRA runs")
    ok, mesh_stats = mesh_training(torch, dev)
    if not ok:
        return 1
    clock("phase 5b (mesh)")
    torch.cuda.empty_cache()
    smi = smi_line()
    ok, base_launches, base_by_dim = run_base_phases(torch, dev, smi)
    if not ok:
        return 1
    clock("phase 6 (SimLingo-Base)")
    per_frame = dict(launches=stats["launches_per_frame"], tokens=stats["tokens_per_frame"],
                     spec=stats["spec_stats"])
    ok, disk_stats, eval_stats = disk_and_eval_phases(torch, dev, per_frame)
    if not ok:
        return 1
    clock("phases 7-10b (disk, plugin, evaluation, microsim, collection)")
    for name, st in (("agent", stats), ("train", train_stats), *fp32_runs.items(),
                     ("train_gated", gated_stats),
                     ("train_int8", int8_stats),
                     *((f"train_remat_{m}", st) for m, st in remat_stats.items()),
                     ("train_lora_fused", fused_stats), ("mesh_training", mesh_stats), ("train_disk", disk_stats),
                     ("carla_plugin", eval_stats["carla_plugin"]),
                     ("eval_language", eval_stats["eval_language"]),
                     ("microsim", eval_stats["microsim"]), ("collect", eval_stats["collect"])):
        with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi), f, indent=1)
    launches = {"serve": stats["launches"], "serve_gated": stats["gated"]["launches"],
                "serve_int4": stats["int4"]["launches"], "train": train_stats["launches"],
                **{name: st["launches"] for name, st in fp32_runs.items()},
                "train_gated": gated_stats["launches"], "train_int8": int8_stats["launches"],
                **{f"train_remat_{m}": st["launches"] for m, st in remat_stats.items()},
                "train_lora_fused": fused_stats["launches"],
                **{run: st["launches"] for run, st in mesh_stats["runs"].items()},
                **base_launches, "train_disk": disk_stats["launches"],
                "carla_plugin": eval_stats["carla_plugin"]["launches"],
                "eval_language": eval_stats["eval_language"]["launches"],
                "microsim": eval_stats["microsim"]["launches"],
                "collect_train": eval_stats["collect"]["train"]["launches"],
                "collect_loop": eval_stats["collect"]["loop"]["launches"],
                "collect_replay": eval_stats["collect"]["replay"]["launches"]}
    small = {k: v["launches"] for k, v in SMALL_LAUNCHES.items()}
    print(json.dumps(kernel_line(cases, launches, base_by_dim, small)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# multi-GPU training: the dp x fsdp x tp mesh (`mesh_training`)
# ---------------------------------------------------------------------------

# (run, (dp, fsdp, tp, sp, pp), batch a data rank, gated, control):
# internvl2_1b(lora=True), remat off, dropout on, seed 0; a global batch of
# 6 in every run; mesh_pp2 at its default 2 microbatches of 3 rows, stage
# remat on (`pipeline.enable`'s default, as JAX's)
MESH_RUNS = (("mesh_dp2", (2, 1, 1, 1, 1), 3, False, "halves"),
             ("mesh_fsdp2", (1, 2, 1, 1, 1), 3, False, "halves"),
             ("mesh_tp2", (1, 1, 2, 1, 1), 6, True, "tp"),
             ("mesh_sp2", (1, 1, 1, 2, 1), 6, False, "seq_halves"),
             ("mesh_pp2", (1, 1, 1, 1, 2), 6, False, "halves"))
MESH_AXES = ("dp", "fsdp", "tp", "sp", "pp")
# SimLingo-Base at tp = 2 (`base_tp2`, A13d): `base`'s configuration
# (CLIP ViT-L/14-336, 23 layers run; the tiny LLaMA), global batch 16,
# MESH_STEPS steps, ungated, in the same spawn, against the `tp` control
BASE_TP_RUN, BASE_TP_SHAPE, BASE_TP_CONTROL = "base_tp2", (1, 1, 2, 1, 1), "tp"
BASE_KEYS = ("loss", "grad_norm_vision", "grad_norm_rest")
# the ring-off run: mesh_sp2 on a sequence of 767 + 30 = 797 positions,
# which does not divide over sp = 2: the trainer must raise after step 1
RING_OFF_TEXT_LEN = 767
# steps a mesh run takes: the checks read step 1 and the last step; 2 (not
# 3) keeps the full run inside its time limit, as the ranks' host-bound
# staging makes this the phase that varies most between calls
MESH_STEPS = 2
MESH_TIMEOUT = 600          # seconds the ranks may take for every run, spawn to exit
# A run is held to its control, the one-process step that makes the run's
# reductions (`control_step`), within MESH_MULT times the control's own
# difference from the one-process trainer: the size of the rounding those
# reductions change, measured in the same call on the same data
MESH_MULT = 4.0


def mesh_cfg(batch, shape=(1, 1, 1, 1, 1), text_len=768):
    import dataclasses
    from simlingo_tpu_torch.core import presets
    from simlingo_tpu_torch.core.config import compose
    cfg = compose([f"max_steps={MESH_STEPS}", f"data.batch_size={batch}",
                   f"data.max_text_len={text_len}", "seed=0", "output_dir=",
                   "log_every_n_steps=1"]
                  + [f"mesh.{a}={n}" for a, n in zip(MESH_AXES, shape)])
    cfg.model = dataclasses.replace(presets.internvl2_1b(lora=True), remat_vision=False,
                                    remat_llm=False)
    return cfg


def base_mesh_cfg(shape=(1, 1, 1, 1, 1)):
    """`base`'s configuration (configs/simlingo_base.yaml: batch 16 a data
    rank) for MESH_STEPS steps on a mesh of `shape`."""
    return _base_cfg("base", f"max_steps={MESH_STEPS}",
                     *(f"mesh.{a}={n}" for a, n in zip(MESH_AXES, shape)))


class _TPOfOne:
    """The mesh `forward_loss` is given by the `tp` control: a tp group of
    one rank (its collectives the identity), so that the model takes its
    tp code paths, every split linear through `layers.tp_params`."""
    batch_size = 1

    def __init__(self):
        from simlingo_tpu_torch.parallel.mesh import Comm
        self.tp = Comm()


class _HalfTP:
    """Rank `rank` of a tp group of 2 whose reduction the caller makes
    (`tp2_products`): the identity here."""
    size = 2

    def __init__(self, rank):
        self.rank = rank

    def all_reduce(self, x):
        return x


@contextlib.contextmanager
def tp2_products(torch):
    """The model, given `_TPOfOne`, with each tp-split product cut as tp = 2
    cuts it, in one process. A row-parallel linear (o, down, fc2, the
    projector's fc2) is two bf16 partials over the halves of its input
    features, each with its LoRA delta where it has one (A's columns of
    the half, dropout placed as the rank places it), summed in bf16, then
    the bias, as `row_finish` adds it. A column-parallel one (q, k, v,
    gate, up, fc1, the projector's fc1) is the two halves of its output
    features, each a product of its own, so its input's gradient sums two
    partials. Every split linear of the ViT, Qwen2, SimLingo-Base's CLIP
    tower and projector, and its LLaMA (`base_tp_control`) goes through
    `layers.tp_params`, so all are cut. The fused LoRA groups are not
    (the mesh runs leave SIMLINGO_LORA_FUSED off)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.models import layers as L
    from simlingo_tpu_torch.models import qwen2 as Q
    tp_params, linear = L.tp_params, L.linear
    lora_linear, mlp_block = Q._linear_maybe_lora, Q._mlp_block

    def split_params(p, role, tp):
        q = tp_params(p, role, tp)
        return dict(q, tp2_role=role) if tp is not None and tp.size == 1 else q

    def split_linear(p, x):
        if "tp2_role" not in p:
            return linear(p, x)
        if "w_q" in p:
            raise ValueError("the tp control runs bf16 weights only")
        w = p["w"].to(x.dtype)
        if p["tp2_role"] == "row":
            h = w.shape[1] // 2
            return (F.linear(x[..., :h].contiguous(), w[:, :h].contiguous())
                    + F.linear(x[..., h:].contiguous(), w[:, h:].contiguous()))
        n = w.shape[0] // 2
        b = p["b"].to(x.dtype) if "b" in p else None
        return torch.cat([F.linear(x, w[:n], None if b is None else b[:n]),
                          F.linear(x, w[n:], None if b is None else b[n:])], -1)

    def finish(parts, p):
        y = parts[0] + parts[1]
        return y + p["b"].to(y.dtype) if "b" in p else y

    def split_lora_linear(p, lora, x, cfg, seed=None, tp=None, role="column", row0=0):
        if tp is None or tp.size != 1 or role != "row":
            return lora_linear(p, lora, x, cfg, seed, tp, role, row0)
        h = x.shape[-1] // 2
        return finish([lora_linear({"w": p["w"][:, i * h:(i + 1) * h]}, lora,
                                   x[..., i * h:(i + 1) * h].contiguous(), cfg, seed,
                                   _HalfTP(i), "row", row0) for i in range(2)], p)

    def split_mlp_block(p, lora, x, cfg, seeds=None, tp=None, row0=0):
        down = lora.get("down") if lora else None
        if (tp is None or tp.size != 1 or down is None or seeds is None
                or cfg.lora_dropout <= 0):
            return mlp_block(p, lora, x, cfg, seeds, tp, row0)
        # the fused SwiGLU LoRA path of `qwen2._mlp_block`, a rank's half each
        x = L.tp_copy(x, tp)
        xg, xu = (split_lora_linear(p[n], lora.get(n), x, cfg, seeds[n], tp, "column", row0)
                  for n in ("gate", "up"))
        h = xg.shape[-1] // 2
        a, b = down["a"].to(x.dtype), down["b"].to(x.dtype)
        parts = []
        for i in range(2):
            half, tpi = slice(i * h, (i + 1) * h), _HalfTP(i)
            g, u = xg[..., half].contiguous(), xu[..., half].contiguous()
            y = F.linear(F.silu(g) * u, p["down"]["w"][:, half].contiguous().to(g.dtype))
            parts.append(y + (cfg.lora_alpha / cfg.lora_r) * Q._LoraDropDeltaGLU.apply(
                g, u, L.tp_slice(a, 1, tpi), b, seeds["down"], cfg.lora_dropout,
                Q._drop_block(g, row0, tpi, "row")))
        return finish(parts, p["down"])

    L.tp_params, L.linear = split_params, split_linear
    Q._linear_maybe_lora, Q._mlp_block = split_lora_linear, split_mlp_block
    try:
        yield
    finally:
        L.tp_params, L.linear = tp_params, linear
        Q._linear_maybe_lora, Q._mlp_block = lora_linear, mlp_block


@contextlib.contextmanager
def base_tp_control(torch):
    """The `tp` control of `base_tp2`: SimLingo-Base's one-process trainer
    with its forward given a tp group of one rank, so that CLIP and the
    LLaMA take their tp code paths, under `tp2_products`."""
    from simlingo_tpu_torch.models import simlingo_base as SB
    real, tp = SB.forward_loss, _TPOfOne().tp
    SB.forward_loss = lambda *a, **k: real(*a, **dict(k, tp=tp))
    try:
        with tp2_products(torch):
            yield
    finally:
        SB.forward_loss = real


def seq_halves_losses(torch, params, ex, seed, m, dtype=None):
    """The `seq_halves` control's forward: what the two ranks of an sp = 2
    step compute, in one process. Each "rank" i casts the masters and
    builds the whole sequence (the ViT included) itself, and runs the LLM
    on its half of the positions; the layers run half 0 then half 1, so
    that half 1's attention finds half 0's keys: half 0 is the causal
    diagonal (what the ring gives rank 0), half 1 the ring's two chunks
    merged by lse in ring order, and the backward the ring's own
    (`sequence.chunk_grads` a chunk against the global o / lse, fp32
    partials; dq summed in fp32; half 0's dk / dv, from both halves,
    summed in fp32 on its fp32 keys; each rounded once). Each half
    computes the loss terms of its positions (the queries' on half 1),
    every average over the whole batch's counts. Returns the two
    TrainingOutputs; their losses' sum is the step's loss. `dtype`: the
    compute dtype (bf16; the CPU test takes fp32)."""
    from simlingo_tpu_torch.core.structs import summarise_losses
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.models import adaptors as A
    from simlingo_tpu_torch.models import layers as L
    from simlingo_tpu_torch.models import qwen2 as Q
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.parallel import sequence as SQ
    from simlingo_tpu_torch.train import train_step as ts
    bf16 = dtype or torch.bfloat16

    def chunk_fwd(q, k, v, va, causal):
        if q.is_cuda:
            return FA.flash_attn_fwd(q, k, v, va, causal, None, None, return_lse=True)
        return (FA.attention_reference(q, k, v, va, causal),      # CPU tests
                FA.attention_lse_reference(q, k, va, causal))

    class Chunks(torch.autograd.Function):
        """A half's ring in one process: its queries against its key chunks
        (k, v fp32, va) in ring order, the causal diagonal first, merged by
        lse; the backward is the ring's (`SQ.chunk_grads`: fp32 partials,
        dq summed in ring order and rounded once, each chunk's dk / dv
        handed back unrounded to its fp32 keys)."""

        @staticmethod
        def forward(ctx, q, *kvs):
            o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), float("-inf"),
                             device=q.device)
            for c in range(0, len(kvs), 3):
                kc, vc, vac = kvs[c:c + 3]
                o, lse = SQ._merge(o, lse, *chunk_fwd(q, kc.to(q.dtype), vc.to(q.dtype), vac,
                                                      c == 0))
            o = o.to(q.dtype)
            ctx.save_for_backward(q, o, lse, *kvs)
            return o

        @staticmethod
        def backward(ctx, dout):
            q, o, lse, *kvs = ctx.saved_tensors
            dout = dout.contiguous()
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            grads = []
            for c in range(0, len(kvs), 3):
                kc, vc, vac = kvs[c:c + 3]
                g = SQ.chunk_grads(q, kc.to(q.dtype), vc.to(q.dtype), vac, o, dout, lse, c == 0)
                dq += g[0]
                grads += [g[1], g[2], None]
            return (dq.to(q.dtype), *grads)

    label = ex.driving_input.prompt
    B, T = label.ids.shape
    cfg = m.llm
    halves = []
    for i in range(2):
        tree = ts.cast_for_compute(params, bf16)
        embeds, valid, pos = simlingo.assemble_sequence(tree, label, ex.driving_input.pixel_values,
                                                        m, dtype=bf16)
        n = embeds.shape[1] // 2
        cut = slice(i * n, (i + 1) * n)
        inv = L.rope_frequencies(cfg.head_dim, cfg.rope_theta, embeds.device)
        halves.append(dict(tree=tree, x=embeds[:, cut], valid=valid[:, cut].to(torch.uint8)
                           .contiguous(), cs=L.rope_cos_sin(pos[:, cut], inv)))
    keys = {}

    def attention(q, k, v, kv_valid=None, causal=True, scale=None, q_offset=None):
        # fp32 keys: half 0's sum its two halves' fp32 partials and round once
        k, v = k.float(), v.float()
        if not keys:                  # half 0: its diagonal; its keys kept for half 1
            keys.update(k=k, v=v, va=kv_valid)
            return Chunks.apply(q, k, v, kv_valid)
        k0, v0, va0 = keys.pop("k"), keys.pop("v"), keys.pop("va")
        return Chunks.apply(q, k, v, kv_valid, k0, v0, va0)

    orig = Q.attention_autograd
    Q.attention_autograd = attention
    try:
        for li in range(cfg.num_layers):
            seeds = Q.layer_seeds(seed, li) if cfg.lora_dropout > 0 else None
            for i, h in enumerate(halves):
                lo = h["tree"]["lora"]["layers"][str(li)]
                h["x"] = Q._decoder_layer(h["tree"]["llm"]["layers"][str(li)], lo, h["x"], cfg,
                                          *h["cs"], h["valid"], True, None, None, seeds, None,
                                          (i * n, n, 2 * n))
    finally:
        Q.attention_autograd = orig
    dl = ex.driving_label
    losses = []
    for i, h in enumerate(halves):
        tree = h["tree"]
        hidden = L.rmsnorm(tree["llm"]["final_norm"], h["x"], cfg.rms_norm_eps)
        hg, labels, valid_g = A.gather_answer_states(hidden, label.ids, label.loss_mask,
                                                     m.max_answer_len, i * n)
        part = A.language_loss_gathered(
            hg, labels, valid_g, lambda x, t=tree: Q.logits_from_hidden(t["llm"], x, cfg),
            head_w=tree["llm"]["embed"]["w"])
        d_losses, _ = A.driving_loss(tree["adaptors"], hidden[:, -m.num_queries:], dl.path,
                                     dl.waypoints[:, :A.NUM_SPEED_QUERIES])
        if i == 0:
            d_losses = {k: (v, torch.zeros_like(c)) for k, (v, c) in d_losses.items()}
        part.update(d_losses)
        losses.append(part)
    counts = sum(torch.stack([c.float().sum() for _, c in part.values()]) for part in losses)
    return [summarise_losses(part, lambda _: counts) for part in losses]


def mesh_launches_per_step(m, shape, coords, batch):
    """A rank's attention and dropout launches a step on a mesh of `shape`
    (dp, fsdp, tp, sp, pp), reckoned from the schedule: under sp the causal
    ring folds i + 1 key chunks on rank i (a later rank's chunk is
    skipped), forward and backward; under pp a stage runs its L / pp layers
    on each of M microbatches, and stage remat re-runs each pass in the
    backward (the forward twice, dropout four times an adapter), while the
    ViT's backward runs on stage 0 alone (the only stage whose input has a
    cotangent). Elsewhere `train_launches_per_step`."""
    sp, pp = shape[3], shape[4]
    if sp == 1 and pp == 1:
        return train_launches_per_step(m)
    V, L = m.vit.num_layers, m.llm.num_layers
    drop = m.llm.lora_r > 0 and m.llm.lora_dropout > 0
    chunks = coords["sp"] + 1 if sp > 1 else 1
    if pp > 1:
        micro = next(d for d in range(min(pp, batch), 0, -1)   # `_num_microbatches` at 0
                     if batch % d == 0)
        runs, again = L // pp * micro, True
    else:
        runs, again = L, bool(m.remat_llm)
    return {"flash_attn_fwd": V * (2 if m.remat_vision is True else 1)
            + runs * chunks * (2 if again else 1),
            "flash_attn_bwd": (V if pp == 1 or coords["pp"] == 0 else 0) + runs * chunks,
            "dropout": dropped_inputs_per_layer() * runs * (4 if again else 3) if drop else 0}


def control_step(torch, state, ex, seed, model_cfg, opt_cfg, control):
    """One training step of a MESH_RUNS control in one process; returns its
    metrics. "halves": the batch as two accumulated halves, each
    loss average divided by the whole batch's count and the two losses
    summed in fp32 (what a dp = 2 or fsdp = 2 step computes); "tp": the
    whole batch through `tp2_products`; "seq_halves": the two sequence
    halves of an sp = 2 step (`seq_halves_losses`)."""
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.train import train_step as ts
    bf16 = torch.bfloat16
    for group in state.optimizer.param_groups:
        group["lr"] = ts.onecycle_schedule(opt_cfg)(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    if control == "seq_halves":
        outs = seq_halves_losses(torch, state.params, ex, seed, model_cfg)
        (outs[0].loss + outs[1].loss).backward()
        loss = outs[0].loss.detach().float() + outs[1].loss.detach().float()
        del outs
    elif control == "tp":
        with tp2_products(torch):
            out, _ = simlingo.forward_loss(ts.cast_for_compute(state.params, bf16), ex,
                                           model_cfg, dropout_seed=seed, compute_dtype=bf16,
                                           mesh=_TPOfOne())
            out.loss.backward()
        loss = out.loss.detach().float()
    else:
        with torch.no_grad():
            whole, _ = simlingo.forward_loss(ts.cast_for_compute(state.params, bf16), ex,
                                             model_cfg, dropout_seed=seed, compute_dtype=bf16)
        counts = torch.stack([whole.loss_counts[k].float() for k in whole.loss_averages])
        del whole
        loss = 0.0
        rows = ex.driving_input.prompt.ids.shape[0] // 2
        for h in range(2):
            part = M.put_batch(ex, M.Mesh(2, 1, 1, rank=h))
            out, _ = simlingo.forward_loss(ts.cast_for_compute(state.params, bf16), part,
                                           model_cfg, dropout_seed=seed, compute_dtype=bf16,
                                           batch_offset=rows * h, count_reduce=lambda c: counts)
            out.loss.backward()
            loss = loss + out.loss.detach().float()
    grads = []
    for x in state.trainable.values():
        if x.grad is None:
            x.grad = torch.zeros_like(x)
        grads.append(x.grad)
    norm = ts.clip_by_global_norm_(grads, opt_cfg.grad_clip)
    state.optimizer.step()
    state.step += 1
    return {"loss": float(loss), "grad_norm": float(norm)}


def mesh_reference(torch, dev, gated=False, control=None, want_p0=False):
    """A one-process run at global batch 6, seed 0: the trainer, or with
    `control` ("halves", "tp") the same steps through `control_step`:
    (per-step records, trainable leaves after the last step, and the
    initial ones where `want_p0`), the leaves fp32 on the host."""
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    with gates_set(gated):
        cfg = mesh_cfg(6)
        m = cfg.model
        params = simlingo.init_params(m, torch.Generator(device=dev).manual_seed(cfg.seed),
                                      device=dev)
        p0 = ({p: x.detach().to("cpu", torch.float32, copy=True)
               for p, x in ts.flatten(params).items() if ts.production_trainable(p)}
              if want_p0 else None)
        if control:
            state = ts.init_train_state(params, cfg.optimizer)
            del params
            ex = synthetic_example(m, batch=6, seq_len=cfg.data.max_text_len, num_patches=2,
                                   device=dev)
            recs = [control_step(torch, state, ex, trainer.step_seed(cfg.seed, i), m,
                                 cfg.optimizer, control) for i in range(MESH_STEPS)]
        else:
            res = trainer.train(cfg, make_synthetic=True, params=params, device=dev)
            del params
            state, recs = res["state"], res["records"]
            del res
        p3 = {p: x.detach().float().cpu() for p, x in state.trainable.items()}
    del state
    torch.cuda.empty_cache()
    return recs, p3, p0


def base_mesh_reference(torch, dev, control=False, want_p0=False):
    """`base` in one process at global batch 16, seed 0, MESH_STEPS steps:
    `train_base`, or with `control` the same under `base_tp_control`:
    (per-step records, every leaf after the last step, and the initial
    ones where `want_p0`), fp32 on the host."""
    from simlingo_tpu_torch.models import simlingo_base
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    cfg = base_mesh_cfg()
    params = simlingo_base.init_params(cfg.model,
                                       torch.Generator(device=dev).manual_seed(cfg.seed),
                                       device=dev)
    p0 = ({p: x.detach().to("cpu", torch.float32, copy=True)
           for p, x in ts.flatten(params).items()} if want_p0 else None)
    with base_tp_control(torch) if control else contextlib.nullcontext():
        res = trainer.train_base(cfg, params=params, device=dev)
    del params
    recs = res["records"]
    p3 = {p: x.detach().float().cpu() for p, x in ts.flatten(res["state"].params).items()}
    del res
    torch.cuda.empty_cache()
    return recs, p3, p0


def _update_err(p3, ref, p0):
    """||p3 - ref|| / ||ref - p0|| over every trainable element."""
    num = sum(float((p3[p] - ref[p]).double().square().sum()) for p in ref)
    den = sum(float((ref[p] - p0[p]).double().square().sum()) for p in ref)
    return (num / max(den, 1e-300)) ** 0.5


def mesh_rank() -> int:
    """One rank of the mesh runs (a child of `mesh_training`; its place
    from torchrun's variables): the trainer on each MESH_RUNS mesh in turn
    and SimLingo-Base's on `base_tp2`'s, each run's statistics (and, on the
    primary, the trained leaves gathered) into SIMLINGO_MESH_WORK. NCCL
    where every rank has a GPU of its own, else gloo, named to
    `initialize` (NCCL refuses two ranks on one GPU); over NCCL the
    trainer runs under torch.profiler, which times the collectives'
    kernels."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from simlingo_tpu_torch.parallel import mesh as M
    from simlingo_tpu_torch.parallel import multihost
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    work = os.environ["SIMLINGO_MESH_WORK"]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, gpus = int(os.environ["WORLD_SIZE"]), torch.cuda.device_count()
    backend = "nccl" if world <= gpus else "gloo"
    multihost.initialize(device="cuda", backend=backend)
    rank = multihost.rank()
    if rank == 0:
        print(f"{world} ranks on {gpus} GPU(s): backend {backend}"
              f"{' (the ranks share a GPU)' if backend == 'gloo' else ''}", flush=True)
    kernels = kernel_fns()

    def one_run(run, train):
        """One run of the trainer `train()` on this rank: its statistics, and
        its trained leaves gathered onto the primary, into SIMLINGO_MESH_WORK."""
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if backend == "nccl" else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            res = train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        nccl_ms = None
        if backend == "nccl":
            nccl_ms = sum(max(getattr(e, "self_device_time_total", 0), 0)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()) / 1e3
        state = res["state"]
        mesh = state.mesh
        stats = dict(run=run, rank=rank, coords=mesh.coords, backend=dist.get_backend(),
                     staged=mesh.staged, device=torch.cuda.current_device(), train_s=wall,
                     records=res["records"], peak_bytes=torch.cuda.max_memory_allocated(),
                     launches={k: fn.launches for k, fn in kernels.items()},
                     comm=mesh.comm_stats(), nccl_device_ms=nccl_ms)
        trained = getattr(state, "trainable", None) or ts.flatten(state.params)
        p3 = {p: x.float().cpu() for p, x in M.gather_tree(
            {p: x.detach() for p, x in trained.items()}, state.layouts, mesh).items()}
        if rank == 0:
            torch.save(p3, os.path.join(work, f"{run}_p3.pt"))
        with open(os.path.join(work, f"{run}_rank{rank}.json"), "w") as f:
            json.dump(stats, f)
        del res, state, mesh, p3, trained
        torch.cuda.empty_cache()
        multihost.sync_hosts()

    for run, shape, batch, gated, _ in MESH_RUNS:
        with gates_set(gated):
            cfg = mesh_cfg(batch, shape)
            one_run(run, lambda: trainer.train(cfg, make_synthetic=True, device=dev))
    one_run(BASE_TP_RUN, lambda: trainer.train_base(base_mesh_cfg(BASE_TP_SHAPE), device=dev))
    # the ring-off run: sp = 2 on a sequence that does not divide
    cfg = mesh_cfg(6, dict((r[0], r[1]) for r in MESH_RUNS)["mesh_sp2"],
                   text_len=RING_OFF_TEXT_LEN)
    try:
        trainer.train(cfg, make_synthetic=True, device=dev)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    with open(os.path.join(work, f"ring_off_rank{rank}.json"), "w") as f:
        json.dump({"raised": raised}, f)
    torch.cuda.empty_cache()
    multihost.sync_hosts()
    multihost.shutdown()
    return 0


def spawn_mesh_ranks(work, world=2):
    """Start `world` ranks (`chip_smoke.py --mesh-rank`), join them within
    MESH_TIMEOUT, kill their process groups on the way out; returns (ok,
    the ranks' logs' tails)."""
    import signal
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   SIMLINGO_MESH_WORK=work)
        path = os.path.join(ROOT, "chiprun_out", f"chip_smoke_mesh_rank{r}.log")
        logs.append(path)
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--mesh-rank"],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True))
    deadline = time.monotonic() + MESH_TIMEOUT
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    tails = []
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            tails.append(f"--- mesh rank {r}: exit {p.returncode} ---\n" + f.read()[-4000:])
    ok = not timed_out and all(p.returncode == 0 for p in procs)
    if timed_out:
        log(f"[mesh] FAIL: the ranks outlasted {MESH_TIMEOUT} s and were killed")
    return ok, tails


def nccl_world_one(torch, dev):
    """multihost.initialize at world 1 over NCCL (explicit coordinator) and
    one all-reduce: the NCCL path runs on any machine."""
    import socket
    import torch.distributed as dist
    from simlingo_tpu_torch.parallel import multihost
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    started = multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    backend = dist.get_backend()
    x = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    ok = started and backend == "nccl" and x.tolist() == [0.0, 1.0, 2.0, 3.0]
    multihost.shutdown()
    log(f"[mesh] world-1 init over {backend}: all-reduce {x.tolist()} in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (init included) {'OK' if ok else 'FAIL'}")
    return ok


def _differences(recs, p3, ref_recs, ref_p3, p0, keys=("loss", "grad_norm")):
    """Step 1's differences in `keys` (the loss and the grad norm; the base
    model's two group norms) and, after the last step, ||p3 - ref|| /
    ||ref - p0|| over the trained leaves ("update")."""
    return dict({k: abs(recs[0][k] - ref_recs[0][k]) for k in keys},
                update=_update_err(p3, ref_p3, p0))


def _hold_run(run, shape, batch, gated, control, ranks, p3, ctl, plain, p0, base, per_rank,
              keys, gpus):
    """A mesh run's ranks held to its control `ctl` (records, leaves): its
    differences within MESH_MULT x the control's own difference from the
    one-process run `plain` (`base`), every rank the same metrics, and
    each rank's launches a step exactly `per_rank`'s. Logs it all; returns
    (ok, the run's statistics)."""
    world = len(ranks)
    recs = ranks[0]["records"]
    got = _differences(recs, p3, *ctl, p0, keys)
    to_plain = _differences(recs, p3, *plain, p0, keys)
    tol = {k: MESH_MULT * base[k] for k in got}
    within = {k: got[k] <= tol[k] for k in got}
    same = all([tuple(x[k] for k in keys) for x in r["records"]]
               == [tuple(x[k] for k in keys) for x in recs] for r in ranks)
    exact = {k: all(r["launches"][k] == want[k] * MESH_STEPS
                    for r, want in zip(ranks, per_rank)) for k in per_rank[0]}
    ok = all(within.values()) and same and all(exact.values())
    ms = [r["ms"] for r in recs[1:]]
    mean_ms = sum(ms) / len(ms)
    comm = {r["rank"]: {g: dict(calls=c["calls"] / MESH_STEPS, mbytes=c["bytes"] / MESH_STEPS / 1e6,
                                ms=c["ms"] / MESH_STEPS)
                        for g, c in r["comm"].items() if c["calls"]}
            for r in ranks}
    nccl_ms = {r["rank"]: r["nccl_device_ms"] / MESH_STEPS for r in ranks
               if r["nccl_device_ms"] is not None}
    log(f"[{run}] mesh dp x fsdp x tp x sp x pp = {shape} on {world} ranks "
        f"({'one GPU each' if gpus >= world else 'sharing GPU 0'}), backend "
        f"{ranks[0]['backend']}{', collectives staged through host memory' if ranks[0]['staged'] else ''}; "
        f"batch {batch} a data rank, gated={gated}; the trainer "
        f"{ranks[0]['train_s']:.1f} s (init and {MESH_STEPS} steps)")
    log(f"[{run}] " + " ".join(f"{k} {[r[k] for r in recs]}" for k in keys)
        + f"; every rank the same metrics: {same}")
    for k in got:
        log(f"[{run}] {k}: |mesh - control {control}| {got[k]:.3e} vs tolerance "
            f"{tol[k]:.3e} ({MESH_MULT} x the control's difference from the one-process run "
            f"{base[k]:.3e}) {'OK' if within[k] else 'FAIL'}; |mesh - the one-process run| "
            f"{to_plain[k]:.3e}")
    log(f"[{run}] ms/step (mean of steps 2-{MESH_STEPS}) {mean_ms:.2f}"
        f"{' (ranks share one GPU: not a scaling figure)' if gpus < world else ''}; "
        f"peak GiB per rank {[round(r['peak_bytes'] / 2 ** 30, 2) for r in ranks]}")
    for r, c in comm.items():
        if r in nccl_ms:
            log(f"[{run}] rank {r} collectives a step: " + ", ".join(
                f"{g} {v['calls']:.0f} calls {v['mbytes']:.1f} MB" for g, v in c.items())
                + f"; NCCL kernels {nccl_ms[r]:.2f} device ms a step (torch.profiler, "
                f"the {MESH_STEPS} steps profiled)")
        else:
            log(f"[{run}] rank {r} collectives a step (staged: host ms, device "
                f"synchronised around each): " + ", ".join(
                    f"{g} {v['calls']:.0f} calls {v['mbytes']:.1f} MB {v['ms']:.1f} ms"
                    for g, v in c.items()))
    for r in ranks:
        log(f"[{run}] rank {r['rank']} hand-kernel launches over {MESH_STEPS} steps: "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    log(f"[{run}] launches a step a rank against the reckoning {per_rank}: "
        f"{'OK' if all(exact.values()) else 'FAIL ' + str(exact)}")
    return ok, dict(shape=shape, batch=batch, gated=gated, control=control, ranks=ranks,
                    differences=got, tolerance=tol, launches_per_step_expected=per_rank,
                    differences_from_trainer=to_plain, nccl_device_ms_per_step=nccl_ms,
                    within=within, mean_step_ms=mean_ms, comm_per_step=comm,
                    launches={k: sum(r["launches"][k] for r in ranks)
                              for k in ranks[0]["launches"]})


def _log_control(run, control, recs, b, keys, what="the trainer"):
    log(f"[{run}] control {control}: " + " ".join(f"{k} {[r[k] for r in recs]}" for k in keys)
        + f"; its difference from {what}: step-1 "
        + ", ".join(f"{k} {b[k]:.3e}" for k in keys)
        + f", leaves after step {MESH_STEPS} {b['update']:.3e} of the update")


def mesh_training(torch, dev):
    """The phase `mesh_training`: the world-1 NCCL init; the one-process
    runs (the trainer ungated and gated, the `halves`, `tp` and
    `seq_halves` controls; SimLingo-Base's trainer and its `tp` control);
    then each MESH_RUNS run and `base_tp2` on 2 ranks (one a GPU over NCCL
    where there are 2 GPUs, else both on this one over gloo, each
    collective staged through host memory), held to its control: step 1's
    loss and grad norm (the base model's: both group norms), and the
    trained leaves after step MESH_STEPS (||run - control|| / ||control -
    init||), each within MESH_MULT x the control's own difference from the
    one-process run (`_differences`); every rank's attention, dropout
    (and, gated, norm and CE) launches held exactly to
    `mesh_launches_per_step` (`base_tp2`: `base_launches`). The 2 ranks
    run every run in turn in one spawn. Returns (ok, stats)."""
    import shutil
    import tempfile
    ok = nccl_world_one(torch, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, ref_p3, p0 = mesh_reference(torch, dev, want_p0=True)
    gref, gref_p3, _ = mesh_reference(torch, dev, gated=True)
    plain = {False: (ref, ref_p3), True: (gref, gref_p3)}
    controls, base = {}, {}
    for control, gated in (("halves", False), ("tp", True), ("seq_halves", False)):
        recs, p3, _ = mesh_reference(torch, dev, gated=gated, control=control)
        controls[control] = (recs, p3, gated)
        base[control] = _differences(recs, p3, *plain[gated], p0)
    t1 = time.perf_counter()
    bref, bref_p3, bp0 = base_mesh_reference(torch, dev, want_p0=True)
    bctl, bctl_p3, _ = base_mesh_reference(torch, dev, control=True)
    bbase = _differences(bctl, bctl_p3, bref, bref_p3, bp0, BASE_KEYS)
    log(f"[mesh] one-process runs (global batch 6, {MESH_STEPS} steps) in "
        f"{t1 - t0:.1f} s: the trainer: loss {[r['loss'] for r in ref]} "
        f"grad_norm {[r['grad_norm'] for r in ref]}; gated: loss {[r['loss'] for r in gref]} "
        f"grad_norm {[r['grad_norm'] for r in gref]}")
    for control, (recs, _, gated) in controls.items():
        _log_control("mesh", control + (" (gated)" if gated else ""), recs, base[control],
                     ("loss", "grad_norm"), "the trainer" + (" (gated)" if gated else ""))
    log(f"[{BASE_TP_RUN}] one-process `base` runs (global batch 16, {MESH_STEPS} steps) in "
        f"{time.perf_counter() - t1:.1f} s: train_base: " + " ".join(
            f"{k} {[r[k] for r in bref]}" for k in BASE_KEYS))
    _log_control(BASE_TP_RUN, BASE_TP_CONTROL, bctl, bbase, BASE_KEYS, "train_base")
    world = 2
    gpus = torch.cuda.device_count()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh_training_", dir=os.path.join(ROOT, "build"))
    stats = {"references": dict(loss=[r["loss"] for r in ref],
                                grad_norm=[r["grad_norm"] for r in ref],
                                gated_loss=[r["loss"] for r in gref],
                                gated_grad_norm=[r["grad_norm"] for r in gref],
                                **{f"{c}_loss": [r["loss"] for r in v[0]]
                                   for c, v in controls.items()},
                                **{f"{c}_grad_norm": [r["grad_norm"] for r in v[0]]
                                   for c, v in controls.items()},
                                control_difference=base,
                                base={k: [r[k] for r in bref] for k in BASE_KEYS},
                                base_tp={k: [r[k] for r in bctl] for k in BASE_KEYS},
                                base_control_difference=bbase),
             "runs": {}}

    def load_ranks(run):
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"{run}_rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks, torch.load(os.path.join(work, f"{run}_p3.pt"), weights_only=True)

    try:
        t1 = time.perf_counter()
        good, tails = spawn_mesh_ranks(work, world)
        stats["ranks_wall_s"] = time.perf_counter() - t1
        if not good:
            for t in tails:
                log(t)
            log("[mesh] FAIL: a rank failed")
            return False, stats
        log(f"[mesh] {world} ranks ran the {len(MESH_RUNS)} runs and {BASE_TP_RUN} in "
            f"{stats['ranks_wall_s']:.1f} s (spawn to exit; logs "
            f"chiprun_out/chip_smoke_mesh_rank*.log)")
        for run, shape, batch, gated, control in MESH_RUNS:
            ranks, p3 = load_ranks(run)
            per_rank = []
            for r in ranks:
                want = mesh_launches_per_step(mesh_cfg(batch).model, shape, r["coords"], batch)
                per_rank.append(dict(want, **GATED_PER_STEP) if gated else want)
            good, stats["runs"][run] = _hold_run(
                run, shape, batch, gated, control, ranks, p3, controls[control][:2],
                plain[gated], p0, base[control], per_rank, ("loss", "grad_norm"), gpus)
            ok &= good
            if not good:
                return False, stats
        ranks, p3 = load_ranks(BASE_TP_RUN)
        want = {k: n for k, n in base_launches(base_mesh_cfg().model, gated=True).items()
                if k in ATTN_KERNELS}
        good, stats["runs"][BASE_TP_RUN] = _hold_run(
            BASE_TP_RUN, BASE_TP_SHAPE, 16, False, BASE_TP_CONTROL, ranks, p3,
            (bctl, bctl_p3), (bref, bref_p3), bp0, bbase, [want] * world, BASE_KEYS, gpus)
        ok &= good
        if not good:
            return False, stats
        raised = []
        for r in range(world):
            with open(os.path.join(work, f"ring_off_rank{r}.json")) as f:
                raised.append(json.load(f)["raised"])
        good = all(m is not None and "ring-routed" in m for m in raised)
        ok &= good
        stats["ring_off"] = dict(text_len=RING_OFF_TEXT_LEN, raised=raised)
        log(f"[mesh_sp2] ring-off run (a sequence of {RING_OFF_TEXT_LEN} + 30, odd): the "
            f"trainer raised on every rank: {good} ({raised[0]!r}) {'OK' if good else 'FAIL'}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ok, stats


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_CHECKS = {"flash_attn_fwd": run_attention_checks, "int8_matmul": run_int8_checks,
                 "int4_matmul": run_int4_checks, "int8_matmul_dx": run_int8_dx_checks,
                 "flash_attn_bwd": run_attention_bwd_checks, "dropout": run_dropout_checks,
                 "norms": run_norm_checks, "fused_ce": run_ce_checks,
                 "fp32": run_fp32_checks}
# parts of "fp32", run only where `--kernels` names them
PART_CHECKS = {"fp32_ce": run_fp32_ce_checks,
               "fp32_int8": lambda torch, dev, results: run_fp32_int8_checks(
                   torch, dev, results, serving=True)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="*", choices=sorted({*KERNEL_CHECKS, *PART_CHECKS}),
                    metavar="NAME",
                    help="build and check the kernels only (those named, else all: "
                         + ", ".join(sorted(KERNEL_CHECKS)) + "; or parts of fp32: "
                         + ", ".join(sorted(PART_CHECKS)) + ")")
    ap.add_argument("--int8-sweep", action="store_true",
                    help="build, then time the int8 forward at every reduction split "
                         "and the GEMV at forced plans")
    ap.add_argument("--ce-sweep", action="store_true",
                    help="build, then time the fused CE backward at forced segment counts")
    ap.add_argument("--attn-sweep", action="store_true",
                    help="build, then time the attention forward at forced plans")
    ap.add_argument("--norm-sweep", action="store_true",
                    help="build, then time the norm kernels at forced plans")
    ap.add_argument("--base", nargs="*", choices=sorted(BASE_CELLS), metavar="CELL",
                    help="build, then the small SimLingo-Base agreement and the phases of "
                         "the named base cells (all if none is named: "
                         + ", ".join(BASE_CELLS) + ")")
    ap.add_argument("--disk", action="store_true",
                    help="build, then run the disk-training phase (7) and, in its "
                         "workspace, the plugin (8), the evaluation (9), the "
                         "microsim (10) and the expert collection (10b) only")
    ap.add_argument("--fp32", action="store_true",
                    help="build, then the fp32 builds' phase-2 cases (with serving's int8 "
                         "rows), the small fp32 training agreements, phase 5's ungated run "
                         "and the fp32 cells beside it (" + ", ".join(
                             ("train_fp32", *FP32_CELLS)) + "), then serve_fp32 only")
    ap.add_argument("--lora-fused", action="store_true",
                    help="build, then phase 5's ungated training run and `train_lora_fused` "
                         "(SIMLINGO_LORA_FUSED=1) beside it only")
    ap.add_argument("--mesh", action="store_true",
                    help="build, then run the multi-GPU training phase (mesh_training) only")
    ap.add_argument("--microsim", action="store_true",
                    help="build, then run the closed-loop microsim phase (10) only, on a "
                         "random trained-SimLingo checkpoint")
    ap.add_argument("--collect", action="store_true",
                    help="build, then run the expert-collection phase (10b) only, on a "
                         "random trained-SimLingo checkpoint")
    ap.add_argument("--mesh-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parent", metavar="DIR",
                    help="also hold the bits of the checked kernels' MUST_EQUAL cases "
                         "(the fused CE forward, the tiled attention forward, every bf16 "
                         "int8 forward case, ...) equal to those of the source tree at "
                         "DIR (e.g. a git archive of the parent commit), and time both "
                         "trees on phase 2's inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if args.mesh_rank:              # one rank of mesh_training, which built the kernels
        return mesh_rank()
    from simlingo_tpu_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    clock = phase_clock()
    _build.build_all(verbose=True)
    log(f"[build] {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    clock("phase 1 (build)")
    if args.int8_sweep:
        return int8_sweep(torch, dev)
    if args.ce_sweep:
        return ce_sweep(torch, dev)
    if args.attn_sweep:
        return attn_sweep(torch, dev)
    if args.norm_sweep:
        return norm_sweep(torch, dev)
    if args.base is not None:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        ok = small_base_agreement(torch, dev)
        if ok:
            ok, _, _ = run_base_phases(torch, dev, smi_line(), tuple(args.base or BASE_CELLS))
        log(f"[base] phases 3 (SimLingo-Base) and 6 {'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1
    if args.fp32:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        cases = []
        run_fp32_checks(torch, dev, cases, serving=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cases_fp32.json"), "w") as f:
            json.dump(cases, f, indent=1)
        bad = [c["case"] for c in cases if not c["ok"]]
        if bad:
            log(f"[kernel] FAILED: {bad}")
        clock("phase 2 at fp32")
        ok = not bad and fp32_small_agreements(torch, dev)
        clock("phase 3 at fp32")
        runs = {}
        if ok:
            ok, plain = full_width_training(torch, dev)
        if ok:
            ok, runs = fp32_training(torch, dev, plain, tuple(FP32_CELLS))
            clock("phase 5 at fp32")
        if ok:
            ok, runs["serve_fp32"] = serve_fp32(torch, dev)
            clock("serve_fp32")
        for name, st in runs.items():
            with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
                json.dump(dict(st, nvidia_smi=smi_line()), f, indent=1)
        log(f"[fp32] phase 2 at fp32, the small fp32 steps, "
            f"{', '.join(('train_fp32', *FP32_CELLS))} and serve_fp32 "
            f"{'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1
    if args.lora_fused:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        ok, plain = full_width_training(torch, dev)
        if ok:
            torch.cuda.empty_cache()
            ok, fused = full_width_training(torch, dev, lora_fused=True)
        if ok:
            compare_lora_fused(plain, fused)
            with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_train_lora_fused.json"),
                      "w") as f:
                json.dump(dict(fused, nvidia_smi=smi_line()), f, indent=1)
        log(f"[lora_fused] phase 5's train and train_lora_fused {'OK' if ok else 'FAILED'} on "
            f"{smi_line()}")
        return 0 if ok else 1
    if args.mesh:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        ok, st = mesh_training(torch, dev)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_mesh_training.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi_line()), f, indent=1)
        log(f"[mesh] phase mesh_training {'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1
    if args.microsim:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        ok, st = microsim_only(torch, dev)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_microsim.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi_line()), f, indent=1)
        log(f"[microsim] phase 10 {'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1
    if args.collect:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        ok, st = microsim_only(torch, dev, collect)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_collect.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi_line()), f, indent=1)
        log(f"[collect] phase 10b {'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1
    if args.disk:
        ok, st, after = disk_and_eval_phases(torch, dev)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        for name, stats in (("train_disk", st), *after.items()):
            with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
                json.dump(dict(stats, nvidia_smi=smi_line()), f, indent=1)
        log(f"[train_disk] phases 7-10b {'OK' if ok else 'FAILED'} on {smi_line()}")
        return 0 if ok else 1

    # 2. kernels
    cases = []
    for name, check in {**KERNEL_CHECKS, **PART_CHECKS}.items():
        if (not args.kernels and name in KERNEL_CHECKS) or name in (args.kernels or ()):
            check(torch, dev, cases)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cases.json"), "w") as f:
        json.dump(cases, f, indent=1)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        log(f"[kernel] FAILED: {[(c['kernel'], c['case'], c['shape']) for c in bad]}")
        return 1
    if args.parent:
        checked = set(args.kernels or KERNEL_CHECKS)
        for check, kernel in (("dropout", "dropout"),
                              ("fused_ce", "fused_ce_fwd"), ("flash_attn_fwd", "flash_attn_fwd"),
                              ("flash_attn_bwd", "flash_attn_bwd"),
                              ("int8_matmul", "int8_fwd"), ("norms", "norms")):
            if check in checked and not compare_fwd(args.parent, kernel):
                return 1
    if args.kernels is not None:
        log(f"[kernel] all cases within tolerance on {smi_line()}")
        return 0

    clock("phase 2 (kernels)")
    return run_path_phases(torch, dev, cases, clock)


if __name__ == "__main__":
    sys.exit(main())
