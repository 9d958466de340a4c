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
    python3 chip_smoke.py --parent DIR  # ... and the CE forward's, the tiled
                                        # attention forward's and the norm
                                        # forward's bits against the tree at
                                        # DIR, with both trees' times of those,
                                        # of the norm backward and of the
                                        # int8 GEMV (scripts/fwd_digest.py)

Phases, in order; any failure exits non-zero:
  1. build: compile csrc/*.cu with nvcc (all in parallel), print seconds;
  2. kernels: every hand-written kernel at every shape the serving and the
     training paths give it, against its plain PyTorch version on the same
     bf16 inputs (fp32 math) at |err| <= ATOL + RTOL |ref| (the attention
     forward also with its lse, bit-identical across two calls, its path
     -- tiled or split, the splits -- its kernel's ptxas registers and
     sha256 digests of out and lse; the attention
     backward: within the bf16 rounding bound of each gradient element,
     see BF16_U, and so pass by pass -- its dS^T scratch against
     attention_ds_reference, its dq against attention_dq_from_ds_reference
     of that scratch -- bit-identical across two calls, with the device ms
     of its three kernels, their ptxas registers, the dK/dV instantiation
     and the scratch bytes; dropout: bit-equal, keep rate 0.9 +- 0.002, identity at
     p = 0; LayerNorm / RMSNorm forward and backward at the ViT, projector
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
     operations on this card;
  3. small-model agreement: a small D=128 model's drive_only waypoints on
     the GPU (bf16, kernels) against the CPU plain path (fp32), and one
     training step of the same model with LoRA r=4, dropout 0.1 (losses to
     2e-2, grad norm to 5e-2 relative), then that step again with both
     fused-kernel gates on (SIMLINGO_CE_IMPL=pallas, SIMLINGO_LN_IMPL=pallas),
     and again on an int8 base LLM (which must launch int8_matmul_dx);
  4. full width, serving: the default LingoAgent (CoT, int8 LLM,
     speculative) on SimLingoConfig() with seeded random bf16 weights,
     FRAMES frames on a seeded 1024x512 frame, then one use_cot=False
     frame; launch counts of every kernel are reset just before and read
     just after; then the same frames again with SIMLINGO_LN_IMPL=pallas
     (`gated_serving`: frame ms beside the ungated frames', the norm
     kernels' launches a frame, tokens equal and waypoints within 2 % of
     the ungated frames', a profile of one gated speculative frame); with
     a profile of one speculative frame (device time by
     kernel class and by hand kernel; int8_matmul's calls in that frame
     against its forward kernels' launches, one each), and the plain
     generator profiled at 1 and GEN_PROFILE_TOKENS new tokens (device
     busy, gemv_kernel's ms and launches a decoded token);
  5. full width, training: train_torch's trainer on
     presets.internvl2_1b(lora=True) (seed 0) and synthetic_example(batch 6,
     seq_len 768, 2 tiles): 1 warm-up step, then TRAIN_STEPS timed steps
     with the launch counts reset after the warm-up; peak memory, and a
     profile of one more step (device time by kernel class); then the
     same run with both gates set in the process environment (restored
     afterwards), which must launch the six norm and CE kernels (their
     counts are logged against GATED_PER_STEP), and the two runs side by
     side (losses to 2e-2 relative); then the ungated run again with the
     base LLM quantized to int8 (`bench.py` BENCH_INT8_BASE=1), which must
     launch int8_matmul and int8_matmul_dx (counts logged against
     INT8_PER_STEP), its losses beside the bf16 base's (information only);
  6. the {"kernels": [...]} line (eleven kernels, launches per path: serve,
     serve_gated, train, train_gated, train_int8), the nvidia-smi line, and the last
     line {"ok": true, "device": {...}}.
Per-case results also go to chiprun_out/chip_smoke_cases.json, the paths'
statistics to chip_smoke_agent.json, chip_smoke_train.json,
chip_smoke_train_gated.json and chip_smoke_train_int8.json.
"""

from __future__ import annotations

import argparse
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
# (the sum of |terms| comes from attention_bwd_reference(abs_terms=True)).
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
    `nvcc -Xptxas -v` log that phase 1 wrote beside the library."""
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
                t = re.search(rf"{len(k)}{k}(?:ILi(\d+)E)?", name)
                if t:
                    short = k + (f"<{t.group(1)}>" if t.group(1) else "")
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


def attention_inputs(torch, dev):
    """For each phase-2 attention case (`attention_cases`, then the two
    training shapes): the case, its first inputs (q, k, v, kv_valid) and
    the timing sets, all drawn from one generator seeded 0. kv_valid is
    bool, so a timed call includes the wrapper's conversion to uint8, as
    it has since PR 6. `scripts/fwd_digest.py` takes its inputs from here."""
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 64
    cases = attention_cases() + [
        ("llm_train", 6, 798, 798, 14, 2, True, None, "train", False),
        ("vit_train", 12, 1025, 1025, 16, 16, False, None, None, True)]
    train_valid = train_llm_valid(torch, dev)
    for case in cases:
        B, T, S, HQ, HK, _, _, ranges, strided = case[1:]

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
    return 2 * (B * T * HQ * 64 * 2 + 2 * B * S * HK * 64) + (B * S if ranges else 0)


def attention_call(FA, case):
    """The timed call of a phase-2 attention case."""
    causal, q_off = case[6], case[7]
    return lambda q_, k_, v_, m_: FA.flash_attn_fwd(q_, k_, v_, m_, causal, None, q_off)


def run_attention_checks(torch, dev, results):
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    from simlingo_tpu_torch.kernels import _build
    D = 64
    regs_all = ptxas_usage("flash_attn_fwd")
    for case, (q, k, v, valid), sets in attention_inputs(torch, dev):
        name, B, T, S, HQ, HK, causal, q_off, _, _ = case
        out, lse = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off,
                                     return_lse=True)
        again = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        off = S - T if q_off is None else q_off
        plan = FA._fwd_plan(B, T, S, HQ, HK, causal, off, sms=_build.sm_count(dev.index or 0))
        kname = "flash_fwd_split_kernel" if plan.path == "split" else "flash_fwd_kernel"
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
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{S},{HK},{D}]",
                   causal=causal, q_offset=q_off, empty_rows=empty_rows,
                   max_abs_err=err, err_over_rms=rel, lse_err=lse_err, ok=ok,
                   bit_identical=same, path=plan.path,
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


def int8_cases():
    """(case, K, N, M, scale dtype) of phase 2's int8 forward: every serving
    row (decode 1, verify 16, queries 30, prefill 640) and the int8-base
    training rows (6 x 798 for the linears, one 32-position CE chunk x 6
    for the tied head) with an fp32 scale; the decode row, the training
    rows and the head again with a bf16 scale."""
    import torch
    lin, head = INT8_SHAPES[:4], INT8_SHAPES[4]
    cases = [(n, K, N, M, torch.float32) for (n, K, N) in lin for M in (1, 16, 30, 640, 4788)]
    cases += [(*head, M, torch.float32) for M in (1, 16, 192)]
    cases += [(n, K, N, M, torch.bfloat16) for (n, K, N) in lin for M in (1, 4788)]
    cases += [(*head, M, torch.bfloat16) for M in (1, 16, 192)]
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
                         registers=regs.get(f"gemv_kernel<{plan.rows}>", (0, 0))[0])
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


def int8_dx_cases():
    """(case, M, N, K) of int8_matmul_dx on the int8-base training path:
    g [M, N] through w_q [N, K]; the linears at 6 x 798 rows, the tied head
    per 32-position CE chunk (6 x 32 rows)."""
    return [("qo", 4788, 896, 896), ("kv", 4788, 128, 896), ("gate_up", 4788, 4864, 896),
            ("down", 4788, 896, 4864), ("head", 192, 151674, 896)]


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


def run_attention_bwd_checks(torch, dev, results):
    """flash_attn_bwd at the two training shapes, against
    attention_bwd_reference on the same bf16 inputs (and the kernel
    forward's o and lse), and pass by pass against attention_ds_reference
    and attention_dq_from_ds_reference; bit-identical across two calls;
    device ms of its three kernels and their ptxas registers; library:
    autograd through SDPA's backward."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(3)
    D = 64
    train_valid = train_llm_valid(torch, dev)
    regs = {k: v for k, v in ptxas_usage("flash_attn_bwd").items()
            if k.split("<")[0] in BWD_KERNELS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, B, T, HQ, HK, causal, strided in (
            ("llm_train", 6, 798, 14, 2, True, False),
            ("vit_train", 12, 1025, 16, 16, False, True)):
        valid = train_valid if causal else None

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

        q, k, v, out, dout, lse = make()
        *got, ds = FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, return_ds=True)
        same = all(torch.equal(a, b) for a, b in zip(       # no atomics: bit-identical
            FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal), got))
        torch.cuda.synchronize()
        args = (q.float(), k.float(), v.float(), valid, out.float(), dout.float(),
                lse, causal)
        ref = FA.attention_bwd_reference(*args)
        mag = FA.attention_bwd_reference(*args, abs_terms=True)
        ok, err, rel, ratio = same, 0.0, 0.0, 0.0
        for a, b, m in zip(got, ref, mag):
            diff = (a.float() - b).abs()
            rms = float(b.square().mean().sqrt())
            tol = BF16_U * (m + b.abs()) + 1e-5 * rms
            ok &= bool((diff <= tol).all())
            err, rel = max(err, float(diff.max())), max(rel, float(diff.max()) / rms)
            ratio = max(ratio, float((diff / tol).max()))
        del mag, ref
        # the scratch path, pass by pass: the kernel's dS^T on the pairs it
        # writes against the plain first pass, and its dq against the plain
        # second pass over the kernel's own scratch (same bound)
        plan = FA._bwd_plan(B, T, T, HQ, HK, causal, 0)
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
        qsz, ksz = B * T * HQ * D, B * T * HK * D
        nbytes = 2 * (3 * qsz + 2 * ksz) + 2 * (qsz + 2 * ksz) + 4 * B * HQ * T + (
            B * T if valid is not None else 0)
        bms, bby = bound(nbytes, flops)
        sets = [make() for _ in range(n_sets(nbytes))]

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
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{T},{HK},{D}]", causal=causal,
                   empty_rows=empty_rows, max_abs_err=err, err_over_rms=rel,
                   err_over_tol=ratio, bit_identical=same, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=bby, split_ms=split, ptxas=regs,
                   ds_bytes=plan.ds_bytes, ds_floor_ms=2 * plan.ds_bytes / PEAK_BYTES * 1e3,
                   pairs_per_head=[len(plan.written), plan.n_qt * plan.n_kt],
                   ds_pass_err_over_tol=pass_ratio[0], dq_pass_err_over_tol=pass_ratio[1],
                   dkdv_blocks=plan.n_kt * HK * B, dq_blocks=plan.n_qt * HQ * B,
                   dkdv_kernel=f"bwd_dkdv_kernel<{FA._dkdv_blocks(B, T, HK, sms)}>",
                   digest=digest)
        results.append(row)
        log(f"[kernel] flash_attn_bwd {name:12s} {row['shape']:32s} err={err:.3e} "
            f"err/rms={rel:.3e} err/tol={ratio:.3f} (tol 2^-8 (sum|terms| + |ref|)) "
            f"bit-identical={same} "
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


def run_dropout_checks(torch, dev, results):
    """dropout at the LoRA inputs of the training path: bit-equal to
    dropout_plain, keep rate 0.9 +- 0.002, identity at p = 0; library:
    F.dropout."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import dropout as DO
    gen = torch.Generator(device=dev).manual_seed(4)
    seed, rate = 0x243F6A8885A308D3, 0.1
    for name, C in (("lora_x_896", 896), ("lora_h_4864", 4864)):
        shape = (6, 798, C)

        def make():
            return (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),)
        (x,) = make()
        out = DO.dropout(x, seed, rate)
        torch.cuda.synchronize()
        ref = DO.dropout_plain(x, seed, rate)
        keep = DO.dropout(torch.ones_like(x), seed, rate) != 0
        keep_ref = DO.keep_mask(x.numel(), seed, rate, dev).view(shape)
        rate_kept = float(keep.float().mean())
        identity = torch.equal(DO.dropout(x, seed, 0.0), x)
        ok = (torch.equal(out, ref) and torch.equal(keep, keep_ref) and identity
              and abs(rate_kept - (1 - rate)) <= 0.002)
        err = float((out.float() - ref.float()).abs().max())
        nbytes = 2 * 2 * x.numel()
        bms, bby = bound(nbytes, 0)
        sets = [make() for _ in range(n_sets(nbytes))]
        kernel_ms = time_ms(torch, lambda x_: DO.dropout(x_, seed, rate), sets)
        plain_ms = time_ms(torch, lambda x_: DO.dropout_plain(x_, seed, rate), sets[:2],
                           iters=2)
        library_ms = time_ms(torch, lambda x_: F.dropout(x_, rate, training=True), sets)
        row = dict(kernel="dropout", case=name, shape=f"[6,798,{C}] bf16 p={rate}",
                   max_abs_err=err, err_over_rms=0.0, bit_equal=torch.equal(out, ref),
                   keep_rate=rate_kept, identity_at_0=identity, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] dropout        {name:12s} {row['shape']:24s} bit_equal="
            f"{row['bit_equal']} keep_rate={rate_kept:.5f} identity_at_0={identity} "
            f"{'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (F.dropout) bound_ms={bms:.4f} ({bby})")


def _ratio(got, ref, tol):
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff / tol).max())


# the norm kernels of csrc/layernorm.cu, as the profiler names them
NORM_KERNELS = ("norm_fwd_kernel", "norm_bwd_kernel", "norm_colsum_kernel")


def norm_cases():
    """(kernel family, case, rows, d, eps, directions): the ViT's 48
    LayerNorms and the projector's and the LLM's 49 RMSNorms in training
    (the LLM's also as the gated step runs them: a frozen scale, dx only),
    and the serving rows: the ViT's 2 tiles x 1025 and the projector's
    2 x 256, the LLM's decode 1, verify 16, queries 30 and prefill 640."""
    both, fwd, dx_only = ("fwd", "bwd"), ("fwd",), ("bwd_dx",)
    return [("layernorm", "vit", 12 * 1025, 1024, 1e-6, both),
            ("layernorm", "projector", 12 * 256, 4096, 1e-5, both),
            ("rmsnorm", "llm_train", 6 * 798, 896, 1e-6, both),
            ("rmsnorm", "llm_train_frozen", 6 * 798, 896, 1e-6, dx_only),
            ("rmsnorm", "serve_decode", 1, 896, 1e-6, both),
            ("rmsnorm", "serve_prefill", 640, 896, 1e-6, both),
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
                    x_.data_ptr(), w_.data_ptr(), s_.data_ptr(), y.data_ptr(), N, K, 0, *plan,
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
    built library, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    ops, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = None
            t = re.search(rf"{len(kernel)}{kernel}I(?:Li(\d+)E)?(\w)", m.group(1))
            if t:
                rows = f"{t.group(1)}," if t.group(1) else ""
                name = f"{kernel}<{rows}{'float' if t.group(2) == 'f' else 'bf16'}>"
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
                dl.data_ptr(), part.data_ptr(), dh.data_ptr(), None, N, H, V, S, per,
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
    kernel of the tree whose `simlingo_tpu_torch` is imported, on phase
    2's inputs and timed calls: "flash_attn_fwd" at every attention case,
    "fused_ce_fwd" at the training shape, "int8_fwd" at the M = 1 cases
    (the GEMV) with both scale dtypes, 200 calls a replay; "norms" at
    every norm case, "<case>_fwd" and "<case>_bwd" apart (200 calls a
    replay below 1 MB of operands)."""
    digests, ms = {}, {}
    warm_up(torch, dev)
    if kernel == "int8_fwd":
        from simlingo_tpu_torch.kernels import quantized_matmul as QM
        for index, (name, K, N, M, sdt) in enumerate(int8_cases()):
            if M != 1:
                continue
            case = f"{name}_{str(sdt).replace('torch.', '')}"
            (x, w_q, scale), sets = int8_inputs(torch, dev, index)
            digests[case] = {"y": sha12(torch, QM.int8_matmul(x, w_q, scale))}
            # 200 calls a replay: these kernels are ~0.002-0.005 ms, and the
            # replay's own start costs a share of 20
            ms[case] = time_ms(torch, QM.int8_matmul, sets, iters=200)
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
        for case, (q, k, v, valid), sets in attention_inputs(torch, dev):
            out, lse = FA.flash_attn_fwd(q, k, v, valid, case[6], None, case[7],
                                         return_lse=True)
            digests[case[0]] = {"out": sha12(torch, out), "lse": sha12(torch, lse)}
            ms[case[0]] = time_ms(torch, attention_call(FA, case), sets)
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
# keeps each accumulator's order) and the attention forward's tiled path
# (its loop keeps each row's order); none of the GEMV's, whose order of
# the sum may change (its bits across calls are held in phase 2)
MUST_EQUAL = {"fused_ce_fwd": ("train",),
              "flash_attn_fwd": ("vit", "vit_train", "llm_prefill", "llm_train"),
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
    for case in mine[0]["ms"]:
        a = [r["ms"][case] for r in mine]
        b = [r["ms"][case] for r in theirs]
        same = mine[0]["digests"][case] == theirs[0]["digests"][case]
        must = case in MUST_EQUAL.get(kernel, ())
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
    """A small model with the kernels' head_dim 64: drive_only waypoints on
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


def full_width(torch, dev, gated_pass=False):
    """The default LingoAgent at SimLingoConfig() width; returns (ok, stats,
    the CoT agent, the frame). `gated_pass`: then the same agents again
    with the norm gate on (`gated_serving`), its statistics under
    stats["gated"]."""
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

    # the counted main path: CoT frames (plain, then speculative) + drive_only
    FA.flash_attn_fwd.launches = 0
    QM.int8_matmul.launches = 0
    results = [agent.run_step(frame) for _ in range(FRAMES)]
    results.append(drive_agent.run_step(frame))
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
    log(f"[full] launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            log(f"[full] FAIL: kernel {name} was not launched on the main path")
            ok = False
    cot_spec = [r["latency_s"] * 1e3 for r in results[1:-1]]

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
    stats = dict(frame_ms_cot_plain=results[0]["latency_s"] * 1e3,
                 frame_ms_cot_spec=cot_spec,
                 frame_ms_drive_only=results[-1]["latency_s"] * 1e3,
                 tokens_per_frame=[len(r.get("language_tokens", [])) for r in results[:-1]],
                 spec_stats=agent.spec_stats, decode_ms_per_token=decode_ms,
                 generate_profile=gen_profile, launches=launches, gated=gated)
    return ok, stats, agent, frame


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
                "dropout_kernel", "gemm_kernel", "gemm64_kernel", "gemv_kernel", "dx_kernel",
                "dx_reduce_kernel",
                "norm_fwd_kernel", "norm_bwd_kernel", "norm_colsum_kernel", "ce_fwd_tile_kernel",
                "ce_fwd_finalize_kernel", "ce_dlogits_kernel", "ce_dh_kernel",
                "ce_dh_reduce_kernel", "ce_dw_kernel")


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
    """Set the fused-kernel gates in the process environment -- both
    (on=True), those of a dict {name: value}, or none -- and restore the
    environment afterwards."""

    def __init__(self, on):
        self.env = GATES_ON if on is True else (on or {})

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in GATES_ON}
        for k in GATES_ON:
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


def small_training_agreement(torch, dev, gated=False, int8_base=False):
    """One train_step of a small D=128 model with LoRA r=4, dropout 0.1 on
    the GPU (bf16, kernels) and on the CPU (fp32, plain versions), from the
    same params, batch and seed: the dropout masks are the same on both
    sides (Philox of the flat index), so the losses and grad norm agree.
    `gated`: with both fused-kernel gates on, on both sides. `int8_base`:
    the base LLM quantized to int8 (core/quantize.quantize_llm) first."""
    import copy
    from simlingo_tpu_torch.core.quantize import quantize_llm
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    from simlingo_tpu_torch.train import train_step as ts
    cfg = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=256, image_size=448, patch_size=56,
                      projector_out=128, gelu_approximate=True),
        llm=Qwen2Config(vocab_size=2048, hidden_size=128, num_layers=2, num_heads=2,
                        num_kv_heads=1, head_dim=64, intermediate_size=256,
                        lora_r=4, lora_alpha=8, lora_dropout=0.1),
        img_context_token_id=2000)
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for ab in _leaves(params["lora"]):
        ab.add_(0.01)                        # nonzero B: every adapter in play
    if int8_base:
        params["llm"] = quantize_llm(params["llm"])
    opt = ts.OptimizerConfig(lr=1e-4, total_steps=10)
    metrics = {}
    fns = kernel_fns()
    watched = NEW_KERNELS + INT8_KERNELS
    tag = "gated " if gated else "int8-base " if int8_base else ""
    with gates_set(gated):
        for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
            state = ts.init_train_state(_to(copy.deepcopy(params), device), opt)
            batch = synthetic_example(cfg, batch=2, seq_len=96, num_patches=2, seed=1,
                                      device=device)
            step = ts.make_train_step(cfg, opt, compute_dtype=dtype)
            before = {k: fns[k].launches for k in watched}
            metrics[str(device)] = {k: float(v) for k, v in step(state, batch, 1234).items()}
    new = {k: fns[k].launches - before[k] for k in watched}
    ref, got = metrics["cpu"], metrics[str(dev)]
    ok = True
    for key, want in ref.items():
        tol = 5e-2 if key == "grad_norm" else 2e-2
        good = abs(got[key] - want) <= tol * abs(want)
        ok &= good
        log(f"[small] {tag}train_step {key:15s} GPU bf16 {got[key]:.6f} vs CPU fp32 "
            f"{want:.6f} (rel tol {tol}) {'OK' if good else 'FAIL'}")
    log(f"[small] {tag}train_step launches of the fused and int8 kernels on the GPU: {new}")
    for name in (NEW_KERNELS if gated else ()) + (INT8_KERNELS if int8_base else ()):
        if new[name] <= 0:
            log(f"[small] FAIL: kernel {name} was not launched in the {tag}step")
            ok = False
    return ok


def full_width_training(torch, dev, gated=False, int8_base=False):
    """presets.internvl2_1b(lora=True) through the trainer: 1 warm-up step
    and TRAIN_STEPS timed steps; launches counted over the timed steps.
    `gated`: with both fused-kernel gates set in the process environment
    (restored afterwards). `int8_base`: the same seed-0 params with the
    frozen base LLM quantized to int8 before the trainer takes them
    (`bench.py` BENCH_INT8_BASE=1)."""
    with gates_set(gated):
        return _full_width_training(torch, dev, gated, int8_base)


def _full_width_training(torch, dev, gated, int8_base):
    import dataclasses
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.core.quantize import quantize_llm
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import trainer

    kernels = kernel_fns()
    tag = "[train_gated]" if gated else "[train_int8]" if int8_base else "[train]"

    def reset_after_warmup(step, _):
        if step == 0:
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0

    cfg = compose([f"max_steps={1 + TRAIN_STEPS}", "data.batch_size=6",
                   "data.max_text_len=768", "seed=0"])
    m = cfg.model
    log(f"{tag} presets.internvl2_1b(lora=True): ViT {m.vit.num_layers}x"
        f"{m.vit.hidden_size} ({m.vit.num_heads} heads, tanh GELU), Qwen2 "
        f"{m.llm.num_layers}x{m.llm.hidden_size} vocab {m.llm.vocab_size}, LoRA r="
        f"{m.llm.lora_r} alpha={m.llm.lora_alpha} dropout={m.llm.lora_dropout}; "
        f"batch {cfg.data.batch_size}, seq {cfg.data.max_text_len} + "
        f"{m.num_queries} queries, 2 tiles; no remat; "
        f"AdamW {dataclasses.asdict(cfg.optimizer)}{'; int8 base LLM' if int8_base else ''}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = None
    if int8_base:                 # the trainer's own init, then the int8 base
        params = simlingo.init_params(m, torch.Generator(device=dev).manual_seed(cfg.seed),
                                      device=dev)
        params["llm"] = quantize_llm(params["llm"])
    res = trainer.train(cfg, params=params, device=dev, after_step=reset_after_warmup)
    del params
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
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
    must = ["flash_attn_fwd", "flash_attn_bwd", "dropout"]
    if gated:
        must += list(NEW_KERNELS)
        for name, per_step in GATED_PER_STEP.items():
            want = per_step * TRAIN_STEPS
            log(f"{tag} {name}: {launches[name]} launches, expected {per_step} per "
                f"step x {TRAIN_STEPS} = {want} "
                f"{'OK' if launches[name] == want else 'DIFFERS'}")
    else:
        log(f"{tag} fused kernels with the gates off: "
            f"{ {k: launches[k] for k in NEW_KERNELS} } (expected 0)")
    if int8_base:
        must += list(INT8_KERNELS)
        for name, per_step in INT8_PER_STEP.items():
            want = per_step * TRAIN_STEPS
            log(f"{tag} {name}: {launches[name]} launches, expected {per_step} per "
                f"step x {TRAIN_STEPS} = {want} "
                f"{'OK' if launches[name] == want else 'DIFFERS'}")
    else:
        log(f"{tag} int8 kernels on the bf16 base: "
            f"{ {k: launches[k] for k in INT8_KERNELS} } (expected 0)")
    for name in must:
        if launches[name] <= 0:
            log(f"{tag} FAIL: kernel {name} was not launched on the training path")
            ok = False
    state, step_fn, batch = res["state"], res["step_fn"], res["batch"]
    profile = device_profile(torch, lambda: step_fn(state, batch, 99),
                             f"one training step {tag}")
    stats = dict(step_ms=ms, mean_step_ms=mean_ms,
                 samples_per_s=cfg.data.batch_size * 1e3 / mean_ms,
                 records=res["records"], peak_bytes=peak, launches=launches,
                 profile=profile)
    return ok, stats


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


def kernel_line(cases, launches):
    """One entry per ported kernel, at a representative shape of its path;
    launches: {path: {kernel: count}} from each path's counted run."""
    meta = {
        "flash_attn_fwd": ("simlingo_tpu_torch/csrc/flash_attn_fwd.cu",
                           "simlingo_tpu/kernels/flash_attention.py:308", "llm_prefill"),
        "int8_matmul": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                        "simlingo_tpu/kernels/quantized_matmul.py:49", "gate_up"),
        "int8_matmul_dx": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                           "simlingo_tpu/kernels/quantized_matmul.py:81", "gate_up"),
        "flash_attn_bwd": ("simlingo_tpu_torch/csrc/flash_attn_bwd.cu",
                           "simlingo_tpu/kernels/flash_attention.py:382", "llm_train"),
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
    return {"kernels": out}


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def run_path_phases(torch, dev, cases) -> int:
    if not (small_model_agreement(torch, dev) and small_training_agreement(torch, dev)
            and small_training_agreement(torch, dev, gated=True)
            and small_training_agreement(torch, dev, int8_base=True)):
        return 1
    ok, stats, agent, frame = full_width(torch, dev, gated_pass=True)
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
    ok, train_stats = full_width_training(torch, dev)
    if not ok:
        return 1
    torch.cuda.empty_cache()
    ok, gated_stats = full_width_training(torch, dev, gated=True)
    if not ok or not compare_training(train_stats, gated_stats):
        return 1
    torch.cuda.empty_cache()
    ok, int8_stats = full_width_training(torch, dev, int8_base=True)
    if not ok:
        return 1
    compare_int8_base(train_stats, int8_stats)
    smi = smi_line()
    for name, st in (("agent", stats), ("train", train_stats), ("train_gated", gated_stats),
                     ("train_int8", int8_stats)):
        with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi), f, indent=1)
    launches = {"serve": stats["launches"], "serve_gated": stats["gated"]["launches"],
                "train": train_stats["launches"],
                "train_gated": gated_stats["launches"], "train_int8": int8_stats["launches"]}
    print(json.dumps(kernel_line(cases, launches)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_CHECKS = {"flash_attn_fwd": run_attention_checks, "int8_matmul": run_int8_checks,
                 "int8_matmul_dx": run_int8_dx_checks, "flash_attn_bwd": run_attention_bwd_checks,
                 "dropout": run_dropout_checks, "norms": run_norm_checks, "fused_ce": run_ce_checks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="*", choices=sorted(KERNEL_CHECKS), metavar="NAME",
                    help="build and check the kernels only (those named, else all: "
                         + ", ".join(sorted(KERNEL_CHECKS)) + ")")
    ap.add_argument("--int8-sweep", action="store_true",
                    help="build, then time the int8 forward at every reduction split "
                         "and the GEMV at forced plans")
    ap.add_argument("--ce-sweep", action="store_true",
                    help="build, then time the fused CE backward at forced segment counts")
    ap.add_argument("--attn-sweep", action="store_true",
                    help="build, then time the attention forward at forced plans")
    ap.add_argument("--norm-sweep", action="store_true",
                    help="build, then time the norm kernels at forced plans")
    ap.add_argument("--parent", metavar="DIR",
                    help="also hold the fused CE forward's and the tiled attention "
                         "forward's bits equal to those of the source tree at DIR (e.g. "
                         "a git archive of the parent commit), and time both forwards "
                         "and the int8 GEMV of both trees on phase 2's inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    from simlingo_tpu_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    log(f"[build] {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    if args.int8_sweep:
        return int8_sweep(torch, dev)
    if args.ce_sweep:
        return ce_sweep(torch, dev)
    if args.attn_sweep:
        return attn_sweep(torch, dev)
    if args.norm_sweep:
        return norm_sweep(torch, dev)

    # 2. kernels
    cases = []
    for name, check in KERNEL_CHECKS.items():
        if not args.kernels or name in args.kernels:
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
        for check, kernel in (("fused_ce", "fused_ce_fwd"), ("flash_attn_fwd", "flash_attn_fwd"),
                              ("int8_matmul", "int8_fwd"), ("norms", "norms")):
            if check in checked and not compare_fwd(args.parent, kernel):
                return 1
    if args.kernels is not None:
        log(f"[kernel] all cases within tolerance on {smi_line()}")
        return 0

    return run_path_phases(torch, dev, cases)


if __name__ == "__main__":
    sys.exit(main())
