#!/usr/bin/env python3
"""Drive the PyTorch port (simlingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one GPU
    python3 chip_smoke.py --kernels     # build + kernel checks only

Phases, in order; any failure exits non-zero:
  1. build: compile csrc/*.cu with nvcc (all in parallel), print seconds;
  2. kernels: every hand-written kernel at every shape the serving and the
     training paths give it, against its plain PyTorch version on the same
     bf16 inputs (fp32 math) at |err| <= ATOL + RTOL |ref| (the attention
     backward: within the bf16 rounding bound of each gradient element,
     see BF16_U; dropout: bit-equal, keep rate 0.9 +- 0.002, identity at
     p = 0; LayerNorm / RMSNorm forward and backward at the ViT, projector,
     LLM-training and serving rows, and the fused CE forward, backward and
     dW backward at the training shape and a ragged one, each against the
     tolerance stated at BF16_SPACING);
     prints max error (absolute and over the output's rms, or over the
     tolerance), kernel / plain / library ms and the bound from bytes or
     operations on this card;
  3. small-model agreement: a small D=128 model's drive_only waypoints on
     the GPU (bf16, kernels) against the CPU plain path (fp32), and one
     training step of the same model with LoRA r=4, dropout 0.1 (losses to
     2e-2, grad norm to 5e-2 relative), then that step again with both
     fused-kernel gates on (SIMLINGO_CE_IMPL=pallas, SIMLINGO_LN_IMPL=pallas);
  4. full width, serving: the default LingoAgent (CoT, int8 LLM,
     speculative) on SimLingoConfig() with seeded random bf16 weights,
     FRAMES frames on a seeded 1024x512 frame, then one use_cot=False
     frame; launch counts of every kernel are reset just before and read
     just after, with a profile of one speculative frame;
  5. full width, training: train_torch's trainer on
     presets.internvl2_1b(lora=True) (seed 0) and synthetic_example(batch 6,
     seq_len 768, 2 tiles): 1 warm-up step, then TRAIN_STEPS timed steps
     with the launch counts reset after the warm-up; peak memory, and a
     profile of one more step (device time by kernel class); then the
     same run with both gates set in the process environment (restored
     afterwards), which must launch the six norm and CE kernels (their
     counts are logged against GATED_PER_STEP), and the two runs side by
     side (losses to 2e-2 relative);
  6. the {"kernels": [...]} line (ten kernels, launches per path: serve,
     train, train_gated), the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.
Per-case results also go to chiprun_out/chip_smoke_cases.json, the paths'
statistics to chip_smoke_agent.json, chip_smoke_train.json and
chip_smoke_train_gated.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
# bf16 kernels vs the fp32 plain version: |err| <= atol + RTOL |ref|.
# Attention outputs are small (rms ~0.05 for rows that see hundreds of
# keys), so its atol is a tenth of int8_matmul's (outputs of rms ~1).
ATOL = {"flash_attn_fwd": 2e-3, "int8_matmul": 2e-2}
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
PEAK_FP32 = 67e12           # non-tensor fp32 FLOP/s (norm arithmetic)
FRAMES = 4                  # CoT frames: the first plain, then speculative
TRAIN_STEPS = 3             # timed full-width training steps (after 1 warm-up)
L2_BYTES = 64 << 20         # rotate operand sets past the 50 MB L2


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops, peak=PEAK_BF16):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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


def run_attention_checks(torch, dev, results):
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 64
    cases = attention_cases() + [
        ("llm_train", 6, 798, 798, 14, 2, True, None, "train", False),
        ("vit_train", 12, 1025, 1025, 16, 16, False, None, None, True)]
    train_valid = train_llm_valid(torch, dev)
    for (name, B, T, S, HQ, HK, causal, q_off, ranges,
         strided) in cases:
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

        q, k, v, valid = make()
        out, lse = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off,
                                     return_lse=True)
        torch.cuda.synchronize()
        ref = FA.attention_reference(q.float(), k.float(), v.float(), valid,
                                     causal, None, q_off)
        err, rel, ok = max_violation("flash_attn_fwd", out, ref)
        ref_lse = FA.attention_lse_reference(q.float(), k.float(), valid, causal,
                                             None, q_off)
        fin = torch.isfinite(ref_lse)
        lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() else 0.0
        ok = ok and torch.equal(torch.isfinite(lse), fin) and lse_err <= 1e-2
        # visible (row, key) pairs: the work this data needs
        pairs, empty_rows, mask = visible_pairs(torch, dev, B, T, S, causal,
                                                q_off, valid)
        flops = 4 * D * pairs * HQ
        nbytes = 2 * (B * T * HQ * D * 2 + 2 * B * S * HK * D) + (
            B * S if valid is not None else 0)
        bms, bby = bound(nbytes, flops)
        sets = [make() for _ in range(n_sets(nbytes))]
        def kernel(q_, k_, v_, m_):
            return FA.flash_attn_fwd(q_, k_, v_, m_, causal, None, q_off)
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
                   kernel_ms=kernel_ms,
                   launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] flash_attn_fwd {name:12s} {row['shape']:32s} "
            f"err={err:.3e} err/rms={rel:.3e} (atol {ATOL['flash_attn_fwd']} "
            f"rtol {RTOL}) lse_err={lse_err:.2e} {'OK' if ok else 'FAIL'} "
            f"empty_rows={empty_rows} kernel_ms={kernel_ms:.4f} "
            f"launch_ms={launch_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bms:.4f} ({bby})")


def run_int8_checks(torch, dev, results):
    from simlingo_tpu_torch.kernels import quantized_matmul as QM
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [("qo", 896, 896), ("kv", 896, 128), ("gate_up", 896, 4864),
              ("down", 4864, 896)]
    cases = [(n, K, N, M) for (n, K, N) in shapes for M in (1, 16, 30, 640)]
    cases += [("head", 896, 151674, 1), ("head", 896, 151674, 16)]
    for name, K, N, M in cases:
        def make():
            x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
            w = torch.randn(N, K, generator=gen, device=dev) * 0.02
            w_q, scale = QM.quantize_weight(w, axis=0)
            return x, w_q, scale
        x, w_q, scale = make()
        out = QM.int8_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        ref = QM.int8_matmul_reference(x.float(), w_q, scale)
        err, rel, ok = max_violation("int8_matmul", out, ref)
        nbytes = M * K * 2 + N * K + N * 4 + M * N * 2
        bms, bby = bound(nbytes, 2 * M * N * K)
        sets = [make() for _ in range(n_sets(nbytes))]
        kernel_ms = time_ms(torch, QM.int8_matmul, sets)
        launch_ms = eager_ms(torch, QM.int8_matmul, sets)
        plain_ms = time_ms(torch, QM.int8_matmul_reference, sets[:2], iters=4)

        def dequant_matmul(x_, w_, s_):
            return x_ @ (w_.to(torch.bfloat16) * s_[:, None].to(torch.bfloat16)).t()
        library_ms = time_ms(torch, dequant_matmul, sets)
        row = dict(kernel="int8_matmul", case=name, shape=f"M={M} K={K} N={N}",
                   M=M, K=K, N=N, max_abs_err=err, err_over_rms=rel, ok=ok,
                   kernel_ms=kernel_ms,
                   launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] int8_matmul    {name:8s} M={M:4d} K={K:5d} N={N:6d} "
            f"err={err:.3e} err/rms={rel:.3e} (atol {ATOL['int8_matmul']} "
            f"rtol {RTOL}) {'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} launch_ms={launch_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bms:.4f} ({bby})")


def run_attention_bwd_checks(torch, dev, results):
    """flash_attn_bwd at the two training shapes, against
    attention_bwd_reference on the same bf16 inputs (and the kernel
    forward's o and lse); library: autograd through SDPA's backward."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(3)
    D = 64
    train_valid = train_llm_valid(torch, dev)
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
        got = FA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal)
        torch.cuda.synchronize()
        args = (q.float(), k.float(), v.float(), valid, out.float(), dout.float(),
                lse, causal)
        ref = FA.attention_bwd_reference(*args)
        mag = FA.attention_bwd_reference(*args, abs_terms=True)
        ok, err, rel, ratio = True, 0.0, 0.0, 0.0
        for a, b, m in zip(got, ref, mag):
            diff = (a.float() - b).abs()
            rms = float(b.square().mean().sqrt())
            tol = BF16_U * (m + b.abs()) + 1e-5 * rms
            ok &= bool((diff <= tol).all())
            err, rel = max(err, float(diff.max())), max(rel, float(diff.max()) / rms)
            ratio = max(ratio, float((diff / tol).max()))
        del mag
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
                   err_over_tol=ratio, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bms, bound_by=bby,
                   dkdv_blocks=-(-T // 64) * HK * B, dq_blocks=-(-T // 64) * HQ * B)
        results.append(row)
        log(f"[kernel] flash_attn_bwd {name:12s} {row['shape']:32s} err={err:.3e} "
            f"err/rms={rel:.3e} err/tol={ratio:.3f} (tol 2^-8 (sum|terms| + |ref|)) "
            f"{'OK' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA backward) bound_ms={bms:.4f} ({bby}) "
            f"dK/dV blocks={row['dkdv_blocks']} dQ blocks={row['dq_blocks']}")


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


def norm_cases():
    """(kernel family, case, rows, d, eps): the ViT's 48 LayerNorms and the
    projector's, the LLM's 49 RMSNorms in training and at the serving rows
    (decode 1, prefill 640)."""
    return [("layernorm", "vit", 12 * 1025, 1024, 1e-6),
            ("layernorm", "projector", 12 * 256, 4096, 1e-5),
            ("rmsnorm", "llm_train", 6 * 798, 896, 1e-6),
            ("rmsnorm", "serve_decode", 1, 896, 1e-6),
            ("rmsnorm", "serve_prefill", 640, 896, 1e-6)]


def run_norm_checks(torch, dev, results):
    """layernorm / rmsnorm forward and backward against their plain
    versions on the same bf16 inputs (bf16 scale and bias, as the compute
    copies of the path); library: F.layer_norm / F.rms_norm and their
    autograd backward (eager)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import layernorm as TL
    gen = torch.Generator(device=dev).manual_seed(5)
    for fam, name, n, d, eps in norm_cases():
        ln = fam == "layernorm"

        def make():
            x = (2 * torch.randn(n, d, generator=gen, device=dev) + 0.3).bfloat16()
            dy = torch.randn(n, d, generator=gen, device=dev).bfloat16()
            scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
            bias = (0.1 * torch.randn(d, generator=gen, device=dev)).bfloat16()
            if ln:
                _, mean, rstd = TL.layernorm_fwd_plain(x, scale, bias, eps)
            else:
                _, rstd = TL.rmsnorm_fwd_plain(x, scale, eps)
                mean = None
            return x, scale, bias, dy, mean, rstd

        x, scale, bias, dy, mean, rstd = make()
        if ln:
            y = TL.layernorm_fwd(x, scale, bias, eps)[0]
            ry = TL.layernorm_fwd_plain(x, scale, bias, eps)[0]
            got = TL.layernorm_bwd(x, scale, mean, rstd, dy)
            ref = TL.layernorm_bwd_plain(x, scale, mean, rstd, dy)
            xhat = (x.float() - mean[:, None]) * rstd[:, None]
            terms = [(dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0)]
        else:
            y = TL.rmsnorm_fwd(x, scale, eps)[0]
            ry = TL.rmsnorm_fwd_plain(x, scale, eps)[0]
            got = TL.rmsnorm_bwd(x, scale, rstd, dy)
            ref = TL.rmsnorm_bwd_plain(x, scale, rstd, dy)
            xhat = x.float() * rstd[:, None]
            terms = [(dy.float() * xhat).abs().sum(0)]
        torch.cuda.synchronize()

        def spacing_tol(r):
            r = r.float()
            return BF16_SPACING * r.abs() + 1e-5 * float(r.square().mean().sqrt())
        fwd_err, fwd_ratio = _ratio(y, ry, spacing_tol(ry))
        bwd = [_ratio(got[0], ref[0], spacing_tol(ref[0]))]
        bwd += [_ratio(a, b, BF16_SPACING * b.float().abs() + 1e-5 * t)
                for a, b, t in zip(got[1:], ref[1:], terms)]
        bwd_err, bwd_ratio = max(e for e, _ in bwd), max(r for _, r in bwd)

        # bytes each input read once, each output written once
        stat_b = (8 if ln else 4) * n
        par_b = (2 if ln else 1) * 2 * d
        fwd_bytes = 2 * n * d * 2 + par_b + stat_b
        bwd_bytes = 3 * n * d * 2 + 2 * d + stat_b + par_b
        fb = bound(fwd_bytes, (8 if ln else 4) * n * d, PEAK_FP32)
        bb = bound(bwd_bytes, (16 if ln else 12) * n * d, PEAK_FP32)
        sets = [make() for _ in range(n_sets(bwd_bytes))]
        if ln:
            kf = lambda x_, s_, b_, d_, m_, r_: TL.layernorm_fwd(x_, s_, b_, eps)      # noqa: E731
            pf = lambda x_, s_, b_, d_, m_, r_: TL.layernorm_fwd_plain(x_, s_, b_, eps)  # noqa: E731
            lf = lambda x_, s_, b_, d_, m_, r_: F.layer_norm(x_, (d,), s_, b_, eps)    # noqa: E731
            kb = lambda x_, s_, b_, d_, m_, r_: TL.layernorm_bwd(x_, s_, m_, r_, d_)   # noqa: E731
            pb = lambda x_, s_, b_, d_, m_, r_: TL.layernorm_bwd_plain(x_, s_, m_, r_, d_)  # noqa: E731
        else:
            kf = lambda x_, s_, b_, d_, m_, r_: TL.rmsnorm_fwd(x_, s_, eps)            # noqa: E731
            pf = lambda x_, s_, b_, d_, m_, r_: TL.rmsnorm_fwd_plain(x_, s_, eps)      # noqa: E731
            lf = lambda x_, s_, b_, d_, m_, r_: F.rms_norm(x_, (d,), s_, eps)          # noqa: E731
            kb = lambda x_, s_, b_, d_, m_, r_: TL.rmsnorm_bwd(x_, s_, r_, d_)         # noqa: E731
            pb = lambda x_, s_, b_, d_, m_, r_: TL.rmsnorm_bwd_plain(x_, s_, r_, d_)   # noqa: E731
        # library backward: autograd through the library forward (eager)
        xs = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
        lib_out = (F.layer_norm(xs[0], (d,), xs[1], xs[2], eps) if ln
                   else F.rms_norm(xs[0], (d,), xs[1], eps))
        lib_in = xs if ln else xs[:2]
        rows = []
        for kernel, fn, plain, lib, err, ratio, (bms, bby) in (
                (f"{fam}_fwd", kf, pf, lf, fwd_err, fwd_ratio, fb),
                (f"{fam}_bwd", kb, pb, None, bwd_err, bwd_ratio, bb)):
            kernel_ms = time_ms(torch, fn, sets)
            plain_ms = time_ms(torch, plain, sets[:2], iters=4)
            if lib is None:
                library_ms, how = eager_ms(torch, lambda: torch.autograd.grad(
                    lib_out, lib_in, dy, retain_graph=True), [()]), "eager"
            else:
                library_ms, how = time_ms(torch, lib, sets), "graph"
            rows.append(dict(kernel=kernel, case=name, shape=f"[{n},{d}] bf16 eps={eps}",
                             max_abs_err=err, err_over_tol=ratio, ok=ratio <= 1.0,
                             kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, library_timing=how,
                             bound_ms=bms, bound_by=bby))
        del lib_out, xs, sets
        for row in rows:
            results.append(row)
            log(f"[kernel] {row['kernel']:14s} {name:13s} {row['shape']:28s} "
                f"err={row['max_abs_err']:.3e} err/tol={row['err_over_tol']:.3f} "
                f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}) bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    torch.cuda.empty_cache()


def ce_cases():
    """(case, N, H, V, compute_dw): the training shape (6 x 160 answer
    positions, the tied 151674-row head), with and without dW, and a
    ragged small one."""
    return [("train", 960, 896, 151674, False), ("train_dw", 960, 896, 151674, True),
            ("ragged", 100, 128, 1111, True)]


def run_ce_checks(torch, dev, results):
    """fused_ce forward and backward (dh; dh + dW) against their plain
    versions on the same bf16 inputs, at the training shape and a ragged
    one (N not a multiple of 128 rows, V not of 128 columns, labels out of
    range); library: F.cross_entropy(F.linear(h, w).float(), labels) and
    its autograd backward (eager)."""
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import fused_ce as TC
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, N, H, V, dw in ce_cases():
        h = torch.randn(N, H, generator=gen, device=dev).bfloat16()
        w = (0.02 * torch.randn(V, H, generator=gen, device=dev)).bfloat16()
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if name == "ragged":
            labels[0], labels[-1] = -100, V
        # the loss's cotangent: 1 / (valid answer tokens) on valid rows
        g = (torch.rand(N, generator=gen, device=dev) < 0.8).float() / (0.8 * N)
        logz, ce = TC.fused_ce_fwd(h, labels, w)
        rlogz, rce = TC.fused_ce_fwd_plain(h, labels, w)
        dh, dwk = TC.fused_ce_bwd(h, labels, w, rlogz, g, dw)
        torch.cuda.synchronize()
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
                             how=how, bound=fb))
        kernel_ms = time_ms(torch, lambda h_, l_, w_, z_, g_: TC.fused_ce_bwd(
            h_, l_, w_, z_, g_, dw), sets)
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
                         how="eager", bound=bb))
        del lib_out, hx, wx, sets
        for r in rows:
            bms, bby = r["bound"]
            with_dw = dw and r["kernel"] == "fused_ce_bwd"
            row = dict(kernel=r["kernel"], case=name,
                       shape=f"N={N} H={H} V={V}{' +dW' if with_dw else ''}",
                       max_abs_err=r["err"], err_over_tol=r["ratio"], ok=r["ratio"] <= 1.0,
                       kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                       library_ms=r["library_ms"], library_timing=r["how"],
                       bound_ms=bms, bound_by=bby)
            results.append(row)
            log(f"[kernel] {row['kernel']:14s} {name:13s} {row['shape']:28s} "
                f"err={row['max_abs_err']:.3e} err/tol={row['err_over_tol']:.3f} "
                f"{'OK' if row['ok'] else 'FAIL'} kernel_ms={row['kernel_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"({row['library_timing']}) bound_ms={bms:.4f} ({bby})")
        torch.cuda.empty_cache()


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


def full_width(torch, dev):
    """The default LingoAgent at SimLingoConfig() width; returns (ok, stats,
    the CoT agent, the frame)."""
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
    stats = dict(frame_ms_cot_plain=results[0]["latency_s"] * 1e3,
                 frame_ms_cot_spec=cot_spec,
                 frame_ms_drive_only=results[-1]["latency_s"] * 1e3,
                 tokens_per_frame=[len(r.get("language_tokens", [])) for r in results[:-1]],
                 spec_stats=agent.spec_stats, decode_ms_per_token=decode_ms,
                 launches=launches)
    return ok, stats, agent, frame


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
    classes = {}
    for ms, n, key in rows:
        cls = kernel_class(key)
        ms0, n0 = classes.get(cls, (0.0, 0))
        classes[cls] = (ms0 + ms, n0 + n)
    log(f"[profile] {what}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    log(f"[profile] device ms (launches) by class: "
        + ", ".join(f"{c} {ms:.2f} ({n})" for c, (ms, n) in sorted(classes.items())))
    for ms, n, key in rows[:15]:
        log(f"[profile] {ms:9.3f} ms  x{n:5d}  {key[:90]}")
    return dict(wall_ms=wall, device_busy_ms=busy,
                classes={c: dict(ms=ms, count=n) for c, (ms, n) in classes.items()},
                top=[dict(ms=ms, count=n, name=key) for ms, n, key in rows[:25]])


HAND_KERNELS = ("flash_fwd_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_prep_kernel",
                "dropout_kernel", "gemm_kernel", "gemv_kernel", "norm_fwd_kernel",
                "norm_bwd_kernel", "col_reduce_kernel", "ce_fwd_tile_kernel",
                "ce_fwd_finalize_kernel", "ce_bwd_kernel", "ce_dh_reduce_kernel")


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


class gates_set:
    """Set the fused-kernel gates in the process environment (or leave
    them unset) and restore the environment afterwards."""

    def __init__(self, on):
        self.env = GATES_ON if on else {}

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
            "layernorm_fwd": TL.layernorm_fwd, "layernorm_bwd": TL.layernorm_bwd,
            "rmsnorm_fwd": TL.rmsnorm_fwd, "rmsnorm_bwd": TL.rmsnorm_bwd,
            "fused_ce_fwd": TC.fused_ce_fwd, "fused_ce_bwd": TC.fused_ce_bwd}


def small_training_agreement(torch, dev, gated=False):
    """One train_step of a small D=128 model with LoRA r=4, dropout 0.1 on
    the GPU (bf16, kernels) and on the CPU (fp32, plain versions), from the
    same params, batch and seed: the dropout masks are the same on both
    sides (Philox of the flat index), so the losses and grad norm agree.
    `gated`: with both fused-kernel gates on, on both sides."""
    import copy
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
    opt = ts.OptimizerConfig(lr=1e-4, total_steps=10)
    metrics = {}
    fns = kernel_fns()
    tag = "gated " if gated else ""
    with gates_set(gated):
        for device, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
            state = ts.init_train_state(_to(copy.deepcopy(params), device), opt)
            batch = synthetic_example(cfg, batch=2, seq_len=96, num_patches=2, seed=1,
                                      device=device)
            step = ts.make_train_step(cfg, opt, compute_dtype=dtype)
            before = {k: fns[k].launches for k in NEW_KERNELS}
            metrics[str(device)] = {k: float(v) for k, v in step(state, batch, 1234).items()}
    new = {k: fns[k].launches - before[k] for k in NEW_KERNELS}
    ref, got = metrics["cpu"], metrics[str(dev)]
    ok = True
    for key, want in ref.items():
        tol = 5e-2 if key == "grad_norm" else 2e-2
        good = abs(got[key] - want) <= tol * abs(want)
        ok &= good
        log(f"[small] {tag}train_step {key:15s} GPU bf16 {got[key]:.6f} vs CPU fp32 "
            f"{want:.6f} (rel tol {tol}) {'OK' if good else 'FAIL'}")
    log(f"[small] {tag}train_step launches of the fused kernels on the GPU: {new}")
    if gated and min(new.values()) <= 0:
        log("[small] FAIL: a fused kernel was not launched with the gates on")
        ok = False
    return ok


def full_width_training(torch, dev, gated=False):
    """presets.internvl2_1b(lora=True) through the trainer: 1 warm-up step
    and TRAIN_STEPS timed steps; launches counted over the timed steps.
    `gated`: with both fused-kernel gates set in the process environment
    (restored afterwards)."""
    with gates_set(gated):
        return _full_width_training(torch, dev, gated)


def _full_width_training(torch, dev, gated):
    import dataclasses
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.train import trainer

    kernels = kernel_fns()
    tag = "[train_gated]" if gated else "[train]"

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
        f"AdamW {dataclasses.asdict(cfg.optimizer)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.train(cfg, device=dev, after_step=reset_after_warmup)
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
    for name in must:
        if launches[name] <= 0:
            log(f"{tag} FAIL: kernel {name} was not launched on the training path")
            ok = False
    state, step_fn, batch = res["state"], res["step_fn"], res["batch"]
    profile = device_profile(torch, lambda: step_fn(state, batch, 99),
                             "one gated training step" if gated else "one training step")
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
    pp, gp = plain["profile"], gated["profile"]
    log(f"[train_ab] mean ms/step {plain['mean_step_ms']:.2f} vs gated "
        f"{gated['mean_step_ms']:.2f}; samples/s {plain['samples_per_s']:.3f} vs "
        f"{gated['samples_per_s']:.3f}; peak {plain['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{gated['peak_bytes'] / 2 ** 30:.2f} GiB; profiled step device busy "
        f"{pp['device_busy_ms']:.2f} of {pp['wall_ms']:.2f} ms vs "
        f"{gp['device_busy_ms']:.2f} of {gp['wall_ms']:.2f} ms")
    for cls in sorted(set(pp["classes"]) | set(gp["classes"])):
        a = pp["classes"].get(cls, {"ms": 0.0, "count": 0})
        b = gp["classes"].get(cls, {"ms": 0.0, "count": 0})
        log(f"[train_ab] {cls:12s} device ms {a['ms']:9.3f} ({a['count']:6d}) vs gated "
            f"{b['ms']:9.3f} ({b['count']:6d})")
    return ok


def kernel_line(cases, launches):
    """One entry per ported kernel, at a representative shape of its path;
    launches: {path: {kernel: count}} from each path's counted run."""
    meta = {
        "flash_attn_fwd": ("simlingo_tpu_torch/csrc/flash_attn_fwd.cu",
                           "simlingo_tpu/kernels/flash_attention.py:308", "llm_prefill"),
        "int8_matmul": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                        "simlingo_tpu/kernels/quantized_matmul.py:49", "gate_up"),
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
        rep = [c for c in mine if c["case"] == case and c.get("M", 640) == 640][0]
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": max(c["max_abs_err"] for c in mine),
                    "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"], "shape": rep["shape"]})
    return {"kernels": out}


def run_path_phases(torch, dev, cases) -> int:
    if not (small_model_agreement(torch, dev) and small_training_agreement(torch, dev)
            and small_training_agreement(torch, dev, gated=True)):
        return 1
    ok, stats, agent, frame = full_width(torch, dev)
    if not ok:
        return 1
    stats["profile"] = device_profile(torch, lambda: agent.run_step(frame),
                                      "one speculative frame")
    del agent, frame
    ok, train_stats = full_width_training(torch, dev)
    if not ok:
        return 1
    torch.cuda.empty_cache()
    ok, gated_stats = full_width_training(torch, dev, gated=True)
    if not ok or not compare_training(train_stats, gated_stats):
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    for name, st in (("agent", stats), ("train", train_stats), ("train_gated", gated_stats)):
        with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_{name}.json"), "w") as f:
            json.dump(dict(st, nvidia_smi=smi), f, indent=1)
    launches = {"serve": stats["launches"], "train": train_stats["launches"],
                "train_gated": gated_stats["launches"]}
    print(json.dumps(kernel_line(cases, launches)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only")
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

    # 2. kernels
    cases = []
    run_attention_checks(torch, dev, cases)
    run_int8_checks(torch, dev, cases)
    run_attention_bwd_checks(torch, dev, cases)
    run_dropout_checks(torch, dev, cases)
    run_norm_checks(torch, dev, cases)
    run_ce_checks(torch, dev, cases)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_cases.json"), "w") as f:
        json.dump(cases, f, indent=1)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        log(f"[kernel] FAILED: {[(c['kernel'], c['case'], c['shape']) for c in bad]}")
        return 1
    if args.kernels:
        log("[kernel] all cases within tolerance")
        return 0

    return run_path_phases(torch, dev, cases)


if __name__ == "__main__":
    sys.exit(main())
