#!/usr/bin/env python3
"""Drive the PyTorch port (simlingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one GPU
    python3 chip_smoke.py --kernels     # build + kernel checks only

Phases, in order; any failure exits non-zero:
  1. build: compile csrc/*.cu with nvcc (all in parallel), print seconds;
  2. kernels: every hand-written kernel at every shape the serving path
     gives it, against its plain PyTorch version on the same bf16 inputs
     (fp32 math) at |err| <= ATOL + RTOL |ref|; prints max error (absolute
     and over the output's rms), kernel / plain / library ms and the bound
     from bytes or operations on this card;
  3. small-model agreement: a small D=64 model's drive_only waypoints on
     the GPU (bf16, kernels) against the CPU plain path (fp32);
  4. full width: the default LingoAgent (CoT, int8 LLM, speculative) on
     SimLingoConfig() with seeded random bf16 weights, FRAMES frames on a
     seeded 1024x512 frame, then one use_cot=False frame; launch counts of every
     kernel are reset just before and read just after;
  5. the {"kernels": [...]} line, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.
Per-case results also go to chiprun_out/chip_smoke_cases.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
FRAMES = 4                  # CoT frames: the first plain, then speculative
L2_BYTES = 64 << 20         # rotate operand sets past the 50 MB L2


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops):
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
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
    """ms per call launched eagerly from Python (includes host overhead)."""
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


def run_attention_checks(torch, dev, results):
    import torch.nn.functional as F
    from simlingo_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 64
    for (name, B, T, S, HQ, HK, causal, q_off, ranges,
         strided) in attention_cases():
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
            if ranges is not None:
                valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
                for lo, hi in ranges:
                    valid[:, lo:hi] = True
            return q, k, v, valid

        q, k, v, valid = make()
        out = FA.flash_attn_fwd(q, k, v, valid, causal, None, q_off)
        torch.cuda.synchronize()
        ref = FA.attention_reference(q.float(), k.float(), v.float(), valid,
                                     causal, None, q_off)
        err, rel, ok = max_violation("flash_attn_fwd", out, ref)
        # visible (row, key) pairs: the work this data needs
        off = S - T if q_off is None else q_off
        mask = torch.ones(T, S, dtype=torch.bool, device=dev)
        if causal:
            mask &= (torch.arange(S, device=dev)[None, :]
                     <= torch.arange(T, device=dev)[:, None] + off)
        if valid is not None:
            mask = mask[None] & valid[:, None, :]
        pairs = int(mask.sum()) * (1 if valid is not None else B)
        empty_rows = int((~mask.any(-1)).sum()) if valid is not None else 0
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
            am = None
            if causal or m_ is not None:
                am = mask if m_ is not None else mask[None]
                am = am[:, None]
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=am, enable_gqa=HQ != HK)
        library_ms = time_ms(torch, sdpa, sets)
        row = dict(kernel="flash_attn_fwd", case=name,
                   shape=f"q[{B},{T},{HQ},{D}] kv[{B},{S},{HK},{D}]",
                   causal=causal, q_offset=q_off, empty_rows=empty_rows,
                   max_abs_err=err, err_over_rms=rel, ok=ok, kernel_ms=kernel_ms,
                   launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=bby)
        results.append(row)
        log(f"[kernel] flash_attn_fwd {name:12s} {row['shape']:32s} "
            f"err={err:.3e} err/rms={rel:.3e} (atol {ATOL['flash_attn_fwd']} "
            f"rtol {RTOL}) {'OK' if ok else 'FAIL'} "
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


def profile_frame(torch, agent, frame):
    """Device time by kernel over one speculative CoT frame (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.run_step(frame)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one speculative frame: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for ms, n, key in rows[:15]:
        log(f"[profile] {ms:9.3f} ms  x{n:5d}  {key[:90]}")
    return dict(wall_ms=wall, device_busy_ms=busy,
                top=[dict(ms=ms, count=n, name=key) for ms, n, key in rows[:25]])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernel_line(cases, launches):
    """One entry per ported kernel, at its representative prefill shape."""
    meta = {
        "flash_attn_fwd": ("simlingo_tpu_torch/csrc/flash_attn_fwd.cu",
                           "simlingo_tpu/kernels/flash_attention.py:308", "llm_prefill"),
        "int8_matmul": ("simlingo_tpu_torch/csrc/int8_matmul.cu",
                        "simlingo_tpu/kernels/quantized_matmul.py:49", "gate_up"),
    }
    out = []
    for name, (src, replaces, case) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        rep = [c for c in mine if c["case"] == case and c.get("M", 640) == 640][0]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(c["max_abs_err"] for c in mine),
                    "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"], "shape": rep["shape"]})
    return {"kernels": out}


def run_agent_phases(torch, dev, cases) -> int:
    if not small_model_agreement(torch, dev):
        return 1
    ok, stats, agent, frame = full_width(torch, dev)
    if not ok:
        return 1
    stats["profile"] = profile_frame(torch, agent, frame)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_agent.json"), "w") as f:
        json.dump(dict(stats, nvidia_smi=smi), f, indent=1)
    print(json.dumps(kernel_line(cases, stats["launches"])), flush=True)
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

    return run_agent_phases(torch, dev, cases)


if __name__ == "__main__":
    sys.exit(main())
