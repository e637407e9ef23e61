#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches another's
error:
  1. the card's name and power limit, torch/CUDA versions; TF32 off;
  2. build the kernel library from src/repro_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card at the
     main path's widths (qwen2-0.5b and hymba-1.5b), with its time, the
     plain version's, its bound and a library call's as a yardstick;
  4. prefill at full qwen2-0.5b width (B 4 x S 1024) through
     `make_prefill_step`, kernel path against forced-plain path, with the
     launch counts of each kernel;
  5. continuous-batching serve at full width (`ServeEngine`, 8 slots,
     12 requests), a mid-stream admission against a solo run; then a
     `torch.profiler` window of 20 steady decode ticks and the device's
     idle share in it;
  6. prefill at full hymba-1.5b width (B 2 x S 2048, past the 1024-token
     window): the bf16 main path with its launch counts and a
     `torch.profiler` pass over it, then the kernel path against the
     forced-plain path in f32, and what a window one key short gives;
  7. continuous-batching serve of hymba-1.5b at full width, as phase 5;
  8. the sliding-window ring cache on the card: hymba-1.5b at full width,
     depth cut to 2 layers, f32, one request of 1100 prompt tokens fed by
     decode through a 1024-entry ring, its last 8 logits against `forward`
     (and against `forward` with a window one key short or long).
The last line is `{"ok": true, "device": {...}}`; the line before it lists
every kernel.  Details go to chiprun_out/chip_smoke.json.

Without a CUDA device, or without src/repro_torch beside this file, it exits
with status 1 and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (dense): the roofline of `bound_ms`.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ARCH = "qwen2-0.5b"
HYBRID_ARCH = "hymba-1.5b"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, samples: int = 21, reps: int = 10) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph, the
    median over `samples` replays timed by CUDA events, divided by `reps`.
    Replaying the graph takes the host (Python wrapper, launch) out of the
    number; `call_ms` keeps it in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def call_ms(torch, fn, samples: int = 21, reps: int = 10) -> float:
    """Time of one eager call, host included: CUDA events around `reps`
    calls issued from Python, median over `samples`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def attention_pairs(s: int, window) -> int:
    """(query, key) pairs inside the causal (and window) band."""
    total = 0
    for qpos in range(s):
        lo = 0 if window is None else max(0, qpos - window + 1)
        total += qpos - lo + 1
    return total


# -- phase 3 ------------------------------------------------------------------

def compare(out, plain, dt_name: str, f32_atol: float):
    """Max abs error of `out` against `plain`, and the tolerance it is held
    to, element by element.  f32: `f32_atol`.  bf16: kernel and plain version
    each round an f32 result, so they may differ by one bf16 step, at most
    2^-7 of the value; 1e-4 covers values near 0.  (An absolute bf16 limit
    would be about as large as small outputs and let an edge off by one key
    pass.)"""
    atol, rtol = (1e-4, 2.0 ** -7) if dt_name == "bfloat16" else \
        (f32_atol, 0.0)
    diff = (out.float() - plain.float()).abs()
    excess = (diff - rtol * plain.float().abs() - atol).max().item()
    tol = f"{atol:g} + {rtol:g}*|plain|" if rtol else f"{atol:g}"
    return diff.max().item(), excess <= 0, tol


def check_flash_attention(torch, ops, F, dt_name: str, *, s=1024,
                          window=None, block_q=64, block_k=64, timed=False,
                          b=4, h=14, kv=2):
    hd = 64
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = ((0.5 * torch.randn((b, s, n, hd), generator=gen,
                                  device="cuda")).to(dtype)
               for n in (h, kv, kv))
    out = ops.flash_attention(q, k, v, window=window, block_q=block_q,
                              block_k=block_k)
    plain = ops.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    err, within, tol = compare(out, plain, dt_name, 2e-5)
    case = (f"flash_attention {dt_name} B{b} S{s} H{h} Kv{kv} hd{hd} "
            f"window={window} block_q={block_q} block_k={block_k}")
    require(torch.isfinite(out.float()).all().item(), f"{case}: non-finite")
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    if timed:
        flops = 4.0 * b * h * hd * attention_pairs(s, window)
        nbytes = 2 * b * s * (h + kv) * hd * q.element_size()
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dt_name)
        kernel = lambda: ops.flash_attention(  # noqa: E731
            q, k, v, window=window, block_q=block_q, block_k=block_k)
        row["ms"] = time_ms(torch, kernel)
        row["call_ms"] = call_ms(torch, kernel)
        row["plain_ms"] = time_ms(torch, lambda: ops.flash_attention_plain(
            q, k, v, window=window), samples=11, reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:  # the causal band of `window` keys as a boolean mask
            pos = torch.arange(s, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        row["library_ms"] = time_ms(torch, library)
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol})"
          + (f", ms {row['ms']:.4f} (call {row['call_ms']:.4f}), "
             f"plain_ms {row['plain_ms']:.4f}, library_ms "
             f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
             f"({row['bound_by']})" if timed else ""))
    return row


def check_rmsnorm(torch, ops, F, dt_name: str, r: int, d: int = 896):
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (0.5 * torch.randn((r, d), generator=gen, device="cuda")).to(dtype)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                     device="cuda")).to(dtype)
    out = ops.rmsnorm_pipelined(x, scale)
    plain = ops.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    err, within, tol = compare(out, plain, dt_name, 1e-5)
    case = f"rmsnorm_pipelined {dt_name} R{r} D{d}"
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    nbytes = (2 * r * d + d) * x.element_size()
    row = {"case": case, "max_abs_err": err, "tol": tol}
    row["bound_ms"], row["bound_by"] = bound(4.0 * r * d, nbytes, dt_name)
    row["ms"] = time_ms(torch, lambda: ops.rmsnorm_pipelined(x, scale))
    row["call_ms"] = call_ms(torch, lambda: ops.rmsnorm_pipelined(x, scale))
    row["plain_ms"] = time_ms(torch, lambda: ops.rmsnorm_plain(x, scale))
    row["library_ms"] = time_ms(torch, lambda: F.rms_norm(
        x, (d,), weight=scale, eps=1e-5))
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol}), ms "
          f"{row['ms']:.4f} (call {row['call_ms']:.4f}), plain_ms "
          f"{row['plain_ms']:.4f}, library_ms {row['library_ms']:.4f}, "
          f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})")
    return row


def check_ssm_scan(torch, ops, dt_name: str, *, b=2, s=2048, din=3200,
                   n=16, timed=False):
    """The selective scan against `ssm_scan_plain` on the same inputs.  It
    returns f32 and computes in f32 whatever its input type, so every case
    is held to 1e-4 absolute + 1e-4 relative, the tolerance of the
    reference's kernel test (`tests/test_kernels.py::TestSsmKernel`): the
    recurrence fused into one multiply-add, the readout summed in another
    order."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.sigmoid(torch.randn((b, s, din, n), generator=gen,
                                  device="cuda") + 1.0)
    bx = torch.randn((b, s, din, n), generator=gen, device="cuda")
    c = torch.randn((b, s, n), generator=gen, device="cuda")
    dtype = getattr(torch, dt_name)
    a, bx, c = a.to(dtype), bx.to(dtype), c.to(dtype)
    out = ops.ssm_scan(a, bx, c)
    plain = ops.ssm_scan_plain(a, bx, c)
    torch.cuda.synchronize()
    atol = rtol = 1e-4
    diff = (out - plain).abs()
    err = diff.max().item()
    within = (diff - rtol * plain.abs() - atol).max().item() <= 0
    tol = f"{atol:g} + {rtol:g}*|plain|"
    case = f"ssm_scan {dt_name} B{b} S{s} din{din} N{n}"
    require(out.dtype == torch.float32 and tuple(out.shape) == (b, s, din),
            f"{case}: out {out.dtype} {tuple(out.shape)}")
    require(torch.isfinite(out).all().item(), f"{case}: non-finite")
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    if timed:
        nbytes = a.nbytes + bx.nbytes + c.nbytes + out.nbytes
        row["bound_ms"], row["bound_by"] = bound(4.0 * b * s * din * n,
                                                 nbytes, "float32")
        kernel = lambda: ops.ssm_scan(a, bx, c)  # noqa: E731
        row["ms"] = time_ms(torch, kernel)
        row["call_ms"] = call_ms(torch, kernel)
        # a Python loop of S steps: a few samples of one call each
        row["plain_ms"] = call_ms(torch, lambda: ops.ssm_scan_plain(
            a, bx, c), samples=3, reps=1)
        row["library_ms"] = None  # no single PyTorch call computes it
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol})"
          + (f", ms {row['ms']:.4f} (call {row['call_ms']:.4f}), "
             f"plain_ms {row['plain_ms']:.2f}, library_ms none, bound_ms "
             f"{row['bound_ms']:.4f} ({row['bound_by']})" if timed else ""))
    return row


# -- phases 4 and 5 -----------------------------------------------------------

def run_prefill(torch, ops, cfg, params, flags, make_prefill_step):
    b, s = 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :128]})  # warm-up (cuBLAS, build)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()

    require(tuple(logits.shape) == (b, s, cfg.vocab_size),
            f"prefill logits shape {tuple(logits.shape)}")
    require(torch.isfinite(logits).all().item(), "prefill logits not finite")
    n_layers = cfg.n_layers
    require(counts["flash_attention"] == n_layers,
            f"prefill: {counts['flash_attention']} flash_attention launches, "
            f"expected {n_layers}")
    require(counts["rmsnorm_pipelined"] == 2 * n_layers + 1,
            f"prefill: {counts['rmsnorm_pipelined']} rmsnorm launches, "
            f"expected {2 * n_layers + 1}")

    with flags(force_plain=True):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    err = (logits - plain).abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    rel_tol = 2e-2
    print(f"  prefill B{b} S{s}: {seconds:.3f} s, launches {counts}, "
          f"logits max|kernel-plain| {err:.4f} of max|logit| {scale:.2f} "
          f"(tol {rel_tol:g} x max|logit|), top-1 agreement {top1:.5f}")
    require(err <= rel_tol * scale,
            f"prefill: kernel vs plain logits differ by {err}")
    require(top1 >= 0.99, f"prefill: top-1 agreement {top1} < 0.99")
    return {"B": b, "S": s, "seconds": seconds, "launches": counts,
            "max_abs_err": err, "max_abs_logit": scale, "top1": top1}


def run_serve(torch, np, ops, cfg, params, ServeEngine, Request, gpu_name):
    slots, max_len, n_req, new = 8, 1024, 12, 32
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             size=int(rng.integers(16, 65)))]
               for _ in range(n_req)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    engine = ServeEngine(cfg, params, slots, max_len)
    for r in reqs:
        engine.submit(r)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mid_stream = []
    t0 = time.perf_counter()
    while engine.active:
        engine.tick()
        # a request admitted this tick sits at pos 1 while a neighbour is
        # further on: admitted mid-stream into a reused slot
        for slot in engine.slots:
            if slot.request is not None and slot.pos == 1 and any(
                    o.request is not None and o.pos > 1
                    for o in engine.slots):
                mid_stream.append(slot.request)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        require(r.done and len(r.generated) == new,
                f"request {r.rid}: {len(r.generated)} tokens, done={r.done}")
    require(counts["rmsnorm_pipelined"] == (2 * cfg.n_layers + 1) *
            engine.ticks, f"serve: {counts['rmsnorm_pipelined']} rmsnorm "
            f"launches over {engine.ticks} ticks")
    require(mid_stream, "serve: no request was admitted mid-stream")

    late = mid_stream[-1]
    solo_engine = ServeEngine(cfg, params, slots, max_len)
    solo = Request(rid=late.rid, prompt=list(late.prompt),
                   max_new_tokens=late.max_new_tokens)
    solo_engine.submit(solo)
    solo_engine.run()
    require(solo.generated == late.generated,
            f"serve: request {late.rid} admitted mid-stream gave "
            f"{late.generated[:8]}..., alone {solo.generated[:8]}...")

    tokens = sum(len(r.generated) for r in reqs)
    fed = sum(len(r.prompt) for r in reqs)
    print(f"  {cfg.name} serve on {gpu_name}: {n_req} requests, {slots} "
          f"slots, {engine.ticks} ticks, {seconds:.3f} s, {tokens} new tokens "
          f"({tokens / seconds:.1f} tokens/s; {fed} prompt tokens fed by "
          f"decode), {seconds / engine.ticks * 1e3:.3f} ms/tick, peak "
          f"memory {peak / 2**30:.3f} GiB, launches {counts}; request "
          f"{late.rid} admitted mid-stream equals its solo run")
    return {"requests": n_req, "slots": slots, "ticks": engine.ticks,
            "seconds": seconds, "new_tokens": tokens, "prompt_tokens": fed,
            "tokens_per_s": tokens / seconds,
            "ms_per_tick": seconds / engine.ticks * 1e3,
            "peak_bytes": peak, "launches": counts,
            "mid_stream_rids": [r.rid for r in mid_stream]}


# -- phases 6 and 8 -----------------------------------------------------------

def run_hybrid_prefill(torch, ops, cfg, params, flags, make_prefill_step,
                       init_params):
    """hymba-1.5b prefill, B 2 x S 2048 (twice the 1024-token window, so
    K1's band is exercised).

    The main path runs in the config's bf16 with the launch counts reset
    just before it.  In f32 the kernel path is held against the
    forced-plain path at 2e-3 of the largest logit (the card has measured
    1.6e-4) with top-1 agreement >= 0.99, and the kernel path with the
    window one key short must fall outside that limit: the check sees a
    band off by one key.  Phase 4's rule cannot hold in bf16: bf16 moves
    random-weight hymba's logits by more than 2e-2 of the largest under any
    change in the order of rounding, and the JAX package's bf16 model and
    the port's differ by more already at 8 layers
    (`tests/test_torch_drift.py`).  So each bf16 path is held against the
    f32 plain path on the same weights unrounded (`init_params` draws in
    f32 and casts): the kernel path's mean abs error may be at most 1.1x
    the plain path's, and its top-1 agreement at most 0.02 lower (the card
    has measured 0.998x and 0.004 higher; the JAX package's and the port's
    bf16 drifts from f32 differ by at most 2% in mean and 0.01 in top-1).
    That gate is for gross faults: the card has measured a window ignored
    outside it (1.19x, 0.039 lower) and a window one key short inside it,
    and both are printed beside."""
    b, s = 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :128]})  # warm-up (cuBLAS)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kernel16 = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(tuple(kernel16.shape) == (b, s, cfg.vocab_size),
            f"hybrid prefill logits shape {tuple(kernel16.shape)}")
    require(torch.isfinite(kernel16).all().item(),
            "hybrid prefill logits not finite")
    expect = {"flash_attention": cfg.n_layers,
              "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
              "ssm_scan": cfg.n_layers}
    require(counts == expect, f"hybrid prefill: launches {counts}, "
            f"expected {expect}")
    print(f"  {cfg.name} bf16 prefill B{b} S{s}: {seconds:.3f} s, launches "
          f"{counts}")
    profile = profile_prefill(torch, prefill, params, tokens)
    with flags(force_plain=True):
        plain16 = prefill(params, {"tokens": tokens})
    # faulty bands: one key short, and the window ignored (S keys)
    short, full = (make_prefill_step(replace(cfg, window=w))(
        params, {"tokens": tokens}) for w in (cfg.window - 1, s))

    cfg32 = replace(cfg, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        0))
    prefill32 = make_prefill_step(cfg32)
    t0 = time.perf_counter()
    kernel32 = prefill32(params32, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds32 = time.perf_counter() - t0
    with flags(force_plain=True):
        plain32 = prefill32(params32, {"tokens": tokens})
    short32 = make_prefill_step(replace(cfg32, window=cfg.window - 1))(
        params32, {"tokens": tokens})
    torch.cuda.synchronize()
    require(torch.isfinite(kernel32).all().item(),
            "hybrid f32 prefill logits not finite")

    scale = plain32.abs().max().item()

    def against(x, ref):
        diff = (x - ref).abs()
        top1 = (x.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return diff.max().item(), diff.mean().item(), top1

    err, _, top1 = against(kernel32, plain32)
    short_err, _, short_top1 = against(short32, plain32)
    rel_tol = 2e-3
    print(f"  {cfg.name} f32 prefill B{b} S{s}: {seconds32:.3f} s; logits "
          f"max|kernel-plain| {err:.3e} of max|logit| {scale:.3f} (tol "
          f"{rel_tol:g} x max|logit|), top-1 agreement {top1:.5f}; window "
          f"{cfg.window - 1} (one key short): {short_err:.3e}, top-1 "
          f"{short_top1:.5f}")
    require(err <= rel_tol * scale,
            f"hybrid prefill: kernel vs plain logits differ by {err}")
    require(top1 >= 0.99, f"hybrid prefill: top-1 agreement {top1} < 0.99")
    require(short_err > rel_tol * scale,
            f"hybrid prefill: a window one key short moves the f32 logits "
            f"by {short_err}, within the tolerance: the check cannot see it")

    drift = {"kernel": against(kernel16, plain32),
             "plain": against(plain16, plain32),
             "kernel_vs_plain": against(kernel16, plain16),
             "window_short": against(short, plain32),
             "window_ignored": against(full, plain32)}
    (_, p_mean, p_top1) = drift["plain"]

    def gate(name):
        _, mean, t1 = drift[name]
        return mean <= 1.1 * p_mean and t1 >= p_top1 - 0.02

    for name, (mx, mean, t1) in drift.items():
        print(f"  bf16 {name.replace('_', ' ')}"
              f"{'' if name == 'kernel_vs_plain' else ' vs f32 plain'}: "
              f"max {mx:.4f}, mean {mean:.5f} of max|logit| {scale:.3f}, "
              f"top-1 {t1:.5f}" + (f"; within the bf16 gate: {gate(name)}"
                                   if name.startswith("window") else ""))
    (_, k_mean, k_top1) = drift["kernel"]
    require(gate("kernel"), f"hybrid bf16 prefill: kernel path mean error "
            f"{k_mean}, top-1 {k_top1} vs f32; plain path {p_mean}, "
            f"{p_top1}")
    return {"B": b, "S": s, "seconds": seconds, "launches": counts,
            "profile": profile, "f32_seconds": seconds32,
            "max_abs_err": err, "max_abs_logit": scale, "top1": top1,
            "window_short_f32": {"max": short_err, "top1": short_top1},
            "bf16_drift": {k: dict(zip(("max", "mean", "top1"), v))
                           for k, v in drift.items()},
            "bf16_gate": {k: gate(k) for k in drift
                          if k not in ("plain", "kernel_vs_plain")}}


def device_time(torch, prof, wall_us: float, top: int = 10):
    """Busy time (the union of the device's activity intervals), idle share
    against `wall_us`, and the largest kernels by summed device time."""
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, reach = 0.0, -float("inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return device, busy_us, sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:top]


def profile_prefill(torch, prefill, params, tokens):
    """`torch.profiler` over one prefill: device busy time and idle share
    of the host-clock wall, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device, busy_us, top = device_time(torch, prof, wall_us)
    row = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": (1 - busy_us / wall_us) if device else None,
           "device_activities": len(device),
           "top_device_ms": {n: t / 1e3 for n, t in top}}
    if not device:
        print("  prefill profile: the profiler saw no device activity; "
              "device idle share not measured")
        return row
    print(f"  prefill profile (one bf16 prefill): {row['wall_ms']:.3f} ms "
          f"wall, device busy {row['device_busy_ms']:.3f} ms, idle share "
          f"{row['device_idle_share']:.4f}, {len(device)} device "
          f"activities")
    for name, ms in row["top_device_ms"].items():
        print(f"    {ms:.4f} ms  {name[:100]}")
    return row


def run_ring_wrap(torch, np, ops, cfg, ServeEngine, Request, forward,
                  init_params):
    """One request of 1100 prompt tokens fed by decode through a ring of
    min(max_len 1152, window 1024) = 1024 entries, so its last positions
    overwrite the ring's oldest; its logits at each of the last 8 positions
    against `forward` over the same tokens through the kernels (K1 with the
    window, K4).  Full width, depth cut to 2 layers so the 1100 ticks fit
    the time limit, f32.  Tolerance 2e-5 of the largest logit: the same f32
    model, but decode takes a product per token and the plain recurrence
    where prefill takes one product over the sequence, K1 and K4, summed in
    other orders (the card has measured 3.3e-6).  A ring one entry short or
    long must fall outside it: `forward` with a window of 1023 and of 1025
    keys is held to the decoded logits too, and must differ by more (phase
    8's CPU counterpart, `tests/test_torch_hybrid.py`, holds decode past
    the window to the reference at 1e-4)."""
    cfg = replace(cfg, n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_prompt, max_len, last = 1100, 1152, 8
    rng = np.random.default_rng(8)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                           size=n_prompt)]
    engine = ServeEngine(cfg, params, batch_slots=1, max_len=max_len)
    ring = engine.state["groups"][0]["kv"]["k"].shape[2]
    require(ring == cfg.window, f"ring of {ring} entries, expected "
            f"{cfg.window}")
    req = Request(rid=0, prompt=prompt, max_new_tokens=1)
    engine.submit(req)
    decoded = []
    t0 = time.perf_counter()
    while engine.active:
        engine.tick()
        if engine.ticks > n_prompt - last:
            decoded.append(engine.last_logits[0].clone())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(engine.ticks == n_prompt and len(decoded) == last,
            f"ring: {engine.ticks} ticks, {len(decoded)} logits kept")
    ops.reset_launch_counts()
    # chunk 100 divides 1100; it matters only to the plain path
    full, _ = forward(params, cfg, torch.tensor([prompt], device="cuda"),
                      chunk=100)
    counts = ops.launch_counts()
    require(counts["flash_attention"] == cfg.n_layers and
            counts["ssm_scan"] == cfg.n_layers,
            f"ring: forward launches {counts}")
    expect = full[0, n_prompt - last:]
    got = torch.stack(decoded)
    scale = expect.abs().max().item()
    err = (got - expect).abs().max().item()
    same_top1 = bool((got.argmax(-1) == expect.argmax(-1)).all().item())
    off = {}  # a ring one entry short or long
    for w in (cfg.window - 1, cfg.window + 1):
        other, _ = forward(params, replace(cfg, window=w),
                           torch.tensor([prompt], device="cuda"), chunk=100)
        off[w] = (got - other[0, n_prompt - last:]).abs().max().item()
    rel_tol = 2e-5
    print(f"  ring wrap ({cfg.n_layers} layers, f32, ring {ring}): "
          f"{n_prompt} ticks in {seconds:.3f} s; logits at positions "
          f"{n_prompt - last}..{n_prompt - 1} max|decode-forward| "
          f"{err:.3e} of max|logit| {scale:.3f} (tol {rel_tol:g} x "
          f"max|logit|), same top-1: {same_top1}; against forward with "
          + ", ".join(f"window {w}: {e:.3e}" for w, e in off.items()))
    require(err <= rel_tol * scale,
            f"ring: decode vs forward logits differ by {err}")
    require(same_top1, "ring: decode and forward disagree on a top-1")
    require(min(off.values()) > rel_tol * scale,
            f"ring: a window one key off gives {off}, within the "
            f"tolerance: the check cannot see it")
    return {"layers": cfg.n_layers, "ring": ring, "ticks": engine.ticks,
            "seconds": seconds, "max_abs_err": err, "max_abs_logit": scale,
            "window_off_by_one_err": {str(w): e for w, e in off.items()},
            "forward_launches": counts}


def profile_decode(torch, np, cfg, params, ServeEngine, Request, ticks: int):
    """Device busy and idle share of steady decode ticks: 8 slots full,
    `torch.profiler` over `ticks` ticks after 8 warm-up ticks.  Busy time is
    the union of the device's activity intervals (kernels, copies, sets);
    idle share is 1 - busy / wall, wall on the host clock from a synchronize
    before the window to one after it."""
    from torch.profiler import ProfilerActivity, profile

    slots = 8
    rng = np.random.default_rng(5)
    engine = ServeEngine(cfg, params, slots, 1024)
    for i in range(slots):
        engine.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, size=16)], max_new_tokens=ticks + 16))
    for _ in range(8):
        engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device, busy_us, top = device_time(torch, prof, wall_us, top=8)
    row = {"ticks": ticks, "wall_ms_per_tick": wall_us / ticks / 1e3,
           "device_busy_ms_per_tick": busy_us / ticks / 1e3,
           "device_idle_share": (1 - busy_us / wall_us) if device else None,
           "device_activities_per_tick": len(device) / ticks,
           "top_device_ms_per_tick": {n: t / ticks / 1e3 for n, t in top}}
    if not device:
        print(f"  decode profile: the profiler saw no device activity over "
              f"{ticks} ticks; device idle share not measured")
        return row
    print(f"  decode profile over {ticks} steady ticks (8 slots full): "
          f"{row['wall_ms_per_tick']:.3f} ms/tick wall, device busy "
          f"{row['device_busy_ms_per_tick']:.3f} ms/tick, idle share "
          f"{row['device_idle_share']:.4f}, "
          f"{row['device_activities_per_tick']:.1f} device activities/tick")
    for name, ms in row["top_device_ms_per_tick"].items():
        print(f"    {ms:.4f} ms/tick  {name[:100]}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"),
                    help="where to write the detailed results")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card only", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import forward, init_params
    from repro_torch.models.flags import flags
    from repro_torch.runtime import make_prefill_step

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    gpu_name = torch.cuda.get_device_name(0)
    print(f"phase 1: {gpu_name} ({smi}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # phase 2
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 2: built {_build.library_path().name} from "
          f"{[p.name for p in _build.sources()]} in {build_s:.1f} s")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())

    # phase 3
    print("phase 3: kernels against their plain versions")
    fa = [check_flash_attention(torch, ops, F, "bfloat16", timed=True),
          check_flash_attention(torch, ops, F, "float32", timed=True),
          # hymba-1.5b's prefill: B 2 x S 2048, 25 / 5 heads, window 1024
          check_flash_attention(torch, ops, F, "bfloat16", timed=True, b=2,
                                s=2048, h=25, kv=5, window=1024)]
    for dt in ("bfloat16", "float32"):
        fa += [check_flash_attention(torch, ops, F, dt, window=256),
               check_flash_attention(torch, ops, F, dt, block_q=64,
                                     block_k=32),
               check_flash_attention(torch, ops, F, dt, block_q=32,
                                     block_k=128),
               check_flash_attention(torch, ops, F, dt, s=1000)]
    # rows of a decode tick (8 slots) and of a prefill (4096 tokens) at
    # qwen2-0.5b's width and at hymba-1.5b's
    rms = [check_rmsnorm(torch, ops, F, dt, r, d)
           for d in (896, 1600) for r in (8, 4096)
           for dt in ("bfloat16", "float32")]
    # the main path's shape first: hymba prefill, a/bx/c in f32 as the
    # model makes them
    scan = [check_ssm_scan(torch, ops, "float32", timed=True),
            check_ssm_scan(torch, ops, "bfloat16", timed=True),
            check_ssm_scan(torch, ops, "float32", s=1000)]
    scan += [check_ssm_scan(torch, ops, dt, s=s, din=din, n=n)
             for s, din, n in ((32, 128, 8), (64, 256, 16))
             for dt in ("float32", "bfloat16")]

    # phases 4 and 5
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"phase 4: prefill, {ARCH} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}, random weights from seed 0)")
    prefill = run_prefill(torch, ops, cfg, params, flags, make_prefill_step)
    print("phase 5: continuous-batching serve")
    serve = run_serve(torch, np, ops, cfg, params, ServeEngine, Request,
                      gpu_name)
    serve["decode_profile"] = profile_decode(
        torch, np, cfg, params, ServeEngine, Request, ticks=20)
    del params
    torch.cuda.empty_cache()

    # phases 6, 7 and 8
    hcfg = get_config(HYBRID_ARCH)
    hparams = init_params(hcfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(hparams))
    print(f"phase 6: prefill, {HYBRID_ARCH} at full width ({hcfg.n_layers} "
          f"hybrid layers, d_model {hcfg.d_model}, {hcfg.n_heads} heads / "
          f"{hcfg.n_kv_heads} KV heads, window {hcfg.window}, d_inner "
          f"{hcfg.ssm_expand * hcfg.d_model}, N {hcfg.ssm_state}, "
          f"{n_params / 1e9:.3f} B parameters, {hcfg.dtype}, random weights "
          f"from seed 0)")
    hprefill = run_hybrid_prefill(torch, ops, hcfg, hparams, flags,
                                  make_prefill_step, init_params)
    print(f"phase 7: continuous-batching serve, {HYBRID_ARCH}")
    hserve = run_serve(torch, np, ops, hcfg, hparams, ServeEngine, Request,
                       gpu_name)
    hserve["decode_profile"] = profile_decode(
        torch, np, hcfg, hparams, ServeEngine, Request, ticks=20)
    del hparams
    torch.cuda.empty_cache()
    print(f"phase 8: sliding-window ring wrap, {HYBRID_ARCH}")
    ring = run_ring_wrap(torch, np, ops, hcfg, ServeEngine, Request, forward,
                         init_params)

    main_fa, main_rms = fa[0], rms[2]  # bf16 at qwen2-0.5b's prefill
    main_scan = scan[0]  # f32 a/bx/c at hymba's prefill shape
    main_runs = (prefill, serve, hprefill, hserve)
    kernels = [
        {"name": "flash_attention", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:99",
         "launches": sum(r["launches"]["flash_attention"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in fa),
         "ms": main_fa["ms"], "plain_ms": main_fa["plain_ms"],
         "bound_ms": main_fa["bound_ms"], "bound_by": main_fa["bound_by"],
         "library_ms": main_fa["library_ms"]},
        {"name": "rmsnorm_pipelined", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:90",
         "launches": sum(r["launches"]["rmsnorm_pipelined"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in rms),
         "ms": main_rms["ms"], "plain_ms": main_rms["plain_ms"],
         "bound_ms": main_rms["bound_ms"], "bound_by": main_rms["bound_by"],
         "library_ms": main_rms["library_ms"]},
        {"name": "ssm_scan", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:38",
         "launches": sum(r["launches"]["ssm_scan"] for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in scan),
         "ms": main_scan["ms"], "plain_ms": main_scan["plain_ms"],
         "bound_ms": main_scan["bound_ms"],
         "bound_by": main_scan["bound_by"], "library_ms": None},
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: no launch on the main "
                f"path")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build_s, "flash_attention": fa, "rmsnorm": rms,
        "ssm_scan": scan, "prefill": prefill, "serve": serve,
        "hybrid_prefill": hprefill, "hybrid_serve": hserve,
        "ring_wrap": ring, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
