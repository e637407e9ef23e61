#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches another's
error:
  1. the card's name and power limit, torch/CUDA versions; TF32 off;
  2. build the kernel library from src/repro_torch/csrc with nvcc; every
     instantiation of flash attention's bf16 tensor-core body, of the
     two RMSNorm kernels (by dtype, chunks a lane and, for the baseline,
     16-byte or value-by-value access), of the sLSTM scan (by dtype, batch
     rows a tile and gate columns a lane), of the chunkwise mLSTM's two
     passes and of the selective scan's fused entry (by dtype and N) must
     report 0 spill bytes, and their registers are printed;
  3. each kernel against its plain PyTorch version on the card at the
     main path's widths (qwen2-0.5b and hymba-1.5b; flash attention also at
     h2o-danube-3-4b's head dim 120, timed in bf16, and at the edges of its
     tensor-core body, each case checked to have launched the body of its
     dtype; both RMSNorm kernels also in f32 at
     h2o-danube-3-4b's D 3840 and glm4-9b's 4096, the rows their wrappers
     refused before), with its time, the plain version's, its bound and a
     library call's as a yardstick; the selective scan's fused entry
     (`ssm_scan_fused`: discretization and scan in one kernel) against
     `ssm_scan_plain` on the terms its plain version discretizes, at
     hymba-1.5b's shape with xin bf16 (a strided view, as the model hands
     it) and f32, its bound the larger of its bytes and its exponentials
     over the special-function units (`sfu_rate`), its registers, blocks
     resident an SM and waves;
  4. prefill at full qwen2-0.5b width (B 4 x S 1024) through
     `make_prefill_step`, kernel path against forced-plain path, with the
     launch counts of each kernel (every flash-attention launch on the
     tensor-core body), timed cold and once more;
  5. continuous-batching serve at full width (`ServeEngine`, 8 slots,
     12 requests), a mid-stream admission against a solo run; then a
     `torch.profiler` window of 20 steady decode ticks and the device's
     idle share in it;
  6. prefill at full hymba-1.5b width (B 2 x S 2048, past the 1024-token
     window): the bf16 main path with its launch counts (flash attention on
     the tensor-core body) and a
     `torch.profiler` pass over it, then the kernel path against the
     forced-plain path in f32, and what a window one key short gives;
  7. continuous-batching serve of hymba-1.5b at full width, as phase 5;
  8. the sliding-window ring cache on the card: hymba-1.5b at full width,
     depth cut to 2 layers, f32, one request of 1100 prompt tokens fed by
     decode through a 1024-entry ring, its last 8 logits against `forward`
     (and against `forward` with a window one key short or long);
  9. the baseline RMSNorm kernel (K3) against its plain version at D 896
     and 1600, R 8 and 4096, f32 and bf16, and against the pipelined one
     (K2) bit for bit, timed beside K2 and `F.rms_norm`, with the eager
     cost of a call to each;
 10. the paper's baseline-vs-pipelined RMSNorm study on the card's own
     code: the PTX of csrc/rmsnorm.cu through `repro_torch.core`'s PTX
     front-end, both kernels diagnosed on `nvidia_h100_sxm` at the
     instantiations bf16 D 896 takes (the pipelined one must show
     `mem_waitcnt` edges at its `cp.async.wait_group` line, the baseline
     none and no `cp.async`), then both kernels through their entry
     points;
 11. the LEO loop at full qwen2-0.5b width: `loss_fn` (B 4 x S 1024, bf16)
     under attention_impl="plain" and "kernel" on the card, on the weights
     and batches of every seed of LOSS_SEEDS, each loss held to the f32 loss
     by a limit drawn from the spread of right attentions on those seeds,
     and K1 with its causal band one key off outside the limit where the
     loss can see it (the rule is at LOSS_FACTOR); the first seed's programs
     captured and diagnosed on `nvidia_h100_sxm` and held to the four cases
     of `tests/test_system.py::TestLeoGuidedLoop`; LEO's estimate beside
     the measured time, and the card's copy and bf16 matmul rates;
 12. the chunkwise mLSTM (K5) and sLSTM scan (K6) kernels against their
     plain versions at the reference's test grids and at xlstm-125m's
     prefill shapes, f32 and bf16, with times and bounds: K6's time a
     step; K5's two launches timed apart, and K5 bf16 also on inputs
     rotated past the 50 MB L2;
 13. prefill at full xlstm-125m width (12 layers: 9 mLSTM, 3 sLSTM; B 4 x
     S 1024): the bf16 main path with its launch counts (exactly 9 K5 and
     3 K6) and a `torch.profiler` pass over it, then the kernel path
     against the forced-plain path in f32, and what K5 fed `log_f` one
     step late gives;
 14. continuous-batching serve of xlstm-125m at full width, as phase 5;
 15. the train step at full qwen2-0.5b width (B 4 x S 1024, bf16,
     `TrainOptions()`: remat "group", chunk 512), batches from the port's
     `DataPipeline`: first one step's gradients in f32, the kernel path
     against the forced-plain path, held to a limit drawn from the right
     paths' spread in the same run (GRAD_FACTOR), with K1's output cut
     off from autograd and a backward whose band is one key off outside
     it (bf16 printed, not gated), every leaf given a gradient; then
     TRAIN_STEPS steps, each launching K1 48 and K2 97 times, the loss,
     grad norm and lr_scale of each, a held batch's loss falling, ms a
     step, tokens/s, peak memory and one profiled step;
 16. the train driver, `repro_torch.launch.train.main`, at phase 15's
     sizes: 4 steps twice without a checkpoint (the first also with
     `--analyze`: the whole step captured on the card and diagnosed on
     `nvidia_h100_sxm`), 2 steps saved through the async checkpoint
     manager, then `--restore` on to step 4; the resumed losses held to
     the uninterrupted run's within RESTORE_FACTOR times the two
     uninterrupted runs' spread, with a restore that drops `opt/mu` and
     one that leaves `step` at 0 outside; K1 and K2 launched as in phase
     15 every step; the checkpoint's bytes, save and restore seconds and
     disk, in a directory under the output's that it removes;
 17. LEO's upper tiers on the card's programs: phase 11's captured
     `loss_plain` and `loss_kernel` and phase 10's PTX of K2 and K3, each
     through the advisor and the rewrite loop on `nvidia_h100_sxm` (the
     identity replay equal to the baseline, every rewrite a typed skip or
     the printer's refusal of a Module it cannot emit) and through
     `LeoService.diagnose` with advise (the advice recorded, the Diagnosis
     unchanged by a JSON round trip), the top advice printed beside the
     card's measured times; then
     `python -m repro_torch.launch.analysis_server --smoke` in a fresh
     process (exit 0) and `LeoHttpd` with `LeoClient` over the three demo
     traces, the wire's Diagnosis equal to the in-process one;
 18. musicgen-medium (48 layers, GELU MLP, embeddings in), internvl2-2b
     (24 layers, embeddings in), phi3.5-moe (8 of its 32 layers, MoE) and
     deepseek-v2 (4 of its 60, MLA + MoE) at full width
     (SLICE_ARCHS): each one's bf16 prefill (B 4 x S 1024) through
     `make_prefill_step` with exact K1 and K2 launch counts
     (SLICE_LAUNCHES); the kernel path against the forced-plain path in
     f32 at the same depth (phase 6's rule), K1's band one key off outside
     it, and each bf16 path against the f32 plain path (phase 6's bf16
     gate; phase 4's numbers printed), the bf16 kernel path with K1's band
     one key off outside that gate;
     the MoE configurations with every MoE layer's routing probed on its
     own input and each flip explained by its top-k margin, the plain path
     following the kernel path's routing (`probe_routing`,
     `follow_routing`); continuous-batching serve of each (K2 launches a
     tick exact, a mid-stream admission equal to its solo run);
     deepseek-v2's absorbed MLA decode after prefill against `forward`
     (2e-5 of the largest logit, the reference's `wkv_b` layout outside);
     LEO on phi3.5-moe's loss (4 layers) on `nvidia_h100_sxm`, its MoE
     scatter-adds MEMORY_STORE.  Phase 3 also times K1 and K2 at these
     shapes;
 19. hymba-1.5b at full width (B 2 x S 2048) under the SSM's default form
     (a/bx materialised, K4's `ssm_scan`) and its fused form
     (`ssm_fused=True, ssm_pallas=True`, K4's `ssm_scan_fused`): each bf16
     prefill with exact launch counts, its profiled busy ms and peak
     memory; in f32 the fused kernel path against the forced-plain path
     (phase 6's rule), the fused entry fed `bsel` one step late outside
     it, and the fused kernel path against the default one; then each
     form's loss at FUSED_LEO_LAYERS layers timed, captured and diagnosed
     on `nvidia_h100_sxm`, the four cases of the LEO loop held (the fused
     form's memory term lower, FLOPs within 1%);
 20. the dry run (`repro_torch.launch.dryrun`) on the card's own mesh,
     `make_host_mesh(1)`: `lower_cell` on meta stand-ins for qwen2-0.5b's
     prefill (B 4 x S 1024), train step (phase 15's) and decode (8 slots
     of 1024), hymba-1.5b's prefill under the fused SSM form (B 2 x S
     2048, phase 19's 8 captured layers), phi3.5-moe's (8 layers, B 4 x
     S 1024) under `moe_impl="ep_shardmap"` and phi3.5-moe's train step
     (2 layers, phase 15's B x S); each held exactly to the real
     step on the card (argument bytes, the capture of the real tensors,
     the launches against the kernel regions), its ms, roofline, LEO
     estimate, peak memory and capture seconds printed; the EP MoE against
     the global form in bf16 and f32, `sequence_parallel` bit for bit, a
     leaf of the wrong dtype failing the byte equality; then each
     argument tree's bytes a device of every config x shape x production
     mesh under the specs, and whether they fit the card;
 21. hillclimb's training cells (`launch/hillclimb.py::run_variant`) on
     the card's own mesh: qwen2-0.5b's five variants at full width and
     depth and hymba-1.5b's at phase 19's 8 layers, B 8 x S 1024 on the
     reference's single-pod micro-batch counts (2, 4), each captured in
     one of 7 spawned processes (the micro-batch loop one `while`),
     rooflined and diagnosed on
     nvidia_h100_sxm, then run once with the counters zeroed (regions,
     counted trip-aware, equal to the launches; ms a step by CUDA events
     beside the roofline's bound and LEO's estimate); each variant's loss
     and gradient norm within 3x the right paths' spread of the forced-plain
     baseline, two faults outside (the loop summing its first trip only,
     K1's band one key off); qwen2's flash_attention captured with the
     loop and unrolled, FLOPs, bytes and regions equal; deepseek-v2's
     five variants captured only (4 layers, 2 trips of train_4k's
     one-row micro-batch), `save_moe`'s FLOPs between `remat_none`'s and
     `ep+flash`'s.  One `{"hillclimb": [...]}` line lists every variant;
 22. MoE training at full width: phi3.5-moe on 2 of its 32 layers (2.86 B
     parameters), phase 15's B x S, its trees' bytes from the dry run's
     `argument_bytes` first: (a) phase 15's f32 gradient gate under remat
     "group" and "group_save_moe", every right path's routing probed
     against the truth's with phase 18's rule (an explained flip takes its
     layer's router and experts out of that path's gate); (b) every MoE
     layer's recomputation in the backward routed as its forward, 0
     tokens apart, f32 and bf16; (c) 10 bf16 steps twice from one state
     (the synthetic stream folded onto 256 ids, each label a fixed
     permutation of its token), ending equal bit for bit, K1 4 and K2 9
     launches a step under both policies, a held loss that falls, ms a
     step and a profiled step split into K1, K2, products, routing,
     dispatch, combine and other; (d) the
     train driver with `--layers 2` twice, its losses equal bit for bit;
 23. the per-device program of a mesh (`runtime/steps.py`): (a) on an
     NCCL group of one rank, phase 22's MoE train step and qwen2-0.5b's
     prefill at full width under `moe_impl="ep_shardmap"` and
     `sequence_parallel`, placed by the sharding rules (`place`) and run
     by `shard_step`, bit for bit the one-card step's, K1 and K2 launched
     alike; (b) in a child process, qwen2-0.5b train_4k's per-device
     program on the 16x16 mesh behind the fake process group, at 1
     layer: the roofline's three terms and the collective bytes by kind
     (LEO's model, not card times); (c) where four cards exist, four NCCL
     ranks on a (2, 2) mesh, qwen2-0.5b's f32 step (2 layers) within 3x
     the one-card right paths' spread, else "4-rank: not run".
The last line is `{"ok": true, "device": {...}}`; the line before it lists
every kernel.  Details go to chiprun_out/chip_smoke.json.

Without a CUDA device, or without src/repro_torch beside this file, it exits
with status 1 and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (dense): the roofline of `bound_ms`.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20  # the H100's L2
ARCH = "qwen2-0.5b"
HYBRID_ARCH = "hymba-1.5b"
XLSTM_ARCH = "xlstm-125m"
# Phase 11: the loss gate, at full qwen2-0.5b width (B 4 x S 1024), on the
# random weights and batch of every seed in LOSS_SEEDS; none is dropped.
# The truth on each seed is the f32 loss (attention_impl="plain").  The
# rule: the kernel's gap from it may be at most LOSS_FACTOR times the
# largest gap, over all the seeds, of the right attentions that are not the
# kernel, measured in the same run; so a right K1 passes by construction.
# It is applied at two levels:
#   * the LEO loop's bf16 program: the right attentions are the plain path
#     and K1's plain version at the call site;
#   * the f32 model with q, k and v rounded to bf16 at the call site, so
#     K1's bf16 body runs and its output returns in f32: the right attention
#     is K1's plain version on the same rounded inputs.  K1 with its causal
#     band one key off must fall outside this limit on every seed.
# The card (NVIDIA H100 80GB HBM3, 700.00 W, seeds 0-9; PERF.md section 6)
# read, in the bf16 program, gaps of up to 4.46e-2 for the right attentions
# other than K1 and 6.02e-2 for K1 (limit 0.134), while the band one key
# off moved the loss by as little as 3.55e-2 (seed 6): logits near 600
# carry a bf16 step of 4, and no limit separates the two there, so that
# level's fault is printed beside its limit, not gated.  With only the
# attention in bf16 the right gaps reached 2.32e-3, K1's 1.83e-3 (limit
# 6.96e-3), and the fault moved the loss by at least 4.43e-2 (seed 6).
# The factor 3 leaves room for K1's gap, one more draw of the same
# rounding noise: it read 1.35x the others' largest in the bf16 program and
# 0.79x with the attention alone.  Two seeds that happened to read small
# gaps (the old gate: 1e-2 on seeds 0 and 1) are not a rule.
LOSS_FACTOR = 3.0
LOSS_SEEDS = tuple(range(10))


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


def attention_pairs(s: int, window, causal: bool = True) -> int:
    """(query, key) pairs inside the band: keys up to the query (causal) or
    to S - 1, and after query - window."""
    total = 0
    for qpos in range(s):
        lo = 0 if window is None else max(0, qpos - window + 1)
        total += (qpos + 1 if causal else s) - lo
    return total


# -- phases 2 and 3 -----------------------------------------------------------

def ptxas_report(log: str, marker: str):
    """Registers and spill bytes (stores + loads) of each function in the
    compiler's `-Xptxas -v` output whose mangled name holds `marker`,
    keyed by its template arguments: the element type where there is one,
    then the integers and booleans (`ILi64ELi32E` -> "64,32",
    `I13__nv_bfloat16Li4ELb1E` -> "bf16,4,1")."""
    rows, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1) if marker in found.group(1) else None
            continue
        if name is None:
            continue
        tail = name.split(marker, 1)[1]
        dtype = ["bf16"] if tail.startswith("I13__nv_bfloat16") else \
            ["f32"] if tail.startswith("If") else []
        key = ",".join(dtype + re.findall(r"L[ib](\d+)E", tail)) or name
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            rows.setdefault(key, {})["spill_bytes"] = \
                int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:  # the last line of a function's report
            rows.setdefault(key, {})["registers"] = int(regs.group(1))
            name = None
    return rows


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
                          b=4, h=14, kv=2, hd=64, causal=True):
    """K1 against `flash_attention_plain` element by element (`compare`),
    on the body of its dtype: bf16 on the tensor cores, f32 on the CUDA
    cores (`flash_attention.body_launches`)."""
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = ((0.5 * torch.randn((b, s, n, hd), generator=gen,
                                  device="cuda")).to(dtype)
               for n in (h, kv, kv))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
    body = {name: n for name, n in ops.flash_attention.body_launches.items()
            if n}
    plain = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err, within, tol = compare(out, plain, dt_name, 2e-5)
    case = (f"flash_attention {dt_name} B{b} S{s} H{h} Kv{kv} hd{hd} "
            f"window={window} block_q={block_q} block_k={block_k}"
            + ("" if causal else " not causal"))
    expect = "tensor_core" if dt_name == "bfloat16" else "cuda_core"
    require(body == {expect: 1}, f"{case}: launched {body}, not {expect}")
    require(torch.isfinite(out.float()).all().item(), f"{case}: non-finite")
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "body": expect, "max_abs_err": err, "tol": tol}
    if timed:
        flops = 4.0 * b * h * hd * attention_pairs(s, window, causal)
        nbytes = 2 * b * s * (h + kv) * hd * q.element_size()
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dt_name)
        kernel = lambda: ops.flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window, block_q=block_q,
            block_k=block_k)
        row["ms"] = time_ms(torch, kernel)
        row["call_ms"] = call_ms(torch, kernel)
        row["plain_ms"] = time_ms(torch, lambda: ops.flash_attention_plain(
            q, k, v, causal=causal, window=window), samples=11, reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
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


# the special-function unit's rate on Hopper, exponentials a clock on one SM
# (CUDA C++ Programming Guide, throughput of native arithmetic instructions,
# compute capability 9.0: base-2 exponential 16 results a clock a
# multiprocessor); the card's SM count and maximum SM clock are read
SFU_PER_CLOCK = 16


def sfu_rate(torch):
    """Exponentials a second on this card: SMs x SFU_PER_CLOCK x the
    maximum SM clock `nvidia-smi` reads."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "max_sm_mhz": mhz,
            "per_s": sms * SFU_PER_CLOCK * mhz * 1e6}


def fused_scan_inputs(torch, dt_name: str, b, s, din, n, strided=False):
    """xin (a view `xz[..., :din]` of a (B, S, 2 din) tensor when `strided`,
    as the model hands it), w_dt, a_log = log(1..N), bsel and csel, at the
    scales the model's init gives them (w_dt of unit scale; xin and the
    selections of order one)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    xz = torch.randn((b, s, 2 * din if strided else din), generator=gen,
                     device="cuda").to(getattr(torch, dt_name))
    w_dt = torch.randn((din,), generator=gen, device="cuda")
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda")).expand(din, n).contiguous()
    bsel = 0.5 * torch.randn((b, s, n), generator=gen, device="cuda")
    csel = 0.5 * torch.randn((b, s, n), generator=gen, device="cuda")
    return xz[..., :din], w_dt, a_log, bsel, csel


def check_ssm_scan_fused(torch, ops, dt_name: str, *, b=2, s=2048, din=3200,
                         n=16, strided=False, timed=False, rate=None,
                         ptxas=None):
    """K4's fused entry against `ssm_scan_plain(*discretize(xin, ...),
    csel)`, the exact sequential loop on the terms the plain version
    discretizes, held to the existing entry's 1e-4 absolute + 1e-4
    relative (the same f32 functions, the recurrence in one multiply-add,
    the readout summed in another order).  Timed: the kernel in a CUDA
    graph and eagerly, its plain version (`ssm_fused_plain`, the chunked
    form), the oracle, and its bound: the larger of the bytes (xin as
    read, w_dt, a_log, bsel, csel, y) over 3.35 TB/s and the
    exponentials (one for each a, and softplus's exp and log1p once a
    channel and step) over `rate`; and how its grid meets the card:
    registers a thread (phase 2's `ptxas`), blocks resident an SM, the
    grid's blocks and its waves."""
    from repro_torch.kernels.ssm_scan import discretize, fused_grid

    xin, w_dt, a_log, bsel, csel = fused_scan_inputs(torch, dt_name, b, s,
                                                     din, n, strided)
    out = ops.ssm_scan_fused(xin, w_dt, a_log, bsel, csel)
    a, bx = discretize(xin, w_dt, a_log, bsel)
    oracle = lambda: ops.ssm_scan_plain(a, bx, csel)  # noqa: E731
    plain = oracle()
    torch.cuda.synchronize()
    atol = rtol = 1e-4
    diff = (out - plain).abs()
    err = diff.max().item()
    within = (diff - rtol * plain.abs() - atol).max().item() <= 0
    tol = f"{atol:g} + {rtol:g}*|plain|"
    case = (f"ssm_scan_fused {dt_name} B{b} S{s} din{din} N{n}"
            + (" xin strided (row 2 din)" if strided else ""))
    require(out.dtype == torch.float32 and tuple(out.shape) == (b, s, din),
            f"{case}: out {out.dtype} {tuple(out.shape)}")
    require(torch.isfinite(out).all().item(), f"{case}: non-finite")
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    del a, bx
    if timed:
        itemsize = xin.element_size()
        nbytes = (b * s * din * itemsize + w_dt.nbytes + a_log.nbytes
                  + bsel.nbytes + csel.nbytes + out.nbytes)
        exps = b * s * din * n + 2 * b * s * din
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = exps / rate["per_s"] * 1e3
        row.update(bytes=nbytes, exponentials=exps, bytes_ms=t_bytes,
                   sfu_ms=t_ops, sfu=rate)
        row["bound_ms"], row["bound_by"] = (t_ops, "operations") \
            if t_ops > t_bytes else (t_bytes, "bytes")
        kernel = lambda: ops.ssm_scan_fused(  # noqa: E731
            xin, w_dt, a_log, bsel, csel)
        row["ms"] = time_ms(torch, kernel)
        row["call_ms"] = call_ms(torch, kernel)
        row["plain_ms"] = call_ms(torch, lambda: ops.ssm_fused_plain(
            xin, w_dt, a_log, bsel, csel), samples=3, reps=1)
        # discretization passes and the sequential loop of S steps
        row["oracle_ms"] = call_ms(torch, lambda: ops.ssm_scan_plain(
            *discretize(xin, w_dt, a_log, bsel), csel), samples=3, reps=1)
        row["library_ms"] = None  # no single PyTorch call computes it
        row["grid"] = fused_grid(xin, n)
        row["grid"]["registers"] = (ptxas or {}).get(
            f"{'bf16' if dt_name == 'bfloat16' else 'f32'},{n}",
            {}).get("registers")
        print(f"  {case}: {row['grid']['registers']} registers a thread, "
              f"{row['grid']['blocks_an_sm']} blocks an SM, "
              f"{row['grid']['grid_blocks']} blocks in the grid "
              f"({row['grid']['channels_a_block']} channels a block), "
              f"{row['grid']['waves']:.3f} waves on {row['grid']['sms']} "
              f"SMs")
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol})"
          + (f", ms {row['ms']:.4f} (call {row['call_ms']:.4f}), "
             f"plain_ms {row['plain_ms']:.3f} (chunked form; sequential "
             f"oracle {row['oracle_ms']:.2f}), library_ms none, bound_ms "
             f"{row['bound_ms']:.4f} ({row['bound_by']}: bytes "
             f"{row['bytes_ms']:.4f}, {row['exponentials']:.3e} "
             f"exponentials {row['sfu_ms']:.4f} at {rate['sms']} SMs x "
             f"{SFU_PER_CLOCK} x {rate['max_sm_mhz']:g} MHz)"
             if timed else ""))
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
    bodies = dict(ops.flash_attention.body_launches)
    # the first call at full length also grows the allocator's pool: time
    # a second one beside it
    t0 = time.perf_counter()
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    warm_seconds = time.perf_counter() - t0

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
    require(bodies == {"tensor_core": n_layers, "cuda_core": 0},
            f"prefill: flash_attention bodies {bodies}: bf16 goes to the "
            f"tensor-core body")

    with flags(force_plain=True):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    err = (logits - plain).abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    rel_tol = 2e-2
    print(f"  prefill B{b} S{s}: {seconds:.3f} s (again {warm_seconds:.4f} "
          f"s), launches {counts} (flash_attention bodies {bodies}), "
          f"logits max|kernel-plain| {err:.4f} of max|logit| {scale:.2f} "
          f"(tol {rel_tol:g} x max|logit|), top-1 agreement {top1:.5f}")
    require(err <= rel_tol * scale,
            f"prefill: kernel vs plain logits differ by {err}")
    require(top1 >= 0.99, f"prefill: top-1 agreement {top1} < 0.99")
    return {"B": b, "S": s, "seconds": seconds, "warm_seconds": warm_seconds,
            "launches": counts, "flash_attention_bodies": bodies,
            "max_abs_err": err, "max_abs_logit": scale, "top1": top1}


def norm_launches(cfg, layer_descriptors) -> int:
    """RMSNorm launches of one token through `cfg`: `ln1` of every block,
    `ln2` of every block with an FFN, the mLSTM's output norm, MLA's
    `q_norm` (where the config has a q_lora_rank) and `kv_norm`, the final
    norm."""
    mla = 1 + bool(cfg.q_lora_rank)
    return 1 + sum(1 + (ffn != "none") + (mixer == "mlstm") +
                   mla * (mixer == "mla")
                   for mixer, ffn in layer_descriptors(cfg))


def run_serve(torch, np, ops, cfg, params, ServeEngine, Request, gpu_name,
              norms: int, n_req: int = 12, new: int = 32):
    """`norms`: RMSNorm launches a decode tick (`norm_launches`)."""
    slots, max_len = 8, 1024
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
    require(counts["rmsnorm_pipelined"] == norms * engine.ticks,
            f"serve: {counts['rmsnorm_pipelined']} rmsnorm launches over "
            f"{engine.ticks} ticks, expected {norms} a tick")
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
          f"memory {peak / 2**30:.3f} GiB, launches {counts} "
          f"({counts['rmsnorm_pipelined'] / engine.ticks:g} K2 a tick); "
          f"request "
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
    bodies = dict(ops.flash_attention.body_launches)
    require(tuple(kernel16.shape) == (b, s, cfg.vocab_size),
            f"hybrid prefill logits shape {tuple(kernel16.shape)}")
    require(torch.isfinite(kernel16).all().item(),
            "hybrid prefill logits not finite")
    expect = {"flash_attention": cfg.n_layers,
              "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
              "rmsnorm_baseline": 0, "ssm_scan": cfg.n_layers,
              "ssm_scan_fused": 0, "mlstm_chunkwise": 0, "slstm_scan": 0}
    require(counts == expect, f"hybrid prefill: launches {counts}, "
            f"expected {expect}")
    require(bodies == {"tensor_core": cfg.n_layers, "cuda_core": 0},
            f"hybrid prefill: flash_attention bodies {bodies}: bf16 goes "
            f"to the tensor-core body")
    print(f"  {cfg.name} bf16 prefill B{b} S{s}: {seconds:.3f} s, launches "
          f"{counts} (flash_attention bodies {bodies})")
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
            "flash_attention_bodies": bodies,
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


# -- phases 9, 10 and 11 ------------------------------------------------------

def check_rmsnorm_baseline(torch, ops, F, dt_name: str, r: int, d: int):
    """K3 against `rmsnorm_plain` element by element at K2's tolerances
    (f32 1e-5, bf16 one bf16 step) and against K2 bit for bit, timed beside
    K2 and `F.rms_norm` on the same inputs, and the eager call of each
    kernel and of `F.rms_norm`."""
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = (0.5 * torch.randn((r, d), generator=gen, device="cuda")).to(dtype)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                     device="cuda")).to(dtype)
    out = ops.rmsnorm_baseline(x, scale)
    plain = ops.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    err, within, tol = compare(out, plain, dt_name, 1e-5)
    case = f"rmsnorm_baseline {dt_name} R{r} D{d}"
    require(torch.isfinite(out.float()).all().item(), f"{case}: non-finite")
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    # one per-lane order of the sum of squares and one shuffle tree in both
    # kernels: the same bits on every input both take
    require(torch.equal(out, ops.rmsnorm_pipelined(x, scale)),
            f"{case}: the baseline and the pipelined kernel differ")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    row["bound_ms"], row["bound_by"] = bound(4.0 * r * d, (2 * r * d + d) *
                                             x.element_size(), dt_name)
    row["ms"] = time_ms(torch, lambda: ops.rmsnorm_baseline(x, scale))
    row["pipelined_ms"] = time_ms(torch, lambda: ops.rmsnorm_pipelined(
        x, scale))
    row["plain_ms"] = time_ms(torch, lambda: ops.rmsnorm_plain(x, scale))
    row["library_ms"] = time_ms(torch, lambda: F.rms_norm(
        x, (d,), weight=scale, eps=1e-5))
    row["call_ms"] = call_ms(torch, lambda: ops.rmsnorm_baseline(x, scale))
    row["pipelined_call_ms"] = call_ms(torch, lambda: ops.rmsnorm_pipelined(
        x, scale))
    row["library_call_ms"] = call_ms(torch, lambda: F.rms_norm(
        x, (d,), weight=scale, eps=1e-5))
    row["baseline_over_pipelined"] = row["ms"] / row["pipelined_ms"]
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol}), ms {row['ms']:.4f}"
          f", pipelined ms {row['pipelined_ms']:.4f} (baseline/pipelined "
          f"{row['baseline_over_pipelined']:.3f}, the same bits), plain_ms "
          f"{row['plain_ms']:.4f}, library_ms {row['library_ms']:.4f}, "
          f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); eager call "
          f"ms: baseline {row['call_ms']:.4f}, pipelined "
          f"{row['pipelined_call_ms']:.4f}, F.rms_norm "
          f"{row['library_call_ms']:.4f}")
    return row


def run_case_study(torch, ops, core, build, csrc: Path, measured):
    """The paper's section VI-D(b) study on the card's own code: the PTX of
    csrc/rmsnorm.cu through the PTX front-end, both kernels diagnosed on
    `nvidia_h100_sxm` in bf16, each at the instantiation bf16 D 896 takes
    (`lane_chunks`: 16-byte chunks a lane; K3's 16-byte loads).  The
    pipelined kernel must show `mem_waitcnt` edges, its wait
    attributed to the `cp.async.wait_group` line of csrc/rmsnorm.cu; the
    baseline must show none.  Then the study's measured half: each kernel
    through its entry point (`rmsnorm_op`, `rmsnorm_baseline_op`) at R 4096,
    D 896, bf16, with the launch counts zeroed just before and read just
    after; LEO's estimate is printed beside the card's times."""
    from repro_torch.core.ptx_frontend import find_entry
    from repro_torch.kernels.rmsnorm import lane_chunks

    chunks = lane_chunks(896, 2)  # the instantiations bf16 D 896 launches
    t0 = time.perf_counter()
    ptx_path = build.ptx("rmsnorm.cu")
    text = ptx_path.read_text()
    ptx_s = time.perf_counter() - t0
    source_lines = (csrc / "rmsnorm.cu").read_text().splitlines()
    rows, modules = {}, {}
    for name, kernel, extra in (
            ("rmsnorm_pipelined", "rmsnorm_pipelined_kernel",
             (f"Li{chunks}E",)),
            ("rmsnorm_baseline", "rmsnorm_baseline_kernel",
             (f"Li{chunks}ELb1E",))):
        entry = find_entry(text, kernel, "bfloat16", *extra)
        t0 = time.perf_counter()
        module = modules[name] = core.from_ptx(text, entry, name=kernel)
        an = core.analyze_module(module, "nvidia_h100_sxm")
        seconds = time.perf_counter() - t0
        waits = [e for e in an.graph.edges
                 if e.kind is core.EdgeKind.MEM_WAITCNT]
        sites = sorted({(Path(w.source_file).name, w.source_line)
                        for w in (module.find(e.consumer) for e in waits)})
        stalls = {}
        for record in an.profile.records.values():
            for cls, cycles in record.stall_breakdown.items():
                stalls[cls.name] = stalls.get(cls.name, 0.0) + cycles
        rows[name] = {"entry": entry, "instructions": sum(
            1 for _ in module.all_instructions()),
            "mem_waitcnt_edges": len(waits),
            "wait_sites": [f"{f}:{n}" for f, n in sites],
            "estimated_s": an.estimated_step_seconds,
            "stall_cycles": dict(sorted(stalls.items())),
            "shared_memory_ops": sum(
                1 for i in module.all_instructions()
                if i.opcode.startswith(("ld.shared", "st.shared"))),
            "cp_async": sum(1 for i in module.all_instructions()
                            if i.opcode.startswith("cp.async")),
            "analysis_s": seconds,
            "top_chain": [f"{link.opcode} {link.source}"
                          for link in an.chains[0].links] if an.chains
            else []}
    pipe, base = rows["rmsnorm_pipelined"], rows["rmsnorm_baseline"]
    require(pipe["mem_waitcnt_edges"] >= 1, "case study: no mem_waitcnt "
            "edge in the pipelined kernel's PTX")
    for site in pipe["wait_sites"]:
        fname, line = site.rsplit(":", 1)
        require(fname == "rmsnorm.cu" and "cp.async.wait_group" in
                source_lines[int(line) - 1], f"case study: a pipelined wait "
                f"attributed to {site}, not the cp.async.wait_group line")
    require(base["mem_waitcnt_edges"] == 0, f"case study: the baseline "
            f"kernel shows {base['mem_waitcnt_edges']} mem_waitcnt edges")
    require(base["cp_async"] == 0, f"case study: the baseline kernel's PTX "
            f"holds {base['cp_async']} cp.async instructions")
    require("cp.async.wait_group 1" in text, "case study: no "
            "`cp.async.wait_group 1` in the PTX of rmsnorm.cu")

    gen = torch.Generator(device="cuda").manual_seed(10)
    x = (0.5 * torch.randn((4096, 896), generator=gen, device="cuda")).to(
        torch.bfloat16)
    scale = torch.ones((896,), device="cuda", dtype=torch.bfloat16)
    reps = 50
    ops.reset_launch_counts()
    for name, fn in (("rmsnorm_pipelined", ops.rmsnorm_op),
                     ("rmsnorm_baseline", ops.rmsnorm_baseline_op)):
        rows[name]["eager_call_ms"] = call_ms(
            torch, lambda: fn(x, scale), samples=5, reps=reps)
    counts = ops.launch_counts()
    require(counts["rmsnorm_baseline"] > 0 and
            counts["rmsnorm_pipelined"] > 0, f"case study: launches {counts}")
    print(f"  PTX of rmsnorm.cu in {ptx_s:.1f} s ({ptx_path.name})")
    for name, row in rows.items():
        row["measured_ms"] = measured[name]
        print(f"  {name} (bf16, {row['instructions']} PTX instructions laid "
              f"out): {row['mem_waitcnt_edges']} mem_waitcnt edges, waits "
              f"at {row['wait_sites'] or 'none'}; LEO estimate "
              f"{row['estimated_s'] * 1e3:.6f} ms (one warp's pass through "
              f"the laid-out code) beside {row['measured_ms']:.4f} ms "
              f"measured at R 4096 D 896 (eager call "
              f"{row['eager_call_ms']:.4f} ms); analysis "
              f"{row['analysis_s']:.2f} s; top chain {row['top_chain'][:3]}")
        print(f"    {row['shared_memory_ops']} shared-memory loads and "
              f"stores (memory operations at 0.05 of their bytes); stall "
              f"cycles by class: "
              + ", ".join(f"{k} {v:.0f}" for k, v in
                          row["stall_cycles"].items()))
    return {"kernels": rows, "launches": counts, "ptx_seconds": ptx_s,
            "modules": modules}


def shifted_keys_attention(flash_attention):
    """A known fault for phase 11's limit: K1 with its causal band one key
    off (every query also sees the next position's key and value)."""
    def faulty(q, k, v, **kwargs):
        k, v = (t.roll(-1, dims=1).contiguous() for t in (k, v))
        return flash_attention(q, k, v, **kwargs)
    return faulty


def plain_attention(flash_attention_plain):
    """K1's plain version at the models' call site (the block sizes belong
    to the kernel)."""
    def attention(q, k, v, causal=True, window=None):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return attention


def bf16_attention(torch, attention):
    """`attention` on q, k and v rounded to bf16, its output back in f32:
    in the f32 model K1 then runs its bf16 body."""
    def rounded(q, k, v, **kwargs):
        return attention(*(t.to(torch.bfloat16) for t in (q, k, v)),
                         **kwargs).float()
    return rounded


def seed_losses(torch, ops, cfg, flags, loss_fn, init_params,
                attention_module, seed: int, b: int, s: int):
    """Phase 11's losses on weights and a batch drawn from `seed`: the f32
    loss (the truth); in the f32 model with the attention in bf16, K1, its
    plain version and K1 with its band one key off; in the bf16 program the
    plain path and K1 (each after a warm-up, with the launch counts zeroed
    just before it and read just after), K1's plain version and the fault.
    Every K1 launch must be the tensor-core body."""
    gen = torch.Generator(device="cuda").manual_seed(11 + seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda")}
    real = attention_module.flash_attention
    one_body = {"tensor_core": cfg.n_layers, "cuda_core": 0}

    def loss(params, c, impl="kernel", attention=None):
        attention_module.flash_attention = attention or real
        try:
            with flags(attention_impl=impl):
                return loss_fn(params, c, batch)
        finally:
            attention_module.flash_attention = real

    cfg32 = replace(cfg, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        seed))
    f32 = {"truth": loss(params32, cfg32, "plain").item()}
    ops.reset_launch_counts()
    f32["kernel"] = loss(params32, cfg32,
                         attention=bf16_attention(torch, real)).item()
    require(ops.flash_attention.body_launches == one_body,
            f"loss seed {seed}, f32 model: flash_attention bodies "
            f"{ops.flash_attention.body_launches}, expected {one_body}")
    f32["k1_plain"] = loss(params32, cfg32, attention=bf16_attention(
        torch, plain_attention(ops.flash_attention_plain))).item()
    f32["fault"] = loss(params32, cfg32, attention=bf16_attention(
        torch, shifted_keys_attention(real))).item()
    del params32

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed))
    runs = {}
    for impl in ("plain", "kernel"):
        loss(params, cfg, impl)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        value = loss(params, cfg, impl)
        torch.cuda.synchronize()
        runs[impl] = {"loss": value.item(),
                      "seconds": time.perf_counter() - t0,
                      "launches": ops.launch_counts(),
                      "flash_attention_bodies": dict(
                          ops.flash_attention.body_launches)}
        require(math.isfinite(runs[impl]["loss"]), f"loss {impl}: not finite")
    norms = 2 * cfg.n_layers + 1
    require(runs["kernel"]["launches"]["flash_attention"] == cfg.n_layers and
            runs["kernel"]["launches"]["rmsnorm_pipelined"] == norms and
            runs["kernel"]["flash_attention_bodies"] == one_body,
            f"loss kernel: launches {runs['kernel']['launches']}, "
            f"flash_attention bodies "
            f"{runs['kernel']['flash_attention_bodies']}")
    require(runs["plain"]["launches"]["flash_attention"] == 0 and
            runs["plain"]["launches"]["rmsnorm_pipelined"] == norms,
            f"loss plain: launches {runs['plain']['launches']}")
    bf16 = {impl: run["loss"] for impl, run in runs.items()}
    bf16["k1_plain"] = loss(params, cfg, attention=plain_attention(
        ops.flash_attention_plain)).item()
    bf16["fault"] = loss(params, cfg,
                         attention=shifted_keys_attention(real)).item()
    for name, value in {**f32, **bf16}.items():
        require(math.isfinite(value), f"loss seed {seed} {name}: not finite")
    return {"runs": runs, "f32": f32, "bf16": bf16,
            "inputs": (params, batch)}


def loss_gate(seeds):
    """The limits of phase 11's rule (see LOSS_FACTOR) from the spread of
    the right attentions that are not the kernel over every seed; the gap
    of each loss from its seed's f32 truth."""
    def gap(r, level, name):
        return abs(r[level][name] - r["f32"]["truth"])
    spread = {"bf16": max(gap(r, "bf16", name) for r in seeds.values()
                          for name in ("plain", "k1_plain")),
              "f32": max(gap(r, "f32", "k1_plain") for r in seeds.values())}
    limits = {level: LOSS_FACTOR * v for level, v in spread.items()}
    gaps = {seed: {level: {name: gap(r, level, name) for name in r[level]
                           if name != "truth"}
                   for level in ("bf16", "f32")}
            for seed, r in seeds.items()}
    return spread, limits, gaps


def run_leo_loop(torch, ops, cfg, flags, loss_fn, init_params, core,
                 attention_module):
    """The LEO loop at full qwen2-0.5b width, B 4 x S 1024, bf16: the
    losses of every seed of LOSS_SEEDS (`seed_losses`) held to the rule at
    LOSS_FACTOR (`loss_gate`); then the first seed's program under each
    attention_impl captured and diagnosed on `nvidia_h100_sxm`, held to the
    four cases of `tests/test_system.py::TestLeoGuidedLoop`."""
    b, s = 4, 1024
    seeds = {}
    for seed in LOSS_SEEDS:
        seeds[seed] = seed_losses(torch, ops, cfg, flags, loss_fn,
                                  init_params, attention_module, seed, b, s)
        inputs = seeds[seed].pop("inputs")
        if seed == LOSS_SEEDS[0]:
            params, batch = inputs
        del inputs
    runs = seeds[LOSS_SEEDS[0]]["runs"]
    spread, limits, gaps = loss_gate(seeds)
    print(f"  loss B{b} S{s}, |loss - f32 loss| on seeds {LOSS_SEEDS[0]}.."
          f"{LOSS_SEEDS[-1]}: right attentions other than K1 reach "
          f"{spread['bf16']:.4e} in the bf16 program and {spread['f32']:.4e} "
          f"with the attention alone in bf16; limits {LOSS_FACTOR:g}x: "
          f"{limits['bf16']:.4e} and {limits['f32']:.4e}")
    for seed, r in seeds.items():
        g = gaps[seed]
        print(f"  seed {seed}: f32 loss {r['f32']['truth']:.6f}; bf16 "
              f"program: plain {r['bf16']['plain']:.6f} "
              f"({r['runs']['plain']['seconds'] * 1e3:.3f} ms), kernel "
              f"{r['bf16']['kernel']:.6f} "
              f"({r['runs']['kernel']['seconds'] * 1e3:.3f} ms), gaps "
              + ", ".join(f"{n} {v:.3e}" for n, v in g["bf16"].items())
              + "; attention alone in bf16, gaps "
              + ", ".join(f"{n} {v:.3e}" for n, v in g["f32"].items()))
        require(g["bf16"]["kernel"] <= limits["bf16"],
                f"loss seed {seed}: the bf16 program through K1 is "
                f"{g['bf16']['kernel']} from the f32 loss, beyond "
                f"{limits['bf16']}")
        require(g["f32"]["kernel"] <= limits["f32"],
                f"loss seed {seed}: K1's bf16 body in the f32 model is "
                f"{g['f32']['kernel']} from the f32 loss, beyond "
                f"{limits['f32']}")
        require(g["f32"]["fault"] > limits["f32"],
                f"loss seed {seed}: a band one key off moves the loss by "
                f"{g['f32']['fault']}, within {limits['f32']}: the check "
                f"cannot see it")
    faults_inside = [seed for seed in seeds
                     if gaps[seed]["bf16"]["fault"] <= limits["bf16"]]
    print(f"  band one key off inside the bf16 program's limit (printed, "
          f"not gated: no limit separates there) on seeds {faults_inside}")

    backend = core.get_backend("nvidia_h100_sxm")
    diag, modules = {}, {}
    for impl in ("plain", "kernel"):
        t0 = time.perf_counter()
        with flags(attention_impl=impl):
            module = modules[f"loss_{impl}"] = core.capture(
                lambda p, bt: loss_fn(p, cfg, bt), params, batch,
                name=f"loss_{impl}")
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        an = core.analyze_module(module, backend)
        analysis_s = time.perf_counter() - t0
        roof = core.compute_roofline(module, backend.hw, chips=1, label=impl)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ctx = core.diagnostic_context("C+L(S)", "loss_fn", an)
        scoped = [link for c in an.chains for link in c.links
                  if link.op_name]
        diag[impl] = {
            "instructions": sum(1 for _ in module.all_instructions()),
            "kernel_regions": module.kernel_calls,
            "capture_s": capture_s, "analysis_s": analysis_s,
            "estimated_step_s": an.estimated_step_seconds,
            "measured_s": runs[impl]["seconds"],
            "memory_s": roof.memory_s, "compute_s": roof.compute_s,
            "hlo_flops": roof.hlo_flops, "hlo_bytes": roof.hlo_bytes,
            "coverage": [an.coverage_before.coverage,
                         an.coverage_after.coverage],
            "chains": len(an.chains), "scoped_links": len(scoped),
            "recommendations": "Recommendations" in ctx,
            "top_chain": [f"{link.opcode} {link.source}"
                          for link in an.chains[0].links] if an.chains
            else []}
        d = diag[impl]
        print(f"  {impl}: captured {d['instructions']} instructions "
              f"(regions {d['kernel_regions']}) in {capture_s:.2f} s, "
              f"diagnosed in {analysis_s:.2f} s; LEO estimated step "
              f"{d['estimated_step_s'] * 1e3:.3f} ms beside "
              f"{d['measured_s'] * 1e3:.3f} ms measured; roofline memory "
              f"{d['memory_s'] * 1e3:.3f} ms, compute "
              f"{d['compute_s'] * 1e3:.3f} ms; coverage "
              f"{d['coverage'][0]:.4f} -> {d['coverage'][1]:.4f}; "
              f"{d['chains']} chains, top {d['top_chain'][:2]}")
        require(an.chains or an.blame.occupancy_blame,
                f"loop {impl}: LEO produced no diagnosis")
        require(scoped, f"loop {impl}: no chain carries an op_name scope")
        require(d["coverage"][1] >= d["coverage"][0],
                f"loop {impl}: coverage degraded {d['coverage']}")
        require(d["recommendations"], f"loop {impl}: no Recommendations")
    require(diag["plain"]["kernel_regions"].get("flash_attention", 0) == 0
            and diag["kernel"]["kernel_regions"].get("flash_attention") ==
            cfg.n_layers, f"loop: regions {diag['plain']['kernel_regions']}"
            f" / {diag['kernel']['kernel_regions']}")
    require(diag["kernel"]["memory_s"] < diag["plain"]["memory_s"],
            f"loop: memory term {diag['plain']['memory_s']} -> "
            f"{diag['kernel']['memory_s']} did not drop")
    flops = (diag["plain"]["hlo_flops"], diag["kernel"]["hlo_flops"])
    require(abs(flops[1] - flops[0]) <= 0.01 * flops[0],
            f"loop: FLOPs {flops} not within 1%")
    del params
    rates = device_rates(torch)
    print(f"  card rates (printed, not gated): device copy "
          f"{rates['copy_bytes_per_s'] / 1e12:.3f} TB/s beside the "
          f"backend's {backend.hw.hbm_bw / 1e12:.2f}; bf16 matmul "
          f"{rates['bf16_matmul_flops'] / 1e12:.1f} TFLOP/s beside "
          f"{backend.hw.peak_flops_bf16 / 1e12:.0f}")
    return {"B": b, "S": s, "factor": LOSS_FACTOR, "spread": spread,
            "limits": limits, "gaps": gaps, "seeds": seeds,
            "fault_inside_bf16_limit": faults_inside,
            "diagnosis": diag, "rates": rates, "modules": modules,
            "launches": {k: sum(r["launches"][k] for one in seeds.values()
                                for r in one["runs"].values())
                         for k in runs["plain"]["launches"]},
            "flash_attention_bodies": {
                k: sum(r["flash_attention_bodies"][k]
                       for one in seeds.values()
                       for r in one["runs"].values())
                for k in runs["kernel"]["flash_attention_bodies"]}}


def device_rates(torch):
    """One device-to-device copy of 2 GiB (bytes read + written over its
    time) and one 8192^3 bf16 product (2 n^3 over its time), each the
    median of 5 timed by CUDA events."""
    src = torch.empty(2**30, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    copy = time_ms(torch, lambda: dst.copy_(src), samples=5, reps=1)
    del src, dst
    n = 8192
    a = torch.randn((n, n), device="cuda").to(torch.bfloat16)
    bm = torch.randn((n, n), device="cuda").to(torch.bfloat16)
    mm = time_ms(torch, lambda: torch.matmul(a, bm), samples=5, reps=1)
    del a, bm
    torch.cuda.empty_cache()
    return {"copy_ms": copy, "copy_bytes_per_s": 2 * 2**31 / (copy / 1e3),
            "matmul_ms": mm, "bf16_matmul_flops": 2 * n**3 / (mm / 1e3)}


# -- phases 12, 13 and 14 -----------------------------------------------------

def mlstm_flops(b: int, s: int, h: int, hd: int, chunk: int) -> float:
    """Operations of the chunkwise mLSTM: per chunk of L steps, q k^T and
    S v over the L (L + 1) / 2 causal pairs (4 hd a pair), and q C and the
    update of C (2 L hd^2 each)."""
    per_chunk = 2.0 * chunk * (chunk + 1) * hd + 4.0 * chunk * hd * hd
    return b * h * (s // chunk) * per_chunk


def check_mlstm(torch, ops, dt_name: str, *, b, s, h, hd, chunk,
                timed=False, rotate=False):
    """K5 against `mlstm_chunkwise_plain`, the step-by-step oracle, on the
    same inputs (the reference kernel test's distribution: normal q, k /
    sqrt(hd), v and log_i; log_f = log_sigmoid(normal + 2)).  f32: 1e-4
    absolute + 1e-4 relative, the reference kernel test's tolerance (the
    chunkwise form against the step-by-step one, summed in other orders).
    bf16 inputs: both compute in f32 and round the result to bf16, so they
    are held one bf16 step apart (`compare`).

    Timed: the call in a CUDA graph (`time_ms`), its two launches apart
    (states, outputs: CUDA events around each, `mlstm_chunkwise_passes`),
    and, with `rotate`, the graph of calls cycling through copies of the
    inputs that together exceed the 50 MB L2, so that each call reads its
    inputs from device memory (the bound counts them read once from
    there)."""
    import torch.nn.functional as F
    from repro_torch.kernels.mlstm_scan import mlstm_chunkwise_passes
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = normal(b, s, h, hd).to(dtype)
    k = (normal(b, s, h, hd) / hd ** 0.5).to(dtype)
    v = normal(b, s, h, hd).to(dtype)
    log_i = normal(b, s, h)
    log_f = F.logsigmoid(normal(b, s, h) + 2.0)
    out = ops.mlstm_chunkwise(q, k, v, log_i, log_f, chunk=chunk)
    plain = ops.mlstm_chunkwise_plain(q, k, v, log_i, log_f)
    torch.cuda.synchronize()
    case = f"mlstm_chunkwise {dt_name} B{b} S{s} H{h} hd{hd} chunk{chunk}"
    require(out.shape == q.shape and out.dtype == dtype,
            f"{case}: out {out.dtype} {tuple(out.shape)}")
    require(torch.isfinite(out.float()).all().item(), f"{case}: non-finite")
    if dt_name == "float32":
        diff = (out - plain).abs()
        err = diff.max().item()
        within = (diff - 1e-4 * plain.abs() - 1e-4).max().item() <= 0
        tol = "0.0001 + 0.0001*|plain|"
    else:
        err, within, tol = compare(out, plain, dt_name, 0.0)
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    if timed:
        nbytes = 4 * q.nbytes + log_i.nbytes + log_f.nbytes  # q k v out
        row["bound_ms"], row["bound_by"] = bound(
            mlstm_flops(b, s, h, hd, chunk), nbytes, dt_name)
        kernel = lambda: ops.mlstm_chunkwise(  # noqa: E731
            q, k, v, log_i, log_f, chunk=chunk)
        row["ms"] = time_ms(torch, kernel)
        row["call_ms"] = call_ms(torch, kernel)
        row["states_ms"], row["outputs_ms"] = mlstm_chunkwise_passes(
            q, k, v, log_i, log_f, chunk=chunk)
        if rotate:
            copies = [tuple(t.clone() for t in (q, k, v, log_i, log_f))
                      for _ in range(-(-2 * L2_BYTES // nbytes))]
            turn = iter(range(1 << 62))
            row["rotated_ms"] = time_ms(torch, lambda: ops.mlstm_chunkwise(
                *copies[next(turn) % len(copies)], chunk=chunk))
            row["rotated_copies"] = len(copies)
            del copies
        # a Python loop of S steps: a few samples of one call each
        row["plain_ms"] = call_ms(torch, lambda: ops.mlstm_chunkwise_plain(
            q, k, v, log_i, log_f), samples=3, reps=1)
        row["library_ms"] = None  # no single PyTorch call computes it
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol})"
          + (f", ms {row['ms']:.4f} (call {row['call_ms']:.4f}; states "
             f"{row['states_ms']:.4f} + outputs {row['outputs_ms']:.4f}, "
             f"events)" + (f", inputs rotated past L2 over "
                           f"{row['rotated_copies']} copies "
                           f"{row['rotated_ms']:.4f}" if rotate else "")
             + f", plain_ms {row['plain_ms']:.2f}, library_ms none, "
             f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})"
             if timed else ""))
    return row


def check_slstm(torch, ops, dt_name: str, *, b, s, d, timed=False):
    """K6 against `slstm_scan_plain` on the same inputs (the reference
    kernel test's distribution: normal xg, r at 0.1).  f32: 1e-5 absolute
    + 1e-5 relative (the same f32 recurrence, the recurrent product summed
    in another order; the card has read 2.4e-7).  bf16: one bf16 step
    (`compare`).  Its time is of eager calls timed by CUDA events
    (`call_ms`): the cooperative launch is not captured into a CUDA graph,
    and at milliseconds a call the host's part is small."""
    dtype = getattr(torch, dt_name)
    gen = torch.Generator(device="cuda").manual_seed(13)
    xg = torch.randn((b, s, 4 * d), generator=gen, device="cuda").to(dtype)
    r = (0.1 * torch.randn((d, 4 * d), generator=gen, device="cuda")).to(
        dtype)
    out = ops.slstm_scan(xg, r)
    plain = ops.slstm_scan_plain(xg, r)
    torch.cuda.synchronize()
    case = f"slstm_scan {dt_name} B{b} S{s} D{d}"
    require(tuple(out.shape) == (b, s, d) and out.dtype == dtype,
            f"{case}: out {out.dtype} {tuple(out.shape)}")
    require(torch.isfinite(out.float()).all().item(), f"{case}: non-finite")
    if dt_name == "float32":
        diff = (out - plain).abs()
        err = diff.max().item()
        within = (diff - 1e-5 * plain.abs() - 1e-5).max().item() <= 0
        tol = "1e-05 + 1e-05*|plain|"
    else:
        err, within, tol = compare(out, plain, dt_name, 0.0)
    require(within, f"{case}: max abs err {err:.3e}, beyond tol {tol}")
    row = {"case": case, "max_abs_err": err, "tol": tol}
    if timed:
        nbytes = xg.nbytes + r.nbytes + out.nbytes
        row["bound_ms"], row["bound_by"] = bound(8.0 * b * s * d * d,
                                                 nbytes, dt_name)
        row["ms"] = row["call_ms"] = call_ms(
            torch, lambda: ops.slstm_scan(xg, r), samples=11)
        row["us_a_step"] = row["ms"] * 1e3 / s
        row["plain_ms"] = call_ms(torch, lambda: ops.slstm_scan_plain(
            xg, r), samples=3, reps=1)
        row["library_ms"] = None  # no single PyTorch call computes it
    print(f"  {case}: max_abs_err {err:.3e} (tol {tol})"
          + (f", ms {row['ms']:.4f} (eager calls, events; "
             f"{row['us_a_step']:.3f} us a step), plain_ms "
             f"{row['plain_ms']:.2f}, library_ms none, bound_ms "
             f"{row['bound_ms']:.4f} ({row['bound_by']})" if timed else ""))
    return row


def late_forget_gate(mlstm_chunkwise):
    """A known fault for phase 13's limit: K5 fed `log_f` one step late
    (each step decays by the previous step's forget gate)."""
    def faulty(q, k, v, log_i, log_f, **kwargs):
        return mlstm_chunkwise(q, k, v, log_i,
                               log_f.roll(1, dims=1).contiguous(), **kwargs)
    return faulty


# Phase 13: |logits(kernel) - logits(plain)| at full xlstm-125m width in
# f32, B 4 x S 1024, as a share of the largest logit.  The card has read
# 4.9e-6 on a largest logit of 3.44 (1.4e-6 of it): the same f32 model, K5
# chunked as the plain path and K6 stepping as it, summed in other orders;
# K5 with `log_f` one step late moved the logits by 0.29, 1666x the limit.
XLSTM_REL_TOL = 5e-5


def run_xlstm_prefill(torch, ops, cfg, params, flags, make_prefill_step,
                      init_params, xlstm_module, norms: int):
    """xlstm-125m prefill, B 4 x S 1024 (8 chunks of 128 for K5).

    The main path runs in the config's bf16 with the launch counts reset
    just before it: exactly 9 K5 and 3 K6 launches, and the RMSNorms of
    `norm_launches`.  bf16 kernel path against forced-plain path: within
    2e-2 of the largest logit, phase 4's rule.  In f32 the kernel path is
    held against the forced-plain path at XLSTM_REL_TOL of the largest
    logit with top-1 agreement >= 0.99, and K5 fed `log_f` one step late
    must fall outside that limit."""
    b, s = 4, 1024
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
            f"xlstm prefill logits shape {tuple(kernel16.shape)}")
    require(torch.isfinite(kernel16).all().item(),
            "xlstm prefill logits not finite")
    kinds = list(cfg.block_kinds)
    expect = {"flash_attention": 0, "rmsnorm_pipelined": norms,
              "rmsnorm_baseline": 0, "ssm_scan": 0, "ssm_scan_fused": 0,
              "mlstm_chunkwise": kinds.count("mlstm"),
              "slstm_scan": kinds.count("slstm")}
    require(counts == expect, f"xlstm prefill: launches {counts}, expected "
            f"{expect}")
    print(f"  {cfg.name} bf16 prefill B{b} S{s}: {seconds:.3f} s, launches "
          f"{counts}")
    profile = profile_prefill(torch, prefill, params, tokens)
    with flags(force_plain=True):
        plain16 = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    scale16 = plain16.abs().max().item()
    err16 = (kernel16 - plain16).abs().max().item()
    top16 = (kernel16.argmax(-1) == plain16.argmax(-1)).float().mean().item()
    print(f"  bf16 logits max|kernel-plain| {err16:.4f} of max|logit| "
          f"{scale16:.3f} (tol 0.02 x max|logit|), top-1 agreement "
          f"{top16:.5f} (printed, not gated)")
    require(err16 <= 2e-2 * scale16, f"xlstm bf16 prefill: kernel vs plain "
            f"logits differ by {err16}")
    del kernel16, plain16

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
    real = xlstm_module.mlstm_chunkwise
    xlstm_module.mlstm_chunkwise = late_forget_gate(real)
    try:
        late32 = prefill32(params32, {"tokens": tokens})
    finally:
        xlstm_module.mlstm_chunkwise = real
    torch.cuda.synchronize()
    scale = plain32.abs().max().item()
    err = (kernel32 - plain32).abs().max().item()
    top1 = (kernel32.argmax(-1) == plain32.argmax(-1)).float().mean().item()
    late_err = (late32 - plain32).abs().max().item()
    late_top1 = (late32.argmax(-1) == plain32.argmax(-1)).float().mean(
    ).item()
    print(f"  {cfg.name} f32 prefill B{b} S{s}: {seconds32:.3f} s; logits "
          f"max|kernel-plain| {err:.3e} of max|logit| {scale:.3f} (tol "
          f"{XLSTM_REL_TOL:g} x max|logit|), top-1 agreement {top1:.5f}; K5 "
          f"with log_f one step late: {late_err:.3e}, top-1 {late_top1:.5f}")
    require(err <= XLSTM_REL_TOL * scale,
            f"xlstm prefill: kernel vs plain logits differ by {err}")
    require(top1 >= 0.99, f"xlstm prefill: top-1 agreement {top1} < 0.99")
    require(late_err > XLSTM_REL_TOL * scale,
            f"xlstm prefill: K5 with log_f one step late moves the f32 "
            f"logits by {late_err}, within the tolerance: the check cannot "
            f"see it")
    return {"B": b, "S": s, "seconds": seconds, "launches": counts,
            "profile": profile, "bf16_max_abs_err": err16,
            "bf16_max_abs_logit": scale16, "bf16_top1": top16,
            "f32_seconds": seconds32, "max_abs_err": err,
            "max_abs_logit": scale, "top1": top1, "tol": XLSTM_REL_TOL,
            "late_forget_gate": {"max": late_err, "top1": late_top1}}


# Phase 15: the train step at full qwen2-0.5b width, B 4 x S 1024, under
# `TrainOptions()` (remat "group": every layer's forward runs again in the
# backward, so K1 launches 2 x 24 = 48 times a step and K2 2 x 48 + 1 = 97,
# the final norm being outside the checkpointed layers).
TRAIN_B, TRAIN_S = 4, 1024
TRAIN_STEPS = 10
TRAIN_LR, TRAIN_WARMUP = 3e-3, 2  # the run leaves warmup at step 2
# The gradient gate, f32: one step's gradients on the weights of seed 0 and
# the pipeline's first batch.  The truth is the forced-plain path.  A path's
# gap is the largest, over the param leaves, of the relative L2 gap of the
# leaf's gradient from the truth's.  The rule, as phase 11's: the kernel
# path's gap may be at most GRAD_FACTOR times the largest gap of the right
# paths that are not the kernel path (the plain attention with K2, and K1's
# plain version at the call site), measured in the same run; two known
# faults must fall outside it: K1's output cut off from autograd (every
# wrapper's output on the card before the autograd route) and a backward
# that recomputes attention with its causal band one key off.  bf16 is
# printed beside it, not gated (ROADMAP C-watch 5).  The card (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md section 6, the train step) read 2.90e-6 for
# the right paths and 2.86e-6 for the kernel path, 0.99x (all three run K2
# where the truth runs the plain norm, and their gaps agree within 2%); the
# faults read 1.0 (wq, wk, wv and ln1 get no gradient) and 0.73.  The
# factor is phase 11's: room for one more draw of the same rounding noise.
GRAD_FACTOR = LOSS_FACTOR
# kinds of device activity in phase 15's profiled step, by words of the
# kernel's name (the first kind that matches); the rest is "other"
# (elementwise passes and reductions)
STEP_KINDS = (("K1", ("flash_attention",)), ("K2", ("rmsnorm",)),
              ("products", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
              ("copies and fills", ("copy", "Memcpy", "Memset", "Fill")))


def detached_kernel_call(torch):
    """A known fault for phase 15's gate: K1 called as before the autograd
    route, its output a fresh tensor with no `grad_fn`."""
    def call(kernel, *args, plain_fn, **kwargs):
        with torch.no_grad():
            return kernel(*args, **kwargs)
    return call


def leaf_path(path) -> str:
    """A pytree key path as "groups/0/attn/wq"."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def loss_grads(torch, loss_fn, cfg, params, batch, options):
    """The train step's loss and gradients (`options.remat`, `chunk`) by
    `torch.autograd.grad`, by leaf (`leaf_path`); a leaf that receives
    none gets None."""
    from torch.utils._pytree import tree_flatten_with_path, tree_unflatten
    pairs, spec = tree_flatten_with_path(params)
    tracked = [p.detach().requires_grad_() for _, p in pairs]
    loss = loss_fn(tree_unflatten(tracked, spec), cfg, batch,
                   chunk=options.chunk, remat=options.remat)
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    return loss.item(), {leaf_path(path): g
                         for (path, _), g in zip(pairs, grads)}


def leaf_gap(torch, g, t, drop=None) -> float:
    """The relative L2 gap of the gradient `g` (None: zeros) from `t`.
    `drop`, a set of index tuples into the leading axes of `t` (a layer, or
    a layer and an expert), leaves those slices out of both norms."""
    g = torch.zeros_like(t) if g is None else g.float()
    if not drop:
        return ((g - t).norm() / t.norm()).item()
    depth = len(next(iter(drop)))
    num = den = 0.0
    for idx in itertools.product(*map(range, t.shape[:depth])):
        if idx not in drop:
            num += (g[idx] - t[idx]).double().square().sum().item()
            den += t[idx].double().square().sum().item()
    return math.sqrt(num / den)


def grad_paths(torch, ops, cfg, params, batch, flags, loss_fn,
               attention_module, options, truth=None, moe_module=None,
               moe_slices=()):
    """Each path's gradients (see GRAD_FACTOR), as relative L2 gaps per
    leaf from `truth` (the forced-plain path's own, when None), with its
    loss and launch counts.  With `moe_module` (phase 22) every call of
    `moe.route` is recorded: each right path's routing is probed against
    the truth's (`routing_flips`, the slices of an explained flip left out
    of that path's gaps; the faults' forward is the kernel path's), and
    every path's recomputation against its forward (`recompute_routing`).
    `moe_slices` gives each MoE layer's (group, layer in the group)."""
    real_chunked = attention_module.chunked_attention
    paths = {
        "plain": ({"force_plain": True}, None),
        "attention_plain": ({"attention_impl": "plain"}, None),
        "k1_plain": ({}, ("flash_attention", plain_attention(
            ops.flash_attention_plain))),
        "kernel": ({}, None),
        "fault_detached": ({}, ("kernel_call", detached_kernel_call(torch))),
        "fault_band_backward": ({}, ("chunked_attention",
                                     shifted_keys_attention(real_chunked))),
    }
    out, truth_routes = {}, None
    for name, (path_flags, patch) in paths.items():
        saved = None
        if patch is not None:
            saved = getattr(attention_module, patch[0])
            setattr(attention_module, patch[0], patch[1])
        try:
            ops.reset_launch_counts()
            with flags(**path_flags), recorded_routes(moe_module) as calls:
                loss, grads = loss_grads(torch, loss_fn, cfg, params, batch,
                                         options)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            bodies = dict(ops.flash_attention.body_launches)
        finally:
            if patch is not None:
                setattr(attention_module, patch[0], saved)
        if truth is None and name == "plain":
            truth = {leaf: g.float() for leaf, g in grads.items()}
        routing, drops = {}, {}
        if moe_module is not None:
            if name == "plain":
                truth_routes = calls
            if not name.startswith("fault"):
                routing["flips"], drops = routing_flips(
                    torch, cfg, calls, truth_routes, moe_slices)
            routing["recompute"] = recompute_routing(calls)
            routing["dropped"] = {leaf: sorted(d) for leaf, d in
                                  drops.items()}
        gaps = {leaf: leaf_gap(torch, grads[leaf], t, drops.get(leaf))
                for leaf, t in truth.items()}
        out[name] = {"loss": loss, "gaps": gaps, "max_gap": max(gaps.values()),
                     "no_grad": [leaf for leaf, g in grads.items()
                                 if g is None],
                     "launches": counts, "flash_attention_bodies": bodies,
                     **routing}
        if name == "kernel":
            out[name]["zero_qkv"] = [
                leaf for leaf, g in grads.items() if g is not None and
                leaf.rsplit("/", 1)[-1] in ("wq", "wk", "wv") and
                not bool(g.any())]
        del grads
    return out, truth


def run_train(torch, ops, cfg, flags, loss_fn, init_params,
              attention_module, runtime, optim, data):
    """Phase 15: the f32 gradient gate (GRAD_FACTOR), bf16 gaps printed;
    then TRAIN_STEPS bf16 train steps at full width from the port's data
    pipeline, each step's launches counted, a held batch's loss before and
    after, ms a step, tokens/s, peak memory and one profiled step."""
    options = runtime.TrainOptions(warmup_steps=TRAIN_WARMUP,
                                 total_steps=TRAIN_STEPS)
    pipe = data.DataPipeline(data.SyntheticTokenDataset(data.SyntheticConfig(
        cfg.vocab_size, TRAIN_S, seed=0)), TRAIN_B)
    batch = pipe.device_batch(0)
    layers, norms = cfg.n_layers, 4 * cfg.n_layers + 1
    one_step = {"flash_attention": 2 * layers, "rmsnorm_pipelined": norms}

    cfg32 = replace(cfg, dtype="float32")
    params32 = init_params(cfg32,
                           torch.Generator(device="cuda").manual_seed(0))
    f32, truth = grad_paths(torch, ops, cfg32, params32, batch, flags,
                            loss_fn, attention_module, options)
    del params32
    params16 = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    bf16, _ = grad_paths(torch, ops, cfg, params16, batch, flags, loss_fn,
                         attention_module, options, truth=truth)
    del params16, truth
    torch.cuda.empty_cache()
    spread = max(f32[n]["max_gap"] for n in ("attention_plain", "k1_plain"))
    limit = GRAD_FACTOR * spread
    leaves = list(f32["plain"]["gaps"])
    print(f"  gradient gate, f32, one step B{TRAIN_B} S{TRAIN_S} (remat "
          f"{options.remat!r}, chunk {options.chunk}): right paths other "
          f"than the kernel path reach {spread:.3e}; limit {GRAD_FACTOR:g}x "
          f"= {limit:.3e}")
    for level, paths in (("f32", f32), ("bf16 (gaps from the f32 truth; not "
                                        "gated)", bf16)):
        print(f"  {level}: loss " + ", ".join(
            f"{n} {p['loss']:.6f}" for n, p in paths.items()))
        print("    largest gap: " + ", ".join(
            f"{n} {p['max_gap']:.3e}" for n, p in paths.items()))
        for leaf in leaves:
            print(f"    {leaf}: " + ", ".join(
                f"{p['gaps'][leaf]:.2e}" for p in paths.values()))
    for level, paths, dtype_body in (("f32", f32, "cuda_core"),
                                     ("bf16", bf16, "tensor_core")):
        k = paths["kernel"]
        require(not k["no_grad"] and not k["zero_qkv"],
                f"train {level}: the kernel path leaves {k['no_grad']} "
                f"without a gradient and {k['zero_qkv']} all zeros")
        require(all(k["launches"][n] == c for n, c in one_step.items()) and
                k["flash_attention_bodies"][dtype_body] == 2 * layers,
                f"train {level}: the kernel path's launches "
                f"{k['launches']}, bodies {k['flash_attention_bodies']}, "
                f"expected {one_step} on the {dtype_body} body")
        require(all(math.isfinite(p["loss"]) for p in paths.values()),
                f"train {level}: a loss is not finite")
    require(f32["kernel"]["max_gap"] <= limit,
            f"train: the kernel path's f32 gradients are "
            f"{f32['kernel']['max_gap']} from the plain path's, beyond "
            f"{limit}")
    for fault in ("fault_detached", "fault_band_backward"):
        require(f32[fault]["max_gap"] > limit,
                f"train: {fault} moves the f32 gradients by "
                f"{f32[fault]['max_gap']}, within {limit}: the gate cannot "
                f"see it")

    state = runtime.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    step = runtime.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR),
                                   options)
    held = pipe.device_batch(10**6)  # a batch no step trains on
    held_before = loss_fn(state["params"], cfg, held).item()
    print(f"  {TRAIN_STEPS} bf16 steps of make_train_step: lr {TRAIN_LR:g}, "
          f"warmup_steps {TRAIN_WARMUP}, total_steps {TRAIN_STEPS}, remat "
          f"{options.remat!r}, chunk {options.chunk}, clip_norm "
          f"{options.clip_norm:g}; batches from DataPipeline(SyntheticToken"
          f"Dataset(seq {TRAIN_S}, seed 0), global batch {TRAIN_B})")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    bodies = dict.fromkeys(ops.flash_attention.body_launches, 0)
    rows = []
    batches = pipe(0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_STEPS):
            b = next(batches)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            for n, c in counts.items():
                totals[n] += c
            for n, c in ops.flash_attention.body_launches.items():
                bodies[n] += c
            row = {"step": i, "seconds": seconds, "launches": counts,
                   **{k: v.item() for k, v in metrics.items()}}
            rows.append(row)
            print(f"    step {i}: loss {row['loss']:.6f}, grad_norm "
                  f"{row['grad_norm']:.6f}, lr_scale {row['lr_scale']:.6f}, "
                  f"{seconds * 1e3:.3f} ms; K1 "
                  f"{counts['flash_attention']}, K2 "
                  f"{counts['rmsnorm_pipelined']}")
            require(math.isfinite(row["loss"]) and
                    math.isfinite(row["grad_norm"]),
                    f"train step {i}: loss or grad norm not finite")
            require(all(counts[n] == c for n, c in one_step.items()) and
                    ops.flash_attention.body_launches["tensor_core"] ==
                    2 * layers, f"train step {i}: launches {counts}, "
                    f"expected {one_step}, all K1 on the tensor-core body")
        peak = torch.cuda.max_memory_allocated()
        from torch.profiler import ProfilerActivity, profile
        b = next(batches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        batches.close()
    device, busy_us, top = device_time(torch, prof, wall_us, top=12)
    kinds = {}
    for e in device:
        kind = next((k for k, words in STEP_KINDS
                     if any(w in e.name for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    # the host-side operators whose own launches take the most device time
    by_op = sorted(((e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CPU and
                    e.self_device_time_total > 0),
                   key=lambda kv: -kv[1])[:12]
    held_after = loss_fn(state["params"], cfg, held).item()
    ms = statistics.median(r["seconds"] for r in rows[1:]) * 1e3
    result = {
        "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
        "warmup_steps": TRAIN_WARMUP, "total_steps": TRAIN_STEPS,
        "remat": options.remat, "chunk": options.chunk,
        "grad_gate": {"factor": GRAD_FACTOR, "spread": spread,
                      "limit": limit, "f32": f32, "bf16": bf16},
        "rows": rows, "ms_per_step": ms,
        "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
        "peak_memory_bytes": peak,
        "held_loss": {"before": held_before, "after": held_after},
        "profile": {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                    "device_idle_share": (1 - busy_us / wall_us)
                    if device else None,
                    "device_activities": len(device),
                    "device_ms_by_kind": kinds,
                    "top_device_ms": {n: t / 1e3 for n, t in top},
                    "top_operator_self_device_ms": dict(by_op)},
        "launches": totals, "flash_attention_bodies": bodies}
    print(f"  {ms:.3f} ms a step (median of steps 1-{TRAIN_STEPS - 1}), "
          f"{result['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; held-batch loss {held_before:.6f} -> "
          f"{held_after:.6f}")
    prof_row = result["profile"]
    if device:
        print(f"  a profiled step: {prof_row['wall_ms']:.3f} ms wall, device "
              f"busy {prof_row['device_busy_ms']:.3f} ms, idle share "
              f"{prof_row['device_idle_share']:.4f}, {len(device)} device "
              f"activities; device ms by kind: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(kinds.items(),
                                                    key=lambda kv: -kv[1])))
        for name, t in prof_row["top_device_ms"].items():
            print(f"    {t:.4f} ms  {name[:100]}")
        print("  operators by their own launches' device time: " + ", ".join(
            f"{n} {t:.3f}" for n, t in by_op))
    else:
        print("  train profile: the profiler saw no device activity; device "
              "idle share not measured")
    require(held_after < held_before,
            f"train: the held batch's loss {held_before} -> {held_after} did "
            f"not fall in {TRAIN_STEPS} steps")
    return result


# Phase 16: the train driver (`repro_torch.launch.train.main`, the user's
# entry point) at full width, the sizes of phase 15.  Run A trains
# DRIVER_STEPS steps in one go, twice (A1 also `--analyze`); run B trains
# RESTORE_AT steps and saves; run C restores it and trains on to
# DRIVER_STEPS.  The gate: C's losses at steps RESTORE_AT.. equal A1's, up
# to RESTORE_FACTOR times the spread between A1 and A2 at those steps (0
# where the two uninterrupted runs agree bit for bit).  A step's loss is
# taken before its update, so the first resumed loss reads only the
# restored params; the next one reads the optimizer state and the step
# counter too.  Two known faults, each a restore that returns run C's
# state with one part lost, must fall outside: `opt/mu` left at the fresh
# state's zeros, and `step` left at 0 (the schedule restarts).
DRIVER_STEPS, RESTORE_AT = 4, 2
RESTORE_FACTOR = LOSS_FACTOR
# free disk the phase asks for: two full checkpoints (~6.9 GB each at
# qwen2-0.5b's width: bf16 params, f32 master, mu and nu) and room
DRIVER_DISK_BYTES = 16 * 2**30


def tree_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def run_train_driver(torch, ops, cfg, train, checkpoint, core, work: Path,
                     phase15_ms: float):
    """Phase 16 (see DRIVER_STEPS): runs A1, A2, B and C through
    `train.main`, each run's launches K1 2 x layers and K2 4 x layers + 1 a
    step; the restore gate and its two faults; the checkpoint's bytes, the
    seconds of each save (the caller's blocking part, the background write)
    and of the restore, the disk it took; LEO on A1's captured step.  The
    seconds are read by the stand-ins this phase puts in the driver's way
    (a timed `CheckpointManager`, `capture` and `LeoSession`)."""
    from torch.utils._pytree import tree_leaves, tree_map
    layers = cfg.n_layers
    one_step = {"flash_attention": 2 * layers,
                "rmsnorm_pipelined": 4 * layers + 1}
    free = shutil.disk_usage(work).free
    print(f"  {free / 2**30:.1f} GiB free under {work}")
    require(free >= DRIVER_DISK_BYTES, f"phase 16: {free} bytes free under "
            f"{work}, the phase needs {DRIVER_DISK_BYTES}")
    ckpt = work / "ckpt"
    base = ["--arch", ARCH, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S)]
    kept = {}
    log = {}  # what the stand-ins saw in the current run

    class TimedManager(checkpoint.CheckpointManager):
        """Run B's manager: times each save and each restore.  A save's
        background write runs from the caller's return to the worker's
        rotation of the checkpoints."""
        def save(self, step, state):
            self.wait()
            record = {"step": step, "bytes": sum(
                torch.as_tensor(x).nbytes for x in tree_leaves(state))}
            log["saves"].append(record)
            t0 = time.perf_counter()
            super().save(step, state)
            record["returned"] = time.perf_counter()
            record["blocking_seconds"] = record["returned"] - t0

        def _rotate(self):
            log["saves"][-1]["written"] = time.perf_counter()
            super()._rotate()

        def restore_latest(self, like, device=None, shardings=None):
            t0 = time.perf_counter()
            out = super().restore_latest(like, device, shardings)
            log["restore_seconds"] = time.perf_counter() - t0
            return out

    class KeepRestored(TimedManager):
        """Run C's manager: also keeps a device copy of what it
        restored."""
        def restore_latest(self, like, device=None, shardings=None):
            state, step = super().restore_latest(like, device, shardings)
            kept["state"] = tree_map(torch.clone, state)
            kept["step"] = step
            return state, step

    def faulty(kind):
        class FaultyRestore(checkpoint.CheckpointManager):
            """A restore that loses one part of run C's state; saves
            nothing."""
            def restore_latest(self, like, device=None, shardings=None):
                state = tree_map(torch.clone, kept["state"])
                if kind == "drop_mu":
                    state["opt"]["mu"] = like["opt"]["mu"]
                else:
                    state["step"] = like["step"]
                return state, kept["step"]

            def save(self, step, state):
                pass
        return FaultyRestore

    real_capture = core.capture

    def timed_capture(*a, **k):
        t0 = time.perf_counter()
        module = real_capture(*a, **k)
        log["analysis"] = {"capture_seconds": time.perf_counter() - t0,
                           "instructions": sum(
                               1 for _ in module.all_instructions()),
                           "kernel_regions": dict(module.kernel_calls)}
        return module

    class TimedSession(core.LeoSession):
        def analyze(self, *a, **k):
            t0 = time.perf_counter()
            an = super().analyze(*a, **k)
            log["analysis"]["analyze_seconds"] = time.perf_counter() - t0
            return an

    def drive(name, extra, manager=TimedManager):
        print(f"  run {name}: main({' '.join(base + extra)})")
        stand_ins = [(train, "CheckpointManager", manager),
                     (core, "capture", timed_capture),
                     (core, "LeoSession", TimedSession)]
        saved = [(m, attr, getattr(m, attr)) for m, attr, _ in stand_ins]
        log.clear()
        log.update(saves=[], restore_seconds=None)
        try:
            for m, attr, new in stand_ins:
                setattr(m, attr, new)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = train.main(base + extra)
            torch.cuda.synchronize()
            res["run_seconds"] = time.perf_counter() - t0
            res["launches"] = ops.launch_counts()
            res["flash_attention_bodies"] = dict(
                ops.flash_attention.body_launches)
        finally:
            for m, attr, old in saved:
                setattr(m, attr, old)
        for record in log["saves"]:  # main waits for the last write
            record["write_seconds"] = (record.pop("written") -
                                       record.pop("returned"))
        res.update(checkpoints=log["saves"],
                   restore_seconds=log["restore_seconds"])
        if "analysis" in log:
            res["analysis"] = log["analysis"]
        n = res["steps"]
        require(all(res["launches"][k] == n * c for k, c in
                    one_step.items()) and
                res["flash_attention_bodies"]["tensor_core"] ==
                n * one_step["flash_attention"],
                f"phase 16 run {name}: launches {res['launches']}, bodies "
                f"{res['flash_attention_bodies']} in {n} steps, expected "
                f"{one_step} a step, all K1 on the tensor-core body")
        require(all(math.isfinite(h["loss"]) for h in res["history"]),
                f"phase 16 run {name}: a loss is not finite")
        res["disk_bytes"] = tree_bytes(work)
        print(f"    {n} steps in {res['run_seconds']:.3f} s: losses " +
              ", ".join(f"{h['step']}: {h['loss']!r}" for h in
                        res["history"]) + f"; {res['disk_bytes']} bytes on "
              f"disk under the phase's directory")
        for c in res["checkpoints"]:
            print(f"    saved step {c['step']}: {c['bytes']} bytes, the "
                  f"caller blocked {c['blocking_seconds']:.3f} s, written "
                  f"in {c['write_seconds']:.3f} s")
        if res["restore_seconds"] is not None:
            print(f"    restored in {res['restore_seconds']:.3f} s")
        return res

    steps = str(DRIVER_STEPS)
    runs = {"A1": drive("A1", ["--steps", steps, "--analyze"]),
            "A2": drive("A2", ["--steps", steps])}
    runs["B"] = drive("B", ["--steps", str(RESTORE_AT), "--checkpoint-dir",
                            str(ckpt)])
    resume = ["--steps", steps, "--checkpoint-dir", str(ckpt), "--restore"]
    runs["C"] = drive("C", resume, KeepRestored)
    faults = {kind: drive(f"fault {kind}", resume, faulty(kind))
              for kind in ("drop_mu", "step_zero")}
    kept.clear()
    peak_disk = max(r["disk_bytes"] for r in runs.values())

    def losses(res):
        return {h["step"]: h["loss"] for h in res["history"]}
    a1, a2, c = losses(runs["A1"]), losses(runs["A2"]), losses(runs["C"])
    resumed = list(range(RESTORE_AT, DRIVER_STEPS))
    spread = max(abs(a1[i] - a2[i]) for i in resumed)
    limit = RESTORE_FACTOR * spread

    def gap(res):
        got = losses(res)
        return max(abs(got[i] - a1[i]) for i in resumed)
    gaps = {"C": gap(runs["C"]),
            **{kind: gap(res) for kind, res in faults.items()}}
    print(f"  restore gate: losses at steps {resumed}, A1 " +
          ", ".join(f"{a1[i]!r}" for i in resumed) + "; A2 " +
          ", ".join(f"{a2[i]!r}" for i in resumed) + "; C " +
          ", ".join(f"{c[i]!r}" for i in resumed) + f"; spread A1-A2 "
          f"{spread!r}, limit {RESTORE_FACTOR:g}x = {limit!r}; largest gap "
          f"from A1: " + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
    require(runs["C"]["steps"] == DRIVER_STEPS - RESTORE_AT and
            sorted(c) == resumed, f"phase 16: run C resumed at "
            f"{sorted(c)}, expected {resumed}")
    require(gaps["C"] <= limit, f"phase 16: run C's losses are "
            f"{gaps['C']} from the uninterrupted run's, beyond {limit}")
    for kind in faults:
        require(gaps[kind] > limit, f"phase 16: the restore fault {kind} "
                f"moves the losses by {gaps[kind]}, within {limit}: the "
                f"gate cannot see it")
    saves = runs["B"]["checkpoints"] + runs["C"]["checkpoints"]
    require([s["step"] for s in saves] == [RESTORE_AT, DRIVER_STEPS],
            f"phase 16: saves {saves}")
    require(peak_disk <= 2 * max(s["bytes"] for s in saves) + 2**20,
            f"phase 16: {peak_disk} bytes on disk at once, more than two "
            f"checkpoints")

    ms = statistics.median(h["seconds"] for r in (runs["A1"], runs["A2"])
                           for h in r["history"][1:]) * 1e3
    an = runs["A1"]["analysis"]
    leo_ms = runs["A1"]["leo_step_seconds"] * 1e3
    print(f"  through the driver: {ms:.3f} ms a step (median of steps "
          f"1-{DRIVER_STEPS - 1} of A1 and A2), "
          f"{TRAIN_B * TRAIN_S / (ms / 1e3):.1f} tokens/s; phase 15 "
          f"{phase15_ms:.3f} ms a step, "
          f"{TRAIN_B * TRAIN_S / (phase15_ms / 1e3):.1f} tokens/s")
    print(f"  --analyze (A1's step captured on the card): "
          f"{an['instructions']} instructions, kernel regions "
          f"{an['kernel_regions']}, captured in {an['capture_seconds']:.3f} "
          f"s, analysed in {an['analyze_seconds']:.3f} s; LEO's estimate "
          f"{leo_ms:.3f} ms a step beside {ms:.3f} ms measured "
          f"({ms / leo_ms:.2f}x)")
    require(an["kernel_regions"] == one_step, f"phase 16: the captured "
            f"step has kernel regions {an['kernel_regions']}, expected "
            f"{one_step}")
    for res in list(runs.values()) + list(faults.values()):
        res.pop("analysis", None)
    return {"steps": DRIVER_STEPS, "restore_at": RESTORE_AT, "runs": runs,
            "faults": faults,
            "gate": {"factor": RESTORE_FACTOR, "spread": spread,
                     "limit": limit, "gaps": gaps},
            "peak_disk_bytes": peak_disk, "ms_per_step": ms,
            "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
            "phase15_ms_per_step": phase15_ms, "analysis": an,
            "leo_ms": leo_ms,
            # the main-path runs' launches, for the kernels line
            "launches": {k: sum(runs[r]["launches"][k] for r in runs)
                         for k in runs["A1"]["launches"]},
            "flash_attention_bodies": {
                k: sum(runs[r]["flash_attention_bodies"][k] for r in runs)
                for k in runs["A1"]["flash_attention_bodies"]}}


# Phase 17: LEO's upper tiers (the advisor, the rewrite loop, the analysis
# server) on the card's own programs.  Every number it prints is a host time
# or a model's estimate beside what the card measured in phases 10 and 11.
SERVER_TIMEOUT_S = 300
UPPER_BACKEND = "nvidia_h100_sxm"


def advise_on(core, advisor, rewrite, name, module, measured_ms):
    """The advisor and the rewrite loop on one captured Module, each tier
    gated on its own.  Gates: the identity replay has the baseline's
    fingerprint; the advice is recorded; every rewrite item is a typed
    skip, or the loop raised the printer's refusal of a non-HLO Module,
    as the reference does; `LeoService.diagnose`'s Diagnosis with the
    advice survives a JSON round trip."""
    backend = core.get_backend(UPPER_BACKEND)
    engine = advisor.WhatIfEngine(module, backend)
    base = advisor.profile_fingerprint(engine.baseline())
    require(advisor.profile_fingerprint(
        engine.replay(advisor.Identity()).profile) == base,
        f"phase 17 {name}: the identity replay is not the baseline")
    t0 = time.perf_counter()
    report = advisor.Advisor().report(module, backend)
    advise_s = time.perf_counter() - t0
    refused = None
    skipped = []
    t0 = time.perf_counter()
    try:
        rw = rewrite.rewrites_section(
            rewrite.RewriteLoop().run(module, backend,
                                      advisor_report=report))
    except rewrite.PrinterError as exc:
        require(module.source != "hlo", f"phase 17 {name}: the printer "
                f"refused an HLO module: {exc}")
        refused = str(exc)
    else:
        require(rw["count"] == 0, f"phase 17 {name}: {rw['count']} "
                f"rewrites of a {module.source} module")
        for s in rw["skipped"]:
            require(s["refusal"]["code"] in ("hardware_mutation",
                                             "unsupported", "noop"),
                    f"phase 17 {name}: untyped skip {s}")
        skipped = [(s["rule"], s["refusal"]["code"]) for s in rw["skipped"]]
    rewrite_s = time.perf_counter() - t0
    diag = core.LeoService().diagnose(
        module, backend=UPPER_BACKEND,
        options=core.DiagnoseOptions(advise=True))
    require(diag.advice.get("recorded") is True,
            f"phase 17 {name}: no advice section recorded")
    text = diag.to_json()
    require(core.Diagnosis.from_json(text).to_json() == text,
            f"phase 17 {name}: the Diagnosis changed in a JSON round trip")
    items = [a.to_dict() for a in report.advice]
    top = items[0] if items else None
    row = {"source": module.source,
           "instructions": sum(1 for _ in module.all_instructions()),
           "advise_s": advise_s, "rewrite_s": rewrite_s,
           "replays": report.candidates_replayed,
           "rules_matched": report.rules_matched,
           "advice": [(a["rule"], a["mutation"], a["modeled_speedup"])
                      for a in items],
           "skipped": skipped, "printer_refusal": refused,
           "measured_ms": measured_ms}
    print(f"  {name} ({module.source}, {row['instructions']} instructions, "
          f"measured {measured_ms:.4f} ms on the card): top advice "
          + (f"{top['rule']} {top['mutation']} modeled "
             f"{top['modeled_speedup']:.4f}x" if top else "none")
          + f"; {row['replays']} replays, {len(items)} items; rewrites "
          + (f"refused by the printer ({refused})" if refused else
             f"skipped {skipped}")
          + f"; advisor {advise_s:.2f} s, rewrite loop {rewrite_s:.2f} s "
          f"on the host")
    return row


def run_analysis_server(core, serve, server_module):
    """The analysis server's entry point in a fresh process (it must exit
    0), then `LeoHttpd` on an ephemeral port with `LeoClient` in this
    one: each demo trace with advise and rewrite, on one backend and fanned
    out, the wire's Diagnosis JSON equal to the in-process one."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analysis_server",
         "--smoke"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=SERVER_TIMEOUT_S)
    smoke_s = time.perf_counter() - t0
    require(res.returncode == 0, f"phase 17: analysis_server --smoke "
            f"exited {res.returncode}: {res.stderr[-2000:]}")
    print(f"  analysis_server --smoke: exit 0 in {smoke_s:.2f} s; "
          + res.stdout.strip().splitlines()[-1])
    traces = {"demo": server_module.demo_hlo(0),
              "copy_storm": server_module.copy_storm_hlo(),
              "wide_ops": server_module.wide_ops_hlo()}
    options = core.DiagnoseOptions(advise=True, rewrite=True)
    svc = core.LeoService()
    served = 0
    t0 = time.perf_counter()
    with serve.LeoHttpd(service=svc, port=0, slots=2) as app:
        with serve.LeoClient(port=app.port, timeout=60.0,
                             max_retries=2) as client:
            for name, text in traces.items():
                for kw in ({"backend": UPPER_BACKEND},
                           {"backends": [UPPER_BACKEND, "tpu_v5e"]}):
                    req = core.AnalyzeRequest(hlo_text=text, options=options,
                                              **kw)
                    wire = client.submit(req)
                    local = svc.submit(core.AnalyzeRequest(
                        hlo_text=text, options=options, **kw))
                    served += 1
                    if isinstance(local, dict):
                        require(sorted(wire) == sorted(local),
                                f"phase 17 {name}: fan-out {sorted(wire)}")
                        pairs = [(wire[b], local[b]) for b in local]
                    else:
                        pairs = [(wire, local)]
                    for w, l in pairs:
                        require(w.to_json() == l.to_json(),
                                f"phase 17 {name}: the wire's Diagnosis on "
                                f"{l.backend} is not the in-process one")
                        require(w.advice["recorded"] and
                                w.rewrites["recorded"],
                                f"phase 17 {name}: advice or rewrites not "
                                f"recorded on {l.backend}")
    wire_s = time.perf_counter() - t0
    print(f"  LeoHttpd + LeoClient: {served} requests served, wire equal to "
          f"in-process on {', '.join(traces)} ({UPPER_BACKEND}, and fanned "
          f"out to tpu_v5e), {wire_s:.2f} s on the host")
    return {"smoke_s": smoke_s, "requests_served": served,
            "wire_s": wire_s}


def run_upper_tiers(core, loss_modules, loss_ms, ptx_modules, ptx_ms):
    """Phase 17: (a) phase 11's captured losses, (b) phase 10's PTX of K2
    and K3, each advised and rewritten on `nvidia_h100_sxm`; (c) the
    analysis server."""
    import repro_torch.advisor as advisor
    import repro_torch.launch.analysis_server as server_module
    import repro_torch.rewrite as rewrite
    import repro_torch.serve as serve

    rows = {}
    for name, module in list(loss_modules.items()) + \
            list(ptx_modules.items()):
        measured = loss_ms[name] if name in loss_ms else ptx_ms[name]
        rows[name] = advise_on(core, advisor, rewrite, name, module,
                               measured)
    ratio = loss_ms["loss_plain"] / loss_ms["loss_kernel"]
    tops = {n: r["advice"][0][2] if r["advice"] else 1.0
            for n, r in rows.items()}
    print(f"  phase 11 measured loss_plain / loss_kernel = {ratio:.3f}x "
          f"(the attention switch to K1); the advisor's top modeled "
          f"speedups: " + ", ".join(f"{n} {v:.4f}x" for n, v in tops.items()))
    return {"programs": rows, "measured_kernel_speedup": ratio,
            "server": run_analysis_server(core, serve, server_module)}


# -- phase 18 -----------------------------------------------------------------

# The configurations of phase 18, each at full width: (name, layers), None
# keeping the config's depth.  phi3.5-moe's 32 layers are 77.99 GiB of bf16
# weights and deepseek-v2's 60 are 439.2 GiB (`models.weight_bytes`): cut
# to a depth whose f32 weights one card holds beside a prefill (39.7 and
# 49.6 GiB).  LEO captures phi3.5-moe's loss at MOE_LEO_LAYERS.
SLICE_ARCHS = (("musicgen-medium", None), ("internvl2-2b", None),
               ("phi3.5-moe-42b-a6.6b", 8), ("deepseek-v2-236b", 4))
MOE_LEO_LAYERS = 4
# K1 and K2 launches of one prefill of each at those depths: K1 once an
# attention layer (none under MLA, whose q/k heads are 192 wide and v's
# 128: no kernel takes two head dims); K2 at `ln1` and `ln2` of every
# layer, MLA's `q_norm` and `kv_norm`, and the final norm
SLICE_LAUNCHES = {"musicgen-medium": (48, 97), "internvl2-2b": (24, 49),
                  "phi3.5-moe-42b-a6.6b": (8, 17),
                  "deepseek-v2-236b": (0, 17)}
SLICE_B, SLICE_S = 4, 1024
# Routing flips between the kernel path and the plain path at one MoE
# layer, on the same input (see `probe_routing`), are explained where the
# plain path's top-k margin is within what the two norms' difference can
# move it, and never less than ROUTE_FLOOR (the f32 router's own rounding).
ROUTE_FLOOR = 1e-5


def slice_inputs(torch, cfg, b: int, s: int):
    """Phase 18's prefill batch from seed 3: tokens, or bf16 embeddings
    (`standard_normal * 0.02`, as `tests/test_archs_smoke.py` makes them)
    for the configurations with a modality front-end."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    if cfg.frontend != "none":
        return {"embeds": (0.02 * torch.randn(
            (b, s, cfg.d_model), generator=gen, device="cuda")).to(
                torch.bfloat16)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device="cuda")}


def probe_routing(torch, flags, modules, run, dt_name: str):
    """`run()`, a kernel-path prefill, with every MoE layer's routing held
    on its own input: the layer's `ln2` input, as the kernel path computed
    it, is normed by K2 (the model's call) and by the plain RMSNorm, and
    both outputs are routed (`moe.route`).  K2's output is held to the
    plain one element by element (`compare`).  A token whose top-k set
    differs between the two is a flip; it is explained where the plain
    path's top-k margin (k-th less (k+1)-th probability) is at most
    max(ROUTE_FLOOR, (p_k + p_k+1) * expm1(2 * L)), L = sum_i |h_i - h'_i|
    * max_e |W_ie| bounding the change of any router logit: a right K2
    passes by construction, whatever the seed.  Returns run()'s output and
    one record a MoE layer, with the kernel path's expert ids (for
    `follow_routing`)."""
    tmod, moe_module = modules["transformer"], modules["moe"]
    real_norm, real_moe = tmod.rmsnorm, moe_module.moe_forward
    real_route = moe_module.route
    last, layers = {}, []

    def norm(x, scale, eps=1e-5):
        out = real_norm(x, scale, eps)
        last.update(x=x, scale=scale, eps=eps, out=out)
        return out

    def moe(p, h, cfg):
        require(last.get("out") is h, "phase 18: a MoE layer's input is not "
                "the norm just before it")
        with flags(force_plain=True):
            h_plain = real_norm(last["x"], last["scale"], last["eps"])
        d, k = h.shape[-1], cfg.top_k
        err, within, tol = compare(h, h_plain, dt_name, 1e-5)
        rk = real_route(p, h.reshape(1, -1, d), cfg)
        rp = real_route(p, h_plain.reshape(1, -1, d), cfg)
        flips = (rk.expert_ids[0].sort(-1).values !=
                 rp.expert_ids[0].sort(-1).values).any(-1)
        shift = (h.float() - h_plain.float()).abs().reshape(-1, d) @ \
            p["router"].float().abs().amax(-1)
        ranked = rp.probs[0].sort(-1, descending=True).values
        pair = ranked[:, k - 1] + ranked[:, k]
        limit = (pair * torch.expm1(2 * shift)).clamp(min=ROUTE_FLOOR)
        margin = rp.margin[0]
        layers.append({
            "tokens": int(flips.numel()), "flips": int(flips.sum()),
            "margins": margin[flips].tolist(),
            "limits": limit[flips].tolist(),
            "unexplained": int((flips & (margin > limit)).sum()),
            "min_margin": margin.min().item(),
            "norm_max_abs_err": err, "norm_within": within, "norm_tol": tol,
            "expert_ids": rk.expert_ids})
        return real_moe(p, h, cfg)

    tmod.rmsnorm, moe_module.moe_forward = norm, moe
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        tmod.rmsnorm, moe_module.moe_forward = real_norm, real_moe
    return out, layers


def forced_route(routing, expert_ids):
    """`routing` (a `moe.Routing`) with its top-k choice replaced by
    `expert_ids` (G, T, k), the gates read from its own probabilities at
    those ids and renormalised, as `moe.route` reads them at its own."""
    vals = routing.probs.gather(-1, expert_ids)
    return routing._replace(
        expert_ids=expert_ids,
        gates=vals / vals.sum(-1, keepdim=True).clamp(min=1e-9))


def follow_routing(torch, flags, modules, run, layers, force_plain=True):
    """`run()`, on the forced-plain path unless `force_plain` is False,
    with each MoE layer routed to the experts the kernel path chose there
    (`probe_routing`'s records; `forced_route`): on the plain path the two
    paths then differ only in the arithmetic of K1, K2 and their plain
    versions."""
    moe_module = modules["moe"]
    real_route = moe_module.route
    forced = iter(layer["expert_ids"] for layer in layers)

    def route(p, xf, cfg):
        return forced_route(real_route(p, xf, cfg), next(forced))

    moe_module.route = route
    try:
        with flags(force_plain=force_plain):
            out = run()
        torch.cuda.synchronize()
    finally:
        moe_module.route = real_route
    require(next(forced, None) is None, "phase 18: the forced routing was "
            "not used by every MoE layer")
    return out


def logits_gap(kernel, plain):
    """Max abs gap, the largest |plain| logit, mean abs gap, top-1
    agreement."""
    diff = (kernel - plain).abs()
    top1 = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    return (diff.max().item(), plain.abs().max().item(), diff.mean().item(),
            top1)


def both_paths(torch, flags, modules, cfg, run):
    """`run()` (one prefill) on the kernel path and on the forced-plain
    path.  With MoE the kernel path's routing is probed layer by layer
    (`probe_routing`, every flip explained) and the plain path follows it
    (`follow_routing`).  Returns (kernel, plain, the probe's records)."""
    if cfg.n_experts:
        kernel, layers = probe_routing(torch, flags, modules, run, cfg.dtype)
        plain = follow_routing(torch, flags, modules, run, layers)
    else:
        kernel, layers = run(), []
        with flags(force_plain=True):
            plain = run()
        torch.cuda.synchronize()
    return kernel, plain, layers


def routing_row(cfg, layers):
    """Phase 18's routing record of one probed prefill, printed and
    gated: every flip explained, K2 within one step at every ln2."""
    flips = sum(layer["flips"] for layer in layers)
    unexplained = sum(layer["unexplained"] for layer in layers)
    margins = [m for layer in layers for m in layer["margins"]]
    limits = [m for layer in layers for m in layer["limits"]]
    print(f"    {cfg.dtype} routing over {len(layers)} MoE layers x "
          f"{layers[0]['tokens']} tokens: {flips} flips between K2 and "
          f"the plain norm on the same input, plain margins "
          f"{[f'{m:.3e}' for m in margins]} (limits "
          f"{[f'{m:.3e}' for m in limits]}), {unexplained} unexplained; "
          f"smallest margin {min(x['min_margin'] for x in layers):.3e}; "
          f"K2 vs plain at ln2 max abs err "
          f"{max(x['norm_max_abs_err'] for x in layers):.3e}")
    require(all(layer["norm_within"] for layer in layers),
            f"phase 18 {cfg.name}: K2 at a MoE layer's ln2 beyond "
            f"{layers[0]['norm_tol']}")
    require(unexplained == 0, f"phase 18 {cfg.name}: {unexplained} "
            f"routing flips with margins beyond their limits")
    return {"flips": flips, "flip_margins": margins, "flip_limits": limits,
            "layers": [{k: v for k, v in layer.items() if k != "expert_ids"}
                       for layer in layers]}


def run_slice_prefill(torch, ops, cfg, params, flags, make_prefill_step,
                      modules):
    """The bf16 main path: B 4 x S 1024 through `make_prefill_step`, the
    launch counts exact (SLICE_LAUNCHES), timed cold and once more; then
    both paths on the same batch (`both_paths`) and, where the
    configuration runs K1, the kernel path with K1's band one key off
    (following the kernel path's routing), kept for the bf16 gate of
    `run_slice_f32`."""
    b, s = SLICE_B, SLICE_S
    batch = slice_inputs(torch, cfg, b, s)
    prefill = make_prefill_step(cfg)
    prefill(params, {k: v[:, :128] for k, v in batch.items()})  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    bodies = dict(ops.flash_attention.body_launches)
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    warm_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(tuple(logits.shape) == (b, s, cfg.vocab_size) and
            torch.isfinite(logits).all().item(),
            f"phase 18 {cfg.name}: prefill logits {tuple(logits.shape)} or "
            f"not finite")
    k1, k2 = SLICE_LAUNCHES[cfg.name]
    expect = {"flash_attention": k1, "rmsnorm_pipelined": k2,
              "rmsnorm_baseline": 0, "ssm_scan": 0, "ssm_scan_fused": 0,
              "mlstm_chunkwise": 0, "slstm_scan": 0}
    require(counts == expect, f"phase 18 {cfg.name}: launches {counts}, "
            f"expected {expect}")
    require(bodies == {"tensor_core": k1, "cuda_core": 0},
            f"phase 18 {cfg.name}: flash_attention bodies {bodies}")
    del logits
    print(f"  {cfg.name} bf16 prefill B{b} S{s} "
          f"({'embeddings' if 'embeds' in batch else 'tokens'}): "
          f"{seconds:.3f} s (again {warm_seconds:.4f} s), launches {counts}, "
          f"peak memory {peak / 2**30:.3f} GiB")
    run = lambda: prefill(params, batch)  # noqa: E731
    kernel, plain, layers = both_paths(torch, flags, modules, cfg, run)
    faulty = None
    if k1:
        real = modules["attention"].flash_attention
        modules["attention"].flash_attention = shifted_keys_attention(real)
        try:
            if layers:
                faulty = follow_routing(torch, flags, modules, run, layers,
                                        force_plain=False)
            else:
                faulty = run()
                torch.cuda.synchronize()
        finally:
            modules["attention"].flash_attention = real
    row = {"B": b, "S": s, "layers": cfg.n_layers, "seconds": seconds,
           "warm_seconds": warm_seconds, "peak_bytes": peak,
           "launches": counts, "flash_attention_bodies": bodies}
    if layers:
        row["routing"] = routing_row(cfg, layers)
    return row, (kernel, plain, layers, faulty)


def run_slice_f32(torch, cfg, flags, make_prefill_step, init_params,
                  modules, bf16):
    """The same configuration in f32 at the same depth, on the weights the
    bf16 run rounded (`init_params` draws in f32 and casts).
    * f32: the kernel path against the forced-plain path, phase 6's rule
      (2e-3 of the largest logit, top-1 agreement >= 0.99), every routing
      flip explained; K1's band one key off outside it where the
      configuration runs K1.
    * bf16: phase 4's rule (2e-2) cannot hold at every depth: bf16 moves
      random-weight logits by more under any change in the order of
      rounding (C-watch 5; musicgen-medium's 48 layers read 2.2e-2).  So,
      as phase 6, each bf16 path is held against the f32 plain path
      following the bf16 kernel path's routing: the kernel path's mean abs
      error at most 1.1x the plain path's, its top-1 agreement at most
      0.02 lower; phase 4's numbers are printed beside.  The bf16 kernel
      path with K1's band one key off, where the configuration runs K1,
      must fall outside this gate."""
    kernel16, plain16, layers16, faulty16 = bf16
    cfg32 = replace(cfg, dtype="float32")
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(0))
    batch = slice_inputs(torch, cfg32, SLICE_B, SLICE_S)
    prefill = make_prefill_step(cfg32)
    run = lambda: prefill(params, batch)  # noqa: E731
    t0 = time.perf_counter()
    kernel, plain, layers = both_paths(torch, flags, modules, cfg32, run)
    seconds = time.perf_counter() - t0
    err, scale, _, top1 = logits_gap(kernel, plain)
    rel_tol = 2e-3
    row = {"dtype": "float32", "layers": cfg32.n_layers, "seconds": seconds,
           "max_abs_err": err, "max_abs_logit": scale, "top1": top1,
           "rel_tol": rel_tol}
    if layers:
        row["routing"] = routing_row(cfg32, layers)
    del kernel, plain
    print(f"    float32 at {cfg32.n_layers} layers: logits max|kernel-plain| "
          f"{err:.4e} of max|logit| {scale:.3f} (tol {rel_tol:g} x "
          f"max|logit|), top-1 agreement {top1:.5f}")
    require(err <= rel_tol * scale, f"phase 18 {cfg.name} f32: kernel vs "
            f"plain logits differ by {err}")
    require(top1 >= 0.99, f"phase 18 {cfg.name} f32: top-1 agreement "
            f"{top1} < 0.99")
    if SLICE_LAUNCHES[cfg.name][0]:
        real = modules["attention"].flash_attention
        modules["attention"].flash_attention = shifted_keys_attention(real)
        try:
            f_kernel, f_plain, _ = both_paths(torch, flags, modules, cfg32,
                                              run)
        finally:
            modules["attention"].flash_attention = real
        f_err, f_scale, _, _ = logits_gap(f_kernel, f_plain)
        del f_kernel, f_plain
        row["band_one_key_off"] = f_err
        print(f"    float32, K1's band one key off: {f_err:.4e} of "
              f"{f_scale:.3f}")
        require(f_err > rel_tol * f_scale, f"phase 18 {cfg.name}: K1 with "
                f"its band one key off gives {f_err}, within {rel_tol} x "
                f"{f_scale}: the check cannot see it")

    # the bf16 gate: both bf16 paths against the f32 plain path
    if layers16:
        truth = follow_routing(torch, flags, modules, run, layers16)
    else:
        with flags(force_plain=True):
            truth = run()
    drift = {"kernel": logits_gap(kernel16, truth),
             "plain": logits_gap(plain16, truth),
             "kernel_vs_plain": logits_gap(kernel16, plain16)}
    if faulty16 is not None:
        drift["band_one_key_off"] = logits_gap(faulty16, truth)
    del truth, params
    torch.cuda.empty_cache()
    (_, _, k_mean, k_top1), (_, _, p_mean, p_top1) = \
        drift["kernel"], drift["plain"]
    kp_err, kp_scale, _, kp_top1 = drift["kernel_vs_plain"]
    print(f"    bfloat16 at {cfg.n_layers} layers, against the f32 plain "
          f"path: kernel mean {k_mean:.5f} top-1 {k_top1:.5f}, plain mean "
          f"{p_mean:.5f} top-1 {p_top1:.5f} (gate: mean <= 1.1x, top-1 >= "
          f"plain's - 0.02); kernel vs plain (phase 4's rule, printed): "
          f"{kp_err:.4e} of {kp_scale:.3f} ({kp_err / kp_scale:.4f}), top-1 "
          f"{kp_top1:.5f}")
    require(k_mean <= 1.1 * p_mean and k_top1 >= p_top1 - 0.02,
            f"phase 18 {cfg.name} bf16: kernel path mean error {k_mean}, "
            f"top-1 {k_top1} vs f32; plain path {p_mean}, {p_top1}")
    if faulty16 is not None:
        _, _, f_mean, f_top1 = drift["band_one_key_off"]
        print(f"    bfloat16, K1's band one key off, against the f32 plain "
              f"path: mean {f_mean:.5f} ({f_mean / p_mean:.3f}x the plain "
              f"path's), top-1 {f_top1:.5f}")
        require(f_mean > 1.1 * p_mean or f_top1 < p_top1 - 0.02,
                f"phase 18 {cfg.name} bf16: K1 with its band one key off "
                f"gives mean error {f_mean}, top-1 {f_top1}, within the "
                f"gate (plain path {p_mean}, {p_top1}): the gate cannot "
                f"see it")
    row["bf16_drift"] = {k: dict(zip(("max", "scale", "mean", "top1"), v))
                         for k, v in drift.items()}
    return row


def run_mla_decode(torch, cfg, init_params, forward, ServeEngine, Request):
    """deepseek-v2 at full width, 2 layers (one dense, one MoE), f32: a
    prompt of 64 tokens fed through the absorbed MLA decode (one slot), its
    last 8 logits against `forward`'s on the same tokens, within 2e-5 of the
    largest logit (phase 8's rule).  The capacity factor is raised to
    E / k so `forward`'s routing of the 64 tokens drops nothing: decode
    routes each token alone, and the two routings differ only in drops.
    Decode reading `wkv_b` in the reference's decode layout (every head's
    nope columns, then every head's v columns) must fall outside."""
    cfg = replace(cfg, n_layers=2, dtype="float32",
                  capacity_factor=cfg.n_experts / cfg.top_k)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(8)
    n_prompt, last = 64, 8
    prompt = torch.randint(0, cfg.vocab_size, (n_prompt,), generator=gen,
                           device="cuda").tolist()
    full, _ = forward(params, cfg, torch.tensor([prompt], device="cuda"),
                      chunk=64)
    expect = full[0, n_prompt - last:]
    scale = expect.abs().max().item()

    def decoded(p):
        engine = ServeEngine(cfg, p, batch_slots=1, max_len=128)
        engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
        out = []
        while engine.active:
            engine.tick()
            if engine.ticks > n_prompt - last:
                out.append(engine.last_logits[0].clone())
        return torch.stack(out)

    t0 = time.perf_counter()
    got = decoded(params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = (got - expect).abs().max().item()
    same_top1 = bool((got.argmax(-1) == expect.argmax(-1)).all().item())
    h, nope = cfg.n_heads, cfg.qk_nope_head_dim
    swapped = {**params, "groups": []}
    for group in params["groups"]:
        w = group["attn"]["wkv_b"]
        per_head = w.reshape(w.shape[:-1] + (h, -1))
        w_ref = torch.cat([per_head[..., :nope].flatten(-2),
                           per_head[..., nope:].flatten(-2)], dim=-1)
        swapped["groups"].append({**group, "attn": {**group["attn"],
                                                    "wkv_b": w_ref}})
    layout_err = (decoded(swapped) - expect).abs().max().item()
    rel_tol = 2e-5
    print(f"  deepseek-v2 MLA decode after prefill ({cfg.n_layers} layers, "
          f"f32, {n_prompt} prompt tokens by decode in {seconds:.3f} s): "
          f"last {last} logits max|decode-forward| {err:.3e} of max|logit| "
          f"{scale:.3f} (tol {rel_tol:g} x max|logit|), same top-1: "
          f"{same_top1}; wkv_b in the reference's decode layout: "
          f"{layout_err:.3e}")
    require(err <= rel_tol * scale, f"phase 18: MLA decode vs forward "
            f"logits differ by {err}")
    require(same_top1, "phase 18: MLA decode and forward disagree on a "
            "top-1")
    require(layout_err > rel_tol * scale, f"phase 18: decode in the "
            f"reference's wkv_b layout gives {layout_err}, within the "
            f"tolerance: the check cannot see it")
    del params, swapped
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "prompt": n_prompt, "seconds": seconds,
            "max_abs_err": err, "max_abs_logit": scale,
            "reference_layout_err": layout_err}


def run_moe_leo(torch, core, cfg, params, loss_fn, layers: int):
    """LEO on phi3.5-moe's loss at full width, `layers` deep (the first
    layers of the main path's weights), B 4 x S 1024, bf16: captured and
    diagnosed on `nvidia_h100_sxm`; its estimate beside the card's time of
    the same loss, and the MoE's scatter-adds classed MEMORY_STORE (two a
    MoE layer: the aux counts and the dispatch)."""
    cfg = replace(cfg, n_layers=layers)

    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:layers]

    params = {**params, "groups": [first(g) for g in params["groups"]]}
    batch = slice_inputs(torch, cfg, SLICE_B, SLICE_S)
    batch["labels"] = batch["tokens"]
    loss = lambda: loss_fn(params, cfg, batch)  # noqa: E731
    measured_ms = call_ms(torch, loss, samples=5, reps=2)
    t0 = time.perf_counter()
    module = core.capture(lambda p, b: loss_fn(p, cfg, b), params, batch,
                          name="loss_moe")
    capture_s = time.perf_counter() - t0
    an = core.analyze_module(module, core.get_backend("nvidia_h100_sxm"))
    instructions = list(module.all_instructions())
    stores = [i for i in instructions
              if i.attributes.get("aten") == "index_add" and
              i.op_class is core.OpClass.MEMORY_STORE]
    moe_layers = max(0, layers - cfg.first_dense_layers)
    row = {"layers": layers, "instructions": len(instructions),
           "kernel_regions": module.kernel_calls, "capture_s": capture_s,
           "estimated_step_s": an.estimated_step_seconds,
           "measured_ms": measured_ms, "moe_scatter_stores": len(stores),
           "chains": len(an.chains)}
    print(f"  LEO on {cfg.name}'s loss ({layers} layers, B{SLICE_B} "
          f"S{SLICE_S}, bf16): {len(instructions)} instructions (regions "
          f"{module.kernel_calls}) captured in {capture_s:.2f} s; LEO "
          f"estimate {an.estimated_step_seconds * 1e3:.3f} ms beside "
          f"{measured_ms:.3f} ms measured; {len(stores)} MoE scatter-adds "
          f"classed MEMORY_STORE; {len(an.chains)} chains")
    require(len(stores) == 2 * moe_layers, f"phase 18: {len(stores)} MoE "
            f"scatter-adds classed MEMORY_STORE, expected {2 * moe_layers}")
    require(an.chains or an.blame.occupancy_blame,
            "phase 18: LEO produced no diagnosis of the MoE loss")
    return row


def time_parts(torch, run, parts):
    """Device time of each named function while `run()` runs: CUDA events
    recorded on the stream before and after every call (`parts`: name ->
    (module, attribute), patched for the run), summed; and of the whole
    run.  Events mark the stream, so where the host falls behind the card
    a part's time holds the card's wait too; nested parts are counted in
    their parents."""
    events = {name: [] for name in parts}
    saved = []
    for name, (module, attr) in parts.items():
        real = getattr(module, attr)

        def timed(*args, _real=real, _name=name, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _real(*args, **kwargs)
            end.record()
            events[_name].append((start, end))
            return out

        saved.append((module, attr, real))
        setattr(module, attr, timed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        for module, attr, real in saved:
            setattr(module, attr, real)
    ms = {name: sum(a.elapsed_time(b) for a, b in evs)
          for name, evs in events.items()}
    ms["calls"] = {name: len(evs) for name, evs in events.items()}
    ms["total"] = start.elapsed_time(end)
    return ms


def moe_time_parts(torch, np, cfg, params, modules, make_prefill_step,
                   ServeEngine, Request, ticks: int = 16):
    """Where the time goes in one bf16 MoE prefill (B 4 x S 1024) and in a
    steady decode tick (8 slots), printed, not gated: the MoE layer
    (`moe_groups`) and, inside it, the routing (`route`: router product,
    softmax, sort, aux), the dispatch's sort and ranks (`dispatch`), the
    expert products (`_experts`) and the shared experts (`mlp`), the rest
    being the buffer fill and the combine; K1, K2, and MLA's attention
    (`chunked_attention` in prefill, `mla_decode` a tick)."""
    moe, attn, tmod = modules["moe"], modules["attention"], \
        modules["transformer"]
    parts = {"moe": (moe, "moe_groups"), "route": (moe, "route"),
             "dispatch": (moe, "dispatch"), "experts": (moe, "_experts"),
             "shared": (moe, "mlp"), "K1": (attn, "flash_attention"),
             "K2 (ln1, ln2, final)": (tmod, "rmsnorm"),
             "K2 (MLA norms)": (attn, "rmsnorm")}
    if cfg.attention == "mla":
        parts["MLA attention"] = (attn, "chunked_attention")
    batch = slice_inputs(torch, cfg, SLICE_B, SLICE_S)
    prefill = make_prefill_step(cfg)
    prefill_ms = time_parts(torch, lambda: prefill(params, batch), parts)
    if cfg.attention == "mla":
        parts["MLA attention"] = (attn, "mla_decode")
    rng = np.random.default_rng(5)
    engine = ServeEngine(cfg, params, 8, 1024)
    for i in range(8):
        engine.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, size=16)], max_new_tokens=ticks + 16))
    for _ in range(8):
        engine.tick()

    def steady():
        for _ in range(ticks):
            engine.tick()

    tick_ms = time_parts(torch, steady, parts)
    tick_ms = {k: (v if k == "calls" else v / ticks)
               for k, v in tick_ms.items()}
    for name, row in (("prefill", prefill_ms), ("decode tick", tick_ms)):
        rest = row["moe"] - sum(row[k] for k in ("route", "dispatch",
                                                   "experts", "shared"))
        row["fill_and_combine"] = rest
        print(f"    {cfg.name} {name} ({row['total']:.3f} ms on the "
              f"stream): " + ", ".join(
                  f"{k} {row[k]:.3f}" for k in (
                      "moe", "route", "dispatch", "experts", "shared",
                      "fill_and_combine", "K1", "K2 (ln1, ln2, final)",
                      "K2 (MLA norms)", "MLA attention") if k in row)
              + " ms")
    return {"prefill": prefill_ms, "decode_tick": tick_ms}


def run_slice(torch, np, ops, core, flags, get_config, init_params, forward,
              loss_fn, make_prefill_step, ServeEngine, Request, gpu_name,
              layer_descriptors, modules):
    """Phase 18 for each configuration of SLICE_ARCHS: the bf16 prefill
    (launch counts, the kernel path against the plain path), the f32
    comparison, continuous-batching serve; deepseek-v2's MLA decode after
    prefill; LEO on phi3.5-moe's loss."""
    out = {}
    for name, layers in SLICE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if layers:
            cfg = replace(cfg, n_layers=layers)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0))
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"  {name} at full width ({cfg.n_layers} layers"
              f"{'' if layers is None else ' of ' + str(get_config(name).n_layers)}"
              f", d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
              f"{cfg.dtype}, random weights from seed 0)")
        torch.cuda.reset_peak_memory_stats()
        row = {}
        row["prefill"], bf16 = run_slice_prefill(
            torch, ops, cfg, params, flags, make_prefill_step, modules)
        moe = cfg.n_experts > 0
        serve = run_serve(torch, np, ops, cfg, params, ServeEngine, Request,
                          gpu_name, norm_launches(cfg, layer_descriptors),
                          n_req=10 if moe else 12, new=16 if moe else 32)
        serve["norms_per_tick"] = norm_launches(cfg, layer_descriptors)
        row["serve"] = serve
        if moe:
            row["time_parts"] = moe_time_parts(
                torch, np, cfg, params, modules, make_prefill_step,
                ServeEngine, Request)
        if name == "phi3.5-moe-42b-a6.6b":
            row["leo"] = run_moe_leo(torch, core, cfg, params, loss_fn,
                                     MOE_LEO_LAYERS)
        del params
        torch.cuda.empty_cache()
        row["f32"] = run_slice_f32(torch, cfg, flags, make_prefill_step,
                                   init_params, modules, bf16)
        del bf16
        torch.cuda.empty_cache()
        if cfg.attention == "mla":
            row["mla_decode"] = run_mla_decode(
                torch, get_config(name), init_params, forward, ServeEngine,
                Request)
        row["seconds"] = time.perf_counter() - t0
        print(f"  {name}: {row['seconds']:.1f} s")
        out[name] = row
    return out


# -- phase 19 -----------------------------------------------------------------

# Phase 19's captures: hymba-1.5b at full width with its depth cut to this
# many layers (a layer records ~3,300 instructions at B 2 x S 2048, 16 chunks
# of the scan; at 32 layers the two captures would take minutes)
FUSED_LEO_LAYERS = 8
SSM_FORMS = {"default": {}, "fused": {"ssm_fused": True, "ssm_pallas": True}}
# the K4 entry each form launches, and the one it must not
SSM_ENTRY = {"default": ("ssm_scan", "ssm_scan_fused"),
             "fused": ("ssm_scan_fused", "ssm_scan")}


def late_selection(torch, ssm_scan_fused):
    """K4's fused entry fed `bsel` one step late (B_{t-1} in step t's bx),
    a fault of the input timing: dt and bx's x come from the same xin
    inside the kernel, so a late dt cannot be fed from outside."""
    def late(xin, w_dt, a_log, bsel, csel, **kwargs):
        shifted = torch.cat([torch.zeros_like(bsel[:, :1]), bsel[:, :-1]],
                            dim=1)
        return ssm_scan_fused(xin, w_dt, a_log, shifted, csel, **kwargs)
    late.check = ssm_scan_fused.check
    return late


def run_fused_ssm(torch, ops, core, cfg, flags, make_prefill_step,
                  init_params, loss_fn, ssm_module):
    """hymba-1.5b at full width, B 2 x S 2048, under the SSM's default form
    (a and bx materialised, K4's `ssm_scan`) and its fused form
    (`ssm_fused=True, ssm_pallas=True`, K4's `ssm_scan_fused`, xin in, y
    out).

    * bf16, 32 layers: each form's prefill with exact launch counts (K1 32
      and K2 65 in both; the form's K4 entry 32, the other 0), its
      `torch.profiler` busy ms and its `max_memory_allocated`, also above
      what was allocated before the call.
    * f32, 32 layers: the fused kernel path against the forced-plain path
      of the same form (phase 6's rule: 2e-3 of the largest logit, top-1 >=
      0.99), the fused entry with `bsel` one step late outside that limit,
      and the fused kernel path against the default kernel path by the
      same rule.
    * LEO, FUSED_LEO_LAYERS layers at full width, bf16: each form's
      `loss_fn` timed on the card and captured, both diagnosed on
      `nvidia_h100_sxm` and held to the four cases of `tests/
      test_system.py::TestLeoGuidedLoop` (the fused form's memory term
      below the default's, FLOPs within 1%); each scan region records
      S/128 chunks a layer."""
    b, s = 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prefill = make_prefill_step(cfg)
    runs, logits16 = {}, {}
    for name, kw in SSM_FORMS.items():
        with flags(**kw):
            prefill(params, {"tokens": tokens[:, :128]})  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            profile = profile_prefill(torch, prefill, params, tokens)
        on, off = SSM_ENTRY[name]
        expect = {"flash_attention": cfg.n_layers,
                  "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
                  "rmsnorm_baseline": 0, on: cfg.n_layers, off: 0,
                  "mlstm_chunkwise": 0, "slstm_scan": 0}
        require(counts == expect, f"phase 19 {name}: launches {counts}, "
                f"expected {expect}")
        require(tuple(logits.shape) == (b, s, cfg.vocab_size) and
                torch.isfinite(logits).all().item(),
                f"phase 19 {name}: logits {tuple(logits.shape)} or not "
                f"finite")
        logits16[name] = logits
        # the prefill's own peak: above what was held before the call (the
        # weights, and the other form's logits kept for the comparison)
        runs[name] = {"seconds": seconds, "launches": counts,
                      "peak_bytes": peak, "held_bytes": held,
                      "prefill_peak_bytes": peak - held, "profile": profile}
        print(f"  {name} form, bf16 prefill B{b} S{s}: {seconds:.3f} s, "
              f"launches {counts}, peak {peak / 2**30:.3f} GiB, "
              f"{(peak - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} held before it")
    bf16_gap = {
        "max": (logits16["fused"] - logits16["default"]).abs().max().item(),
        "scale": logits16["default"].abs().max().item(),
        "top1": (logits16["fused"].argmax(-1) == logits16["default"].argmax(
            -1)).float().mean().item()}
    print(f"  bf16 fused against default (printed, not gated: bf16 drifts "
          f"with random weights): max {bf16_gap['max']:.4f} of max|logit| "
          f"{bf16_gap['scale']:.3f}, top-1 {bf16_gap['top1']:.5f}")
    del params, logits16, logits
    torch.cuda.empty_cache()

    cfg32 = replace(cfg, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        0))
    prefill32 = make_prefill_step(cfg32)
    batch = {"tokens": tokens}
    with flags(**SSM_FORMS["fused"]):
        ops.reset_launch_counts()
        fused32 = prefill32(params32, batch)
        fused_counts = ops.launch_counts()
        with flags(force_plain=True):
            plain32 = prefill32(params32, batch)
        real = ssm_module.ssm_scan_fused
        ssm_module.ssm_scan_fused = late_selection(torch, real)
        try:
            late32 = prefill32(params32, batch)
        finally:
            ssm_module.ssm_scan_fused = real
    default32 = prefill32(params32, batch)
    torch.cuda.synchronize()
    require(fused_counts["ssm_scan_fused"] == cfg.n_layers and
            fused_counts["ssm_scan"] == 0,
            f"phase 19 f32: launches {fused_counts}")
    require(torch.isfinite(fused32).all().item(),
            "phase 19 f32 fused logits not finite")
    rel_tol = 2e-3

    def against(x, ref):
        diff = (x - ref).abs()
        top1 = (x.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return {"max": diff.max().item(), "top1": top1,
                "scale": ref.abs().max().item()}

    f32 = {"fused_vs_plain": against(fused32, plain32),
           "late_vs_plain": against(late32, plain32),
           "fused_vs_default": against(fused32, default32)}
    for key, r in f32.items():
        print(f"  f32 {key.replace('_', ' ')}: max {r['max']:.3e} of "
              f"max|logit| {r['scale']:.3f} (tol {rel_tol:g} x), top-1 "
              f"{r['top1']:.5f}")
    for key in ("fused_vs_plain", "fused_vs_default"):
        r = f32[key]
        require(r["max"] <= rel_tol * r["scale"] and r["top1"] >= 0.99,
                f"phase 19 f32 {key}: {r}")
    r = f32["late_vs_plain"]
    require(r["max"] > rel_tol * r["scale"],
            f"phase 19: bsel one step late moves the f32 logits by "
            f"{r['max']}, within the tolerance: the check cannot see it")
    del params32, fused32, plain32, late32, default32
    torch.cuda.empty_cache()

    cfg_l = replace(cfg, n_layers=FUSED_LEO_LAYERS)
    params_l = init_params(cfg_l, torch.Generator(device="cuda").manual_seed(
        0))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    backend = core.get_backend("nvidia_h100_sxm")
    diag = {}
    for name, kw in SSM_FORMS.items():
        with flags(**kw):
            loss_fn(params_l, cfg_l, batch)  # warm-up
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = loss_fn(params_l, cfg_l, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            require(math.isfinite(loss.item()), f"phase 19 {name}: loss")
            t0 = time.perf_counter()
            module = core.capture(lambda p, bt: loss_fn(p, cfg_l, bt),
                                  params_l, batch, name=f"hymba_{name}")
            capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        an = core.analyze_module(module, backend)
        analysis_s = time.perf_counter() - t0
        roof = core.compute_roofline(module, backend.hw, chips=1, label=name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ctx = core.diagnostic_context("C+L(S)", "loss_fn", an)
        scoped = [link for c in an.chains for link in c.links
                  if link.op_name]
        on = SSM_ENTRY[name][0]
        mark = f"{core.FUSED_REGION_MARK}:{on}"
        readouts = sum(1 for i in module.all_instructions()
                       if mark in i.op_name and i.opcode == "bmm")
        diag[name] = {
            "layers": FUSED_LEO_LAYERS, "loss": loss.item(),
            "instructions": sum(1 for _ in module.all_instructions()),
            "kernel_regions": module.kernel_calls, "readouts": readouts,
            "capture_s": capture_s, "analysis_s": analysis_s,
            "estimated_step_s": an.estimated_step_seconds,
            "measured_s": statistics.median(times),
            "memory_s": roof.memory_s, "compute_s": roof.compute_s,
            "hlo_flops": roof.hlo_flops,
            "coverage": [an.coverage_before.coverage,
                         an.coverage_after.coverage],
            "chains": len(an.chains), "scoped_links": len(scoped),
            "recommendations": "Recommendations" in ctx}
        d = diag[name]
        print(f"  {name} form, loss at {FUSED_LEO_LAYERS} layers: captured "
              f"{d['instructions']} instructions (regions "
              f"{d['kernel_regions']}) in {capture_s:.2f} s, diagnosed in "
              f"{analysis_s:.2f} s; LEO estimated "
              f"{d['estimated_step_s'] * 1e3:.3f} ms beside "
              f"{d['measured_s'] * 1e3:.3f} ms measured; roofline memory "
              f"{d['memory_s'] * 1e3:.3f} ms, compute "
              f"{d['compute_s'] * 1e3:.3f} ms; coverage "
              f"{d['coverage'][0]:.4f} -> {d['coverage'][1]:.4f}; "
              f"{d['chains']} chains")
        require(an.chains or an.blame.occupancy_blame,
                f"phase 19 {name}: LEO produced no diagnosis")
        require(scoped, f"phase 19 {name}: no chain carries an op_name "
                f"scope")
        require(d["coverage"][1] >= d["coverage"][0],
                f"phase 19 {name}: coverage degraded {d['coverage']}")
        require(d["recommendations"], f"phase 19 {name}: no "
                f"Recommendations")
        require(module.kernel_calls.get(on) == FUSED_LEO_LAYERS and
                SSM_ENTRY[name][1] not in module.kernel_calls,
                f"phase 19 {name}: regions {module.kernel_calls}")
        require(readouts == FUSED_LEO_LAYERS * s // 128,
                f"phase 19 {name}: {readouts} readouts, not S/128 a layer")
    require(diag["fused"]["memory_s"] < diag["default"]["memory_s"],
            f"phase 19: memory term {diag['default']['memory_s']} -> "
            f"{diag['fused']['memory_s']} did not drop")
    flops = (diag["default"]["hlo_flops"], diag["fused"]["hlo_flops"])
    require(abs(flops[1] - flops[0]) <= 0.01 * flops[0],
            f"phase 19: FLOPs {flops} not within 1%")
    return {"B": b, "S": s, "bf16": runs, "bf16_fused_vs_default": bf16_gap,
            "f32": f32, "leo": diag}


# -- phase 20 -----------------------------------------------------------------

# Phase 20: the dry run's cells on the card's own mesh, `make_host_mesh(1)`,
# each at an earlier phase's size: (arch, layers kept or None, (kind, S,
# B), model flags).  hymba-1.5b is cut to phase 19's captured depth: a
# layer records ~3,300 instructions at B 2 x S 2048, and the phase
# captures each cell twice (the dry run's stand-ins, the real tensors).
DRY_CELLS = (
    ("qwen2-0.5b", None, ("prefill", 1024, 4), {}),
    ("qwen2-0.5b", None, ("train", TRAIN_S, TRAIN_B), {}),
    ("qwen2-0.5b", None, ("decode", 1024, 8), {}),
    ("hymba-1.5b", FUSED_LEO_LAYERS, ("prefill", 2048, 2),
     {"ssm_fused": True, "ssm_pallas": True}),
    ("phi3.5-moe-42b-a6.6b", 8, ("prefill", SLICE_S, SLICE_B),
     {"moe_impl": "ep_shardmap"}),
    ("phi3.5-moe-42b-a6.6b", 2, ("train", TRAIN_S, TRAIN_B), {}),
)
DRY_BACKEND = "nvidia_h100_sxm"
# the f32 comparison of the two MoE forms: phi3.5-moe's first layers
EP_F32_LAYERS = 2
EP_F32_TOL = 1e-5


def real_cell_inputs(torch, cfg, shape, init_params, init_train_state,
                     init_decode_state):
    """Real tensors on the card with the structure, shapes and dtypes of
    `launch/specs.py::input_specs` (weights and batch from seed 0)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"token": torch.randint(0, cfg.vocab_size, (b,),
                                        generator=gen, device="cuda",
                                        dtype=torch.int32),
                 "pos": torch.tensor(s // 2, dtype=torch.int32,
                                     device="cuda")}
    else:
        batch = {"labels": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)}
        if cfg.frontend != "none":
            batch["embeds"] = (0.02 * torch.randn(
                (b, s, cfg.d_model), generator=gen, device="cuda")).to(
                    torch.bfloat16)
        else:
            batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                            generator=gen, device="cuda",
                                            dtype=torch.int32)
    inputs = {"batch": batch}
    if shape.kind == "train":
        inputs["state"] = init_train_state(cfg, gen)
    else:
        inputs["params"] = init_params(cfg, gen)
    if shape.kind == "decode":
        inputs["decode_state"] = init_decode_state(cfg, b, s)
    return inputs


def module_totals(module):
    instrs = list(module.all_instructions())
    return {"instructions": len(instrs), "flops": module.total_flops(),
            "bytes": sum(i.bytes_read + i.bytes_written for i in instrs)}


def run_dry_cell(torch, ops, core, dryrun, mesh, mesh_context, flags, cfg,
                 shape, model_flags, inputs):
    """One cell: `lower_cell` on the meta stand-ins, then the same step
    captured from the real tensors and run once on the card with the
    launch counts zeroed.  Exactly: the dry run's argument bytes are the
    real arguments' `nbytes`, its Module has the direct capture's
    instructions, FLOPs and bytes, and its kernel regions are the launches
    the real step made.  Printed: the step's ms (CUDA events around eager
    calls), the roofline's and LEO's estimates, the peak memory and the
    capture seconds."""
    label = f"{cfg.name}__{shape.name}__host"
    with flags(**model_flags):
        module, memory, capture_s = dryrun.lower_cell(cfg, shape, mesh)
        real_bytes = sum(t.numel() * t.element_size() for t in _leaves(
            dryrun.program_inputs(shape, inputs, dryrun.unread_leaves(
                shape, module))))
        step, args = dryrun.cell_program(
            cfg, shape, inputs, "cuda", dryrun.cell_options(cfg, shape,
                                                            mesh))
        with mesh_context(mesh):
            t0 = time.perf_counter()
            direct = core.capture(step, *args)
            direct_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            out = step(*args)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            bodies = dict(ops.flash_attention.body_launches)
            peak = torch.cuda.max_memory_allocated()
            ms = call_ms(torch, lambda: step(*args), samples=5, reps=1)
    dry, real = module_totals(module), module_totals(direct)
    launched = {k: v for k, v in counts.items() if v}
    rl = core.compute_roofline(module, core.get_backend(DRY_BACKEND).hw,
                               chips=1, label=label)
    t0 = time.perf_counter()
    an = core.analyze_module(module, core.get_backend(DRY_BACKEND))
    analyze_s = time.perf_counter() - t0
    print(f"  {label} ({cfg.n_layers} layers, B{shape.global_batch} "
          f"S{shape.seq_len}{', ' if model_flags else ''}"
          f"{', '.join(f'{k}={v}' for k, v in model_flags.items())}): "
          f"{ms:.3f} ms a step measured; roofline {rl.bound_s * 1e3:.3f} ms "
          f"({rl.dominant}-bound), LEO {an.estimated_step_seconds * 1e3:.3f} "
          f"ms; peak memory {peak / 2**30:.3f} GiB; captured in "
          f"{capture_s:.2f} s (from the real tensors {direct_s:.2f} s), "
          f"analysed in {analyze_s:.2f} s")
    print(f"    arguments {memory['argument_size_in_bytes']} bytes (real "
          f"{real_bytes}), outputs {memory['output_size_in_bytes']}; module "
          f"{dry} (from the real tensors {real}); kernel regions "
          f"{module.kernel_calls}, launches {launched}")
    require(memory["argument_size_in_bytes"] == real_bytes,
            f"phase 20 {label}: the dry run's argument bytes "
            f"{memory['argument_size_in_bytes']} are not the real "
            f"arguments' {real_bytes}")
    require(dry == real, f"phase 20 {label}: the dry run's module {dry} "
            f"differs from the capture of the real tensors {real}")
    require(module.kernel_calls == launched, f"phase 20 {label}: kernel "
            f"regions {module.kernel_calls}, launches {launched}")
    require(launched, f"phase 20 {label}: the step launched no kernel")
    row = {"label": label, "layers": cfg.n_layers, "B": shape.global_batch,
           "S": shape.seq_len, "flags": model_flags, "memory": memory,
           "real_argument_bytes": real_bytes, "module": dry,
           "kernel_regions": module.kernel_calls, "launches": counts,
           "flash_attention_bodies": bodies, "ms": ms, "peak_bytes": peak,
           "roofline_s": rl.bound_s, "roofline_dominant": rl.dominant,
           "leo_s": an.estimated_step_seconds, "capture_s": capture_s,
           "direct_capture_s": direct_s, "analyze_s": analyze_s}
    return row, out


@contextlib.contextmanager
def recorded_routes(moe_module):
    """Every call of `moe.route` while the block runs, in order: the layer
    (its router's address; the checkpoint's recomputation calls it with the
    forward's tensors) and its expert ids, and at a layer's first call its
    router input (f32), router, probabilities and top-k margins.  Nothing
    is patched where `moe_module` is None."""
    calls = []
    if moe_module is None:
        yield calls
        return
    real = moe_module.route

    def route(p, xf, cfg):
        r = real(p, xf, cfg)
        key = p["router"].data_ptr()
        first = all(c["key"] != key for c in calls)
        calls.append({"key": key, "expert_ids": r.expert_ids.detach(),
                      **({"xf": xf.detach().float(),
                          "router": p["router"].detach(),
                          "probs": r.probs.detach(),
                          "margin": r.margin.detach()} if first else {})})
        return r

    moe_module.route = route
    try:
        yield calls
    finally:
        moe_module.route = real


def routed(torch, moe_module, run):
    """`run()`, a prefill, with every call of `moe.route` recorded
    (`recorded_routes`): the expert ids, sorted, and top-k margins of each
    MoE layer, in order."""
    with recorded_routes(moe_module) as calls:
        out = run()
        torch.cuda.synchronize()
    return out, [(c["expert_ids"].sort(-1).values, c["margin"])
                 for c in calls]


def compare_moe_forms(torch, flags, moe_module, run, dt_name):
    """`run()` under moe_impl="ep_shardmap" and "global" on the same
    inputs: the logits' gap and the routing flips of each MoE layer, each
    flip with the global form's margin."""
    with flags(moe_impl="ep_shardmap"):
        ep, ep_calls = routed(torch, moe_module, run)
    with flags(moe_impl="global"):
        glob, glob_calls = routed(torch, moe_module, run)
    require(len(ep_calls) == len(glob_calls) > 0, f"phase 20: "
            f"{len(ep_calls)} / {len(glob_calls)} MoE layers routed")
    flips, margins = 0, []
    for (ids_ep, _), (ids_g, margin) in zip(ep_calls, glob_calls):
        flip = (ids_ep != ids_g).any(-1)
        flips += int(flip.sum())
        margins += margin[flip].tolist()
    err, scale, _, top1 = logits_gap(ep, glob)
    print(f"    {dt_name} ep_shardmap vs global: logits max gap {err:.4e} of "
          f"max|logit| {scale:.3f}, top-1 agreement {top1:.5f}, "
          f"{flips} routing flips over {len(ep_calls)} MoE layers (margins "
          f"{[f'{m:.3e}' for m in margins]}), bit for bit "
          f"{bool(torch.equal(ep, glob))}")
    return {"dtype": dt_name, "max_abs_err": err, "max_abs_logit": scale,
            "top1": top1, "flips": flips, "flip_margins": margins,
            "moe_layers": len(ep_calls), "equal": bool(torch.equal(ep, glob))}


def run_dryrun(torch, ops, core, flags, get_config, init_params,
               init_train_state, init_decode_state, make_prefill_step,
               moe_module):
    """Phase 20: the dry run (`launch/dryrun.py`) on the card's own mesh.
    Each cell of DRY_CELLS through `run_dry_cell`; the EP MoE against the
    global form (phi3.5-moe: bf16 at the cell's depth, phase 4's rule with
    every routing flip at a margin within ROUTE_FLOOR; f32 at
    EP_F32_LAYERS layers within EP_F32_TOL of the largest logit, the
    routing equal); qwen2-0.5b's prefill under `sequence_parallel` equal
    bit for bit to the cell's; a dry run handed one leaf of the wrong
    dtype failing the byte equality; then `run_cell` over every config x
    its shapes x the production meshes (specs only), the cells that fit
    the card listed."""
    from repro_torch.configs import (ALL_ARCHS, LONG_500K, ShapeConfig,
                                     shapes_for)
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.context import mesh_context

    t_phase = time.perf_counter()
    mesh = make_host_mesh(1)
    require(mesh.shape == {"data": 1, "model": 1} and
            mesh.device.type == "cuda", f"phase 20: host mesh {mesh}")
    print(f"  host mesh {mesh.shape} on {mesh.devices}")
    rows, extra = [], {}
    for arch, layers, (kind, s, b), model_flags in DRY_CELLS:
        cfg = get_config(arch)
        if layers:
            cfg = replace(cfg, n_layers=layers)
        shape = ShapeConfig(f"{kind}_{b}x{s}", s, b, kind)
        inputs = real_cell_inputs(torch, cfg, shape, init_params,
                                  init_train_state, init_decode_state)
        row, out = run_dry_cell(torch, ops, core, dryrun, mesh,
                                mesh_context, flags, cfg, shape,
                                model_flags, inputs)
        rows.append(row)
        if arch == ARCH and kind == "prefill":
            with mesh_context(mesh), flags(sequence_parallel=True):
                sp = make_prefill_step(cfg)(inputs["params"],
                                            inputs["batch"])
            torch.cuda.synchronize()
            same = bool(torch.equal(sp, out))
            print(f"    sequence_parallel=True on the host mesh: logits "
                  f"equal bit for bit {same}")
            require(same, "phase 20: sequence_parallel moved qwen2-0.5b's "
                    "prefill logits on a one-device mesh")
            extra["sequence_parallel_equal"] = same
        if arch == ARCH and kind == "decode":
            bad = specs.input_specs(cfg, shape)
            bad["batch"]["token"] = torch.empty(
                (shape.global_batch,), dtype=torch.int64, device="meta")
            _, memory, _ = dryrun.lower_cell(cfg, shape, mesh, inputs=bad)
            print(f"    fault control: the tokens as int64 in the dry run "
                  f"give {memory['argument_size_in_bytes']} argument bytes "
                  f"against {row['real_argument_bytes']} real")
            require(memory["argument_size_in_bytes"] !=
                    row["real_argument_bytes"], "phase 20: a dry run with "
                    "a leaf of the wrong dtype matched the real bytes")
            extra["fault_argument_bytes"] = memory["argument_size_in_bytes"]
        if model_flags.get("moe_impl") == "ep_shardmap":
            prefill = make_prefill_step(cfg)
            run = lambda: prefill(inputs["params"], inputs["batch"])  # noqa
            with mesh_context(mesh):
                bf16 = compare_moe_forms(torch, flags, moe_module, run,
                                         cfg.dtype)
            require(bf16["max_abs_err"] <= 2e-2 * bf16["max_abs_logit"] and
                    bf16["top1"] >= 0.99, f"phase 20: bf16 ep_shardmap vs "
                    f"global {bf16}")
            require(all(m <= ROUTE_FLOOR for m in bf16["flip_margins"]),
                    f"phase 20: bf16 routing flips beyond ROUTE_FLOOR "
                    f"{bf16['flip_margins']}")
            inputs = out = run = None
            torch.cuda.empty_cache()
            cfg32 = replace(cfg, n_layers=EP_F32_LAYERS, dtype="float32")
            params32 = init_params(cfg32, torch.Generator(
                device="cuda").manual_seed(0))
            batch = slice_inputs(torch, cfg32, SLICE_B, SLICE_S)
            prefill32 = make_prefill_step(cfg32)
            run = lambda: prefill32(params32, batch)  # noqa: E731
            with mesh_context(mesh):
                f32 = compare_moe_forms(torch, flags, moe_module, run,
                                        cfg32.dtype)
            require(f32["max_abs_err"] <= EP_F32_TOL * f32["max_abs_logit"]
                    and f32["flips"] == 0, f"phase 20: f32 ep_shardmap vs "
                    f"global {f32}")
            extra["ep_vs_global"] = {"bfloat16": bf16, "float32": f32}
            params32 = batch = run = None
        inputs = out = None
        torch.cuda.empty_cache()

    # every production cell's arguments a device under the specs (the
    # records' `argument_bytes`; phase 23 (b) captures a cell's program)
    from repro_torch.core import get_backend
    from repro_torch.launch import specs as dry_specs
    from repro_torch.launch.mesh import make_production_mesh
    hbm = get_backend(DRY_BACKEND).hw.hbm_bytes
    t0 = time.perf_counter()
    fits, over, total = [], [], 0
    with tempfile.TemporaryDirectory(prefix="phase20_") as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        for cfg in ALL_ARCHS:
            for shape in shapes_for(cfg) + (
                    () if cfg.supports_long_context else (LONG_500K,)):
                for mesh_kind in ("single", "multi"):
                    total += 1
                    label = f"{cfg.name}__{shape.name}__{mesh_kind}"
                    if shape is LONG_500K and not cfg.supports_long_context:
                        rec = dryrun.run_cell(cfg.name, shape.name,
                                              mesh_kind, tmp,
                                              hw_name=DRY_BACKEND)
                        require(rec["status"] == "skipped",
                                f"phase 20: {label} {rec.get('status')}")
                        continue
                    args = dryrun.argument_bytes(
                        cfg, shape, make_production_mesh(
                            multi_pod=(mesh_kind == "multi")),
                        dry_specs.input_specs(cfg, shape))
                    (fits if sum(args.values()) <= hbm else
                     over).append(label)
    sweep_s = time.perf_counter() - t0
    by_arch = {}
    for label in fits:
        arch, shape_name, mesh_kind = label.split("__")
        by_arch.setdefault(arch, []).append(f"{shape_name}/{mesh_kind}")
    print(f"  argument bytes of {total} cells (every config x its shapes "
          f"x single, multi; the specs') in {sweep_s:.2f} s: {len(fits)} fit "
          f"{DRY_BACKEND}'s 80 GB a device: "
          f"{'; '.join(f'{a}: ' + ' '.join(c) for a, c in by_arch.items())}"
          f"; {len(over)} do not: {over}")
    seconds = time.perf_counter() - t_phase
    return {"cells": rows, **extra,
            "sweep": {"cells": total, "fit": fits, "over": over,
                      "seconds": sweep_s},
            "seconds": seconds}


# -- phase 21 -----------------------------------------------------------------

# Phase 21: hillclimb's training cells (`launch/hillclimb.py::CELLS`) on the
# card's own mesh, each variant through `run_variant` (the capture with the
# micro-batch loop as one `while`, the roofline, LEO's estimate on
# HILL_BACKEND), then run on the card.  qwen2 at full width and depth and
# hymba at full width cut to phase 19's 8 layers run at B 8 x S 1024, cut
# from train_4k's B 256 x S 4096, on the reference's single-pod micro-batch
# count `default_microbatch(cfg, 256, 4096, dp=16)` (2 and 4) unless the
# variant sets its own.  deepseek-v2 is captured only, at phase 18's 4
# layers and train_4k's shape on one device (256 micro-batches of one
# 4096-token row, one `while`): a MoE train step at a depth with a MoE
# layer does not fit the card.  A capture is host work (nothing runs on the
# card) and costs two trips of its loop whatever the trip count: 8-60 s a
# variant at these sizes on one H100's host, 703 s in all; so the captures
# run in HILL_WORKERS spawned processes together, before the real steps.
HILL_B, HILL_S = 8, 1024
HILL_CELLS = (("qwen2", None), ("hymba", FUSED_LEO_LAYERS))
HILL_DP = 16  # the data-parallel size of the reference's single-pod mesh
HILL_DSV2_LAYERS = 4
HILL_BACKEND = "nvidia_h100_sxm"
HILL_WORKERS = 7  # the card host has 8 cores; one is the main process's
# host seconds a capture takes a layer a trip, by cell, to start the
# longest first (measured on one H100 host, phase 21 alone)
HILL_LAYER_TRIP_S = {"qwen2": 1.0, "hymba": 3.4, "dsv2": 6.2}
# The agreement rule, phase 15's: f32, one step of each path from the
# weights and batch of seed 0, its gradients as the step hands them to the
# clip (`steps.clip_by_global_norm`: summed over the micro-batches and
# divided, cast where the variant casts), a path's gap the largest, over
# the param leaves, of the relative L2 gap of the leaf's gradient from the
# truth's.  The truth is the cell's baseline with every op on its plain path
# (`force_plain`).  The right paths run no kernel under test: each variant's
# twin (its flags and options under `force_plain`: the other micro-batch
# counts, the other remat, hymba's fused SSM form), the truth with the
# attention's chunk HILL_CHUNK in place of 512, and the truth with K1's plain
# version (full-matrix attention) in place of the chunked one.  A variant
# may be at most HILL_FACTOR times the largest gap of the right paths of its
# gradient dtype (bf16 gradients against the twins that cast theirs).  Two
# known faults on the cell's first K1 variant must fall outside the limit,
# in both cells: the micro-batch loop summing only its first trip
# (`steps.loop` replaced) and K1 with its causal band one key off.  The
# factor is phase 15's (GRAD_FACTOR).
HILL_FACTOR = GRAD_FACTOR
HILL_CHUNK = 256


def first_trip_loop(torch):
    """A known fault for phase 21's rule: the micro-batch loop runs its
    first trip only, as if the later trips' losses and gradients were
    zero."""
    from torch.utils._pytree import tree_map

    def loop(body, carry, xs):
        return body(carry, tree_map(lambda x: x[0], xs))
    return loop


def full_matrix_attention(flash_attention_plain):
    """K1's plain version at the plain attention's call site
    (`attention.chunked_attention`), a right path of phase 21's rule."""
    def attention(q, k, v, chunk=512, window=None):
        return flash_attention_plain(q, k, v, causal=True, window=window)
    return attention


def hill_shape(b, s):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(f"train_{b}x{s}", s, b, "train")


def hill_micro(arch):
    """The reference's micro-batch count of `arch`'s train_4k cell on its
    single-pod mesh."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.runtime import default_microbatch
    return default_microbatch(get_config(arch), TRAIN_4K.global_batch,
                              TRAIN_4K.seq_len, HILL_DP)


def hill_unrolled(microbatch):
    """qwen2-0.5b's flash_attention variant at phase 21's shape captured
    with the loop switched off: its totals."""
    from repro_torch.configs import get_config
    from repro_torch.core.roofline import _trip_aware_bytes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.flags import flags
    from repro_torch.runtime import TrainOptions

    with flags(attention_impl="kernel"):
        module, _, secs = dryrun.lower_cell(
            get_config("qwen2-0.5b"), hill_shape(HILL_B, HILL_S),
            make_host_mesh(1), opts=TrainOptions(microbatch=microbatch),
            loops=False)
    return {"instructions": sum(1 for _ in module.all_instructions()),
            "hlo_flops": module.total_flops(),
            "hlo_bytes": _trip_aware_bytes(module),
            "kernel_regions": module.kernel_calls,
            "whiles": [i.trip_count for i in module.all_instructions()
                       if i.opcode == "while"], "capture_s": secs}


def hill_captures(hillclimb, outdir):
    """Every capture of phase 21 in HILL_WORKERS spawned processes (the
    main process holds the card's context), the longest first: by key,
    (cell, variant) -> `run_variant`'s record, ("loop", "unrolled") -> the
    unrolled capture's totals."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import get_config
    jobs = []  # (host seconds expected, key, fn, kwargs)
    for cell, layers in HILL_CELLS + (("dsv2", HILL_DSV2_LAYERS),):
        spec = hillclimb.CELLS[cell]
        dsv2 = cell == "dsv2"
        micro = hill_micro(spec["arch"])
        for name, model_flags, overrides in spec["variants"]:
            cfg = get_config(spec["arch"])
            kwargs = dict(arch=spec["arch"], shape_name="train_4k" if dsv2
                          else hill_shape(HILL_B, HILL_S), name=name,
                          model_flags=model_flags, opt_overrides=overrides if
                          dsv2 else {"microbatch": micro, **overrides},
                          mesh_kind="host", outdir=str(outdir / cell),
                          hw_name=HILL_BACKEND, analyze=not dsv2,
                          force=True, layers=layers)
            trips = 2 if dsv2 or overrides.get("microbatch", micro) > 1 else 1
            jobs.append(((layers or cfg.n_layers) * trips *
                         HILL_LAYER_TRIP_S[cell], (cell, name),
                         hillclimb.run_variant, kwargs))
    jobs.append((24 * 2 * HILL_LAYER_TRIP_S["qwen2"], ("loop", "unrolled"),
                 hill_unrolled,
                 {"microbatch": hill_micro("qwen2-0.5b")}))

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=HILL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(fn, **kwargs) for _, key, fn, kwargs in
                   sorted(jobs, key=lambda job: -job[0])}
        out = {key: f.result() for key, f in futures.items()}
    seconds = time.perf_counter() - t0
    busy = sum(r.get("compile_seconds", r.get("capture_s", 0.0))
               for r in out.values())
    print(f"  {len(jobs)} captures in {HILL_WORKERS} processes: "
          f"{seconds:.1f} s of wall time, {busy:.1f} s of capture in all")
    return out, seconds


def hill_step(torch, ops, dryrun, flags, mesh, mesh_context, cfg, shape,
              model_flags, opts, make_inputs, patches=(), timed=0,
              steps_module=None):
    """One real train step of a variant on the card from seed 0's state and
    batch (the step updates its state in place, so each run makes its
    own), the launch counts zeroed just before it and read just after;
    then `timed` more steps, each timed with CUDA events.  `patches` are
    (module, name, value) set for the run.  With `steps_module`, the row
    keeps the gradients the step hands to the clip, flattened, in f32, and
    their leaves' names."""
    from torch.utils._pytree import tree_flatten_with_path
    inputs = make_inputs(cfg, shape)
    step, args = dryrun.cell_program(cfg, shape, inputs, "cuda", opts)
    grads, leaves = [], []
    if steps_module is not None:
        clip = steps_module.clip_by_global_norm

        def keeping_clip(tree, max_norm, **kw):
            for path, g in tree_flatten_with_path(tree)[0]:
                grads.append(g.float())
                leaves.append("/".join(str(getattr(
                    k, "key", getattr(k, "idx", k))) for k in path))
            return clip(tree, max_norm, **kw)
        patches = tuple(patches) + (
            (steps_module, "clip_by_global_norm", keeping_clip),)
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        with flags(**model_flags), mesh_context(mesh):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            _, metrics = step(*args)
            torch.cuda.synchronize()
            row = {"loss": metrics["loss"].item(),
                   "grad_norm": metrics["grad_norm"].item(),
                   "launches": ops.launch_counts(),
                   "flash_attention_bodies": dict(
                       ops.flash_attention.body_launches),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            times = []
            for _ in range(timed):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(*args)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
    if times:
        row["ms"] = statistics.median(times)
    if steps_module is not None:
        row["grads"], row["leaves"] = grads, leaves
    require(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
            f"phase 21 {cfg.name}: loss {row['loss']} or grad_norm "
            f"{row['grad_norm']} not finite")
    return row


def hill_gap(grads, truth):
    """(the largest relative L2 gap over the leaves, that leaf's index)."""
    gaps = []
    for g, t in zip(grads, truth):
        diff, norm = (g - t).norm().item(), t.norm().item()
        gaps.append(diff / norm if norm else (0.0 if not diff else math.inf))
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[worst], worst


def run_hill_cell(torch, ops, dryrun, hillclimb, flags, mesh, mesh_context,
                  cell, layers, records, make_inputs, attention_module,
                  steps_module):
    """One cell of phase 21 (qwen2 or hymba): each variant's record from
    `run_variant`, then its real bf16 step and one step timed (the regions,
    counted trip-aware, equal to the launches; ms a step beside the
    roofline's bound and LEO's estimate), then the f32 agreement rule
    (HILL_FACTOR) with its faults."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainOptions

    spec = hillclimb.CELLS[cell]
    full = get_config(spec["arch"])
    cfg = replace(full, n_layers=layers) if layers else full
    shape = hill_shape(HILL_B, HILL_S)
    micro = hill_micro(spec["arch"])
    rows = []
    for name, model_flags, overrides in spec["variants"]:
        rec = records[(cell, name)]
        opts = TrainOptions(**{"microbatch": micro, **overrides})
        real = hill_step(torch, ops, dryrun, flags, mesh, mesh_context, cfg,
                         shape, model_flags, opts, make_inputs, timed=1)
        launched = {k: v for k, v in real["launches"].items() if v}
        rl = rec["roofline"]
        row = {"cell": cell, "variant": name, "flags": model_flags,
               "options": overrides, "layers": cfg.n_layers,
               "B": HILL_B, "S": HILL_S, "microbatch": rec["microbatch"],
               "capture_s": rec["compile_seconds"],
               "instructions": rec["instructions"],
               "kernel_regions": rec["kernel_regions"],
               "roofline_ms": rl["bound_s"] * 1e3,
               "roofline_dominant": rl["dominant"],
               "hlo_flops": rl["hlo_flops"], "hlo_bytes": rl["hlo_bytes"],
               "leo_ms": rec["leo"]["estimated_step_seconds"] * 1e3,
               **real}
        print(f"  {cell} {name} ({cfg.n_layers} layers, B{HILL_B} S{HILL_S}, "
              f"{rec['microbatch']} micro-batches): {real['ms']:.3f} ms a "
              f"step measured; roofline {row['roofline_ms']:.3f} ms "
              f"({rl['dominant']}-bound), LEO {row['leo_ms']:.3f} ms on "
              f"{HILL_BACKEND}; {rec['instructions']} instructions captured "
              f"in {rec['compile_seconds']:.2f} s; loss {real['loss']:.6f}, "
              f"grad_norm {real['grad_norm']:.6f}; regions "
              f"{rec['kernel_regions']}, launches {launched}; peak "
              f"{real['peak_bytes'] / 2**30:.3f} GiB")
        require(rec["kernel_regions"] == launched, f"phase 21 {cell} {name}: "
                f"kernel regions {rec['kernel_regions']}, launches "
                f"{launched}")
        require(launched, f"phase 21 {cell} {name}: no kernel launched")
        rows.append(row)

    # the agreement rule, in f32: the truth, the right paths, the variants,
    # the faults
    cfg32 = replace(cfg, dtype="float32")
    variants = {name: (f, o) for name, f, o in spec["variants"]}
    base_flags, base_opts = variants["baseline"]
    k1_name = next(name for name, (f, _) in variants.items()
                   if f.get("attention_impl") == "kernel")

    def run(model_flags, overrides, patches=()):
        opts = TrainOptions(**{"microbatch": micro, **overrides})
        return hill_step(torch, ops, dryrun, flags, mesh, mesh_context,
                         cfg32, shape, model_flags, opts, make_inputs,
                         patches, steps_module=steps_module)

    def plain(model_flags):
        return {**model_flags, "force_plain": True}

    def dtype(overrides):
        return overrides.get("grad_dtype", "f32")

    truth = run(plain(base_flags), base_opts)
    truth_grads, leaves = truth.pop("grads"), truth["leaves"]
    right = {}  # name -> its gradient dtype, gap, worst leaf, loss, norm

    def keep(table, name, row, grad_dtype):
        gap, worst = hill_gap(row.pop("grads"), truth_grads)
        table[name] = {"grad_dtype": grad_dtype, "gap": gap,
                       "leaf": leaves[worst], "loss": row["loss"],
                       "grad_norm": row["grad_norm"]}
        torch.cuda.empty_cache()

    for name, (f, o) in variants.items():
        if name != "baseline":
            keep(right, f"twin {name}", run(plain(f), o), dtype(o))
    keep(right, f"chunk {HILL_CHUNK}", run(plain(base_flags), {
        **base_opts, "chunk": HILL_CHUNK}), "f32")
    keep(right, "k1_plain_version", run(plain(base_flags), base_opts, (
        (attention_module, "chunked_attention",
         full_matrix_attention(ops.flash_attention_plain)),)), "f32")
    spread = {}
    for r in right.values():
        spread[r["grad_dtype"]] = max(spread.get(r["grad_dtype"], 0.0),
                                      r["gap"])
    limit = {d: HILL_FACTOR * v for d, v in spread.items()}
    checked = {}
    for name, (f, o) in variants.items():
        keep(checked, name, run(f, o), dtype(o))
    k1_flags, k1_over = variants[k1_name]
    faults = {}
    keep(faults, "first_trip_only", run(k1_flags, k1_over, (
        (steps_module, "loop", first_trip_loop(torch)),)), dtype(k1_over))
    keep(faults, "band_one_key_off", run(k1_flags, k1_over, (
        (attention_module, "flash_attention",
         shifted_keys_attention(ops.flash_attention)),)), dtype(k1_over))
    del truth_grads
    torch.cuda.empty_cache()

    print(f"  {cell} agreement, f32, {len(leaves)} leaves: truth (baseline, "
          f"force_plain) loss {truth['loss']:.6f}, grad_norm "
          f"{truth['grad_norm']:.6f}; limits {HILL_FACTOR:g}x the right "
          f"paths: " + ", ".join(f"{d} {v:.3e}" for d, v in limit.items()))
    for kind, table in (("right path", right), ("variant", checked),
                        ("fault", faults)):
        for name, r in table.items():
            print(f"    {kind} {name} ({r['grad_dtype']} gradients): gap "
                  f"{r['gap']:.3e} at {r['leaf']}, loss {r['loss']:.6f}")
    for name, r in checked.items():
        require(r["gap"] <= limit[r["grad_dtype"]],
                f"phase 21 {cell} {name}: gradient gap {r['gap']} at "
                f"{r['leaf']} beyond {limit[r['grad_dtype']]}")
    for name, r in faults.items():
        require(r["gap"] > limit[r["grad_dtype"]],
                f"phase 21 {cell}: the fault {name} moves the gradients by "
                f"{r['gap']}, within {limit[r['grad_dtype']]}: the rule "
                f"cannot see it")
    for row in rows:
        row["gap"] = checked[row["variant"]]["gap"]
    return {"cell": cell, "arch": spec["arch"], "layers": cfg.n_layers,
            "microbatch": micro, "variants": rows,
            "truth": {"loss": truth["loss"], "grad_norm": truth["grad_norm"],
                      "leaves": len(leaves)},
            "right": right, "spread": spread, "limit": limit,
            "checked": checked, "faults": faults}


def check_loop_region(records):
    """Loop body against unrolled: qwen2's flash_attention variant at the
    phase's shape, its `run_variant` capture (the loop one `while`)
    against the capture with the loop switched off; the trip-aware FLOPs,
    bytes and kernel regions equal exactly."""
    a, b = records[("qwen2", "flash_attention")], records[("loop",
                                                           "unrolled")]
    looped = {"instructions": a["instructions"],
              "hlo_flops": a["roofline"]["hlo_flops"],
              "hlo_bytes": a["roofline"]["hlo_bytes"],
              "kernel_regions": a["kernel_regions"],
              "capture_s": a["compile_seconds"]}
    print(f"  loop body against unrolled (qwen2-0.5b flash_attention, "
          f"{a['microbatch']} micro-batches): {looped['instructions']} "
          f"against {b['instructions']} instructions, captured in "
          f"{looped['capture_s']:.2f} / {b['capture_s']:.2f} s; FLOPs "
          f"{looped['hlo_flops']:.6e} / {b['hlo_flops']:.6e}, bytes "
          f"{looped['hlo_bytes']:.6e} / {b['hlo_bytes']:.6e}; regions "
          f"{looped['kernel_regions']} / {b['kernel_regions']}")
    require(not b["whiles"], f"phase 21: the unrolled capture holds whiles "
            f"{b['whiles']}")
    require(all(looped[k] == b[k] for k in ("hlo_flops", "hlo_bytes",
                                            "kernel_regions")),
            f"phase 21: the loop's module {looped} is not the unrolled one's "
            f"{b}")
    return {"looped": looped, "unrolled": b}


def check_hill_dsv2(hillclimb, records):
    """deepseek-v2's five variants captured only: the trip-aware FLOPs of
    `ep+flash+save_moe` no more than `ep+flash`'s and no less than
    `ep+flash+remat_none`'s."""
    rows = {}
    for name, _, _ in hillclimb.CELLS["dsv2"]["variants"]:
        rec = records[("dsv2", name)]
        rl = rec["roofline"]
        rows[name] = {"flops": rl["hlo_flops"], "bytes": rl["hlo_bytes"],
                      "capture_s": rec["compile_seconds"],
                      "instructions": rec["instructions"],
                      "microbatch": rec["microbatch"],
                      "kernel_regions": rec["kernel_regions"],
                      "argument_bytes": rec["memory"][
                          "argument_size_in_bytes"]}
        print(f"  dsv2 {name} ({HILL_DSV2_LAYERS} layers, "
              f"train_4k, {rec['microbatch']} micro-batches, "
              f"captured only): {rl['hlo_flops']:.6e} FLOPs, "
              f"{rl['hlo_bytes']:.6e} bytes, {rec['instructions']} "
              f"instructions captured in {rec['compile_seconds']:.2f} s; "
              f"regions {rec['kernel_regions']}")
    save = rows["ep+flash+save_moe"]["flops"]
    require(rows["ep+flash+remat_none"]["flops"] <= save <=
            rows["ep+flash"]["flops"], f"phase 21 dsv2: save_moe FLOPs {save} "
            f"outside [remat_none {rows['ep+flash+remat_none']['flops']}, "
            f"group {rows['ep+flash']['flops']}]")
    return {"layers": HILL_DSV2_LAYERS, "B": 256, "S": 4096,
            "variants": rows}


def run_hillclimb(torch, ops, flags, init_params, init_train_state,
                  init_decode_state, attention_module):
    """Phase 21: every capture (`hill_captures`), then the qwen2 and hymba
    cells on the card (`run_hill_cell`), the loop region against the
    unrolled capture (`check_loop_region`) and the dsv2 captures
    (`check_hill_dsv2`), on `make_host_mesh(1)`."""
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.context import mesh_context
    import repro_torch.runtime.steps as steps_module

    t_phase = time.perf_counter()
    mesh = make_host_mesh(1)

    def make_inputs(cfg, shape):
        return real_cell_inputs(torch, cfg, shape, init_params,
                                init_train_state, init_decode_state)

    with tempfile.TemporaryDirectory(prefix="phase21_") as tmp:
        records, capture_wall = hill_captures(hillclimb, Path(tmp))
    cells = {}
    for cell, layers in HILL_CELLS:
        t0 = time.perf_counter()
        cells[cell] = run_hill_cell(
            torch, ops, dryrun, hillclimb, flags, mesh, mesh_context, cell,
            layers, records, make_inputs, attention_module, steps_module)
        cells[cell]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    loop_region = check_loop_region(records)
    dsv2 = check_hill_dsv2(hillclimb, records)
    table = [{k: row[k] for k in ("cell", "variant", "layers", "microbatch",
                                  "ms", "roofline_ms", "leo_ms", "capture_s",
                                  "loss", "grad_norm", "kernel_regions")}
             for c in cells.values() for row in c["variants"]]
    table += [{"cell": "dsv2", "variant": name, "layers": HILL_DSV2_LAYERS,
               "microbatch": row["microbatch"], "flops": row["flops"],
               "capture_s": row["capture_s"]}
              for name, row in dsv2["variants"].items()]
    print(json.dumps({"hillclimb": table}))
    return {"cells": cells, "loop_region": loop_region, "dsv2": dsv2,
            "capture_wall_s": capture_wall, "table": table,
            "seconds": time.perf_counter() - t_phase}


# -- phase 22 -----------------------------------------------------------------

# Phase 22: MoE training at full width.  phi3.5-moe (d_model 4096, 32 / 8
# heads of 128, 16 experts of ff 6400, top-2) cut to MOE_TRAIN_LAYERS of its
# 32 layers: 2.86 B parameters, ~40 GB of bf16 train state (bf16 params,
# f32 mu, nu and master), at phase 15's B x S.  Its parts run one after the
# other, each freeing what it made before the next starts:
#   (a) the f32 gradient gate, phase 15's rule and faults, under each policy
#       of MOE_REMATS, every right path's routing probed against the
#       truth's (`routing_flips`: an unexplained flip fails; an explained
#       one takes that layer's router and the flipped experts out of that
#       path's gaps);
#   (b) the checkpoint's recomputation routes as the forward did: every MoE
#       layer's expert ids in the forward against the recomputation's, 0
#       tokens apart, on every path of (a) in f32 and on the kernel path in
#       bf16 under both policies (else the gradient would belong to another
#       routing than the loss);
#   (c) TRAIN_STEPS bf16 steps of `make_train_step` under `TrainOptions()`,
#       twice from one state on the same batches, the two ends equal bit for
#       bit (params and optimizer state); K1 and K2 launched as phase 15
#       counts them (2 L and 4 L + 1 a step) under both policies; a held
#       loss that falls; a profiled step split by part (`moe_step_split`);
#   (d) the train driver twice, MOE_DRIVER_STEPS steps with no checkpoint
#       directory (a checkpoint would be ~40 GB of disk), the two runs'
#       losses equal bit for bit.
MOE_TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_TRAIN_LAYERS = 2
MOE_REMATS = ("group", "group_save_moe")
MOE_DRIVER_STEPS = 4
# (c) trains under the reference's defaults, `AdamWConfig()` (lr 3e-4, the
# driver's for a full-width run) and `TrainOptions()` (warmup 100 of 10,000
# steps), on a stream with something to learn: the pipeline's synthetic
# tokens folded onto the first MOE_TRAIN_IDS ids, each label a fixed
# permutation of its token (`FoldedStream`).  The synthetic stream itself
# is uniform over all 32064 ids, so no batch tells anything of another but
# the logits' scale, and phi3.5-moe's held loss did not fall on it: 11.195
# -> 14.089 under phase 15's schedule (lr 3e-3, warmup 2 of 10), -> 12.009
# at lr 3e-4, -> 11.196 under the defaults (my chip runs 2-4, PR 32).
MOE_TRAIN_IDS = 256
# the MoE's functions whose work makes up each MoE part of phase 22's
# profiled step: the kernels launched inside a call (forward and
# recomputation) or by the backward of an op it ran; products (the
# router's and the experts') are counted as products by their names
MOE_PARTS = (("routing", "route"), ("dispatch", "dispatch"),
             ("dispatch", "_dispatch_buffer"), ("combine", "_combine"))
# the dispatch gather's backward, a Python autograd Function whose forward
# the profiler records under no op of its own
MOE_BACKWARD_NODES = (("dispatch", "_GatherTokensBackward"),)


def recompute_routing(calls):
    """(b): each MoE layer's calls of `moe.route` (the forward's, then the
    recomputation's) and the tokens whose expert ids differ from the
    forward's."""
    layers = {}
    for c in calls:
        layers.setdefault(c["key"], []).append(c["expert_ids"])
    return [{"calls": len(ids), "differ": sum(
        int((x != ids[0]).any(-1).sum()) for x in ids[1:])}
        for ids in layers.values()]


def routing_flips(torch, cfg, calls, truth_calls, moe_slices):
    """A path's routing at each MoE layer against the truth's (the forward
    calls), phase 18's rule on two router inputs: a token whose top-k set
    differs is a flip, explained where the truth's top-k margin is at most
    max(ROUTE_FLOOR, (p_k + p_k+1) * expm1(2 L)), L = sum_i |x_i - x'_i| *
    max_e |W_ie| bounding the change of any router logit between the two
    inputs.  Returns one record a layer and the gradient slices the
    explained flips take out of the gate: by leaf, the layer's router and
    each expert chosen by one side only."""
    k = cfg.top_k
    mine = [c for c in calls if "xf" in c]
    theirs = [c for c in truth_calls if "xf" in c]
    require(len(mine) == len(theirs) == len(moe_slices),
            f"phase 22: {len(mine)} / {len(theirs)} MoE layers routed, "
            f"expected {len(moe_slices)}")
    rows, drops = [], {}
    for (group, rep), c, t in zip(moe_slices, mine, theirs):
        ids = c["expert_ids"].reshape(-1, k).sort(-1).values
        tids = t["expert_ids"].reshape(-1, k).sort(-1).values
        flips = (ids != tids).any(-1)
        d = t["xf"].shape[-1]
        shift = (c["xf"] - t["xf"]).abs().reshape(-1, d) @ \
            t["router"].float().abs().amax(-1)
        ranked = t["probs"].reshape(-1, cfg.n_experts).sort(
            -1, descending=True).values
        limit = ((ranked[:, k - 1] + ranked[:, k]) *
                 torch.expm1(2 * shift)).clamp(min=ROUTE_FLOOR)
        margin = t["margin"].reshape(-1)
        experts = set()
        for a, b in zip(ids[flips].tolist(), tids[flips].tolist()):
            experts |= set(a) ^ set(b)
        rows.append({"layer": [group, rep], "tokens": int(flips.numel()),
                     "flips": int(flips.sum()),
                     "margins": margin[flips].tolist(),
                     "limits": limit[flips].tolist(),
                     "unexplained": int((flips & (margin > limit)).sum()),
                     "experts": sorted(experts)})
        if experts:
            prefix = f"groups/{group}/ffn/"
            drops.setdefault(prefix + "router", set()).add((rep,))
            for name in ("w_gate", "w_up", "w_down"):
                drops.setdefault(prefix + name, set()).update(
                    (rep, e) for e in experts)
    return rows, drops


def moe_layer_slices(cfg, layer_groups):
    """(group, layer in the group) of each MoE layer, in order."""
    return [(g, rep) for g, ((_, ffn), reps) in enumerate(layer_groups(cfg))
            for rep in range(reps) if ffn == "moe"]


def moe_train_budget(torch, cfg, b: int, s: int):
    """The bytes of phase 22's trees before anything is allocated, from the
    dry run's `argument_bytes` on meta stand-ins on the card's own mesh
    (`make_host_mesh(1)`): the bf16 train state and its gradient (as large
    as the params), and the f32 gate's params, truth and path gradients."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1)
    shape = ShapeConfig(f"train_{b}x{s}", s, b, "train")
    args = {name: dryrun.argument_bytes(c, shape, mesh,
                                        specs.input_specs(c, shape))
            for name, c in (("bf16", cfg),
                            ("f32", replace(cfg, dtype="float32")))}
    bf16, f32 = args["bf16"], args["f32"]
    budget = {"arguments": args,
              "bf16_state": bf16["params"] + bf16["opt"] + bf16["step"],
              "bf16_grads": bf16["params"], "f32_params": f32["params"],
              "f32_gate_trees": 3 * f32["params"],
              "card": torch.cuda.get_device_properties(0).total_memory}
    budget["bf16_train"] = budget["bf16_state"] + budget["bf16_grads"]
    return budget


@contextlib.contextmanager
def annotated_moe(torch, moe_module):
    """Each function of MOE_PARTS run inside `torch.profiler.
    record_function("moe.<name>")`, for a profiled step."""
    saved = []
    for _, attr in MOE_PARTS:
        real = getattr(moe_module, attr)

        def wrapped(*args, _real=real, _name=f"moe.{attr}", **kwargs):
            with torch.profiler.record_function(_name):
                return _real(*args, **kwargs)

        saved.append((attr, real))
        setattr(moe_module, attr, wrapped)
    try:
        yield
    finally:
        for attr, real in saved:
            setattr(moe_module, attr, real)


def moe_step_split(events, kernels_of=lambda e: e.kernels):
    """Device ms of a profiled MoE step (under `annotated_moe`) by part:
    K1, K2 and products by the kernel's name (STEP_KINDS); then routing,
    dispatch and combine by where the kernel was launched: inside a call
    of MOE_PARTS (the forward, or its recomputation in the backward), or
    by the autograd node of an op such a call ran in the forward (matched
    by the forward's thread and sequence number; the recomputation runs
    on the backward's thread, whose numbers are its own) or of
    MOE_BACKWARD_NODES; the rest is "other".
    `kernels_of(e)` lists the kernels an op event launched, each with a
    `name` and a `duration` in us."""
    annotations = {f"moe.{attr}": part for part, attr in MOE_PARTS}
    by_seq = {}
    for e in events:
        part = annotations.get(e.name)
        todo = list(e.cpu_children) if part else []
        while todo:
            child = todo.pop()
            if child.sequence_nr >= 0:
                by_seq.setdefault((child.thread, child.sequence_nr), part)
            todo += child.cpu_children

    def origin(e):
        while e is not None:
            if e.name in annotations:
                return annotations[e.name]
            for part, node in MOE_BACKWARD_NODES:
                if node in e.name:
                    return part
            key = (e.fwd_thread, e.sequence_nr)
            if "Backward" in e.name and key in by_seq:
                return by_seq[key]
            e = e.cpu_parent
        return None

    named = STEP_KINDS[:3]
    ms = dict.fromkeys([k for k, _ in named] + ["routing", "dispatch",
                                                 "combine", "other"], 0.0)
    for e in events:
        launched = kernels_of(e)
        if not launched:
            continue
        part = origin(e)
        for kernel in launched:
            kind = next((k for k, words in named
                         if any(w in kernel.name for w in words)),
                        part or "other")
            ms[kind] += kernel.duration / 1e3
    return ms


def state_leaves(state):
    """(`leaf_path`, tensor) of each leaf of a train state's params and
    optimizer state."""
    from torch.utils._pytree import tree_flatten_with_path
    pairs, _ = tree_flatten_with_path({"params": state["params"],
                                       "opt": state["opt"]})
    return [(leaf_path(path), t) for path, t in pairs]


def host_mismatches(torch, kept, state):
    """The leaves of `state` whose bits differ from `kept` (a host copy of
    another state's leaves, by path), compared on the card a leaf at a
    time."""
    leaves = state_leaves(state)
    require(sorted(name for name, _ in leaves) == sorted(kept),
            "phase 22: the two runs' states have different leaves")
    return [name for name, t in leaves
            if not torch.equal(kept[name].to(t.device, non_blocking=True),
                               t)]


def moe_grad_gate(torch, ops, cfg32, flags, loss_fn, init_params,
                  attention_module, moe_module, runtime, batch, slices):
    """Phase 22 (a) and (b) in f32: `grad_paths` under each policy of
    MOE_REMATS on the weights of seed 0, phase 15's rule (GRAD_FACTOR) and
    faults, the routing of every right path explained against the truth's
    and every path's recomputation routed as its forward."""
    layers = cfg32.n_layers
    one_step = {"flash_attention": 2 * layers,
                "rmsnorm_pipelined": 4 * layers + 1}
    params = init_params(cfg32,
                         torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for remat in MOE_REMATS:
        options = runtime.TrainOptions(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        paths, truth = grad_paths(torch, ops, cfg32, params, batch, flags,
                                  loss_fn, attention_module, options,
                                  moe_module=moe_module, moe_slices=slices)
        del truth
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        spread = max(paths[n]["max_gap"]
                     for n in ("attention_plain", "k1_plain"))
        limit = GRAD_FACTOR * spread
        print(f"  (a) f32 gradient gate, remat {remat!r} (chunk "
              f"{options.chunk}), {seconds:.1f} s, peak memory "
              f"{peak / 2**30:.3f} GiB: right paths other than the kernel "
              f"path reach {spread:.3e}; limit {GRAD_FACTOR:g}x = "
              f"{limit:.3e}")
        print("    loss: " + ", ".join(f"{n} {p['loss']:.6f}"
                                       for n, p in paths.items()))
        print("    largest gap: " + ", ".join(
            f"{n} {p['max_gap']:.3e}" for n, p in paths.items()))
        for leaf in paths["plain"]["gaps"]:
            print(f"    {leaf}: " + ", ".join(
                f"{p['gaps'][leaf]:.2e}" for p in paths.values()))
        for name, p in paths.items():
            flips = p.get("flips", [])
            print(f"    {name}: routing flips against the truth "
                  f"{[r['flips'] for r in flips]} a layer (margins "
                  f"{[f'{m:.3e}' for r in flips for m in r['margins']]}, "
                  f"limits {[f'{m:.3e}' for r in flips for m in r['limits']]}"
                  f", {sum(r['unexplained'] for r in flips)} unexplained"
                  f"); taken out of its gate: {p['dropped'] or 'nothing'}; "
                  f"recomputation {p['recompute']}")
        k = paths["kernel"]
        require(not k["no_grad"] and not k["zero_qkv"],
                f"phase 22 {remat}: the kernel path leaves {k['no_grad']} "
                f"without a gradient and {k['zero_qkv']} all zeros")
        require(all(k["launches"][n] == c for n, c in one_step.items()) and
                k["flash_attention_bodies"]["cuda_core"] == 2 * layers,
                f"phase 22 {remat}: the kernel path's launches "
                f"{k['launches']}, bodies {k['flash_attention_bodies']}, "
                f"expected {one_step} on the cuda_core body")
        for name, p in paths.items():
            require(math.isfinite(p["loss"]),
                    f"phase 22 {remat} {name}: the loss is not finite")
            require(sum(r["unexplained"] for r in p.get("flips", [])) == 0,
                    f"phase 22 {remat} {name}: routing flips beyond their "
                    f"limits: {p.get('flips')}")
            require(all(r == {"calls": 2, "differ": 0}
                        for r in p["recompute"]) and
                    len(p["recompute"]) == len(slices),
                    f"phase 22 {remat} {name}: the recomputation routed "
                    f"otherwise than the forward: {p['recompute']}")
        require(k["max_gap"] <= limit, f"phase 22 {remat}: the kernel "
                f"path's f32 gradients are {k['max_gap']} from the plain "
                f"path's, beyond {limit}")
        for fault in ("fault_detached", "fault_band_backward"):
            require(paths[fault]["max_gap"] > limit,
                    f"phase 22 {remat}: {fault} moves the f32 gradients by "
                    f"{paths[fault]['max_gap']}, within {limit}: the gate "
                    f"cannot see it")
        out[remat] = {"spread": spread, "limit": limit, "paths": paths,
                      "seconds": seconds, "peak_bytes": peak}
    del params
    return out


class FoldedStream:
    """(c)'s stream: `base`'s (a `SyntheticTokenDataset`) tokens folded
    onto ids 0..ids-1, each label a fixed permutation of its token; the
    dataset interface `DataPipeline` reads."""

    def __init__(self, np, base, ids: int, seed: int = 0):
        self.base, self.ids = base, ids
        self.perm = np.random.default_rng(seed).permutation(ids).astype(
            np.int32)

    def batch(self, step: int, start_index: int, count: int):
        tokens = self.base.batch(step, start_index, count)["tokens"] % \
            self.ids
        return {"tokens": tokens, "labels": self.perm[tokens]}


def moe_train_steps(torch, ops, cfg, loss_fn, runtime, optim, pipe,
                    moe_module):
    """Phase 22 (b) in bf16 and (c): see the phase's comment.  `pipe`
    gives (c)'s batches and its held one."""
    layers = cfg.n_layers
    one_step = {"flash_attention": 2 * layers,
                "rmsnorm_pipelined": 4 * layers + 1}
    options = runtime.TrainOptions()
    step = runtime.make_train_step(cfg, optim.AdamWConfig(), options)
    held = pipe.device_batch(10**6)  # a batch no step trains on

    def fresh():
        return runtime.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0))

    bodies = dict.fromkeys(ops.flash_attention.body_launches, 0)

    def train(state, label):
        rows, tensor_core = [], 0
        batches = pipe(0)
        try:
            for i in range(TRAIN_STEPS):
                b = next(batches)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = ops.launch_counts()
                for n, k in ops.flash_attention.body_launches.items():
                    bodies[n] += k
                tensor_core += ops.flash_attention.body_launches[
                    "tensor_core"]
                row = {"step": i, "seconds": seconds, "launches": counts,
                       **{k: v.item() for k, v in metrics.items()}}
                rows.append(row)
                print(f"    {label} step {i}: loss {row['loss']:.6f}, "
                      f"grad_norm {row['grad_norm']:.6f}, lr_scale "
                      f"{row['lr_scale']:.6f}, {seconds * 1e3:.3f} ms; K1 "
                      f"{counts['flash_attention']}, K2 "
                      f"{counts['rmsnorm_pipelined']}")
                require(math.isfinite(row["loss"]) and
                        math.isfinite(row["grad_norm"]),
                        f"phase 22 {label} step {i}: loss or grad norm not "
                        f"finite")
                require(all(counts[n] == c for n, c in one_step.items()),
                        f"phase 22 {label} step {i}: launches {counts}, "
                        f"expected {one_step}")
        finally:
            batches.close()
        require(tensor_core == 2 * layers * TRAIN_STEPS, f"phase 22 "
                f"{label}: {tensor_core} K1 launches on the tensor-core body")
        return state, rows

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    # (b) in bf16: the kernel path's recomputation against its forward
    batch = pipe.device_batch(0)
    recompute = {}
    for remat in MOE_REMATS:
        with recorded_routes(moe_module) as calls:
            loss_grads(torch, loss_fn, cfg, state["params"], batch,
                       runtime.TrainOptions(remat=remat))
        recompute[remat] = recompute_routing(calls)
        del calls
        print(f"  (b) bf16 kernel path, remat {remat!r}: recomputation "
              f"{recompute[remat]}")
        require(len(recompute[remat]) == layers and all(
            r == {"calls": 2, "differ": 0} for r in recompute[remat]),
            f"phase 22 bf16 {remat}: the recomputation routed otherwise "
            f"than the forward: {recompute[remat]}")
    held_before = loss_fn(state["params"], cfg, held).item()
    print(f"  (c) {TRAIN_STEPS} bf16 steps of make_train_step, twice from "
          f"the state of seed 0, on the synthetic stream folded onto "
          f"{MOE_TRAIN_IDS} ids, each label a fixed permutation of its "
          f"token: AdamWConfig() (lr "
          f"{optim.AdamWConfig().lr:g}), TrainOptions() (warmup_steps "
          f"{options.warmup_steps}, total_steps {options.total_steps}, remat "
          f"{options.remat!r}, chunk {options.chunk})")
    state, rows = train(state, "run 1")
    peak = torch.cuda.max_memory_allocated()
    held_after = loss_fn(state["params"], cfg, held).item()
    t0 = time.perf_counter()
    kept = {}
    for name, t in state_leaves(state):  # pinned: ~10x a pageable copy
        kept[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        kept[name].copy_(t)
    copy_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    state, rows2 = train(fresh(), "run 2")
    t0 = time.perf_counter()
    differ = host_mismatches(torch, kept, state)
    compare_s = time.perf_counter() - t0
    del kept
    same_losses = [r["loss"] for r in rows] == [r["loss"] for r in rows2]
    ms = statistics.median(r["seconds"] for r in rows[1:]) * 1e3
    tokens = TRAIN_B * TRAIN_S
    print(f"  {ms:.3f} ms a step (median of run 1's steps 1-"
          f"{TRAIN_STEPS - 1}), {tokens / (ms / 1e3):.1f} tokens/s, peak "
          f"memory {peak / 2**30:.3f} GiB; held-batch loss "
          f"{held_before:.6f} -> {held_after:.6f}; run 2 against run 1: "
          f"losses equal {same_losses}, leaves differing in their bits "
          f"{differ or 'none'} (host copy {copy_s:.1f} s, compare "
          f"{compare_s:.1f} s)")
    require(held_after < held_before, f"phase 22: the held batch's loss "
            f"{held_before} -> {held_after} did not fall in {TRAIN_STEPS} "
            f"steps")
    require(not differ and same_losses, f"phase 22: two runs from one "
            f"state end apart: leaves {differ}, losses equal {same_losses}")

    # one step under group_save_moe, counted; then one profiled step
    save_moe = runtime.make_train_step(
        cfg, optim.AdamWConfig(), replace(options, remat="group_save_moe"))
    batches = pipe(TRAIN_STEPS)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        state, _ = save_moe(state, next(batches))
        torch.cuda.synchronize()
        save_counts = ops.launch_counts()
        print(f"  one step under remat 'group_save_moe': K1 "
              f"{save_counts['flash_attention']}, K2 "
              f"{save_counts['rmsnorm_pipelined']} (under 'group': "
              f"{one_step['flash_attention']}, "
              f"{one_step['rmsnorm_pipelined']})")
        require(all(save_counts[n] == c for n, c in one_step.items()),
                f"phase 22: group_save_moe launches {save_counts}, "
                f"expected {one_step}")
        from torch.profiler import ProfilerActivity, profile
        b = next(batches)
        torch.cuda.synchronize()
        with annotated_moe(torch, moe_module), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        batches.close()
    device, busy_us, top = device_time(torch, prof, wall_us, top=12)
    split = moe_step_split(prof.events())
    del state
    torch.cuda.empty_cache()
    profile_row = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                   "device_idle_share": (1 - busy_us / wall_us)
                   if device else None, "device_activities": len(device),
                   "device_ms_by_part": split,
                   "top_device_ms": {n: t / 1e3 for n, t in top}}
    if device:
        print(f"  a profiled step: {wall_us / 1e3:.3f} ms wall, device busy "
              f"{busy_us / 1e3:.3f} ms, idle share "
              f"{profile_row['device_idle_share']:.4f}; device ms by part: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        for name, t in profile_row["top_device_ms"].items():
            print(f"    {t:.4f} ms  {name[:100]}")
    else:
        print("  the profiler saw no device activity; the split is not "
              "measured")
    totals = {n: sum(r["launches"][n] for r in rows + rows2)
              for n in rows[0]["launches"]}
    return {"B": TRAIN_B, "S": TRAIN_S,
            "recompute_bf16": recompute, "rows": rows, "rows_run2": rows2,
            "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_bytes": peak,
            "held_loss": {"before": held_before, "after": held_after},
            "bit_equal": not differ, "group_save_moe_launches": save_counts,
            "profile": profile_row, "launches": totals,
            "flash_attention_bodies": bodies}


def moe_train_driver(torch, ops, train, layers: int):
    """Phase 22 (d): `launch/train.py::main` twice, MOE_DRIVER_STEPS steps
    of phi3.5-moe cut to `layers` at phase 15's B x S, no checkpoint; the
    two runs' losses equal bit for bit, K1 and K2 launched 2 L and 4 L + 1
    times a step."""
    argv = ["--arch", MOE_TRAIN_ARCH, "--layers", str(layers), "--steps",
            str(MOE_DRIVER_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S)]
    runs = {}
    for name in ("A1", "A2"):
        print(f"  (d) run {name}: main({' '.join(argv)})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        res["run_seconds"] = time.perf_counter() - t0
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["launches"] = ops.launch_counts()
        res["flash_attention_bodies"] = dict(
            ops.flash_attention.body_launches)
        torch.cuda.empty_cache()
        runs[name] = res
        steps = MOE_DRIVER_STEPS
        require(res["launches"]["flash_attention"] == 2 * layers * steps and
                res["launches"]["rmsnorm_pipelined"] ==
                (4 * layers + 1) * steps, f"phase 22 driver {name}: "
                f"launches {res['launches']}")
        require(all(math.isfinite(h["loss"]) for h in res["history"]),
                f"phase 22 driver {name}: a loss is not finite")
        print(f"    {res['run_seconds']:.1f} s, peak memory "
              f"{res['peak_bytes'] / 2**30:.3f} GiB, losses "
              f"{[h['loss'] for h in res['history']]}")
    same = [h["loss"] for h in runs["A1"]["history"]] == \
        [h["loss"] for h in runs["A2"]["history"]]
    require(same, "phase 22: the driver's two runs' losses differ")
    return {"runs": runs, "losses_equal": same}


def run_moe_train(torch, ops, flags, get_config, init_params, loss_fn,
                  layer_groups, attention_module, moe_module, runtime, optim,
                  data, train):
    """Phase 22 (see MOE_TRAIN_ARCH): the budget, then (a)-(d), each part
    freeing its tensors before the next."""
    t_phase = time.perf_counter()
    cfg = replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)
    cfg32 = replace(cfg, dtype="float32")
    budget = moe_train_budget(torch, cfg, TRAIN_B, TRAIN_S)
    gib = {k: v / 2**30 for k, v in budget.items() if k != "arguments"}
    print(f"  budget from dryrun.argument_bytes on make_host_mesh(1): bf16 "
          f"train state {gib['bf16_state']:.3f} GiB + its gradient "
          f"{gib['bf16_grads']:.3f}; f32 gate's params {gib['f32_params']:.3f}"
          f" GiB, x3 with the truth's and a path's gradients "
          f"{gib['f32_gate_trees']:.3f}; the card {gib['card']:.3f} GiB")
    require(budget["bf16_train"] < budget["card"] and
            budget["f32_gate_trees"] < budget["card"],
            f"phase 22: the trees do not fit the card: {budget}")
    slices = moe_layer_slices(cfg, layer_groups)
    pipe = data.DataPipeline(data.SyntheticTokenDataset(data.SyntheticConfig(
        cfg.vocab_size, TRAIN_S, seed=0)), TRAIN_B)
    batch = pipe.device_batch(0)
    gate = moe_grad_gate(torch, ops, cfg32, flags, loss_fn, init_params,
                         attention_module, moe_module, runtime, batch,
                         slices)
    torch.cuda.empty_cache()
    import numpy as np
    folded = data.DataPipeline(FoldedStream(np, pipe.dataset,
                                            MOE_TRAIN_IDS), TRAIN_B)
    steps = moe_train_steps(torch, ops, cfg, loss_fn, runtime, optim,
                            folded, moe_module)
    torch.cuda.empty_cache()
    driver = moe_train_driver(torch, ops, train, MOE_TRAIN_LAYERS)
    return {"arch": MOE_TRAIN_ARCH, "layers": MOE_TRAIN_LAYERS,
            "budget": budget, "grad_gate": gate, "train": steps,
            "driver": driver, "seconds": time.perf_counter() - t_phase}


# -- phase 23 -----------------------------------------------------------------

# Phase 23: the per-device program of a mesh (`runtime/steps.py`).
# (a) on a process group of one rank (NCCL): phase 22's MoE step and
# qwen2-0.5b's prefill through `place` and `shard_step`, each against the
# one-card step on the same inputs, bit for bit, K1 and K2 launched alike;
# (b) a production cell's per-device program captured in a child process
# behind the fake process group; (c) four NCCL ranks on a (2, 2) mesh where
# four cards exist.
MESH_PREFILL = (4, 1024)            # qwen2-0.5b's prefill, phase 4's B x S
MESH_CELL = ("qwen2-0.5b", "train_4k", "single", 1)  # arch, shape, mesh, layers
MESH_FLAGS = {"moe_impl": "ep_shardmap", "sequence_parallel": True}
# (a) the MoE configs under the default `global` form, 2 layers each
# (deepseek-v2: one dense, one MoE): (arch, whether the train step runs).
# deepseek-v2's train state at 2 layers is 69.9 GiB (bf16 weights, f32
# moments and master) and its gradients 10.0 GiB more, over the card's
# 80 GB: its step runs on four ranks, (c), and on the CPU's four `gloo`
# ranks (`tests/test_torch_mesh_dist.py`)
MESH_GLOBAL = (("phi3.5-moe-42b-a6.6b", True), ("deepseek-v2-236b", False))
MESH_GLOBAL_LAYERS = 2
MESH_TICK = (8, 1024, 16)           # a serve tick: slots, cache, positions
                                    # already held
MESH_RANKS_LAYERS = 2               # (c): each config at full width, 2 layers
MESH_RANKS_ARCHS = ("qwen2-0.5b", "phi3.5-moe-42b-a6.6b",
                    "deepseek-v2-236b")
MESH_RANKS_FACTOR = 3.0             # (c): phase 15's factor over the right
                                    # paths' spread


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def one_rank_group(torch):
    """The default process group of one rank on the card (NCCL)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    return dist


def same_bits(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                    b.view(torch.uint8) if b.dtype != torch.bool else b)


def mesh_moe_step(torch, ops, flags, get_config, runtime, data,
                  arch=MOE_TRAIN_ARCH, model_flags=MESH_FLAGS):
    """(a) phase 22's phi3.5-moe train step (2 layers, B x S of phase 15)
    under MESH_FLAGS (or `arch` at 2 layers under `model_flags`): the
    one-card step, then the same state (seed 0) and batch placed on the
    one-rank mesh and stepped by its per-device program; the new params,
    loss and grad norm equal bit for bit."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.context import mesh_context
    from repro_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               gather, place)
    from repro_torch.runtime.steps import shard_step, train_specs
    cfg = replace(get_config(arch), n_layers=MOE_TRAIN_LAYERS)
    pipe = data.DataPipeline(data.SyntheticTokenDataset(data.SyntheticConfig(
        cfg.vocab_size, TRAIN_S, seed=0)), TRAIN_B)
    batch = pipe.device_batch(0)
    # a state past its warmup (step 1 of a 1-step warmup, lr_scale 1), so
    # AdamW moves every weight and the new params' bits test the update
    options = runtime.TrainOptions(warmup_steps=1)

    def fresh():
        state = runtime.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        state["step"].fill_(1)
        return state

    rows = {}
    with flags(**model_flags):
        mesh = make_host_mesh(1)
        step = runtime.make_train_step(cfg, options=options)
        state = fresh()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with mesh_context(mesh):
            new, metrics = step(state, batch)
        torch.cuda.synchronize()
        rows["one_card"] = {"seconds": time.perf_counter() - t0,
                            "launches": ops.launch_counts()}
        kept = [t.cpu() for t in _leaves(new["params"])]
        want = {k: v.item() for k, v in metrics.items()}
        state = new = metrics = None
        torch.cuda.empty_cache()

        mesh = make_host_mesh(1)  # now over the group's one rank
        require(mesh.device_mesh is not None, f"phase 23: {mesh} has no "
                f"DeviceMesh")
        rules = ShardingRules(mesh, cfg)
        state = fresh()
        specs = train_specs(rules, state)
        sharded = shard_step(
            runtime.make_train_step(cfg, options=options, specs=specs),
            mesh, (specs, {k: PartitionSpec() for k in
                           ("loss", "grad_norm", "lr_scale")}))
        placed = place(state, specs, mesh)
        pbatch = place(batch, rules.batch_specs(
            cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train")), mesh)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new, metrics = sharded(placed, pbatch)
        torch.cuda.synchronize()
        rows["one_rank_mesh"] = {"seconds": time.perf_counter() - t0,
                                 "launches": ops.launch_counts()}
        got = {k: v.full_tensor().item() for k, v in metrics.items()}
        params = [t.cpu() for t in _leaves(gather(new["params"]))]
    state = placed = new = metrics = None
    torch.cuda.empty_cache()
    equal = got == want and all(same_bits(torch, a, b)
                                for a, b in zip(kept, params))
    launches = (rows["one_card"]["launches"],
                rows["one_rank_mesh"]["launches"])
    print(f"  (a) {arch} train step ({MOE_TRAIN_LAYERS} layers, B "
          f"{TRAIN_B} x S {TRAIN_S}, {model_flags}): one card "
          f"{rows['one_card']['seconds'] * 1e3:.3f} ms, the one-rank mesh's "
          f"per-device program {rows['one_rank_mesh']['seconds'] * 1e3:.3f}"
          f" ms (first calls, not timings); loss {got['loss']:.6f} / "
          f"{want['loss']:.6f}, grad norm {got['grad_norm']:.6f} / "
          f"{want['grad_norm']:.6f}, lr_scale {got['lr_scale']:g}; "
          f"{len(params)} updated params bit for bit: "
          f"{equal}; K1/K2 {launches[0]['flash_attention']}/"
          f"{launches[0]['rmsnorm_pipelined']} and "
          f"{launches[1]['flash_attention']}/"
          f"{launches[1]['rmsnorm_pipelined']}")
    require(equal, f"phase 23 (a): {arch}'s step on the one-rank mesh is "
            f"not the one-card step's bits: {got} / {want}")
    require(got["lr_scale"] == 1.0, f"phase 23 (a): lr_scale {got}")
    require(launches[0] == launches[1] and
            launches[1]["flash_attention"] > 0 and
            launches[1]["rmsnorm_pipelined"] > 0,
            f"phase 23 (a): {arch} step launches {launches}")
    return {"metrics": got, "one_card": rows["one_card"],
            "one_rank_mesh": rows["one_rank_mesh"], "equal": equal}


def mesh_prefill(torch, ops, flags, get_config, init_params,
                 make_prefill_step, arch=ARCH, layers=0,
                 model_flags=MESH_FLAGS):
    """(a) qwen2-0.5b's prefill at full width (phase 4's B x S) under
    MESH_FLAGS (or `arch`, its depth cut to `layers`, under
    `model_flags`): one card against the one-rank mesh's per-device
    program, the logits bit for bit, K1 and K2 launched alike (K1 once a
    GQA layer)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.context import mesh_context
    from repro_torch.parallel.sharding import ShardingRules, place
    from repro_torch.runtime.steps import shard_step
    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    b, s = MESH_PREFILL
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.
                           Generator(device="cuda").manual_seed(3),
                           device="cuda")
    with flags(**model_flags), torch.no_grad():
        mesh = make_host_mesh(1)
        with mesh_context(make_host_mesh(1)):
            ops.reset_launch_counts()
            want = make_prefill_step(cfg)(params, {"tokens": tokens})
            torch.cuda.synchronize()
            one = ops.launch_counts()
        rules = ShardingRules(mesh, cfg)
        pspecs = rules.param_specs(params)
        shape = ShapeConfig("prefill", s, b, "prefill")
        sharded = shard_step(make_prefill_step(cfg, pspecs=pspecs), mesh,
                             rules.logits_spec(shape))
        ops.reset_launch_counts()
        got = sharded(place(params, pspecs, mesh), place(
            {"tokens": tokens},
            {"tokens": rules.batch_specs(cfg, shape)["tokens"]}, mesh))
        torch.cuda.synchronize()
        mine = ops.launch_counts()
        got = got.full_tensor()
    equal = same_bits(torch, got, want)
    params = got = want = None
    torch.cuda.empty_cache()
    gqa = 0 if cfg.attention == "mla" else cfg.n_layers
    print(f"  (a) {cfg.name} prefill B {b} x S {s} ({model_flags}): logits "
          f"bit for bit {equal}; K1/K2 {one['flash_attention']}/"
          f"{one['rmsnorm_pipelined']} one card, "
          f"{mine['flash_attention']}/{mine['rmsnorm_pipelined']} on the "
          f"one-rank mesh")
    require(equal, f"phase 23 (a): {cfg.name}'s prefill logits on the "
            f"one-rank mesh are not the one-card step's bits")
    require(one == mine and mine["flash_attention"] == gqa and
            mine["rmsnorm_pipelined"] > 0,
            f"phase 23 (a): {cfg.name}'s prefill launches {one} / {mine}")
    return {"equal": equal, "launches": mine}


def mesh_serve_tick(torch, ops, get_config, init_params):
    """(a) `arch` at MESH_GLOBAL_LAYERS layers, one serve tick (the
    per-slot decode step `ServeEngine` takes) of MESH_TICK's slots, each at
    its own position in a cache holding random keys and values: one card
    against the one-rank mesh's per-device program, the tokens, the logits
    and the new decode state bit for bit, K1 and K2 launched alike."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_decode_state
    from repro_torch.parallel.context import mesh_context
    from repro_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               gather, place)
    from repro_torch.runtime import make_serve_step
    from repro_torch.runtime.steps import shard_step

    def run(arch):
        cfg = replace(get_config(arch), n_layers=MESH_GLOBAL_LAYERS)
        slots, cache, held = MESH_TICK
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = init_params(cfg, gen)
        state = init_decode_state(cfg, slots, cache)
        for leaf in _leaves(state):
            if leaf.is_floating_point() and leaf.ndim >= 4:
                leaf[:, :, :held] = torch.randn(
                    leaf[:, :, :held].shape, generator=gen, device="cuda"
                ).to(leaf.dtype)
        token = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                              device="cuda")
        pos = torch.randint(held // 2, held, (slots,), generator=gen,
                            device="cuda")
        with torch.no_grad():
            mine_state = {"groups": [
                {k: {n: t.clone() for n, t in v.items()}
                 for k, v in g.items()} for g in state["groups"]]}
            with mesh_context(make_host_mesh(1)):
                ops.reset_launch_counts()
                want = make_serve_step(cfg, per_slot_pos=True)(
                    params, state, token, pos)
                torch.cuda.synchronize()
                one = ops.launch_counts()
            mesh = make_host_mesh(1)
            rules = ShardingRules(mesh, cfg)
            pspecs = rules.param_specs(params)
            shape = ShapeConfig("tick", cache, slots, "decode")
            sspecs = rules.decode_state_specs(mine_state, shape)
            dp = PartitionSpec(rules.dp_spec)
            serve = shard_step(make_serve_step(
                cfg, per_slot_pos=True, pspecs=pspecs, sspecs=sspecs), mesh,
                (dp, rules.logits_spec(shape), sspecs))
            ops.reset_launch_counts()
            got = serve(place(params, pspecs, mesh),
                        place(mine_state, sspecs, mesh),
                        place(token, dp, mesh), place(pos, dp, mesh))
            torch.cuda.synchronize()
            mine = ops.launch_counts()
            got_state = gather(got[2])
            equal = all(same_bits(torch, a.full_tensor(), b)
                        for a, b in zip(got[:2], want[:2])) and all(
                same_bits(torch, a, b) for a, b in zip(
                    _leaves(got_state), _leaves(want[2])))
        print(f"  (a) {cfg.name} serve tick ({slots} slots, positions "
              f"{held // 2}-{held - 1}, global): tokens, logits and state "
              f"bit for bit {equal}; K1/K2 {one['flash_attention']}/"
              f"{one['rmsnorm_pipelined']} one card, "
              f"{mine['flash_attention']}/{mine['rmsnorm_pipelined']} on "
              f"the one-rank mesh")
        require(equal, f"phase 23 (a): {cfg.name}'s serve tick on the "
                f"one-rank mesh is not the one-card step's bits")
        require(one == mine and mine["rmsnorm_pipelined"] > 0,
                f"phase 23 (a): {cfg.name}'s tick launches {one} / {mine}")
        return {"equal": equal, "launches": mine}

    out = {}
    for arch, _ in MESH_GLOBAL:
        out[arch] = run(arch)
        torch.cuda.empty_cache()
    return out


def mesh_cell_program():
    """(b) MESH_CELL's per-device program captured in a child process
    behind the fake process group (`dryrun --mesh single`): the roofline's
    three terms on nvidia_h100_sxm and the collective bytes by kind, LEO's
    model of the program, not times of the card."""
    arch, shape, mesh_kind, layers = MESH_CELL
    out = ROOT / "chiprun_out" / "phase23"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh_kind, "--layers", str(layers),
           "--hw", "nvidia_h100_sxm", "--device", "cuda", "--force",
           "--outdir", str(out)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    rec = json.loads((out / f"{arch}__{shape}__{mesh_kind}.json"
                      ).read_text())
    require(done.returncode == 0 and rec["status"] == "ok",
            f"phase 23 (b): {rec.get('error')} {done.stderr[-2000:]}")
    rl = rec["roofline"]
    print(f"  (b) {rec['label']} ({rec['reduced']}, {rec['chips']} ranks of "
          f"the fake group, child {seconds:.1f} s, capture "
          f"{rec['compile_seconds']:.1f} s): LEO's roofline model on "
          f"nvidia_h100_sxm, not card times: compute "
          f"{rl['compute_s'] * 1e3:.3f} ms, memory {rl['memory_s'] * 1e3:.3f}"
          f" ms, collective {rl['collective_s'] * 1e3:.3f} ms; collective "
          f"bytes a device by kind {rl['collective_breakdown']}; arguments "
          f"{rec['memory']['argument_size_in_bytes']} bytes a device")
    require(rl["collective_bytes"] > 0, "phase 23 (b): no collective")
    return {"record": {k: rec[k] for k in ("label", "chips", "reduced",
                                           "memory", "compile_seconds")},
            "roofline": {k: rl[k] for k in (
                "compute_s", "memory_s", "collective_s", "collective_bytes",
                "collective_breakdown", "hlo_flops", "hlo_bytes")},
            "seconds": seconds}


def mesh_rank_state(torch, cfg, specs, mesh):
    """(c) a fresh train state (weights of seed 0, zero moments, step 3)
    laid out on `mesh` by `specs` without the whole state on one card:
    the weights drawn whole, each rank keeping its cut of them and of
    their f32 master copy and zero moments by the optimizer's specs, the
    whole weights then freed: no card holds the whole f32 state of both
    MoE configs at 2 layers and a step's transients."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import (_at, local_part, placements,
                                               tree_map_with_path)
    dm = mesh.device_mesh
    coords = dict(zip(mesh.axis_names, dm.get_coordinate()))

    def cut(t, spec):
        return DTensor.from_local(
            local_part(t, spec, mesh, coords).clone(), dm,
            placements(spec, mesh), run_check=False, shape=t.shape,
            stride=t.contiguous().stride())

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ospecs = specs["opt"]

    def moment(kind):
        return tree_map_with_path(lambda path, p: cut(
            p.detach().float() if kind == "master" else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
            _at(ospecs[kind], path)), params)

    state = {"params": tree_map_with_path(
        lambda path, p: cut(p, _at(specs["params"], path)), params),
        "opt": {"mu": moment("mu"), "nu": moment("nu"),
                "master": moment("master"),
                "count": cut(torch.zeros((), dtype=torch.int32,
                                         device="cuda"), ospecs["count"])},
        "step": cut(torch.full((), 3, dtype=torch.int32, device="cuda"),
                    specs["step"])}
    params = None
    torch.cuda.empty_cache()
    return state


def mesh_rank(rank, port, out_path, archs=MESH_RANKS_ARCHS):
    """(c) One of four NCCL ranks, one card each: each config of `archs`
    at full width on MESH_RANKS_LAYERS layers in f32 (the
    MoE configs under the default global form), one train step on a (2, 2)
    mesh, its first moments gathered (0.1 x the clipped gradient after a
    step from zero moments); rank 0 also takes the one-card gradients on
    the kernel path and on the forced-plain path, as first moments, and
    writes the largest gaps to `out_path`, one record a config."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.flags import flags
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               gather, place)
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.runtime import TrainOptions
    from repro_torch.runtime.steps import shard_step, train_specs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    # the other ranks wait at a barrier while rank 0 takes the one-card
    # gradients
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(minutes=30))
    records = {}
    try:
        for arch in archs:
            cfg = replace(get_config(arch), n_layers=MESH_RANKS_LAYERS,
                          dtype="float32")
            gen = torch.Generator(device="cuda").manual_seed(5)
            tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                   generator=gen, device="cuda")
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            options = TrainOptions(warmup_steps=1)

            mesh = make_host_mesh(2)
            rules = ShardingRules(mesh, cfg)
            specs = train_specs(rules, init_train_state(cfg, device="meta"))
            step = shard_step(
                make_train_step(cfg, options=options, specs=specs),
                mesh, (specs, {k: PartitionSpec() for k in
                               ("loss", "grad_norm", "lr_scale")}))
            bspec = PartitionSpec(rules.dp_spec, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, metrics = step(mesh_rank_state(torch, cfg, specs, mesh),
                                place(batch, {"tokens": bspec,
                                              "labels": bspec}, mesh))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            # after one AdamW step from zero moments mu is 0.1 x the
            # clipped gradient: phase 15's rule on the gradients, leaf by
            # leaf, the one card's taken without its optimizer state
            got = [t.cpu() for t in _leaves(gather(new["opt"]["mu"]))]
            got_m = {k: v.full_tensor().item() for k, v in metrics.items()}
            new = metrics = None
            torch.cuda.empty_cache()
            if rank == 0:
                params = init_params(
                    cfg, torch.Generator(device="cuda").manual_seed(0))
                b1 = AdamWConfig().b1

                def moments(**model_flags):
                    """The clipped gradients times 1 - b1, in place: no
                    copy of a gradient beside the weights'."""
                    leaves = [t.requires_grad_() for t in _leaves(params)]
                    with flags(**model_flags):
                        loss = loss_fn(params, cfg, batch,
                                       chunk=options.chunk,
                                       remat=options.remat)
                    grads = list(torch.autograd.grad(loss, leaves))
                    for t in leaves:
                        t.requires_grad_(False)
                    norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                          for g in grads))
                    scale = torch.clamp(options.clip_norm / torch.clamp(
                        norm, min=1e-12), max=1.0)
                    return loss.item(), [g.mul_(scale).mul_(1 - b1)
                                         for g in grads]

                k_loss, kernel = moments()
                kernel = [g.cpu() for g in kernel]
                torch.cuda.empty_cache()
                p_loss, plain = moments(force_plain=True)
                spread = max((a.cuda() - b).abs().max().item()
                             for a, b in zip(kernel, plain))
                plain = None
                gap = max((a.cuda() - b.cuda()).abs().max().item()
                          for a, b in zip(got, kernel))
                records[arch] = {
                    "seconds": seconds, "peak_bytes": peak,
                    "metrics": got_m, "one_card_loss": k_loss,
                    "plain_loss": p_loss, "gap": gap, "spread": spread}
                # each config's record as it is taken
                Path(out_path).write_text(json.dumps(records))
                params = kernel = None
            got = None
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_four_ranks(torch, archs=MESH_RANKS_ARCHS):
    """(c) where four cards exist: four spawned NCCL ranks (`mesh_rank`),
    for each config of `archs` their step's gradients (as its
    first moments) within MESH_RANKS_FACTOR times the one-card right
    paths' spread (kernel against forced-plain) of the one-card
    gradients, leaf by leaf, phase 15's f32 rule."""
    n = torch.cuda.device_count()
    if n < 4:
        print(f"  (c) 4-rank: not run, {n} card(s)")
        return {"run": False, "cards": n}
    import torch.multiprocessing as mp
    out = ROOT / "chiprun_out" / "phase23" / "four_ranks.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_rank, args=(r, port, str(out), archs))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=900)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    # the configs rank 0 finished, printed whether or not the others did
    records = json.loads(out.read_text()) if out.exists() else {}
    for arch, res in records.items():
        res["limit"] = MESH_RANKS_FACTOR * res["spread"]
        print(f"  (c) 4 NCCL ranks, (2, 2), {arch} f32 on "
              f"{MESH_RANKS_LAYERS} layers, B {TRAIN_B} x S {TRAIN_S}: step "
              f"{res['seconds'] * 1e3:.3f} ms (first call), peak "
              f"{res['peak_bytes'] / 2**30:.2f} GiB a rank, loss "
              f"{res['metrics']['loss']:.7f} / one card "
              f"{res['one_card_loss']:.7f} (plain {res['plain_loss']:.7f});"
              f" the gradients' (0.1 x, as first moments) largest gap to "
              f"the one-card kernel path {res['gap']:.3e}, limit "
              f"{MESH_RANKS_FACTOR:g} x the right paths' spread "
              f"{res['spread']:.3e} = {res['limit']:.3e}")
    print(f"  (c) {time.perf_counter() - t0:.1f} s")
    require(all(p.exitcode == 0 for p in procs),
            f"phase 23 (c): rank exit codes {[p.exitcode for p in procs]}")
    for arch, res in records.items():
        require(res["gap"] <= res["limit"], f"phase 23 (c): {arch} gap "
                f"{res['gap']} > {res['limit']}")
    return {"run": True, "configs": records}


def run_mesh(torch, ops, flags, get_config, init_params, make_prefill_step,
             runtime, data):
    """Phase 23: (a) on a one-rank NCCL group, (b), (c)."""
    t_phase = time.perf_counter()
    dist = one_rank_group(torch)
    global_form = {}
    try:
        moe = mesh_moe_step(torch, ops, flags, get_config, runtime, data)
        prefill = mesh_prefill(torch, ops, flags, get_config, init_params,
                               make_prefill_step)
        t_global = time.perf_counter()
        for arch, trains in MESH_GLOBAL:
            row = global_form[arch] = {}
            if trains:
                row["train"] = mesh_moe_step(torch, ops, flags, get_config,
                                             runtime, data, arch, {})
            row["prefill"] = mesh_prefill(
                torch, ops, flags, get_config, init_params,
                make_prefill_step, arch, MESH_GLOBAL_LAYERS, {})
        for arch, tick in mesh_serve_tick(torch, ops, get_config,
                                          init_params).items():
            global_form[arch]["tick"] = tick
        t_global = time.perf_counter() - t_global
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase
    cell = mesh_cell_program()
    ranks = mesh_four_ranks(torch)
    return {"moe_step": moe, "prefill": prefill, "global": global_form,
            "cell": cell, "four_ranks": ranks, "seconds_a": t_a,
            "seconds_global": t_global,
            "seconds": time.perf_counter() - t_phase}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"),
                    help="where to write the detailed results")
    args = ap.parse_args(argv)
    wall0 = time.perf_counter()

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
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import HEAD_DIMS, TC_BLOCK_K
    from repro_torch.kernels.rmsnorm import LANE_CHUNKS
    from repro_torch.kernels.slstm_scan import MAX_ROWS as SLSTM_ROWS
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import attention as attention_module
    from repro_torch.models import moe as moe_module
    from repro_torch.models import ssm as ssm_module
    from repro_torch.models import transformer as transformer_module
    from repro_torch.models import xlstm as xlstm_module
    from repro_torch.models import (forward, init_decode_state, init_params,
                                    layer_descriptors, loss_fn)
    from repro_torch.models.transformer import layer_groups
    from repro_torch.models.flags import flags
    from repro_torch.runtime import make_prefill_step
    import repro_torch.checkpoint as checkpoint
    import repro_torch.data as data
    import repro_torch.launch.train as train_driver
    import repro_torch.optim as optim
    import repro_torch.runtime as runtime

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
    log = _build.log_path()
    require(log.exists(), f"phase 2: no compiler output at {log}")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    tc = ptxas_report(log.read_text(), "flash_attention_tc_kernel")
    print("  flash_attention bf16 tensor-core body, ptxas by HD,block_k: "
          + ", ".join(f"{key} {r.get('registers')} registers "
                      f"{r.get('spill_bytes')} spill bytes"
                      for key, r in sorted(tc.items())))
    require(len(tc) == len(HEAD_DIMS) * len(TC_BLOCK_K) and all(
        r.get("spill_bytes") == 0 and r.get("registers") for r in
        tc.values()), f"phase 2: bf16 flash attention instantiations "
            f"{tc}: each must be reported with 0 spill bytes")
    # K2 and K3: by dtype and chunks a lane (0: a wide row read twice),
    # K3 also by its 16-byte (1) or value-by-value (0, chunks 0 only)
    # instantiation
    rms_ptxas = {}
    for marker, per_dtype in (("rmsnorm_pipelined_kernel",
                               len(LANE_CHUNKS) + 1),
                              ("rmsnorm_baseline_kernel",
                               len(LANE_CHUNKS) + 2)):
        rep = rms_ptxas[marker] = ptxas_report(log.read_text(), marker)
        print(f"  {marker}, ptxas by dtype,chunks[,vec]: "
              + ", ".join(f"{key} {r.get('registers')} registers "
                          f"{r.get('spill_bytes')} spill bytes"
                          for key, r in sorted(rep.items())))
        require(len(rep) == 2 * per_dtype and all(
            r.get("spill_bytes") == 0 and r.get("registers") for r in
            rep.values()), f"phase 2: {marker} instantiations {rep}: each "
                f"must be reported with 0 spill bytes")
    # K6 by dtype, batch rows a tile and gate columns a lane (2, 4, 8);
    # K5's two passes, bf16 on the tensor cores, f32 on the CUDA cores
    xlstm_ptxas = {}
    for marker, count in (("slstm_scan_kernel", 2 * SLSTM_ROWS * 3),
                          ("mlstm_state_tc_kernel", 1),
                          ("mlstm_state_kernel", 1),
                          ("mlstm_out_tc_kernel", 1),
                          ("mlstm_out_kernel", 1)):
        rep = xlstm_ptxas[marker] = ptxas_report(log.read_text(), marker)
        print(f"  {marker}, ptxas: " + ", ".join(
            f"{key if len(key) < 16 else ''} {r.get('registers')} "
            f"registers {r.get('spill_bytes')} spill bytes"
            for key, r in sorted(rep.items())))
        require(len(rep) == count and all(
            r.get("spill_bytes") == 0 and r.get("registers") for r in
            rep.values()), f"phase 2: {marker} instantiations {rep}: "
                f"{count}, each reported with 0 spill bytes")
    # K4's fused entry by dtype and state size N (1, 2, 4, 8, 16, 32)
    fused_ptxas = ptxas_report(log.read_text(), "ssm_scan_fused_kernel")
    print("  ssm_scan_fused_kernel, ptxas by dtype,N: " + ", ".join(
        f"{key} {r.get('registers')} registers {r.get('spill_bytes')} "
        f"spill bytes" for key, r in sorted(fused_ptxas.items())))
    require(len(fused_ptxas) == 12 and all(
        r.get("spill_bytes") == 0 and r.get("registers") for r in
        fused_ptxas.values()), f"phase 2: ssm_scan_fused_kernel "
            f"instantiations {fused_ptxas}: 12, each reported with 0 spill "
            f"bytes")

    # phase 3
    print("phase 3: kernels against their plain versions")
    fa = [check_flash_attention(torch, ops, F, "bfloat16", timed=True),
          check_flash_attention(torch, ops, F, "float32", timed=True),
          # hymba-1.5b's prefill: B 2 x S 2048, 25 / 5 heads, window 1024
          check_flash_attention(torch, ops, F, "bfloat16", timed=True, b=2,
                                s=2048, h=25, kv=5, window=1024),
          # h2o-danube-3-4b's head dim 120, run zero-padded to 128
          check_flash_attention(torch, ops, F, "bfloat16", timed=True, b=1,
                                h=32, kv=8, hd=120)]
    # the bf16 body's edges: head dims, no causal band, S below one tile
    # and off the tiles, a window of 1 and one off the tiles
    fa += [check_flash_attention(torch, ops, F, "bfloat16", b=2, s=s_,
                                 h=4, kv=2, hd=hd_, window=w_, causal=c_)
           for s_, hd_, w_, c_ in ((256, 16, None, True),
                                   (256, 32, None, True),
                                   (256, 128, None, True),
                                   (256, 64, None, False),
                                   (17, 64, 50, True), (300, 64, 50, True),
                                   (300, 64, 50, False),
                                   (256, 64, 1, True), (256, 64, 100, True))]
    for dt in ("bfloat16", "float32"):
        fa += [check_flash_attention(torch, ops, F, dt, window=256),
               check_flash_attention(torch, ops, F, dt, block_q=64,
                                     block_k=32),
               check_flash_attention(torch, ops, F, dt, block_q=32,
                                     block_k=128),
               check_flash_attention(torch, ops, F, dt, block_q=32,
                                     block_k=32),
               check_flash_attention(torch, ops, F, dt, block_q=32,
                                     block_k=64),
               check_flash_attention(torch, ops, F, dt, s=1000),
               # h2o-danube-3-4b's head dim 120, run zero-padded to 128
               check_flash_attention(torch, ops, F, dt, b=1, h=32, kv=8,
                                     hd=120),
               check_flash_attention(torch, ops, F, dt, b=1, h=32, kv=8,
                                     hd=120, window=256)]
    # phase 18's attention shapes (B 4 x S 1024): musicgen-medium's 24 / 24
    # heads of 64, internvl2-2b's 16 / 8 and phi3.5-moe's 32 / 8 of 128
    slice_fa = [check_flash_attention(torch, ops, F, "bfloat16", timed=True,
                                      h=h_, kv=kv_, hd=hd_)
                for h_, kv_, hd_ in ((24, 24, 64), (16, 8, 128),
                                     (32, 8, 128))]
    # rows of a decode tick (8 slots) and of a prefill (4096 tokens) at
    # qwen2-0.5b's width and at hymba-1.5b's
    rms = [check_rmsnorm(torch, ops, F, dt, r, d)
           for d in (896, 1600) for r in (8, 4096)
           for dt in ("bfloat16", "float32")]
    # bf16 rows of phase 18's norms: musicgen-medium's d_model and MLA's
    # q_norm (1536), internvl2-2b's (2048), phi3.5-moe's (4096),
    # deepseek-v2's (5120) and MLA's kv_norm (512)
    slice_rms = [check_rmsnorm(torch, ops, F, "bfloat16", r, d)
                 for d in (1536, 2048, 4096, 5120, 512) for r in (4096, 8)]
    # f32 rows of h2o-danube-3-4b (3840) and glm4-9b / phi3.5-moe (4096):
    # 32 chunks a lane, scale in shared memory beside a ring of 7 or 6
    # rows a stage (K2) or read as the row is scaled (K3)
    wide_rms = [check_rmsnorm(torch, ops, F, "float32", r, d)
                for d in (3840, 4096) for r in (8, 4096)]
    wide_base = [check_rmsnorm_baseline(torch, ops, F, "float32", r, d)
                 for d in (3840, 4096) for r in (8, 4096)]
    # the main path's shape first: hymba prefill, a/bx/c in f32 as the
    # model makes them
    scan = [check_ssm_scan(torch, ops, "float32", timed=True),
            check_ssm_scan(torch, ops, "bfloat16", timed=True),
            check_ssm_scan(torch, ops, "float32", s=1000)]
    scan += [check_ssm_scan(torch, ops, dt, s=s, din=din, n=n)
             for s, din, n in ((32, 128, 8), (64, 256, 16))
             for dt in ("float32", "bfloat16")]
    # K4's fused entry at hymba's prefill shape, xin as the model hands it
    # (bf16, a view of rows of 2 din) first; then f32, contiguous xin, and
    # the edges of its chunks (128 steps) and channel tiles (16)
    rate = sfu_rate(torch)
    scan_fused = [
        check_ssm_scan_fused(torch, ops, "bfloat16", strided=True,
                             timed=True, rate=rate, ptxas=fused_ptxas),
        check_ssm_scan_fused(torch, ops, "float32", timed=True, rate=rate,
                             ptxas=fused_ptxas),
        check_ssm_scan_fused(torch, ops, "bfloat16", timed=True, rate=rate,
                             ptxas=fused_ptxas),
        check_ssm_scan_fused(torch, ops, "float32", strided=True)]
    scan_fused += [check_ssm_scan_fused(torch, ops, dt, s=s, din=din, n=n)
                   for s, din, n in ((32, 128, 8), (1000, 320, 32),
                                     (40, 100, 1), (1, 64, 16),
                                     (129, 3201, 16))
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
                      gpu_name, norm_launches(cfg, layer_descriptors))
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
                       gpu_name, norm_launches(hcfg, layer_descriptors))
    hserve["decode_profile"] = profile_decode(
        torch, np, hcfg, hparams, ServeEngine, Request, ticks=20)
    del hparams
    torch.cuda.empty_cache()
    print(f"phase 8: sliding-window ring wrap, {HYBRID_ARCH}")
    ring = run_ring_wrap(torch, np, ops, hcfg, ServeEngine, Request, forward,
                         init_params)
    torch.cuda.empty_cache()

    # phases 9, 10 and 11
    print("phase 9: rmsnorm_baseline (K3) against its plain version, beside "
          "the pipelined kernel (K2)")
    base = [check_rmsnorm_baseline(torch, ops, F, dt, r, d)
            for d in (896, 1600) for r in (8, 4096)
            for dt in ("bfloat16", "float32")]
    main_base = base[2]  # bf16, R 4096, D 896
    print("phase 10: baseline vs pipelined RMSNorm, LEO on the card's own "
          "PTX (nvidia_h100_sxm)")
    ptx_ms = {"rmsnorm_baseline": main_base["ms"],
              "rmsnorm_pipelined": main_base["pipelined_ms"]}
    study = run_case_study(
        torch, ops, core, _build, SRC / "repro_torch" / "csrc", ptx_ms)
    ptx_modules = study.pop("modules")
    print(f"phase 11: the LEO loop at full {ARCH} width (loss B 4 x S 1024, "
          f"{cfg.dtype}): plain vs kernel attention, captured and diagnosed")
    loop = run_leo_loop(torch, ops, cfg, flags, loss_fn, init_params, core,
                        attention_module)
    loss_modules = loop.pop("modules")
    loss_ms = {f"loss_{impl}": d["measured_s"] * 1e3
               for impl, d in loop["diagnosis"].items()}
    torch.cuda.empty_cache()

    # phases 12, 13 and 14
    print("phase 12: mlstm_chunkwise (K5) and slstm_scan (K6) against their "
          "plain versions")
    # the main path's shapes first: xlstm-125m's prefill in its bf16
    mlstm = [check_mlstm(torch, ops, dt, b=4, s=1024, h=4, hd=192,
                         chunk=128, timed=True, rotate=dt == "bfloat16")
             for dt in ("bfloat16", "float32")]
    mlstm += [check_mlstm(torch, ops, dt, b=2, s=s_, h=h_, hd=hd_,
                          chunk=ch)
              for s_, h_, hd_, ch in ((64, 2, 32, 16), (128, 1, 64, 32))
              for dt in ("float32", "bfloat16")]
    slstm = [check_slstm(torch, ops, dt, b=4, s=1024, d=768, timed=True)
             for dt in ("bfloat16", "float32")]
    slstm += [check_slstm(torch, ops, dt, b=2, s=s_, d=d_)
              for s_, d_ in ((32, 64), (64, 128))
              for dt in ("float32", "bfloat16")]
    xcfg = get_config(XLSTM_ARCH)
    xparams = init_params(xcfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(xparams))
    kinds = list(xcfg.block_kinds)
    print(f"phase 13: prefill, {XLSTM_ARCH} at full width ({xcfg.n_layers} "
          f"layers: {kinds.count('mlstm')} mLSTM, {kinds.count('slstm')} "
          f"sLSTM; d_model {xcfg.d_model}, {xcfg.n_heads} heads of "
          f"{xcfg.head_dim_}, vocab {xcfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"parameters, {xcfg.dtype}, random weights from seed 0)")
    xnorms = norm_launches(xcfg, layer_descriptors)
    xprefill = run_xlstm_prefill(torch, ops, xcfg, xparams, flags,
                                 make_prefill_step, init_params,
                                 xlstm_module, xnorms)
    print(f"phase 14: continuous-batching serve, {XLSTM_ARCH}")
    xserve = run_serve(torch, np, ops, xcfg, xparams, ServeEngine, Request,
                       gpu_name, xnorms)
    xserve["decode_profile"] = profile_decode(
        torch, np, xcfg, xparams, ServeEngine, Request, ticks=20)
    del xparams
    torch.cuda.empty_cache()

    # phase 15
    print(f"phase 15: the train step at full {ARCH} width (B {TRAIN_B} x S "
          f"{TRAIN_S}, {cfg.dtype}, AdamW with f32 master weights), the "
          f"f32 gradient gate first")
    trained = run_train(torch, ops, cfg, flags, loss_fn, init_params,
                        attention_module, runtime, optim, data)
    torch.cuda.empty_cache()

    # phase 16
    print(f"phase 16: the train driver at full {ARCH} width (B {TRAIN_B} x "
          f"S {TRAIN_S}, {cfg.dtype}): checkpoint, restore and resume "
          f"against an uninterrupted run, --analyze")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase16_", dir=out.parent))
    try:
        driven = run_train_driver(torch, ops, cfg, train_driver, checkpoint,
                                  core, work, trained["ms_per_step"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # phase 17
    print(f"phase 17: LEO's advisor, rewrite loop and analysis server on "
          f"the card's programs ({smi}): phase 11's losses and phase 10's "
          f"PTX of K2 and K3 on {UPPER_BACKEND}")
    upper = run_upper_tiers(core, loss_modules, loss_ms, ptx_modules, ptx_ms)

    # phase 18
    print(f"phase 18: {', '.join(name for name, _ in SLICE_ARCHS)} at "
          f"full width through K1 and K2 ({smi})")
    t0 = time.perf_counter()
    sliced = run_slice(
        torch, np, ops, core, flags, get_config, init_params, forward,
        loss_fn, make_prefill_step, ServeEngine, Request, gpu_name,
        layer_descriptors, {"transformer": transformer_module,
                            "moe": moe_module,
                            "attention": attention_module})
    print(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # phase 19
    print(f"phase 19: {HYBRID_ARCH} at full width under the SSM's default "
          f"and fused forms (K4's two entries), the LEO loop on both "
          f"({smi})")
    t0 = time.perf_counter()
    fused_ssm = run_fused_ssm(torch, ops, core, hcfg, flags,
                              make_prefill_step, init_params, loss_fn,
                              ssm_module)
    fused_ssm["seconds"] = time.perf_counter() - t0
    print(f"  phase 19: {fused_ssm['seconds']:.1f} s")

    # phase 20
    print(f"phase 20: the dry run on the card's own mesh "
          f"(make_host_mesh(1)), each cell captured on meta stand-ins and "
          f"held to the real step ({smi})")
    dry = run_dryrun(torch, ops, core, flags, get_config, init_params,
                     runtime.init_train_state, init_decode_state,
                     make_prefill_step, moe_module)
    print(f"  phase 20: {dry['seconds']:.1f} s")

    # phase 21
    print(f"phase 21: hillclimb's training cells on the card's own mesh "
          f"(qwen2, hymba run; dsv2 captured), the micro-batch loop one "
          f"while ({smi})")
    hill = run_hillclimb(torch, ops, flags, init_params,
                         runtime.init_train_state, init_decode_state,
                         attention_module)
    print(f"  phase 21: {hill['seconds']:.1f} s")

    # phase 22
    print(f"phase 22: MoE training, {MOE_TRAIN_ARCH} at full width on "
          f"{MOE_TRAIN_LAYERS} of its layers (B {TRAIN_B} x S {TRAIN_S}): the "
          f"f32 gradient gate under {', '.join(MOE_REMATS)}, the "
          f"recomputation's routing, bf16 steps twice, the driver twice "
          f"({smi})")
    moe_train = run_moe_train(torch, ops, flags, get_config, init_params,
                              loss_fn, layer_groups, attention_module,
                              moe_module, runtime, optim, data, train_driver)
    print(f"  phase 22: {moe_train['seconds']:.1f} s")

    # phase 23
    print(f"phase 23: the per-device program of a mesh: (a) "
          f"{MOE_TRAIN_ARCH}'s train step and {ARCH}'s prefill, and the "
          f"MoE configs under the global form ({MESH_GLOBAL_LAYERS} layers: "
          f"{MESH_GLOBAL[0][0]}'s train step, both configs' prefill and "
          f"serve tick), on a one-rank NCCL group against one card, (b) "
          f"{MESH_CELL[0]} "
          f"{MESH_CELL[1]}'s program on the {MESH_CELL[2]} production "
          f"mesh, (c) four ranks where four cards exist ({smi})")
    meshed = run_mesh(torch, ops, flags, get_config, init_params,
                      make_prefill_step, runtime, data)
    print(f"  phase 23: {meshed['seconds']:.1f} s")

    main_fa, main_rms = fa[0], rms[2]  # bf16 at qwen2-0.5b's prefill
    main_fa32 = fa[1]  # K1's f32 body at the same shape
    main_scan = scan[0]  # f32 a/bx/c at hymba's prefill shape
    main_fused = scan_fused[0]  # bf16 strided xin at hymba's prefill shape
    main_mlstm, main_slstm = mlstm[0], slstm[0]  # bf16, xlstm's prefill
    main_runs = (prefill, serve, hprefill, hserve, study, loop, xprefill,
                 xserve, trained, driven) + tuple(
                     row[part] for row in sliced.values()
                     for part in ("prefill", "serve")) + tuple(
                         fused_ssm["bf16"].values()) + tuple(dry["cells"]) + \
        tuple(row for c in hill["cells"].values() for row in c["variants"]) \
        + (moe_train["train"],) + tuple(moe_train["driver"]["runs"].values()) \
        + (meshed["moe_step"]["one_rank_mesh"], meshed["prefill"]) + tuple(
            run["one_rank_mesh"] if part == "train" else run
            for row in meshed["global"].values()
            for part, run in row.items())
    kernels = [
        {"name": "flash_attention", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention.py:99",
         "launches": sum(r["launches"]["flash_attention"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in fa + slice_fa),
         "ms": main_fa["ms"], "plain_ms": main_fa["plain_ms"],
         "bound_ms": main_fa["bound_ms"], "bound_by": main_fa["bound_by"],
         "library_ms": main_fa["library_ms"],
         # K1's two bodies, by dtype, at qwen2-0.5b's prefill shape; the
         # launches of each in the same main-path runs
         "bodies": [
             {"body": body, "source": source,
              "launches": sum(r.get("flash_attention_bodies", {}).get(
                  body, 0) for r in main_runs),
              "max_abs_err": max(r["max_abs_err"] for r in fa
                                 if r["body"] == body),
              **{key: row[key] for key in ("ms", "call_ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")}}
             for body, source, row in (
                 ("tensor_core", "src/repro_torch/csrc/flash_attention_tc.cu",
                  main_fa),
                 ("cuda_core", "src/repro_torch/csrc/flash_attention.cu",
                  main_fa32))]},
        {"name": "rmsnorm_pipelined", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:90",
         "launches": sum(r["launches"]["rmsnorm_pipelined"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"]
                            for r in rms + wide_rms + slice_rms),
         "ms": main_rms["ms"], "plain_ms": main_rms["plain_ms"],
         "bound_ms": main_rms["bound_ms"], "bound_by": main_rms["bound_by"],
         "library_ms": main_rms["library_ms"]},
        {"name": "rmsnorm_baseline", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:41",
         "launches": sum(r["launches"]["rmsnorm_baseline"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in base + wide_base),
         "ms": main_base["ms"], "plain_ms": main_base["plain_ms"],
         "bound_ms": main_base["bound_ms"],
         "bound_by": main_base["bound_by"],
         "library_ms": main_base["library_ms"]},
        {"name": "ssm_scan", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:38",
         "launches": sum(r["launches"]["ssm_scan"] for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in scan),
         "ms": main_scan["ms"], "plain_ms": main_scan["plain_ms"],
         "bound_ms": main_scan["bound_ms"],
         "bound_by": main_scan["bound_by"], "library_ms": None},
        {"name": "ssm_scan_fused", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:38",
         # the reference model's fused region it also takes in
         "region": "src/repro/models/ssm.py:84",
         "launches": sum(r["launches"].get("ssm_scan_fused", 0)
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in scan_fused),
         "ms": main_fused["ms"], "plain_ms": main_fused["plain_ms"],
         "bound_ms": main_fused["bound_ms"],
         "bound_by": main_fused["bound_by"], "library_ms": None},
        {"name": "mlstm_chunkwise", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan.py:73",
         "launches": sum(r["launches"]["mlstm_chunkwise"]
                         for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in mlstm),
         "ms": main_mlstm["ms"], "plain_ms": main_mlstm["plain_ms"],
         "bound_ms": main_mlstm["bound_ms"],
         "bound_by": main_mlstm["bound_by"], "library_ms": None},
        {"name": "slstm_scan", "route": "cuda", "status": "ok",
         "source": "src/repro_torch/csrc/slstm_scan.cu",
         "replaces": "src/repro/kernels/slstm_scan.py:63",
         "launches": sum(r["launches"]["slstm_scan"] for r in main_runs),
         "max_abs_err": max(r["max_abs_err"] for r in slstm),
         "ms": main_slstm["ms"], "plain_ms": main_slstm["plain_ms"],
         "bound_ms": main_slstm["bound_ms"],
         "bound_by": main_slstm["bound_by"], "library_ms": None},
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: no launch on the main "
                f"path")
    out.write_text(json.dumps({
        "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build_s, "rmsnorm_ptxas": rms_ptxas,
        "xlstm_ptxas": xlstm_ptxas,
        "flash_attention": fa, "rmsnorm": rms,
        "ssm_scan": scan, "ssm_scan_fused": scan_fused,
        "ssm_scan_fused_ptxas": fused_ptxas, "wide_rmsnorm": wide_rms,
        "wide_rmsnorm_baseline": wide_base, "prefill": prefill,
        "serve": serve,
        "hybrid_prefill": hprefill, "hybrid_serve": hserve,
        "ring_wrap": ring, "rmsnorm_baseline": base, "case_study": study,
        "leo_loop": loop, "mlstm_chunkwise": mlstm, "slstm_scan": slstm,
        "xlstm_prefill": xprefill, "xlstm_serve": xserve, "train": trained,
        "train_driver": driven, "upper_tiers": upper,
        "slice_flash_attention": slice_fa, "slice_rmsnorm": slice_rms,
        "slice": sliced, "fused_ssm": fused_ssm, "dryrun": dry,
        "hillclimb": hill, "moe_train": moe_train, "mesh": meshed,
        "wall_seconds": time.perf_counter() - wall0,
        "kernels": kernels}, indent=1))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - wall0:.1f} s of wall time")
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
