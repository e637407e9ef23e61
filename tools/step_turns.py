#!/usr/bin/env python3
"""Time one phase of `chip_smoke.py` in one checkout, on one NVIDIA GPU, so
that two checkouts can be run in turns on one card.

  python3 tools/step_turns.py prefill [--root DIR] [--samples N] [--out F]
  python3 tools/step_turns.py train [--root DIR] [--out F]
  python3 tools/step_turns.py driver [--root DIR] [--samples N] [--out F]

`--root` is the checkout whose `src/` and `chip_smoke.py` run (default:
this one).  To compare a commit with this tree, unpack it with `git
archive <commit> | tar -x -C build/<name>` and run this script on each in
one session, in turns (parent, change, change, parent).

prefill: hymba-1.5b's bf16 prefill as `chip_smoke.py` phase 6 runs it (B 2
  x S 2048, weights from seed 0, tokens from seed 3), after a warm-up
  call, `--samples` calls each with grad mode on (as phase 6) and with
  `torch.no_grad()` (there `kernel_call` and the wrappers' checks skip
  their `requires_grad` scan), the two alternating.  Each sample is the
  wall time of one call and a CUDA synchronize.  Then three calls under
  `torch.profiler`, each with its device busy time.
train: phase 15, through the checkout's `chip_smoke.run_train`.
driver: phase 15's timed loop and phase 16's driver, in turns in one
  process (`--samples` turns of each, the loop first), at qwen2-0.5b's
  full width, B 4 x S 1024, DRIVER_STEPS steps a turn.  The loop takes
  its state, pipeline and step from `launch/train.py::build` and times
  each step between two CUDA synchronizes, as phase 15 does; the driver
  is `launch/train.py::main`, each step timed by its `history`.  A turn's
  first step is left out of its samples.

The card's name and power limit are printed first, the result as one JSON
line last, and the result is written to `--out` when given.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def prefill_turn(torch, cs, samples: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.runtime import make_prefill_step
    cfg = get_config(cs.HYBRID_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048),
                           generator=torch.Generator(
                               device="cuda").manual_seed(3), device="cuda")
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :128]})  # warm-up (cuBLAS)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    times = {"grad_on": [], "no_grad": []}
    for _ in range(samples):
        for mode in times:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            if mode == "no_grad":
                with torch.no_grad():
                    prefill(params, {"tokens": tokens})
            else:
                prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    # device busy time (the union of the device's activity intervals) of
    # three calls with grad mode on, each under the profiler
    from torch.profiler import ProfilerActivity, profile
    profiled = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        _, busy_us, _ = cs.device_time(torch, prof, wall_us)
        profiled.append({"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3})
    return {"arch": cfg.name, "B": 2, "S": 2048, "launches": counts,
            "seconds": times,
            "median_s": {m: statistics.median(t) for m, t in times.items()},
            "profiled": profiled}


def train_turn(torch, cs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attention_module
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.flags import flags
    import repro_torch.data as data
    import repro_torch.optim as optim
    import repro_torch.runtime as runtime
    r = cs.run_train(torch, ops, get_config(cs.ARCH), flags, loss_fn,
                     init_params, attention_module, runtime, optim, data)
    return {"ms_per_step": r["ms_per_step"],
            "step_ms": [row["seconds"] * 1e3 for row in r["rows"]],
            "tokens_per_s": r["tokens_per_s"],
            "peak_memory_bytes": r["peak_memory_bytes"],
            "held_loss": r["held_loss"], "profile": r["profile"],
            "grad_gate": {k: r["grad_gate"][k]
                          for k in ("spread", "limit")},
            "kernel_gap": r["grad_gate"]["f32"]["kernel"]["max_gap"]}


DRIVER_STEPS = 6


def driver_turns(torch, cs, turns: int) -> dict:
    import repro_torch.launch.train as train
    args = ["--arch", cs.ARCH, "--batch", str(cs.TRAIN_B), "--seq",
            str(cs.TRAIN_S), "--steps", str(DRIVER_STEPS)]
    ms = {"loop": [], "driver": []}
    for turn in range(turns):
        _, state, pipeline, step = train.build(
            cs.ARCH, False, cs.TRAIN_B, cs.TRAIN_S, "cuda",
            steps=DRIVER_STEPS)
        batches = pipeline(0)
        loop = []
        try:
            for _ in range(DRIVER_STEPS):
                b = next(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                torch.cuda.synchronize()
                loop.append((time.perf_counter() - t0) * 1e3)
                for v in metrics.values():  # as phase 15, after the timing
                    v.item()
        finally:
            batches.close()
        del state, step, pipeline, metrics
        torch.cuda.empty_cache()
        res = train.main(args)
        torch.cuda.empty_cache()
        driven = [h["seconds"] * 1e3 for h in res["history"]]
        ms["loop"].append(loop[1:])
        ms["driver"].append(driven[1:])
        print(f"turn {turn}: loop " + ", ".join(f"{t:.3f}" for t in loop) +
              " ms; driver " + ", ".join(f"{t:.3f}" for t in driven) +
              " ms", flush=True)
    summary = {}
    for way, per_turn in ms.items():
        every = [t for turn in per_turn for t in turn]
        summary[way] = {"median_ms": statistics.median(every),
                        "min_ms": min(every), "max_ms": max(every),
                        "turn_medians_ms": [statistics.median(t)
                                            for t in per_turn]}
    return {"arch": cs.ARCH, "B": cs.TRAIN_B, "S": cs.TRAIN_S,
            "steps_a_turn": DRIVER_STEPS, "turns": turns, "step_ms": ms,
            "summary": summary,
            "driver_over_loop": (summary["driver"]["median_ms"] /
                                 summary["loop"]["median_ms"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("prefill", "train", "driver"))
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose src/ and chip_smoke.py run")
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--out", help="write the result here as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("step_turns: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    # as chip_smoke.py phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    if args.phase == "prefill":
        result = prefill_turn(torch, cs, args.samples)
    elif args.phase == "train":
        result = train_turn(torch, cs)
    else:
        result = driver_turns(torch, cs, args.samples)
    result = {"phase": args.phase, "root": str(root), "gpu": smi, **result}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
