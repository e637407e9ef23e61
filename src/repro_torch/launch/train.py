"""End-to-end training driver (the port of `repro.launch.train`): data
pipeline -> train step -> rotating crash-consistent checkpoints ->
`--restore` -> (optional) LEO analysis of the captured step.

It runs on the card unless `--device cpu` is given; there the kernels'
plain versions run.  The step runs eagerly (the port has no `jax.jit`);
`--analyze` captures the whole step (forward, the backward through the
per-layer recomputation, clipping and AdamW) and diagnoses it on
`nvidia_h100_sxm`.  Examples:

  python -m repro_torch.launch.train --smoke --device cpu --steps 30 \\
      --batch 8 --seq 32 --checkpoint-dir /tmp/ckpt --analyze
  python -m repro_torch.launch.train --steps 20 --batch 4 --seq 1024
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke_config
from ..data import DataPipeline, SyntheticConfig, SyntheticTokenDataset
from ..optim import AdamWConfig
from ..runtime.steps import TrainOptions, init_train_state, make_train_step


def build(arch: str, smoke: bool, batch: int, seq: int, device="cuda",
          microbatch: int = 1, grad_compression: bool = False,
          steps: int = 0, lr: float = 0.0):
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    ds = SyntheticTokenDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, d_model=cfg.d_model,
        frontend=cfg.frontend))
    pipeline = DataPipeline(ds, batch, device=device)

    # The TrainOptions schedule defaults (100-step warmup over a 10k-step
    # horizon) are production-run constants; a short run that never leaves
    # warmup makes no measurable progress.  Scale the schedule to the run
    # that was actually requested.
    if steps > 0:
        warmup = max(1, min(100, steps // 10))
        total = steps
    else:
        warmup, total = 100, 10_000
    options = TrainOptions(remat="group", chunk=min(512, seq),
                           microbatch=microbatch,
                           grad_compression=grad_compression,
                           warmup_steps=warmup, total_steps=total)
    # Smoke configs are tiny (d_model 64); the production 3e-4 moves them
    # too slowly to beat per-batch loss noise inside a smoke-length run.
    if lr <= 0.0:
        lr = 3e-3 if smoke else AdamWConfig().lr
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), options=options)
    return cfg, state, pipeline, step_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="peak learning rate (0 = auto: 3e-3 smoke, "
                         "3e-4 production)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--analyze", action="store_true",
                    help="run LEO on the captured train step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: the port "
                         f"trains on one card; only 1 is supported")

    cfg, state, pipeline, step_fn = build(
        args.arch, args.smoke, args.batch, args.seq, args.device,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        steps=args.steps, lr=args.lr)

    manager = None
    start_step = 0
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir, keep=3)
        if args.restore and manager.has_checkpoint():
            state, start_step = manager.restore_latest(state)
            print(f"restored from step {start_step}")

    history = []
    t0 = time.time()
    it = pipeline(start_step)
    try:
        for step in range(start_step, args.steps):
            batch = next(it)
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step's work
            history.append({
                "step": step, "loss": loss,
                "grad_norm": float(metrics["grad_norm"]),
                "lr_scale": float(metrics["lr_scale"]),
                "seconds": time.perf_counter() - t1})
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"gnorm {history[-1]['grad_norm']:.3f}")
            if manager and (step + 1) % args.checkpoint_every == 0:
                manager.save(step + 1, state)
    finally:
        it.close()
    if manager:
        manager.save(args.steps, state)
        manager.wait()
    wall = time.time() - t0

    losses = [h["loss"] for h in history]
    result = {"final_loss": losses[-1], "first_loss": losses[0],
              "steps": args.steps - start_step, "wall_seconds": wall,
              "history": history}
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({result['steps']} steps, {wall:.1f}s)")

    if args.analyze:
        from ..core import LeoSession, capture
        module = capture(step_fn, state, pipeline.device_batch(0),
                         name="train_step", device=args.device)
        an = LeoSession().analyze(module, backend="nvidia_h100_sxm")
        print(an.summary())
        result["leo_step_seconds"] = an.estimated_step_seconds
    return result


if __name__ == "__main__":
    main()
