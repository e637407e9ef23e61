"""End-to-end training driver (the port of `repro.launch.train`): data
pipeline -> train step -> rotating crash-consistent checkpoints ->
`--restore` -> (optional) LEO analysis of the captured step.

It runs on the card unless `--device cpu` is given; there the kernels'
plain versions run.  The step runs eagerly (the port has no `jax.jit`);
`--analyze` captures the whole step (forward, the backward through the
per-layer recomputation, clipping and AdamW) and diagnoses it on
`nvidia_h100_sxm`.  `--layers N` keeps the config's first N layers, as the
port's other launch scripts do: a MoE config's full depth does not train on
one card.  `--model-parallel N` trains on the ranks of a `torchrun`
launch (or of a process group the caller started), `(ranks / N, N)` over
("data", "model"): the state laid out by the sharding rules as DTensors,
each batch's rows cut over "data", the train step run as each rank's
program (`runtime/steps.py::shard_step`), checkpoints gathered and written
by rank 0 and placed again on restore; only rank 0 prints, and `--analyze`
captures rank 0's per-device step.  With no process group the mesh is the
one device's, and the same code runs the step as it is.  Examples:

  python -m repro_torch.launch.train --smoke --device cpu --steps 30 \\
      --batch 8 --seq 32 --checkpoint-dir /tmp/ckpt --analyze
  python -m repro_torch.launch.train --steps 20 --batch 4 --seq 1024
  python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
      --layers 2 --steps 4 --batch 4 --seq 1024
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --model-parallel 2 --steps 20 --batch 8 --seq 1024
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch
from torch.utils._pytree import tree_map

from ..checkpoint import CheckpointManager
from ..configs import ShapeConfig, get_config, smoke_config
from ..data import DataPipeline, SyntheticConfig, SyntheticTokenDataset
from ..optim import AdamWConfig
from ..parallel.sharding import PartitionSpec, ShardingRules, place
from ..runtime.steps import (
    TrainOptions,
    init_train_state,
    make_train_step,
    shard_step,
    train_specs,
)


def build(arch: str, smoke: bool, batch: int, seq: int, device="cuda",
          microbatch: int = 1, grad_compression: bool = False,
          steps: int = 0, lr: float = 0.0, layers: int = 0, mesh=None):
    """(cfg, state, pipeline, step): the config, its fresh train state, the
    data pipeline and the train step; on `mesh`, each rank's program of it
    on the state's shards under the sharding rules (`train_specs`), which
    `shard_step` runs."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if layers:
        if not 0 < layers <= cfg.n_layers:
            raise ValueError(f"--layers {layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        cfg = replace(cfg, n_layers=layers)
    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    if grad_compression:
        # the error feedback starts at zero, as the step starts it, laid
        # out as the gradients it is added to
        state["grad_ef"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32),
            state["params"])
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
    specs = None if mesh is None else train_specs(ShardingRules(mesh, cfg),
                                                  state)
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), options=options,
                              specs=specs)
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
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers (0: all)")
    ap.add_argument("--analyze", action="store_true",
                    help="run LEO on the captured train step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = _mesh(args.model_parallel, args.device)
    say = print if _rank() == 0 else (lambda *a, **k: None)
    # this rank's device by its index: the data pipeline's thread does not
    # share the main thread's current CUDA device
    cfg, state, pipeline, program = build(
        args.arch, args.smoke, args.batch, args.seq, mesh.device,
        microbatch=args.microbatch, grad_compression=args.grad_compression,
        steps=args.steps, lr=args.lr, layers=args.layers, mesh=mesh)
    rules = ShardingRules(mesh, cfg)
    specs = train_specs(rules, state)
    bspecs = rules.batch_specs(cfg, ShapeConfig("train", 0, 0, "train"))
    scalar = PartitionSpec()
    step_fn = shard_step(program, mesh, (specs, {
        "loss": scalar, "grad_norm": scalar, "lr_scale": scalar}))
    state = place(state, specs, mesh)

    manager = None
    start_step = 0
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir, keep=3)
        if args.restore and manager.has_checkpoint():
            state, start_step = manager.restore_latest(
                state, shardings=(specs, mesh))
            say(f"restored from step {start_step}")

    history = []
    t0 = time.time()
    it = pipeline(start_step)
    try:
        for step in range(start_step, args.steps):
            batch = place(next(it), bspecs, mesh)
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(_whole(metrics["loss"]))  # waits for the step
            history.append({
                "step": step, "loss": loss,
                "grad_norm": float(_whole(metrics["grad_norm"])),
                "lr_scale": float(_whole(metrics["lr_scale"])),
                "seconds": time.perf_counter() - t1})
            if step % 10 == 0 or step == args.steps - 1:
                say(f"step {step:5d}  loss {loss:.4f}  "
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
    say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({result['steps']} steps, {wall:.1f}s)")

    if args.analyze and _rank() == 0:
        from ..core import LeoSession
        module = _capture_local(program, mesh, state, place(
            pipeline.device_batch(0), bspecs, mesh))
        an = LeoSession().analyze(module, backend="nvidia_h100_sxm")
        print(an.summary())
        result["leo_step_seconds"] = an.estimated_step_seconds
    return result


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh(model_parallel: int, device):
    """The mesh of the launch's ranks (`make_host_mesh`; the one device's,
    with no process group).  Under `torchrun` (its `WORLD_SIZE` in the
    environment) the default group is started here: NCCL on the card,
    `gloo` on the CPU."""
    import os

    import torch.distributed as dist

    from .mesh import make_host_mesh
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        kind = torch.device(device).type
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
    if not dist.is_initialized() and model_parallel != 1:
        raise ValueError(
            f"--model-parallel {model_parallel} needs the ranks of a "
            f"process group (launch under torchrun); one device has "
            f"no 'model' axis to split")
    return make_host_mesh(model_parallel, device=device)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _capture_local(program, mesh, state, batch):
    """Rank 0's per-device train step, captured on its shards."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map

    from ..core import capture
    from ..parallel import spmd
    from ..parallel.context import mesh_context
    shards = tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                      else t, (state, batch))
    with spmd.program(mesh), mesh_context(mesh):
        return capture(program, *shards, name="train_step",
                       device=mesh.device)


if __name__ == "__main__":
    main()
