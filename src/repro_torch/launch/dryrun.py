"""Dry run: what does an (arch x shape x mesh) cell cost, and does it fit?
(the port of `repro.launch.dryrun`).

For each cell this:
  1. builds the mesh: the ranks' own (`--mesh host`, `make_host_mesh`), or
     the reference's production meshes (16x16 single-pod, 2x16x16
     multi-pod) behind PyTorch's fake process group of their 256 (512)
     ranks, in this one process and for the length of the cell
     (`mesh.fake_production_mesh`);
  2. captures the cell's step with `core/torch_frontend.capture` on
     `launch/specs.py`'s meta stand-ins: rank 0's program of the step
     (`make_train_step`, `make_prefill_step` or `make_serve_step`) on its
     shards' shapes under the sharding rules, its collectives recorded as
     the reference's HLO collectives: nothing is allocated, nothing is
     sent and nothing runs;
  3. records the per-device argument and output bytes in place of XLA's
     `memory_analysis()` (the argument bytes those of the captured
     program's parameters, checked equal to the specs'; its temp and code
     sizes have no counterpart without a compiler and are recorded as
     absent, `None`, never estimated), and each argument tree's bytes a
     device under the specs (`argument_bytes`, of the uncut cell where
     `--layers` cuts the depth; only the arguments the captured program
     reads, as the reference's compiled step keeps only those,
     `unread_leaves`), and whether they fit the `--hw` backend;
  4. derives the roofline terms, the collective term included, from the
     captured Module with the port's `core/roofline.compute_roofline`, and
  5. optionally runs LEO's analysis of the Module (--analyze).

Artifacts land in experiments/dryrun/<arch>__<shape>__<mesh>.json (plus
the captured Module, a gzipped pickle, with --save-hlo).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --layers 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k --mesh host --analyze --hw nvidia_h100_sxm
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import pickle
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from torch.utils._pytree import tree_leaves

def argument_trees(cfg, shape, rules, inputs) -> Dict[str, Tuple[Any, Any]]:
    """(tree, specs) of each argument tree of the cell's step, by name:
    params, opt and step (train) or params (prefill, decode), the decode
    state (decode), and the batch."""
    from ..parallel.sharding import PartitionSpec
    bspecs = rules.batch_specs(cfg, shape)
    if shape.kind == "train":
        state = inputs["state"]
        return {"params": (state["params"],
                           rules.param_specs(state["params"])),
                "opt": (state["opt"],
                        rules.opt_specs(state["opt"], state["params"])),
                "step": (state["step"], PartitionSpec()),
                "batch": (inputs["batch"], bspecs)}
    trees = {"params": (inputs["params"],
                        rules.param_specs(inputs["params"]))}
    if shape.kind == "decode":
        trees["decode_state"] = (
            inputs["decode_state"],
            rules.decode_state_specs(inputs["decode_state"], shape))
    trees["batch"] = (inputs["batch"], bspecs)
    return trees


def argument_bytes(cfg, shape, mesh, inputs, unread=frozenset()
                   ) -> Dict[str, int]:
    """Each argument tree's bytes on one device of `mesh` under the specs,
    leaving out the leaves in `unread` ((tree, path) pairs,
    `unread_leaves`)."""
    from ..parallel.sharding import ShardingRules, per_device_bytes
    rules = ShardingRules(mesh, cfg)
    return {name: per_device_bytes(specs, _read(tree, name, unread), mesh)
            for name, (tree, specs) in
            argument_trees(cfg, shape, rules, inputs).items()}


def _read(tree, name: str, unread, path=()):
    """`tree` (argument tree `name`) without its leaves in `unread`; an
    unread leaf at the root leaves an empty tree."""
    if (name, "/".join(path)) in unread:
        return {}
    if not isinstance(tree, dict):
        return tree
    return {k: _read(v, name, unread, path + (str(k),))
            for k, v in tree.items()
            if (name, "/".join(path + (str(k),))) not in unread}


def unread_leaves(shape, module) -> frozenset:
    """The argument leaves the captured step `module` does not read, as
    (tree, path) pairs of `argument_trees` (the batch's labels in a
    prefill, the position of a decode whose mixers read none): the
    arguments the reference's compiled step leaves out (`jax.jit`'s
    `keep_unused=False`)."""
    trees = {"train": (("state",), ("batch",)),
             "prefill": (("params",), ("batch",)),
             "decode": (("params",), ("decode_state",), ("batch", "token"),
                        ("batch", "pos"))}[shape.kind]
    out = set()
    for path in module.unread_parameters:
        index, *rest = path.split(".")
        name, *inner = trees[int(index)] + tuple(rest)
        if name == "state":
            name, *inner = inner
        out.add((name, "/".join(inner)))
    return frozenset(out)


def program_inputs(shape, inputs, unread):
    """`inputs` without the leaves in `unread` (`unread_leaves`): the
    arguments the cell's program reads."""
    if shape.kind == "train":
        return {"state": {k: _read(v, k, unread)
                          for k, v in inputs["state"].items()},
                "batch": _read(inputs["batch"], "batch", unread)}
    return {k: _read(v, k, unread) for k, v in inputs.items()}


def cell_program(cfg, shape, inputs, device, opts=None, mesh=None):
    """(step, args): the cell's step and its arguments in call order
    (`inputs` from `specs.input_specs`, or real tensors of the same
    structure; a prefill step reads no labels).  On
    `mesh` the step is each rank's program under the mesh's sharding rules
    and the arguments are rank 0's shards: meta stand-ins of their shapes
    where the mesh cuts a leaf, the leaf itself where it does not."""
    import torch

    from ..parallel.sharding import ShardingRules, _at, shard_shape, \
        tree_map_with_path
    from ..runtime.steps import (make_prefill_step, make_serve_step,
                                 make_train_step)
    specs = {}
    if mesh is not None:
        trees = argument_trees(cfg, shape, ShardingRules(mesh, cfg), inputs)
        specs = {name: s for name, (_, s) in trees.items()}

        def shard(name, path, t):
            local = shard_shape(_at(specs[name], path), tuple(t.shape), mesh)
            if local == tuple(t.shape):
                return t
            if t.device.type != "meta":
                raise ValueError(f"cell_program: the {mesh.shape} mesh cuts "
                                 f"{name} leaf {path} {tuple(t.shape)}; "
                                 f"hand its shard or a meta stand-in")
            return torch.empty(local, dtype=t.dtype, device="meta")

        shards = {name: tree_map_with_path(
            lambda path, t, name=name: shard(name, path, t), tree)
            for name, (tree, _) in trees.items()}
        if shape.kind == "train":
            inputs = {"state": {k: shards[k] for k in
                                ("params", "opt", "step")},
                      "batch": shards["batch"]}
        else:
            inputs = {**inputs, **shards}
    batch = inputs["batch"]
    if shape.kind == "train":
        return (make_train_step(cfg, options=opts, specs=specs or None),
                (inputs["state"], batch))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, chunk=min(512, shape.seq_len),
                                  device=device, pspecs=specs.get("params")),
                (inputs["params"], batch))
    return (make_serve_step(cfg, pspecs=specs.get("params"),
                            sspecs=specs.get("decode_state")),
            (inputs["params"], inputs["decode_state"], batch["token"],
             batch["pos"]))


def cell_options(cfg, shape, mesh):
    """The train step's options of a cell: gradient accumulation keeping
    each device's layer-boundary activations near 2 GB
    (`runtime/steps.py::default_microbatch`), as the reference's."""
    from ..parallel.sharding import ShardingRules
    from ..runtime.steps import TrainOptions, default_microbatch
    dp = math.prod(mesh.shape[a]
                   for a in ShardingRules(mesh, cfg).dp_axes)
    return TrainOptions(microbatch=default_microbatch(
        cfg, shape.global_batch, shape.seq_len, dp))


def lower_cell(cfg, shape, mesh, opts=None, inputs=None, loops=True):
    """Capture one (arch, shape, mesh) cell: rank 0's program of the
    cell's step (`runtime/steps.py`), with its collectives, on meta
    stand-ins of the rank's shards; on a mesh of one device the step
    itself.  The mesh has devices behind it: the card's, a process
    group's, or the fake group of `mesh.fake_production_mesh`.  Returns
    (module, memory, seconds): the captured `Module`, the memory record
    (per-device argument and output bytes; temp and code sizes None) and
    the seconds the capture took.  The argument bytes are those of the
    captured program's parameters, and must equal the specs' bytes.
    `inputs` replaces `specs.input_specs(cfg, shape)`; `loops=False`
    records the train step's micro-batches trip by trip instead of as one
    `while`."""
    from ..core import capture
    from ..parallel import spmd
    from ..parallel.context import mesh_context
    from . import specs as S

    if mesh.devices is None:
        raise RuntimeError(f"lower_cell: the {mesh.shape} mesh has no "
                           f"devices and no process group behind it")
    if mesh.size != 1 and mesh.device_mesh is None:
        raise RuntimeError(f"lower_cell: the {mesh.shape} mesh has no "
                           f"DeviceMesh to run its per-device program on")
    if opts is None:
        opts = cell_options(cfg, shape, mesh)
    if inputs is None:
        inputs = S.input_specs(cfg, shape)
    step, args = cell_program(cfg, shape, inputs, mesh.device, opts, mesh)
    outputs = []

    def traced(*a):
        out = step(*a)
        outputs.append(out)
        return out

    # a decode batch smaller than the data axes (batch-1 long context):
    # every rank serves all its slots
    from ..parallel.sharding import ShardingRules
    small = shape.kind == "decode" and shape.global_batch < math.prod(
        mesh.shape[a] for a in ShardingRules(mesh, cfg).dp_axes)
    t0 = time.time()
    with mesh_context(mesh), spmd.program(mesh, () if small else None):
        module = capture(traced, *args, name=f"{shape.kind}_step",
                         device=mesh.device, loops=loops)
    secs = time.time() - t0
    args_bytes = sum(argument_bytes(cfg, shape, mesh, inputs, unread_leaves(
        shape, module)).values())
    captured = sum(i.shape.byte_size for i in module.computations[
        module.entry].instructions if i.opcode == "parameter" and
        i.attributes["path"] not in module.unread_parameters)
    if captured != args_bytes:
        raise RuntimeError(f"lower_cell: the captured program's arguments "
                           f"are {captured} bytes a device, the specs' "
                           f"{args_bytes}")
    out_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(outputs[0])
                    if hasattr(t, "element_size"))
    memory = {"argument_size_in_bytes": args_bytes,
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": None,
              "generated_code_size_in_bytes": None}
    return module, memory, secs


def _parse_flags(spec: str) -> dict:
    out = {}
    for part in (spec or "").split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        v = v.strip()
        if v.lower() in ("true", "false"):
            val = v.lower() == "true"
        else:
            try:
                val = int(v)
            except ValueError:
                val = v
        out[k.strip()] = val
    return out


_SERVICES = {}
_METRICS = None


def get_metrics():
    """Process-wide MetricsRegistry shared by every per-outdir service,
    so a sweep's `--metrics-out` dump covers all cells."""
    global _METRICS
    if _METRICS is None:
        from ..serve.metrics import MetricsRegistry
        _METRICS = MetricsRegistry()
    return _METRICS


def get_service(outdir: str):
    """One disk-backed LeoService per artifact dir: every cell in this
    process shares the graph/analysis caches, and the disk tier under
    `<outdir>/.leo_cache` is bounded — 512 MiB cap, 14-day idle TTL — so a
    long-lived sweep directory cannot grow without bound."""
    from ..core import LeoService
    svc = _SERVICES.get(outdir)
    if svc is None:
        svc = LeoService(cache_dir=os.path.join(outdir, ".leo_cache"),
                         disk_cache_max_bytes=512 * 2**20,
                         disk_cache_ttl_seconds=14 * 24 * 3600.0,
                         metrics=get_metrics())
        _SERVICES[outdir] = svc
    return svc


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             analyze: bool = False, save_hlo: bool = False,
             hw_name: str = "tpu_v5e", force: bool = False,
             model_flags: Optional[dict] = None, device="cuda",
             layers: int = 0) -> dict:
    """One cell's record, written to `<outdir>/<label>.json`.  `mesh_kind`
    "host" is the mesh of `device`'s ranks (`make_host_mesh`), "single"
    and "multi" the production meshes, behind a fake process group of
    their 256 (512) ranks for the length of the cell, whose per-device
    program is captured for `device`.  `layers` keeps the config's first
    N layers (the record's `reduced`); `argument_bytes` are always the
    uncut cell's, each tree's bytes a device under the specs."""
    from ..configs import get_config, get_shape, model_flops
    from ..core import get_backend
    from ..core.roofline import compute_roofline
    from ..models.flags import flags as flags_ctx
    from . import specs as S
    from .mesh import fake_production_mesh, make_host_mesh

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    label = f"{arch}__{shape_name}__{mesh_kind}"
    path = os.path.join(outdir, label + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    if shape.name == "long_500k" and not cfg.supports_long_context:
        result = {"label": label, "status": "skipped",
                  "reason": "full quadratic attention at 524k decode; "
                            "skip per DESIGN.md long-context applicability"}
        os.makedirs(outdir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    try:
        mesh_cm = contextlib.nullcontext(make_host_mesh(1, device=device)) \
            if mesh_kind == "host" else fake_production_mesh(
                multi_pod=(mesh_kind == "multi"), device=device)
        hw = get_backend(hw_name).hw
        with flags_ctx(**(model_flags or {})), mesh_cm as mesh:
            chips = mesh.size
            run_cfg, reduced = cfg, []
            if layers and layers < cfg.n_layers:
                reduced.append(f"n_layers {cfg.n_layers} -> {layers}")
                run_cfg = dataclasses.replace(cfg, n_layers=layers)
            # the uncut config's micro-batches: a depth cut keeps the loop
            opts = cell_options(cfg, shape, mesh)
            module, mem, secs = lower_cell(run_cfg, shape, mesh, opts=opts)
            per_tree = argument_bytes(cfg, shape, mesh,
                                      S.input_specs(cfg, shape),
                                      unread_leaves(shape, module))
            rl = compute_roofline(
                module, hw, chips=chips, label=label,
                model_flops=model_flops(run_cfg, shape))
            result = {"label": label, "status": "ok", "chips": chips,
                      "compile_seconds": secs, "roofline": rl.to_dict(),
                      "memory": mem, "argument_bytes": per_tree,
                      "argument_bytes_total": sum(per_tree.values()),
                      "hbm_bytes": hw.hbm_bytes,
                      "fits": sum(per_tree.values()) <= hw.hbm_bytes}
            if reduced:
                result["reduced"] = reduced
            if analyze:
                diag = get_service(outdir).diagnose(module,
                                                    backend=hw_name)
                result["leo"] = diag.to_dict()
            if save_hlo:
                os.makedirs(outdir, exist_ok=True)
                with gzip.open(os.path.join(
                        outdir, label + ".module.pkl.gz"), "wb") as f:
                    pickle.dump(module, f)
            print(f"[ok] {label}: capture={secs:.1f}s  "
                  f"{rl.summary_row()}")
            print(f"     memory: {mem}")
    except Exception as e:  # noqa: BLE001 - report failures as cell results
        result = {"label": label, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
        print(f"[FAIL] {label}: {type(e).__name__}: {e}")

    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    from ..configs import ALL_ARCHS, get_config, shapes_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "host"],
                    help="host: the ranks' own mesh; single, multi: the "
                         "production meshes behind a fake process group")
    ap.add_argument("--device", default="cuda",
                    help="the device the per-device program is captured "
                         "for (cpu: the plain paths, no kernel regions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep each config's first N layers (0: all)")
    ap.add_argument("--outdir", default="experiments/dryrun")
    ap.add_argument("--analyze", action="store_true",
                    help="run LEO root-cause analysis per cell")
    ap.add_argument("--save-hlo", action="store_true",
                    help="save each captured Module (a gzipped pickle)")
    ap.add_argument("--hw", default="tpu_v5e")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--flags", default="",
                    help="model flags, e.g. attention_impl=plain,"
                         "ssm_fused=true,ssm_pallas=true,"
                         "moe_impl=ep_shardmap")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the analysis-cache/latency metrics "
                         "(Prometheus text format) to PATH after the sweep")
    args = ap.parse_args(argv)
    model_flags = _parse_flags(args.flags)

    archs = [c.name for c in ALL_ARCHS] if args.arch == "all" \
        else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shape_names = [s.name for s in shapes_for(cfg)] + (
            ["long_500k"] if not cfg.supports_long_context else [])
        if args.shape != "all":
            shape_names = args.shape.split(",")
        for shape_name in shape_names:
            for mesh_kind in meshes:
                r = run_cell(arch, shape_name, mesh_kind, args.outdir,
                             analyze=args.analyze, save_hlo=args.save_hlo,
                             hw_name=args.hw, force=args.force,
                             model_flags=model_flags, device=args.device,
                             layers=args.layers)
                if r.get("status") == "error":
                    failures += 1
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(get_metrics().render())
        print(f"wrote metrics to {args.metrics_out}")
    print(f"\ndry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
