"""Dry run: what does an (arch x shape x mesh) cell cost, and does it fit?
(the port of `repro.launch.dryrun`).

For each cell this:
  1. builds the mesh: the card's own (`--mesh host`, `make_host_mesh`), or
     the reference's production meshes (16x16 single-pod, 2x16x16
     multi-pod), which have no devices behind them here;
  2. on a mesh whose devices exist, captures the cell's step
     (`make_train_step`, `make_prefill_step` or `make_serve_step`) with
     `core/torch_frontend.capture` on `launch/specs.py`'s meta stand-ins at
     the per-device shapes, on the mesh's device: nothing is allocated and
     nothing runs;
  3. records the per-device argument and output bytes under
     `parallel/sharding.py`'s specs in place of XLA's `memory_analysis()`
     (its temp and code sizes have no counterpart without a compiler and
     are recorded as absent, `None`, never estimated);
  4. derives the roofline terms from the captured Module with the port's
     `core/roofline.compute_roofline`, and
  5. optionally runs LEO's analysis of the Module (--analyze).

PyTorch on one card has no partitioner: the per-device program of an
N-device mesh, with its collectives, is not built.  On the production
meshes a cell is recorded `"status": "specs_only"`: each argument tree's
bytes on a device under the specs (exact: each leaf's shard shape times
its element size), whether they fit the `--hw` backend's memory, and why
there is no program.

Artifacts land in experiments/dryrun/<arch>__<shape>__<mesh>.json (plus
the captured Module, a gzipped pickle, with --save-hlo).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k --mesh host --analyze --hw nvidia_h100_sxm
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import pickle
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from torch.utils._pytree import tree_leaves

NO_PARTITIONER = ("no partitioner: the per-device program of an {n}-device "
                  "mesh is not built on one card")


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


def argument_bytes(cfg, shape, mesh, inputs) -> Dict[str, int]:
    """Each argument tree's bytes on one device of `mesh` under the specs."""
    from ..parallel.sharding import ShardingRules, per_device_bytes
    rules = ShardingRules(mesh, cfg)
    return {name: per_device_bytes(specs, tree, mesh)
            for name, (tree, specs) in
            argument_trees(cfg, shape, rules, inputs).items()}


def cell_program(cfg, shape, inputs, device, opts=None):
    """(step, args): the cell's step and its arguments in call order
    (`inputs` from `specs.input_specs`, or real tensors of the same
    structure)."""
    from ..runtime.steps import (make_prefill_step, make_serve_step,
                                 make_train_step)
    batch = inputs["batch"]
    if shape.kind == "train":
        return (make_train_step(cfg, options=opts),
                (inputs["state"], batch))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, chunk=min(512, shape.seq_len),
                                  device=device), (inputs["params"], batch))
    return (make_serve_step(cfg),
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


def lower_cell(cfg, shape, mesh, opts=None, inputs=None):
    """Capture one (arch, shape, mesh) cell on a mesh whose devices exist.
    Returns (module, memory, seconds): the captured `Module`, the memory
    record (per-device argument and output bytes; temp and code sizes
    None) and the seconds the capture took.  `inputs` replaces
    `specs.input_specs(cfg, shape)`."""
    from ..core import capture
    from ..parallel.context import mesh_context
    from . import specs as S

    if mesh.devices is None:
        raise RuntimeError(NO_PARTITIONER.format(n=mesh.size))
    if mesh.size != 1:
        raise NotImplementedError(
            f"lower_cell on a {mesh.shape} mesh of devices needs "
            f"torch.distributed process groups, a later slice of the port")
    if opts is None:
        opts = cell_options(cfg, shape, mesh)
    if inputs is None:
        inputs = S.input_specs(cfg, shape)
    args_bytes = sum(argument_bytes(cfg, shape, mesh, inputs).values())
    step, args = cell_program(cfg, shape, inputs, mesh.device, opts)
    outputs = []

    def traced(*a):
        out = step(*a)
        outputs.append(out)
        return out

    t0 = time.time()
    with mesh_context(mesh):
        module = capture(traced, *args, name=f"{shape.kind}_step",
                         device=mesh.device)
    secs = time.time() - t0
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


def specs_only(cfg, shape, mesh, label: str, hw) -> dict:
    """The record of a cell on a mesh with no devices behind it: each
    argument tree's per-device bytes under the specs, and whether they fit
    `hw`'s memory."""
    from . import specs as S
    per_tree = argument_bytes(cfg, shape, mesh, S.input_specs(cfg, shape))
    total = sum(per_tree.values())
    return {"label": label, "status": "specs_only", "chips": mesh.size,
            "reason": NO_PARTITIONER.format(n=mesh.size),
            "argument_bytes": per_tree, "argument_bytes_total": total,
            "hw": hw.name, "hbm_bytes": hw.hbm_bytes,
            "fits": total <= hw.hbm_bytes}


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             analyze: bool = False, save_hlo: bool = False,
             hw_name: str = "tpu_v5e", force: bool = False,
             model_flags: Optional[dict] = None, device="cuda") -> dict:
    """One cell's record, written to `<outdir>/<label>.json`.  `mesh_kind`
    "host" is the card's own mesh (`device`'s), "single" and "multi" the
    production meshes."""
    from ..configs import get_config, get_shape, model_flops
    from ..core import get_backend
    from ..core.roofline import compute_roofline
    from ..models.flags import flags as flags_ctx
    from .mesh import make_host_mesh, make_production_mesh

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
        mesh = make_host_mesh(1, device=device) if mesh_kind == "host" \
            else make_production_mesh(multi_pod=(mesh_kind == "multi"))
        chips = mesh.size
        hw = get_backend(hw_name).hw
        with flags_ctx(**(model_flags or {})):
            if mesh.devices is None:
                result = specs_only(cfg, shape, mesh, label, hw)
                print(f"[specs] {label}: "
                      f"{result['argument_bytes_total'] / 2**30:.3f} GiB "
                      f"of arguments a device, "
                      f"{'fits' if result['fits'] else 'does not fit'} "
                      f"{hw.name}")
            else:
                module, mem, secs = lower_cell(cfg, shape, mesh)
                rl = compute_roofline(
                    module, hw, chips=chips, label=label,
                    model_flops=model_flops(cfg, shape))
                result = {"label": label, "status": "ok", "chips": chips,
                          "compile_seconds": secs, "roofline": rl.to_dict(),
                          "memory": mem}
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
                    help="host: the card's own mesh; single, multi: "
                         "the production meshes, specs only")
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
                             model_flags=model_flags)
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
