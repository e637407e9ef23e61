"""Per-device records of the MoE configurations' production cells.

For each (config, shape) cell, rank 0's per-device program on the 16x16
production mesh (`launch/dryrun.py::lower_cell` behind the fake process
group of its 256 ranks), at full width with the depth cut to `--layers`:
the FLOPs a device, the collective wire bytes by kind, and by the
function that issues it the largest tensor one all-gather makes
(`materialize`: the largest weight a layer gathers; `prefill_step`: the
logits' vocab).
Captures only: nothing is allocated and nothing runs, so it runs on the
CPU.  `--root DIR` captures the tree at DIR (a `git archive` of another
commit) in a fresh process, so two trees are compared by one command.

Usage:
  PYTHONPATH=src python tools/mesh_records.py --layers 2 \\
      --out chiprun_out/mesh_records.json [--root build/parent]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

CELLS = [(arch, shape, impl)
         for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")
         for shape, impl in (("train_4k", "global"),
                             ("train_4k", "ep_shardmap"),
                             ("prefill_32k", "global"),
                             ("decode_32k", "global"))]


SPMD_FUNCTIONS = {"all_gather", "apply", "forward", "backward", "leaf",
                  "tree_map_with_path", "<lambda>", "<listcomp>",
                  "<dictcomp>", "<genexpr>"}


def record(arch: str, shape_name: str, impl: str, layers: int) -> dict:
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.collectives import collective_summary
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.models.flags import flags

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    run_cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.time()
    with flags(moe_impl=impl), fake_production_mesh() as mesh:
        opts = dryrun.cell_options(cfg, shape, mesh)
        module, memory, _ = dryrun.lower_cell(run_cfg, shape, mesh,
                                              opts=opts)
    # the largest tensor an all-gather makes, by the function that issues
    # it (the innermost frame outside `parallel/spmd.py`)
    gathers = {}
    for i in module.all_instructions():
        if i.opcode != "all-gather":
            continue
        chain = [f for f in i.op_name.split("/")[1:]
                 if not f.startswith("_") and f not in SPMD_FUNCTIONS]
        where = chain[-1] if chain else "?"
        if i.shape.byte_size > gathers.get(where, (0,))[0]:
            gathers[where] = (i.shape.byte_size, list(i.shape.dims))
    colls = collective_summary(module, trip_aware=True)
    return {"cell": f"{arch}__{shape_name}__{impl}",
            "layers": layers,
            "flops": module.total_flops(),
            "collective_bytes": {k: v.wire_bytes for k, v in
                                 sorted(colls.items())},
            "largest_gather": dict(sorted(gathers.items(),
                                          key=lambda kv: -kv[1][0])),
            "argument_bytes": memory["argument_size_in_bytes"],
            "capture_s": time.time() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="capture the tree at DIR instead of this one")
    ap.add_argument("--cell", default=None,
                    help="one cell, arch__shape__impl (else all of CELLS)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.root is not None:
        env = dict(os.environ, PYTHONPATH=os.path.join(args.root, "src"))
        cmd = [sys.executable, os.path.abspath(__file__), "--layers",
               str(args.layers)] + (["--cell", args.cell] if args.cell
                                    else []) + (["--out", args.out]
                                                if args.out else [])
        raise SystemExit(subprocess.call(cmd, env=env))
    cells = CELLS if args.cell is None else \
        [tuple(args.cell.split("__"))]
    out = []
    for arch, shape, impl in cells:
        rec = record(arch, shape, impl, args.layers)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
