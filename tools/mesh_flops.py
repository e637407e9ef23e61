"""Per-device FLOPs of the port's per-device program against the
reference's compiled SPMD program, on a (2, 2) ("data", "model") mesh.

For each (config, MoE form) and each kind (train, prefill, decode), at
smoke size (S 64, B 8): the port's `launch/dryrun.py::lower_cell` captured
behind PyTorch's fake process group of 4 ranks, and the reference's
`repro.launch.dryrun.lower_cell` compiled on 4 XLA host devices in a child
process (`parse_hlo` of the compiled text).  Prints, a line each, the
FLOPs of both, their ratio, the argument bytes of both and the collective
kinds; with `--ops` the FLOPs of each side by opcode.  These are
instruction counts of LEO's model, not times.  The test
`tests/test_torch_dryrun_mesh.py` holds the ratio within 10%.
`--root DIR` captures the port of the tree at DIR (a `git archive` of
another commit); the reference is this tree's.

Usage:
  PYTHONPATH=src python tools/mesh_flops.py \\
      --cases deepseek-v2-236b:global,hymba-1.5b:global [--ops] \\
      [--root DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 8
KINDS = ("train", "prefill", "decode")

REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %r)
import mesh_flops as mf
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as rd
from repro.configs import ShapeConfig, get_config, smoke_config
from repro.core import parse_hlo
from repro.models.flags import flags
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, impl, kind in json.loads(sys.argv[1]):
    shape = ShapeConfig("smoke_" + kind, mf.SEQ, mf.BATCH, kind)
    with flags(moe_impl=impl):
        _, compiled, _ = rd.lower_cell(smoke_config(get_config(arch)),
                                       shape, mesh)
    module = parse_hlo(compiled.as_text(), hints={"total_devices": 4})
    out["|".join((arch, impl, kind))] = mf.summary(
        module, compiled.memory_analysis().argument_size_in_bytes,
        lambda op: op.replace("-start", "").replace("-done", ""))
print(json.dumps(out))
""" % str(Path(__file__).resolve().parent)

COLLECTIVES = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"}


def by_opcode(module) -> dict:
    """FLOPs by opcode, a loop body's times its trip count."""
    out = defaultdict(float)

    def walk(name, mult, stack):
        if name in stack or name not in module.computations:
            return
        for instr in module.computations[name].instructions:
            out[instr.opcode] += mult * instr.flops
            for callee in instr.called_computations:
                walk(callee, mult * instr.trip_count, stack | {name})
    walk(module.entry, 1.0, frozenset())
    return {k: v for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            if v}


def summary(module, args: int, opcode=lambda op: op) -> dict:
    return {"flops": module.total_flops(), "args": args,
            "collectives": sorted({opcode(i.opcode)
                                   for i in module.all_instructions()} &
                                  COLLECTIVES),
            "ops": by_opcode(module)}


def port(cases) -> dict:
    from repro_torch.configs import ShapeConfig, get_config, smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.flags import flags
    out = {}
    for arch, impl, kind in cases:
        shape = ShapeConfig("smoke_" + kind, SEQ, BATCH, kind)
        with flags(moe_impl=impl), \
                fake_mesh(("data", "model"), (2, 2), "cpu") as mesh:
            module, memory, _ = dryrun.lower_cell(
                smoke_config(get_config(arch)), shape, mesh)
        out["|".join((arch, impl, kind))] = summary(
            module, memory["argument_size_in_bytes"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="qwen2-0.5b:global",
                    help="arch:moe_impl, comma-separated")
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--ops", action="store_true",
                    help="print each side's FLOPs by opcode")
    ap.add_argument("--root", default=None,
                    help="capture the port of the tree at DIR")
    ap.add_argument("--port-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cases = [(*c.split(":"), kind) for c in args.cases.split(",")
             for kind in args.kinds.split(",")]
    if args.port_only:
        print(json.dumps(port(cases)))
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF, json.dumps(cases)],
                           env=env, stdout=subprocess.PIPE, text=True)
    if args.root is None:
        mine = port(cases)
    else:
        done = subprocess.run(
            [sys.executable, __file__, "--port-only", "--cases",
             args.cases, "--kinds", args.kinds],
            env=dict(env, PYTHONPATH=os.path.join(args.root, "src")),
            stdout=subprocess.PIPE, text=True, check=True)
        mine = json.loads(done.stdout.strip().splitlines()[-1])
    out, _ = ref.communicate()
    if ref.returncode:
        raise SystemExit(f"the reference's child failed ({ref.returncode})")
    theirs = json.loads(out.strip().splitlines()[-1])
    for key, p in mine.items():
        r = theirs[key]
        print(f"{key}: port {p['flops']:.0f} / reference {r['flops']:.0f}"
              f" = {p['flops'] / r['flops']:.3f}; arguments {p['args']} / "
              f"{r['args']}; collectives {p['collectives']} / "
              f"{r['collectives']}")
        if args.ops:
            print(f"  port {p['ops']}\n  reference {r['ops']}")
    if args.out:
        Path(args.out).write_text(json.dumps({"port": mine,
                                              "reference": theirs}))


if __name__ == "__main__":
    main()
