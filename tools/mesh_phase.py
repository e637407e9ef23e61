#!/usr/bin/env python3
"""Run phase 23 of `chip_smoke.py` alone: the per-device program of a
mesh (`runtime/steps.py`) on the card, after the kernel build.

  python3 tools/mesh_phase.py          # (a) and (b) on one card, and (c)
                                       # where four cards exist
  python3 tools/mesh_phase.py four     # (c) alone: four NCCL ranks
  python3 tools/mesh_phase.py four deepseek-v2-236b   # (c) of one config

(a) phase 22's MoE train step and qwen2-0.5b's prefill on an NCCL group of
one rank against one card, bit for bit; (b) a production cell's program
captured in a child process behind the fake process group; (c) where four
cards exist, four NCCL ranks on a (2, 2) mesh against one card.  The
card's name and power limit are printed first; the result goes to
`chiprun_out/phase23.json`.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    import repro_torch.data as data
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import init_params
    from repro_torch.models.flags import flags
    from repro_torch.runtime import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if argv[:1] == ["four"]:
        result = cs.mesh_four_ranks(torch, tuple(argv[1:]) or
                                    cs.MESH_RANKS_ARCHS)
    else:
        result = cs.run_mesh(torch, ops, flags, get_config, init_params,
                             make_prefill_step, runtime, data)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    out = ROOT / "chiprun_out" / "phase23.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except cs.SmokeFailure as exc:
        print(f"mesh_phase: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
