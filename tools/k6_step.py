#!/usr/bin/env python3
"""Where a step of the sLSTM scan (K6) goes, on one NVIDIA GPU.

  python3 tools/k6_step.py

At xlstm-125m's prefill shape (B 4, S 1024, D 768), f32 and bf16:
1. the first design of the kernel, from `tools/k6_step_probe.cu`, with
   parts of its step switched off (the grid barrier alone, the barrier and
   the h fetch, the step without its barrier, a one-way exchange in place
   of the barrier, the step without its store of `out`);
2. the kernel of `src/repro_torch/csrc/slstm_scan.cu`, copied under
   `build/k6_step/` with parts of its step removed (the product, the
   owners' math, the wait for the other blocks, the first tile's load of
   the gate inputs, the store of `out`), each copy built with nvcc
   and timed through the kernel's C entry point.
Every time is CUDA events around one call, the median of 6 calls after 2.
A copy that skips work computes nothing right: it times, it does not
check.  The card's name and power limit are printed first.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k6_step"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
B, S, D = 4, 1024, 768

# the removals, as (text in the source, its replacement)
PRODUCT = ("      for (int c = c_lo + sub; c < c_hi; c += kSubs) {",
           "      for (int c = c_lo + sub; c < c_lo; c += kSubs) {")
WAIT = ("        for (int64_t spins = 0; ld_acquire(counter) < want; ++spins)",
        "        for (int64_t spins = 0; false; ++spins)")
OWNER = ("        const float h =\n"
         "            (1.f / (1.f + expf(-gate[3]))) * c_new / "
         "fmaxf(n_new, 1.f);",
         "        const float h = gate[0] + gate[1] + gate[2] + gate[3] + c + "
         "n + m;")
XG = ("\n      for (int g = 0; g < 4; ++g) x4[g] = repro::to_f32(x[g * D]);",
      "\n      for (int g = 0; g < 4; ++g) x4[g] = 0.5f;")
OUT_STORE = ("    if (tiles == 1 && owns)\n      out[",
             "    if (false)\n      out[")
VARIANTS = {"kernel": (), "no product": (PRODUCT,), "no owner math": (OWNER,),
            "no wait": (WAIT,), "no wait, no product": (WAIT, PRODUCT),
            "no xg load": (XG,), "no out store": (OUT_STORE,)}


def build(nvcc: str):
    """Start every nvcc at once; return {name: library or binary path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    source = (csrc / "slstm_scan.cu").read_text()
    jobs = {"probe": subprocess.Popen(
        [nvcc, *FLAGS, "-o", str(OUT / "probe"),
         str(ROOT / "tools" / "k6_step_probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    paths = {"probe": OUT / "probe"}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"k6_step: {name}: the source no longer "
                                 f"holds {old.strip()!r}")
            text = text.replace(old, new, 1)
        src = OUT / f"variant{i}.cu"
        src.write_text(text)
        (OUT / "common.cuh").write_text((csrc / "common.cuh").read_text())
        paths[name] = OUT / f"libvariant{i}.so"
        jobs[name] = subprocess.Popen(
            [nvcc, *FLAGS, "-Xcompiler", "-fPIC", "-shared", "-o",
             str(paths[name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise SystemExit(f"k6_step: nvcc failed for {name}:\n{log}")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k6_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import slstm_scan as k6

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    paths = build(_build.find_nvcc())
    print(subprocess.run([str(paths.pop("probe"))], capture_output=True,
                         text=True, check=True).stdout, end="")
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(13)
        xg = torch.randn((B, S, 4 * D), generator=gen, device="cuda").to(
            dtype)
        r = (0.1 * torch.randn((D, 4 * D), generator=gen,
                               device="cuda")).to(dtype)
        out = torch.empty((B, S, D), dtype=dtype, device="cuda")
        for name, path in paths.items():
            fn = ctypes.CDLL(str(path)).repro_slstm_scan_fwd
            fn.argtypes = _build.SIGNATURES["repro_slstm_scan_fwd"]
            fn.restype = ctypes.c_int
            times = []
            for _ in range(8):
                hbuf = torch.zeros(k6.hbuf_floats(B, D), device="cuda")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fn(_build.DTYPE_CODE[dtype], xg.data_ptr(),
                         r.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
                         hbuf.data_ptr(), B, S, D, _build.current_stream(xg))
                end.record()
                end.synchronize()
                if err:
                    raise SystemExit(f"k6_step: {name}: CUDA error {err}")
                times.append(start.elapsed_time(end))
            ms = statistics.median(times[2:])
            print(f"kernel {str(dtype)[6:]:8s} {name:20s} {ms:.4f} ms, "
                  f"{ms * 1e3 / S:.3f} us a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
