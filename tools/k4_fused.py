#!/usr/bin/env python3
"""K4's fused entry (`repro_ssm_scan_fused_fwd`) on one NVIDIA GPU: this
tree's kernel beside another tree's, and copies with a part changed or
removed.

  python3 tools/k4_fused.py [--parent DIR] [--variants] [--out FILE]

At hymba-1.5b's prefill shape (B 2, S 2048, din 3200, N 16), for xin in
bf16 as the model hands it (the view `xz[..., :din]` of a (B, S, 2 din)
tensor), bf16 contiguous and f32:
- `kernel`: `src/repro_torch/csrc/ssm_scan.cu` as it is;
- `parent`: `DIR/src/repro_torch/csrc/ssm_scan.cu` with --parent (unpack a
  commit there with `git archive <commit> | tar -x -C DIR`);
- with --variants, copies of this tree's source with its layout constants
  changed (`VARIANTS`: steps a thread, channels a block, blocks an SM the
  registers must allow), which compute the same function, and copies with
  a part removed, which compute nothing right.
Every copy is built with nvcc under `build/k4_fused/` (all started
together) and called through its C entry.  A copy that computes the
function is first held against the sequential oracle on the terms the
plain version discretizes, 1e-4 + 1e-4 |oracle|, at the timed shape and at
S 300 (ragged chunks), din 3208 (a ragged channel tile).  Times: CUDA
events around 20 calls, the median of 11 samples, taken in turns (every
copy in order, then in reverse order, twice over).  The card's name and
power limit are printed first; with --out the rows are written as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import ptxas_report  # noqa: E402
OUT = ROOT / "build" / "k4_fused"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
B, S, DIN, N = 2, 2048, 3200, 16


def layout(chunk=128, steps=16, channels=16, min_blocks=4):
    """The edits that set the fused kernel's layout constants."""
    return tuple((f"constexpr int {name} = {old};",
                  f"constexpr int {name} = {new};")
                 for name, old, new in (
                     ("kFusedChunk", 128, chunk), ("kFusedSteps", 16, steps),
                     ("kFusedChannels", 16, channels),
                     ("kFusedMinBlocks", 4, min_blocks))
                 if old != new)


# (edits as (text in the source, its replacement), computes the function)
VARIANTS = {
    # 8 steps a thread, 8 channels a block: the first layout timed (72
    # registers a thread for 7 blocks an SM, with spills)
    "R8 C8": (layout(steps=8, channels=8, min_blocks=7), True),
    "R16 C8": (layout(channels=8, min_blocks=7), True),
    "no scan": ((("for (int o = 1; o < P; o <<= 1) {",
                  "for (int o = P; o < P; o <<= 1) {"),), False),
    "no softplus": ((("dt[r] = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));",
                      "dt[r] = fmaxf(v, 0.f);"),), False),
    "no ex2": ((("a[r] = ex2(na * dt[r]);", "a[r] = na * dt[r];"),
                ("float A = ex2(na * dts);", "float A = na * dts;")), False),
    "no bsel/csel copy": ((("for (int e = tid; e < L * N; e += NT) {",
                            "for (int e = tid; e < 0; e += NT) {"),), False),
    "no y sum": ((("yv[r] = fmaf(h, cv[j], yv[r]);", "yv[r] = h;"),), False),
}


def build(nvcc: str, parent: Path | None, variants: bool):
    """Start every nvcc at once; return {name: (library, checked)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    sources = {"kernel": ((csrc / "ssm_scan.cu").read_text(), csrc, True)}
    if parent is not None:
        pcsrc = parent / "src" / "repro_torch" / "csrc"
        sources["parent"] = ((pcsrc / "ssm_scan.cu").read_text(), pcsrc,
                             True)
    if variants:
        text = sources["kernel"][0]
        for name, (edits, checked) in VARIANTS.items():
            edited = text
            for old, new in edits:
                if old not in edited:
                    raise SystemExit(f"k4_fused: {name}: the source no "
                                     f"longer holds {old!r}")
                edited = edited.replace(old, new)
            sources[name] = (edited, csrc, checked)
    jobs, paths = {}, {}
    for i, (name, (text, inc, checked)) in enumerate(sources.items()):
        sub = OUT / f"copy{i}"
        sub.mkdir(exist_ok=True)
        (sub / "common.cuh").write_text((inc / "common.cuh").read_text())
        (sub / "ssm_scan.cu").write_text(text)
        paths[name] = (sub / "libk4.so", checked)
        jobs[name] = subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(paths[name][0]),
             str(sub / "ssm_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise SystemExit(f"k4_fused: nvcc failed for {name}:\n{log}")
        fused = ptxas_report(log, "ssm_scan_fused_kernel")
        print(f"built {name}: ssm_scan_fused_kernel by dtype,N: " + ", ".join(
            f"{key} {r.get('registers')} registers {r.get('spill_bytes')} "
            f"spill bytes" for key, r in sorted(fused.items())))
    return paths


def inputs(torch, dt_name, b, s, din, n, strided):
    """As chip_smoke.fused_scan_inputs: a_log = log(1..N), w_dt of unit
    scale, xin and the selections of order one."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    xz = torch.randn((b, s, 2 * din if strided else din), generator=gen,
                     device="cuda").to(getattr(torch, dt_name))
    w_dt = torch.randn((din,), generator=gen, device="cuda")
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda")).expand(din, n).contiguous()
    bsel = 0.5 * torch.randn((b, s, n), generator=gen, device="cuda")
    csel = 0.5 * torch.randn((b, s, n), generator=gen, device="cuda")
    return xz[..., :din], w_dt, a_log, bsel, csel


def caller(torch, _build, path):
    fn = ctypes.CDLL(str(path)).repro_ssm_scan_fused_fwd
    fn.argtypes = _build.SIGNATURES["repro_ssm_scan_fused_fwd"]
    fn.restype = ctypes.c_int

    def call(xin, w_dt, a_log, bsel, csel, y):
        b, s, din = xin.shape
        err = fn(_build.DTYPE_CODE[xin.dtype], xin.data_ptr(),
                 xin.stride(0), xin.stride(1), w_dt.data_ptr(),
                 a_log.data_ptr(), bsel.data_ptr(), csel.data_ptr(),
                 y.data_ptr(), b, s, din, a_log.shape[-1],
                 _build.current_stream(xin))
        if err:
            raise SystemExit(f"k4_fused: {path}: CUDA error {err}")
    return call


def time_ms(torch, call, *args) -> float:
    """CUDA events around 20 calls, the median of 11 samples, after 3."""
    for _ in range(3):
        call(*args)
    times = []
    for _ in range(11):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scaling", action="store_true",
                    help="also time each copy that computes the function "
                         "at B 1, din 16 x 132 x k (16 k channels an SM)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_fused: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import discretize, ssm_scan_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    paths = build(_build.find_nvcc(), args.parent, args.variants)
    calls = {name: caller(torch, _build, p) for name, (p, _) in paths.items()}
    for name, (_, checked) in paths.items():
        if not checked:
            continue
        for dt_name, s, din, strided in (("bfloat16", S, DIN, True),
                                         ("float32", 300, DIN + 8, False),
                                         ("bfloat16", 300, DIN + 8, True)):
            xin, w_dt, a_log, bsel, csel = inputs(torch, dt_name, B, s, din,
                                                  N, strided)
            y = torch.empty((B, s, din), device="cuda")
            calls[name](xin, w_dt, a_log, bsel, csel, y)
            oracle = ssm_scan_plain(*discretize(xin, w_dt, a_log, bsel),
                                    csel)
            err = (y - oracle).abs()
            excess = (err - 1e-4 * oracle.abs() - 1e-4).max().item()
            print(f"check {name} {dt_name} S{s} din{din}: max abs err "
                  f"{err.max().item():.3e}, "
                  f"{'within' if excess <= 0 else 'BEYOND'} 1e-4 + "
                  f"1e-4*|oracle|")
            if excess > 0:
                return 1
    rows = []
    for dt_name, strided in (("bfloat16", True), ("bfloat16", False),
                             ("float32", False)):
        xin, w_dt, a_log, bsel, csel = inputs(torch, dt_name, B, S, DIN, N,
                                              strided)
        y = torch.empty((B, S, DIN), device="cuda")
        order = list(calls)
        samples = {name: [] for name in order}
        for turn in order + order[::-1] + order + order[::-1]:
            samples[turn].append(time_ms(torch, calls[turn], xin, w_dt,
                                         a_log, bsel, csel, y))
        case = f"{dt_name}{' strided' if strided else ''}"
        for name in order:
            ms = samples[name]
            rows.append({"case": case, "copy": name, "turns_ms": ms,
                         "median_ms": statistics.median(ms)})
            print(f"time {case:16s} {name:18s} median "
                  f"{statistics.median(ms):.4f} ms, turns "
                  + " ".join(f"{t:.4f}" for t in ms))
    if args.scaling:
        # B 1, din 16 x 132 x k: k blocks of 16 channels on each of 132
        # SMs (2k of 8 channels)
        for name in [n for n, (_, checked) in paths.items() if checked]:
            for k in (1, 2, 3, 4, 5, 6):
                din = 16 * 132 * k
                xin, w_dt, a_log, bsel, csel = inputs(
                    torch, "bfloat16", 1, S, din, N, True)
                y = torch.empty((1, S, din), device="cuda")
                ms = time_ms(torch, calls[name], xin, w_dt, a_log, bsel,
                             csel, y)
                rows.append({"case": f"scaling B1 din {din}", "copy": name,
                             "median_ms": ms})
                print(f"scaling {name:18s} B1 din {din:5d} ({16 * k} "
                      f"channels an SM): {ms:.4f} ms")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "shape": [B, S, DIN, N],
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
