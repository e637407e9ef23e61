"""Build and load the port's CUDA kernel library.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one `nvcc` per
source, all started together) and linked into one shared library with a
plain C interface, loaded with `ctypes`.  The library lives under
`build/repro_torch/` at the repository root and its name carries a hash of
the sources and flags, so a stale build is never loaded.  Nothing is built
when this module is imported: `library()` builds at first use.

`ptx(source)` compiles one source to PTX with line information (for
`core/ptx_frontend.py`), cached the same way.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# PTX for the kernel-body front-end: the same target and optimisation, with
# `.loc` line information
PTX_FLAGS = ("-arch=sm_90a", "-std=c++17", "-O3", "-lineinfo", "-ptx")

_P, _I64, _F32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
# C entry points: (name, argtypes).  Each returns cudaGetLastError() as int.
SIGNATURES = {
    # dtype, q, k, v, out, B, S, H, Kv, hd, block_q, block_k, causal,
    # window (0 = none), scale, stream
    "repro_flash_attention_fwd": [_INT, _P, _P, _P, _P, _I64, _I64, _I64,
                                  _I64, _I64, _I64, _I64, _I64, _I64, _F32,
                                  _P],
    # dtype, x, scale, out, R, D, eps, stream
    "repro_rmsnorm_baseline_fwd": [_INT, _P, _P, _P, _I64, _I64, _F32, _P],
    # dtype, x, scale, out, R, D, eps, grid, stream
    "repro_rmsnorm_pipelined_fwd": [_INT, _P, _P, _P, _I64, _I64, _F32,
                                    _I64, _P],
    # dtype (a, bx, c), a, bx, c, y, B, S, din, N, stream
    "repro_ssm_scan_fwd": [_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                           _P],
}
# the `dtype` argument of every entry point: repro::kFloat32 and
# repro::kBFloat16 in csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100


class BuildError(RuntimeError):
    """The kernel library could not be built."""


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of repro_torch are built from src/repro_torch/csrc at first "
        "use and need the CUDA toolkit; CPU tensors take the plain path")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_sources_hash(NVCC_FLAGS)}.so"


def _sources_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless an up-to-date one exists; return its path.

    The compiler's output (with `-Xptxas -v`: registers, shared memory and
    spills of each kernel) is written beside the library as `build.log`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for cmd, _, proc in procs:  # wait for every nvcc before judging
            log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        for (_, _, proc), text in zip(procs, log):
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed ({proc.returncode}):\n{text}")
        objs = [str(obj) for _, obj, _ in procs]
        tmp_lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp_lib), *objs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            raise BuildError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    return out


def ptx(source: str) -> Path:
    """PTX of `csrc/<source>` for sm_90a with `.loc` line information
    (`nvcc -ptx -lineinfo`), written under `build/repro_torch/` keyed by a
    hash of the sources and flags; raises `BuildError` without nvcc."""
    src = CSRC / source
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    out = BUILD_DIR / f"{src.stem}_{_sources_hash(PTX_FLAGS)}.ptx"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc, *PTX_FLAGS, str(src), "-o", str(tmp_out)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise BuildError(f"nvcc -ptx failed ({res.returncode}):\n"
                             f"{' '.join(cmd)}\n{res.stdout}")
        os.replace(tmp_out, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
