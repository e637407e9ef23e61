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
    # q, k, v, out, B, S, H, Kv, hd, block_q, block_k, causal, window
    # (0 = none), scale, stream: f32 (CUDA cores) and bf16 (tensor cores)
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                  _I64, _I64, _I64, _I64, _I64, _F32, _P],
    "repro_flash_attention_tc_fwd": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                     _I64, _I64, _I64, _I64, _I64, _F32, _P],
    # dtype, x, scale, out, R, D, eps, chunks a lane, 16-byte loads, stream
    "repro_rmsnorm_baseline_fwd": [_INT, _P, _P, _P, _I64, _I64, _F32, _I64,
                                   _INT, _P],
    # dtype, x, scale, out, R, D, eps, chunks a lane, rows a stage, scale
    # in shared memory, grid, stream
    "repro_rmsnorm_pipelined_fwd": [_INT, _P, _P, _P, _I64, _I64, _F32,
                                    _I64, _I64, _INT, _I64, _P],
    # dtype, D, chunks a lane, rows a stage, scale in shared memory, blocks
    # an SM (out)
    "repro_rmsnorm_pipelined_occupancy": [_INT, _I64, _I64, _I64, _INT,
                                          ctypes.POINTER(_INT)],
    # dtype (a, bx, c), a, bx, c, y, B, S, din, N, stream
    "repro_ssm_scan_fwd": [_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                           _P],
    # dtype (xin), xin, its batch and time strides (elements), w_dt,
    # a_log, bsel, csel, y, B, S, din, N, stream
    "repro_ssm_scan_fused_fwd": [_INT, _P, _I64, _I64, _P, _P, _P, _P, _P,
                                 _I64, _I64, _I64, _I64, _P],
    # dtype (xin), N, blocks an SM (out), channels a block (out)
    "repro_ssm_scan_fused_occupancy": [_INT, _I64, ctypes.POINTER(_INT),
                                       ctypes.POINTER(_INT)],
    # dtype (q, k, v), q, k, v, log_i, log_f, out, state scratch C, n, m,
    # B, S, H, hd, chunk, passes (1 states, 2 outputs, 3 both), stream
    "repro_mlstm_chunkwise_fwd": [_INT, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I64, _I64, _I64, _I64, _I64, _INT, _P],
    # dtype (xg, r), xg, r, out, hbuf (h and the step counter), state, B,
    # S, D, stream
    "repro_slstm_scan_fwd": [_INT, _P, _P, _P, _P, _P, _I64, _I64, _I64,
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


def log_path() -> Path:
    """The compiler's output for the library at `library_path()`."""
    return library_path().with_suffix(".log")


def _sources_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless an up-to-date one exists; return its path.

    The compiler's output (with `-Xptxas -v`: registers, shared memory and
    spills of each kernel) is written beside the library under the same
    hash, at `log_path()`."""
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
        tmp_log = Path(tmp) / log_path().name
        tmp_log.write_text("\n".join(log))
        os.replace(tmp_log, log_path())  # the log first: a library has one
        os.replace(tmp_lib, out)
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


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of `t`'s device, without
    the `torch.cuda.Stream` object that `torch.cuda.current_stream` builds
    on every call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Refuse inputs that autograd tracks while grad mode is on: a kernel's
    output is a fresh tensor with no `grad_fn`, so a direct call would cut
    the gradient of everything behind it.  The models call the kernels
    through `core.torch_frontend.kernel_call`, whose autograd route calls
    the wrapper with grad mode off (`kernels/autograd.py`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input requires grad and the kernel has "
                         f"no backward of its own; call it through "
                         f"kernel_call, which gives it the plain version's "
                         f"gradient")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
