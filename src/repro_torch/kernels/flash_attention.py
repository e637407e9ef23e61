"""Flash attention: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
flash_attention` (body `_flash_kernel`).  The kernel has two bodies, taken
by dtype:

  bfloat16 -> `csrc/flash_attention_tc.cu`, on the tensor cores: one block
              per (batch, q-head, q-tile), a warp per 16 query rows with
              `mma.sync` m16n8k16 in f32 accumulators, K/V tiles through a
              two-stage `cp.async` ring, and P split into two bf16 parts
              (`hi = bf16(p)`, `lo = bf16(p - hi)`) so the output stays one
              bf16 step from the f32 plain version.  It takes block_k in
              `TC_BLOCK_K` and block_q in `TC_BLOCK_Q`, nothing else.
  float32  -> `csrc/flash_attention.cu`, on the CUDA cores: one thread per
              query row, any block_q up to 1024 and any block_k whose K and
              V tiles fit shared memory.  TF32 would break its f32 bar.

Both compute the causal / sliding-window band from positions, so
`block_q != block_k` and an S that is no multiple of the block are right.

Bound on the H100: operations, `4*B*H*hd*pairs` (QK^T and PV over the
(query, key) pairs inside the band) over the card's peak for the dtype,
989 TFLOP/s bf16 or 67 TFLOP/s f32 (the scores never reach device memory;
the bytes, q, k, v and out once each, are far smaller).  `chip_smoke.py`
reports that bound beside each body's time; both are in PERF.md.

`flash_attention` takes a CPU tensor to `flash_attention_plain` and a CUDA
tensor to the body of its dtype; on anything else, or on a CUDA input that
body does not take, it raises.  It never falls back from one body to the
other.  Both bodies are built for head dims 16, 32, 64 and 128;
h2o-danube-3-4b's 120 runs as 128: the wrapper zero-pads q, k and v (zero
columns change no score, and the padded output columns are dropped) and
passes the scale 1/sqrt(120).  `check_flash_attention` (also the wrapper's
`check`) raises what the wrapper raises for a CUDA input, and launches
nothing.  `flash_attention.launches` counts launches of either body,
`flash_attention.body_launches` each body's (`ops.reset_launch_counts`
zeroes both).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (16, 32, 64, 128)
# head dims the kernel runs zero-padded to an instantiated one
PADDED_HEAD_DIMS = {120: 128}
# the bf16 body: block_k is a template value, block_q (a warp per 16 rows)
# a run-time one
TC_BLOCK_K = (32, 64, 128)
TC_BLOCK_Q = tuple(range(16, 129, 16))
# the body each dtype takes, and its C entry point
BODIES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
ENTRY_POINTS = {"tensor_core": "repro_flash_attention_tc_fwd",
                "cuda_core": "repro_flash_attention_fwd"}


def smem_bytes(dtype: torch.dtype, hd_run: int, block_k: int) -> int:
    """Shared memory a block of the body for `dtype` uses: bf16, two ring
    stages of a K and a V tile with rows padded by 8 values (the output
    rows are staged in the ring after the loop); f32, one K and one V tile
    converted to f32."""
    if dtype == torch.bfloat16:
        return 4 * block_k * (hd_run + 8) * 2
    return 2 * block_k * hd_run * 4


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Full-matrix attention in f32 (the port of `kernels/ref.py::
    flash_attention_ref`).  q (B,S,H,hd), k/v (B,S,Kv,hd)."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def check_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, block_q: int = 64,
                          block_k: int = 64) -> None:
    _build.check_no_grad("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"all inputs must be on one CUDA device")
        if t.dtype not in BODIES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             f"kernel takes float32 or bfloat16, one dtype")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"(B, S, heads, hd) tensor")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {h} q-heads not a multiple of "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS and hd not in PADDED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS} or {tuple(PADDED_HEAD_DIMS)}")
    if q.dtype == torch.bfloat16:
        if block_q not in TC_BLOCK_Q or block_k not in TC_BLOCK_K:
            raise ValueError(
                f"flash_attention: the bf16 body takes block_q in "
                f"{TC_BLOCK_Q} and block_k in {TC_BLOCK_K}, not {block_q} / "
                f"{block_k}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            # 16-byte copies and stores; a padded head dim runs on copies
            if t.storage_offset() % 8 and hd not in PADDED_HEAD_DIMS:
                raise ValueError(f"flash_attention: {name} does not start "
                                 f"on a 16-byte boundary")
    # the kernel stages K and V tiles at the head dim it runs at
    hd_run = PADDED_HEAD_DIMS.get(hd, hd)
    if not 1 <= block_q <= 1024 or block_k < 1 or \
            smem_bytes(q.dtype, hd_run, block_k) > _build.MAX_SMEM:
        raise ValueError(f"flash_attention: block_q {block_q}, block_k "
                         f"{block_k} out of range at head dim {hd_run}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if h > 65535 or b > 65535:
        raise ValueError("flash_attention: B and H must be <= 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,S,Kv,hd) with H % Kv == 0. Returns (B,S,H,hd).

    The kernel has no backward of its own: the models reach it through
    `kernel_call`, which differentiates `chunked_attention` instead, and a
    CUDA input that requires grad under grad mode is refused."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    lib = _build.library()
    check_flash_attention(q, k, v, window=window, block_q=block_q,
                          block_k=block_k)
    b, s, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    hd_run = PADDED_HEAD_DIMS.get(hd, hd)
    if hd_run != hd:
        q, k, v = (F.pad(t, (0, hd_run - hd)) for t in (q, k, v))
    out = torch.empty_like(q)
    body = BODIES[q.dtype]
    err = getattr(lib, ENTRY_POINTS[body])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], hd_run, block_q, block_k, int(causal), window or 0,
        scale, _build.current_stream(q))
    _build.check(err, f"flash_attention ({body} body)")
    flash_attention.launches += 1
    flash_attention.body_launches[body] += 1
    return out if hd_run == hd else out[..., :hd].contiguous()


flash_attention.launches = 0
flash_attention.body_launches = dict.fromkeys(ENTRY_POINTS, 0)
flash_attention.check = check_flash_attention
