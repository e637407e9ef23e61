"""The arithmetic of flash attention's bf16 tensor-core body
(`src/repro_torch/csrc/flash_attention_tc.cu`) on the CPU.

The CUDA body runs only on the card, so its arithmetic is emulated here in
numpy, in the body's order: key tiles of 64 in turn; f32 scores of the
bf16 inputs, scaled into log2 units; the -1e30 mask; an online softmax
whose row maximum is known before any exp2 (a row with no key yet takes
p = 0); P split into `hi = bf16(p)` and `lo = bf16(p - hi)` with
`acc += hi V + lo V` in f32; `l` summed from the f32 p; the output
`acc / max(l, 1e-30)` rounded once to bf16.  It is held against the JAX
package's oracle `repro.kernels.ref.flash_attention_ref` element by element
at the port's bf16 bar, one bf16 step: 1e-4 + 2^-7 |ref| (`chip_smoke.py`
`compare`, `tests/test_torch_gpu.py`).  The same emulation with P rounded
to bf16 once, as the TPU kernel does (`p.astype(v.dtype)`,
`src/repro/kernels/flash_attention.py:86`), breaks that bar: that is why
the body splits P.

This checks the design, not the kernel: no code of the port runs here, and
the CUDA source can drift from this copy of its arithmetic without a
failure.  Any change to the arithmetic of `flash_attention_tc.cu` (tile
order, masking, how P is split) must be made here too; the kernel itself
is held to the same bar on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py` phase 3).

The block pairs the body takes are checked beside the wrapper's other
checks, in `tests/test_torch_frontend.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.ref import flash_attention_ref

NEG_INF = np.float32(-1e30)
ATOL, RTOL = 1e-4, 2.0 ** -7
BLOCK_K = 64  # the main path's key tile


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to the nearest bf16 (ties to even), returned as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & \
        np.uint32(0xFFFF0000)
    return u.view(np.float32)


def emulate(q, k, v, *, split=True, causal=True, window=None):
    """The body's arithmetic on bf16-valued f32 arrays q (B,S,H,hd), k/v
    (B,S,Kv,hd); returns the bf16-valued output."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    scale2 = np.float32(np.log2(np.e) / np.sqrt(hd))
    qpos = np.arange(s)[:, None]
    out = np.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh = q[bi, :, hi], k[bi, :, hi // groups], \
                v[bi, :, hi // groups]
            m = np.full((s, 1), NEG_INF, np.float32)
            l = np.zeros((s, 1), np.float32)
            acc = np.zeros((s, hd), np.float32)
            for t0 in range(0, s, BLOCK_K):
                kt, vt = kh[t0:t0 + BLOCK_K], vh[t0:t0 + BLOCK_K]
                sc = (qh @ kt.T).astype(np.float32) * scale2
                kpos = np.arange(t0, t0 + kt.shape[0])[None, :]
                ok = np.ones_like(sc, bool)
                if causal:
                    ok &= kpos <= qpos
                if window is not None:
                    ok &= kpos > qpos - window
                sc = np.where(ok, sc, NEG_INF)
                m_new = np.maximum(m, sc.max(axis=1, keepdims=True))
                base = np.where(m_new == NEG_INF, np.float32(0), m_new)
                corr = np.exp2(m - base)
                p = np.exp2(sc - base).astype(np.float32)
                l = l * corr + p.sum(axis=1, keepdims=True)
                if split:
                    p_hi = bf16(p)
                    pv = p_hi @ vt + bf16(p - p_hi) @ vt
                else:
                    pv = bf16(p) @ vt
                acc = acc * corr + pv.astype(np.float32)
                m = m_new
            out[bi, :, hi] = bf16(acc / np.maximum(l, np.float32(1e-30)))
    return out


def _case(hd, s=256, causal=True, window=None, b=2, h=4, kv=2):
    """bf16 inputs made from seed 1 with numpy, and the JAX oracle's bf16
    output on them."""
    rng = np.random.default_rng(1)
    q, k, v = (bf16((0.5 * rng.standard_normal((b, s, n, hd))).astype(
        np.float32)) for n in (h, kv, kv))
    ref = np.asarray(flash_attention_ref(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
        causal=causal, window=window), np.float32)
    return q, k, v, ref


def _excess(out, ref):
    return np.abs(out - ref) - RTOL * np.abs(ref) - ATOL


@pytest.mark.parametrize("hd", [64, 128])
def test_split_p_meets_one_bf16_step(hd):
    q, k, v, ref = _case(hd)
    excess = _excess(emulate(q, k, v), ref)
    assert excess.max() <= 0, (
        f"{int((excess > 0).sum())} of {excess.size} outputs beyond "
        f"{ATOL:g} + {RTOL:g} |ref|")


@pytest.mark.parametrize("window,causal", [(50, True), (100, False)])
def test_split_p_meets_one_bf16_step_in_a_band(window, causal):
    q, k, v, ref = _case(64, s=300, causal=causal, window=window)
    excess = _excess(emulate(q, k, v, causal=causal, window=window), ref)
    assert excess.max() <= 0


def test_p_rounded_once_breaks_one_bf16_step():
    """The TPU kernel's `p.astype(v.dtype)`: about 2% of the outputs of
    B2 S256 H4/2 hd64 fall beyond the bar that the split meets."""
    q, k, v, ref = _case(64)
    broken = int((_excess(emulate(q, k, v, split=False), ref) > 0).sum())
    assert broken > 0.01 * ref.size, f"{broken} of {ref.size}"

