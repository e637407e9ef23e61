"""The arithmetic of the chunkwise mLSTM kernel's two passes
(`src/repro_torch/csrc/mlstm_scan.cu`) on the CPU.

The CUDA kernels run only on the card, so their arithmetic is emulated here
in numpy, in the kernels' order:
* pass 1, the states: per (b, h) the chunks in order, F = cumsum(log_f),
  the running max of log_i - F, m_new, the carry decay and the weights
  w_t; C = C * carry + (k w)^T v and n likewise, the state before each
  chunk kept; with bf16 inputs k w is formed in f32 and split into
  hi = bf16(k w) and lo = bf16(k w - hi), each multiplied by v (the
  tensor-core body), and n sums hi + lo; with f32 inputs all f32 (the
  CUDA-core body);
* pass 2, the outputs, every chunk from the state before it: S = q k^T in
  f32, gated and causal; its row sums and q . n in f32; with bf16 inputs C
  and the gated S each split into hi = bf16(x) and lo = bf16(x - hi) and
  multiplied twice (the tensor-core body), with f32 inputs no split (the
  CUDA-core body); out = (d_u q C + S v) / max(|d_u q . n + sum S|, e^-m_u)
  rounded once to the input type.
It is held against the JAX package's Pallas kernel
`repro.kernels.mlstm_scan.mlstm_chunkwise` in interpret mode and against
its oracle `repro.kernels.ref.mlstm_ref`, element by element:
* bf16 inputs: one bf16 step, 1e-4 + 2^-7 |ref| (`chip_smoke.py`
  `compare`, `tests/test_torch_gpu.py`): both sides round an f32 result to
  bf16 once, so they may differ by one step, and 1e-4 covers values near 0;
* f32 inputs: 1e-4 + 1e-4 |ref|, the tolerance of
  `tests/test_kernels.py::TestMlstmKernel` (the chunkwise form against the
  step-by-step one, sums in other orders).
The same emulation with C, S or k w rounded to bf16 once, as one bf16
operand of a product, breaks the bf16 bar: that is why the kernel splits
all three.

This checks the design, not the kernel: no code of the port runs here, and
the CUDA source can drift from this copy of its arithmetic without a
failure.  Any change to the arithmetic of `mlstm_scan.cu` (the update, the
gating, how C and S are split) must be made here too; the kernel itself is
held to the same bars on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py` phase 12).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.mlstm_scan import mlstm_chunkwise
from repro.kernels.ref import mlstm_ref

BF16_TOL = (1e-4, 2.0 ** -7)  # (atol, rtol)
F32_TOL = (1e-4, 1e-4)
# (B, S, H, hd, chunk): the reference grid, hd 48 with a chunk of 40 (no
# multiple of 16: the mma tiles' masked edges), a chunk of 1, and
# xlstm-125m's head dim and chunk
SHAPES = [(2, 64, 2, 32, 16), (2, 128, 1, 64, 32), (1, 200, 3, 48, 40),
          (2, 8, 2, 32, 1), (1, 256, 1, 192, 128)]


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to the nearest bf16 (ties to even), returned as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & \
        np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _gates(li, lf, m_prev):
    """F, m_u of one chunk (f32)."""
    f = np.cumsum(lf, dtype=np.float32)
    m_u = np.maximum(np.float32(m_prev),
                     np.maximum.accumulate(li - f)) + f
    return f, m_u.astype(np.float32)


def states(k, v, li, lf, chunk, *, split_kw, round_kw=False):
    """Pass 1 for one (b, h): k, v (S, hd), gates (S,); the (C, n, m)
    before each chunk."""
    s, hd = k.shape
    c = np.zeros((hd, hd), np.float32)
    n = np.zeros(hd, np.float32)
    m = np.float32(-1e30)
    out = []
    for s0 in range(0, s, chunk):
        out.append((c.copy(), n.copy(), m))
        sl = slice(s0, s0 + chunk)
        f, m_u = _gates(li[sl], lf[sl], m)
        f_tot, m_new = f[-1], m_u[-1]
        carry = np.exp(f_tot + m - m_new, dtype=np.float32)
        w = np.exp(li[sl] + (f_tot - f) - m_new, dtype=np.float32)
        kw = (k[sl] * w[:, None]).astype(np.float32)
        if split_kw:
            kw_hi = bf16(kw)
            kw_lo = bf16(kw - kw_hi)
            c = (c * carry + kw_hi.T @ v[sl] + kw_lo.T @ v[sl]).astype(
                np.float32)
            kw = kw_hi + kw_lo
        else:
            if round_kw:
                kw = bf16(kw)
            c = (c * carry + kw.T @ v[sl]).astype(np.float32)
        n = (n * carry + kw.sum(axis=0)).astype(np.float32)
        m = m_new
    return out


def outputs(q, k, v, li, lf, chunk, state_list, *, split_c, split_s,
            round_c=False, round_s=False):
    """Pass 2 for one (b, h); returns f32 outputs before the final
    rounding."""
    s, hd = q.shape
    y = np.empty((s, hd), np.float32)
    for ci, s0 in enumerate(range(0, s, chunk)):
        c, n, m_prev = state_list[ci]
        sl = slice(s0, s0 + chunk)
        qc, kc, vc = q[sl], k[sl], v[sl]
        f, m_u = _gates(li[sl], lf[sl], m_prev)
        u = np.arange(qc.shape[0])
        scores = (qc @ kc.T).astype(np.float32)
        gate = np.exp(f[:, None] - f[None, :] + li[sl][None, :] -
                      m_u[:, None], dtype=np.float32)
        sg = np.where(u[None, :] <= u[:, None], scores * gate,
                      np.float32(0)).astype(np.float32)
        d_u = np.exp(f + m_prev - m_u, dtype=np.float32)
        if split_c:
            c_hi = bf16(c)
            qcm = qc @ c_hi + qc @ bf16(c - c_hi)
        else:
            qcm = qc @ (bf16(c) if round_c else c)
        if split_s:
            s_hi = bf16(sg)
            sv = s_hi @ vc + bf16(sg - s_hi) @ vc
        else:
            sv = (bf16(sg) if round_s else sg) @ vc
        den = np.maximum(np.abs((qc @ n) * d_u + sg.sum(axis=1)),
                         np.exp(-m_u, dtype=np.float32))
        y[sl] = ((qcm * d_u[:, None] + sv) / den[:, None]).astype(np.float32)
    return y


def emulate(q, k, v, li, lf, chunk, *, bf16_inputs, round_kw=False,
            **variant):
    """Both passes over every (b, h) of q/k/v (B,S,H,hd), gates (B,S,H)."""
    split = dict(split_c=bf16_inputs, split_s=bf16_inputs)
    split.update(variant)
    out = np.empty_like(q)
    for bi in range(q.shape[0]):
        for hi in range(q.shape[2]):
            args = [t[bi, :, hi] for t in (q, k, v, li, lf)]
            st = states(*args[1:], chunk,
                        split_kw=bf16_inputs and not round_kw,
                        round_kw=round_kw)
            out[bi, :, hi] = outputs(*args, chunk, st, **split)
    return bf16(out) if bf16_inputs else out


def _case(shape, dtype):
    """Inputs from seed 3 with numpy, the reference kernel test's
    distribution (normal q, k / sqrt(hd), v and log_i; log_f =
    log_sigmoid(normal + 2)), q/k/v rounded to `dtype`, and the JAX
    package's two answers on them."""
    b, s, h, hd, chunk = shape
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    k = (k / np.sqrt(hd)).astype(np.float32)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = (-np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 2.0))
          ).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    jli, jlf = jnp.asarray(li), jnp.asarray(lf)
    pallas = np.asarray(mlstm_chunkwise(jq, jk, jv, jli, jlf, chunk=chunk,
                                        interpret=True), np.float32)
    ref = np.asarray(mlstm_ref(jq, jk, jv, jli, jlf), np.float32)
    return (q, k, v, li, lf), chunk, pallas, ref


def _excess(out, ref, tol):
    atol, rtol = tol
    return np.abs(out - ref) - rtol * np.abs(ref) - atol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_two_passes_meet_the_bars(shape, dtype):
    args, chunk, pallas, ref = _case(shape, dtype)
    out = emulate(*args, chunk, bf16_inputs=dtype == "bfloat16")
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for name, want in (("pallas", pallas), ("mlstm_ref", ref)):
        excess = _excess(out, want, tol)
        assert excess.max() <= 0, (
            f"{name}: {int((excess > 0).sum())} of {excess.size} outputs "
            f"beyond {tol[0]:g} + {tol[1]:g} |ref|")


@pytest.mark.parametrize("rounded", ["c", "s", "kw"])
def test_c_or_s_rounded_once_breaks_one_bf16_step(rounded):
    """C, the gated S or k w as one bf16 operand, as a single bf16 product
    would take it: outputs of xlstm-125m's head dim and chunk fall beyond
    the bar that the split meets (91, 3883 and 62 of 49152)."""
    args, chunk, _, ref = _case(SHAPES[-1], "bfloat16")
    variant = {"c": {"split_c": False, "round_c": True},
               "s": {"split_s": False, "round_s": True},
               "kw": {"round_kw": True}}[rounded]
    out = emulate(*args, chunk, bf16_inputs=True, **variant)
    broken = int((_excess(out, ref, BF16_TOL) > 0).sum())
    assert broken > 0, f"{broken} of {ref.size}"
