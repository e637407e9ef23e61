"""Parity of the port's kernels with the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version; it is held
against the Pallas kernel in interpret mode (`repro.kernels.ops`) and the jnp
oracle (`repro.kernels.ref`) on the same numpy-made inputs.  Tolerances are
those of `tests/test_kernels.py`: f32 2e-5 / 1e-5 (the same f32 arithmetic in
another summation order), bf16 2e-2 / 3e-2 (bf16 rounding of the output and,
in the Pallas kernel, of the probabilities).

The CUDA kernels themselves are held against their plain versions on the
card by `tests/test_torch_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels.rmsnorm import (check_rmsnorm_baseline,
                                         check_rmsnorm_pipelined, ring_rows)
from repro_torch.models.attention import chunked_attention as t_chunked

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype_name):
    """Same values for both packages: numpy f32, rounded once to dtype."""
    jdt, tdt, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    arrays = [(0.5 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(port, expect, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("s,h,kv,hd", [
        (128, 4, 4, 64),    # MHA
        (256, 4, 2, 32),    # GQA
        (128, 8, 1, 64),    # MQA
        (128, 14, 2, 64),   # qwen2-0.5b head layout
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_and_ref(self, s, h, kv, hd, dtype):
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            0, [(2, s, h, hd), (2, s, kv, hd), (2, s, kv, hd)], dtype)
        before = tops.flash_attention.launches
        out = tops.flash_attention(tq, tk, tv, causal=True)
        assert tops.flash_attention.launches == before  # CPU: plain version
        tol = DTYPES[dtype][2]
        _close(out, jops.flash_attention_op(jq, jk, jv, causal=True,
                                            block_q=64, block_k=64,
                                            interpret=True), tol)
        _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True), tol)

    def test_sliding_window(self):
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            1, [(1, 256, 2, 32)] * 3, "float32")
        out = tops.flash_attention(tq, tk, tv, causal=True, window=64)
        _close(out, jops.flash_attention_op(jq, jk, jv, causal=True,
                                            window=64, block_q=32,
                                            block_k=32, interpret=True), 2e-5)
        _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                             window=64), 2e-5)

    def test_non_causal(self):
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            2, [(1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)], "float32")
        out = tops.flash_attention(tq, tk, tv, causal=False)
        _close(out, jref.flash_attention_ref(jq, jk, jv, causal=False), 2e-5)

    @pytest.mark.parametrize("window", [None, 64])
    def test_chunked_attention_matches_reference(self, window):
        """The models' plain path against the reference's and the kernel."""
        (jq, jk, jv), (tq, tk, tv) = _inputs(
            3, [(2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32)],
            "float32")
        out = t_chunked(tq, tk, tv, chunk=32, window=window)
        _close(out, j_chunked(jq, jk, jv, chunk=32, window=window), 2e-5)
        _close(out, tops.flash_attention_plain(tq, tk, tv, window=window),
               2e-5)


class TestRmsnormPlain:
    @pytest.mark.parametrize("r,d", [(32, 128), (64, 256), (8, 512),
                                     (8, 896)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, r, d, dtype):
        (jx, jscale), (tx, tscale) = _inputs(4, [(r, d), (d,)], "float32")
        jx = jx.astype(DTYPES[dtype][0])
        tx = tx.to(DTYPES[dtype][1])
        jscale, tscale = 1.0 + 0.1 * jscale, 1.0 + 0.1 * tscale
        before = tops.rmsnorm_pipelined.launches
        out = tops.rmsnorm_op(tx, tscale)
        assert tops.rmsnorm_pipelined.launches == before
        assert out.dtype == tx.dtype
        tol = 3e-2 if dtype == "bfloat16" else 1e-5
        _close(out, jops.rmsnorm_op(jx, jscale, block_rows=8,
                                    interpret=True), tol)
        _close(out, jref.rmsnorm_ref(jx, jscale), tol)

    @pytest.mark.parametrize("d", [3840, 4096])
    def test_checks_take_wide_f32_rows(self, d):
        """f32 rows of h2o-danube-3-4b (3840) and glm4-9b (4096), which both
        CUDA wrappers refused for width before: the pipelined ring now takes
        7 rows a stage instead of 8, and the baseline reads the row in two
        passes.  Checked on fake CUDA tensors: no card is needed."""
        with FakeTensorMode():
            x = torch.empty((4096, d), device="cuda")
            scale = torch.empty((d,), device="cuda")
            check_rmsnorm_pipelined(x, scale)
            check_rmsnorm_baseline(x, scale)
        assert ring_rows(d, 4) == 7
        assert ring_rows(d, 2) == 8

    def test_pipelined_check_refuses_a_row_two_of_which_do_not_fit(self):
        """f32 D 29184: two rows are 233,472 bytes, above the 232,448 a
        block may use, so not even a ring of one row a stage fits."""
        with FakeTensorMode():
            x = torch.empty((8, 29184), device="cuda")
            scale = torch.empty((29184,), device="cuda")
            with pytest.raises(ValueError, match="too wide"):
                check_rmsnorm_pipelined(x, scale)
            check_rmsnorm_baseline(x, scale)
