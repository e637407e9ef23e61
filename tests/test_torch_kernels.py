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
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trms
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


def _close(port, expect, tol, err_msg=""):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol, err_msg=err_msg)


def _numeric_state() -> str:
    """The process-wide settings an earlier test in the same worker could
    have left behind that move an f32 result: torch's float32 matmul
    precision (on a CPU with AMX, "medium" runs f32 products in bf16 and
    moves this file's attention by ~3e-3), its default dtype and threads,
    both packages' model flags and current meshes, JAX's devices."""
    import jax
    from repro.models import flags as j_flags
    from repro.parallel import context as j_context
    from repro_torch.models import flags as t_flags
    from repro_torch.parallel import context as t_context
    return (f"worker state: torch matmul precision "
            f"{torch.get_float32_matmul_precision()!r}, default dtype "
            f"{torch.get_default_dtype()}, threads {torch.get_num_threads()}"
            f"; flags {j_flags.get_flags()} / {t_flags.get_flags()}; meshes "
            f"{j_context.get_current_mesh()} / "
            f"{t_context.get_current_mesh()}; jax devices "
            f"{len(jax.devices())}")


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
        state = _numeric_state()
        out = t_chunked(tq, tk, tv, chunk=32, window=window)
        _close(out, j_chunked(jq, jk, jv, chunk=32, window=window), 2e-5,
               state)
        _close(out, tops.flash_attention_plain(tq, tk, tv, window=window),
               2e-5, state)


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
        CUDA wrappers refused for width before: a lane holds 32 chunks of
        such a row but not scale's, so the pipelined ring keeps scale in
        shared memory beside two stages of 7 (3840) or 6 (4096) rows
        instead of 8; in bf16 a lane holds both and a stage 8 rows.
        Checked on fake CUDA tensors: no card is needed."""
        with FakeTensorMode():
            x = torch.empty((4096, d), device="cuda")
            scale = torch.empty((d,), device="cuda")
            check_rmsnorm_pipelined(x, scale)
            check_rmsnorm_baseline(x, scale)
        assert ring_rows(d, 4) == {3840: 7, 4096: 6}[d]
        assert ring_rows(d, 2) == 8
        assert trms.lane_chunks(d, 4) == 32 > trms.HOLD_CHUNKS
        assert trms.lane_chunks(d, 2) == 16 == trms.HOLD_CHUNKS
        assert trms.staged_scale(d, 4) and not trms.staged_scale(d, 2)

    # (dtype, D): where the pipelined kernel keeps scale for rows a lane
    # does not hold scale's chunks of, and the rows a ring stage then takes
    @pytest.mark.parametrize("dtype,d,staged,rows", [
        ("bfloat16", 4096, False, 8),     # held in registers
        ("bfloat16", 8192, True, 6),      # 32 chunks a lane, scale staged
        ("bfloat16", 16384, True, 3),     # read twice, scale staged
        ("float32", 8192, True, 3),
        ("float32", 19368, True, 1),      # the widest row staged
        ("float32", 19376, False, 1),     # read as the row is scaled
        ("float32", 29056, False, 1),     # the widest row two of fit
    ])
    def test_pipelined_stages_scale_where_it_fits(self, dtype, d, staged,
                                                  rows):
        itemsize = getattr(torch, dtype).itemsize
        assert trms.staged_scale(d, itemsize) is staged
        assert ring_rows(d, itemsize) == rows

    # (dtype, R, D, x's storage offset in values): the instantiation each
    # wrapper takes, the rows a ring stage holds, and whether the
    # pipelined kernel refuses the input
    @pytest.mark.parametrize("dtype,r,d,offset,chunks,vec,rows,refused", [
        ("bfloat16", 4096, 896, 0, 4, True, 8, None),    # qwen2-0.5b
        ("bfloat16", 8, 896, 0, 4, True, 2, None),       # its decode tick
        ("bfloat16", 4096, 1600, 0, 7, True, 8, None),   # hymba-1.5b
        ("bfloat16", 8, 768, 0, 3, True, 2, None),       # xlstm-125m
        ("float32", 4096, 1600, 0, 13, True, 8, None),
        ("float32", 13, 4096, 0, 32, True, 4, None),
        ("float32", 8, 8192, 0, 0, True, 2, None),       # read twice
        ("float32", 8, 29056, 0, 0, True, 1, None),      # the widest ring
        ("float32", 8, 45, 0, 1, False, 0, "16-byte multiples"),
        ("bfloat16", 13, 1001, 0, 4, False, 0, "16-byte multiples"),
        ("bfloat16", 8, 896, 1, 4, False, 0, "16-byte alignment"),
        ("float32", 8, 1000, 2, 8, False, 0, "16-byte alignment"),
        ("float32", 8, 1000, 4, 8, True, 2, None),       # 16 bytes in
    ])
    def test_wrappers_choose_the_instantiation(self, dtype, r, d, offset,
                                               chunks, vec, rows, refused):
        """What each wrapper launches for an input, from its shape and
        where it starts: the 16-byte or the value-by-value baseline, the
        chunks a lane holds (0: read twice), and the pipelined ring's rows
        a stage (a short call spread over SPREAD blocks); or the pipelined
        check's refusal.  On fake CUDA tensors: no card is needed."""
        tdtype = getattr(torch, dtype)
        itemsize = tdtype.itemsize
        with FakeTensorMode():
            flat = torch.empty((r * d + offset,), device="cuda", dtype=tdtype)
            x = flat.as_strided((r, d), (d, 1), offset)
            scale = torch.empty((d,), device="cuda", dtype=tdtype)
            assert x.is_contiguous() and x.storage_offset() == offset
            check_rmsnorm_baseline(x, scale)
            if refused:
                with pytest.raises(ValueError, match=refused):
                    check_rmsnorm_pipelined(x, scale)
            else:
                check_rmsnorm_pipelined(x, scale)
        assert trms.lane_chunks(d, itemsize) == chunks
        assert trms.vectors(d * itemsize, offset * itemsize, 0) is vec
        if not refused:
            assert trms.stage_rows(r, d, itemsize) == rows

    def test_plan_constants_match_the_cuda_source(self):
        """The wrapper's plan names the instantiations and block sizes that
        csrc/rmsnorm.cu builds: the cases of `by_chunks` (0 aside), the
        most chunks a lane holds, the chunks a lane holds beside scale's,
        the rows a stage and a baseline block."""
        src = (Path(trms.__file__).parent.parent / "csrc" /
               "rmsnorm.cu").read_text()
        cases = [int(n) for n in re.findall(
            r"case (\d+): return Op<T, \1>::run\(a\);", src)]
        assert cases == [0, *trms.LANE_CHUNKS]

        def const(pattern):
            return int(re.search(pattern, src).group(1))
        assert const(r"constexpr int kMaxChunks = (\d+);") == \
            trms.LANE_CHUNKS[-1]
        assert const(r"kHoldScale = CHUNKS > 0 && CHUNKS <= (\d+);") == \
            trms.HOLD_CHUNKS
        assert const(r"constexpr int kMaxRows = (\d+);") == \
            trms.ROWS_PER_STAGE
        assert const(r"constexpr int kBaseRows = (\d+);") == trms.BASE_ROWS

    def test_ring_grid_is_capped_by_residency(self):
        """One block a row block, up to the blocks the card holds at once;
        past that each block walks further row blocks through its ring."""
        assert trms.ring_grid(4096, 8, 3 * 132) == 396
        assert trms.ring_grid(4096, 8, 6 * 132) == 512
        assert trms.ring_grid(8, 2, 3 * 132) == 4
        assert trms.ring_grid(4097, 8, 10_000) == 513

    def test_pipelined_check_refuses_a_row_two_of_which_do_not_fit(self):
        """f32 D 29184: two rows are 233,472 bytes, above the 232,448 a
        block may use, so not even a ring of one row a stage fits."""
        with FakeTensorMode():
            x = torch.empty((8, 29184), device="cuda")
            scale = torch.empty((29184,), device="cuda")
            with pytest.raises(ValueError, match="too wide"):
                check_rmsnorm_pipelined(x, scale)
            check_rmsnorm_baseline(x, scale)
