"""The port's CUDA kernels against their plain versions on the card.

Every test here carries the `gpu` marker and skips where there is no CUDA
device (decided inside the test, never at import).  The file imports torch
and the port only, so it also runs where JAX is not installed:

  python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances, element by element: f32 2e-5 (flash attention) / 1e-5
(RMSNorm), the same f32 arithmetic in another order; bf16 1e-4 + 2^-7 of the
value, one bf16 step apart after each side rounds its f32 result.  The
selective scan returns f32 whatever its input type and computes in f32, so
every case is held to 1e-4 absolute and relative, the tolerance of
`tests/test_kernels.py::TestSsmKernel` (the recurrence fused into one
multiply-add, the readout summed in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as tt
from repro_torch.models.flags import flags

pytestmark = pytest.mark.gpu

BF16_TOL = (1e-4, 2.0 ** -7)  # (atol, rtol)
TOL = {"float32": (2e-5, 0.0), "bfloat16": BF16_TOL}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _inputs(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((0.5 * rng.standard_normal(s)).astype(
        np.float32)).to(device=device, dtype=getattr(torch, dtype))
        for s in shapes]


def _close(out, expect, tol):
    atol, rtol = tol
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("s,h,kv,hd,window,block_q,block_k", [
    (1024, 14, 2, 64, None, 64, 64),   # qwen2-0.5b prefill
    (256, 4, 2, 32, 64, 32, 32),       # sliding window
    (256, 8, 1, 16, None, 64, 32),     # block_q != block_k
    (256, 4, 4, 128, 100, 32, 64),     # window not a block multiple
    (200, 4, 2, 64, None, 64, 64),     # ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention(s, h, kv, hd, window, block_q, block_k, dtype):
    dev = _cuda()
    q, k, v = _inputs(5, [(2, s, h, hd), (2, s, kv, hd), (2, s, kv, hd)],
                      dtype, dev)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=window, block_q=block_q,
                              block_k=block_k)
    assert ops.flash_attention.launches == before + 1
    _close(out, ops.flash_attention_plain(q, k, v, window=window),
           TOL[dtype])


@pytest.mark.parametrize("d", [896, 1600])  # qwen2-0.5b, hymba-1.5b
@pytest.mark.parametrize("r", [8, 13, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(r, d, dtype):
    dev = _cuda()
    x, scale = _inputs(6, [(r, d), (d,)], dtype, dev)
    scale = 1.0 + 0.1 * scale
    before = ops.rmsnorm_pipelined.launches
    out = ops.rmsnorm_pipelined(x, scale)
    assert ops.rmsnorm_pipelined.launches == before + 1
    _close(out, ops.rmsnorm_plain(x, scale),
           BF16_TOL if dtype == "bfloat16" else (1e-5, 0.0))


def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    half = torch.ones((8, 896), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.rmsnorm_pipelined(half, half[0])
    with pytest.raises(ValueError):  # rows of 90 bytes: no 16-byte copies
        ops.rmsnorm_pipelined(torch.ones((8, 45), device=dev),
                              torch.ones(45, device=dev))
    q = torch.ones((1, 64, 4, 96), device=dev)
    with pytest.raises(ValueError):  # head_dim 96 is not instantiated
        ops.flash_attention(q, q, q)
    q = torch.ones((1, 64, 4, 64), device=dev)
    with pytest.raises(ValueError):  # not contiguous
        ops.flash_attention(q.transpose(1, 2), q, q)


def test_prefill_kernel_path_matches_plain_path():
    dev = _cuda()
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    ops.reset_launch_counts()
    logits, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts() == {"flash_attention": cfg.n_layers,
                                   "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
                                   "ssm_scan": 0}
    with flags(force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert (logits - plain).abs().max() <= 2e-2 * plain.abs().max()


def _scan_inputs(b, s, din, n, dtype, device):
    gen = torch.Generator(device=device).manual_seed(7)
    a = torch.sigmoid(torch.randn((b, s, din, n), generator=gen,
                                  device=device) + 1.0)
    bx = torch.randn((b, s, din, n), generator=gen, device=device)
    c = torch.randn((b, s, n), generator=gen, device=device)
    dt = getattr(torch, dtype)
    return a.to(dt), bx.to(dt), c.to(dt)


@pytest.mark.parametrize("s,din,n", [
    (32, 128, 8),       # the reference grid
    (64, 256, 16),
    (1000, 320, 16),    # ragged S, no multiple of the 8-step prefetch
    (64, 100, 8),       # din no multiple of a block's channels
    (40, 64, 32),
    (40, 64, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan(s, din, n, dtype):
    dev = _cuda()
    a, bx, c = _scan_inputs(2, s, din, n, dtype, dev)
    before = ops.ssm_scan.launches
    out = ops.ssm_scan(a, bx, c, chunk=16)
    assert ops.ssm_scan.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (2, s, din)
    expect = ops.ssm_scan_plain(a, bx, c)
    _close(out, expect, (1e-4, 1e-4))
    # `chunk` is the TPU kernel's time block: it does not change the result
    assert torch.equal(ops.ssm_scan(a, bx, c, chunk=s), out)


def test_ssm_scan_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    a, bx, c = _scan_inputs(2, 16, 64, 16, "float32", dev)
    before = ops.ssm_scan.launches
    with pytest.raises(ValueError):  # N = 12 does not divide 32
        ops.ssm_scan(a[..., :12].contiguous(), bx[..., :12].contiguous(),
                     c[..., :12].contiguous())
    with pytest.raises(ValueError):  # not contiguous
        ops.ssm_scan(a.transpose(1, 2), bx.transpose(1, 2), c)
    with pytest.raises(ValueError):  # one tensor on the CPU
        ops.ssm_scan(a, bx, c.cpu())
    with pytest.raises(ValueError):  # a and bx of two dtypes
        ops.ssm_scan(a, bx.bfloat16(), c)
    with pytest.raises(ValueError):  # c of another dtype than a/bx
        ops.ssm_scan(a.bfloat16(), bx.bfloat16(), c)
    with pytest.raises(ValueError):  # float16 is not instantiated
        ops.ssm_scan(a.half(), bx.half(), c.half())
    assert ops.ssm_scan.launches == before


def test_swa_head_dim_120_raises_on_the_card():
    """h2o-danube's hd 120 is not a head dim K1 is built for: on the card
    its prefill raises rather than taking the plain path."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("h2o-danube-3-4b")),
                              head_dim=120)
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim 120"):
        tt.forward(params, cfg, tokens=tokens)


def test_hymba_prefill_kernel_path_matches_plain_path():
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("hymba-1.5b")),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 160), device=dev)
    ops.reset_launch_counts()
    logits, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts() == {"flash_attention": cfg.n_layers,
                                   "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
                                   "ssm_scan": cfg.n_layers}
    with flags(force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts()["ssm_scan"] == cfg.n_layers
    _close(logits, plain, (1e-4, 1e-4))
