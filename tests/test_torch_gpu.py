"""The port's CUDA kernels against their plain versions on the card.

Every test here carries the `gpu` marker and skips where there is no CUDA
device (decided inside the test, never at import).  The file imports torch
and the port only, so it also runs where JAX is not installed:

  python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances, element by element: f32 2e-5 (flash attention) / 1e-5
(RMSNorm, the sLSTM scan), the same f32 arithmetic in another order; bf16
1e-4 + 2^-7 of the value, one bf16 step apart after each side rounds its
f32 result.  The selective scan returns f32 whatever its input type and
computes in f32, so every case is held to 1e-4 absolute and relative, the
tolerance of `tests/test_kernels.py::TestSsmKernel` (the recurrence fused
into one multiply-add, the readout summed in another order); so is its
fused entry, which discretizes with the same f32 functions.  The chunkwise
mLSTM in f32 is held to 1e-4 absolute and relative, the tolerance of
`tests/test_kernels.py::TestMlstmKernel` (the chunkwise form against the
step-by-step oracle).
"""
import dataclasses
import functools

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
# the flash-attention body each dtype takes
BODY = {"float32": "cuda_core", "bfloat16": "tensor_core"}


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
    bodies = dict(ops.flash_attention.body_launches)
    out = ops.flash_attention(q, k, v, window=window, block_q=block_q,
                              block_k=block_k)
    assert ops.flash_attention.launches == before + 1
    body = BODY[dtype]
    assert ops.flash_attention.body_launches == {
        **bodies, body: bodies[body] + 1}
    _close(out, ops.flash_attention_plain(q, k, v, window=window),
           TOL[dtype])


# the bf16 body's edges (phase 3 of chip_smoke.py at small sizes): head
# dims, no causal band, S below one tile and off the tiles, windows of 1
# and of no tile multiple, and the ends of block_q's range
@pytest.mark.parametrize("s,hd,window,causal,block_q,block_k", [
    (256, 16, None, True, 64, 64),
    (256, 32, None, True, 64, 64),
    (256, 128, None, True, 64, 64),
    (256, 64, None, False, 64, 64),
    (17, 64, 50, True, 64, 64),
    (300, 64, 50, True, 64, 64),
    (300, 64, 50, False, 64, 64),
    (256, 64, 1, True, 64, 64),
    (256, 64, 100, True, 64, 64),
    (200, 64, None, True, 16, 128),
    (200, 128, 70, True, 128, 32),
])
def test_flash_attention_bf16_edges(s, hd, window, causal, block_q,
                                    block_k):
    dev = _cuda()
    q, k, v = _inputs(8, [(2, s, 4, hd), (2, s, 2, hd), (2, s, 2, hd)],
                      "bfloat16", dev)
    tc = ops.flash_attention.body_launches["tensor_core"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
    assert ops.flash_attention.body_launches["tensor_core"] == tc + 1
    _close(out, ops.flash_attention_plain(q, k, v, causal=causal,
                                          window=window), BF16_TOL)


# qwen2-0.5b, hymba-1.5b, h2o-danube-3-4b, glm4-9b: in f32 the last two
# keep scale in shared memory beside a ring of 7 or 6 rows a stage; f32
# D 8192 (64 chunks a lane) is read twice from shared memory; f32 D 19368
# is the widest row with scale in shared memory, 29056 the widest two of
# which fit a block's shared memory (scale read as the row is scaled)
@pytest.mark.parametrize("d", [896, 1600, 3840, 4096, 8192, 19368, 29056])
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


# rows of 16-byte multiples take the 16-byte instantiations (f32 3840 and
# 4096 hold 32 chunks a lane, f32 8192 is read twice); D 45 (90 or 180
# bytes) and 1001 the kernel that moves one value at a time
@pytest.mark.parametrize("d", [45, 512, 896, 1000, 1001, 1600, 3840, 4096,
                               8192])
@pytest.mark.parametrize("r", [8, 13, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_baseline(r, d, dtype):
    dev = _cuda()
    x, scale = _inputs(6, [(r, d), (d,)], dtype, dev)
    scale = 1.0 + 0.1 * scale
    before = ops.rmsnorm_baseline.launches
    out = ops.rmsnorm_baseline(x, scale)
    assert ops.rmsnorm_baseline.launches == before + 1
    _close(out, ops.rmsnorm_plain(x, scale),
           BF16_TOL if dtype == "bfloat16" else (1e-5, 0.0))


# the phase-3 shapes of chip_smoke.py, and a wide bf16 row
@pytest.mark.parametrize("dtype,r,d", [
    (dt, r, d) for d in (896, 1600) for r in (8, 4096)
    for dt in ("float32", "bfloat16")] + [
    ("float32", r, d) for d in (3840, 4096) for r in (8, 4096)] + [
    (dt, 13, 8192) for dt in ("float32", "bfloat16")] + [
    ("bfloat16", 13, 16384), ("float32", 13, 29056)])
def test_rmsnorm_kernels_return_the_same_bits(dtype, r, d):
    """One per-lane order of the sum of squares and one shuffle tree in
    both kernels: K2 and K3 agree bit for bit on every input both take."""
    dev = _cuda()
    x, scale = _inputs(7, [(r, d), (d,)], dtype, dev)
    scale = 1.0 + 0.1 * scale
    assert torch.equal(ops.rmsnorm_pipelined(x, scale),
                       ops.rmsnorm_baseline(x, scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [896, 1600])
def test_rmsnorm_off_a_16_byte_boundary(d, dtype):
    """x contiguous but starting one value past a 16-byte boundary: the
    baseline takes it value by value, to the same bits as on an aligned
    copy; the pipelined kernel (cp.async) refuses it."""
    dev = _cuda()
    flat, scale = _inputs(8, [(8 * d + 1,), (d,)], dtype, dev)
    scale = 1.0 + 0.1 * scale
    x = flat[1:].view(8, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = ops.rmsnorm_baseline.launches
    out = ops.rmsnorm_baseline(x, scale)
    assert ops.rmsnorm_baseline.launches == before + 1
    assert torch.equal(out, ops.rmsnorm_baseline(x.clone(), scale))
    _close(out, ops.rmsnorm_plain(x, scale),
           BF16_TOL if dtype == "bfloat16" else (1e-5, 0.0))
    before = ops.rmsnorm_pipelined.launches
    with pytest.raises(ValueError, match="16-byte"):
        ops.rmsnorm_pipelined(x, scale)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rmsnorm_pipelined(x.clone(), flat[1:d + 1])
    assert ops.rmsnorm_pipelined.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    half = torch.ones((8, 896), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.rmsnorm_pipelined(half, half[0])
    with pytest.raises(ValueError):  # rows of 90 bytes: no 16-byte copies
        ops.rmsnorm_pipelined(torch.ones((8, 45), device=dev),
                              torch.ones(45, device=dev))
    with pytest.raises(ValueError):  # two f32 rows above 227 KB: no ring
        ops.rmsnorm_pipelined(torch.ones((8, 29184), device=dev),
                              torch.ones(29184, device=dev))
    with pytest.raises(ValueError):  # scale of another width
        ops.rmsnorm_baseline(torch.ones((8, 2056), device=dev),
                             torch.ones(2048, device=dev))
    q = torch.ones((1, 64, 4, 96), device=dev)
    with pytest.raises(ValueError):  # head_dim 96 is not instantiated
        ops.flash_attention(q, q, q)
    q = torch.ones((1, 64, 4, 64), device=dev)
    with pytest.raises(ValueError):  # not contiguous
        ops.flash_attention(q.transpose(1, 2), q, q)
    q = torch.ones((1, 64, 4, 120), device=dev)
    # block_k 230 fits shared memory at hd 120 but not at the 128 it runs at
    with pytest.raises(ValueError, match="head dim 128"):
        ops.flash_attention(q, q, q, block_k=230)
    before = ops.flash_attention.launches
    q = torch.ones((1, 64, 4, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 body"):  # no block_k 48
        ops.flash_attention(q, q, q, block_k=48)
    with pytest.raises(ValueError, match="16-byte"):  # starts 8 bytes in
        off = torch.ones(1 * 64 * 4 * 64 + 4, device=dev,
                         dtype=torch.bfloat16)[4:].view(1, 64, 4, 64)
        ops.flash_attention(off, q, q)
    assert ops.flash_attention.launches == before
    q = torch.ones((2, 96, 2, 32), device=dev)
    g = torch.zeros((2, 96, 2), device=dev)
    before = ops.mlstm_chunkwise.launches
    with pytest.raises(ValueError):  # chunk 64 does not divide S 96
        ops.mlstm_chunkwise(q, q, q, g, g)
    long_q = torch.ones((1, 256, 1, 32), device=dev)
    long_g = torch.zeros((1, 256, 1), device=dev)
    with pytest.raises(ValueError):  # a chunk above the kernel's 128
        ops.mlstm_chunkwise(long_q, long_q, long_q, long_g, long_g,
                            chunk=256)
    with pytest.raises(ValueError):  # gates in bf16
        ops.mlstm_chunkwise(q, q, q, g.bfloat16(), g.bfloat16(), chunk=32)
    with pytest.raises(ValueError):  # v of another dtype
        ops.mlstm_chunkwise(q, q, q.bfloat16(), g, g, chunk=32)
    with pytest.raises(ValueError):  # not contiguous
        ops.mlstm_chunkwise(q.transpose(1, 2), q, q, g, g, chunk=32)
    assert ops.mlstm_chunkwise.launches == before
    xg = torch.ones((2, 16, 256), device=dev)
    before = ops.slstm_scan.launches
    with pytest.raises(ValueError):  # r is not (D, 4D)
        ops.slstm_scan(xg, torch.ones((64, 64), device=dev))
    with pytest.raises(ValueError):  # r of another dtype than xg
        ops.slstm_scan(xg, torch.ones((64, 256), device=dev).bfloat16())
    with pytest.raises(ValueError):  # r on the CPU
        ops.slstm_scan(xg, torch.ones((64, 256)))
    with pytest.raises(ValueError):  # not contiguous
        ops.slstm_scan(xg, torch.ones((256, 64), device=dev).t())
    assert ops.slstm_scan.launches == before


def test_prefill_kernel_path_matches_plain_path():
    dev = _cuda()
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    ops.reset_launch_counts()
    logits, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts() == {"flash_attention": cfg.n_layers,
                                   "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
                                   "rmsnorm_baseline": 0, "ssm_scan": 0,
                                   "ssm_scan_fused": 0,
                                   "mlstm_chunkwise": 0, "slstm_scan": 0}
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


def _fused_inputs(b, s, din, n, dtype, device, strided=False, a_log=None):
    """xin (a view of a (B, S, 2 din) tensor when `strided`, as the model
    hands it), w_dt, a_log = log(1..N) unless given, bsel and csel."""
    gen = torch.Generator(device=device).manual_seed(11)
    xz = torch.randn((b, s, 2 * din if strided else din), generator=gen,
                     device=device).to(getattr(torch, dtype))
    w_dt = torch.randn((din,), generator=gen, device=device)
    if a_log is None:
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(din, n)
    a_log = a_log.to(device).contiguous()
    bsel = 0.5 * torch.randn((b, s, n), generator=gen, device=device)
    csel = 0.5 * torch.randn((b, s, n), generator=gen, device=device)
    return xz[..., :din], w_dt, a_log, bsel, csel


# the kernel stages 128 steps a chunk, 16 channels a block
# (csrc/ssm_scan.cu kFusedChunk, kFusedChannels): the cases cross both seams
@pytest.mark.parametrize("s,din,n,strided", [
    (32, 128, 8, False),
    (64, 256, 16, True),
    (1000, 320, 16, True),  # ragged S, no multiple of a chunk
    (64, 100, 8, False),    # din no multiple of a block's channels
    (40, 64, 32, False),
    (40, 64, 1, True),
    (1, 64, 16, True),      # one step
    (127, 64, 16, True),    # a step under a chunk
    (128, 64, 16, False),   # one whole chunk
    (129, 64, 16, True),    # a step over a chunk
    (130, 17, 16, False),   # din one over a channel tile
    (64, 3201, 16, True),   # hymba's din plus one
    (200, 72, 4, True),
    (200, 72, 2, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_fused(s, din, n, strided, dtype):
    """K4's fused entry against the oracle on the terms its plain version
    discretizes, 1e-4 absolute and relative as `test_ssm_scan`; and
    against its plain version, the chunked form."""
    from repro_torch.kernels.ssm_scan import discretize
    dev = _cuda()
    xin, w_dt, a_log, bsel, csel = _fused_inputs(2, s, din, n, dtype, dev,
                                                 strided)
    assert xin.is_contiguous() != strided
    before = ops.ssm_scan_fused.launches
    out = ops.ssm_scan_fused(xin, w_dt, a_log, bsel, csel)
    assert ops.ssm_scan_fused.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (2, s, din)
    a, bx = discretize(xin, w_dt, a_log, bsel)
    _close(out, ops.ssm_scan_plain(a, bx, csel), (1e-4, 1e-4))
    _close(out, ops.ssm_fused_plain(xin, w_dt, a_log, bsel, csel),
           (1e-4, 1e-4))
    # a copy of the view gives the same bits
    assert torch.equal(ops.ssm_scan_fused(xin.contiguous(), w_dt, a_log,
                                          bsel, csel), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_fused_carries_the_state_across_chunks(dtype):
    """S 4096 (32 chunks) with a_log near -4: a = exp(-exp(a_log) dt) is
    near 1, so the state of the first steps still counts at the last, and
    every chunk's state must be carried into the next.  Held to the oracle
    at 1e-4 + 1e-4 |oracle| as `test_ssm_scan_fused`."""
    from repro_torch.kernels.ssm_scan import discretize
    dev = _cuda()
    n, din = 16, 72
    rng = np.random.default_rng(5)
    a_log = torch.from_numpy((-4.0 + 0.1 * rng.standard_normal(
        (din, n))).astype(np.float32))
    xin, w_dt, a_log, bsel, csel = _fused_inputs(2, 4096, din, n, dtype, dev,
                                                 True, a_log)
    out = ops.ssm_scan_fused(xin, w_dt, a_log, bsel, csel)
    a, bx = discretize(xin, w_dt, a_log, bsel)
    assert a.median().item() > 0.95  # the state decays slowly
    _close(out, ops.ssm_scan_plain(a, bx, csel), (1e-4, 1e-4))
    assert torch.equal(ops.ssm_scan_fused(xin.contiguous(), w_dt, a_log,
                                          bsel, csel), out)


def test_ssm_scan_fused_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    xin, w_dt, a_log, bsel, csel = _fused_inputs(2, 16, 64, 16, "float32",
                                                 dev)
    before = ops.ssm_scan_fused.launches
    with pytest.raises(ValueError, match="N=12"):
        ops.ssm_scan_fused(xin, w_dt, a_log[:, :12].contiguous(),
                           bsel[..., :12].contiguous(),
                           csel[..., :12].contiguous())
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssm_scan_fused(xin.transpose(1, 2), w_dt[:16], a_log[:16],
                           bsel, csel)
    with pytest.raises(ValueError, match="on cpu"):
        ops.ssm_scan_fused(xin, w_dt, a_log, bsel, csel.cpu())
    with pytest.raises(ValueError, match="float32"):
        ops.ssm_scan_fused(xin, w_dt, a_log, bsel.bfloat16(), csel)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.ssm_scan_fused(xin.half(), w_dt, a_log, bsel, csel)
    with pytest.raises(ValueError, match="shapes"):
        ops.ssm_scan_fused(xin, w_dt[:32], a_log, bsel, csel)
    assert ops.ssm_scan_fused.launches == before


def test_hybrid_fused_forms_on_the_card():
    """hymba smoke, f32: under ssm_fused + ssm_pallas the fused entry
    launches once a layer and the old entry never, its logits within 1e-4
    of the forced-plain path's (the chunked form) and of the default
    kernel path's; ssm_fused alone runs the chunked form, no K4."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("hymba-1.5b")),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=dev)
    default, _ = tt.forward(params, cfg, tokens=tokens)
    runs = {}
    for name, kw in (("pallas", {"ssm_pallas": True}), ("chunked", {})):
        ops.reset_launch_counts()
        with flags(ssm_fused=True, **kw):
            runs[name], _ = tt.forward(params, cfg, tokens=tokens)
        counts = ops.launch_counts()
        assert counts["ssm_scan"] == 0
        assert counts["ssm_scan_fused"] == (cfg.n_layers if kw else 0)
        assert counts["flash_attention"] == cfg.n_layers
    with flags(ssm_fused=True, ssm_pallas=True, force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    for got in (runs["pallas"], runs["chunked"]):
        _close(got, plain, (1e-4, 1e-4))
        _close(got, default, (1e-4, 1e-4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_120(dtype):
    """h2o-danube's hd 120 runs as hd 128, zero-padded, at 1/sqrt(120)."""
    dev = _cuda()
    q, k, v = _inputs(8, [(2, 256, 4, 120), (2, 256, 2, 120),
                          (2, 256, 2, 120)], dtype, dev)
    out = ops.flash_attention(q, k, v, window=64)
    assert out.shape == q.shape and out.is_contiguous()
    _close(out, ops.flash_attention_plain(q, k, v, window=64), TOL[dtype])


def test_swa_head_dim_120_kernel_path_matches_plain_path():
    """h2o-danube's prefill at hd 120 goes through K1 on the card and
    equals the plain path (it raised before K1 padded hd 120)."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("h2o-danube-3-4b")),
                              head_dim=120, dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 160), device=dev)
    ops.reset_launch_counts()
    logits, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    with flags(force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    _close(logits, plain, (1e-4, 1e-4))


def test_capture_on_the_card_launches_nothing():
    """The capture of the card's own program (real CUDA tensors in, fake
    tensors inside) runs no kernel and sees each kernel as a region."""
    from repro_torch.core import analyze_module, capture
    dev = _cuda()
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long, device=dev),
             "labels": torch.zeros((2, 64), dtype=torch.long, device=dev)}
    ops.reset_launch_counts()
    module = capture(lambda p, b: tt.loss_fn(p, cfg, b, chunk=32), params,
                     batch)
    assert set(ops.launch_counts().values()) == {0}
    assert module.kernel_calls == {"rmsnorm_pipelined": 2 * cfg.n_layers + 1,
                                   "flash_attention": cfg.n_layers}
    assert analyze_module(module, "nvidia_h100_sxm").chains


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
                                   "rmsnorm_baseline": 0,
                                   "ssm_scan": cfg.n_layers,
                                   "ssm_scan_fused": 0,
                                   "mlstm_chunkwise": 0, "slstm_scan": 0}
    with flags(force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts()["ssm_scan"] == cfg.n_layers
    _close(logits, plain, (1e-4, 1e-4))


def _mlstm_inputs(b, s, h, hd, dtype, device):
    """The reference kernel test's distribution: normal q, k / sqrt(hd), v
    and log_i; log_f = log_sigmoid(normal + 2); gates f32."""
    gen = torch.Generator(device=device).manual_seed(14)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    dt = getattr(torch, dtype)
    q = normal(b, s, h, hd).to(dt)
    k = (normal(b, s, h, hd) / hd ** 0.5).to(dt)
    v = normal(b, s, h, hd).to(dt)
    return q, k, v, normal(b, s, h), \
        torch.nn.functional.logsigmoid(normal(b, s, h) + 2.0)


@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (2, 64, 2, 32, 16), (2, 128, 1, 64, 32),   # the reference grid
    (4, 1024, 4, 192, 128),                    # xlstm-125m's prefill
    (1, 200, 3, 48, 40),                       # no multiple of 4 or of 32
    (2, 8, 2, 32, 1), (2, 136, 2, 64, 17),     # chunks of 1 and 17, 8 each
    (2, 256, 2, 16, 32), (2, 256, 2, 200, 32),  # head dims 16 and 200
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunkwise(b, s, h, hd, chunk, dtype):
    dev = _cuda()
    args = _mlstm_inputs(b, s, h, hd, dtype, dev)
    before = ops.mlstm_chunkwise.launches
    out = ops.mlstm_chunkwise(*args, chunk=chunk)
    assert ops.mlstm_chunkwise.launches == before + 1
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    _close(out, ops.mlstm_chunkwise_plain(*args),
           BF16_TOL if dtype == "bfloat16" else (1e-4, 1e-4))


@pytest.mark.parametrize("b,s,d", [
    (2, 32, 64), (2, 64, 128),   # the reference grid
    (4, 1024, 768),              # xlstm-125m's prefill
    (3, 50, 100),                # D no multiple of the SMs' share
    (11, 20, 64),                # more batch rows than one staged tile
    (9, 20, 64),                 # one row past a tile
    (1, 1, 768),                 # one step
    (4, 30, 1204),               # the widest D the first design took
    (2, 16, "widest"),           # the widest D this one takes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan(b, s, d, dtype):
    dev = _cuda()
    if d == "widest":
        d = _widest_slstm_d(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    dt = getattr(torch, dtype)
    xg = torch.randn((b, s, 4 * d), generator=gen, device=dev).to(dt)
    r = (0.1 * torch.randn((d, 4 * d), generator=gen, device=dev)).to(dt)
    before = ops.slstm_scan.launches
    out = ops.slstm_scan(xg, r)
    assert ops.slstm_scan.launches == before + 1
    assert out.dtype == dt and out.shape == (b, s, d)
    _close(out, ops.slstm_scan_plain(xg, r),
           BF16_TOL if dtype == "bfloat16" else (1e-5, 1e-5))


def _widest_slstm_d(dev):
    from repro_torch.kernels import slstm_scan as k6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widest = 0
    for d in range(1, 4096):
        units, rows = k6.plan(1, d, sms)
        if units <= k6.MAX_UNITS and rows:
            widest = d
    return widest


def test_slstm_scan_refuses_a_grid_that_is_not_co_resident(monkeypatch):
    """K6 spins on other blocks' h, so every block must be resident: on 66
    SMs D 1024 f32 needs 16 units a block, whose columns of r do not fit in
    shared memory beside one row of h.  The wrapper raises, launches
    nothing and returns; the C entry point, handed the card's own SMs and a
    D one block an SM cannot hold, refuses the launch itself."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import slstm_scan as k6
    dev = _cuda()
    monkeypatch.setattr(k6, "_sm_count", lambda device: 66)
    xg = torch.zeros((2, 4, 4096), device=dev)
    r = torch.zeros((1024, 4096), device=dev)
    before = ops.slstm_scan.launches
    with pytest.raises(ValueError, match="slstm_scan: D=1024"):
        ops.slstm_scan(xg, r)
    assert ops.slstm_scan.launches == before
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = _widest_slstm_d(dev) + 1
    assert not k6.plan(1, d, sms)[1] or k6.plan(1, d, sms)[0] > \
        k6.MAX_UNITS
    xg = torch.zeros((1, 4, 4 * d), device=dev)
    r = torch.zeros((d, 4 * d), device=dev)
    out = torch.full((1, 4, d), 7.0, device=dev)
    hbuf = torch.zeros(k6.hbuf_floats(1, d), device=dev)
    err = _build.library().repro_slstm_scan_fwd(
        0, xg.data_ptr(), r.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
        hbuf.data_ptr(), 1, 4, d, _build.current_stream(xg))
    torch.cuda.synchronize()
    assert err == 720  # cudaErrorCooperativeLaunchTooLarge
    assert (out == 7.0).all()


def test_mlstm_passes_count_no_launch():
    """The two-launch timing aid of K5 counts nothing; a wrapper call
    counts one, whatever its launches."""
    from repro_torch.kernels.mlstm_scan import mlstm_chunkwise_passes
    dev = _cuda()
    args = _mlstm_inputs(1, 256, 2, 64, "bfloat16", dev)
    before = ops.mlstm_chunkwise.launches
    states_ms, outputs_ms = mlstm_chunkwise_passes(*args, chunk=64, reps=2)
    assert states_ms > 0 and outputs_ms > 0
    assert ops.mlstm_chunkwise.launches == before
    ops.mlstm_chunkwise(*args, chunk=64)
    assert ops.mlstm_chunkwise.launches == before + 1


def test_xlstm_prefill_kernel_path_matches_plain_path():
    """xlstm-125m smoke in f32 on the card: each mLSTM layer through K5
    (one chunk of 128 here: S 256 is two), each sLSTM layer through K6,
    against the forced-plain path."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("xlstm-125m")),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev)
    ops.reset_launch_counts()
    logits, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "rmsnorm_pipelined": 8,
                                   "rmsnorm_baseline": 0, "ssm_scan": 0,
                                   "ssm_scan_fused": 0,
                                   "mlstm_chunkwise": 3, "slstm_scan": 1}
    with flags(force_plain=True):
        plain, _ = tt.forward(params, cfg, tokens=tokens)
    assert ops.launch_counts()["mlstm_chunkwise"] == 3
    _close(logits, plain, (1e-4, 1e-4))


@pytest.mark.parametrize("arch,k1,k2", [("musicgen-medium", 2, 5),
                                        ("internvl2-2b", 2, 5),
                                        ("phi3.5-moe-42b-a6.6b", 2, 5),
                                        ("deepseek-v2-236b", 0, 9)])
def test_slice_prefill_kernel_path_matches_plain_path(arch, k1, k2):
    """The MLA, MoE, GELU and embedding configurations at smoke size in
    f32 on the card: K1 once an attention layer (none under MLA), K2 at
    every norm (MLA's `q_norm` and `kv_norm` too), against the
    forced-plain path.  The MoE layers route the same tokens on both paths
    here: f32 norms one rounding apart move no smoke router's choice."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(1)
    if cfg.frontend != "none":
        batch = {"embeds": (0.02 * torch.randn((2, 128, cfg.d_model),
                                               generator=gen, device=dev)
                            ).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                         generator=gen, device=dev)}
    ops.reset_launch_counts()
    logits, aux = tt.forward(params, cfg, **batch)
    assert ops.launch_counts() == {"flash_attention": k1,
                                   "rmsnorm_pipelined": k2,
                                   "rmsnorm_baseline": 0, "ssm_scan": 0,
                                   "ssm_scan_fused": 0,
                                   "mlstm_chunkwise": 0, "slstm_scan": 0}
    with flags(force_plain=True):
        plain, plain_aux = tt.forward(params, cfg, **batch)
    _close(logits, plain, (1e-4, 1e-4))
    _close(aux, plain_aux, (1e-5, 1e-5))


def test_moe_combine_is_deterministic_on_the_card():
    """deepseek-v2's routing (160 experts, top-6, two shared) at a narrow
    width in bf16: the same input gives the same bits, call after call, in
    both routing forms.  The combine sums each token's six contributions in
    a fixed order; an atomic scatter-add of bf16 rows would not."""
    from repro_torch.models import moe
    dev = _cuda()
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), d_model=256,
                              moe_d_ff=128)
    gen = torch.Generator(dev).manual_seed(0)

    def normal(shape, scale, dtype):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    p = {k: v[0] if isinstance(v, torch.Tensor) else
         {kk: vv[0] for kk, vv in v.items()}
         for k, v in moe.init_moe(cfg, 1, normal, torch.bfloat16,
                                  dev).items()}
    x = torch.randn((4, 512, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    first, aux = moe.moe_forward(p, x, cfg)
    slots = moe.moe_forward_slots(p, x[:, 0], cfg)
    for _ in range(5):
        again, again_aux = moe.moe_forward(p, x, cfg)
        assert torch.equal(again, first) and torch.equal(again_aux, aux)
        assert torch.equal(moe.moe_forward_slots(p, x[:, 0], cfg), slots)


# -- gradients through the kernels (kernels/autograd.py) ----------------------

def _tracked(seed, shapes, dtype, dev):
    return [t.requires_grad_() for t in _inputs(seed, shapes, dtype, dev)]


def _route_grads(out, inputs, seed):
    """Gradients of a fixed random projection of `out`."""
    gen = torch.Generator(out.device).manual_seed(seed)
    weight = torch.randn(out.shape, generator=gen, device=out.device)
    return torch.autograd.grad((out.float() * weight).sum(), inputs)


@pytest.mark.parametrize("hd,window", [(64, None), (64, 100), (120, None),
                                       (120, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_route_gradients(hd, window, dtype):
    """K1 through `kernel_call` on inputs that require grad: the forward is
    the kernel (one launch of its dtype's body, held to its plain version
    as `test_flash_attention` holds it), the backward launches nothing and
    equals autograd of `chunked_attention`, which it recomputes."""
    from repro_torch.core.torch_frontend import kernel_call
    from repro_torch.models.attention import chunked_attention
    dev = _cuda()
    q, k, v = _tracked(6, [(2, 256, 4, hd), (2, 256, 2, hd),
                           (2, 256, 2, hd)], dtype, dev)
    plain = functools.partial(chunked_attention, chunk=64, window=window)
    before = ops.flash_attention.body_launches[BODY[dtype]]
    out = kernel_call(ops.flash_attention, q, k, v, causal=True,
                      window=window, plain_fn=plain)
    assert out.grad_fn is not None
    got = _route_grads(out, (q, k, v), 7)
    assert ops.flash_attention.body_launches[BODY[dtype]] == before + 1
    with torch.no_grad():
        _close(out, ops.flash_attention_plain(q, k, v, window=window),
               TOL[dtype])
    want = _route_grads(plain(q, k, v), (q, k, v), 7)
    for g, w in zip(got, want):
        _close(g, w, (1e-6, 1e-5) if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("d", [896, 1600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_route_gradients(d, dtype):
    from repro_torch.core.torch_frontend import kernel_call
    dev = _cuda()
    x, scale = _tracked(8, [(512, d), (d,)], dtype, dev)
    plain = functools.partial(ops.rmsnorm_plain, eps=1e-5)
    before = ops.rmsnorm_pipelined.launches
    out = kernel_call(ops.rmsnorm_pipelined, x, scale, eps=1e-5,
                      plain_fn=plain)
    got = _route_grads(out, (x, scale), 9)
    assert ops.rmsnorm_pipelined.launches == before + 1
    with torch.no_grad():
        _close(out, plain(x, scale), TOL[dtype])
    want = _route_grads(plain(x, scale), (x, scale), 9)
    for g, w in zip(got, want):
        _close(g, w, (1e-6, 1e-5) if dtype == "float32" else BF16_TOL)


def test_each_wrapper_refuses_an_input_that_requires_grad():
    """Called directly, no wrapper returns a result cut off from inputs
    that autograd tracks; with grad mode off it launches as before."""
    dev = _cuda()
    cases = {
        "flash_attention": [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)],
        "rmsnorm_pipelined": [(8, 896), (896,)],
        "rmsnorm_baseline": [(8, 896), (896,)],
        "ssm_scan": [(1, 16, 32, 16), (1, 16, 32, 16), (1, 16, 16)],
        "ssm_scan_fused": [(1, 16, 32), (32,), (32, 16), (1, 16, 16),
                           (1, 16, 16)],
        "mlstm_chunkwise": [(1, 64, 2, 32)] * 3 + [(1, 64, 2)] * 2,
        "slstm_scan": [(1, 8, 256), (64, 256)],
    }
    for name, shapes in cases.items():
        fn = ops.KERNELS[name]
        args = _tracked(10, shapes, "float32", dev)
        before = fn.launches
        with pytest.raises(ValueError, match="requires grad"):
            fn(*args)
        assert fn.launches == before
        with torch.no_grad():
            fn(*args)
        assert fn.launches == before + 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b", "xlstm-125m"])
def test_loss_gradients_kernel_path_match_plain_path(arch):
    """f32 smoke on the card: every param leaf gets a gradient through the
    kernel path (K1 and K2; K4 in hymba; K5 and K6 in xLSTM, all under
    remat "group", so each kernel launches twice a layer), each within
    1e-3 of the forced-plain gradient's L2 norm."""
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    leaves, spec = torch.utils._pytree.tree_flatten(params)

    def grads():
        tracked = [p.detach().requires_grad_() for p in leaves]
        loss = tt.loss_fn(spec.unflatten(tracked), cfg, batch, chunk=128)
        return loss, torch.autograd.grad(loss, tracked)
    ops.reset_launch_counts()
    loss, got = grads()
    counts = ops.launch_counts()
    with flags(force_plain=True):
        plain_loss, want = grads()
    assert ops.launch_counts() == counts
    layers = tt.layer_descriptors(cfg)
    attends = sum(m in ("attn", "hybrid") for m, _ in layers)
    assert counts["flash_attention"] == 2 * attends
    assert counts["ssm_scan"] == 2 * sum(m == "hybrid" for m, _ in layers)
    assert counts["mlstm_chunkwise"] == 2 * sum(m == "mlstm"
                                                for m, _ in layers)
    assert counts["slstm_scan"] == 2 * sum(m == "slstm" for m, _ in layers)
    assert loss.item() == pytest.approx(plain_loss.item(), rel=1e-5)
    for g, w in zip(got, want):
        assert float(w.norm()) > 0
        assert float((g - w).norm()) <= 1e-3 * float(w.norm())


def test_train_step_kernel_path_matches_plain_path():
    """Two steps of `make_train_step` on qwen2-0.5b smoke in f32 (the second
    leaves warmup), kernel path against forced-plain path from one state:
    loss and grad norm at rel 1e-5, params after at 1e-4 (AdamW magnifies
    rounding where a gradient is near eps; `tests/test_torch_train.py`)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (TrainOptions, init_train_state,
                                     make_train_step)
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              dtype="float32")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainOptions(
        warmup_steps=1, total_steps=10, chunk=128))
    gen = torch.Generator(dev).manual_seed(2)
    batches = [{k: torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                                 device=dev) for k in ("tokens", "labels")}
               for _ in range(2)]
    runs = {}
    for force_plain in (False, True):
        state = init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        ops.reset_launch_counts()
        with flags(force_plain=force_plain):
            state, m1 = step(state, batches[0])
            state, m2 = step(state, batches[1])
        runs[force_plain] = (state, (m1, m2), ops.launch_counts())
    kernel, plain = runs[False], runs[True]
    # two steps, each layer's K1 once forward and once recomputed
    assert kernel[2]["flash_attention"] == 2 * 2 * cfg.n_layers
    assert kernel[2]["rmsnorm_pipelined"] == 2 * (4 * cfg.n_layers + 1)
    assert plain[2]["flash_attention"] == 0
    for mk, mp in zip(kernel[1], plain[1]):
        for key in ("loss", "grad_norm"):
            assert float(mk[key]) == pytest.approx(float(mp[key]), rel=1e-5)
    for a, b in zip(torch.utils._pytree.tree_leaves(kernel[0]["params"]),
                    torch.utils._pytree.tree_leaves(plain[0]["params"])):
        _close(a, b, (1e-4, 0.0))


def test_async_checkpoint_of_a_card_state(tmp_path):
    """The checkpoint manager's snapshot of a state on the card is a host
    copy taken before `save` returns: an in-place update right after it
    does not reach the file, and the restore lands on the card, bit for
    bit (bf16 included)."""
    from repro_torch.checkpoint import CheckpointManager
    dev = _cuda()
    state = {"params": {"w": torch.randn((64, 32), device=dev,
                                         dtype=torch.bfloat16)},
             "opt": {"mu": torch.randn((64, 32), device=dev)},
             "step": torch.tensor(5, dtype=torch.int32, device=dev)}
    before = {"w": state["params"]["w"].clone(),
              "mu": state["opt"]["mu"].clone()}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state)
    state["opt"]["mu"].add_(1.0)
    state["params"]["w"].mul_(2.0)
    mgr.wait()
    like = {"params": {"w": torch.zeros_like(state["params"]["w"])},
            "opt": {"mu": torch.zeros_like(state["opt"]["mu"])},
            "step": torch.zeros_like(state["step"])}
    restored, step = mgr.restore_latest(like)
    assert step == 5 and int(restored["step"]) == 5
    assert restored["params"]["w"].device.type == "cuda"
    assert torch.equal(restored["params"]["w"], before["w"])
    assert torch.equal(restored["opt"]["mu"], before["mu"])


def test_train_driver_launches_the_kernels_every_step(tmp_path):
    """The driver at smoke width on the card: every step runs K1 and K2
    (remat "group": the forward twice), and a resumed run takes over where
    the saved one stopped."""
    from repro_torch.launch.train import main
    _cuda()
    cfg = smoke_config(get_config("qwen2-0.5b"))
    args = ["--smoke", "--batch", "2", "--seq", "64", "--checkpoint-dir",
            str(tmp_path)]
    ops.reset_launch_counts()
    main(args + ["--steps", "2"])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * 2 * cfg.n_layers
    assert counts["rmsnorm_pipelined"] == 2 * (4 * cfg.n_layers + 1)
    res = main(args + ["--steps", "3", "--restore"])
    assert res["steps"] == 1 and res["history"][0]["step"] == 2


# -- the card's own mesh (launch/mesh.py, parallel/, launch/dryrun.py) --------

def test_host_mesh_on_the_card():
    from repro_torch.launch.mesh import make_host_mesh
    dev = _cuda()
    mesh = make_host_mesh()
    n = torch.cuda.device_count()
    assert mesh.shape == {"data": n, "model": 1}
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    if n == 1:
        assert mesh.device == torch.device(dev.type, 0)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(n + 1)


def test_hillclimb_variant_regions_are_its_launches(tmp_path):
    """hymba-1.5b's `ssm_pallas+flash` variant of hillclimb's cell, smoke
    width at 2 layers, on the card's mesh: `run_variant`'s kernel regions,
    counted trip-aware over its two micro-batches (one `while`), are the
    launches of the real step, K1, K2 and K4's fused entry each."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.context import mesh_context
    from repro_torch.runtime import TrainOptions, init_train_state
    dev = _cuda()
    spec = hillclimb.CELLS["hymba"]
    name, model_flags, overrides = next(
        v for v in spec["variants"] if v[0] == "ssm_pallas+flash")
    shape = ShapeConfig("train_4x128", 128, 4, "train")
    cfg = dataclasses.replace(smoke_config(get_config(spec["arch"])),
                              n_layers=2)
    rec = hillclimb.run_variant(
        cfg, shape, name, model_flags, {"microbatch": 2, **overrides},
        "host", str(tmp_path), hw_name="nvidia_h100_sxm", analyze=False)
    gen = torch.Generator(dev).manual_seed(0)
    inputs = {"state": init_train_state(cfg, gen, dev),
              "batch": {k: torch.randint(0, cfg.vocab_size, (4, 128),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)
                        for k in ("tokens", "labels")}}
    step, args = dryrun.cell_program(
        cfg, shape, inputs, "cuda", TrainOptions(microbatch=2, **overrides))
    ops.reset_launch_counts()
    with flags(**model_flags), mesh_context(make_host_mesh(1)):
        _, metrics = step(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    assert rec["microbatch"] == 2
    assert rec["kernel_regions"] == launched
    assert set(launched) == {"flash_attention", "rmsnorm_pipelined",
                             "ssm_scan_fused"}
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_ep_is_moe_forward_on_the_card(dtype):
    """phi3.5-moe's smoke config on the card's (1, 1) mesh: the per-shard
    body equals the global form bit for bit (the same products, and the
    combine in ascending expert id in both), run after run, on 2048 tokens
    of which the capacity drops some."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.context import mesh_context
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config(
        "phi3.5-moe-42b-a6.6b")), dtype=dtype)
    params = tt.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    gi = next(i for i, g in enumerate(params["groups"])
              if "router" in g.get("ffn", {}))
    p = {k: v[0] for k, v in params["groups"][gi]["ffn"].items()}
    gen = torch.Generator(dev).manual_seed(1)
    base = torch.randn((cfg.d_model,), generator=gen, device=dev)
    x = (base + 0.1 * torch.randn((4, 512, cfg.d_model), generator=gen,
                                  device=dev)).to(getattr(torch, dtype))
    glob, glob_aux = moe.moe_forward(p, x, cfg)
    r = moe.route(p, x.reshape(1, -1, cfg.d_model), cfg)
    keep = moe.dispatch(r.expert_ids, moe._capacity(cfg, 2048)).keep
    assert not bool(keep.all())
    with mesh_context(make_host_mesh(1)):
        for _ in range(3):
            y, aux = moe.moe_forward_ep(p, x, cfg)
            assert torch.equal(y, glob) and torch.equal(aux, glob_aux)
