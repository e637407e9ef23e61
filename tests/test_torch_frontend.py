"""The port's LEO loop on the CPU: `repro_torch.core.capture` of the port's
qwen2-0.5b smoke `loss_fn` (`chunk=64`, batch 4 x 128, the program
`tests/test_system.py::TestLeoGuidedLoop` compiles in the reference),
captured as the CUDA program the card runs (fake CUDA tensors: no card is
needed) and diagnosed by the port's analyzer.

* Its MATMUL FLOPs equal the reference's `from_function(loss_fn)` Module's,
  trip-aware, to 1e-9 relative: both count `2 * out * K` for each product
  of the same shapes (the port unrolls the layer and key-block loops the
  reference scans), so they may differ only by the rounding of the sums.
* The four cases of `TestLeoGuidedLoop` hold on the port's program with
  `nvidia_h100_sxm` and with `tpu_v5e`: a diagnosis with scoped chains;
  `attention_impl="plain"` -> `"kernel"` drops the roofline's memory term
  with FLOPs within 1%; coverage never degrades; the C+L(S) context carries
  recommendations.  And the reference's `tpu_v5p < tpu_v4 < tpu_v5e`
  ordering of estimated step time.
* `kernel_call`, through which the models call each hand kernel, calls the
  wrapper outside a capture; inside one it launches nothing, runs the
  wrapper's checks and records the plain version as the kernel's region.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as ref_core
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_config, smoke_config
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import (FUSED_REGION_MARK, OpClass, analyze_module,
                              capture, compute_roofline, diagnostic_context,
                              get_backend)
from repro_torch.core.torch_frontend import kernel_call
from repro_torch.kernels.flash_attention import (TC_BLOCK_K, TC_BLOCK_Q,
                                                 check_flash_attention)
from repro_torch.kernels import ops
from repro_torch.models import init_params, loss_fn
from repro_torch.models.flags import flags

BACKENDS = ["nvidia_h100_sxm", "tpu_v5e"]


def _capture(impl, device="cuda", cfg=None, batch=(4, 128)):
    cfg = cfg or smoke_config(get_config("qwen2-0.5b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = {"tokens": torch.zeros(batch, dtype=torch.long),
            "labels": torch.zeros(batch, dtype=torch.long)}
    with flags(attention_impl=impl):
        return capture(lambda p, b: loss_fn(p, cfg, b, chunk=64), params,
                       data, device=device, name="loss")


@pytest.fixture(scope="module")
def programs():
    return {impl: _capture(impl) for impl in ("plain", "kernel")}


def class_flops(module, cls_value):
    """Trip-aware FLOPs of one op class (scan bodies times their trips)."""
    def visit(name, mult, stack):
        if name in stack or name not in module.computations:
            return 0.0
        total = 0.0
        for instr in module.computations[name].instructions:
            if instr.op_class.value == cls_value:
                total += mult * instr.flops
            for callee in instr.called_computations:
                total += visit(callee, mult * instr.trip_count,
                               stack | {name})
        return total
    return visit(module.entry, 1.0, frozenset())


def test_matmul_flops_equal_reference(programs):
    jcfg = j_smoke(j_get_config("qwen2-0.5b"))
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.zeros((4, 128), jnp.int32),
             "labels": jnp.zeros((4, 128), jnp.int32)}
    jm = ref_core.from_function(
        lambda p, b: j_loss_fn(p, jcfg, b, chunk=64), params, batch)
    want = class_flops(jm, "matmul")
    assert want > 0
    for module in programs.values():
        assert class_flops(module, "matmul") == pytest.approx(want,
                                                              rel=1e-9)


def test_kernel_calls_are_fused_regions(programs):
    cfg = smoke_config(get_config("qwen2-0.5b"))
    norms = 2 * cfg.n_layers + 1
    assert programs["plain"].kernel_calls == {"rmsnorm_pipelined": norms}
    assert programs["kernel"].kernel_calls == {
        "rmsnorm_pipelined": norms, "flash_attention": cfg.n_layers}
    kernel = list(programs["kernel"].all_instructions())
    region = [i for i in kernel if FUSED_REGION_MARK in i.op_name]
    assert region and all(i.bytes_read == i.bytes_written == 0.0
                          for i in region)
    attn = [i for i in region if "chunked_attention" in i.op_name]
    assert {i.op_class for i in attn} >= {OpClass.MATMUL, OpClass.REDUCE}
    # the same ops in both programs: the kernel variant only prices them
    plain = list(programs["plain"].all_instructions())
    assert [i.opcode for i in plain] == [i.opcode for i in kernel]
    # nodes carry the port's own source lines and scopes
    mm = [i for i in plain if i.opcode == "mm"]
    assert mm and all(i.source_file.endswith(".py") and i.source_line > 0
                      and "/repro_torch/" in i.source_file for i in mm)
    assert all(i.op_name.startswith("loss/loss_fn/forward") for i in mm)
    # a view launches nothing and moves no bytes; a copy does
    views = [i for i in plain if i.opcode in ("view", "permute")]
    assert views and all(i.bytes_read == 0.0 for i in views)
    assert any(i.opcode == "_to_copy" and i.bytes_written > 0
               for i in plain)


def test_capture_of_a_cuda_program_launches_nothing(programs):
    ops.reset_launch_counts()
    _capture("kernel")
    assert set(ops.launch_counts().values()) == {0}


def test_capture_of_a_cpu_program_has_no_kernel():
    module = _capture("kernel", device=None)
    assert module.kernel_calls == {}
    assert not any(FUSED_REGION_MARK in i.op_name
                   for i in module.all_instructions())


def test_capture_of_a_cuda_program_refuses_what_the_kernel_refuses():
    """No fallback in a capture either: the kernel path's checks run."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              head_dim=24)
    with pytest.raises(ValueError, match="head_dim 24"):
        _capture("kernel", cfg=cfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_diagnosis_with_scoped_chains(programs, backend):
    an = analyze_module(programs["plain"], backend)
    assert an.profile.total_stall_cycles >= 0
    assert an.chains or an.blame.occupancy_blame, \
        "LEO must produce a diagnosis"
    scoped = [link for c in an.chains for link in c.links if link.op_name]
    assert scoped, "chains must attribute through op_name scopes"


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_kernel_drops_memory_term(programs, backend):
    hw = get_backend(backend).hw
    base = compute_roofline(programs["plain"], hw, chips=1, label="plain")
    opt = compute_roofline(programs["kernel"], hw, chips=1, label="kernel")
    assert opt.memory_s < base.memory_s
    assert opt.hlo_flops == pytest.approx(base.hlo_flops, rel=0.01)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_coverage_never_degrades(programs, backend):
    for module in programs.values():
        an = analyze_module(module, backend)
        assert an.coverage_after.coverage >= an.coverage_before.coverage


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_reports_are_actionable(programs, backend):
    an = analyze_module(programs["plain"], backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ctx = diagnostic_context("C+L(S)", "kernel source here", an)
        assert "Recommendations" in ctx
        assert len(ctx) > len(diagnostic_context("C", "kernel source here"))


def test_cross_backend_ordering(programs):
    times = {name: analyze_module(programs["plain"],
                                  name).estimated_step_seconds
             for name in ("tpu_v5e", "tpu_v5p", "tpu_v4")}
    assert times["tpu_v5p"] < times["tpu_v4"] < times["tpu_v5e"]


# wrapper, plain version, input shapes the kernel takes, shapes it refuses
KERNEL_CASES = {
    "flash_attention": (ops.flash_attention, ops.flash_attention_plain,
                        [(1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)],
                        [(1, 64, 4, 96)] * 3),  # head dim 96
    "rmsnorm_pipelined": (ops.rmsnorm_pipelined, ops.rmsnorm_plain,
                          [(8, 896), (896,)],
                          [(8, 45), (45,)]),  # rows of 180 bytes
    "rmsnorm_baseline": (ops.rmsnorm_baseline, ops.rmsnorm_plain,
                         [(8, 896), (896,)],
                         [(8, 896), (895,)]),  # scale of another width
    "ssm_scan": (ops.ssm_scan, ops.ssm_scan_plain,
                 [(2, 16, 32, 16), (2, 16, 32, 16), (2, 16, 16)],
                 [(2, 16, 32, 12), (2, 16, 32, 12), (2, 16, 12)]),  # N 12
    "mlstm_chunkwise": (ops.mlstm_chunkwise, ops.mlstm_chunkwise_plain,
                        [(1, 64, 2, 16)] * 3 + [(1, 64, 2)] * 2,
                        # chunk 64 does not divide S 96
                        [(1, 96, 2, 16)] * 3 + [(1, 96, 2)] * 2),
    "slstm_scan": (ops.slstm_scan, ops.slstm_scan_plain,
                   [(2, 16, 64), (16, 64)],
                   [(2, 16, 64), (16, 60)]),  # r is not (D, 4D)
}


def _call_kernel(kernel):
    fn, plain = KERNEL_CASES[kernel][:2]
    return lambda *a: kernel_call(fn, *a, plain_fn=plain)


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_call_in_a_capture_records_the_plain_version(kernel):
    args = [torch.rand(shape) for shape in KERNEL_CASES[kernel][2]]
    ops.reset_launch_counts()
    module = capture(_call_kernel(kernel), *args, device="cuda")
    assert set(ops.launch_counts().values()) == {0}
    assert module.kernel_calls == {kernel: 1}
    recorded = [i for i in module.all_instructions()
                if i.opcode not in ("parameter", "constant")]
    assert recorded and all(f"{FUSED_REGION_MARK}:{kernel}" in i.op_name
                            for i in recorded)
    assert all(i.bytes_read == i.bytes_written == 0.0 for i in recorded)


@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_kernel_call_in_a_capture_refuses_what_the_kernel_refuses(kernel):
    args = [torch.rand(shape) for shape in KERNEL_CASES[kernel][3]]
    with pytest.raises(ValueError, match=kernel):
        capture(_call_kernel(kernel), *args, device="cuda")


def test_kernel_call_outside_a_capture_calls_the_wrapper():
    x, scale = torch.rand((8, 64)), torch.rand(64)

    def never(*args):
        raise AssertionError("the plain version runs only in a capture")
    out = kernel_call(ops.rmsnorm_pipelined, x, scale, plain_fn=never)
    assert torch.equal(out, ops.rmsnorm_plain(x, scale))


def test_flash_attention_checks_shared_memory_at_the_padded_head_dim():
    """hd 120 runs as 128: block_k 230 fits at 120 (220,800 bytes of K and
    V tiles) but not at 128 (235,520, above the 232,448 a block may use)."""
    with FakeTensorMode():
        q = torch.empty((1, 64, 4, 120), device="cuda")
        check_flash_attention(q, q, q, block_k=226)
        with pytest.raises(ValueError, match="head dim 128"):
            check_flash_attention(q, q, q, block_k=230)


def test_flash_attention_checks_the_block_pairs_of_the_bf16_body():
    """The bf16 body (csrc/flash_attention_tc.cu) is built for block_k in
    TC_BLOCK_K and takes block_q in TC_BLOCK_Q (a warp per 16 rows): the
    check takes each of those pairs and refuses others, as the launch
    does; the f32 body takes any block_k that fits."""
    with FakeTensorMode():
        q = torch.empty((1, 256, 4, 64), device="cuda", dtype=torch.bfloat16)
        for block_q in TC_BLOCK_Q:
            for block_k in TC_BLOCK_K:
                check_flash_attention(q, q, q, block_q=block_q,
                                      block_k=block_k)
        for block_q, block_k in ((64, 48), (64, 16), (64, 256), (8, 64),
                                 (24, 64), (144, 64)):
            with pytest.raises(ValueError, match="bf16 body"):
                check_flash_attention(q, q, q, block_q=block_q,
                                      block_k=block_k)
        # the f32 body takes block_k 48
        check_flash_attention(q.float(), q.float(), q.float(), block_k=48)
