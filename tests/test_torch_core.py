"""The port's copies of LEO's analyzer tiers (`repro_torch.core`) against
the originals (`repro.core`).

Two reference Modules are built with the JAX package: `parse_hlo` of the
compiled qwen2-0.5b smoke loss (as `tests/test_system.py` compiles it) and
`from_function` of the pipelined RMSNorm Pallas kernel in interpret mode
(as `tests/test_kernels.py::test_leo_traces_rmsnorm_dma`).  Each is rebuilt
as the port's `Module` field by field, enums mapped by value, and analysed
by both packages on every backend of the reference.  The analysis is pure
Python over the same input in the same order, so the results must be
equal, not close: estimated seconds, stall cycles per class, edges per
kind, chains (every link), coverage, the roofline's fields and the
C+L(S) diagnostic context.
"""
import dataclasses
import warnings
from collections import Counter

import jax
import jax.numpy as jnp
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.configs import get_config, smoke_config
from repro.kernels.rmsnorm import rmsnorm_pipelined
from repro.models import init_params, loss_fn
from repro_torch.core import isa as port_isa

BACKENDS = ["amd_mi300a", "intel_pvc", "nvidia_gh200", "tpu_v5e", "tpu_v5p",
            "tpu_v4"]


def _shape(s):
    return port_isa.ShapeInfo(
        dtype=s.dtype, dims=s.dims,
        elements=None if s.elements is None else tuple(
            _shape(e) for e in s.elements))


def to_port(module):
    """The reference's Module as the port's: every dataclass field copied,
    every enum mapped by value."""
    out = port_isa.Module(name=module.name, entry=module.entry,
                          source=module.source)
    for comp in module.computations.values():
        pc = port_isa.Computation(name=comp.name, kind=comp.kind,
                                  parent_op=comp.parent_op)
        for i in comp.instructions:
            fields = {f.name: getattr(i, f.name)
                      for f in dataclasses.fields(i)}
            fields.update(
                op_class=port_isa.OpClass(i.op_class.value),
                shape=_shape(i.shape), attributes=dict(i.attributes),
                sync=port_isa.SyncInfo(
                    kind=None if i.sync.kind is None else
                    port_isa.SyncKind(i.sync.kind.value),
                    sets=i.sync.sets, waits=i.sync.waits,
                    counter=i.sync.counter))
            pi = port_isa.Instruction(**fields)
            pc.add(pi)
            pi.index = i.index
        out.add_computation(pc)
    return out


@pytest.fixture(scope="module")
def programs():
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.zeros((4, 128), jnp.int32),
             "labels": jnp.zeros((4, 128), jnp.int32)}
    hlo = jax.jit(lambda p, b: loss_fn(p, cfg, b, chunk=64)).lower(
        params, batch).compile().as_text()
    x = jnp.zeros((32, 128), jnp.float32)
    scale = jnp.ones((128,), jnp.float32)
    return {
        "qwen2_loss_hlo": lambda: ref.parse_hlo(hlo),
        "rmsnorm_pipelined_jaxpr": lambda: ref.from_function(
            lambda a, b: rmsnorm_pipelined(a, b, interpret=True), x, scale),
    }


def summary(an):
    stalls = Counter()
    for rec in an.profile.records.values():
        for cls, cycles in rec.stall_breakdown.items():
            stalls[cls.value] += cycles
    return {
        "seconds": an.estimated_step_seconds,
        "total_stall_cycles": an.profile.total_stall_cycles,
        "stalls": dict(stalls),
        "edges": dict(Counter(e.kind.value for e in an.graph.edges)),
        "sync_edges_added": an.sync_edges_added,
        "chains": [[(link.qualified, link.opcode,
                     link.edge_kind and link.edge_kind.value,
                     link.blame_cycles, link.op_name, link.source)
                    for link in chain.links] for chain in an.chains],
        "coverage": (an.coverage_before.coverage,
                     an.coverage_after.coverage),
        "root_causes": [(q, c) for q, c in an.top_root_causes(10)],
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", ["qwen2_loss_hlo",
                                     "rmsnorm_pipelined_jaxpr"])
def test_analysis_equals_reference(programs, program, backend):
    module = programs[program]()
    mirrored = to_port(module)
    want = ref.analyze_module(module, backend)
    got = port.analyze_module(mirrored, backend)
    assert summary(got) == summary(want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert port.diagnostic_context("C+L(S)", "src", got) == \
            ref.diagnostic_context("C+L(S)", "src", want)
        assert [r.action for r in port.recommendations(got)] == \
            [r.action for r in ref.recommendations(want)]


@pytest.mark.parametrize("program", ["qwen2_loss_hlo",
                                     "rmsnorm_pipelined_jaxpr"])
def test_roofline_equals_reference(programs, program):
    module = programs[program]()
    mirrored = to_port(module)
    for hw in (ref.TPU_V5E, ref.TPU_V5P, ref.TPU_V4):
        want = ref.compute_roofline(module, hw, chips=1, label="x")
        got = port.compute_roofline(mirrored, port.HARDWARE_MODELS[hw.name],
                                    chips=1, label="x")
        assert got.to_dict() == want.to_dict()


def test_backend_registry_is_the_reference_plus_the_h100():
    names = sorted(b.name for b in port.list_backends())
    assert names == sorted(BACKENDS + ["nvidia_h100_sxm"])
    for name in BACKENDS:
        assert dataclasses.asdict(port.get_backend(name).hw) == \
            dataclasses.asdict(ref.get_backend(name).hw)


def test_h100_backend_is_the_datasheet():
    """H100 SXM5 80GB datasheet numbers; the SM models are GH200's."""
    h100, gh200 = (port.get_backend(n) for n in ("nvidia_h100_sxm",
                                                 "nvidia_gh200"))
    hw = h100.hw
    assert (hw.peak_flops_bf16, hw.peak_flops_f32) == (989e12, 67e12)
    assert (hw.hbm_bw, hw.hbm_bytes) == (3.35e12, 80e9)
    assert hw.ici_bw_per_link * hw.ici_links == 450e9
    assert (hw.vmem_bytes, hw.clock_hz) == (50 * 2**20, 1980e6)
    assert h100.issue == gh200.issue and h100.sync == gh200.sync
    assert h100.native_occupancy == gh200.native_occupancy
    assert h100.stall_taxonomy == gh200.stall_taxonomy
