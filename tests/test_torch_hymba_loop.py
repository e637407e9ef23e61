"""The port's LEO loop on the hybrid model, on the CPU: hymba-1.5b smoke's
`loss_fn` (batch 2 x 256, attention chunk 64) captured as the CUDA program
the card runs (fake CUDA tensors: no card is needed) under the reference's
two SSM forms, and diagnosed by the port's analyzer.

* The baseline: `ssm_fused=False`, a region of K4's `ssm_scan` over the
  materialised a/bx (B, S, din, N).  The fix: `ssm_fused=True,
  ssm_pallas=True`, one region of K4's fused entry from xin to y.
* Each region records the reference's chunked scan: S/128 chunk iterations
  a layer (one readout product each), not an unrolled loop of S steps.
* The four cases of `tests/test_system.py::TestLeoGuidedLoop` hold on
  `nvidia_h100_sxm` and `tpu_v5e`: a diagnosis with scoped chains; the
  roofline's memory term drops from baseline to fix with FLOPs within 1%;
  coverage never degrades; the C+L(S) context carries recommendations.
  And the reference's `tpu_v5p < tpu_v4 < tpu_v5e` ordering.
* The reference's own Modules (`from_function(loss_fn)` under the same
  flags) drop their memory term in the same direction.
"""
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
from repro.models.flags import flags as j_flags
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (FUSED_REGION_MARK, analyze_module, capture,
                              compute_roofline, diagnostic_context,
                              get_backend)
from repro_torch.kernels import ops
from repro_torch.models import init_params, loss_fn
from repro_torch.models.flags import flags

BACKENDS = ["nvidia_h100_sxm", "tpu_v5e"]
BATCH = (2, 256)
FORMS = {"baseline": {}, "fix": {"ssm_fused": True, "ssm_pallas": True}}
REGION = {"baseline": "ssm_scan", "fix": "ssm_scan_fused"}


def _capture(form):
    cfg = smoke_config(get_config("hymba-1.5b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = {"tokens": torch.zeros(BATCH, dtype=torch.long),
            "labels": torch.zeros(BATCH, dtype=torch.long)}
    with flags(**FORMS[form]):
        return capture(lambda p, b: loss_fn(p, cfg, b, chunk=64), params,
                       data, device="cuda", name="loss")


@pytest.fixture(scope="module")
def programs():
    ops.reset_launch_counts()
    out = {form: _capture(form) for form in FORMS}
    assert set(ops.launch_counts().values()) == {0}
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
def test_scan_regions_run_chunks_not_steps(programs, form):
    cfg = smoke_config(get_config("hymba-1.5b"))
    assert programs[form].kernel_calls == {
        "rmsnorm_pipelined": 2 * cfg.n_layers + 1,
        "flash_attention": cfg.n_layers, REGION[form]: cfg.n_layers}
    mark = f"{FUSED_REGION_MARK}:{REGION[form]}"
    region = [i for i in programs[form].all_instructions()
              if mark in i.op_name]
    assert region and all(i.bytes_read == i.bytes_written == 0.0
                          for i in region)
    # one readout product a chunk, S/128 a layer (the sequential loop
    # records one a step, S a layer)
    readouts = [i for i in region if i.opcode == "bmm"]
    assert len(readouts) == cfg.n_layers * BATCH[1] // 128


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_diagnosis_with_scoped_chains(programs, backend):
    an = analyze_module(programs["baseline"], backend)
    assert an.profile.total_stall_cycles >= 0
    assert an.chains or an.blame.occupancy_blame, \
        "LEO must produce a diagnosis"
    scoped = [link for c in an.chains for link in c.links if link.op_name]
    assert scoped, "chains must attribute through op_name scopes"


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_fused_scan_drops_memory_term(programs, backend):
    hw = get_backend(backend).hw
    base = compute_roofline(programs["baseline"], hw, chips=1,
                            label="baseline")
    fix = compute_roofline(programs["fix"], hw, chips=1, label="fix")
    assert fix.memory_s < base.memory_s
    assert fix.hlo_flops == pytest.approx(base.hlo_flops, rel=0.01)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_coverage_never_degrades(programs, backend):
    for module in programs.values():
        an = analyze_module(module, backend)
        assert an.coverage_after.coverage >= an.coverage_before.coverage


@pytest.mark.parametrize("backend", BACKENDS)
def test_loop_reports_are_actionable(programs, backend):
    an = analyze_module(programs["baseline"], backend)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ctx = diagnostic_context("C+L(S)", "kernel source here", an)
        assert "Recommendations" in ctx
        assert len(ctx) > len(diagnostic_context("C", "kernel source here"))


def test_cross_backend_ordering(programs):
    times = {name: analyze_module(programs["baseline"],
                                  name).estimated_step_seconds
             for name in ("tpu_v5e", "tpu_v5p", "tpu_v4")}
    assert times["tpu_v5p"] < times["tpu_v4"] < times["tpu_v5e"]


def test_reference_drops_its_memory_term_alike(programs):
    """The reference's fused+pallas form prices its scan as one region, so
    its Module's memory term drops from the default's, as the port's
    does."""
    jcfg = j_smoke(j_get_config("hymba-1.5b"))
    params = j_init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.zeros(BATCH, jnp.int32),
             "labels": jnp.zeros(BATCH, jnp.int32)}
    hw = ref_core.get_backend("tpu_v5e").hw
    memory = {}
    for form, kw in FORMS.items():
        with j_flags(**kw):
            module = ref_core.from_function(
                lambda p, b: j_loss_fn(p, jcfg, b, chunk=64), params, batch)
        memory[form] = ref_core.compute_roofline(module, hw, chips=1,
                                                 label=form).memory_s
    assert memory["fix"] < memory["baseline"]
    port_hw = get_backend("tpu_v5e").hw
    port = {form: compute_roofline(programs[form], port_hw, chips=1,
                                   label=form).memory_s for form in FORMS}
    assert port["fix"] < port["baseline"]
