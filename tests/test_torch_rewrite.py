"""The port's rewrite loop (`repro_torch.rewrite`, copies of
`repro.rewrite`) against the original.

On HLO programs (the conftest fixtures, the 48-copy storm, the wide-ops
and demo traces, the qwen2-0.5b smoke loss) both packages parse the same
text, emit it, lower every kind of mutation and close the loop on every
backend of the reference: the emitted text, each rewrite's hash and
certificate, the predicted and realized speedups and every typed refusal
must be equal, not close.  On the sources the printer cannot emit (the
reference's jaxpr Modules, the port's torch capture and the PTX fixtures)
the port must refuse or skip exactly where the reference does, with the
reference's `PrinterError` where a program mutation reaches `emit_hlo`.
"""
import json

import jax.numpy as jnp
import pytest

import repro.core as ref
import repro.rewrite as ref_rw
import repro_torch.core as port
import repro_torch.rewrite as port_rw
from conftest import ASYNC_HLO, COPYSTORM_HLO
from repro.advisor import mutation_from_dict as ref_mutation
from repro.launch.analysis_server import (copy_storm_hlo, demo_hlo,
                                          wide_ops_hlo)
from repro_torch.advisor import mutation_from_dict as port_mutation
from test_torch_advisor import (GOLDENS, PROGRAMS, PTX, assert_copy,
                                build_programs, smoke_loss_hlo, to_ref)
from test_torch_core import BACKENDS, to_port

GPU_VENDORS = ("nvidia_gh200", "amd_mi300a", "intel_pvc")

MUTATIONS = {
    "identity": {"kind": "Identity"},
    "coalesce_2": {"kind": "CoalesceSyncTags", "group": 2},
    "coalesce_1": {"kind": "CoalesceSyncTags", "group": 1},
    "pipeline_2": {"kind": "PipelineAsyncChain", "window": 2},
    "tree_reduce_4": {"kind": "TreeReduceChain", "min_length": 4},
    "compose": {"kind": "Compose", "parts": [
        {"kind": "CoalesceSyncTags", "group": 8},
        {"kind": "TreeReduceChain", "min_length": 4}]},
    "compose_hardware": {"kind": "Compose", "parts": [
        {"kind": "CoalesceSyncTags", "group": 4},
        {"kind": "ResizePool", "pool": "barrier_slot", "capacity": 12}]},
    "resize_pool": {"kind": "ResizePool", "pool": "barrier_slot",
                    "capacity": 12},
    "set_issue": {"kind": "SetIssue", "width": 2},
    "scale_latency": {"kind": "ScaleLatency", "hw_field": "hbm_bw",
                      "factor": 2.0},
    "set_occupancy": {"kind": "SetOccupancy"},
    "relax_sync_edge": {"kind": "RelaxSyncEdge", "match": "copy-done"},
}


@pytest.fixture(scope="module")
def texts():
    return {"async": ASYNC_HLO, "copystorm8": COPYSTORM_HLO,
            "copystorm48": copy_storm_hlo(48), "wide_ops": wide_ops_hlo(),
            "demo": demo_hlo(), "qwen2_loss": smoke_loss_hlo()}


TEXTS = ["async", "copystorm8", "copystorm48", "wide_ops", "demo",
         "qwen2_loss"]

#: the Modules the printer cannot emit: the reference's jaxpr ones, the
#: port's torch capture and PTX
NOT_HLO = ["rmsnorm_pipelined_jaxpr", "sin_jaxpr", "qwen2_loss_torch",
           *PTX]


@pytest.fixture(scope="module")
def programs():
    progs = build_programs()
    m = ref.from_function(lambda x: jnp.sin(x).sum(), jnp.ones((4, 4)))
    progs["sin_jaxpr"] = (m, to_port(m))
    return progs


def outcome(rw, mutation, module, hints=None):
    """What `apply_rewrite` does with one mutation: the rewrite's text,
    hash and certificate, or the exception it raised."""
    try:
        res = rw.apply_rewrite(module, mutation, hints=hints)
    except Exception as e:      # the refusal itself is the result
        return ("raised", type(e).__name__, str(e),
                getattr(e, "to_dict", lambda: None)())
    return ("applied", res.hlo_text, res.to_dict())


def report_data(rep):
    """A RewriteReport without its wall time."""
    data = rep.to_dict()
    data.pop("rewrite_seconds")
    return data


def loop_outcome(rw, program, backend, **kw):
    try:
        return ("ran", report_data(rw.RewriteLoop(**kw).run(program,
                                                            backend)))
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("name", ["rewrite/printer.py",
                                  "rewrite/rewriters.py", "rewrite/loop.py",
                                  "rewrite/__init__.py"])
def test_copies_are_verbatim(name):
    assert_copy(name)


def test_kinds_equal_reference():
    assert port_rw.REWRITABLE_KINDS == ref_rw.REWRITABLE_KINDS
    for m in MUTATIONS.values():
        assert port_rw.is_rewritable(port_mutation(m)) == \
            ref_rw.is_rewritable(ref_mutation(m))


@pytest.mark.parametrize("name", TEXTS)
def test_emit_hlo_equals_reference(texts, name):
    module = port.parse_hlo(texts[name])
    text = port_rw.emit_hlo(module)
    assert text == ref_rw.emit_hlo(ref.parse_hlo(texts[name]))
    assert port.parse_hlo(text) == module


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("name", TEXTS)
def test_apply_rewrite_equals_reference(texts, name, mutation):
    hints = {"force_serial": True} if name == "wide_ops" else None
    got = outcome(port_rw, port_mutation(MUTATIONS[mutation]),
                  port.parse_hlo(texts[name], hints=hints), hints)
    want = outcome(ref_rw, ref_mutation(MUTATIONS[mutation]),
                   ref.parse_hlo(texts[name], hints=hints), hints)
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", TEXTS)
def test_rewrite_loop_equals_reference(texts, name, backend):
    """Outcomes (hash, predicted and realized speedups, certificates,
    fallbacks) and skips, through the session when asked for."""
    got = loop_outcome(port_rw, texts[name], backend, top_k=2)
    want = loop_outcome(ref_rw, texts[name], backend, top_k=2)
    assert got == want and got[0] == "ran"
    if name == "copystorm48" and backend in GPU_VENDORS:
        assert got[1]["outcomes"]
        with_session = port_rw.RewriteLoop(top_k=2).run(
            texts[name], backend, session=port.LeoSession())
        assert report_data(with_session) == got[1]


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("program", NOT_HLO)
def test_apply_rewrite_on_other_sources(programs, program, mutation):
    """Hardware kinds and unregistered kinds refuse with their typed code
    before the printer; a program mutation on a Module the printer cannot
    emit raises its `PrinterError`."""
    ref_module, port_module = programs[program]
    got = outcome(port_rw, port_mutation(MUTATIONS[mutation]), port_module)
    assert got == outcome(ref_rw, ref_mutation(MUTATIONS[mutation]),
                          ref_module)
    assert got[:2] in (("raised", "NotApplicable"), ("raised", "PrinterError"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", NOT_HLO)
def test_rewrite_loop_on_other_sources(programs, program, backend):
    ref_module, port_module = programs[program]
    got = loop_outcome(port_rw, port_module, backend)
    assert got == loop_outcome(ref_rw, ref_module, backend)
    assert got[1] == "PrinterError" if got[0] == "raised" else \
        not got[1]["outcomes"]


@pytest.mark.parametrize("program", PROGRAMS + ["sin_jaxpr"])
def test_rewrite_loop_on_the_h100_backend(programs, program):
    """The port's own backend: a Module the printer cannot emit is never
    rewritten; each skip is typed."""
    module = programs[program][1]
    try:
        rep = port_rw.RewriteLoop().run(module, "nvidia_h100_sxm")
    except port_rw.PrinterError:
        assert module.source != "hlo"
        return
    if module.source != "hlo":
        assert not rep.outcomes
    for s in rep.skipped:
        assert s["refusal"]["code"] in ("hardware_mutation", "unsupported",
                                        "noop")
    assert json.loads(json.dumps(port_rw.rewrites_section(rep))) == \
        port_rw.rewrites_section(rep)


def _divergence_snapshot(report):
    """`tests/test_rewrite_divergence.py`'s `_snapshot`."""
    best = report.best
    return {
        "baseline_makespan_cycles": report.baseline_makespan_cycles,
        "n_outcomes": len(report.outcomes),
        "skipped_rules": sorted(s["rule"] for s in report.skipped),
        "best_rule": best.rule if best else None,
        "best_source": best.source if best else None,
        "best_mutation": dict(best.mutation) if best else None,
        "best_certificate": best.certificate["declared"] if best else None,
        "best_predicted_speedup": best.predicted_speedup if best else 1.0,
        "best_realized_speedup": best.realized_speedup if best else 1.0,
        "best_refusal_code": (best.refusal or {}).get("code")
        if best else None,
    }


def test_rewrite_divergence_golden():
    """The port's loop on the 48-copy storm equals the reference's and the
    committed golden (read, never written)."""
    goldens = json.loads((GOLDENS / "rewrite_divergence.json").read_text())
    assert sorted(k for k in goldens if not k.startswith("_")) == \
        sorted(GPU_VENDORS)
    hlo = copy_storm_hlo(48)
    for b in GPU_VENDORS:
        got = _divergence_snapshot(port_rw.RewriteLoop(top_k=2).run(hlo, b))
        assert got == _divergence_snapshot(
            ref_rw.RewriteLoop(top_k=2).run(hlo, b)), b
        assert got == goldens[b], b


@pytest.mark.parametrize("backend", GPU_VENDORS)
def test_service_rewrites_equal_reference(backend):
    hlo = copy_storm_hlo(48)
    got = port.LeoService().diagnose(
        hlo, backend=backend,
        options=port.DiagnoseOptions(advise=True, rewrite=True))
    want = ref.LeoService().diagnose(
        hlo, backend=backend,
        options=ref.DiagnoseOptions(advise=True, rewrite=True))
    assert got.to_json() == want.to_json()
    assert got.rewrites["recorded"] and got.rewrites["count"] >= 1


def test_to_ref_mirrors_to_port(programs):
    for ref_module, port_module in programs.values():
        assert to_ref(to_port(ref_module)) == ref_module
