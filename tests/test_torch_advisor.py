"""The port's advisor (`repro_torch.advisor`, copies of `repro.advisor`)
against the original.

The programs are the Modules `tests/test_torch_core.py` builds (the
qwen2-0.5b smoke loss through `parse_hlo`, the pipelined RMSNorm through
`from_function` in interpret mode), the three demo traces of
`launch/analysis_server.py`, and two kinds the reference never makes: the
port's `capture` of the smoke loss (source "torch") and the PTX fixtures
of `tests/test_torch_ptx.py` (source "ptx").  A reference Module is
mirrored into the port with `to_port`, a port Module into the reference
with `to_ref`; both packages then advise on the same Module.  The advisor
is pure Python over the same input, so advice, replay counts and every
replay's profile fingerprint must be equal, not close, on every backend
of the reference.  On the port's own `nvidia_h100_sxm`, which the
reference lacks, the identity replay must reproduce the baseline.
"""
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import repro.advisor as ref_adv
import repro.advisor.whatif as ref_whatif
import repro.core as ref
import repro_torch.advisor as port_adv
import repro_torch.advisor.whatif as port_whatif
import repro_torch.core as port
from repro.configs import get_config, smoke_config
from repro.core import isa as ref_isa
from repro.kernels.rmsnorm import rmsnorm_pipelined
from repro.launch.analysis_server import (copy_storm_hlo, demo_hlo,
                                          wide_ops_hlo)
from repro.models import init_params, loss_fn
from test_torch_core import BACKENDS, mirror, to_port
from test_torch_ptx import PLAIN, RING, RING_V4, SYNC_V4

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"

#: Lines of the reference's text that the port words differently, by file:
#: comments and docstrings that said what only the JAX package does.
DOC_EDITS = {
    "serve/httpd.py": [(
        "        # imported here, not at module top: repro_torch.launch pulls "
        "jax in via\n"
        "        # its package __init__, and repro_torch.serve stays "
        "stdlib-light until\n"
        "        # a server is actually constructed\n",
        "        # imported here, not at module top: the slot engine under\n"
        "        # repro_torch.launch loads only once a server is actually\n"
        "        # constructed\n")],
    "serve/pool.py": [(
        "(repro_torch.launch pulls jax in)",
        "(repro_torch.core pulls torch in)")],
    "serve/__init__.py": [(
        "This module stays import-light: ``repro_torch.serve`` pulls no "
        "accelerator\n"
        "dependencies (the slot engine under ``repro_torch.launch`` is "
        "imported lazily\n"
        "by the front-end at construction time).\n",
        "``repro_torch.serve`` imports torch through ``repro_torch.core`` "
        "but runs\n"
        "on the host and never initialises CUDA (the slot engine under\n"
        "``repro_torch.launch`` is imported lazily by the front-end at "
        "construction\n"
        "time).\n")],
}


def assert_copy(rel):
    """`src/repro_torch/<rel>` is `src/repro/<rel>` with the package named
    `repro_torch`, apart from the edits `DOC_EDITS` lists."""
    want = re.sub(r"\brepro\.", "repro_torch.",
                  (ROOT / "src/repro" / rel).read_text())
    for old, new in DOC_EDITS.get(rel, []):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    assert (ROOT / "src/repro_torch" / rel).read_text() == want


def to_ref(module):
    """The port's Module as the reference's: the inverse of `to_port`."""
    return mirror(module, ref_isa)


def smoke_loss_hlo():
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.zeros((4, 128), jnp.int32),
             "labels": jnp.zeros((4, 128), jnp.int32)}
    return jax.jit(lambda p, b: loss_fn(p, cfg, b, chunk=64)).lower(
        params, batch).compile().as_text()


def torch_capture():
    """The port's CUDA program of the smoke loss (fake tensors)."""
    import torch
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import smoke_config as t_smoke_config
    from repro_torch.models import init_params as t_init_params
    from repro_torch.models import loss_fn as t_loss_fn
    cfg = t_smoke_config(t_get_config("qwen2-0.5b"))
    params = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}
    return port.capture(lambda p, b: t_loss_fn(p, cfg, b, chunk=32),
                        params, batch, device="cuda")


def ptx_module(text):
    (entry,) = port.ptx_entries(text)
    return port.from_ptx(text, entry)


PTX = {"ptx_plain": PLAIN, "ptx_ring": RING, "ptx_ring_v4": RING_V4,
       "ptx_sync_v4": SYNC_V4}


def build_programs():
    """{name: (reference Module, port Module)} over every source kind."""
    hlo = smoke_loss_hlo()
    x = jnp.zeros((32, 128), jnp.float32)
    scale = jnp.ones((128,), jnp.float32)
    ref_modules = {
        "qwen2_loss_hlo": ref.parse_hlo(hlo),
        "rmsnorm_pipelined_jaxpr": ref.from_function(
            lambda a, b: rmsnorm_pipelined(a, b, interpret=True), x, scale),
        "copy_storm_48": ref.parse_hlo(copy_storm_hlo(48)),
        "wide_ops": ref.parse_hlo(wide_ops_hlo()),
        "demo": ref.parse_hlo(demo_hlo()),
    }
    out = {k: (m, to_port(m)) for k, m in ref_modules.items()}
    port_modules = {"qwen2_loss_torch": torch_capture()}
    port_modules.update({k: ptx_module(t) for k, t in PTX.items()})
    out.update({k: (to_ref(m), m) for k, m in port_modules.items()})
    return out


PROGRAMS = ["qwen2_loss_hlo", "rmsnorm_pipelined_jaxpr", "copy_storm_48",
            "wide_ops", "demo", "qwen2_loss_torch", *PTX]


@pytest.fixture(scope="module")
def programs():
    return build_programs()


def recording(monkeypatch, whatif):
    """Every sampler run of `whatif.WhatIfEngine` from here on, as its
    profile's fingerprint."""
    seen = []
    run = whatif.WhatIfEngine._run

    def _run(self, module, backend):
        profile = run(self, module, backend)
        seen.append(whatif.profile_fingerprint(profile))
        return profile
    monkeypatch.setattr(whatif.WhatIfEngine, "_run", _run)
    return seen


def report_data(rep):
    """An AdvisorReport without its wall time."""
    return {"backend": rep.backend,
            "advice": [(a.to_dict(), a.score) for a in rep.advice],
            "baseline_makespan_cycles": rep.baseline_makespan_cycles,
            "rules_matched": rep.rules_matched,
            "candidates_replayed": rep.candidates_replayed}


@pytest.mark.parametrize("name", ["advisor/whatif.py", "advisor/rules.py",
                                  "advisor/advisor.py",
                                  "advisor/__init__.py"])
def test_copies_are_verbatim(name):
    assert_copy(name)


def test_sources_are_the_ones_named(programs):
    assert {n: p.source for n, (_, p) in programs.items()} == {
        "qwen2_loss_hlo": "hlo", "rmsnorm_pipelined_jaxpr": "jaxpr",
        "copy_storm_48": "hlo", "wide_ops": "hlo", "demo": "hlo",
        "qwen2_loss_torch": "torch", "ptx_plain": "ptx",
        "ptx_ring": "ptx", "ptx_ring_v4": "ptx", "ptx_sync_v4": "ptx"}
    assert programs["qwen2_loss_torch"][1].kernel_calls


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", PROGRAMS)
def test_advice_and_replays_equal_reference(programs, monkeypatch, program,
                                            backend):
    """Advice lists, replay counts and every replay's fingerprint, for a
    plain report and for `compose` stacked on it."""
    ref_module, port_module = programs[program]
    ref_seen = recording(monkeypatch, ref_whatif)
    port_seen = recording(monkeypatch, port_whatif)
    want = ref_adv.Advisor().report(ref_module, ref.get_backend(backend))
    got = port_adv.Advisor().report(port_module, port.get_backend(backend))
    assert report_data(got) == report_data(want)
    assert port_seen == ref_seen and len(port_seen) == \
        1 + got.candidates_replayed
    want_c = ref_adv.Advisor().compose(ref_module, ref.get_backend(backend),
                                       report=want)
    got_c = port_adv.Advisor().compose(port_module,
                                       port.get_backend(backend), report=got)
    assert report_data(got_c) == report_data(want_c)
    assert port_seen == ref_seen
    assert json.dumps(port_adv.advice_section(got_c.advice, got_c)) == \
        json.dumps(ref_adv.advice_section(want_c.advice, want_c))


@pytest.mark.parametrize("program", PROGRAMS)
def test_h100_identity_replay_is_the_baseline(programs, program):
    """The port's own backend: no reference result, so the copies are held
    to the identity replay, and the advice they give replays to the
    speedup it claims."""
    module = programs[program][1]
    b = port.get_backend("nvidia_h100_sxm")
    engine = port_adv.WhatIfEngine(module, b)
    base = port_adv.profile_fingerprint(engine.baseline())
    assert port_adv.profile_fingerprint(
        engine.replay(port_adv.Identity()).profile) == base
    rep = port_adv.Advisor().report(module, b)
    assert report_data(rep) == report_data(port_adv.Advisor().report(
        module, b))
    for a in rep.advice:
        assert engine.replay(a.to_mutation()).modeled_speedup == \
            a.modeled_speedup
        assert port_adv.mutation_from_dict(a.mutation).to_dict() == \
            a.mutation


def test_rules_equal_reference():
    assert [(r.name, r.confidence) for r in port_adv.RULES] == \
        [(r.name, r.confidence) for r in ref_adv.RULES]
    for r in ref_adv.RULES:
        assert port_adv.rule_by_name(r.name).name == r.name


def _divergence_snapshot(report):
    """`tests/test_advisor_divergence.py`'s `_snapshot`."""
    top = report.top
    return {
        "rules_matched": report.rules_matched,
        "candidates_replayed": report.candidates_replayed,
        "advice_rules": [a.rule for a in report.advice],
        "top_rule": top.rule if top else None,
        "top_mutation": dict(top.mutation) if top else None,
        "top_speedup": top.modeled_speedup if top else 1.0,
        "top_confidence": top.confidence if top else None,
        "top_description": top.description if top else None,
    }


def test_advice_divergence_golden():
    """The port's reports on the 48-copy storm equal the reference's and
    the committed golden (read, never written)."""
    goldens = json.loads((GOLDENS / "advice_divergence.json").read_text())
    backends = sorted(k for k in goldens if not k.startswith("_"))
    assert backends == sorted(BACKENDS)
    module = port.parse_hlo(copy_storm_hlo(48))
    ref_module = ref.parse_hlo(copy_storm_hlo(48))
    for b in backends:
        got = _divergence_snapshot(port_adv.Advisor().report(
            module, port.get_backend(b)))
        assert got == _divergence_snapshot(ref_adv.Advisor().report(
            ref_module, ref.get_backend(b))), b
        assert got == goldens[b], b


@pytest.mark.parametrize("program", ["qwen2_loss_torch", "ptx_ring_v4"])
def test_service_advice_on_a_captured_module(programs, program):
    """`LeoService(advise=True)` on a Module the reference cannot make, on
    the port's backend: the section the advisor gives, and a JSON round
    trip."""
    module = programs[program][1]
    b = port.get_backend("nvidia_h100_sxm")
    diag = port.LeoService().diagnose(
        module, backend="nvidia_h100_sxm",
        options=port.DiagnoseOptions(advise=True))
    rep = port_adv.Advisor().report(module, b)
    assert diag.advice == port_adv.advice_section(rep.advice, rep)
    assert diag.advice["recorded"] and diag.advice["count"] >= 1
    assert port.Diagnosis.from_json(diag.to_json()).to_json() == \
        diag.to_json()
