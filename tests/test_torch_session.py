"""The port's session and service tiers (`repro_torch.core.session`,
`service`, `caching` and `hlo_parser`, verbatim copies of `repro.core`'s)
against the originals.

The input is the compiled qwen2-0.5b smoke loss's HLO text, as
`tests/test_torch_core.py` compiles it.  Each package parses it; the port's
Module must equal the reference's field by field (enums by value).  The
analyses are pure Python over the same Module, so they must be equal, not
close, and so must the `Diagnosis` payloads: a `Diagnosis` records no wall
time.  No multi-process or timing case here (ROADMAP C-watch 8).
"""
import dataclasses
import enum
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.configs import get_config, smoke_config
from repro.models import init_params, loss_fn
from test_torch_core import BACKENDS, summary, to_port

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["caching", "hlo_parser", "session", "service"]


@pytest.fixture(scope="module")
def hlo():
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jnp.zeros((4, 128), jnp.int32),
             "labels": jnp.zeros((4, 128), jnp.int32)}
    return jax.jit(lambda p, b: loss_fn(p, cfg, b, chunk=64)).lower(
        params, batch).compile().as_text()


def norm(x):
    """A Module (or any of its parts) as plain data: dataclass fields by
    name (private ones skipped), enums by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: norm(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if not f.name.startswith("_")})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


@pytest.mark.parametrize("name", COPIES)
def test_copies_are_verbatim(name):
    assert (ROOT / f"src/repro_torch/core/{name}.py").read_text() == \
        (ROOT / f"src/repro/core/{name}.py").read_text()


def test_parse_hlo_gives_the_references_module(hlo):
    got = port.parse_hlo(hlo)
    want = ref.parse_hlo(hlo)
    assert isinstance(got, port.Module)
    assert sum(1 for _ in got.all_instructions()) > 100
    assert norm(got) == norm(to_port(want))


def test_session_analysis_equals_reference(hlo):
    got = port.LeoSession().analyze(hlo, backend="nvidia_gh200")
    want = ref.LeoSession().analyze(hlo, backend="nvidia_gh200")
    assert summary(got) == summary(want)


def test_session_takes_a_captured_module():
    """What the port's driver hands the session: a Module from `capture`,
    analysed on the H100 backend, cached by identity."""
    import torch
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import smoke_config as t_smoke_config
    from repro_torch.models import init_params as t_init_params
    from repro_torch.models import loss_fn as t_loss_fn
    cfg = t_smoke_config(t_get_config("qwen2-0.5b"))
    params = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}
    module = port.capture(lambda p, b: t_loss_fn(p, cfg, b, chunk=32),
                          params, batch, device="cuda")
    session = port.LeoSession()
    an = session.analyze(module, backend="nvidia_h100_sxm")
    assert an is session.analyze(module, backend="nvidia_h100_sxm")
    assert summary(an) == summary(port.analyze_module(module,
                                                      "nvidia_h100_sxm"))
    assert session.stats.parse_calls == 0 and \
        session.stats.analyze_misses == 1


def test_compare_backends_parses_once_and_equals_reference(hlo):
    p_session, r_session = port.LeoSession(), ref.LeoSession()
    got = p_session.compare_backends(hlo, backends=BACKENDS)
    want = r_session.compare_backends(hlo, backends=BACKENDS)
    assert list(got) == list(want) == BACKENDS
    for b in BACKENDS:
        assert summary(got[b]) == summary(want[b]), b
    for s in (p_session.stats, r_session.stats):
        assert s.parse_calls == len(BACKENDS) and s.parse_misses == 1
    assert dataclasses.asdict(p_session.stats) == \
        dataclasses.asdict(r_session.stats)


def test_service_diagnosis_equals_reference(hlo):
    got = port.LeoService().diagnose(hlo, backend="tpu_v5e")
    want = ref.LeoService().diagnose(hlo, backend="tpu_v5e")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.to_markdown() == want.to_markdown()
    assert got.to_llm_context("C+L(S)") == want.to_llm_context("C+L(S)")


def test_diagnosis_migrates_a_v1_payload(hlo):
    """A v1 payload (before sync resources, issue pressure, advice,
    rewrites and occupancy) reads in both packages, with the same
    "not recorded" defaults, at the current schema."""
    payload = json.loads(port.LeoService().diagnose(
        hlo, backend="amd_mi300a").to_json())
    for key in ("sync_resources", "issue_pressure", "advice", "rewrites",
                "occupancy"):
        payload.pop(key)
    payload["schema_version"] = 1
    got = port.Diagnosis.from_json(json.dumps(payload))
    want = ref.Diagnosis.from_json(json.dumps(payload))
    assert got.schema_version == ref.SCHEMA_VERSION
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.advice == dict(ref.ADVICE_NOT_RECORDED)


@pytest.mark.parametrize("option", ["advise", "rewrite"])
def test_advise_and_rewrite_equal_reference(hlo, option):
    """`advise=True` and `rewrite=True` run the port's advisor and rewrite
    loop: the Diagnosis, its advice and rewrites sections included, is
    the reference's."""
    got = port.LeoService().diagnose(
        hlo, backend="nvidia_gh200",
        options=port.DiagnoseOptions(**{option: True}))
    want = ref.LeoService().diagnose(
        hlo, backend="nvidia_gh200",
        options=ref.DiagnoseOptions(**{option: True}))
    assert got.to_json() == want.to_json()
    section = got.advice if option == "advise" else got.rewrites
    assert section["recorded"]
    assert got.to_markdown() == want.to_markdown()


def test_caches_equal_reference(tmp_path):
    """The LRU tier evicts in the reference's order; the disk tier stores
    and reloads a Diagnosis under its content key."""
    evicted = {p: [] for p in ("port", "ref")}
    for name, m in (("port", port), ("ref", ref)):
        cache = m.LRUCache(2, on_evict=lambda k, v, n=name:
                           evicted[n].append(k))
        for k in "abcab":
            cache[k] = k.upper()
            cache.get("a")
        assert cache.evictions == 2
    assert evicted["port"] == evicted["ref"] == ["b", "c"]
    payload = ref.Diagnosis(backend="tpu_v5e", module_name="m")
    disk = port.DiskCache(str(tmp_path))
    disk.store_diagnosis("k", port.Diagnosis.from_json(payload.to_json()))
    assert json.loads(disk.load_diagnosis("k").to_json()) == \
        json.loads(payload.to_json())
