"""hillclimb's what-if and rewrite lanes in the port (`repro_torch.launch.
hillclimb`, a copy of the reference's model-only half) and the two examples
that need only that lane, against the reference, on the CPU.

Everything here is host-side Python over the same HLO text, so results are
held equal, not close: each backend's mutation space, the seeded blind and
advisor-guided searches on the 48-copy storm (every GPU-vendor backend,
seed 0, budget 16), the rewrite loop's report, `advisor_demo --smoke`'s
output line for line, and `crossvendor_divergence`'s fixture demos row
for row (the port prints one more row, its own `nvidia_h100_sxm`).  The
example's embedding MLP is a torch function captured on fake tensors; its
MATMUL FLOPs equal the reference's `from_function(kernel)` Module's to
1e-9 relative (a small table: the products do not depend on its rows).
"""
import contextlib
import importlib.util
import inspect
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import repro.core as ref_core
import repro.launch.hillclimb as ref_hc
import repro_torch.core as port_core
import repro_torch.launch.hillclimb as port_hc
from repro.launch.analysis_server import copy_storm_hlo
from repro_torch.examples import advisor_demo, crossvendor_divergence
from test_torch_frontend import class_flops

ROOT = Path(__file__).resolve().parent.parent
BACKENDS = ["amd_mi300a", "intel_pvc", "nvidia_gh200", "tpu_v5e", "tpu_v5p",
            "tpu_v4"]
GPU_VENDOR_BACKENDS = ("nvidia_gh200", "amd_mi300a", "intel_pvc")
COPIED = ("mutation_space", "whatif_search", "run_whatif", "run_rewrite")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_the_reference(name):
    want = re.sub(r"\brepro\.", "repro_torch.",
                  inspect.getsource(getattr(ref_hc, name)))
    assert inspect.getsource(getattr(port_hc, name)) == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutation_space_equals_reference(backend):
    port = [m.to_dict() for m in port_hc.mutation_space(
        port_core.get_backend(backend))]
    ref = [m.to_dict() for m in ref_hc.mutation_space(
        ref_core.get_backend(backend))]
    assert port and port == ref


def test_mutation_space_on_the_h100_covers_every_kind_family():
    kinds = {m.kind for m in port_hc.mutation_space(
        port_core.get_backend("nvidia_h100_sxm"))}
    assert {"ResizePool", "CoalesceSyncTags", "PipelineAsyncChain",
            "TreeReduceChain", "SetIssue", "ScaleLatency"} <= kinds


@pytest.fixture(scope="module")
def searches():
    """Blind, then guided chasing the blind best, as the reference's
    `TestGuidedHillclimb` runs them, in both packages."""
    text = copy_storm_hlo(48)
    out = {}
    for pkg, hc, core in (("port", port_hc, port_core),
                          ("ref", ref_hc, ref_core)):
        module = core.parse_hlo(text)
        for name in GPU_VENDOR_BACKENDS:
            backend = core.get_backend(name)
            blind = hc.whatif_search(module, backend, mode="blind",
                                     budget=16, seed=0)
            guided = hc.whatif_search(module, backend, mode="guided",
                                      budget=16, seed=0,
                                      target_speedup=blind["best_speedup"])
            out[pkg, name] = {"blind": blind, "guided": guided}
    return out


@pytest.mark.parametrize("mode", ["blind", "guided"])
@pytest.mark.parametrize("backend", GPU_VENDOR_BACKENDS)
def test_whatif_search_equals_reference(searches, backend, mode):
    port, ref = searches["port", backend][mode], searches["ref", backend][mode]
    for key in ("history", "best_speedup", "evaluations",
                "evaluations_to_best", "best", "baseline_makespan_cycles"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("backend", GPU_VENDOR_BACKENDS)
def test_guided_reaches_blind_best_in_half_the_evals(searches, backend):
    blind, guided = (searches["port", backend][m]
                     for m in ("blind", "guided"))
    assert guided["best_speedup"] >= blind["best_speedup"]
    assert guided["evaluations"] <= blind["evaluations"] / 2
    assert guided["evaluations"] * 2 <= blind["evaluations_to_best"] + 1


def test_seeded_blind_search_is_reproducible():
    module = port_core.parse_hlo(copy_storm_hlo(8))
    backend = port_core.get_backend("nvidia_h100_sxm")
    a = port_hc.whatif_search(module, backend, mode="blind", budget=6,
                              seed=7)
    b = port_hc.whatif_search(module, backend, mode="blind", budget=6,
                              seed=7)
    assert a["history"] == b["history"]
    c = port_hc.whatif_search(module, backend, mode="blind", budget=6,
                              seed=8)
    assert [h["mutation"] for h in c["history"]] != \
        [h["mutation"] for h in a["history"]]


def _timeless(obj):
    """`obj` without the wall times it records (keys `*_seconds`)."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if not k.endswith("_seconds")}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


@pytest.mark.parametrize("backend", ["nvidia_gh200", "intel_pvc"])
def test_run_whatif_equals_reference(backend, tmp_path):
    port, port_text = _printed(lambda: port_hc.run_whatif(
        backend, budget=8, seed=0, n_copies=12))
    ref, ref_text = _printed(lambda: ref_hc.run_whatif(
        backend, budget=8, seed=0, n_copies=12))
    assert _timeless(port) == _timeless(ref)
    assert port_text == ref_text


@pytest.mark.parametrize("backend", ["nvidia_gh200", "amd_mi300a",
                                     "intel_pvc"])
def test_run_rewrite_equals_reference(backend):
    port, port_text = _printed(lambda: port_hc.run_rewrite(backend))
    ref, ref_text = _printed(lambda: ref_hc.run_rewrite(backend))
    assert _timeless(port) == _timeless(ref)
    assert port_text == ref_text


def test_main_lanes(tmp_path, capsys):
    port_hc.main(["--whatif", "--backend", "nvidia_h100_sxm", "--budget",
                  "4", "--copies", "8", "--outdir", str(tmp_path)])
    port_hc.main(["--rewrite", "--backend", "nvidia_h100_sxm", "--copies",
                  "8", "--outdir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "rewrite__nvidia_h100_sxm.json", "whatif__nvidia_h100_sxm__s0.json"]
    text = capsys.readouterr().out
    assert "[whatif:guided] nvidia_h100_sxm best" in text
    assert "[rewrite:nvidia_h100_sxm]" in text
    # --cell on a production mesh: one specs_only record a variant
    cells = tmp_path / "cells"
    port_hc.main(["--cell", "hymba", "--outdir", str(cells)])
    names = [name for name, _, _ in port_hc.CELLS["hymba"]["variants"]]
    assert sorted(p.name for p in cells.iterdir()) == sorted(
        f"hymba-1.5b__train_4k__{name}.json" for name in names)
    for name in names:
        rec = json.loads((cells / f"hymba-1.5b__train_4k__{name}.json"
                          ).read_text())
        assert rec["status"] == "specs_only" and rec["variant"] == name
        assert rec["chips"] == 256 and "no partitioner" in rec["reason"]


# the reference's flag values in the port's: K1 is "kernel" where the
# reference says "pallas_fused"; the port's default attention is "kernel",
# so a variant that leaves it unset in the reference sets "plain"
ATTENTION = {"pallas_fused": "kernel", "xla": "plain"}


def _port_flags(ref_flags):
    flags = dict(ref_flags)
    flags["attention_impl"] = ATTENTION[flags.get("attention_impl", "xla")]
    return flags


def test_cells_are_the_references():
    assert list(port_hc.CELLS) == list(ref_hc.CELLS)
    for cell, ref in ref_hc.CELLS.items():
        port = port_hc.CELLS[cell]
        assert (port["arch"], port["shape"]) == (ref["arch"], ref["shape"])
        assert [(name, flags, opts) for name, flags, opts in
                port["variants"]] == [
            (name, _port_flags(flags), opts)
            for name, flags, opts in ref["variants"]], cell
    plain = [(cell, name) for cell, spec in port_hc.CELLS.items()
             for name, flags, _ in spec["variants"]
             if flags["attention_impl"] == "plain"]
    assert plain == [("qwen2", "baseline"), ("hymba", "baseline"),
                     ("hymba", "ssm_fused"), ("dsv2", "baseline"),
                     ("dsv2", "ep_shardmap")]


# the keys of the reference's record (`repro/launch/hillclimb.py:110-122`)
# and of its `leo` part with the length each list is cut to
RECORD_KEYS = {"label", "variant", "flags", "options", "compile_seconds",
               "roofline", "leo"}
LEO_CUTS = {"top_stalls": 3, "root_causes": 5, "self_blame": 3,
            "recommendations": 4}
# one variant of each cell that sets every flag the cell uses
RUN_VARIANTS = [("qwen2", "flash+mb1+remat_none"),
                ("hymba", "ssm_pallas+flash"),
                ("dsv2", "ep+flash+save_moe")]


@pytest.mark.parametrize("cell,variant", RUN_VARIANTS)
def test_run_variant_records_the_references_keys(cell, variant, tmp_path):
    """`run_variant` on `--mesh host --device cpu` at a smoke config (qwen2
    and hymba cut to one layer; deepseek-v2's one MoE layer is its second)
    and a small train shape, two micro-batches (one `while`
    of 2 trips, unless the variant sets its own): the reference's record
    plus `memory`, `microbatch`, the kernel regions and the cut; `single`
    writes specs_only."""
    from repro_torch.configs import ShapeConfig, get_config, smoke_config
    spec = port_hc.CELLS[cell]
    name, flags, opts = next(v for v in spec["variants"] if v[0] == variant)
    cfg = smoke_config(get_config(spec["arch"]))
    opts = {"microbatch": 2, **opts}
    layers = None if cell == "dsv2" else 1
    # 16 rows: the single-pod mesh's 16-way data axis divides them
    shape = ShapeConfig("train_16x64", 64, 16, "train")
    rec = port_hc.run_variant(cfg, shape, name, flags, opts, "host",
                              str(tmp_path), hw_name="nvidia_h100_sxm",
                              device="cpu", layers=layers)
    label = f"{cfg.name}__train_16x64__{name}"
    assert json.loads((tmp_path / f"{label}.json").read_text()) == rec
    assert set(rec) == RECORD_KEYS | {"memory", "microbatch",
                                      "kernel_regions", "instructions"} | (
        {"reduced"} if layers else set())
    assert rec["instructions"] > 0
    assert rec["kernel_regions"] == {}  # CPU tensors take the plain paths
    assert (rec["label"], rec["variant"], rec["flags"], rec["options"]) == \
        (label, name, flags, opts)
    assert rec["microbatch"] == opts["microbatch"]
    assert rec.get("reduced") == (
        [f"n_layers {cfg.n_layers} -> 1"] if layers else None)
    assert rec["compile_seconds"] > 0 and rec["roofline"]["hlo_flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert set(rec["leo"]) == set(LEO_CUTS) | {"estimated_step_seconds"}
    assert rec["leo"]["estimated_step_seconds"] > 0
    assert rec["leo"]["top_stalls"] and rec["leo"]["root_causes"]
    for key, cut in LEO_CUTS.items():
        assert len(rec["leo"][key]) <= cut, key
    single = port_hc.run_variant(cfg, shape, name, flags, opts,
                                 "single", str(tmp_path / "single"),
                                 hw_name="nvidia_h100_sxm", layers=layers)
    assert single["status"] == "specs_only" and single["variant"] == name
    assert single["label"] == label and single["flags"] == flags


def test_advisor_demo_smoke_equals_reference():
    ref = _reference_example("advisor_demo")
    ref_rc, ref_text = _printed(ref.main, ["--smoke"])
    port_rc, port_text = _printed(advisor_demo.main, ["--smoke"])
    assert port_rc == ref_rc == 0
    assert port_text.splitlines() == ref_text.splitlines()
    assert "advisor demo OK" in port_text


def _rows(text, extra="nvidia_h100_sxm"):
    """The printed lines, the port's own backend's rows set apart."""
    lines = text.splitlines()
    return ([line for line in lines if not line.startswith(extra)],
            [line for line in lines if line.startswith(extra)])


@pytest.mark.parametrize("demo", ["copy_storm_demo", "wide_ops_demo",
                                  "occupancy_demo", "advice_demo"])
def test_crossvendor_fixture_demos_equal_reference(demo):
    ref = _reference_example("crossvendor_divergence")
    ref_service, port_service = ref_core.LeoService(), port_core.LeoService()
    _, ref_text = _printed(getattr(ref, demo), ref_service)
    _, port_text = _printed(getattr(crossvendor_divergence, demo),
                            port_service)
    rows, extra = _rows(port_text)
    assert rows == ref_text.splitlines()
    assert len(extra) == 1  # nvidia_h100_sxm, which the reference lacks
    assert port_service.stats.parse_misses == 1  # one parse, every backend


def test_crossvendor_main_fans_one_capture_across_every_backend(
        monkeypatch):
    made = []

    class Recording(port_core.LeoService):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_core, "LeoService", Recording)
    _, text = _printed(crossvendor_divergence.main)
    service, = made
    backends = [b.name for b in service.session.backends]
    assert text.startswith("captured once (")
    for name in backends:
        assert any(line.startswith(name) for line in text.splitlines())
    # the fixture texts: copy_storm_hlo(12) twice, wide_ops_hlo, the
    # 48-copy storm; each parsed once however many backends read it
    assert service.stats.parse_misses == 3


def test_captured_mlp_flops_equal_reference():
    ref = _reference_example("crossvendor_divergence")
    rows, dim, hidden = 1000, crossvendor_divergence.DIM, \
        crossvendor_divergence.HIDDEN
    key = jax.random.PRNGKey(0)
    jm = ref_core.from_function(
        ref.kernel, jnp.zeros((rows, dim), jnp.bfloat16),
        jax.random.randint(key, (crossvendor_divergence.INDICES,), 0, rows),
        jnp.zeros((dim, hidden), jnp.bfloat16),
        jnp.zeros((hidden, dim), jnp.bfloat16))
    want = class_flops(jm, "matmul")
    assert want == 2 * 2 * crossvendor_divergence.INDICES * dim * hidden
    port = crossvendor_divergence.capture_kernel(rows=rows)
    assert class_flops(port, "matmul") == pytest.approx(want, rel=1e-9)
    # the demo's own size allocates nothing: the same products
    full = crossvendor_divergence.capture_kernel()
    assert class_flops(full, "matmul") == pytest.approx(want, rel=1e-9)


def test_lanes_and_examples_import_no_jax(tmp_path):
    code = f"""
import sys
from repro_torch.launch.hillclimb import main
main(["--whatif", "--backend", "nvidia_h100_sxm", "--budget", "4",
      "--copies", "8", "--outdir", {str(tmp_path)!r}])
main(["--rewrite", "--backend", "nvidia_h100_sxm", "--copies", "8",
      "--outdir", {str(tmp_path)!r}])
from repro_torch.examples import advisor_demo, crossvendor_divergence
assert advisor_demo.main(["--smoke"]) == 0
crossvendor_divergence.capture_kernel()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
