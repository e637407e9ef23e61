"""The port's rules, checked: it imports nothing of JAX or of `repro`, its
entry points default to the card, a kernel wrapper given a non-CPU tensor
builds and launches its kernel or raises (never the plain path), no library
kernel stands in for a hand-written one, and the copied config table equals
the reference's."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_jax_or_reference_in_sys_modules():
    """Import the port, run one CPU forward and one CPU serve tick, capture
    the CUDA program of the smoke loss and diagnose it, advise on it and
    close the rewrite loop, serve one request over HTTP, and take one
    train step from the port's data pipeline, in a fresh interpreter, and
    look at what got imported."""
    code = """
import sys, torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_params, forward
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.runtime import make_prefill_step
import repro_torch.kernels.ops
cfg = smoke_config(get_config("qwen2-0.5b"))
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
logits = make_prefill_step(cfg, device="cpu")(params, {"tokens": [[1, 2, 3]]})
assert logits.shape == (1, 3, cfg.vocab_size)
engine = ServeEngine(cfg, params, 2, 16, device="cpu")
engine.submit(Request(0, [5, 6], 2))
engine.tick()
cfg = smoke_config(get_config("hymba-1.5b"))
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
assert forward(params, cfg, torch.tensor([[1, 2, 3]]))[0].shape == \
    (1, 3, cfg.vocab_size)
engine = ServeEngine(cfg, params, 2, 16, device="cpu")
engine.submit(Request(0, [5, 6], 2))
engine.tick()
cfg = smoke_config(get_config("xlstm-125m"))
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
assert forward(params, cfg, torch.tensor([[1, 2, 3]]))[0].shape == \
    (1, 3, cfg.vocab_size)
engine = ServeEngine(cfg, params, 2, 16, device="cpu")
engine.submit(Request(0, [5, 6], 2))
engine.tick()
from repro_torch.core import analyze_module, capture
from repro_torch.models import loss_fn
cfg = smoke_config(get_config("qwen2-0.5b"))
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
         "labels": torch.zeros((2, 64), dtype=torch.long)}
module = capture(lambda p, b: loss_fn(p, cfg, b, chunk=32), params, batch,
                 device="cuda")
assert module.kernel_calls["flash_attention"] == cfg.n_layers
an = analyze_module(module, "nvidia_h100_sxm")
assert an.estimated_step_seconds > 0 and an.chains
from repro_torch.core import AnalyzeRequest, DiagnoseOptions, LeoService
diag = LeoService().diagnose(
    module, backend="nvidia_h100_sxm",
    options=DiagnoseOptions(advise=True, rewrite=True))
assert diag.advice["recorded"] and diag.rewrites["recorded"]
from repro_torch.launch.analysis_server import copy_storm_hlo
from repro_torch.serve import LeoClient, LeoHttpd
with LeoHttpd(port=0, slots=1) as app:
    with LeoClient(port=app.port, timeout=30.0, max_retries=1) as client:
        served = client.submit(AnalyzeRequest(
            hlo_text=copy_storm_hlo(), backend="nvidia_h100_sxm",
            options=DiagnoseOptions(advise=True, rewrite=True)))
assert served.advice["recorded"] and served.rewrites["recorded"]
assert not torch.cuda.is_initialized()
from repro_torch.data import (DataPipeline, SyntheticConfig,
                              SyntheticTokenDataset)
from repro_torch.runtime import TrainOptions, init_train_state, make_train_step
state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
pipe = DataPipeline(SyntheticTokenDataset(SyntheticConfig(cfg.vocab_size, 32)),
                    2, device="cpu")
state, metrics = make_train_step(cfg, options=TrainOptions(chunk=32))(
    state, pipe.device_batch(0))
assert int(state["step"]) == 1 and metrics["loss"].isfinite()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


# the driver's tiers: the checkpoints, fault handling, the train driver,
# the session and service copies, and the examples
DRIVER_MODULES = ["checkpoint/__init__.py", "checkpoint/checkpointer.py",
                  "checkpoint/manager.py", "runtime/fault.py",
                  "launch/train.py", "core/caching.py", "core/hlo_parser.py",
                  "core/session.py", "core/service.py",
                  "examples/__init__.py", "examples/quickstart.py",
                  "examples/serve_demo.py"]

# LEO's upper tiers: the advisor, the rewrite loop, the analysis server
UPPER_TIERS = ["advisor/whatif.py", "advisor/rules.py", "advisor/advisor.py",
               "advisor/__init__.py", "rewrite/printer.py",
               "rewrite/rewriters.py", "rewrite/loop.py",
               "rewrite/__init__.py", "serve/protocol.py",
               "serve/metrics.py", "launch/analysis_server.py",
               "serve/httpd.py", "serve/client.py", "serve/pool.py",
               "serve/__init__.py", "examples/rewrite_demo.py",
               "examples/analysis_client_demo.py"]


def test_no_jax_or_reference_in_the_driver_tiers(tmp_path):
    """Train two smoke steps through the driver with a checkpoint, resume
    one more with `--restore` and `--analyze`, diagnose through
    `LeoService`, and run the serve demo, in a fresh interpreter, and look
    at what got imported."""
    code = f"""
import sys
from repro_torch.launch.train import main
main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
      "--seq", "16", "--checkpoint-dir", {str(tmp_path)!r}])
res = main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--checkpoint-dir", {str(tmp_path)!r},
            "--restore", "--analyze"])
assert res["steps"] == 1 and res["leo_step_seconds"] > 0
from repro_torch.core import LeoService, capture
from repro_torch.launch.train import build
_, state, pipe, step = build("qwen2-0.5b", True, 2, 16, "cpu")
module = capture(step, state, pipe.device_batch(0), device="cpu")
assert LeoService().diagnose(module, backend="nvidia_h100_sxm").to_json()
import repro_torch.runtime.fault, repro_torch.core.hlo_parser
from repro_torch.examples import serve_demo
serve_demo.main(["--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


# the multi-device layer and the dry run
MESH_TIERS = ["parallel/__init__.py", "parallel/context.py",
              "parallel/sharding.py", "parallel/spmd.py", "launch/mesh.py",
              "launch/specs.py", "launch/dryrun.py", "runtime/steps.py",
              "checkpoint/manager.py", "launch/train.py",
              "launch/hillclimb.py"]


def test_no_jax_or_reference_in_the_dry_run(tmp_path):
    """Sweep the dry run over two configs' decode and long-context cells
    on both production meshes (each a per-device program captured behind a
    fake process group, at one layer: a capture of every cell takes
    minutes), capture the smoke train step's per-device program on a fake
    (2, 2) mesh, lower a smoke cell on the CPU's own mesh, and run the
    expert-parallel MoE and sequence parallelism on it, in a fresh
    interpreter, and look at what got imported."""
    code = f"""
import sys, torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
try:
    dryrun.main(["--arch", "qwen2-0.5b,phi3.5-moe-42b-a6.6b", "--shape",
                 "decode_32k,long_500k", "--mesh", "both", "--layers", "1",
                 "--device", "cpu", "--outdir", {str(tmp_path)!r}])
except SystemExit as e:
    assert e.code == 0
from repro_torch.configs import ShapeConfig, get_config, smoke_config
with fake_mesh(("data", "model"), (2, 2)) as mesh:
    module, _, _ = dryrun.lower_cell(
        smoke_config(get_config("qwen2-0.5b")),
        ShapeConfig("t", 32, 4, "train"), mesh)
    assert any(i.op_class.value == "collective"
               for i in module.all_instructions())
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import forward, init_params
from repro_torch.models.flags import flags
from repro_torch.parallel.context import mesh_context
cfg = smoke_config(get_config("phi3.5-moe-42b-a6.6b"))
mesh = make_host_mesh(1, device="cpu")
with flags(moe_impl="ep_shardmap", sequence_parallel=True):
    module, memory, _ = dryrun.lower_cell(
        cfg, ShapeConfig("p", 32, 2, "prefill"), mesh)
    assert module.total_flops() > 0 and memory["argument_size_in_bytes"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with mesh_context(mesh), torch.no_grad():
        assert forward(params, cfg, torch.zeros((1, 8), dtype=torch.long)
                       )[0].isfinite().all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_no_forbidden_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {PORT / m for m in DRIVER_MODULES + UPPER_TIERS + MESH_TIERS} \
        <= set(files)
    for path in files:
        bad = [m for m in _imports(path) if _forbidden(m)]
        assert not bad, (path, bad)


def test_no_library_kernel_in_the_port():
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for word in ("scaled_dot_product_attention", "rms_norm(",
                     "torch.compile", "cpp_extension", "flash_attn",
                     "xformers", "cudnn"):
            assert word not in text, (path, word)


def test_entry_points_default_to_the_card():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import init_decode_state, init_params
    cfg = smoke_config(get_config("qwen2-0.5b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert ServeEngine(cfg, params).device.type == "cuda"
        return
    # no card here: asking for the default device must fail, not run on CPU
    with pytest.raises((RuntimeError, AssertionError)):
        ServeEngine(cfg, params)
    with pytest.raises((RuntimeError, AssertionError)):
        init_decode_state(cfg, 1, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        init_params(cfg)
    from repro_torch.data import (DataPipeline, SyntheticConfig,
                                  SyntheticTokenDataset)
    from repro_torch.runtime import init_train_state
    with pytest.raises((RuntimeError, AssertionError)):
        init_train_state(cfg)
    pipe = DataPipeline(SyntheticTokenDataset(SyntheticConfig(256, 8)), 2)
    with pytest.raises((RuntimeError, AssertionError)):
        pipe.device_batch(0)


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """An empty build directory and no CUDA toolkit to be found."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    _build.library.cache_clear()
    yield _build
    _build.library.cache_clear()


def test_build_without_nvcc_raises(no_nvcc):
    with pytest.raises(no_nvcc.BuildError, match="nvcc not found"):
        no_nvcc.build()
    assert not (no_nvcc.BUILD_DIR).exists()


@pytest.mark.parametrize("kernel", ["flash_attention", "rmsnorm_pipelined",
                                    "rmsnorm_baseline", "ssm_scan",
                                    "ssm_scan_fused", "mlstm_chunkwise",
                                    "slstm_scan"])
def test_wrapper_off_cpu_raises_instead_of_plain(no_nvcc, kernel):
    from repro_torch.kernels import ops
    fn = ops.KERNELS[kernel]
    before = fn.launches
    if kernel == "flash_attention":
        args = [torch.empty((1, 64, 4, 16), device="meta")] * 3
    elif kernel == "ssm_scan":
        args = [torch.empty((2, 64, 256, 16), device="meta")] * 2 + \
            [torch.empty((2, 64, 16), device="meta")]
    elif kernel == "ssm_scan_fused":
        args = [torch.empty((2, 64, 256), device="meta"),
                torch.empty((256,), device="meta"),
                torch.empty((256, 16), device="meta")] + \
            [torch.empty((2, 64, 16), device="meta")] * 2
    elif kernel == "mlstm_chunkwise":
        args = [torch.empty((2, 128, 4, 192), device="meta")] * 3 + \
            [torch.empty((2, 128, 4), device="meta")] * 2
    elif kernel == "slstm_scan":
        args = [torch.empty((2, 64, 3072), device="meta"),
                torch.empty((768, 3072), device="meta")]
    else:
        args = [torch.empty((8, 896), device="meta"),
                torch.empty((896,), device="meta")]
    with pytest.raises(no_nvcc.BuildError):
        fn(*args)
    assert fn.launches == before


def test_ptx_without_nvcc_raises(no_nvcc):
    with pytest.raises(no_nvcc.BuildError, match="nvcc not found"):
        no_nvcc.ptx("rmsnorm.cu")
    assert not (no_nvcc.BUILD_DIR).exists()


def test_library_name_follows_sources(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two")
    assert _build.library_path() != first


def test_build_log_is_keyed_like_its_library(monkeypatch, tmp_path):
    """Phase 2 reads the ptxas report of the library it loaded, not the
    last build's in the same directory."""
    from repro_torch.kernels import _build
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.log_path()
    assert first.parent == _build.library_path().parent
    assert first.stem == _build.library_path().stem
    (src / "a.cu").write_text("// two")
    assert _build.log_path() != first
    assert _build.log_path().stem == _build.library_path().stem


def test_config_tables_equal_reference():
    """The port's copy of the architecture table cannot drift."""
    import repro.configs as j
    import repro_torch.configs as t
    assert [c.name for c in t.ALL_ARCHS] == [c.name for c in j.ALL_ARCHS]
    for jc, tc in zip(j.ALL_ARCHS, t.ALL_ARCHS):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), jc.name
        assert dataclasses.asdict(t.smoke_config(tc)) == \
            dataclasses.asdict(j.smoke_config(jc))
        assert tc.param_count() == jc.param_count()
        assert tc.block_kinds == jc.block_kinds
    for name in j.SHAPES:
        assert dataclasses.asdict(t.get_shape(name)) == \
            dataclasses.asdict(j.get_shape(name))


SHIMS = sorted(p.name for p in (ROOT / "src" / "repro" / "configs").glob(
    "*.py") if p.name not in ("__init__.py", "base.py", "lm_archs.py"))


@pytest.mark.parametrize("name", SHIMS)
def test_config_shim_equals_reference(name):
    """`configs/<arch>.py`: the reference's shim, file for file, whose
    `CONFIG` is the same architecture as the reference's."""
    import importlib
    mod = name[:-3]
    ref = importlib.import_module(f"repro.configs.{mod}")
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    assert dataclasses.asdict(port.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert (PORT / "configs" / name).read_text() == \
        (ROOT / "src" / "repro" / "configs" / name).read_text()


def test_configs_match_the_reference_file_for_file():
    ref = sorted(p.name for p in (ROOT / "src" / "repro" / "configs"
                                  ).glob("*.py"))
    assert sorted(p.name for p in (PORT / "configs").glob("*.py")) == ref
    assert len(SHIMS) == 10
