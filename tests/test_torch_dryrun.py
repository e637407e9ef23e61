"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro/launch/dryrun.py`), which no test imports: importing it sets
`XLA_FLAGS` to 512 host devices.  What is compared with it is read from its
source (`_parse_flags`, executed alone; the `long_500k` skip record) or
computed with the modules it calls (`repro.parallel.sharding`,
`repro.launch.specs`).

* `lower_cell` on smoke configs on a CPU `(1, 1)` mesh: the same Module as
  a direct `capture` of the step on real CPU tensors (instructions, FLOPs,
  bytes), the per-device argument bytes the real arguments' `nbytes`, the
  output bytes the real outputs', temp and code sizes absent.
* each argument tree's bytes a device on both production meshes, for
  every config and shape, equal to the reference specs' (each leaf's bytes
  over the product of the mesh axes its spec names), and the reference's
  skip record for `long_500k`; `--mesh both` over qwen2-0.5b's cells at
  one layer: `ok` records with a program, collectives and those bytes.
* A production mesh with nothing behind it has no program: `lower_cell`
  raises; behind a fake process group it captures rank 0's program.
"""
import ast
import inspect
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.utils._pytree import tree_leaves, tree_map

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import shapes_for as j_shapes_for
from repro.launch import specs as JS
from repro.parallel.sharding import ShardingRules as JRules
from repro_torch.configs import ShapeConfig, get_config, shapes_for, \
    smoke_config
from repro_torch.core import capture
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.flags import flags
from repro_torch.parallel.context import mesh_context
from repro_torch.runtime import TrainOptions, init_train_state

ROOT = Path(__file__).resolve().parent.parent
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
ARCHS = [c.name for c in J_ARCHS]


def _ref_function(name):
    """A top-level function of the reference's dryrun.py, compiled from its
    source alone (the module is not imported)."""
    tree = ast.parse(REF_DRYRUN.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {}
    exec(compile(ast.Module([node], []), str(REF_DRYRUN), "exec"),
         namespace)
    return namespace[name], ast.get_source_segment(REF_DRYRUN.read_text(),
                                                   node)


@pytest.mark.parametrize("spec", [
    "", "attention_impl=pallas_fused,ssm_fused=true,ssm_pallas=TRUE",
    "moe_impl=ep_shardmap, fsdp_threshold_mb=512", "sequence_parallel=false",
    ",,a=1,b=x,", "c=-3,d= 4 "])
def test_parse_flags_is_the_reference(spec):
    ref, source = _ref_function("_parse_flags")
    assert dryrun._parse_flags(spec) == ref(spec)
    assert inspect.getsource(dryrun._parse_flags) == source + "\n"


def test_long_context_skip_record_is_the_reference(tmp_path):
    """The reference's record for long_500k on an arch without long
    context, as its source writes it."""
    tree = ast.parse(REF_DRYRUN.read_text())
    reason = next(
        ast.literal_eval(v) for n in ast.walk(tree)
        if isinstance(n, ast.Dict)
        for k, v in zip(n.keys, n.values)
        if isinstance(k, ast.Constant) and k.value == "reason"
        and "quadratic" in ast.unparse(v))
    got = dryrun.run_cell("qwen2-0.5b", "long_500k", "single",
                          str(tmp_path))
    assert got == {"label": "qwen2-0.5b__long_500k__single",
                   "status": "skipped", "reason": reason}
    assert json.loads((tmp_path / (got["label"] + ".json")).read_text()) \
        == got


def _ref_bytes(jc, shape, mesh_shape):
    """The reference specs' bytes a device for each argument tree of the
    cell: each leaf's bytes over the product of the mesh axes its spec
    names."""
    class FakeMesh:
        shape = mesh_shape
        axis_names = tuple(mesh_shape)

    rules = JRules(FakeMesh(), jc)
    inputs = JS.input_specs(jc, shape)

    def tree_bytes(tree, specs):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(spec_leaves)
        total = 0
        for leaf, spec in zip(leaves, spec_leaves):
            ways = 1
            for e in spec:
                for a in (e if isinstance(e, tuple) else (e,)):
                    ways *= mesh_shape[a] if a is not None else 1
            total += math.prod(leaf.shape) * leaf.dtype.itemsize // ways
        return total

    bspecs = rules.batch_specs(jc, shape)
    if shape.kind == "train":
        st = inputs["state"]
        return {"params": tree_bytes(st["params"],
                                     rules.param_specs(st["params"])),
                "opt": tree_bytes(st["opt"], rules.opt_specs(
                    st["opt"], st["params"])),
                "step": tree_bytes(st["step"], JP()),
                "batch": tree_bytes(inputs["batch"], bspecs)}
    out = {"params": tree_bytes(inputs["params"],
                                rules.param_specs(inputs["params"]))}
    if shape.kind == "decode":
        out["decode_state"] = tree_bytes(
            inputs["decode_state"],
            rules.decode_state_specs(inputs["decode_state"], shape))
    out["batch"] = tree_bytes(inputs["batch"], bspecs)
    return out


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """`main(["--arch", "qwen2-0.5b", "--shape", "decode_32k,long_500k",
    "--mesh", "both", "--layers", "1", "--device", "cpu"])`: the decode
    cell's per-device program on both production meshes, captured at full
    width on one layer, and the long-context skip.  A capture on the CPU
    costs seconds a layer, a minute for a prefill_32k cell's: the sweep of
    every cell is a tool's run (`PERF.md`), and `tests/
    test_torch_dryrun_mesh.py` captures train_4k."""
    out = tmp_path_factory.mktemp("dryrun")
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", SWEPT, "--mesh",
                     "both", "--layers", "1", "--device", "cpu",
                     "--hw", "nvidia_h100_sxm", "--outdir", str(out)])
    assert done.value.code == 0
    return out


SWEPT = "decode_32k,long_500k"
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _production_mesh(name):
    return make_production_mesh(multi_pod=(name == "multi"))


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference(arch, tmp_path):
    """Each argument tree's bytes a device on each production mesh, as the
    dry run's records give them (`dryrun.argument_bytes`, the uncut cell
    under the specs), against the reference specs'; and the reference's
    skip record for long_500k where the arch has no long context."""
    from repro_torch.launch import specs
    jc = J_ARCHS[ARCHS.index(arch)]
    cfg = get_config(arch)
    names = [s.name for s in j_shapes_for(jc)]
    for shape in j_shapes_for(jc):
        inputs = specs.input_specs(cfg, next(
            s for s in shapes_for(cfg) if s.name == shape.name))
        for mesh, mesh_shape in MESHES.items():
            got = dryrun.argument_bytes(cfg, shape, _production_mesh(mesh),
                                        inputs)
            assert got == _ref_bytes(jc, shape, mesh_shape), (shape, mesh)
    if "long_500k" not in names:
        for mesh in MESHES:
            rec = dryrun.run_cell(arch, "long_500k", mesh, str(tmp_path))
            assert rec["status"] == "skipped"


def test_production_cells_have_programs(sweep):
    """qwen2-0.5b's decode cells: `ok` records whose argument bytes are
    the reference specs', with a collective term above 0 (the cell shards
    its weights over an axis of 16), and the skip record of long_500k."""
    jc = J_ARCHS[ARCHS.index("qwen2-0.5b")]
    for shape in j_shapes_for(jc):
        if shape.name not in SWEPT:
            continue
        for mesh, mesh_shape in MESHES.items():
            rec = json.loads((sweep / f"qwen2-0.5b__{shape.name}__{mesh}"
                                      f".json").read_text())
            n = math.prod(mesh_shape.values())
            assert rec["status"] == "ok" and rec["chips"] == n
            assert rec["reduced"] == ["n_layers 24 -> 1"]
            assert rec["argument_bytes"] == _ref_bytes(jc, shape,
                                                       mesh_shape)
            total = sum(rec["argument_bytes"].values())
            assert rec["argument_bytes_total"] == total
            assert rec["fits"] == (total <= rec["hbm_bytes"])
            rl = rec["roofline"]
            assert rl["chips"] == n and rl["collective_bytes"] > 0
            assert rl["collective_s"] > 0 and rl["hlo_flops"] > 0
            assert rec["memory"]["temp_size_in_bytes"] is None
    for mesh in MESHES:
        rec = json.loads((sweep / f"qwen2-0.5b__long_500k__{mesh}.json"
                          ).read_text())
        assert rec["status"] == "skipped"


def test_train_4k_bytes_a_device():
    """train_4k's params + optimizer state + batch a device under the
    reference's specs: qwen2-0.5b 0.185 / 0.160 GiB, phi3.5-moe 2.494 /
    1.329, deepseek-v2 12.974 / 6.908 (single / multi)."""
    from repro_torch.configs import get_shape
    from repro_torch.launch import specs
    want = {"qwen2-0.5b": (0.185, 0.160),
            "phi3.5-moe-42b-a6.6b": (2.494, 1.329),
            "deepseek-v2-236b": (12.974, 6.908)}
    shape = get_shape("train_4k")
    for arch, gib in want.items():
        cfg = get_config(arch)
        inputs = specs.input_specs(cfg, shape)
        for mesh, expect in zip(("single", "multi"), gib):
            total = sum(dryrun.argument_bytes(
                cfg, shape, _production_mesh(mesh), inputs).values())
            assert round(total / 2**30, 3) == expect


# -- lower_cell on the CPU's own mesh ---------------------------------------

CELLS = [("qwen2-0.5b", {}), ("hymba-1.5b", {"ssm_fused": True}),
         ("phi3.5-moe-42b-a6.6b", {"moe_impl": "ep_shardmap"}),
         ("musicgen-medium", {})]


def _real_inputs(cfg, shape):
    """Real CPU tensors of `specs.input_specs`' structure, shapes and
    dtypes."""
    gen = torch.Generator().manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"token": torch.zeros((b,), dtype=torch.int32),
                 "pos": torch.tensor(3, dtype=torch.int32)}
    else:
        batch = {"labels": torch.zeros((b, s), dtype=torch.int32)}
        if cfg.frontend != "none":
            batch["embeds"] = torch.randn((b, s, cfg.d_model),
                                          generator=gen).bfloat16()
        else:
            batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                            generator=gen,
                                            dtype=torch.int32)
    inputs = {"batch": batch}
    if shape.kind == "train":
        inputs["state"] = init_train_state(cfg, gen, "cpu")
    else:
        inputs["params"] = init_params(cfg, gen, "cpu")
    if shape.kind == "decode":
        inputs["decode_state"] = init_decode_state(cfg, b, s, device="cpu")
    return inputs


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch,model_flags", CELLS,
                         ids=[a for a, _ in CELLS])
def test_lower_cell_is_a_capture_of_the_step(arch, model_flags, kind):
    cfg = smoke_config(get_config(arch))
    shape = ShapeConfig(f"smoke_{kind}", 32, 2, kind)
    mesh = make_host_mesh(1, device="cpu")
    with flags(**model_flags):
        module, memory, secs = dryrun.lower_cell(cfg, shape, mesh)
        inputs = _real_inputs(cfg, shape)
        step, args = dryrun.cell_program(cfg, shape, inputs, "cpu",
                                         TrainOptions())
        with mesh_context(mesh):
            direct = capture(step, *args, device="cpu")
            out = step(*tree_map(lambda t: t.clone(), args))
    assert secs > 0
    got = list(module.all_instructions())
    want = list(direct.all_instructions())
    assert len(got) == len(want)
    assert [i.opcode for i in got] == [i.opcode for i in want]
    assert module.total_flops() == direct.total_flops()
    assert sum(i.bytes_read + i.bytes_written for i in got) == \
        sum(i.bytes_read + i.bytes_written for i in want)
    assert module.kernel_calls == direct.kernel_calls
    # the arguments the program reads: a prefill's are all but the labels
    assert memory["argument_size_in_bytes"] == _nbytes(dryrun.program_inputs(
        shape, inputs, dryrun.unread_leaves(shape, direct)))
    assert memory["output_size_in_bytes"] == _nbytes(out)
    assert memory["temp_size_in_bytes"] is None
    assert memory["generated_code_size_in_bytes"] is None


def test_wrong_dtype_leaf_fails_the_byte_equality():
    """The fault control of the card's phase: one leaf of the wrong dtype
    handed to the dry run moves its argument bytes off the real ones."""
    cfg = smoke_config(get_config("qwen2-0.5b"))
    shape = ShapeConfig("smoke_prefill", 32, 2, "prefill")
    mesh = make_host_mesh(1, device="cpu")
    from repro_torch.launch import specs
    inputs = specs.input_specs(cfg, shape)
    module, memory, _ = dryrun.lower_cell(cfg, shape, mesh, inputs=inputs)
    real = _nbytes(dryrun.program_inputs(shape, _real_inputs(cfg, shape),
                                         dryrun.unread_leaves(shape, module)))
    assert real < _nbytes(_real_inputs(cfg, shape))  # no labels taken
    assert memory["argument_size_in_bytes"] == real
    ln = inputs["params"]["groups"][0]["ln1"]
    inputs["params"]["groups"][0]["ln1"] = torch.empty(
        ln.shape, dtype=torch.float32, device="meta")
    _, memory, _ = dryrun.lower_cell(cfg, shape, mesh, inputs=inputs)
    assert memory["argument_size_in_bytes"] != real


def test_production_mesh_is_specs_only():
    """A production mesh with nothing behind it (shapes only, as the rules
    read it) runs no program: `lower_cell` raises.  Behind the fake
    process group of its ranks it captures rank 0's per-device program,
    whose arguments are a device's share."""
    from repro_torch.launch.mesh import fake_production_mesh
    cfg = smoke_config(get_config("qwen2-0.5b"))
    shape = ShapeConfig("smoke_prefill", 32, 16, "prefill")
    with pytest.raises(RuntimeError, match="no devices"):
        dryrun.lower_cell(cfg, shape, make_production_mesh())
    with fake_production_mesh(device="cpu") as mesh:
        module, memory, _ = dryrun.lower_cell(cfg, shape, mesh)
    one, one_memory, _ = dryrun.lower_cell(cfg, shape,
                                           make_host_mesh(1, device="cpu"))
    assert memory["argument_size_in_bytes"] < \
        one_memory["argument_size_in_bytes"]
    assert any(i.op_class.value == "collective"
               for i in module.all_instructions())
    assert not torch.distributed.is_initialized()  # the group is gone


def test_host_cell_record(tmp_path, monkeypatch):
    """`run_cell` on the CPU's own mesh writes the reference's fields
    (status ok, chips, compile_seconds, roofline and, under --analyze,
    leo) and the memory record, on a smoke config standing in for the
    full one."""
    from repro_torch import configs
    cfg = smoke_config(get_config("qwen2-0.5b"))
    monkeypatch.setattr(configs, "get_config", lambda name: cfg)
    monkeypatch.setattr(configs, "get_shape", lambda name: ShapeConfig(
        name, 32, 2, "prefill"))
    rec = dryrun.run_cell("qwen2-0.5b", "smoke_prefill", "host",
                          str(tmp_path), analyze=True, save_hlo=True,
                          hw_name="nvidia_h100_sxm", device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["compile_seconds"] > 0
    assert rec["roofline"]["hw_name"] == "nvidia_h100_sxm"
    assert rec["roofline"]["hlo_flops"] > 0
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["leo"]
    assert (tmp_path / "qwen2-0.5b__smoke_prefill__host.module.pkl.gz") \
        .exists()
    assert np.isfinite(rec["roofline"]["memory_s"])
