"""The per-device program of a mesh of several devices, captured
(`repro_torch.launch.dryrun.lower_cell` on a mesh behind PyTorch's fake
process group), against the reference's compiled SPMD program of the same
cell.

* qwen2-0.5b, xlstm-125m, and phi3.5-moe and deepseek-v2 under both MoE
  forms, smoke, train / prefill / decode, on a `(2, 2)` ("data",
  "model") mesh: the port's capture on a fake group of 4 ranks, and the
  reference's `launch/dryrun.py::lower_cell` compiled on 4 XLA host
  devices in a subprocess (it sets `XLA_FLAGS` before it imports JAX; the
  reference's module sets them to 512 devices when imported).  Per-device
  FLOPs (`Module.total_flops()` against `repro.core.parse_hlo` of the
  compiled text) within 10%: the two partitioners cut the same products
  (attention by heads, MLA's too, the MLP and the shared experts by
  columns and rows, the expert banks by expert, the vocab of the
  embedding and the head), and differ in the elementwise work around them
  (the port's vocab-parallel cross-entropy, the reference's resharding
  copies).  Per-device argument bytes exactly equal: the arguments the
  program reads (xlstm's decode reads no position).  The collective kinds
  of each are printed; `PERF.md` explains each difference.
* `spmd.materialize` on (2, 2): the leaves it gathers over "model", by
  path; none of the MoE configs' (banks, shared experts, MLA).
* qwen2-0.5b `train_4k` at full width, its depth cut to one layer, on the
  16x16 production mesh: an `ok` record with collective bytes above 0 and
  the argument bytes of the reference's specs; a short prefill's record,
  whose argument bytes are the reference specs' without the labels the
  program does not read.
* The capture's collectives: each `_c10d_functional` op as the reference's
  HLO opcode with its ring bytes (`repro/core/hlo_parser.py:444-466`), a
  DTensor op refused (a mesh's program is captured on its local shards),
  and a sharded loss that gathers no vocab-wide logits.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import specs as JS
from repro.configs import TRAIN_4K
from repro.configs import get_config as j_get_config
from repro.parallel.sharding import ShardingRules as JRules
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.core import capture
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.flags import flags
from repro_torch.parallel import spmd

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8

# (arch, moe_impl) of the comparison's cases: qwen2-0.5b's keep their ids
# (the kind alone)
CASES = [("qwen2-0.5b", "global"), ("xlstm-125m", "global")] + [
    (arch, impl) for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")
    for impl in ("global", "ep_shardmap")]
SHORT = {"phi3.5-moe-42b-a6.6b": "phi3.5-moe",
         "deepseek-v2-236b": "deepseek-v2"}

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
assert len(jax.devices()) == 4
from jax.sharding import AxisType
import repro.launch.dryrun as rd
from repro.configs import ShapeConfig, get_config, smoke_config
from repro.core import parse_hlo
from repro.models.flags import flags
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, impl in %r:
    cfg = smoke_config(get_config(arch))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("smoke_" + kind, %d, %d, kind)
        with flags(moe_impl=impl):
            _, compiled, _ = rd.lower_cell(cfg, shape, mesh)
        module = parse_hlo(compiled.as_text(), hints={"total_devices": 4})
        kinds = sorted({i.opcode.replace("-start", "").replace("-done", "")
                        for i in module.all_instructions()} &
                       {"all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute"})
        out["|".join((arch, impl, kind))] = {
            "flops": module.total_flops(),
            "args": compiled.memory_analysis().argument_size_in_bytes,
            "collectives": kinds}
print(json.dumps(out))
""" % (CASES, SEQ, BATCH)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _port(kind, arch="qwen2-0.5b", impl="global"):
    cfg = smoke_config(get_config(arch))
    shape = ShapeConfig("smoke_" + kind, SEQ, BATCH, kind)
    with flags(moe_impl=impl), \
            fake_mesh(("data", "model"), (2, 2), "cpu") as mesh:
        module, memory, _ = dryrun.lower_cell(cfg, shape, mesh)
    return module, memory


def _collective_kinds(module):
    return sorted({i.opcode for i in module.all_instructions()
                   if i.op_class.value == "collective"})


def _case_id(arch, impl, kind):
    if arch == "qwen2-0.5b":
        return kind
    return "-".join([SHORT.get(arch, arch)] +
                    ([impl] if arch in SHORT else []) + [kind])


@pytest.mark.parametrize("arch,impl,kind", [
    pytest.param(arch, impl, kind, id=_case_id(arch, impl, kind))
    for arch, impl in CASES for kind in KINDS])
def test_per_device_program_matches_the_reference_compile(reference, arch,
                                                          impl, kind):
    module, memory = _port(kind, arch, impl)
    ref = reference["|".join((arch, impl, kind))]
    flops = module.total_flops()
    print(f"{arch} {impl} {kind}: port {flops:.0f} FLOPs, collectives "
          f"{_collective_kinds(module)}; reference {ref['flops']:.0f}, "
          f"{ref['collectives']}")
    assert abs(flops - ref["flops"]) <= 0.10 * ref["flops"]
    assert memory["argument_size_in_bytes"] == ref["args"]
    assert _collective_kinds(module)  # the program communicates


def _model_gathered(arch, impl, decode):
    """The paths of the leaves whose "model" cut `spmd.materialize`
    gathers, in rank 0's per-device program on a fake (2, 2) mesh (smoke
    config, the rules' specs), and the paths the rules cut over "model"."""
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import (ShardingRules, _at,
                                               _path_str, shard_shape,
                                               tree_leaves_with_path,
                                               tree_map_with_path)
    cfg = smoke_config(get_config(arch))
    params = init_params(cfg, device="meta")
    with flags(moe_impl=impl), \
            fake_mesh(("data", "model"), (2, 2), "cpu") as mesh:
        specs = ShardingRules(mesh, cfg).param_specs(params)
        shards = tree_map_with_path(lambda path, t: torch.zeros(
            shard_shape(_at(specs, path), tuple(t.shape), mesh),
            dtype=t.dtype), params)
        with spmd.program(mesh):
            whole = spmd.materialize(shards, specs, decode=decode)
    cut, gathered = [], []
    for path, t in tree_leaves_with_path(whole):
        dims = spmd.sharded_dims(_at(specs, path), ("model",))
        if dims:
            cut.append(_path_str(path))
            full = _at(params, path).shape
            if any(t.shape[d] == full[d] for d in dims):
                gathered.append(_path_str(path))
    return cut, gathered


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("impl", ["global", "ep_shardmap"])
@pytest.mark.parametrize("decode", [False, True], ids=["step", "decode"])
def test_materialize_gathers_no_split_layer(arch, impl, decode):
    """On (2, 2) the MoE configs' expert banks, shared experts and MLA
    weights are read on this rank's shard: `materialize` gathers none of
    the leaves the rules cut over "model"."""
    cut, gathered = _model_gathered(arch, impl, decode)
    want = {"w_up", "w_down"} | ({"wq_a", "wq_b", "wkv_b", "wo"}
                                 if "deepseek" in arch else {"wq", "wo"})
    assert want <= {p.split("/")[-1] for p in cut}, cut
    if "deepseek" in arch:
        assert any("/shared/" in p for p in cut), cut
    assert gathered == [], gathered


def test_materialize_gathers_the_ssm_outside_decode():
    """hymba's SSM has a tensor-parallel form in decode only: a train or
    prefill step gathers its cut leaves, a decode step reads them on this
    rank's channels."""
    _, gathered = _model_gathered("hymba-1.5b", "global", False)
    assert gathered and all("/ssm/" in p for p in gathered), gathered
    assert _model_gathered("hymba-1.5b", "global", True)[1] == []


def test_unread_arguments_are_left_out():
    """xlstm-125m's decode reads no position (its mixers are recurrent):
    the captured program's unread argument is the 4-byte `pos`, and the
    argument bytes leave it out, as the reference's compiled step does
    (342096 bytes a device on (2, 2)); a prefill leaves out its labels."""
    cfg = smoke_config(get_config("xlstm-125m"))
    module, memory = _port("decode", "xlstm-125m")
    assert module.unread_parameters == ["3"]
    assert dryrun.unread_leaves(ShapeConfig("d", SEQ, BATCH, "decode"),
                                module) == {("batch", "pos")}
    shape = ShapeConfig("smoke_decode", SEQ, BATCH, "decode")
    from repro_torch.launch import specs as S
    with fake_mesh(("data", "model"), (2, 2), "cpu") as mesh:
        every = dryrun.argument_bytes(cfg, shape, mesh,
                                      S.input_specs(cfg, shape))
    assert sum(every.values()) - memory["argument_size_in_bytes"] == 4
    assert memory["argument_size_in_bytes"] == 342096
    prefill, _ = _port("prefill", "xlstm-125m")
    assert prefill.unread_parameters == ["1.labels"]
    qwen, _ = _port("decode")
    assert qwen.unread_parameters == []  # attention reads the position


class _Mesh:
    """The single-pod production mesh as the reference's rules read it."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _ref_bytes(tree, specs):
    """A tree's bytes a device of `_Mesh` under the reference's specs."""
    import jax
    from jax.sharding import PartitionSpec as JP
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        ways = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                ways *= _Mesh.shape[a] if a is not None else 1
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // ways
    return total


def test_production_cell_has_a_program(tmp_path):
    """qwen2-0.5b train_4k on the 16x16 mesh, full width, one layer."""
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", str(tmp_path),
                          hw_name="nvidia_h100_sxm", device="cpu",
                          layers=1)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["reduced"] == ["n_layers 24 -> 1"]
    rl = rec["roofline"]
    assert rl["collective_bytes"] > 0 and rl["collective_s"] > 0
    assert set(rl["collective_breakdown"]) >= {"all-reduce", "all-gather"}
    # the uncut cell's bytes a device under the reference's specs
    jc = j_get_config("qwen2-0.5b")
    shape = TRAIN_4K
    rules = JRules(_Mesh(), jc)
    from jax.sharding import PartitionSpec as JP
    inputs = JS.input_specs(jc, shape)
    st = inputs["state"]
    want = {"params": _ref_bytes(st["params"],
                                 rules.param_specs(st["params"])),
            "opt": _ref_bytes(st["opt"],
                              rules.opt_specs(st["opt"], st["params"])),
            "step": _ref_bytes(st["step"], JP()),
            "batch": _ref_bytes(inputs["batch"],
                                rules.batch_specs(jc, shape))}
    assert rec["argument_bytes"] == want
    assert rec["argument_bytes_total"] == sum(want.values())
    assert rec["memory"]["temp_size_in_bytes"] is None


def _collective_module(fn, *shapes):
    with fake_mesh(("data", "model"), (2, 4), "cpu") as mesh:
        with spmd.local_program(spmd.Local.of(mesh)):
            return capture(fn, *[torch.zeros(s) for s in shapes])


@pytest.mark.parametrize("op,opcode,n,wire", [
    (lambda x: spmd.all_reduce(x, "model"), "all-reduce", 4,
     lambda i, o, n: 2 * i * (n - 1) / n),
    (lambda x: spmd.all_gather(x, "model", 1), "all-gather", 4,
     lambda i, o, n: o * (n - 1) / n),
    (lambda x: spmd.reduce_scatter(x, "model", 0), "reduce-scatter", 4,
     lambda i, o, n: i * (n - 1) / n),
    (lambda x: spmd.all_to_all(x, "model", 0, 1), "all-to-all", 4,
     lambda i, o, n: i * (n - 1) / n),
    (lambda x: spmd.all_reduce(x, "data"), "all-reduce", 2,
     lambda i, o, n: 2 * i * (n - 1) / n),
], ids=["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
        "all_reduce_data"])
def test_collective_is_the_reference_opcode(op, opcode, n, wire):
    module = _collective_module(lambda x: op(x) * 2.0, (8, 6))
    colls = [i for i in module.all_instructions()
             if i.op_class.value == "collective"]
    assert [i.opcode for i in colls] == [opcode]
    (c,) = colls
    assert int(c.attributes["group_size"]) == n
    in_bytes = 8 * 6 * 4
    assert c.comm_bytes == pytest.approx(
        wire(in_bytes, c.shape.byte_size, n))
    # `wait_tensor` is no instruction: the next op reads the collective
    instrs = list(module.all_instructions())
    assert not any("wait" in i.opcode for i in instrs)
    assert any(c.name in i.operands for i in instrs)


def test_capture_refuses_a_dtensor():
    """A mesh's program is captured on its local shards (`lower_cell`,
    `train --analyze`); an op on a DTensor reaching the capture raises
    rather than record the op once on the global shapes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_mesh(("data", "model"), (2, 2), "cpu") as mesh:
        dm = mesh.device_mesh

        def program(x, w):
            X = DTensor.from_local(x, dm, [Shard(0), Replicate()],
                                   run_check=False)
            W = DTensor.from_local(w, dm, [Replicate(), Shard(1)],
                                   run_check=False)
            return (X @ W).to_local()

        with pytest.raises(RuntimeError, match="on a DTensor"):
            capture(program, torch.zeros(4, 8), torch.zeros(8, 8))
        # the same product on the local shards is recorded
        module = capture(lambda x, w: x @ w, torch.zeros(4, 8),
                         torch.zeros(8, 4))
    assert [i.opcode for i in module.all_instructions()
            if i.opcode == "mm"] == ["mm"]


def test_sharded_loss_gathers_no_logits():
    """The train step's per-device program on (2, 2): the vocab-parallel
    cross-entropy sums the max, the exponentials and the label's logit
    over "model"; nothing gathers a tensor as wide as the vocab."""
    cfg = smoke_config(get_config("qwen2-0.5b"))
    module, _ = _port("train")
    v = cfg.vocab_size
    gathers = [i for i in module.all_instructions()
               if i.opcode == "all-gather"]
    assert all(v not in i.shape.dims for i in gathers), \
        [i.shape.dims for i in gathers]
    prefill, _ = _port("prefill")
    assert any(i.opcode == "all-gather" and v in i.shape.dims
               for i in prefill.all_instructions())  # its output's spec


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_smoke"])
def test_uncut_cell_memory_is_its_argument_bytes(shape, tmp_path,
                                                 monkeypatch):
    """On an uncut production cell the memory record's argument bytes are
    the record's `argument_bytes`, tree by tree summed: qwen2-0.5b's
    decode_32k at full depth, and a prefill (a short one, so its capture
    is quick), whose program takes no labels: its record's bytes are the
    reference specs' of the params and of the batch's tokens."""
    from repro_torch import configs
    if shape == "prefill_smoke":
        monkeypatch.setattr(configs, "get_shape", lambda name: ShapeConfig(
            name, 64, 16, "prefill"))
    rec = dryrun.run_cell("qwen2-0.5b", shape, "single", str(tmp_path),
                          hw_name="nvidia_h100_sxm", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert "reduced" not in rec
    assert rec["memory"]["argument_size_in_bytes"] == \
        rec["argument_bytes_total"] == sum(rec["argument_bytes"].values())
    if shape == "prefill_smoke":
        from repro.configs import ShapeConfig as JShapeConfig
        jc = j_get_config("qwen2-0.5b")
        jshape = JShapeConfig("prefill_smoke", 64, 16, "prefill")
        rules = JRules(_Mesh(), jc)
        inputs = JS.input_specs(jc, jshape)
        bspecs = rules.batch_specs(jc, jshape)
        assert set(inputs["batch"]) == {"tokens", "labels"}
        want = {"params": _ref_bytes(inputs["params"], rules.param_specs(
                    inputs["params"])),
                "batch": _ref_bytes(inputs["batch"]["tokens"],
                                    bspecs["tokens"])}
        assert rec["argument_bytes"] == want
        assert want["batch"] == 64 * 16 * 4 // 16
