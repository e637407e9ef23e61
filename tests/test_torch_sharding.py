"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
reference's (`repro.parallel.sharding`).

The rules are pure functions of the mesh's axis names and sizes and of the
leaves' paths and shapes, so both sides run on a fake mesh (the reference's
own test does so, `tests/test_sharding_roofline.py:23-40`): the production
meshes 16x16 and 2x16x16 and a 2x4 mesh.  For every configuration, each
spec tree the dry run reads — params, optimizer state (ZeRO-1), the batch
of every shape, the decode state of the decode shapes, the logits — equals
the reference's leaf by leaf, by path ("groups/0/attn/wq"), the port's
trees being `launch/specs.py`'s meta tensors and the reference's
`jax.eval_shape`'s.  The per-device shapes of `param_shardings` equal
`NamedSharding(...).shard_shape` over a `jax.sharding.AbstractMesh`.  The
rule-math unit tests mirror the reference's, with `fsdp_threshold_mb`.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import shapes_for as j_shapes_for
from repro.launch import specs as JS
from repro.models.flags import flags as j_flags
from repro.parallel.sharding import ShardingRules as JRules
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.flags import flags as t_flags
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import P, ShardingRules


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
ARCHS = [c.name for c in J_ARCHS]


def ref_flat(tree):
    """{path: leaf} of a reference tree, paths as the rules read them."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def port_flat(tree):
    return {tsh._path_str(path): leaf
            for path, leaf in tsh.tree_leaves_with_path(tree)}


def assert_same_specs(ref_tree, port_tree):
    ref, port = ref_flat(ref_tree), port_flat(port_tree)
    assert list(sorted(ref)) == list(sorted(port))
    for path, spec in ref.items():
        assert tuple(port[path]) == tuple(spec), path
    return len(ref)


@pytest.fixture(scope="module")
def trees():
    """Both packages' abstract train states, by arch."""
    return {name: (JS.abstract_train_state(jc),
                   TS.abstract_train_state(get_config(name)))
            for name, jc in zip(ARCHS, J_ARCHS)}


def _rules(arch, mesh):
    jc = J_ARCHS[ARCHS.index(arch)]
    return (jc, JRules(FakeMesh(MESHES[mesh]), jc), get_config(arch),
            ShardingRules(FakeMesh(MESHES[mesh]), get_config(arch)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(trees, arch, mesh):
    _, jr, _, tr = _rules(arch, mesh)
    jst, tst = trees[arch]
    n = assert_same_specs(jr.param_specs(jst["params"]),
                          tr.param_specs(tst["params"]))
    assert n > 5
    assert_same_specs(jr.opt_specs(jst["opt"], jst["params"]),
                      tr.opt_specs(tst["opt"], tst["params"]))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_specs_equal_reference(arch, mesh):
    """The batch and logits specs of every shape, and the decode state's
    for the decode shapes (the 8 GiB cache budget at 2 bytes an element,
    sequence-sharded caches, batch-1 long context)."""
    jc, jr, tc, tr = _rules(arch, mesh)
    for shape in j_shapes_for(jc):
        tshape = get_shape(shape.name)
        assert_same_specs(jr.batch_specs(jc, shape),
                          tr.batch_specs(tc, tshape))
        assert tuple(tr.logits_spec(tshape)) == tuple(jr.logits_spec(shape))
        if shape.kind == "decode":
            assert_same_specs(
                jr.decode_state_specs(JS.abstract_decode_state(jc, shape),
                                      shape),
                tr.decode_state_specs(TS.abstract_decode_state(tc, tshape),
                                      tshape))


@pytest.mark.parametrize("threshold_mb", [16, 512])
@pytest.mark.parametrize("moe_impl", ["global", "ep_shardmap"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-coder-33b"])
def test_flags_move_the_specs_as_the_reference(trees, arch, moe_impl,
                                               threshold_mb):
    """`fsdp_threshold_mb` moves auto-FSDP, and `moe_impl="ep_shardmap"`
    keeps the expert weights stationary, in both packages alike."""
    _, jr, _, tr = _rules(arch, "single")
    jst, tst = trees[arch]
    with j_flags(moe_impl=moe_impl, fsdp_threshold_mb=threshold_mb), \
            t_flags(moe_impl=moe_impl, fsdp_threshold_mb=threshold_mb):
        assert_same_specs(jr.param_specs(jst["params"]),
                          tr.param_specs(tst["params"]))
        assert_same_specs(jr.opt_specs(jst["opt"], jst["params"]),
                          tr.opt_specs(tst["opt"], tst["params"]))


def test_threshold_flag_decides_auto_fsdp():
    """deepseek-coder-33b's w_up, 62 layers of (7168, 19200), is 1020
    MiB a device once split over "model" (at the rule's 2 bytes an
    element): a 16 MiB threshold shards it over data, 2048 MiB does not."""
    cfg = get_config("deepseek-coder-33b")
    params = TS.abstract_params(cfg)
    rules = ShardingRules(FakeMesh(MESHES["single"]), cfg)
    got = {}
    for mb in (16, 2048):
        with t_flags(fsdp_threshold_mb=mb):
            got[mb] = rules.param_specs(params)["groups"][0]["ffn"]["w_up"]
    assert "data" in tuple(got[16]) and "data" not in tuple(got[2048])


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b",
                                  "hymba-1.5b", "xlstm-125m"])
def test_param_shardings_shard_shapes_equal_jax(trees, arch, mesh):
    """Each leaf's per-device shape, as `NamedSharding(mesh, spec).
    shard_shape(shape)` gives it on an abstract mesh of the same axes."""
    _, jr, _, tr = _rules(arch, mesh)
    jst, tst = trees[arch]
    amesh = AbstractMesh(tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
    ref = ref_flat(jr.param_specs(jst["params"]))
    shapes = ref_flat(jst["params"])
    port = port_flat(tr.param_shardings(tst["params"]))
    for path, spec in ref.items():
        want = NamedSharding(amesh, spec).shard_shape(shapes[path].shape)
        assert port[path].shard_shape == tuple(want), path
        assert tuple(port[path].spec) == tuple(spec)


def test_production_mesh_shapes():
    single, multi = make_production_mesh(), \
        make_production_mesh(multi_pod=True)
    assert single.shape == MESHES["single"] and single.devices is None
    assert multi.shape == MESHES["multi"] and multi.devices is None
    assert (single.size, multi.size) == (256, 512)


# -- the rule math, as `tests/test_sharding_roofline.py:23-83` --------------

class TestShardingRuleMath:
    def _rules(self, cfg, data=16, model=16):
        return ShardingRules(FakeMesh({"data": data, "model": model}), cfg)

    def test_head_filter_blocks_subhead_sharding(self):
        rules = self._rules(get_config("qwen2-0.5b"))  # 14 heads, kv 2
        assert rules._head_filter("groups/0/attn/wk", P(None, "model"),
                                  (24, 896, 128)) == P(None, None)
        assert rules._head_filter("groups/0/attn/wq", P(None, "model"),
                                  (24, 896, 896)) == P(None, None)

    def test_head_filter_allows_divisible_heads(self):
        rules = self._rules(get_config("glm4-9b"))  # 32 heads % 16 == 0
        assert rules._head_filter("groups/0/attn/wq", P(None, "model"),
                                  (40, 4096, 4096)) == P(None, "model")
        assert rules._head_filter("groups/0/attn/wk", P(None, "model"),
                                  (40, 4096, 256)) == P(None, None)

    def test_divisibility_filter(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        # hymba vocab 32001 is not divisible by 16
        assert tsh._divisibility_filter(P("model", None), (32001, 1600),
                                        mesh) == P(None, None)
        assert tsh._divisibility_filter(P("model", None), (32000, 1600),
                                        mesh) == P("model", None)

    def test_auto_fsdp_shards_large_weights(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        # 7168 x 19200 bf16 = 263 MB > 128 MB threshold
        spec = tsh._auto_shard_dp(P(None, None, "model"), (62, 7168, 19200),
                                  mesh, ("data",), 128 * 2**20)
        assert "data" in tuple(spec)
        # small tensor untouched
        assert tsh._auto_shard_dp(P(None, None), (64, 64), mesh, ("data",),
                                  128 * 2**20) == P(None, None)

    def test_auto_fsdp_counts_two_bytes_an_element(self):
        """The reference prices auto-FSDP at 2 bytes an element whatever
        the leaf's dtype (`sharding.py:134`): an f32 leaf of 100 MiB is
        50 MiB to the rule, under a 64 MiB threshold."""
        mesh = FakeMesh({"data": 16, "model": 16})
        assert tsh._auto_shard_dp(P(None, None), (1024, 25600), mesh,
                                  ("data",), 64 * 2**20) == P(None, None)

    def test_pad_and_spec_for(self):
        assert tsh._pad(("model", None, None), 4) == \
            P(None, "model", None, None)
        assert tsh._pad((None, "model"), 1) == P("model")
        assert tsh._spec_for("groups/1/ffn/w_up", (31, 16, 4096, 6400),
                             True) == P(None, "model", None, None)
        assert tsh._spec_for("groups/0/ffn/w_up", (24, 896, 4864),
                             False) == P(None, None, "model")
        assert tsh._spec_for("final_norm", (896,), False) == P(None)

    def test_specs_repr_and_equality(self):
        assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"
        assert P(("pod", "data"), None) == (("pod", "data"), None)
