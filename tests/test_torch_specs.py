"""The port's abstract input specs (`repro_torch.launch.specs`) against the
reference's (`repro.launch.specs`): for every configuration and shape,
each leaf of the batch, the params, the train state and the decode state
has the reference's path, shape and dtype, the reference's from
`jax.eval_shape`, the port's tensors on `torch.device("meta")`, so nothing
is allocated on either side."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import LM_SHAPES as J_SHAPES
from repro.launch import specs as JS
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import specs as TS
from repro_torch.parallel import sharding as tsh

ARCHS = [c.name for c in J_ARCHS]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


def _flat_ref(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_same_leaves(ref_tree, port_tree):
    ref = _flat_ref(ref_tree)
    port = {tsh._path_str(p): leaf
            for p, leaf in tsh.tree_leaves_with_path(port_tree)}
    assert sorted(ref) == sorted(port)
    for path, leaf in ref.items():
        got = port[path]
        assert isinstance(got, torch.Tensor) and got.device.type == "meta"
        assert tuple(got.shape) == tuple(leaf.shape), path
        assert got.dtype == DTYPES[np.dtype(leaf.dtype).name], path


@pytest.mark.parametrize("shape", [s.name for s in J_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    jc = J_ARCHS[ARCHS.index(arch)]
    jshape = [s for s in J_SHAPES if s.name == shape][0]
    ref = JS.input_specs(jc, jshape)
    port = TS.input_specs(get_config(arch), get_shape(shape))
    assert sorted(ref) == sorted(port)
    for name in ref:
        assert_same_leaves(ref[name], port[name])


def test_train_state_mirrors_params_leaf_for_leaf():
    state = TS.abstract_train_state(get_config("qwen2-0.5b"))
    params = tsh.tree_leaves_with_path(state["params"])
    for moment in ("mu", "nu", "master"):
        opt = tsh.tree_leaves_with_path(state["opt"][moment])
        assert [p for p, _ in opt] == [p for p, _ in params]
        assert all(t.dtype == torch.float32 for _, t in opt)


def test_frontend_archs_get_embeds():
    specs = TS.batch_specs(get_config("musicgen-medium"),
                           get_shape("train_4k"))
    assert "embeds" in specs and "tokens" not in specs
    assert tuple(specs["embeds"].shape) == (256, 4096, 1536)
    assert specs["embeds"].dtype == torch.bfloat16


def test_decode_specs():
    specs = TS.input_specs(get_config("glm4-9b"), get_shape("decode_32k"))
    assert tuple(specs["batch"]["token"].shape) == (128,)
    kv = specs["decode_state"]["groups"][0]["kv"]["k"]
    assert tuple(kv.shape) == (40, 128, 32768, 2, 128)
