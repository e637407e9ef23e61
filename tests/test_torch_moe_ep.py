"""The expert-parallel MoE (`moe_impl="ep_shardmap"`), sequence
parallelism and the mesh they read, against the reference.

The reference's `moe_forward_ep` runs its per-shard body under shard_map
over the current mesh; on a one-device mesh (`make_host_mesh(1)`) its
all-to-alls are the identity, as the port's are on its own `(1, 1)` mesh.
Both are fed the same numpy-made weights (f32 smoke configs, the
reference's own weights converted) and held within 1e-5 (f32: the same
arithmetic in another summation order; measured ~1e-9), on a token count
that keeps every assignment and one where the capacity drops some.  Off a
mesh, or where the "model" axis does not divide the experts, both fall
back to `moe_forward`.  A mesh with no devices behind it, or one of more
than one device outside its per-device program, raises in the port
instead of running something else (`tests/test_torch_mesh_dist.py` runs
the form on four ranks).

`sequence_parallel` is the identity on a one-device mesh in both.  Under
jax 0.9.0 the reference's `make_host_mesh` has Explicit axes, on which its
`with_sharding_constraint` of a PartitionSpec raises, so its forward is run
on a (1, 1) mesh of Auto axes (C-watch 12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.models.flags import ModelFlags as JFlags
from repro.models.flags import flags as j_flags
from repro.parallel.context import mesh_context as j_mesh_context
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import convert
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt
from repro_torch.models.flags import ModelFlags, flags
from repro_torch.parallel.context import get_current_mesh, mesh_context

from test_torch_moe import MOE_ARCHS, _configs


def _weights(arch):
    jcfg, tcfg = _configs(arch)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   "cpu")
    return jcfg, tcfg, jp, tp


def _moe_layer(jp, tp):
    """Layer 0 of the first MoE group, both sides."""
    gi = next(i for i, g in enumerate(jp["groups"])
              if "router" in g.get("ffn", {}))
    jl = jax.tree.map(lambda a: a[0], jp["groups"][gi]["ffn"])
    tl = jax.tree.map(lambda a: a[0], tp["groups"][gi]["ffn"])
    return jl, tl


def cpu_mesh():
    return make_host_mesh(1, device="cpu")


# (batch, seq, drops): 32 tokens of independent values, nothing dropped;
# 256 tokens near one common value, so most choose the same experts and
# the capacity drops assignments (checked)
TOKENS = [(2, 16, False), (4, 64, True)]


def _tokens(b, s, d, skewed):
    rng = np.random.default_rng(1)
    if not skewed:
        return rng.standard_normal((b, s, d)).astype(np.float32)
    return (rng.standard_normal(d) + 0.1 * rng.standard_normal(
        (b, s, d))).astype(np.float32)


@pytest.mark.parametrize("b,s,drops", TOKENS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_ep_matches_reference(arch, b, s, drops):
    jcfg, tcfg, jp, tp = _weights(arch)
    jl, tl = _moe_layer(jp, tp)
    x = _tokens(b, s, jcfg.d_model, drops)
    with j_mesh_context(j_host_mesh(1)):
        jy, jaux = j_moe.moe_forward_ep(jl, jnp.asarray(x), jcfg)
    xt = torch.from_numpy(x)
    with mesh_context(cpu_mesh()):
        y, aux = t_moe.moe_forward_ep(tl, xt, tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6)
    r = t_moe.route(tl, xt.reshape(1, b * s, -1), tcfg)
    keep = t_moe.dispatch(r.expert_ids,
                          t_moe._capacity(tcfg, b * s)).keep
    assert bool((~keep).any()) == drops
    # on one device the per-shard body is the global form, bit for bit
    y_global, aux_global = t_moe.moe_forward(tl, xt, tcfg)
    assert torch.equal(y, y_global) and torch.equal(aux, aux_global)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_off_mesh_falls_back_to_global(arch, monkeypatch):
    """No mesh, or a "model" axis that does not divide the smoke config's
    4 experts (3, on a mesh with no devices: the fallback comes first, as
    in the reference), runs `moe_forward` itself."""
    jcfg, tcfg, jp, tp = _weights(arch)
    jl, tl = _moe_layer(jp, tp)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, tcfg.d_model)).astype(np.float32))
    calls = []
    real = t_moe.moe_forward

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(t_moe, "moe_forward", spy)
    assert get_current_mesh() is None
    y, _ = t_moe.moe_forward_ep(tl, x, tcfg)
    with mesh_context(Mesh(("data", "model"), (1, 3))):
        y3, _ = t_moe.moe_forward_ep(tl, x, tcfg)
    assert len(calls) == 2
    assert torch.equal(y, real(tl, x, tcfg)[0]) and torch.equal(y, y3)
    jy, _ = j_moe.moe_forward_ep(jl, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)


def test_ep_refuses_meshes_it_cannot_run():
    _, tcfg, jp, tp = _weights(MOE_ARCHS[0])
    _, tl = _moe_layer(jp, tp)
    x = torch.zeros((1, 8, tcfg.d_model))
    cpu = torch.device("cpu")
    with mesh_context(Mesh(("data", "model"), (2, 2))):
        with pytest.raises(RuntimeError, match="no devices"):
            t_moe.moe_forward_ep(tl, x, tcfg)
    # a mesh of several devices runs the expert-parallel form only in its
    # per-device program (`parallel/spmd.py`), where each rank holds its
    # own experts; outside it the whole layer is no rank's shard
    for sizes in ((1, 2), (2, 1)):
        with mesh_context(Mesh(("data", "model"), sizes, (cpu, cpu))):
            with pytest.raises(RuntimeError, match="per-device program"):
                t_moe.moe_forward_ep(tl, x, tcfg)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_under_ep_and_sequence_parallel(arch, sp):
    """The smoke forward (logits and aux) under `moe_impl="ep_shardmap"`,
    `sequence_parallel` on and off, against the reference's under the same
    flags; and bit for bit the port's own global-form forward."""
    jcfg, tcfg, jp, tp = _weights(arch)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16))
    mesh = _auto_mesh()
    with j_mesh_context(mesh), mesh, \
            j_flags(moe_impl="ep_shardmap", sequence_parallel=sp):
        jl, jaux = jt.forward(jp, jcfg, jnp.asarray(tokens))
    tt_tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        with mesh_context(cpu_mesh()), \
                flags(moe_impl="ep_shardmap", sequence_parallel=sp):
            logits, aux = tt.forward(tp, tcfg, tt_tokens)
        plain, plain_aux = tt.forward(tp, tcfg, tt_tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * float(np.abs(jl).max()))
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6)
    assert torch.equal(logits, plain) and torch.equal(aux, plain_aux)


def test_sequence_parallel_refuses_a_mesh_with_no_devices():
    """On a production mesh with nothing behind it no per-device program
    runs to shard the residual stream: the forward raises; without the
    flag the mesh changes nothing."""
    _, tcfg, _, tp = _weights(MOE_ARCHS[0])
    tokens = torch.zeros((1, 16), dtype=torch.long)
    with torch.no_grad(), mesh_context(make_production_mesh()):
        with flags(sequence_parallel=True):
            with pytest.raises(RuntimeError, match="no devices"):
                tt.forward(tp, tcfg, tokens)
        logits, _ = tt.forward(tp, tcfg, tokens)
    assert torch.equal(logits, tt.forward(tp, tcfg, tokens)[0])


def test_flags_have_the_reference_defaults():
    ref, port = JFlags(), ModelFlags()
    for name in ("ssm_fused", "ssm_pallas", "sequence_parallel", "moe_impl",
                 "fsdp_threshold_mb"):
        assert getattr(port, name) == getattr(ref, name), name
    with pytest.raises(ValueError, match="moe_impl"):
        with flags(moe_impl="shard_map"):
            pass


def test_host_mesh():
    mesh = cpu_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices == (torch.device("cpu"),) and mesh.size == 1
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(2, device="cpu")
    with pytest.raises(RuntimeError):
        make_production_mesh().device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
