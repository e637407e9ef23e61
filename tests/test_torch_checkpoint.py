"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's (`repro.checkpoint`).

The on-disk format is shared: a checkpoint written by either package
restores in the other, bit for bit on every leaf (bf16 included, which the
port writes and reads as raw bytes, with no numpy bfloat16), and the two
packages write the same `manifest.json` and the same `arrays.npz` members
for the same state.  The state is the reference's qwen2-0.5b smoke train
state (bf16 params, f32 `mu`/`nu`/`master`, int32 `count` and `step`), its
float leaves drawn from a numpy seed so that no leaf is all zeros, carried
to the port by `train_state_from_numpy`.  Then the reference's
`TestCheckpoint` cases on the port, the in-place update of a state during
an async save, and the error-feedback state's round trip.
"""
import json
import os
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.runtime import init_train_state as j_init_train_state
from repro_torch.checkpoint import (
    CheckpointManager,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint import manager as manager_module
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import train_state_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainOptions, init_train_state, \
    make_train_step

ARCH = "qwen2-0.5b"
STEP = 7


@pytest.fixture(scope="module")
def states():
    """The reference's fresh smoke train state, and the same tree with
    every float leaf drawn from a numpy seed and the counters at STEP."""
    jcfg = j_smoke(j_get_config(ARCH))
    fresh = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def draw(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)
        return jnp.full(leaf.shape, STEP, leaf.dtype)
    drawn = jax.tree.map(draw, fresh)
    return fresh, drawn, smoke_config(get_config(ARCH))


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return leaf.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _assert_bit_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        assert _dtype(got[key]) == _dtype(want[key]), key
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert _bytes(got[key]) == _bytes(want[key]), key


def test_keys_are_the_references(states):
    fresh, _, tcfg = states
    carried = train_state_from_numpy(jax.tree.map(np.asarray, fresh), tcfg,
                                     "cpu")
    keys = [k for k, _ in _flatten(carried)]
    assert keys == list(_jax_leaves(fresh))
    assert keys[0] == "opt/count" and keys[-1] == "step"
    assert "opt/master/embed/table" in keys and \
        "params/groups/0/ln2" in keys


def test_reference_checkpoint_restores_in_the_port(states, tmp_path):
    fresh, drawn, tcfg = states
    j_save(str(tmp_path), STEP, drawn)
    like = train_state_from_numpy(jax.tree.map(np.asarray, fresh), tcfg,
                                  "cpu")
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == STEP
    _assert_bit_equal(dict(_flatten(restored)), _jax_leaves(drawn))
    assert restored["params"]["embed"]["table"].dtype == torch.bfloat16
    assert restored["step"].device.type == "cpu"


def test_port_checkpoint_restores_in_the_reference(states, tmp_path):
    fresh, drawn, tcfg = states
    carried = train_state_from_numpy(jax.tree.map(np.asarray, drawn), tcfg,
                                     "cpu")
    save_checkpoint(str(tmp_path), STEP, carried)
    restored, step = j_restore(str(tmp_path), fresh)
    assert step == STEP
    _assert_bit_equal(_jax_leaves(restored), dict(_flatten(carried)))


def test_both_packages_write_the_same_files(states, tmp_path):
    _, drawn, tcfg = states
    carried = train_state_from_numpy(jax.tree.map(np.asarray, drawn), tcfg,
                                     "cpu")
    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    j_path = j_save(str(j_dir), STEP, drawn)
    t_path = save_checkpoint(str(t_dir), STEP, carried)
    assert os.path.basename(j_path) == os.path.basename(t_path)
    manifests = [(tmp_path / d / f"step_{STEP:08d}" / "manifest.json")
                 .read_text() for d in ("jax", "torch")]
    assert json.loads(manifests[1]) == json.loads(manifests[0])
    assert manifests[1] == manifests[0]  # same key order, same text
    assert (t_dir / "LATEST").read_text() == (j_dir / "LATEST").read_text()
    with zipfile.ZipFile(os.path.join(j_path, "arrays.npz")) as jz, \
            zipfile.ZipFile(os.path.join(t_path, "arrays.npz")) as tz:
        assert tz.namelist() == jz.namelist()
        for name in jz.namelist():
            assert tz.read(name) == jz.read(name), name


# -- the reference's TestCheckpoint cases, on the port ----------------------

def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 7, _state(7.0))
    restored, step = restore_checkpoint(d, _state())
    assert step == 7
    np.testing.assert_allclose(restored["params"]["w"], 7.0)
    assert restored["step"].dtype == torch.int32 and \
        int(restored["step"]) == 7


def test_latest_wins_and_rotation(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_saves=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    restored, step = mgr.restore_latest(_state())
    assert step == 4
    np.testing.assert_allclose(restored["params"]["w"], 4.0)
    assert len(list_checkpoints(d)) == 2  # rotated to keep=2


def test_async_save(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=3, async_saves=True)
    mgr.save(5, _state(5.0))
    mgr.wait()
    restored, step = mgr.restore_latest(_state())
    assert step == 5
    np.testing.assert_allclose(restored["params"]["w"], 5.0)


def test_corrupt_checkpoint_skipped(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _state(1.0))
    save_checkpoint(d, 2, _state(2.0))
    # corrupt the newest
    with open(os.path.join(d, "step_00000002", "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    restored, step = restore_checkpoint(d, _state())
    assert step == 1  # fell back to the valid one
    np.testing.assert_allclose(restored["params"]["w"], 1.0)


def test_torn_write_invisible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _state(1.0))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    _, step = restore_checkpoint(d, _state())
    assert step == 1


# -- what the port adds ------------------------------------------------------

def test_async_save_snapshots_a_state_updated_in_place(tmp_path,
                                                       monkeypatch):
    """The train step updates `mu`, `nu` and `master` in place, and `.cpu()`
    of a CPU tensor is the tensor itself: the snapshot must be a copy.  The
    write is held back until the caller has updated its state."""
    updated = threading.Event()
    real_save = manager_module.save_checkpoint

    def held_save(*args):
        assert updated.wait(timeout=30)
        return real_save(*args)
    monkeypatch.setattr(manager_module, "save_checkpoint", held_save)
    d = str(tmp_path)
    state = {"opt": {"mu": torch.arange(16, dtype=torch.float32)},
             "step": torch.tensor(3, dtype=torch.int32)}
    before = {k: v.clone() for k, v in _flatten(state)}
    mgr = CheckpointManager(d, keep=3, async_saves=True)
    mgr.save(3, state)
    state["opt"]["mu"].mul_(-2.0).add_(1.0)
    state["step"].add_(1)
    updated.set()
    mgr.wait()
    restored, step = mgr.restore_latest(tree_map(torch.zeros_like, state))
    assert step == 3
    for key, value in _flatten(restored):
        assert torch.equal(value, before[key]), key


def test_grad_compression_state_round_trip(tmp_path):
    """The error-feedback residual `grad_ef` (f32, one leaf a param) is part
    of the checkpoint: one smoke step with compression, saved, restored
    into a fresh state's structure bit for bit."""
    cfg = smoke_config(get_config(ARCH))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainOptions(
        chunk=32, grad_compression=True))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    state, _ = step(state, batch)
    assert "grad_ef" in state and any(
        bool(v.any()) for _, v in _flatten(state["grad_ef"]))
    save_checkpoint(str(tmp_path), 1, state)
    like = init_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    like["grad_ef"] = tree_map(torch.zeros_like, state["grad_ef"])
    restored, n = restore_checkpoint(str(tmp_path), like)
    assert n == 1
    _assert_bit_equal(dict(_flatten(restored)), dict(_flatten(state)))


def test_restore_refuses_another_configuration(tmp_path):
    """A leaf of another dtype or shape is a caller's error, not a corrupt
    checkpoint: it raises instead of falling back to an older one."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _state(1.0))
    with pytest.raises(ValueError, match="params/w"):
        restore_checkpoint(d, {"params": {"w": torch.zeros((4, 4),
                                                            dtype=torch.bfloat16)},
                               "step": torch.tensor(0, dtype=torch.int32)})
    with pytest.raises(ValueError, match="params/w"):
        restore_checkpoint(d, {"params": {"w": torch.zeros((2, 8))},
                               "step": torch.tensor(0, dtype=torch.int32)})
