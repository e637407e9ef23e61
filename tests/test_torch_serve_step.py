"""`make_serve_step(cfg, chunk=512, per_slot_pos=False)`, the reference's
signature, in both of its forms, against the reference's serve step on
qwen2-0.5b smoke and phi3.5-moe smoke in f32, from one reference decode
state filled by 6 tokens of 3 slots.

* The scalar form takes a 0-dim position shared by every slot; there the
  MoE routes the batch together against a capacity of B tokens (the
  reference's `make_serve_step(cfg)`, which can drop), at the config's
  capacity factor and at 0.5, where it does drop.
* The per-slot form takes a (B,) position, each slot's MoE routed alone
  (the reference's `make_serve_step(cfg, per_slot_pos=True)`).
* A position of the other form's shape raises; nothing is guessed.

Tolerances are `tests/test_torch_archs.py`'s for decode: logits and states
1e-4 of the largest reference value; the next tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.steps import make_serve_step as j_serve_step
from repro_torch.models import convert, moe
from repro_torch.runtime import make_serve_step
from test_torch_archs import _close, _configs, _filled, _params, \
    _states_close

ARCHS = ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b"]
SLOTS = 3


def _run(arch, per_slot_pos, pos, slots=SLOTS, **cfg_kw):
    jcfg, tcfg = _configs(arch, **cfg_kw)
    jp, tp = _params(jcfg, tcfg)
    j_state = _filled(jp, jcfg, b=slots, steps=6)
    t_state = convert.decode_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    token = np.random.default_rng(4).integers(0, jcfg.vocab_size, slots)
    j_out = j_serve_step(jcfg, per_slot_pos=per_slot_pos)(
        jp, j_state, jnp.asarray(token, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_out = make_serve_step(tcfg, per_slot_pos=per_slot_pos)(
        tp, t_state, torch.from_numpy(token), torch.as_tensor(pos))
    return j_out, t_out


def _equal(j_out, t_out):
    (j_next, j_logits, j_new), (t_next, t_logits, t_new) = j_out, t_out
    _close(t_logits, j_logits, 1e-4)
    assert t_next.tolist() == np.asarray(j_next).tolist()
    _states_close(t_new, j_new, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_scalar_form_matches_reference(arch):
    _equal(*_run(arch, False, 6))


def test_scalar_form_drops_as_the_reference(monkeypatch):
    """phi3.5-moe, 16 slots at capacity factor 0.5: the 16 tokens routed
    together against a capacity of 8 tokens an expert drop some, as
    there."""
    kept = []
    dispatch = moe.dispatch

    def recording(expert_ids, cap):
        out = dispatch(expert_ids, cap)
        kept.append(out.keep)
        return out

    monkeypatch.setattr(moe, "dispatch", recording)
    _equal(*_run("phi3.5-moe-42b-a6.6b", False, 6, slots=16,
                 capacity_factor=0.5))
    assert [tuple(k.shape) for k in kept] == [(1, 32)] * 2
    assert sum(int((~k).sum()) for k in kept) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_per_slot_form_matches_reference(arch):
    _equal(*_run(arch, True, np.array([6, 2, 0])))


@pytest.mark.parametrize("per_slot_pos,pos", [
    (False, np.array([6, 2, 0])), (False, np.array([6])),
    (True, 6), (True, np.array([6, 2])), (True, np.zeros((SLOTS, 1)))])
def test_position_of_the_wrong_shape_raises(per_slot_pos, pos):
    _, tcfg = _configs("qwen2-0.5b")
    step = make_serve_step(tcfg, chunk=512, per_slot_pos=per_slot_pos)
    with pytest.raises(ValueError, match="pos has shape"):
        step({}, {}, torch.zeros(SLOTS, dtype=torch.long),
             torch.as_tensor(pos))
