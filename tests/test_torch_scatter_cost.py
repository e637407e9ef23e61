"""The capture prices a scatter as the reference's compiled HLO does.

`repro/core/hlo_parser.py:435-442` charges a `scatter` or a
`dynamic-update-slice` the bytes of its updates and indices, read and
written, in place: the destination is not read, so a one-token write into a
KV cache costs one token.  The port's capture records `index_put`,
`_index_put_impl`, `scatter`, `scatter_add`, `index_copy`, `index_add` and
`embedding_dense_backward` so: opcode `scatter`, class MEMORY_STORE, the
aten name in the `aten` attribute, those bytes.

* Each op: its updates' and indices' bytes, and, against the reference's
  own compiled scatter of the same f32 shapes (`.at[i].set` / `.at[i].add`),
  the same update bytes.  Index bytes follow each side's index tensors (the
  port's int64 indices, the HLO's s32 start indices).
* The qwen2-0.5b smoke serve step, both forms, f32: one token's K and V a
  layer, plus its (B,) row and slot indices, and in sum the update bytes of
  the reference's `dynamic-update-slice`s (scalar position) or `scatter`s
  (a position a slot), counted through its layer loop's trip count.  In
  bf16 the same count at 2 bytes an element (the reference's CPU compile
  carries bf16 caches in f32, so only the f32 step is compared to it).
* The smoke train step: the embedding's backward writes the output
  gradient's rows, not the whole table's gradient.
* A control: the rule with the destination priced fails the serve-step
  comparison.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as ref_core
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.runtime.steps import make_serve_step as j_make_serve_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import OpClass, capture
from repro_torch.core import torch_frontend
from repro_torch.models import init_decode_state, init_params
from repro_torch.runtime import (TrainOptions, init_train_state,
                                 make_serve_step, make_train_step)

S = jax.ShapeDtypeStruct


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def port_scatters(fn, *tensors, device="cpu"):
    """The scatters of `fn`'s captured program.  Tensor assignment
    (`t[i] = u`) takes a device guard that this CPU-only build refuses for
    a fake CUDA tensor, so such programs are captured on the CPU: the
    pricing is the same."""
    module = capture(fn, *tensors, device=device)
    return [i for i in module.all_instructions() if i.opcode == "scatter"]


def _walk(module, comp_name, mult, out):
    comp = module.computations[comp_name]
    for instr in comp.instructions:
        if instr.opcode == "dynamic-update-slice":
            upd = [instr.operands[1]]
            idx = list(instr.operands[2:])
        elif instr.opcode == "scatter":
            upd = list(instr.operands[2:])
            idx = [instr.operands[1]]
        else:
            upd = None
        if upd is not None:
            size = lambda names: float(sum(  # noqa: E731
                comp.get(n).shape.byte_size for n in names))
            assert max(instr.raw_bytes_read, instr.bytes_read) == \
                size(upd) + size(idx)  # the parser's rule, as read here
            out.extend([(instr.opcode, size(upd), size(idx))] * int(mult))
        trips = instr.trip_count if instr.opcode == "while" else 1
        for callee in instr.called_computations:
            if callee in module.computations:
                _walk(module, callee, mult * trips, out)


def ref_writes(fn, *avals, donate=()):
    """(opcode, update bytes, index bytes) of every dynamic-update-slice and
    scatter of the reference's compiled HLO of `fn`, once for each trip of
    the loops around it."""
    hlo = jax.jit(fn, donate_argnums=donate).lower(*avals).compile() \
        .as_text()
    module = ref_core.parse_hlo(hlo)
    out = []
    _walk(module, module.entry, 1, out)
    return out


# (name, port op, port inputs, reference op, reference inputs, update
#  bytes, port index bytes)
CASES = [
    ("index_put of rows", lambda t, i, u: t.index_put_((i,), u),
     [((1000, 64), torch.float32), ((16,), torch.int64),
      ((16, 64), torch.float32)],
     lambda t, i, u: t.at[i].set(u),
     (S((1000, 64), jnp.float32), S((16,), jnp.int32),
      S((16, 64), jnp.float32)), 16 * 64 * 4, 16 * 8),
    ("index_add of rows", lambda t, i, u: t.index_add_(0, i, u),
     [((300, 8), torch.float32), ((100,), torch.int64),
      ((100, 8), torch.float32)],
     lambda t, i, u: t.at[i].add(u),
     (S((300, 8), jnp.float32), S((100,), jnp.int32),
      S((100, 8), jnp.float32)), 100 * 8 * 4, 100 * 8),
    ("index_copy of rows", lambda t, i, u: t.index_copy(0, i, u),
     [((50, 4, 16), torch.float32), ((20,), torch.int64),
      ((20, 4, 16), torch.float32)],
     lambda t, i, u: t.at[i].set(u),
     (S((50, 4, 16), jnp.float32), S((20,), jnp.int32),
      S((20, 4, 16), jnp.float32)), 20 * 4 * 16 * 4, 20 * 8),
    ("scatter_add along a row", lambda t, i, u: t.scatter_add(1, i, u),
     [((8, 100), torch.float32), ((8, 5), torch.int64),
      ((8, 5), torch.float32)], None, None, 8 * 5 * 4, 40 * 8),
    ("scatter along a row", lambda t, i, u: t.scatter(1, i, u),
     [((8, 100), torch.float32), ((8, 5), torch.int64),
      ((8, 5), torch.float32)], None, None, 8 * 5 * 4, 40 * 8),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scatter_priced_by_the_hlo_rule(case):
    name, op, inputs, ref_op, ref_avals, upd_bytes, idx_bytes = case
    got = port_scatters(op, *(meta(s, d) for s, d in inputs))
    assert len(got) == 1
    s = got[0]
    assert s.op_class is OpClass.MEMORY_STORE
    assert s.attributes["aten"] == name.split()[0]
    assert s.bytes_read == s.bytes_written == upd_bytes + idx_bytes
    if ref_op is None:
        return
    (_, ref_upd, _), = ref_writes(ref_op, *ref_avals)
    assert s.bytes_read - idx_bytes == ref_upd


def _smoke(dtype):
    jcfg = dataclasses.replace(j_smoke(j_get_config("qwen2-0.5b")),
                               dtype=dtype)
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-0.5b")),
                              dtype=dtype)
    return jcfg, cfg


B, DEPTH = 4, 64


def port_cache_writes(cfg, per_slot):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = init_decode_state(cfg, B, DEPTH, device="cpu")
    pos = torch.zeros((B,) if per_slot else (), dtype=torch.int32)
    return port_scatters(make_serve_step(cfg, per_slot_pos=per_slot),
                         params, state, torch.zeros(B, dtype=torch.int32),
                         pos)


def ref_cache_writes(jcfg, per_slot):
    params = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    state = jax.eval_shape(lambda: j_init_decode_state(jcfg, B, DEPTH))
    pos = S((B,) if per_slot else (), jnp.int32)
    return ref_writes(j_make_serve_step(jcfg, per_slot_pos=per_slot),
                      params, state, S((B,), jnp.int32), pos, donate=(1,))


def check_cache_writes(port, ref, cfg, itemsize):
    """One token's K or V a layer, its (B,) int64 row and slot indices
    beside it, and the same update bytes in sum as the reference's."""
    token = B * cfg.n_kv_heads * cfg.head_dim_ * itemsize
    assert len(port) == 2 * cfg.n_layers
    for s in port:
        assert s.attributes["aten"] == "index_put"
        assert s.bytes_read == s.bytes_written == token + 2 * B * 8
    assert len(ref) == 2 * cfg.n_layers
    assert sum(s.bytes_read - 2 * B * 8 for s in port) == \
        sum(upd for _, upd, _ in ref)


@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["scalar_pos", "per_slot_pos"])
def test_serve_step_cache_write_is_one_token(per_slot):
    """f32: the reference lowers the scalar form's write to a
    `dynamic-update-slice` (five s32 start indices) and the per-slot form's
    to a `scatter` ((B, 6) s32 indices); the port's to one `index_put` a
    cache a layer in both."""
    jcfg, cfg = _smoke("float32")
    ref = ref_cache_writes(jcfg, per_slot)
    assert {op for op, _, _ in ref} == \
        {"scatter" if per_slot else "dynamic-update-slice"}
    check_cache_writes(port_cache_writes(cfg, per_slot), ref, cfg, 4)


def test_bf16_cache_write_is_one_bf16_token():
    _, cfg = _smoke("bfloat16")
    token = B * cfg.n_kv_heads * cfg.head_dim_ * 2
    writes = port_cache_writes(cfg, per_slot=False)
    assert len(writes) == 2 * cfg.n_layers
    cache = DEPTH * token
    for s in writes:
        assert s.bytes_read == s.bytes_written == token + 2 * B * 8 < cache


def test_embedding_backward_writes_rows_not_the_table():
    """The smoke train step, B 2 x S 16: the embedding's gradient is one
    scatter of the (2, 16, 64) output gradient's rows and the (2, 16)
    token indices, not a write of the (256, 64) table's gradient."""
    cfg = smoke_config(get_config("qwen2-0.5b"))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int64),
             "labels": torch.zeros((2, 16), dtype=torch.int64)}
    step = make_train_step(cfg, options=TrainOptions(chunk=16))
    got = [s for s in port_scatters(step, state, batch)
           if s.attributes["aten"] == "embedding_dense_backward"]
    assert len(got) == 1
    rows = 2 * 16 * cfg.d_model * 2 + 2 * 16 * 8
    table = cfg.vocab_size * cfg.d_model * 2
    assert got[0].bytes_read == got[0].bytes_written == rows < table
    assert got[0].op_class is OpClass.MEMORY_STORE


def test_control_destination_priced_fails(monkeypatch):
    """The rule with the destination read and written, as before the
    repair: the serve step's comparison must refuse it."""
    def with_destination(name, inputs):
        return float(sum(torch_frontend._shape(t).byte_size
                         for t in inputs))

    monkeypatch.setattr(torch_frontend, "_scatter_bytes", with_destination)
    jcfg, cfg = _smoke("float32")
    port = port_cache_writes(cfg, per_slot=False)
    with pytest.raises(AssertionError):
        check_cache_writes(port, ref_cache_writes(jcfg, False), cfg, 4)
