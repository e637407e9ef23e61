"""The capture prices a gather as the reference's compiled HLO does.

LEO's loop diagnoses the reference's compiled HLO (`tests/test_system.py`),
where a table read at indices is one `gather` inside a loop fusion, priced
by `repro/core/hlo_parser.py:418-434`: the rows it takes, each at least a
256-byte granule and at most 8x the useful bytes, plus its indices; its
parameters are buffer bindings that move nothing themselves
(`repro/core/fusion_model.py:207-211`).  The port's capture records
`embedding`, `index_select`, `gather`, `index` and `nll_loss_forward` so:
opcode `gather`, class FUSION (one eager kernel on the card), those bytes.

* Each op at a few shapes, rows under and over 256 bytes: the rule's bytes,
  and, for f32 tables, the same gathered-row bytes as the reference's own
  compiled gather of the same shapes (`jnp.take`, `x[idx]`,
  `take_along_axis`).  Index bytes follow each side's index tensor: JAX's
  `take_along_axis` carries one s32 column for each dimension of the
  operand, the port's `gather` and `nll_loss` one int64 index an element.
* `crossvendor_divergence`'s embedding MLP at its own size (fake and
  abstract tensors: nothing allocated): the port's top diagnosis on every
  backend equals the reference's ("indirect addressing"), and its memory
  term on `tpu_v5e` is within 25% of the reference's (see the test).
* The qwen2-0.5b smoke loss: the same gathers as the reference's compiled
  `loss_fn` (the embedding and the label pick), in count and in the bytes
  of the rows they take.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import repro.core as ref_core
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import (LeoService, OpClass, capture,
                              compute_roofline)
from repro_torch.examples import crossvendor_divergence as port_cv
from repro_torch.models import init_params, loss_fn

from test_torch_hillclimb import _reference_example


def rule(useful: float, rows: int, idx_bytes: float) -> float:
    """`hlo_parser.py:418-434`, written out."""
    if useful / rows < 256.0:
        useful = min(rows * 256.0, 8.0 * useful)
    return useful + idx_bytes


def port_gathers(fn, *tensors, device="cuda"):
    """The gathers of `fn`'s captured program.  Tensor indexing (`t[i]`)
    takes a device guard that this CPU-only build refuses for a fake CUDA
    tensor, so it is captured on the CPU: the pricing is the same."""
    module = capture(fn, *tensors, device=device)
    return [i for i in module.all_instructions() if i.opcode == "gather"]


def ref_gathers(fn, *avals):
    """(bytes of the rows taken, bytes of the indices) of each gather in
    the reference's compiled HLO of `fn` on abstract shapes."""
    hlo = jax.jit(fn).lower(*avals).compile().as_text()
    module = ref_core.parse_hlo(hlo)
    out = []
    for comp in module.computations.values():
        for instr in comp.instructions:
            if instr.opcode != "gather":
                continue
            idx = comp.get(instr.operands[1]).shape.byte_size
            total = max(instr.raw_bytes_read, instr.bytes_read)
            out.append((total - idx, idx))
    return sorted(out)


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


S = jax.ShapeDtypeStruct

# (name, port op, port inputs, reference op or None, reference inputs,
#  useful bytes, rows, index bytes)
CASES = [
    ("embedding rows of 256 bytes", lambda t, i: F.embedding(i, t),
     ((1000, 64), torch.float32, (4, 128), torch.int32),
     lambda t, i: jnp.take(t, i, axis=0),
     (S((1000, 64), jnp.float32), S((4, 128), jnp.int32)),
     4 * 128 * 64 * 4, 512, 512 * 4),
    ("embedding bf16 rows of 64 bytes", lambda t, i: F.embedding(i, t),
     ((1000, 32), torch.bfloat16, (512,), torch.int64), None, None,
     512 * 32 * 2, 512, 512 * 8),
    ("index_select rows of 32 bytes",
     lambda t, i: torch.index_select(t, 0, i),
     ((300, 8), torch.float32, (100,), torch.int32),
     lambda t, i: t[i], (S((300, 8), jnp.float32), S((100,), jnp.int32)),
     100 * 8 * 4, 100, 100 * 4),
    ("tensor index rows of 256 bytes", lambda t, i: t[i],
     ((50, 4, 16), torch.float32, (20,), torch.int32),
     lambda t, i: t[i], (S((50, 4, 16), jnp.float32), S((20,), jnp.int32)),
     20 * 4 * 16 * 4, 20, 20 * 4),
    ("gather one value a row", lambda t, i: torch.gather(t, 1, i),
     ((8, 100), torch.float32, (8, 5), torch.int64),
     lambda t, i: jnp.take_along_axis(t, i, axis=1),
     (S((8, 100), jnp.float32), S((8, 5), jnp.int32)),
     8 * 5 * 4, 40, 40 * 8),
    ("nll_loss label pick", lambda t, i: F.nll_loss(t, i),
     ((64, 1000), torch.float32, (64,), torch.int64),
     lambda t, i: jnp.take_along_axis(t, i[:, None], axis=-1).mean(),
     (S((64, 1000), jnp.float32), S((64,), jnp.int32)),
     64 * 4, 64, 64 * 8),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gather_priced_by_the_hlo_rule(case):
    name, op, (tshape, tdtype, ishape, idtype), ref_op, ref_avals, useful, \
        rows, idx_bytes = case
    device = "cpu" if name.startswith("tensor index") else "cuda"
    got = port_gathers(op, meta(tshape, tdtype), meta(ishape, idtype),
                       device=device)
    assert len(got) == 1
    g = got[0]
    assert g.op_class is OpClass.FUSION and g.flops == 0.0
    assert g.bytes_read == rule(useful, rows, idx_bytes)
    assert g.bytes_written == g.shape.byte_size
    if ref_op is None:
        return
    (ref_rows, _), = ref_gathers(ref_op, *ref_avals)
    assert g.bytes_read - idx_bytes == ref_rows


def test_several_index_tensors_read_broadcast_together():
    """`x[i, j]`: one gather whose start indices are (5, 2), as the HLO's;
    its rows and index bytes counted over both columns."""
    got = port_gathers(lambda x, i, j: x[i, j],
                       meta((10, 20, 4), torch.float32),
                       meta((5,), torch.int32), meta((5,), torch.int32),
                       device="cpu")
    assert len(got) == 1
    assert got[0].bytes_read == rule(5 * 4 * 4, 10, 2 * 5 * 4)
    (ref_rows, ref_idx), = ref_gathers(
        lambda x, i, j: x[i, j], S((10, 20, 4), jnp.float32),
        S((5,), jnp.int32), S((5,), jnp.int32))
    assert got[0].bytes_read == ref_rows + ref_idx


def test_parameters_are_bindings_and_the_backward_keeps_its_pricing():
    """A parameter moves nothing itself; the backward of an embedding
    (not a gather) still reads every input byte."""
    table = torch.randn(100, 32)
    idx = torch.randint(0, 100, (16,))

    def step(t, i):
        t = t.requires_grad_()
        out = F.embedding(i, t).sum()
        return torch.autograd.grad(out, t)[0]

    module = capture(step, table, idx, device="cpu")
    params = [i for i in module.all_instructions()
              if i.op_class is OpClass.PARAMETER]
    assert len(params) == 2 and all(p.bytes_read == 0.0 for p in params)
    back = [i for i in module.all_instructions()
            if i.opcode == "embedding_dense_backward"]
    assert len(back) == 1 and back[0].op_class is not OpClass.FUSION
    grad_out = module.computations[module.entry].get(back[0].operands[0])
    assert back[0].bytes_read == grad_out.shape.byte_size + 16 * 8


def _top(an):
    blamed = list(an.blame.self_blame) + list(an.blame.occupancy_blame)
    return max(blamed, key=lambda s: s.cycles).subcategory if blamed \
        else "dependency stalls"


# the example's own shapes (`examples/crossvendor_divergence.py:41`),
# abstract: lowering and compiling allocate nothing
DIVERGENCE_AVALS = (S((port_cv.TABLE_ROWS, port_cv.DIM), jnp.bfloat16),
                    S((port_cv.INDICES,), jnp.int32),
                    S((port_cv.DIM, port_cv.HIDDEN), jnp.bfloat16),
                    S((port_cv.HIDDEN, port_cv.DIM), jnp.bfloat16))


@pytest.fixture(scope="module")
def divergence():
    ref = _reference_example("crossvendor_divergence")
    hlo = jax.jit(ref.kernel).lower(*DIVERGENCE_AVALS).compile().as_text()
    return (ref_core.LeoService().compare_backends(hlo),
            LeoService().compare_backends(port_cv.capture_kernel()))


def test_divergence_names_the_gather_as_the_reference_does(divergence):
    ref, port = divergence
    assert _top(ref["tpu_v5e"]) == "indirect addressing"
    for name, an in ref.items():
        assert _top(port[name]) == _top(an), name


def test_divergence_memory_term_near_the_reference(divergence):
    """tpu_v5e: the reference's memory term 1045.9 us, the port's 3219.2
    before the repair (the table's 1.02 GB read twice: by its parameter
    and by the embedding).  The two programs move different bytes by
    construction, so they are held within 25%: the reference's is XLA's
    CPU compile, which carries the gathered rows (268 MB) and the second
    product's output (268 MB, written and read) in f32, twice the port's
    bf16, but fuses the rows into the first product and the GELU into its
    producer; the port's eager program writes and reads back every op's
    output.  The gather itself reads the same rows: half the reference's
    f32 bytes, its s32 indices alike."""
    ref, port = divergence
    ref_rl = ref_core.compute_roofline(ref["tpu_v5e"].module,
                                       ref["tpu_v5e"].hw, chips=1)
    port_rl = compute_roofline(port["tpu_v5e"].module, port["tpu_v5e"].hw,
                               chips=1)
    assert port_rl.memory_s == pytest.approx(ref_rl.memory_s, rel=0.25)
    (ref_rows, ref_idx), = ref_gathers(
        _reference_example("crossvendor_divergence").kernel,
        *DIVERGENCE_AVALS)
    g, = [i for i in port["tpu_v5e"].module.all_instructions()
          if i.opcode == "gather"]
    assert g.bytes_read == ref_rows / 2 + ref_idx


def test_loss_gathers_equal_the_reference_hlo():
    """qwen2-0.5b smoke, batch 4 x 128: the embedding and the label pick,
    two gathers in both programs, each taking the same bytes of rows (the
    reference's rows are f32 after XLA's CPU legalization, 512 of 256
    bytes; the port's bf16 rows of 128 bytes each pay the 256-byte
    granule: the same 131072).  The index bytes differ by the index
    tensors: the tokens are int32 in both, the labels int64 in the port
    (`nll_loss`'s targets) and (512, 3) s32 in the reference
    (`take_along_axis`: a column for each dimension of `logp`)."""
    jcfg = j_smoke(j_get_config("qwen2-0.5b"))
    params = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    batch = {"tokens": S((4, 128), jnp.int32),
             "labels": S((4, 128), jnp.int32)}
    ref = ref_gathers(lambda p, b: j_loss_fn(p, jcfg, b, chunk=64), params,
                      batch)
    cfg = smoke_config(get_config("qwen2-0.5b"))
    tparams = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = {"tokens": torch.zeros((4, 128), dtype=torch.int32),
            "labels": torch.zeros((4, 128), dtype=torch.int64)}
    got = port_gathers(lambda p, b: loss_fn(p, cfg, b, chunk=64), tparams,
                       data)
    # the embedding's output is (4, 128, 64), the label pick's (512,)
    port = sorted(g.bytes_read - (512 * 4 if len(g.shape.dims) == 3
                                  else 512 * 8) for g in got)
    assert len(got) == len(ref) == 2
    assert port == [rows for rows, _ in ref]
    assert sorted(i for _, i in ref) == [512 * 4, 512 * 3 * 4]
