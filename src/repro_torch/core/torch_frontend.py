"""PyTorch front-end: a captured PyTorch program -> unified Module.

The counterpart of `repro.core.jaxpr_frontend` for the port's programs.
`capture(fn, *args)` runs `fn` once on fake tensors (`FakeTensorMode`: the
shapes, dtypes and device of the inputs, no data and no device memory, so a
full-width program is captured on the CPU as well as on the card) under a
dispatch mode that records every aten op the program dispatches.  This is
what `make_fx(..., tracing_mode="fake")` does inside; the front-end keeps
its own recorder so that every node carries the program's own Python stack
(`make_fx`'s stack traces keep only frames of `nn.Module.forward`, and the
port's models are functions).

One `Instruction` per dispatched op, in the single entry computation:

* the op class comes from the aten name (`_OP_CLASS`, the counterpart of
  `_PRIM_CLASS`), FLOPs and bytes as `jaxpr_frontend._annotate` gives them:
  `2 * out * K` for a product, `max(in, out)` for a reduction, 1 or 8 (the
  transcendental set) per output element for the rest; bytes read are the
  tensor operands', bytes written the output's.  A view (`view`,
  `permute`, `expand`, `slice`, ...) launches nothing in eager PyTorch, so
  it moves no bytes here; a copy (`_to_copy`, `clone`, `cat`) does.
* gathers and parameters follow `repro.core.hlo_parser` and its fusion
  model instead, because LEO's loop diagnoses the reference's compiled HLO.
  There a table read at indices is a `gather` inside a loop fusion, one
  kernel: `embedding`, `index_select`, `gather`, `index` and
  `nll_loss_forward` (the label pick of the loss, `take_along_axis` in the
  reference) are recorded with opcode `gather` and class FUSION, each one
  eager kernel on the card, and read the rows they take, each at least a
  256-byte granule and at most 8x the useful bytes, plus their indices
  (`_gather_bytes`), not their whole table.  Likewise a write of rows at
  indices (`index_put`, `scatter`, `index_add`, ..., and the embedding's
  backward) is a `scatter` of class MEMORY_STORE that reads and writes its
  updates and indices and not its destination (`_scatter_bytes`,
  `hlo_parser.py:435-442`): a decode step's cache write costs one token,
  not the cache.  A parameter is a buffer
  binding and moves nothing itself: every op that reads it pays for its
  read (`repro/core/fusion_model.py:207-211`).
* operands are the tensors the op reads, by identity; an in-place op
  renames its output.
* `source_file`/`source_line` are the innermost frame of the `repro_torch`
  package on the stack (this front-end's own frames excluded), `op_name`
  the chain of function names from the outermost such frame in.
* a hand kernel is one fused region.  The models call each kernel's
  wrapper through `kernel_call`, which under a capture launches nothing:
  it runs the wrapper's checks (a capture of a CUDA program refuses what
  the kernel refuses) and records the plain function the model hands it
  (`chunked_attention` at the plain path's chunk for flash attention, as
  the reference marks it; the plain versions for the others) with
  `FUSED_REGION_MARK` in each op's `op_name`; `fusion_model.
  _apply_fused_regions` prices the region as on-chip.  FLOPs are those of
  the plain path by construction.  No other fusion is applied: eager
  PyTorch launches each aten op as its own kernel, and that is what the card
  runs.  Outside a capture `kernel_call` also gives the kernel its gradient
  (`kernels/autograd.py`).

Python loops (the model's layers, the attention's key blocks) are unrolled
in the capture, with one exception: a loop written with `loop` (the train
step's micro-batches, the reference's `lax.scan`) is captured as the
reference's HLO holds a scan, one `while` instruction in the calling
computation whose `trip_count` is the number of trips and whose body, a
computation of kind `loop_body`, holds the first trip.  The body reads one
tuple parameter through `get-tuple-element`s and ends in a `tuple`, slot
for slot: the carry first (the body's result is the next trip's carry),
then every value from outside the loop that a trip reads (passed through
unchanged).  The `while` takes the `tuple` of the slots' first values, and
what follows the loop reads the last carry through `get-tuple-element`s of
the `while`: the layout `core/cfg.py` and `core/depgraph.py` follow across
the back edge.  The second trip runs, and is checked and not recorded: the
same ops in the same order, on the same shapes and dtypes, reading the
same values (an op of the same trip, a carry slot or the same value from
outside), or the capture raises.  The later trips do not run: a trip is
a function of the carry and its slice of `xs` alone, so a second trip
that repeats the first's program, the carry it returns included, hands
the third the same inputs the second had, and so on.  A body must
therefore not read Python state that changes from trip to trip (a
counter, a list it appends to); the check sees such state only where it
changes the second trip.  A capture costs two trips, whatever the trip
count.  Trip-aware FLOPs and bytes
(`Module.total_flops`, `roofline._trip_aware_bytes`) and `kernel_calls`
then equal the unrolled capture's (`capture(..., loops=False)`).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import (
    TorchFunctionMode,
    _get_current_function_mode_stack,
)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..kernels.autograd import kernel_apply
from .fusion_model import FUSED_REGION_MARK, _apply_fused_regions
from .isa import Computation, Instruction, Module, OpClass, ShapeInfo

_DTYPE_SHORT = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64",
}

_OP_CLASS = {
    "mm": OpClass.MATMUL, "bmm": OpClass.MATMUL, "addmm": OpClass.MATMUL,
    "baddbmm": OpClass.MATMUL, "convolution": OpClass.MATMUL,
    "sum": OpClass.REDUCE, "amax": OpClass.REDUCE, "amin": OpClass.REDUCE,
    "mean": OpClass.REDUCE, "max": OpClass.REDUCE, "min": OpClass.REDUCE,
    "prod": OpClass.REDUCE, "argmax": OpClass.REDUCE,
    "argmin": OpClass.REDUCE, "cumsum": OpClass.REDUCE,
    "logsumexp": OpClass.REDUCE, "var_mean": OpClass.REDUCE,
    "arange": OpClass.MEMORY_LOAD,
    "_to_copy": OpClass.DATA_MOVEMENT, "clone": OpClass.DATA_MOVEMENT,
    "copy": OpClass.DATA_MOVEMENT, "cat": OpClass.DATA_MOVEMENT,
    "stack": OpClass.DATA_MOVEMENT, "repeat": OpClass.DATA_MOVEMENT,
    "constant_pad_nd": OpClass.DATA_MOVEMENT, "full": OpClass.DATA_MOVEMENT,
    "zeros": OpClass.DATA_MOVEMENT, "ones": OpClass.DATA_MOVEMENT,
    "empty": OpClass.DATA_MOVEMENT, "scalar_tensor": OpClass.DATA_MOVEMENT,
    "lift_fresh_copy": OpClass.DATA_MOVEMENT, "fill": OpClass.DATA_MOVEMENT,
    "zero": OpClass.DATA_MOVEMENT, "flip": OpClass.DATA_MOVEMENT,
}

# aten ops that read a table's rows at indices: one HLO `gather` each in
# the reference's compiled program, inside a fusion (an eager kernel here)
_GATHERS = {"embedding", "index_select", "gather", "index",
            "nll_loss_forward"}
# aten ops that write rows of a destination at indices: one HLO `scatter`
# each in the reference's compiled program (a `dynamic-update-slice` where
# the index is a scalar), class MEMORY_STORE (`repro/core/isa.py:290`).
# `embedding_dense_backward` is the embedding's gradient, a scatter-add of
# the output gradient's rows into a zero table in the reference's HLO.
_SCATTERS = {"index_put", "_index_put_impl", "scatter", "scatter_add",
             "index_copy", "index_add", "embedding_dense_backward"}
# `repro/core/hlo_parser.py:427-433`: HBM moves at least a 256-byte granule
# a gathered row, and a gather of small rows pays at most 8x its useful
# bytes ("real gathers coalesce partially")
_GRANULE = 256.0
_GRANULE_CAP = 8.0
# the reference's opcode for each gather and scatter; the aten name of a
# scatter stays in its `aten` attribute
_OPCODE = {**{n: "gather" for n in _GATHERS},
           **{n: "scatter" for n in _SCATTERS}}

# 8 FLOPs per element, as `jaxpr_frontend._TRANSCENDENTAL_PRIMS`; the fused
# softmaxes and SiLU, which jax spells with exp / logistic, count so too.
_TRANSCENDENTAL = {
    "exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sqrt", "sin", "cos",
    "pow", "log1p", "expm1", "silu", "gelu", "_softmax", "_log_softmax",
    "log_sigmoid_forward",
}

# `torch.ops._c10d_functional` collectives -> the reference's HLO opcodes
# (`wait_tensor` is no instruction: its users read the collective)
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}

_PACKAGE = Path(__file__).resolve().parent.parent
_SELF = Path(__file__).resolve()


def _short_dtype(dtype: torch.dtype) -> str:
    return _DTYPE_SHORT.get(dtype, "f32")


def _shape(t: torch.Tensor) -> ShapeInfo:
    return ShapeInfo(dtype=_short_dtype(t.dtype),
                     dims=tuple(int(d) for d in t.shape))


def _base_name(func) -> str:
    """`aten.add_.Tensor` -> "add"; `aten._to_copy.default` -> "_to_copy"."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _op_class(func) -> OpClass:
    if getattr(func, "is_view", False):
        return OpClass.DATA_MOVEMENT
    name = _base_name(func)
    if name in _GATHERS:
        return OpClass.FUSION
    if name in _SCATTERS:
        return OpClass.MEMORY_STORE
    return _OP_CLASS.get(name, OpClass.COMPUTE)


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _port_file(filename: str) -> Optional[str]:
    """The resolved path of a source file of the `repro_torch` package
    (this module excluded), else None."""
    path = Path(filename).resolve()
    if path == _SELF or _PACKAGE not in path.parents:
        return None
    return str(path)


def _stack() -> List[Tuple[str, int, str]]:
    """(file, line, function) of the `repro_torch` frames on the stack,
    outermost first, this module's frames excluded."""
    frames = []
    f = sys._getframe(1)
    while f is not None:
        path = _port_file(f.f_code.co_filename)
        if path is not None:
            frames.append((path, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    frames.reverse()
    return frames


def _meta(t: torch.Tensor) -> Tuple[torch.dtype, Tuple[int, ...]]:
    return t.dtype, tuple(t.shape)


class _Trip:
    """What one trip of a `loop` did, in a form another trip's can be
    compared with: each op (its overload, the kernel region it runs in,
    where each value it reads comes from, its outputs' dtypes and shapes)
    and where each leaf of the carry it returns comes from.  A value comes
    from ("op", k, j), output j of the trip's op k; ("carry", c), slot c of
    the carry the trip was handed; or ("outer", name), the value of that
    name outside the loop (None: a value of no name, such as one an
    earlier trip made)."""

    def __init__(self, carry: List[torch.Tensor], outer: Dict[int, str],
                 recording: bool):
        self.outer = outer
        self.recording = recording
        self.ids: Dict[int, Tuple] = {}
        self.keep: List[torch.Tensor] = list(carry)  # ids stay unique
        self.ops: List[Tuple] = []
        for c, t in enumerate(carry):
            self.ids.setdefault(id(t), ("carry", c))

    def source(self, t: torch.Tensor) -> Tuple:
        return self.ids.get(id(t)) or ("outer", self.outer.get(id(t)))

    def see(self, func, inputs: List[torch.Tensor],
            outputs: List[torch.Tensor], kernel: Optional[str]) -> None:
        k = len(self.ops)
        self.ops.append((str(func), kernel,
                         tuple(self.source(t) for t in inputs),
                         tuple(_meta(o) for o in outputs)))
        for j, o in enumerate(outputs):
            self.ids[id(o)] = ("op", k, j)
        self.keep.extend(outputs)

    def result(self, carry: List[torch.Tensor]) -> Tuple:
        return (self.ops, [(self.source(t), _meta(t)) for t in carry])


def _difference(first: Tuple, other: Tuple) -> str:
    """Where a later trip's record differs from the first trip's."""
    (ops0, out0), (ops, out) = first, other
    for k, (a, b) in enumerate(zip(ops0, ops)):
        if a != b:
            return f"op {k} is {b}, in the first trip {a}"
    if len(ops0) != len(ops):
        return f"{len(ops)} ops, in the first trip {len(ops0)}"
    return f"the carry it returns is {out}, in the first trip {out0}"


class _Body:
    """The loop body being recorded (the first trip): its computation,
    its tuple parameter, and for each slot of the state the name of its
    first value outside the loop, its shape and its `get-tuple-element`."""

    def __init__(self, comp: Computation, param: Instruction,
                 outer: Tuple[Computation, Dict[int, str]]):
        self.comp = comp
        self.param = param
        self.outer = outer
        self.inits: List[str] = []
        self.shapes: List[ShapeInfo] = []
        self.gtes: List[str] = []


class _Recorder(TorchDispatchMode):
    """Appends one Instruction per dispatched op to `comp` (to a loop
    body's computation while `loop` records its first trip)."""

    def __init__(self, module: Module, comp: Computation, scope: str,
                 loops: bool = True):
        super().__init__()
        self.module = module
        self.comp = comp
        self.scope = scope
        self.loops = loops
        self.names: Dict[int, str] = {}
        self.keep: List[torch.Tensor] = []  # ids stay unique while alive
        self.counter = itertools.count()
        self.open_region: Optional[Tuple[int, str]] = None  # (depth, name)
        self.kernel_calls: Dict[str, int] = {}
        self.body: Optional[_Body] = None
        self.effects: List[str] = []  # ops that write one of their inputs
        self.trip: Optional[_Trip] = None

    # -- naming -----------------------------------------------------------

    def bind(self, t: torch.Tensor, name: str) -> None:
        self.names[id(t)] = name
        self.keep.append(t)

    def parameter(self, path: str, t: torch.Tensor, index: int) -> None:
        instr = Instruction(
            name=f"p{index}", opcode="parameter", op_class=OpClass.PARAMETER,
            shape=_shape(t), operands=(), computation=self.comp.name,
            index=0, attributes={"literal": str(index), "path": path},
            op_name=self.scope)
        # a buffer binding, not traffic: each kernel that reads it pays for
        # its own read, a gather for the rows it takes, as the reference's
        # HLO prices its parameters (`repro/core/fusion_model.py:207-211`)
        self.comp.add(instr)
        self.bind(t, instr.name)

    def name_of(self, t: torch.Tensor) -> str:
        """The SSA name of `t`; a tensor no recorded op made (a constant
        closed over by the program) becomes a constant here.  In a loop
        body, a value from outside the loop becomes a slot of the body's
        state."""
        if id(t) not in self.names:
            if self.body is not None:
                self.bind(t, self.slot(t, self.outer_name(t)))
            else:
                self.bind(t, self.constant(self.comp, t))
        return self.names[id(t)]

    def constant(self, comp: Computation, t: torch.Tensor) -> str:
        instr = Instruction(
            name=f"k{next(self.counter)}", opcode="constant",
            op_class=OpClass.CONSTANT, shape=_shape(t), operands=(),
            computation=comp.name, index=0, op_name=self.scope)
        comp.add(instr)
        return instr.name

    def outer_name(self, t: torch.Tensor) -> str:
        """The name of `t` outside the loop being recorded."""
        comp, names = self.body.outer
        if id(t) not in names:
            names[id(t)] = self.constant(comp, t)
            self.keep.append(t)
        return names[id(t)]

    def slot(self, t: torch.Tensor, init: str) -> str:
        """A new slot of the loop body's state, first `init` (a name
        outside the loop): its `get-tuple-element` in the body."""
        body = self.body
        gte = Instruction(
            name=f"v{next(self.counter)}", opcode="get-tuple-element",
            op_class=OpClass.TUPLE, shape=_shape(t),
            operands=(body.param.name,), computation=body.comp.name,
            index=0, attributes={"index": str(len(body.inits))},
            op_name=self.scope)
        body.comp.add(gte)
        body.inits.append(init)
        body.shapes.append(_shape(t))
        body.gtes.append(gte.name)
        return gte.name

    # -- attribution ------------------------------------------------------

    def where(self) -> Tuple[str, str, int]:
        frames = _stack()
        chain = [fn for _, _, fn in frames]
        if self.open_region is not None:
            depth, kernel = self.open_region
            chain = chain[:depth] + [f"{FUSED_REGION_MARK}:{kernel}"] + \
                chain[depth:]
        op_name = "/".join([self.scope] + chain)
        if not frames:
            return op_name, "", 0
        path, line, _ = frames[-1]
        return op_name, path, line

    # -- the hook ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            raise RuntimeError(
                f"capture: {func} on a DTensor; capture a mesh's per-device "
                f"program on its local shards (`spmd.program`)")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out

    def region(self, kernel: str, plain: Callable[[], Any]) -> Any:
        """Run `plain()` with its ops marked as one region of `kernel`."""
        self.kernel_calls[kernel] = self.kernel_calls.get(kernel, 0) + 1
        self.open_region = (len(_stack()), kernel)
        try:
            return plain()
        finally:
            self.open_region = None

    def record(self, func, args, kwargs, out) -> None:
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        if not flat_out:
            return  # a query (`prim.device`, a size): no tensor, no kernel
        trip = self.trip
        if trip is not None and not trip.recording:
            trip.see(func, flat_in, flat_out, self.open_kernel())
            return
        name = _base_name(func)
        if _is_c10d(func) and name == "wait_tensor":
            # the wait moves nothing: its users read the collective itself,
            # so a stall on the value follows one edge back to it
            self.bind(flat_out[0], self.name_of(flat_in[0]))
            if trip is not None:
                trip.see(func, flat_in, flat_out, self.open_kernel())
            return
        operands = tuple(self.name_of(t) for t in flat_in)
        op_name, path, line = self.where()
        first = flat_out[0]
        if _is_c10d(func):
            if name not in _COLLECTIVES:
                raise NotImplementedError(
                    f"capture: no opcode for the collective {func}")
            cls, opcode = OpClass.COLLECTIVE, _COLLECTIVES[name]
        else:
            cls, opcode = _op_class(func), _OPCODE.get(name, name)
        instr = Instruction(
            name=f"v{next(self.counter)}",
            opcode=opcode, op_class=cls,
            shape=_shape(first), operands=operands,
            computation=self.comp.name, index=0, op_name=op_name,
            source_file=path, source_line=line)
        if name in _SCATTERS:
            instr.attributes["aten"] = name
        if cls is OpClass.COLLECTIVE:
            _annotate_collective(instr, name, args, flat_in)
        else:
            _annotate(instr, func, flat_in)
        self.comp.add(instr)
        self.bind(first, instr.name)
        if func._schema.is_mutable:
            self.effects.append(instr.name)
        for i, extra in enumerate(flat_out[1:], start=1):
            alias = Instruction(
                name=f"v{next(self.counter)}", opcode="get-tuple-element",
                op_class=OpClass.TUPLE, shape=_shape(extra),
                operands=(instr.name,), computation=self.comp.name,
                index=0, attributes={"index": str(i)}, op_name=op_name)
            self.comp.add(alias)
            self.bind(extra, alias.name)
        if trip is not None:
            trip.see(func, flat_in, flat_out, self.open_kernel())

    def open_kernel(self) -> Optional[str]:
        return None if self.open_region is None else self.open_region[1]

    # -- loops ------------------------------------------------------------

    def loop(self, body_fn: Callable, carry, xs, trips: int):
        """`loop` under the capture: the first trip recorded into a loop
        body, one `while` of `trip_count` `trips` here, the second trip run
        and checked against the first (the module's docstring)."""
        carry_in, spec = tree_flatten(carry)
        if not all(isinstance(t, torch.Tensor) for t in carry_in):
            raise TypeError("loop: every leaf of the carry must be a tensor")
        op_name, path, line = self.where()
        before = dict(self.kernel_calls)
        outer = (self.comp, self.names)
        comp = Computation(
            name=f"c{len(self.module.computations)}_loop_body",
            kind="loop_body")
        self.module.add_computation(comp)
        param = Instruction(
            name=f"v{next(self.counter)}", opcode="parameter",
            op_class=OpClass.PARAMETER, shape=ShapeInfo(), operands=(),
            computation=comp.name, index=0, attributes={"literal": "0"},
            op_name=self.scope)
        comp.add(param)
        body = self.body = _Body(comp, param, outer)
        self.comp, self.names = comp, {}
        try:
            for t in carry_in:
                self.bind(t, self.slot(t, self.outer_name(t)))
            self.trip = _Trip(carry_in, outer[1], recording=True)
            out = body_fn(carry, tree_map(lambda x: x[0], xs))
            carry_out, out_spec = tree_flatten(out)
            if out_spec != spec or [_meta(t) for t in carry_out] != \
                    [_meta(t) for t in carry_in]:
                raise RuntimeError(
                    f"loop: a trip takes a carry of {spec} "
                    f"{[_meta(t) for t in carry_in]} and returns "
                    f"{out_spec} {[_meta(t) for t in carry_out]}")
            first = self.trip.result(carry_out)
            one_trip = {k: n - before.get(k, 0)
                        for k, n in self.kernel_calls.items()}
            results = [self.name_of(t) for t in carry_out]
            state = ShapeInfo(elements=tuple(body.shapes))
            param.shape = state
            root = Instruction(
                name=f"v{next(self.counter)}", opcode="tuple",
                op_class=OpClass.TUPLE, shape=state,
                operands=tuple(results) + tuple(body.gtes[len(results):]),
                computation=comp.name, index=0, op_name=self.scope,
                is_root=True)
            comp.add(root)
        finally:
            self.comp, self.names = outer
            self.body = self.trip = None
        init = Instruction(
            name=f"v{next(self.counter)}", opcode="tuple",
            op_class=OpClass.TUPLE, shape=state, operands=tuple(body.inits),
            computation=self.comp.name, index=0, op_name=op_name)
        self.comp.add(init)
        while_ = Instruction(
            name=f"v{next(self.counter)}", opcode="while",
            op_class=OpClass.CONTROL, shape=state, operands=(init.name,),
            computation=self.comp.name, index=0, op_name=op_name,
            source_file=path, source_line=line,
            attributes={"body": comp.name}, called_computations=(comp.name,),
            trip_count=trips)
        self.comp.add(while_)
        comp.parent_op = while_.qualified_name
        if trips > 1:
            try:
                self.trip = _Trip(carry_out, self.names, recording=False)
                out = body_fn(out, tree_map(lambda x: x[1], xs))
                carry_out = tree_flatten(out)[0]
                seen = self.trip.result(carry_out)
                if seen != first:
                    raise RuntimeError(
                        f"loop: trip 1 of {trips} is not the first trip's "
                        f"program ({_difference(first, seen)}); the "
                        f"capture records one body for every trip")
            finally:
                self.trip = None
        self.kernel_calls = {k: before.get(k, 0) + trips * one_trip.get(k, 0)
                             for k in set(before) | set(one_trip)}
        for c, t in enumerate(carry_out):
            gte = Instruction(
                name=f"v{next(self.counter)}", opcode="get-tuple-element",
                op_class=OpClass.TUPLE, shape=_shape(t),
                operands=(while_.name,), computation=self.comp.name, index=0,
                attributes={"index": str(c)}, op_name=op_name)
            self.comp.add(gte)
            self.bind(t, gte.name)
        return out


class _Functions(TorchFunctionMode):
    """The Python-level half of a capture: `t[...]` with ints, slices,
    `None` and `...` becomes `select` / `narrow` / `unsqueeze` calls, and
    `~t` `bitwise_not(t)`.  The same ops, but PyTorch's C++ indexing and
    inversion take a device guard first, which a build without CUDA refuses
    for a fake CUDA tensor, so a CUDA program can be captured on the CPU.
    Other indexing goes through unchanged."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__ and not kwargs:
            out = _basic_getitem(*args)
            if out is not None:
                return out
        if func is torch.Tensor.__invert__:
            return torch.bitwise_not(*args)
        return func(*args, **kwargs)


def _basic_getitem(t: torch.Tensor, index) -> Optional[torch.Tensor]:
    index = index if isinstance(index, tuple) else (index,)
    if not all(i is None or i is Ellipsis or isinstance(i, (int, slice))
               for i in index) or any(isinstance(i, bool) for i in index):
        return None
    if sum(i is Ellipsis for i in index) > 1:
        return None
    real = sum(1 for i in index if isinstance(i, (int, slice)))
    out, dim = t, 0
    for i in index:
        if i is Ellipsis:
            dim += t.dim() - real
        elif i is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(i, int):
            out = out.select(dim, i)
        else:
            start, stop, step = i.indices(out.shape[dim])
            if step != 1:
                return None
            out = out.narrow(dim, start, max(0, stop - start))
            dim += 1
    return out


def _annotate(instr: Instruction, func, inputs: List[torch.Tensor]) -> None:
    """FLOPs and bytes, as `jaxpr_frontend.JaxprConverter._annotate`."""
    out_elems = instr.shape.num_elements
    cls = instr.op_class
    name = _base_name(func)
    if cls is OpClass.MATMUL:
        # addmm / baddbmm carry the bias first; the left factor's last axis
        # is the contracted one
        lhs = inputs[1] if name in ("addmm", "baddbmm") else inputs[0]
        instr.flops = 2.0 * out_elems * int(lhs.shape[-1])
    elif cls is OpClass.REDUCE:
        in_elems = inputs[0].numel() if inputs else 0
        instr.flops = float(max(in_elems, out_elems))
    elif cls is OpClass.COMPUTE:
        per = 8.0 if name in _TRANSCENDENTAL else 1.0
        instr.flops = per * out_elems
    if getattr(func, "is_view", False):
        return  # no kernel runs: no bytes move
    instr.bytes_read = float(sum(_shape(t).byte_size for t in inputs))
    instr.bytes_written = float(instr.shape.byte_size)
    if name in _GATHERS:
        instr.bytes_read = _gather_bytes(name, inputs, instr.shape.byte_size)
    elif name in _SCATTERS:
        instr.bytes_read = instr.bytes_written = _scatter_bytes(name, inputs)


def _is_c10d(func) -> bool:
    return getattr(func, "namespace", "") == "_c10d_functional"


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _annotate_collective(instr: Instruction, name: str, args,
                         inputs: List[torch.Tensor]) -> None:
    """Bytes of a collective, by `repro/core/hlo_parser.py:444-466`: the
    operand read and the output written in HBM, and on the wire per
    participating device with a ring over its group of n: all-reduce
    `2 * in * (n - 1) / n`, all-gather `out * (n - 1) / n`, reduce-scatter
    and all-to-all `in * (n - 1) / n`; none on a group of one."""
    if name == "all_reduce":
        n = _group_size(args[2])
    elif name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        n = int(args[-2])
    else:
        n = _group_size(args[3])
    in_bytes = float(sum(_shape(t).byte_size for t in inputs))
    out_bytes = float(instr.shape.byte_size)
    instr.bytes_read, instr.bytes_written = in_bytes, out_bytes
    instr.attributes["group_size"] = str(n)
    if n <= 1:
        instr.comm_bytes = 0.0
    elif name == "all_reduce":
        instr.comm_bytes = 2.0 * in_bytes * (n - 1) / n
    elif name == "all_gather_into_tensor":
        instr.comm_bytes = out_bytes * (n - 1) / n
    else:
        instr.comm_bytes = in_bytes * (n - 1) / n


def _gather_bytes(name: str, inputs: List[torch.Tensor],
                  out_bytes: int) -> float:
    """Bytes a gather reads, by `repro/core/hlo_parser.py:418-434`: the
    useful bytes (the output's; for `nll_loss_forward` the values picked
    before the mean, one of `logp`'s elements a target) over `rows`, the
    elements of the index tensor; rows under 256 bytes read
    `min(rows * 256, 8 * useful)`; the index bytes are added.  `index`
    with several index tensors reads them broadcast together, as the HLO's
    one start-index tensor of `len(indices)` columns."""
    table, indices = inputs[0], inputs[1:]
    if name == "nll_loss_forward":
        indices = indices[:1]  # the targets; a class-weight tensor is not
        useful = float(indices[0].numel() * table.element_size())
    else:
        useful = float(out_bytes)
    if not indices:
        return useful
    elems = 1
    for dim in torch.broadcast_shapes(*(t.shape for t in indices)):
        elems *= int(dim)
    rows = max(1, elems * len(indices))
    idx_bytes = float(sum(elems * t.element_size() for t in indices))
    if useful / rows < _GRANULE:
        useful = min(rows * _GRANULE, _GRANULE_CAP * useful)
    return useful + idx_bytes


def _scatter_bytes(name: str, inputs: List[torch.Tensor]) -> float:
    """Bytes a scatter reads, and writes, by `repro/core/hlo_parser.py:
    435-442`: its updates' and its indices' bytes, every operand but the
    destination, which is updated in place and not read (a one-token write
    into a 32k-deep KV cache costs one token).  `embedding_dense_backward`
    has no destination operand: the table it writes is the HLO scatter's
    zero operand, so all its inputs (the output gradient and the indices)
    are the updates."""
    updates = inputs if name == "embedding_dense_backward" else inputs[1:]
    return float(sum(_shape(t).byte_size for t in updates))


_ACTIVE: Optional[_Recorder] = None  # the recorder of the running capture


def kernel_call(kernel: Callable, *args, plain_fn: Callable[..., Any],
                **kwargs) -> Any:
    """`kernel(*args, **kwargs)`: the models call each hand kernel's wrapper
    through here, with `plain_fn`, the kernel's plain version as a function
    of the kernel's positional tensors.

    * Under `capture` nothing launches: `kernel.check(*args, **kwargs)`,
      with grad mode off as the autograd route calls the wrapper, raises
      what the wrapper would raise, then `plain_fn(*args)` runs and its
      ops (and, in a captured backward, its gradient's) are recorded as
      one fused region of the kernel.
    * When grad mode is on and an argument requires grad, the kernel runs
      through `kernels.autograd.KernelFunction`: forward the kernel, backward
      the gradient of `plain_fn` recomputed on the saved inputs (the
      gradient the reference takes).
    * Otherwise (serving, prefill) the wrapper is called as it is."""
    if _ACTIVE is not None:
        with torch.no_grad():
            kernel.check(*args, **kwargs)
        return _ACTIVE.region(kernel.__name__,
                              functools.partial(plain_fn, *args))
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return kernel_apply(kernel, plain_fn, *args, **kwargs)
    return kernel(*args, **kwargs)


def capture_functions():
    """The capture's Python-level rewrites (`_Functions`) around code that
    a checkpoint runs again in the backward: the autograd engine carries
    no torch function mode into its recomputation, which would otherwise
    index through PyTorch's C++ path and dispatch other views than the
    forward did (a slice over a whole axis is `alias` there, `slice`
    here; a selective checkpoint refuses the difference).  Outside a
    capture, or where the rewrites are on, nothing."""
    if _ACTIVE is None or any(isinstance(m, _Functions)
                              for m in _get_current_function_mode_stack()):
        return contextlib.nullcontext()
    return _Functions()


def loop(body: Callable, carry, xs):
    """The last carry of `carry = body(carry, x)` over the trips i = 0, ...,
    n - 1, x being `xs` (a nest of tensors sharing a leading axis of n)
    taken at i: the reference's `lax.scan(body, carry, xs)` with nothing
    collected a trip.  Every leaf of the carry is a tensor, of the same
    shape and dtype after each trip.

    A Python loop, except under `capture(..., loops=True)` (the default)
    and outside another loop's trip: there the loop is one `while` whose
    body holds the first trip, the second trip is checked against it and
    the later trips do not run (the module's docstring), so `body` must
    not read Python state that changes from trip to trip."""
    leaves = tree_flatten(xs)[0]
    trips = int(leaves[0].shape[0]) if leaves else 0
    if any(int(x.shape[0]) != trips for x in leaves):
        raise ValueError(f"loop: the leaves of xs have leading axes "
                         f"{[int(x.shape[0]) for x in leaves]}, not one "
                         f"number of trips")
    if _ACTIVE is not None and _ACTIVE.loops and _ACTIVE.trip is None \
            and trips > 0:
        return _ACTIVE.loop(body, carry, xs, trips)
    for i in range(trips):
        carry = body(carry, tree_map(lambda x: x[i], xs))
    return carry


def _unread(comp: Computation, live: List[str]) -> List[str]:
    """The paths of `comp`'s parameters that nothing in `live` (the
    outputs, and the ops that write an input) reads, through the operands
    of `comp`: the arguments `jax.jit` would leave out of the compiled
    step (`keep_unused=False`, after dead code is removed)."""
    seen, todo = set(), list(live)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        instr = comp.get(name)
        if instr is not None:
            todo.extend(instr.operands)
    return [i.attributes["path"] for i in comp.instructions
            if i.opcode == "parameter" and i.name not in seen]


def capture(fn: Callable, *args, name: Optional[str] = None,
            device=None, loops: bool = True) -> Module:
    """Capture `fn(*args)` into a `Module`.

    `args` may be nests of dicts, lists and tuples; their tensors (real,
    on any device) are replaced by fake tensors of the same shape and dtype
    (moved to `device` when given, so a CUDA program is captured from CPU
    tensors: `device="cuda"` needs no card).  Nothing runs on a device.
    A `loop` is one `while` unless `loops` is False, which records every
    trip in line.  The returned module's `kernel_calls` counts the regions
    of each hand kernel the program runs, a loop body's once a trip
    ({"flash_attention": 24, ...}), and its `unread_parameters` lists the
    paths of the arguments (`"1.labels"`) the program does not read
    (`_unread`)."""
    name = name or getattr(fn, "__name__", "fn")
    module = Module(name=name, source="torch")
    comp = Computation(name="c0_entry", kind="entry")
    module.add_computation(comp)
    module.entry = comp.name

    fake_mode = FakeTensorMode()

    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                   device=device or t.device)

    with fake_mode:
        fargs = tree_map(fake, args)
    recorder = _Recorder(module, comp, name, loops)
    index = 0
    for path, leaf in _leaves(fargs):
        if isinstance(leaf, torch.Tensor):
            recorder.parameter(path, leaf, index)
            index += 1
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("capture: a capture is already running")
    _ACTIVE = recorder
    try:
        with fake_mode, recorder, _Functions():
            out = fn(*fargs)
    finally:
        _ACTIVE = None
    outputs = [recorder.names.get(id(o), "") for o in tree_flatten(out)[0]
               if isinstance(o, torch.Tensor)]
    for name in reversed(outputs):
        root = comp.get(name)
        if root is not None:
            root.is_root = True
            break
    module.kernel_calls = dict(recorder.kernel_calls)
    module.unread_parameters = _unread(comp, outputs + recorder.effects)
    _apply_fused_regions(module)
    return module
