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
  (`_gather_bytes`), not their whole table.  A parameter is a buffer
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
in the capture, so every trip count is 1.
"""
from __future__ import annotations

import functools
import itertools
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
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
    "index_put": OpClass.MEMORY_STORE, "_index_put_impl": OpClass.MEMORY_STORE,
    "scatter": OpClass.MEMORY_STORE, "scatter_add": OpClass.MEMORY_STORE,
    "index_copy": OpClass.MEMORY_STORE, "index_add": OpClass.MEMORY_STORE,
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
# `repro/core/hlo_parser.py:427-433`: HBM moves at least a 256-byte granule
# a gathered row, and a gather of small rows pays at most 8x its useful
# bytes ("real gathers coalesce partially")
_GRANULE = 256.0
_GRANULE_CAP = 8.0

# 8 FLOPs per element, as `jaxpr_frontend._TRANSCENDENTAL_PRIMS`; the fused
# softmaxes and SiLU, which jax spells with exp / logistic, count so too.
_TRANSCENDENTAL = {
    "exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sqrt", "sin", "cos",
    "pow", "log1p", "expm1", "silu", "gelu", "_softmax", "_log_softmax",
    "log_sigmoid_forward",
}

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


class _Recorder(TorchDispatchMode):
    """Appends one Instruction per dispatched op to `comp`."""

    def __init__(self, comp: Computation, scope: str):
        super().__init__()
        self.comp = comp
        self.scope = scope
        self.names: Dict[int, str] = {}
        self.keep: List[torch.Tensor] = []  # ids stay unique while alive
        self.counter = itertools.count()
        self.open_region: Optional[Tuple[int, str]] = None  # (depth, name)
        self.kernel_calls: Dict[str, int] = {}

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
        closed over by the program) becomes a constant here."""
        if id(t) not in self.names:
            instr = Instruction(
                name=f"k{next(self.counter)}", opcode="constant",
                op_class=OpClass.CONSTANT, shape=_shape(t), operands=(),
                computation=self.comp.name, index=0, op_name=self.scope)
            self.comp.add(instr)
            self.bind(t, instr.name)
        return self.names[id(t)]

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
        operands = tuple(self.name_of(t) for t in flat_in)
        op_name, path, line = self.where()
        cls = _op_class(func)
        first = flat_out[0]
        name = _base_name(func)
        instr = Instruction(
            name=f"v{next(self.counter)}",
            opcode="gather" if name in _GATHERS else name, op_class=cls,
            shape=_shape(first), operands=operands,
            computation=self.comp.name, index=0, op_name=op_name,
            source_file=path, source_line=line)
        _annotate(instr, func, flat_in)
        self.comp.add(instr)
        self.bind(first, instr.name)
        for i, extra in enumerate(flat_out[1:], start=1):
            alias = Instruction(
                name=f"v{next(self.counter)}", opcode="get-tuple-element",
                op_class=OpClass.TUPLE, shape=_shape(extra),
                operands=(instr.name,), computation=self.comp.name,
                index=0, attributes={"index": str(i)}, op_name=op_name)
            self.comp.add(alias)
            self.bind(extra, alias.name)


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


def capture(fn: Callable, *args, name: Optional[str] = None,
            device=None) -> Module:
    """Capture `fn(*args)` into a `Module`.

    `args` may be nests of dicts, lists and tuples; their tensors (real,
    on any device) are replaced by fake tensors of the same shape and dtype
    (moved to `device` when given, so a CUDA program is captured from CPU
    tensors: `device="cuda"` needs no card).  Nothing runs on a device.
    The returned module's `kernel_calls` counts the regions of each hand
    kernel ({"flash_attention": 24, ...})."""
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
    recorder = _Recorder(comp, name)
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
    for leaf in reversed([o for o in tree_flatten(out)[0]
                          if isinstance(o, torch.Tensor)]):
        root = comp.get(recorder.names.get(id(leaf), ""))
        if root is not None:
            root.is_root = True
            break
    module.kernel_calls = dict(recorder.kernel_calls)
    _apply_fused_regions(module)
    return module
