"""The per-device program of an N-device mesh: its collectives and its view
of the mesh (the port's counterpart of what XLA's SPMD partitioner writes
for the reference, and of `jax.shard_map`'s body).

A step on a mesh of more than one device runs as one program a rank, on
the rank's own shards of each tensor (`parallel/sharding.py::place` lays
them out as DTensors by the sharding rules; `runtime/steps.py::
shard_step` hands the program their local tensors and wraps what it
returns).  While the program runs, `current()` is its `Local`: the mesh, this rank's
coordinates, and the process group of each axis or tuple of axes.  The
model reads it where a layer's weights are sharded (`models/`), and
issues the collectives below itself, as Megatron-LM writes tensor and
sequence parallelism by hand.  DTensor's own operator-by-operator
propagation is not used inside the program: the port's plain paths
(chunked attention's masks, the MoE's sorts and index adds, the scans)
have no sharding strategies, and a capture of DTensor ops records each
op twice (once where DTensor propagates its sharding on fake tensors,
once on the local shard).

Each collective is the functional op of `torch.ops._c10d_functional`
followed by its `wait_tensor`, so a capture (`core/torch_frontend.py`)
records it as the reference's HLO collective.  On an axis of one device a
collective is the identity and issues nothing: on the card's own `(1, 1)`
mesh the program is the one-card program, op for op.

Gradients follow two conventions, by axis:

* over the data axes a gradient is *partial*: each rank holds its share
  of the batch's gradient and the shares sum to the whole (the loss a rank
  differentiates is its share of the global loss);
* over "model" a value computed alike on every rank (replicated) has the
  same gradient on every rank; a tensor-parallel region's gradients are
  partial and are summed where the region is entered, Megatron's `f`
  (`copy_to` here) and `g` (`all_reduce` with an identity backward).

Every collective here names the backward that keeps these conventions.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Tuple[str, ...]]

_CURRENT: Optional["Local"] = None


def current() -> Optional["Local"]:
    """The running per-device program's `Local`, None outside one."""
    return _CURRENT


@contextlib.contextmanager
def local_program(local: Optional["Local"]):
    """Run the body as `local`'s per-device program (None: the step of one
    device with no process group, which issues no collective)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = local
    try:
        yield local
    finally:
        _CURRENT = prev


def program(mesh, batch_axes: Optional[Tuple[str, ...]] = None):
    """`local_program` of rank `mesh.device_mesh.get_coordinate()` of
    `mesh`; on a mesh with no `DeviceMesh` behind it (one device, no
    process group) the body runs as the one-device step."""
    return local_program(None if mesh.device_mesh is None
                         else Local.of(mesh, batch_axes))


def _tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclass
class Local:
    """One rank's view of a mesh with a `DeviceMesh` behind it: the axes in
    order, this rank's coordinate on each, and the group of each axis or
    tuple of axes (a tuple's group is the flattened sub-mesh, its ranks in
    the axes' order, so a dimension sharded over ("pod", "data") is laid
    out pod-major, as `jax.sharding` lays it)."""
    mesh: "object"                      # launch.mesh.Mesh
    coords: Dict[str, int]
    # the axes the step's batch rows are cut over: the data axes, or none
    # where a decode batch is smaller than them (batch-1 long context)
    batch_axes: Tuple[str, ...] = ()
    # the axes each decode-state KV cache's positions are cut over, by
    # the id of its "k" buffer (set by the serve step's program)
    kv_seq_axes: Dict[int, Tuple[str, ...]] = field(default_factory=dict)
    _groups: Dict[Tuple[str, ...], Tuple[str, int]] = field(
        default_factory=dict)

    @classmethod
    def of(cls, mesh, batch_axes: Optional[Tuple[str, ...]] = None
           ) -> "Local":
        dm = mesh.device_mesh
        if dm is None:
            raise RuntimeError(f"the {mesh.shape} mesh has no DeviceMesh "
                               f"behind it: no per-device program runs on it")
        coords = dict(zip(mesh.axis_names, dm.get_coordinate()))
        local = cls(mesh, coords)
        local.batch_axes = local.dp_axes if batch_axes is None \
            else tuple(batch_axes)
        # resolved here, before any capture: slicing a DeviceMesh runs
        # tensor ops of its own
        names = mesh.axis_names
        for bits in range(1, 2 ** len(names)):
            local.group(tuple(a for i, a in enumerate(names)
                              if bits >> i & 1))
        return local

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names if a != "model")

    def size(self, axes: Axes) -> int:
        return math.prod(self.mesh.shape[a] for a in _tuple(axes))

    def index(self, axes: Axes) -> int:
        """This rank's linear index over `axes`, the first axis major."""
        i = 0
        for a in _tuple(axes):
            i = i * self.mesh.shape[a] + self.coords[a]
        return i

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("model", 1)

    def group(self, axes: Axes) -> Tuple[str, int]:
        """(group name, size) of the process group over `axes`."""
        key = tuple(a for a in self.mesh.axis_names if a in _tuple(axes))
        if key not in self._groups:
            # the flattened sub-meshes are built once a DeviceMesh
            dm = self.mesh.device_mesh
            built = dm.__dict__.setdefault("_spmd_groups", {})
            if key not in built:
                sub = dm[key[0]] if len(key) == 1 else \
                    dm[key]._flatten("_".join(key))
                built[key] = (sub.get_group().group_name, sub.size())
            self._groups[key] = built[key]
        return self._groups[key]


def tp_size() -> int:
    """The "model" axis's size of the running program, 1 outside one."""
    local = current()
    return 1 if local is None else local.tp


# -- the functional collectives -------------------------------------------

def _c10d():
    return torch.ops._c10d_functional


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _c10d().wait_tensor(t)


def _raw_all_reduce(x: torch.Tensor, axes: Axes, op: str = "sum"
                    ) -> torch.Tensor:
    name, n = current().group(axes)
    if n == 1:
        return x
    return _wait(_c10d().all_reduce(x.contiguous(), op, name))


def _raw_all_gather(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """The shards of `axes`' ranks laid end to end along `dim`."""
    name, n = current().group(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    moved = x.movedim(dim, 0).contiguous()
    out = _wait(_c10d().all_gather_into_tensor(moved, n, name))
    # laid out as its input (a weight gathered for the next step must be
    # contiguous, as the kernels take their inputs)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _raw_reduce_scatter(x: torch.Tensor, axes: Axes, dim: int
                        ) -> torch.Tensor:
    """The sum over `axes`' ranks, cut along `dim`: this rank's part."""
    name, n = current().group(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {tuple(x.shape)} along {dim} "
                         f"over {n} ranks does not divide")
    moved = x.movedim(dim, 0).contiguous()
    out = _wait(_c10d().reduce_scatter_tensor(moved, "sum", n, name))
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _raw_all_to_all(x: torch.Tensor, axes: Axes, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)`:
    x cut into n parts along `split_dim`, part j sent to rank j, the parts
    received laid end to end along `concat_dim` in rank order."""
    name, n = current().group(axes)
    if n == 1:
        return x
    split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"all-to-all of {tuple(x.shape)} along "
                         f"{split_dim} over {n} ranks does not divide")
    moved = x.movedim(split_dim, 0).contiguous()
    rows = moved.shape[0] // n
    out = _wait(_c10d().all_to_all_single(moved, [rows] * n, [rows] * n,
                                          name))
    parts = out.reshape((n, rows) + tuple(moved.shape[1:])).unbind(0)
    return torch.cat([p.movedim(0, split_dim) for p in parts],
                     dim=concat_dim)


def _slice(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's part of `x` cut into `size(axes)` along `dim`."""
    local = current()
    n = local.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{tuple(x.shape)} along {dim} does not split "
                         f"over {n} ranks")
    part = x.shape[dim] // n
    return x.narrow(dim, local.index(axes) * part, part)


def _pad(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """`x`, this rank's part along `dim`, in a zero tensor of the whole."""
    local = current()
    n = local.size(axes)
    if n == 1:
        return x
    dim = dim % x.ndim
    i = local.index(axes)
    before = list(x.shape)
    before[dim] = i * x.shape[dim]
    after = list(x.shape)
    after[dim] = (n - 1 - i) * x.shape[dim]
    return torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim=dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, bwd_sum):
        ctx.axes, ctx.bwd_sum = axes, bwd_sum
        return _raw_all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return (_raw_all_reduce(g, ctx.axes) if ctx.bwd_sum else g), \
            None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.axes), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, bwd):
        ctx.axes, ctx.dim, ctx.bwd = axes, dim, bwd
        return _raw_all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "sum":
            g = _raw_reduce_scatter(g, ctx.axes, ctx.dim)
        else:
            g = _slice(g, ctx.axes, ctx.dim).contiguous()
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return _raw_reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.axes, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, bwd):
        ctx.axes, ctx.dim, ctx.bwd = axes, dim, bwd
        return _slice(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "gather":
            g = _raw_all_gather(g, ctx.axes, ctx.dim)
        else:
            g = _pad(g, ctx.axes, ctx.dim)
        return g, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, split_dim, concat_dim):
        ctx.args = (axes, concat_dim, split_dim)
        return _raw_all_to_all(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_to_all(g, *ctx.args), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _one(axes: Axes) -> bool:
    local = current()
    return local is None or local.size(axes) == 1


def all_reduce(x: torch.Tensor, axes: Axes, bwd: str = "identity"
               ) -> torch.Tensor:
    """The sum over `axes`.  Backward: `"identity"` where the sum's users
    are alike on every rank (Megatron's `g`), `"sum"` where their
    gradients are partial (the data axes)."""
    if _one(axes):
        return x
    return _AllReduce.apply(x, axes, bwd == "sum")


def all_reduce_max(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The elementwise max over `axes`, without a gradient."""
    if _one(axes):
        return x
    return _raw_all_reduce(x.detach(), axes, "max")


def copy_to(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The identity, whose backward sums the gradient over `axes`: the
    entry of a tensor-parallel region (Megatron's `f`), or a weight used
    on tokens that differ from rank to rank."""
    if _one(axes):
        return x
    return _CopyTo.apply(x, axes)


def all_gather(x: torch.Tensor, axes: Axes, dim: int, bwd: str = "sum"
               ) -> torch.Tensor:
    """The ranks' shards laid end to end along `dim`.  Backward `"sum"`
    reduce-scatters (the users' gradients are partial: a tensor-parallel
    region, or the data axes); `"slice"` takes this rank's part (the users
    run alike on every rank)."""
    if _one(axes):
        return x
    return _AllGather.apply(x, axes, dim, bwd)


def reduce_scatter(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """The sum over `axes`, this rank's part along `dim`; backward an
    all-gather."""
    if _one(axes):
        return x
    return _ReduceScatter.apply(x, axes, dim)


def scatter(x: torch.Tensor, axes: Axes, dim: int, bwd: str = "gather"
            ) -> torch.Tensor:
    """This rank's part along `dim` of a value alike on every rank of
    `axes`.  Backward `"gather"` all-gathers the parts' gradients (over
    "model": the value's users run alike); `"zeros"` puts this rank's part
    in zeros (over the data axes: the gradient stays partial)."""
    if _one(axes):
        return x
    return _Scatter.apply(x, axes, dim, bwd)


def all_to_all(x: torch.Tensor, axes: Axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all (`_raw_all_to_all`); backward the all-to-all
    back."""
    if _one(axes):
        return x
    return _AllToAll.apply(x, axes, split_dim, concat_dim)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The identity, whose backward scales the gradient."""
    if scale == 1.0:
        return x
    return _ScaleGrad.apply(x, scale)


# -- the sharded dimensions of a spec ------------------------------------------

def sharded_dims(spec: Sequence, axes: Sequence[str]) -> Dict[int, Tuple[
        str, ...]]:
    """{dim: the axes of `axes` that `spec` shards it over}."""
    out = {}
    for d, e in enumerate(spec):
        hit = tuple(a for a in _tuple(e) if a in axes)
        if hit:
            out[d] = hit
    return out


# -- a tree's leaves as the program reads them -----------------------------

# the leaves whose "model" cut a layer's own tensor-parallel form reads
# (`models/`): attention's heads (GQA's projections; MLA's `wq_a` by its
# q_lora columns, `wq_b`/`wkv_b` by head-major columns, `wo` by rows), the
# dense and the shared experts' MLP by columns and rows, the expert banks
# by expert (either MoE form), the vocab-parallel embedding and head; and
# in a decode step the SSM's channels (`models/ssm.py::ssm_decode`).
# Every other leaf the rules cut over "model" (the SSM's, in a train or
# prefill step) is gathered whole for the layer.  Where the rules drop a
# cut (heads that do not divide the axis) the leaf arrives whole and its
# layer runs whole: each layer reads its local width off the leaf's shape.
_TP_LEAVES = re.compile(r"attn/(wq|wk|wv|bq|bk|bv|wo|wq_a|wq_b|wkv_b)$|"
                        r"ffn/(shared/)?(w_gate|w_up|w_down)$|"
                        r"^embed/table$|^head$")
_TP_DECODE_LEAVES = re.compile(r"ssm/(w_in|w_b|w_c|w_dt|a_log|d_skip|"
                               r"w_out)$")


def tensor_parallel_leaf(path: str, decode: bool = False) -> bool:
    """Whether the layer that reads the leaf at `path` runs on its "model"
    shard as it is (in a decode step where `decode`)."""
    return bool(_TP_LEAVES.search(path) or
                decode and _TP_DECODE_LEAVES.search(path))


def materialize(tree, specs, decode: bool = False):
    """Each leaf of `tree` (this rank's shards, laid out by the
    same-structured `specs`) as the per-device program reads it: gathered
    along each dimension the data axes cut (auto-FSDP; the gradient
    reduce-scattered back, partial sums added), and along a dimension cut
    over "model" unless a layer runs on the shard (`tensor_parallel_leaf`,
    of a decode step where `decode`; the gradient of a layer run alike on
    every rank sliced back).  Outside a per-device program the tree is
    whole already."""
    from .sharding import _at, _path_str, tree_map_with_path
    local = current()
    if local is None:
        return tree
    dp = local.dp_axes

    def leaf(path, t):
        spec = _at(specs, path)
        for d, axes in sharded_dims(spec, dp).items():
            t = all_gather(t, axes, d, bwd="sum")
        if not tensor_parallel_leaf(_path_str(path), decode):
            for d, axes in sharded_dims(spec, ("model",)).items():
                t = all_gather(t, axes, d, bwd="slice")
        return t
    return tree_map_with_path(leaf, tree)
