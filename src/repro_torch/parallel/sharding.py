"""Sharding rules: param/activation PartitionSpecs for the production mesh
(the port of `repro.parallel.sharding`).

Axes: `"model"` carries tensor parallelism (Megatron col/row sharding,
vocab-parallel embeddings, expert parallelism for MoE); `("pod","data")` (or
`("data",)` single-pod) carries data parallelism, sequence parallelism for
batch-1 long-context decode, and ZeRO/FSDP weight sharding.

Rules match on (path suffix, rank).  Two automated passes follow the rules:

* **auto-FSDP**: any weight whose per-shard size still exceeds a threshold
  (`flags.fsdp_threshold_mb`) gets its largest remaining unsharded,
  divisible axis sharded over the DP axes (2-D weight sharding).
* **ZeRO-1**: optimizer moments/master weights reuse the param spec and then
  the same auto-pass with threshold 0 (always shard over DP when divisible),
  sharding optimizer state across the data axes.

The rules are the reference's, table and passes alike, as pure functions of
the mesh's axis names and sizes and of the leaves' paths and shapes: a
`PartitionSpec` here is a tuple of `None`, axis names or tuples of axis
names, and a tree is the port's nest of dicts and lists of tensors (on
`torch.device("meta")` for the dry run), its paths joined with "/" as the
reference's (`groups/0/attn/wq`).  As there, auto-FSDP and the decode
cache budget count 2 bytes an element whatever the leaf's dtype.
`param_shardings` gives each leaf's spec and per-device shape, as
`NamedSharding` does.  `placements` maps a spec to DTensor placements on a
mesh's `DeviceMesh`, `place` lays a tree out by its specs as DTensors (each
rank keeps its own shard of the full tensors it is handed), and `gather`
gives the full tensors back.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig
from ..models.flags import get_flags


class PartitionSpec(tuple):
    """The entries of a spec, one a leading dimension: `None`, an axis name
    or a tuple of axis names (`jax.sharding.PartitionSpec`'s)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (path regex, spec builder taking rank) — first match wins.  Specs are
# written for the *unstacked* trailing dims; a leading scan/stack axis is
# padded with None automatically by `_pad`.
_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/table$", ("model", None)),
    (r"head$", (None, "model")),
    # attention
    (r"attn/w[qkv]$", (None, "model")),
    (r"attn/b[qkv]$", ("model",)),
    (r"attn/wo$", ("model", None)),
    # MLA
    (r"attn/wq_a$", (None, "model")),
    (r"attn/wq_b$", (None, "model")),
    (r"attn/wkv_a$", (None, None)),
    (r"attn/wkv_b$", (None, "model")),
    (r"attn/(q|kv)_norm$", (None,)),
    # dense MLP
    (r"ffn/w_(gate|up)$", (None, "model")),
    (r"ffn/w_down$", ("model", None)),
    (r"ffn/shared/w_(gate|up)$", (None, "model")),
    (r"ffn/shared/w_down$", ("model", None)),
    # MoE experts: expert-parallel over "model"
    (r"ffn/router$", (None, None)),
    (r"ffn/w_(gate|up)$", ("model", None, None)),      # (E, D, ff)
    (r"ffn/w_down$", ("model", None, None)),           # (E, ff, D)
    # SSM
    (r"ssm/w_in$", (None, "model")),
    (r"ssm/w_out$", ("model", None)),
    (r"ssm/w_[bc]$", ("model", None)),
    (r"ssm/(w_dt|d_skip)$", ("model",)),
    (r"ssm/a_log$", ("model", None)),
    # mLSTM / sLSTM
    (r"mlstm/w_up$", (None, "model")),
    (r"mlstm/w_down$", ("model", None)),
    (r"mlstm/w[qkv]$", ("model", None)),
    (r"mlstm/w_if$", (None, None)),
    (r"mlstm/norm$", (None,)),
    (r"slstm/(w|r)_gates$", (None, "model")),
    (r"slstm/ffn_(gate|up)$", (None, "model")),
    (r"slstm/ffn_down$", ("model", None)),
    # norms and everything else: replicated
    (r".*", ()),
]


def _fsdp_threshold_bytes() -> int:
    """The auto-FSDP threshold, `flags.fsdp_threshold_mb` MiB (the
    reference's fixed `_FSDP_THRESHOLD_BYTES` is its default, 128 MiB)."""
    return get_flags().fsdp_threshold_mb * 2**20


# -- trees -------------------------------------------------------------------

def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) of a dict, list or tuple node; None for a leaf (a
    tensor, a `PartitionSpec`, a `Sharding`)."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, (PartitionSpec, Sharding)):
        return list(enumerate(tree))
    return None


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree,
                       path: Tuple = ()) -> Any:
    """`fn(path, leaf)` over a nest of dicts, lists and tuples; `path` is
    the keys and indices from the root (`jax.tree_util.
    tree_map_with_path`'s, without its key classes)."""
    children = _children(tree)
    if children is None:
        return fn(path, tree)
    mapped = [(k, tree_map_with_path(fn, v, path + (k,)))
              for k, v in children]
    return dict(mapped) if isinstance(tree, dict) else \
        type(tree)(v for _, v in mapped)


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf, in the tree's order."""
    children = _children(tree)
    if children is None:
        return [(path, tree)]
    return [pl for k, v in children
            for pl in tree_leaves_with_path(v, path + (k,))]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


# -- the rule math ----------------------------------------------------------

def _pad(spec: Tuple, rank: int) -> P:
    """Left-pad a trailing-dims spec with None up to the leaf's rank.

    MoE expert banks are rank-3 specs; under a layer stack they become
    rank-4.  Dense rules are rank-2.  Rank-1 rules cover biases/norm scales.
    """
    if len(spec) > rank:
        return P(*spec[len(spec) - rank:])
    return P(*((None,) * (rank - len(spec)) + tuple(spec)))


def _spec_for(path: str, shape: Tuple[int, ...], is_moe_leaf: bool) -> P:
    rank = len(shape)
    for pattern, spec in _RULES:
        # Disambiguate moe vs dense ffn rules by rank: expert banks have an
        # extra E axis (rank 3 before stacking, 4 after).
        if pattern.startswith(r"ffn/w_") and "shared" not in pattern:
            if is_moe_leaf != (len(spec) == 3):
                continue
        if re.search(pattern, path):
            return _pad(spec, rank)
    return P()


def _divisibility_filter(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop sharded entries whose axis size does not divide the dim (an
    uneven sharding is refused — e.g. hymba's vocab of 32001)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is not None and dim % _axis_size(mesh, e) != 0:
            e = None
        out.append(e)
    return P(*out)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _auto_shard_dp(spec: P, shape: Tuple[int, ...], mesh,
                   dp_axes: Tuple[str, ...],
                   threshold_bytes: int, itemsize: int = 2) -> P:
    """Shard the largest remaining divisible axis over DP if the per-shard
    size exceeds `threshold_bytes` (auto-FSDP / ZeRO pass)."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dp_size = _axis_size(mesh, dp)
    if dp_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    shard_sizes = [
        shape[i] // _axis_size(mesh, entries[i]) for i in range(len(shape))]
    per_shard = math.prod(shard_sizes) * itemsize if shape else itemsize
    if per_shard <= threshold_bytes:
        return spec
    # biggest unsharded axis divisible by dp_size
    cands = [(shard_sizes[i], i) for i in range(len(shape))
             if entries[i] is None and shape[i] % dp_size == 0 and
             shard_sizes[i] % dp_size == 0]
    if not cands:
        return spec
    _, idx = max(cands)
    entries[idx] = dp
    return P(*entries)


class Sharding(NamedTuple):
    """A leaf's spec and the shape of its shard on each device
    (`NamedSharding(mesh, spec)` and its `shard_shape`)."""
    spec: P
    shard_shape: Tuple[int, ...]


def shard_shape(spec: P, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The per-device shape of a `shape` leaf under `spec`; an axis size
    that does not divide its dimension raises, as `jax.sharding`'s
    `shard_shape` does."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        n = _axis_size(mesh, e)
        if dim % n:
            raise ValueError(f"spec {spec} splits dimension {dim} of "
                             f"{shape} {n} ways, not evenly")
        out.append(dim // n)
    return tuple(out)


class ShardingRules:
    def __init__(self, mesh, cfg: ArchConfig,
                 fsdp: bool = True, zero1: bool = True):
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp = fsdp
        self.zero1 = zero1
        names = mesh.axis_names
        self.dp_axes: Tuple[str, ...] = tuple(
            a for a in names if a in ("pod", "data"))
        self.dp_spec = self.dp_axes if len(self.dp_axes) > 1 else \
            self.dp_axes[0]
        self.tp = mesh.shape.get("model", 1)

    def _head_filter(self, path: str, spec: P, shape: Tuple[int, ...]) -> P:
        """Drop "model" sharding that would cut *inside* attention heads.

        Sharding wk (D, Kv*hd) 16-way when Kv=2 slices within a head, and
        the score contraction would be sharded with a per-chunk all-reduce
        (the reference's first catch by LEO).  Megatron practice: head
        projections shard over "model" only when the head count divides
        TP; otherwise the (small) projection is replicated and the arch
        runs attention data-parallel.  mLSTM/sLSTM mixers have few heads
        (and matrix-memory states) — replicated likewise; their model
        parallelism comes from the vocab-sharded embedding/head.
        """
        cfg = self.cfg
        q_ok = cfg.n_heads % self.tp == 0
        kv_ok = cfg.n_kv_heads % self.tp == 0
        drop = False
        if re.search(r"attn/(wq|bq|wq_a|wq_b)$", path) or \
                re.search(r"attn/wo$", path):
            drop = not q_ok
        elif re.search(r"attn/(wk|wv|bk|bv)$", path):
            drop = not kv_ok
        elif re.search(r"attn/wkv_b$", path):
            drop = not q_ok  # MLA up-projection is per-head
        elif re.search(r"(mlstm|slstm)/", path):
            drop = cfg.n_heads % self.tp != 0 or "mlstm" in path or \
                "slstm" in path
        if not drop:
            return spec
        return P(*[None if e == "model" else e for e in spec])

    def _is_moe(self, ps: str, shape: Tuple[int, ...]) -> bool:
        return self.cfg.n_experts > 0 and "/ffn/" in ps and \
            "shared" not in ps and len(shape) >= 4

    # -- params ---------------------------------------------------------------

    def param_specs(self, params_shape) -> Any:
        def leaf(path, leaf_sds):
            ps, shape = _path_str(path), _shape(leaf_sds)
            is_moe = self._is_moe(ps, shape)
            spec = _spec_for(ps, shape, is_moe)
            spec = self._head_filter(ps, spec, shape)
            spec = _divisibility_filter(spec, shape, self.mesh)
            if is_moe and get_flags().moe_impl == "ep_shardmap":
                return spec  # stationary expert weights: no FSDP
            if self.fsdp:
                spec = _auto_shard_dp(spec, shape, self.mesh,
                                      self.dp_axes, _fsdp_threshold_bytes())
            return spec
        return tree_map_with_path(leaf, params_shape)

    def param_shardings(self, params_shape) -> Any:
        return shardings(self.param_specs(params_shape), params_shape,
                         self.mesh)

    # -- optimizer state (ZeRO-1) ------------------------------------------------

    def opt_specs(self, opt_shape, params_shape) -> Any:
        def like_params(tree):
            def leaf(path, leaf_sds):
                ps, shape = _path_str(path), _shape(leaf_sds)
                spec = _spec_for(ps, shape, self._is_moe(ps, shape))
                spec = self._head_filter(ps, spec, shape)
                spec = _divisibility_filter(spec, shape, self.mesh)
                if self.zero1:
                    spec = _auto_shard_dp(spec, shape, self.mesh,
                                          self.dp_axes, 0, itemsize=4)
                elif self.fsdp:
                    spec = _auto_shard_dp(spec, shape, self.mesh,
                                          self.dp_axes,
                                          _fsdp_threshold_bytes(),
                                          itemsize=4)
                return spec
            return tree_map_with_path(leaf, tree)

        return {
            "mu": like_params(opt_shape["mu"]),
            "nu": like_params(opt_shape["nu"]),
            "master": like_params(opt_shape["master"]),
            "count": P(),
        }

    # -- activations / step inputs -------------------------------------------------

    def batch_specs(self, cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, P]:
        dp = self.dp_spec
        if shape.kind in ("train", "prefill"):
            specs = {"labels": P(dp, None)}
            if cfg.frontend != "none":
                specs["embeds"] = P(dp, None, None)
            else:
                specs["tokens"] = P(dp, None)
            return specs
        # decode: batch-1 long-context cannot shard batch
        if shape.global_batch < _axis_size(self.mesh, dp):
            return {"token": P(None), "pos": P()}
        return {"token": P(dp), "pos": P()}

    def decode_state_specs(self, state_shape, shape: ShapeConfig) -> Any:
        dp = self.dp_spec
        batch_shardable = shape.global_batch >= _axis_size(self.mesh, dp)

        cache_budget = 8 * 2**30  # per-chip bytes before seq-sharding

        def leaf(path, leaf_sds):
            dims = _shape(leaf_sds)
            rank = len(dims)
            # leading axis is the layer stack; axis 1 is batch
            if batch_shardable:
                entries = [None, dp] + [None] * (rank - 2)
                # KV caches too large for batch sharding alone (MHA archs
                # like musicgen at 32k x 128) additionally shard the
                # sequence axis over "model"; decode attention reduces
                # partial softmax stats across it.
                per_shard = math.prod(dims) * 2 // \
                    max(_axis_size(self.mesh, dp), 1)
                if per_shard > cache_budget and rank >= 3:
                    seq_axis = _argmax(dims[2:]) + 2
                    if dims[seq_axis] % self.tp == 0:
                        entries[seq_axis] = "model"
                return P(*entries)
            # batch-1: shard the longest axis (sequence for KV caches) over
            # data — sequence parallelism for long-context decode.
            if rank >= 3:
                seq_axis = _argmax(dims[2:]) + 2
                if dims[seq_axis] % _axis_size(self.mesh, dp) == 0:
                    entries = [None] * rank
                    entries[seq_axis] = dp
                    return P(*entries)
            return P()
        return tree_map_with_path(leaf, state_shape)

    def logits_spec(self, shape: ShapeConfig) -> P:
        dp = self.dp_spec
        if shape.kind == "decode" and \
                shape.global_batch < _axis_size(self.mesh, dp):
            return P(None, "model")
        return P(dp, "model") if shape.kind == "decode" else P(dp, None, None)


def _argmax(dims: Tuple[int, ...]) -> int:
    """The first index of the largest value, as `np.argmax`."""
    return max(range(len(dims)), key=lambda i: (dims[i], -i))


def shardings(specs, tree, mesh) -> Any:
    """`Sharding(spec, shard shape)` of each leaf of `tree` under the
    same-structured `specs`."""
    return tree_map_with_path(
        lambda path, leaf: Sharding(
            _at(specs, path), shard_shape(_at(specs, path), _shape(leaf),
                                          mesh)), tree)


def _at(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def per_device_bytes(specs, tree, mesh) -> int:
    """Bytes of `tree`'s leaves on each device under `specs`: each leaf's
    shard shape times its element size."""
    return sum(math.prod(shard_shape(_at(specs, path), _shape(leaf), mesh))
               * leaf.element_size()
               for path, leaf in tree_leaves_with_path(tree))


# -- DTensor placements ------------------------------------------------------

def placements(spec: P, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of `spec` on `mesh`, one a mesh axis in the
    mesh's order: `Shard(dim)` on each axis an entry names, `Replicate()`
    on the others.  An entry naming two axes, as auto-FSDP's
    `("pod", "data")`, shards its dimension over both, the first axis
    major: DTensor's order of `Shard`s on one dimension, `jax.sharding`'s
    too."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate() for _ in mesh.axis_names]
    for dim, e in enumerate(spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        for a in names:
            i = mesh.axis_names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} shards two dimensions over "
                                 f"axis {a!r}")
            out[i] = Shard(dim)
        if len(names) > 1 and [mesh.axis_names.index(a) for a in names] != \
                sorted(mesh.axis_names.index(a) for a in names):
            raise ValueError(f"spec {spec} names axes {names} out of the "
                             f"mesh's order {mesh.axis_names}")
    return tuple(out)


def local_part(t, spec: P, mesh, coords: Dict[str, int]):
    """This rank's shard of the full tensor `t` under `spec` (a view):
    along each sharded dimension, the part at the rank's linear index over
    the entry's axes, the first axis major."""
    out = t
    for dim, e in enumerate(spec):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        n, i = 1, 0
        for a in names:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + coords[a]
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"spec {spec} splits dimension {dim} of "
                             f"{tuple(t.shape)} {n} ways, not evenly")
        part = out.shape[dim] // n
        out = out.narrow(dim, i * part, part)
    return out


def place(tree, specs, mesh) -> Any:
    """`tree`'s tensors as DTensors on `mesh`'s `DeviceMesh`, each laid
    out by its spec in the same-structured `specs`.  Every rank hands in
    the same full tensors (made from one seed, or read from one
    checkpoint) and keeps its own shard of each: nothing is sent.  On a
    mesh with no `DeviceMesh` behind it (one device, no process group)
    each tensor is its own shard and the tree is returned as it is."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh
    if dm is None:
        return tree
    coords = dict(zip(mesh.axis_names, dm.get_coordinate()))

    def leaf(path, t):
        spec = _at(specs, path)
        local = local_part(t, spec, mesh, coords).contiguous()
        return DTensor.from_local(local, dm, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.contiguous().stride())
    return tree_map_with_path(leaf, tree)


def gather(tree) -> Any:
    """The full tensors of a tree of DTensors (every rank takes part: an
    all-gather a sharded leaf); plain tensors pass through."""
    from torch.distributed.tensor import DTensor
    return tree_map_with_path(
        lambda path, t: t.full_tensor() if isinstance(t, DTensor) else t,
        tree)
