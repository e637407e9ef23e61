"""Crash-consistent checkpointing (the port of
`repro.checkpoint.checkpointer`), byte-compatible with the reference: a
checkpoint written by either package restores in the other, bit for bit.

Layout per step:
    <dir>/step_<n>.tmp/...      (in progress; ignored by restore)
    <dir>/step_<n>/
        arrays.npz              (flattened leaves, path-keyed)
        manifest.json           (step, tree paths, shapes/dtypes, checksums)
    <dir>/LATEST                (atomic pointer file)

Writes go to a `.tmp` directory first and are renamed into place only after
the manifest (with per-array adler32 checksums) is fsynced — a torn write
can never be mistaken for a valid checkpoint.  Restore validates checksums
and falls back to the previous checkpoint on corruption.

The tree is a nest of dicts and lists of tensors, flattened as
`jax.tree_util` flattens the reference's: dict keys sorted, list items by
index, a leaf's key its path joined by "/" ("opt/master/embed/table",
"params/groups/0/ln2", "step").  Each leaf is stored as its raw bytes (a
`uint8` vector), so bfloat16 needs no numpy dtype: the manifest carries the
dtype's name ("bfloat16", "float32", "int32"), the reference's names.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _raw(leaf) -> Tuple[np.ndarray, List[int], str]:
    """A leaf's bytes as a uint8 vector on the host (a view where the leaf
    is a contiguous CPU tensor), its shape and its dtype's name."""
    t = torch.as_tensor(leaf).detach()
    raw = t.reshape(-1).view(torch.uint8).cpu().numpy()
    return raw, list(t.shape), _NAMES[t.dtype]


def save_checkpoint(directory: str, step: int, state) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "arrays": {}}
    for key, leaf in _flatten(state):
        raw, shape, dtype = _raw(leaf)
        arrays[key] = raw
        manifest["arrays"][key] = {
            "shape": shape,
            "dtype": dtype,
            "adler32": zlib.adler32(raw),
        }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest = os.path.join(directory, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest + ".tmp", latest)
    return final


def list_checkpoints(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    out = [d for d in sorted(os.listdir(directory))
           if d.startswith("step_") and not d.endswith(".tmp") and
           os.path.isfile(os.path.join(directory, d, "manifest.json"))]
    return out


def _decode(raw: np.ndarray, meta: Dict[str, Any], key: str,
            like: torch.Tensor, device) -> torch.Tensor:
    dtype = DTYPES[meta["dtype"]]
    if dtype != like.dtype or list(meta["shape"]) != list(like.shape):
        raise ValueError(f"checkpoint leaf {key}: {meta['dtype']} "
                         f"{meta['shape']}, the state wants {like.dtype} "
                         f"{list(like.shape)}")
    t = torch.from_numpy(raw).view(dtype).reshape(meta["shape"])
    return t.to(like.device if device is None else device)


def _load(path: str, flat_like: List[Tuple[str, Any]], device
          ) -> Optional[Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """The manifest and the leaves of `flat_like`, each array read once and
    held to its adler32; None if the checkpoint is corrupt or lacks a leaf
    of `flat_like`."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        wanted = dict(flat_like)
        leaves = {}
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            if not wanted.keys() <= set(npz.files):
                return None
            for key, meta in manifest["arrays"].items():
                raw = npz[key]
                if zlib.adler32(raw) != meta["adler32"]:
                    return None
                if key in wanted:
                    leaves[key] = (raw, meta)
    except Exception:
        return None
    return manifest, {key: _decode(raw, meta, key, wanted[key], device)
                      for key, (raw, meta) in leaves.items()}


def restore_checkpoint(directory: str, like, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int]:
    """Restore into the structure, dtypes and device of `like` (or onto
    `device`).  Picks the latest valid checkpoint (or `step`), skipping
    corrupt ones.  A leaf whose dtype or shape differs from `like`'s
    raises: the checkpoint belongs to another configuration."""
    cands = list_checkpoints(directory)
    if step is not None:
        cands = [c for c in cands if c == f"step_{step:08d}"]
    flat_like = [(k, torch.as_tensor(v)) for k, v in _flatten(like)]
    for name in reversed(cands):
        loaded = _load(os.path.join(directory, name), flat_like, device)
        if loaded is None:
            continue
        manifest, leaves = loaded
        return _unflatten(like, leaves), int(manifest["step"])
    raise FileNotFoundError(f"no valid checkpoint in {directory}")
