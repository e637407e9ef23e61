"""Abstract input specs for every model input (the port of
`repro.launch.specs`).

No device allocation ever happens here: params, train state and decode
state are the port's own initializers run on `torch.device("meta")`, which
gives every leaf its shape and dtype and no storage (the counterpart of
`jax.eval_shape`), and batches are built there directly.  The same specs
drive the dry run (`launch/dryrun.py`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import init_decode_state, init_params
from ..runtime.steps import init_train_state

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"labels": _sds((b, s), torch.int32)}
        if cfg.frontend != "none":
            specs["embeds"] = _sds((b, s, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = _sds((b, s), torch.int32)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": _sds((b,), torch.int32), "pos": _sds((), torch.int32)}


def abstract_params(cfg: ArchConfig):
    return init_params(cfg, device=META)


def abstract_train_state(cfg: ArchConfig):
    return init_train_state(cfg, device=META)


def abstract_decode_state(cfg: ArchConfig, shape: ShapeConfig):
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every input of the lowered step for this (arch, shape) cell."""
    out: Dict[str, Any] = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "train":
        out["state"] = abstract_train_state(cfg)
    elif shape.kind == "decode":
        out["params"] = abstract_params(cfg)
        out["decode_state"] = abstract_decode_state(cfg, shape)
    else:  # prefill
        out["params"] = abstract_params(cfg)
    return out
