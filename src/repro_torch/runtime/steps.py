"""Serve and prefill step builders (the port of the serving half of
`repro.runtime.steps`; the train step belongs to a later slice).

`make_serve_step` is the reference's `make_serve_step(per_slot_pos=True)`:
    (params, decode_state, token (B,), pos (B,)) -> (next_token, logits, state)
one-token greedy decode in which every batch slot sits at its own position.
The reference vmaps a one-slot step over the batch; here the batch
dimension is written out in `attn_decode`, and the caches are updated in
place.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import decode_step as model_decode_step
from ..models import forward


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, state, token, pos):
        logits, state = model_decode_step(params, state, cfg, token, pos)
        return logits.argmax(dim=-1).int(), logits, state

    return serve_step


def make_prefill_step(cfg: ArchConfig, chunk: int = 512, device="cuda"):
    """Full-sequence forward for prefill (logits only).  The batch's
    `tokens` (B, S) are moved to `device`."""
    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"], device=device)
        logits, _ = forward(params, cfg, tokens, chunk=chunk)
        return logits

    return prefill_step
