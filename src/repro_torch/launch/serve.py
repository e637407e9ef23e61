"""Batched serving driver: slot-based continuous batching over decode_step
(the port of `repro.launch.serve`).

Requests (token prompts) fill a fixed pool of batch slots; each engine tick
decodes one token for every slot; finished sequences release their slot to
queued requests.  Every slot decodes at its own position, so a freed slot
admits a new request at pos 0 while its neighbours keep decoding.  Prompts
enter by teacher-forced decode of their tokens (prefill-by-decode).

  python -m repro_torch.launch.serve                     # qwen2-0.5b, card
  python -m repro_torch.launch.serve --arch hymba-1.5b   # full width, card
  python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
  python -m repro_torch.launch.serve --arch xlstm-125m   # mLSTM + sLSTM
  python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu
  python -m repro_torch.launch.serve --arch musicgen-medium     # GELU MLP
  python -m repro_torch.launch.serve --arch internvl2-2b
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --layers 8
  python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 4
  python -m repro_torch.launch.serve --arch deepseek-v2-236b --smoke \
      --device cpu                                         # MLA + MoE

Every configuration is served by tokens, as the reference's engine serves
them (musicgen-medium's and internvl2-2b's front-ends give embeddings to
prefill, not to decode).  On the card a configuration whose weights exceed
the card's memory is refused before anything is allocated: phi3.5-moe
(77.99 GiB of bf16 weights) and deepseek-v2 (445.9 GiB) serve on one H100
only with their depth cut (`--layers`).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0
    feed_idx: int = 0   # how much of the prompt is consumed


class ServeEngine:
    def __init__(self, cfg, params, batch_slots: int = 8, max_len: int = 1024,
                 device="cuda"):
        from ..models import init_decode_state
        from ..runtime.steps import make_serve_step

        self.cfg = cfg
        self.params = params
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.state = init_decode_state(cfg, batch_slots, max_len,
                                       self.device)
        # one slot of pristine state, copied into a slot at admission:
        # recurrent mixers carry state across tokens, so a reused slot must
        # not pass its previous occupant's state to the next request
        self._fresh_state = init_decode_state(cfg, 1, max_len, self.device)
        self.last_logits: Optional[torch.Tensor] = None  # (B, V), last tick
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Request] = []
        self.ticks = 0
        self._step = make_serve_step(cfg, per_slot_pos=True)

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def _reset_slot_state(self, idx: int) -> None:
        """Overwrite batch slot `idx` (axis 1 of every (L, B, ...) state
        leaf) with freshly initialized decode state, in place."""
        def copy(state, fresh):
            if isinstance(state, dict):
                for key in state:
                    copy(state[key], fresh[key])
            elif isinstance(state, list):
                for st, fr in zip(state, fresh):
                    copy(st, fr)
            else:
                state[:, idx] = fresh[:, 0]

        copy(self.state, self._fresh_state)

    def _fill_slots(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request is None and self.queue:
                slot.request = self.queue.pop(0)
                slot.pos = 0
                slot.feed_idx = 0
                self._reset_slot_state(i)

    @property
    def active(self) -> bool:
        return bool(self.queue) or any(s.request for s in self.slots)

    def tick(self) -> None:
        """One engine step: feed a prompt token or the last generated one."""
        self._fill_slots()
        tokens = np.zeros((self.batch_slots,), np.int64)
        pos = np.zeros((self.batch_slots,), np.int64)
        for i, slot in enumerate(self.slots):
            pos[i] = slot.pos
            r = slot.request
            if r is None:
                continue
            if slot.feed_idx < len(r.prompt):
                tokens[i] = r.prompt[slot.feed_idx]
            else:
                tokens[i] = r.generated[-1] if r.generated else 0
        next_tok, self.last_logits, self.state = self._step(
            self.params, self.state, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        next_tok = next_tok.cpu().numpy()
        self.ticks += 1
        for i, slot in enumerate(self.slots):
            r = slot.request
            if r is None:
                continue
            slot.pos += 1
            if slot.feed_idx < len(r.prompt):
                slot.feed_idx += 1
                if slot.feed_idx == len(r.prompt):
                    r.generated.append(int(next_tok[i]))
            else:
                r.generated.append(int(next_tok[i]))
            if len(r.generated) >= r.max_new_tokens or \
                    slot.pos >= self.max_len - 1:
                r.done = True
                slot.request = None

    def run(self) -> None:
        while self.active:
            self.tick()


def check_fits(cfg, total_bytes: int) -> int:
    """The bytes of `cfg`'s weights (`models.weight_bytes`, counted on
    shapes); raises ValueError where they exceed `total_bytes`."""
    from ..models import weight_bytes

    need = weight_bytes(cfg)
    if need > total_bytes:
        raise ValueError(
            f"{cfg.name} at {cfg.n_layers} layers: {need} bytes of weights "
            f"({need / 2**30:.2f} GiB), more than the card's {total_bytes} "
            f"bytes ({total_bytes / 2**30:.2f} GiB); cut its depth with "
            f"--layers")
    return need


def main(argv=None) -> Dict[int, List[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke config, not full width")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dataclasses import replace

    from ..configs import get_config, smoke_config
    from ..models import init_params

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    if torch.device(args.device).type == "cuda":
        check_fits(cfg, torch.cuda.get_device_properties(0).total_memory)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(cfg, gen, device=args.device)
    engine = ServeEngine(cfg, params, args.slots, args.max_len, args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=[int(t) for t in
                            rng.integers(0, cfg.vocab_size, size=4)],
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    out = {r.rid: r.generated for r in reqs}
    for rid, toks in out.items():
        print(f"request {rid}: {len(toks)} tokens: {toks[:8]}...")
    return out


if __name__ == "__main__":
    main()
