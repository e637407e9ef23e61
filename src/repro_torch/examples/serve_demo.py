"""Batched serving demo: slot-based continuous batching over decode_step,
through the port's `ServeEngine`.

Requests with *staggered* lengths release their slots at different ticks,
and a request admitted mid-stream starts at pos=0 while its neighbors keep
decoding at pos>0; its tokens equal those of a solo run.

  python -m repro_torch.examples.serve_demo                 # on the card
  python -m repro_torch.examples.serve_demo --device cpu    # plain versions
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config, smoke_config
    from ..launch.serve import Request, ServeEngine
    from ..models import init_params

    cfg = smoke_config(get_config("hymba-1.5b"))    # hybrid attn+SSM decode
    params = init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    engine = ServeEngine(cfg, params, batch_slots=3, max_len=64,
                         device=args.device)

    rng = np.random.default_rng(0)

    def make_request(rid, max_new):
        return Request(rid=rid,
                       prompt=[int(t) for t in
                               rng.integers(0, cfg.vocab_size, size=4)],
                       max_new_tokens=max_new)

    # staggered lengths, exactly filling the 3 slots (queue left empty so
    # the next submission is genuinely the next admission)
    reqs = [make_request(i, max_new=6 + 6 * i) for i in range(3)]
    for r in reqs:
        engine.submit(r)

    # run until the first request completes and its slot frees
    while not any(r.done for r in reqs):
        engine.tick()
    mid_positions = [s.pos for s in engine.slots if s.request is not None]
    if not any(p > 0 for p in mid_positions):
        raise AssertionError("expected neighbors still decoding mid-stream")

    # admit a NEW request mid-stream: it enters the freed slot at pos=0
    # on the next tick while the others continue at their own positions
    late = make_request(99, max_new=8)
    engine.submit(late)
    engine.tick()
    late_slot = next(s for s in engine.slots if s.request is late)
    positions = sorted(s.pos for s in engine.slots if s.request is not None)
    print(f"after mid-stream admission, active slot positions: {positions}")
    if not (late_slot.pos == 1 and late_slot.pos < max(positions)):
        raise AssertionError("late request should decode at its own "
                             "position, trailing the rest")

    engine.run()
    for r in reqs + [late]:
        if not (r.done and len(r.generated) == r.max_new_tokens):
            raise AssertionError((r.rid, len(r.generated), r.max_new_tokens))
        print(f"request {r.rid}: {len(r.generated)} tokens: "
              f"{r.generated[:8]}...")

    # slot-state isolation: the mid-stream request must decode exactly as
    # it would alone (the reused slot's KV *and* recurrent SSM state were
    # reset at admission; greedy decode is deterministic)
    solo_engine = ServeEngine(cfg, params, batch_slots=3, max_len=64,
                              device=args.device)
    solo = Request(rid=late.rid, prompt=list(late.prompt),
                   max_new_tokens=late.max_new_tokens)
    solo_engine.submit(solo)
    solo_engine.run()
    if solo.generated != late.generated:
        raise AssertionError(("mid-stream admission leaked slot state",
                              solo.generated, late.generated))

    print("\nall 4 requests served through 3 slots, one admitted "
          "mid-stream\ninto a reused slot (per-slot position vectors + "
          "per-slot state reset;\nits tokens match a solo run exactly).")
    return {"requests": reqs + [late], "solo": solo}


if __name__ == "__main__":
    main()
