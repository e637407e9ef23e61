"""The model-only half of the hillclimb driver (the port of
`repro.launch.hillclimb`): a **what-if search** that climbs the advisor's
mutation space without lowering or running anything, and the **rewrite**
loop that lowers the advisor's top advice to equivalence-checked HLO
rewrites.  `mutation_space`, `whatif_search`, `run_whatif` and
`run_rewrite` are the reference's, with the package named `repro_torch`.

The reference's other half, `CELLS` and `run_variant` (`--cell`), lowers a
training cell on the production device mesh under the model flags it sets
(`ssm_fused`, `ssm_pallas`, `attention_impl`).  The port's dry run
(`launch/dryrun.py`) builds a cell's program only on a mesh of one device;
a production mesh's per-device program waits for process groups, and
`--cell` raises until then.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --whatif \\
      --backend nvidia_h100_sxm --mode guided --budget 12 --seed 0
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --rewrite \\
      --backend nvidia_h100_sxm
"""
import argparse
import json
import os
import random
import time


# ---------------------------------------------------------------------------
# What-if search: hillclimb over the advisor's mutation space, entirely in
# the model (no lowering, no jax).  The §VII "LEO-guided optimization" loop
# in miniature — `guided` mode replays the advisor's rule-matched candidates
# first; `blind` shuffles the full space under an explicit --seed, so the
# guided-vs-blind comparison is reproducible run to run.
# ---------------------------------------------------------------------------

def mutation_space(backend):
    """Deterministic enumeration of every knob a Mutation can turn on
    this backend, at a few settings each — the blind search's universe."""
    from ..advisor import (
        CoalesceSyncTags,
        PipelineAsyncChain,
        ResizePool,
        ScaleLatency,
        SetIssue,
        SetOccupancy,
        TreeReduceChain,
    )
    from ..core.hwmodel import ISSUE_POLICIES

    space = []
    for p in backend.sync.pools:
        for cap in sorted({p.capacity * 2, p.capacity + 4,
                           max(1, p.capacity // 2)} - {p.capacity}):
            space.append(ResizePool(pool=p.name, capacity=cap))
    for group in (2, 4, 8, 16):
        space.append(CoalesceSyncTags(group=group))
    for window in (2, 4, 8):
        space.append(PipelineAsyncChain(window=window))
    space.append(TreeReduceChain())
    iss = backend.issue
    for queues in sorted({max(1, iss.queues // 2), iss.queues * 2}):
        space.append(SetIssue(queues=queues))
    space.append(SetIssue(width=iss.width * 2))
    for policy in ISSUE_POLICIES:
        if policy != iss.policy:
            space.append(SetIssue(policy=policy))
    space.append(ScaleLatency(hw_field="hbm_bw", factor=2.0))
    space.append(ScaleLatency(hw_field="dma_setup_cycles", factor=0.5))
    native = backend.native_occupancy
    if native.multi_wave:
        for waves in sorted({native.waves, max(2, native.waves // 2)}):
            space.append(SetOccupancy(waves=waves))
    return space


def whatif_search(module, backend, *, mode="blind", budget=12, seed=0,
                  target_speedup=None):
    """Search the mutation space for the best modeled speedup.

    ``blind`` replays a seeded-shuffle order over :func:`mutation_space`;
    ``guided`` replays in advisor order — the top candidate of every
    *matched* rule first, then each unmatched rule's top pick as a
    speculative tier, then the matched rules' remaining candidates, then
    the same shuffled space (rule matching prices nothing — ordering is
    free).  Both stop after ``budget`` replays, or as soon as
    ``target_speedup`` is reached — so "how many evaluations did the
    advisor save?" is a direct read of the two ``evaluations`` counts.
    """
    from ..advisor import RULES, Evidence, WhatIfEngine, match_rules

    engine = WhatIfEngine(module, backend)
    baseline = engine.baseline()
    candidates = mutation_space(backend)
    rng = random.Random(seed)
    rng.shuffle(candidates)
    if mode == "guided":
        evidence = Evidence(backend=backend, profile=baseline)
        matched = {r.name for r in match_rules(evidence)}
        tiers = ([], [], [])   # matched picks | speculative picks | rest
        for rule in RULES:
            cands = rule.candidates(evidence)
            if not cands:
                continue
            if rule.name in matched:
                tiers[0].append(cands[0])
                tiers[2].extend(cands[1:])
            else:
                tiers[1].append(cands[0])
        advised = [m for tier in tiers for m in tier]
        seen = {json.dumps(m.to_dict(), sort_keys=True) for m in advised}
        candidates = advised + [
            m for m in candidates
            if json.dumps(m.to_dict(), sort_keys=True) not in seen]
    elif mode != "blind":
        raise ValueError(f"mode must be 'blind' or 'guided', got {mode!r}")

    best = None
    best_at = 0
    evaluations = 0
    history = []
    for mutation in candidates[:budget]:
        res = engine.replay(mutation)
        evaluations += 1
        history.append({"evaluation": evaluations,
                        "mutation": mutation.to_dict(),
                        "modeled_speedup": res.modeled_speedup})
        if best is None or res.modeled_speedup > best.modeled_speedup:
            best = res
            best_at = evaluations
        if target_speedup is not None \
                and best.modeled_speedup >= target_speedup:
            break
    return {
        "mode": mode,
        "seed": seed,
        "budget": budget,
        "backend": backend.name,
        "baseline_makespan_cycles": baseline.makespan_cycles,
        "evaluations": evaluations,
        "evaluations_to_best": best_at,
        "best": best.to_dict() if best is not None else None,
        "best_speedup": best.modeled_speedup if best is not None else 1.0,
        "history": history,
    }


def run_whatif(backend_name, *, mode="both", budget=12, seed=0,
               n_copies=48, outdir=None, hlo_text=None):
    """CLI entry for the model-only search; returns per-mode results."""
    from ..core import parse_hlo, resolve_backend
    from .analysis_server import copy_storm_hlo

    backend = resolve_backend(backend_name)
    module = parse_hlo(hlo_text if hlo_text is not None
                       else copy_storm_hlo(n_copies))
    modes = ("blind", "guided") if mode == "both" else (mode,)
    out = {}
    for m in modes:
        # guided chases the blind best, so the evaluation counts compare
        target = out.get("blind", {}).get("best_speedup")
        t0 = time.monotonic()
        res = whatif_search(module, backend, mode=m, budget=budget,
                            seed=seed, target_speedup=target)
        res["search_seconds"] = time.monotonic() - t0
        out[m] = res
        best = res["best"] or {}
        print(f"[whatif:{m}] {backend.name} best "
              f"{res['best_speedup']:.3f}x in {res['evaluations']} evals "
              f"({(best.get('mutation') or {}).get('kind', '-')})")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"whatif__{backend.name}__s{seed}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[whatif] wrote {path}")
    return out


def run_rewrite(backend_name, *, top_k=2, n_copies=48, outdir=None,
                hlo_text=None):
    """CLI entry for the closed loop: lower the advisor's top advice to
    equivalence-checked HLO rewrites via the real text path (emit ->
    re-parse -> full re-analysis) and report predicted vs realized."""
    from ..core import resolve_backend
    from ..core.session import LeoSession
    from ..rewrite import RewriteLoop
    from .analysis_server import copy_storm_hlo

    backend = resolve_backend(backend_name)
    text = hlo_text if hlo_text is not None else copy_storm_hlo(n_copies)
    session = LeoSession()
    t0 = time.monotonic()
    report = RewriteLoop(top_k=top_k).run(text, backend, session=session)
    seconds = time.monotonic() - t0
    out = report.to_dict()
    out["loop_seconds"] = seconds
    for o in report.outcomes:
        print(f"[rewrite:{backend.name}] {o.rule} ({o.source}): "
              f"{o.mutation.get('kind')} predicted "
              f"{o.predicted_speedup:.3f}x -> realized "
              f"{o.realized_speedup:.3f}x "
              f"({o.realized_fraction:.0%} of predicted)")
    for s in report.skipped:
        print(f"[rewrite:{backend.name}] skipped {s['rule']}: "
              f"{s['refusal']['code']}")
    best = report.best
    print(f"[rewrite:{backend.name}] best "
          f"{best.realized_speedup:.3f}x realized"
          if best is not None else
          f"[rewrite:{backend.name}] no applicable rewrite")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"rewrite__{backend.name}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[rewrite] wrote {path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", help="not in the port yet: lowering a cell "
                    "on the production mesh needs process groups")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--outdir", default="experiments/perf")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--whatif", action="store_true",
                    help="run the model-only mutation search instead of "
                         "lowering a cell")
    ap.add_argument("--rewrite", action="store_true",
                    help="lower the advisor's top advice to equivalence-"
                         "checked HLO rewrites and measure realized vs "
                         "predicted speedup via the real text path")
    ap.add_argument("--top-k", type=int, default=2,
                    help="advice items the --rewrite loop lowers")
    ap.add_argument("--backend", default="nvidia_gh200")
    ap.add_argument("--mode", default="both",
                    choices=("blind", "guided", "both"))
    ap.add_argument("--budget", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0,
                    help="shuffle seed for the blind search order; "
                         "explicit so guided-vs-blind comparisons "
                         "reproduce exactly")
    ap.add_argument("--copies", type=int, default=48,
                    help="copy-storm width for the --whatif workload")
    args = ap.parse_args(argv)

    if args.rewrite:
        run_rewrite(args.backend, top_k=args.top_k, n_copies=args.copies,
                    outdir=args.outdir)
        return
    if args.whatif:
        run_whatif(args.backend, mode=args.mode, budget=args.budget,
                   seed=args.seed, n_copies=args.copies,
                   outdir=args.outdir)
        return
    if args.cell is None:
        ap.error("--cell is required unless --whatif or --rewrite is given")
    raise NotImplementedError(
        f"--cell {args.cell}: lowering a training cell (the reference's "
        f"run_variant) needs the production device mesh's per-device "
        f"program, which the port does not build yet (launch/dryrun.py "
        f"records such cells specs_only); run --whatif or --rewrite")


if __name__ == "__main__":
    main()
