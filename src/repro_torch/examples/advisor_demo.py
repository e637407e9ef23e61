"""What-if advisor walkthrough (paper §VII).

Three acts, each on the async copy-storm fixture:

1. **Counterfactual replay** — clone the model, apply one declarative
   ``Mutation`` (grow a sync pool, coalesce the barrier tags, re-tree
   the serial reduction), rerun the virtual sampler, and price the
   change as a modeled speedup.  The null mutation must reproduce the
   baseline ``StallProfile`` byte-for-byte — that identity check is the
   engine's correctness anchor and runs first.
2. **Evidence -> advice** — the rule catalog reads the diagnosed
   sync/issue pressure, proposes candidate mutations in each vendor's
   native vocabulary (``bar.sync`` vs ``s_waitcnt`` vs SBIDs), and the
   advisor replays every candidate and ranks by speedup x confidence.
3. **Advisor-guided search** — the same candidates seed a what-if
   hill-climb that reaches the blind search's best mutation in a
   fraction of the replays (the GPA-style "estimate-backed optimizer"
   loop).

  PYTHONPATH=src python -m repro_torch.examples.advisor_demo          # tour
  PYTHONPATH=src python -m repro_torch.examples.advisor_demo --smoke  # CI
"""
import argparse
import sys


def identity_act(module, backends) -> None:
    from ..advisor import Identity, WhatIfEngine, profile_fingerprint
    print("--- act 1: the identity replay (engine correctness anchor) ---")
    for name in backends:
        from ..core import get_backend
        engine = WhatIfEngine(module, get_backend(name))
        base = profile_fingerprint(engine.baseline())
        replay = profile_fingerprint(engine.replay(Identity()).profile)
        assert replay == base, (
            f"{name}: identity replay diverged from baseline "
            f"({replay[:12]} != {base[:12]})")
        print(f"{name:<14s} baseline sha256 {base[:16]}… == identity "
              f"replay ({engine.replays} sampler runs)")
    print()


def advice_act(module, backends) -> dict:
    from ..advisor import Advisor
    from ..core import get_backend
    print("--- act 2: evidence-matched, replay-priced advice ---")
    reports = {}
    for name in backends:
        reports[name] = Advisor().report(module, get_backend(name))
    print(f"{'backend':<14s} {'rules':>5s} {'replays':>7s}  ranked advice "
          f"(speedup x confidence = score)")
    for name, rep in reports.items():
        if not rep.advice:
            print(f"{name:<14s} {rep.rules_matched:>5d} "
                  f"{rep.candidates_replayed:>7d}  (nothing profitable)")
            continue
        for i, a in enumerate(rep.advice):
            lead = (f"{name:<14s} {rep.rules_matched:>5d} "
                    f"{rep.candidates_replayed:>7d}" if i == 0
                    else " " * 28)
            print(f"{lead}  #{i + 1} {a.rule}: "
                  f"{a.modeled_speedup:.3f}x x {a.confidence:.2f} "
                  f"= {a.score:.3f}")
        print(f"{'':<28s}  -> {rep.top.description}")
    assert any(rep.top and rep.top.modeled_speedup > 1.0
               for rep in reports.values()), \
        "no backend produced profitable advice on the storm"
    print()
    return reports


def search_act(hlo_text, backends, *, budget, seed) -> None:
    from ..launch.hillclimb import run_whatif
    print("--- act 3: advisor-guided vs blind what-if search ---")
    for name in backends:
        out = run_whatif(name, mode="both", budget=budget, seed=seed,
                         hlo_text=hlo_text)
        blind, guided = out["blind"], out["guided"]
        assert guided["best_speedup"] >= blind["best_speedup"] - 1e-9, \
            f"{name}: guided search lost to blind"
        print(f"{name:<14s} blind best {blind['best_speedup']:.3f}x in "
              f"{blind['evaluations']} replays "
              f"(found at #{blind['evaluations_to_best']}); guided "
              f"matched it in {guided['evaluations']}")
    print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="trimmed CI lane: one GPU vendor per act, a "
                         "12-copy storm, and a small search budget")
    ap.add_argument("--copies", type=int, default=None,
                    help="async copies in the storm fixture "
                         "(default: 48 full / 12 smoke)")
    ap.add_argument("--seed", type=int, default=0,
                    help="search-shuffle seed (act 3 reproducibility)")
    args = ap.parse_args(argv)

    from ..core import parse_hlo
    from ..launch.analysis_server import copy_storm_hlo

    copies = args.copies or (12 if args.smoke else 48)
    backends = ("nvidia_gh200",) if args.smoke else \
        ("nvidia_gh200", "amd_mi300a", "intel_pvc")
    budget = 8 if args.smoke else 16
    hlo = copy_storm_hlo(copies)
    module = parse_hlo(hlo)
    print(f"fixture: {copies}-copy async storm feeding one serial "
          f"reduction; backends: {', '.join(backends)}\n")

    identity_act(module, backends)
    advice_act(module, backends)
    search_act(hlo, backends, budget=budget, seed=args.seed)
    print("advisor demo OK: identity replay byte-identical, advice "
          "profitable and\nreplay-priced, guided search no worse than "
          "blind at the same budget.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
