"""§Perf hillclimb driver (the port of `repro.launch.hillclimb`): capture
one training cell under a sequence of optimization variants and record the
roofline terms and LEO's diagnosis of each, plus the model-only **what-if
search** that climbs the advisor's mutation space without capturing
anything, and the **rewrite** loop that lowers the advisor's top advice to
equivalence-checked HLO rewrites.  `mutation_space`, `whatif_search`,
`run_whatif` and `run_rewrite` are the reference's, with the package named
`repro_torch`.

Each variant is (name, model flags, TrainOptions overrides): `CELLS` holds
the reference's three cells and fifteen variants with the port's flag
values, "kernel" for the reference's "pallas_fused" attention (K1) and
"plain" for its "xla".  The port's default attention is "kernel", so a
variant that leaves the reference's attention unset sets "plain".  The
port's unfused SSM form runs K4's first entry (`ssm_scan`) on CUDA tensors
(`models/flags.py`, `ssm_fused`), so hymba's `baseline` and `ssm_fused`
hold one fused region a layer where the reference's unfused form holds
none; the cells mirror the reference's flags all the same.

`run_variant` captures a variant with `launch/dryrun.py::lower_cell`:
on the card's own mesh (`--mesh host`, `make_host_mesh(1)`) the step on
meta stand-ins, and on the production meshes (`single`, `multi`) rank 0's
per-device program behind a fake process group of their ranks
(`mesh.fake_production_mesh`), collectives and all, as the reference
compiles its cells on them; the train step's micro-batches are one
`while` of their trip count (`core/torch_frontend.loop`).  Results land
in experiments/perf/<arch>__<shape>__<variant>.json.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen2 \\
      --mesh host --backend nvidia_h100_sxm
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell dsv2 \\
      --mesh host --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --whatif \\
      --backend nvidia_h100_sxm --mode guided --budget 12 --seed 0
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --rewrite \\
      --backend nvidia_h100_sxm
"""
import argparse
import contextlib
import dataclasses
import json
import os
import random
import time


CELLS = {
    "qwen2": {
        "arch": "qwen2-0.5b", "shape": "train_4k",
        "variants": [
            ("baseline", {"attention_impl": "plain"}, {}),
            ("flash_attention", {"attention_impl": "kernel"}, {}),
            ("flash+microbatch1",
             {"attention_impl": "kernel"}, {"microbatch": 1}),
            ("flash+mb1+remat_none",
             {"attention_impl": "kernel"},
             {"microbatch": 1, "remat": "none"}),
            ("flash+mb1+bf16grads",
             {"attention_impl": "kernel"},
             {"microbatch": 1, "grad_dtype": "bf16"}),
        ],
    },
    "hymba": {
        "arch": "hymba-1.5b", "shape": "train_4k",
        "variants": [
            ("baseline", {"attention_impl": "plain"}, {}),
            ("ssm_fused", {"ssm_fused": True, "attention_impl": "plain"}, {}),
            ("ssm_fused+flash",
             {"ssm_fused": True, "attention_impl": "kernel"}, {}),
            ("ssm+flash+mb2",
             {"ssm_fused": True, "attention_impl": "kernel"},
             {"microbatch": 2}),
            ("ssm_pallas+flash",
             {"ssm_fused": True, "ssm_pallas": True,
              "attention_impl": "kernel"}, {}),
        ],
    },
    "dsv2": {
        "arch": "deepseek-v2-236b", "shape": "train_4k",
        "variants": [
            ("baseline", {"attention_impl": "plain"}, {}),
            ("ep_shardmap",
             {"moe_impl": "ep_shardmap", "attention_impl": "plain"}, {}),
            ("ep+flash",
             {"moe_impl": "ep_shardmap", "attention_impl": "kernel"}, {}),
            ("ep+flash+remat_none",
             {"moe_impl": "ep_shardmap", "attention_impl": "kernel"},
             {"remat": "none"}),
            ("ep+flash+save_moe",
             {"moe_impl": "ep_shardmap", "attention_impl": "kernel"},
             {"remat": "group_save_moe"}),
        ],
    },
}


def run_variant(arch, shape_name, name, model_flags, opt_overrides,
                mesh_kind, outdir, hw_name="tpu_v5e", analyze=True,
                force=False, device="cuda", layers=None):
    """One variant's record, written to `<outdir>/<label>.json` (read back
    unless `force`).  `mesh_kind` "host" captures the step on the card's
    own mesh (`device`'s); "single" and "multi" capture rank 0's
    per-device program on the production meshes, for `device`.
    `arch` names a config of `configs` (or is an `ArchConfig`, such as a
    smoke config, whose name goes into the label); `shape_name` names a
    shape (or is a `ShapeConfig`); `layers` cuts the config's depth, and
    the record's `reduced` says so.  The train options are the variant's
    overrides on the reference's micro-batch count, `default_microbatch`
    of the uncut config on the mesh's data-parallel size.  The record is
    the reference's (`compile_seconds` the capture's) plus `memory` as
    `run_cell` writes it, `microbatch`, `kernel_regions` (each hand
    kernel's regions in the step, a loop body's once a trip) and
    `instructions` (the captured Module's)."""
    from ..configs import ShapeConfig, get_config, get_shape, model_flops
    from ..core import get_backend
    from ..core.roofline import compute_roofline
    from ..models.flags import flags as flags_ctx
    from ..runtime.steps import TrainOptions, default_microbatch
    from .dryrun import get_service, lower_cell
    from .mesh import fake_production_mesh, make_host_mesh

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else get_shape(shape_name)
    label = f"{cfg.name}__{shape.name}__{name}"
    path = os.path.join(outdir, label + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    full, reduced = cfg, []
    if layers:
        reduced.append(f"n_layers {cfg.n_layers} -> {layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh_cm = contextlib.nullcontext(make_host_mesh(1, device=device)) \
        if mesh_kind == "host" else fake_production_mesh(
            multi_pod=(mesh_kind == "multi"), device=device)
    hw = get_backend(hw_name).hw
    result = {"label": label, "variant": name, "flags": model_flags,
              "options": opt_overrides}
    if reduced:
        result["reduced"] = reduced
    with mesh_cm as mesh:
        chips = mesh.size
        dp = chips // mesh.shape["model"]
        # the uncut config's count: a depth cut keeps the cell's loop
        defaults = dict(microbatch=default_microbatch(
            full, shape.global_batch, shape.seq_len, dp))
        defaults.update(opt_overrides)
        opts = TrainOptions(**defaults)
        with flags_ctx(**model_flags):
            module, mem, secs = lower_cell(cfg, shape, mesh, opts=opts)
    rl = compute_roofline(module, hw, chips=chips, label=label,
                          model_flops=model_flops(cfg, shape))
    result.update({"microbatch": opts.microbatch,
                   "compile_seconds": secs, "roofline": rl.to_dict(),
                   "memory": mem, "kernel_regions": module.kernel_calls,
                   "instructions": sum(
                       1 for _ in module.all_instructions())})
    if analyze:
        rep = get_service(outdir).diagnose(module,
                                           backend=hw_name).to_dict()
        result["leo"] = {
            "top_stalls": rep["top_stalls"][:3],
            "root_causes": rep["root_causes"][:5],
            "self_blame": rep["self_blame"][:3],
            "recommendations": rep["recommendations"][:4],
            "estimated_step_seconds": rep["estimated_step_seconds"],
        }
    print(f"[{name}] {rl.summary_row()}")
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


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
    ap.add_argument("--cell", choices=sorted(CELLS))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "host"],
                    help="host: the card's own mesh; single, multi: rank "
                         "0's program on the production meshes")
    ap.add_argument("--outdir", default="experiments/perf")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the step is captured for (cpu: the "
                         "tests)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke version (CPU runs)")
    ap.add_argument("--whatif", action="store_true",
                    help="run the model-only mutation search instead of "
                         "lowering a cell")
    ap.add_argument("--rewrite", action="store_true",
                    help="lower the advisor's top advice to equivalence-"
                         "checked HLO rewrites and measure realized vs "
                         "predicted speedup via the real text path")
    ap.add_argument("--top-k", type=int, default=2,
                    help="advice items the --rewrite loop lowers")
    ap.add_argument("--backend", default="nvidia_gh200",
                    help="the backend of the search, the rewrite loop and "
                         "each cell's roofline and diagnosis")
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
    spec = CELLS[args.cell]
    arch = spec["arch"]
    if args.smoke:
        from ..configs import get_config, smoke_config
        arch = smoke_config(get_config(arch))
    for name, model_flags, opt_overrides in spec["variants"]:
        run_variant(arch, spec["shape"], name, model_flags, opt_overrides,
                    args.mesh, args.outdir, hw_name=args.backend,
                    force=args.force, device=args.device, layers=args.layers)


if __name__ == "__main__":
    main()
