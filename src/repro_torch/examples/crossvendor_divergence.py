"""Observation-1 demo (paper §VI-A, MASS3DEA) on the port: the SAME kernel
exhibits different bottlenecks on different backends, and LEO explains
each.

The kernel is an embedding-heavy MLP written in PyTorch, captured as the
CUDA program the card would run (`core.capture` on fake tensors: the
500000 x 1024 bf16 table is never allocated).  One
``LeoService.compare_backends`` call fans the captured Module across every
registered backend — three TPU generations plus NVIDIA-, AMD- and
Intel-class descriptors whose FLOP:HBM:interconnect ratios genuinely
differ, and the port's ``nvidia_h100_sxm`` — concurrently over the service
thread pool.  Each row prints the vendor's dominant stall in its *native*
profiler vocabulary (CUPTI / rocprofiler / Level Zero / xplane), the way
the paper's §II-D taxonomy maps back out.  The copy-storm, wide-ops,
occupancy and advice demos that follow read the shared HLO fixtures, each
parsed once for all backends.

  PYTHONPATH=src python -m repro_torch.examples.crossvendor_divergence
"""
import torch
import torch.nn.functional as F

# sized on the compute/memory knife edge: ~26 GFLOP of matmul vs ~134 MB of
# gathered table rows — narrow-HBM parts tip one way, fat-HBM parts the
# other
TABLE_ROWS, DIM, INDICES, HIDDEN = 500_000, 1024, 65_536, 96


def kernel(table, idx, w1, w2):
    """An embedding-heavy MLP: gather -> matmul -> gelu -> matmul (GELU's
    tanh form, `jax.nn.gelu`'s default)."""
    # F.embedding is `table[idx]`, a gather a capture of a CUDA program
    # can trace on the CPU (`models/layers.py::embed`)
    x = F.embedding(idx, table)                         # (B, D) gather
    h = F.gelu(x @ w1, approximate="tanh")              # (B, F)
    return (h @ w2).sum()


def capture_kernel(rows: int = TABLE_ROWS):
    """`kernel`'s CUDA program at the demo's sizes (a table of `rows`),
    captured from meta tensors: nothing is allocated or run."""
    from ..core import capture

    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    return capture(kernel, meta((rows, DIM)),
                   meta((INDICES,), torch.int32), meta((DIM, HIDDEN)),
                   meta((HIDDEN, DIM)), device="cuda", name="kernel")


def main():
    from ..core import LeoService, compute_roofline

    module = capture_kernel()
    # the serving entry point: concurrent fan-out over the thread pool; a
    # captured Module needs no parse
    service = LeoService()
    per_backend = service.compare_backends(module)
    print(f"captured once ({sum(1 for _ in module.all_instructions())} "
          f"instructions), analyzed on {len(per_backend)} backends "
          f"concurrently\n")

    print(f"{'backend':<14s} {'vendor':<7s} {'est. time':>10s} "
          f"{'compute':>9s} {'memory':>9s} {'mem/comp':>9s}  "
          f"diagnosis (native counter)")
    for name, an in per_backend.items():
        rl = compute_roofline(an.module, an.hw, chips=1, label=name)
        diagnosed = list(an.blame.self_blame) + \
            list(an.blame.occupancy_blame)
        if diagnosed:
            top = max(diagnosed, key=lambda s: s.cycles)
            label = top.subcategory
        else:
            label = "dependency stalls"
        # the same diagnosis in the vendor profiler's own vocabulary
        stalled = an.profile.top_stalled(1)
        native = an.backend.native_stall_name(stalled[0].dominant_stall) \
            if stalled else "-"
        print(f"{name:<14s} {an.backend.vendor:<7s} "
              f"{an.estimated_step_seconds*1e6:>8.1f}us "
              f"{rl.compute_s*1e6:>7.1f}us {rl.memory_s*1e6:>7.1f}us "
              f"{rl.memory_s/max(rl.compute_s,1e-12):>8.2f}x  "
              f"{label} ({native})")

    # §III-E resource pressure: which finite vendor sync resources the
    # program's async traffic actually consumed (and whether it ever
    # oversubscribed them — "peak 6/6 in flight" is the strategist's cue).
    print("\nsync-resource pressure (finite §III-E resources per vendor):")
    for name, an in per_backend.items():
        if an.sync_pressure is None:
            continue
        used = [p for p in an.sync_pressure.pools if p["acquisitions"]]
        if not used:
            print(f"{name:<14s} no async sync traffic")
            continue
        cells = []
        for p in used:
            cell = f"{p['label']}: peak {p['peak_in_flight']}/{p['capacity']}"
            if p["evictions"]:
                cell += (f" — {p['evictions']} oversubscription(s), "
                         f"{p['contention_cycles']:,.0f} cyc serialized")
            cells.append(cell)
        print(f"{name:<14s} " + "; ".join(cells))

    # the capture records the gather as `embedding` and prices it as a
    # read of the whole table, where the reference's HLO has a `gather` of
    # the rows it takes, which LEO names indirect addressing
    print("\nSame captured program, every backend, no parse: the table's "
          "bytes lead the\nproducts' on every part and the balance shifts "
          "per vendor — the paper's\nObservation 1.")

    copy_storm_demo(service)
    wide_ops_demo(service)
    occupancy_demo(service)
    advice_demo(service)


def copy_storm_demo(service) -> None:
    """The §III-E headline: in-flight async copies oversubscribe some
    vendors' finite sync resources and sail through others' — and under
    the multi-stream issue model, pool *scope* decides: NVIDIA's named
    barriers are CTA-shared (all 4 warp schedulers fight over B1-B6)
    while AMD's waitcnt counters are per-wave (each SIMD queue owns its
    own vmcnt/lgkmcnt), so the 12-copy storm contends on every AMD queue
    but spreads where an 8-copy storm would fit."""
    from ..launch.analysis_server import copy_storm_hlo
    print("\n--- copy storm: 12 async copies in flight at once ---")
    print(f"{'backend':<14s} {'resource pool':<28s} {'scope':<7s} "
          f"{'pressure':<12s} top stall (native)")
    for name, diag in service.diagnose_fanout(copy_storm_hlo(12)).items():
        top = diag.top_stalls[0]["breakdown"]
        dominant = max(top, key=top.get)
        used = [p for p in diag.sync_resources["pools"]
                if p["acquisitions"]]
        pool = used[0] if used else None
        label = pool["label"] if pool else "-"
        scope = pool.get("scope", "-") if pool else "-"
        pressure = (f"{pool['peak_in_flight']}/{pool['capacity']}"
                    + ("!" * min(pool["evictions"], 3)) if pool else "-")
        print(f"{name:<14s} {label:<28s} {scope:<7s} {pressure:<12s} "
              f"{dominant} ({diag.stall_taxonomy[dominant]})")
    print("12 copies > NVIDIA's 6 CTA-shared barriers and > AMD's per-"
          "wave 2-counter\nfiles (3 copies per SIMD queue), but < Intel's "
          "per-thread 16 SWSB tokens\nand the TPUs' 32 async contexts: "
          "contended vendors serialize (oldest-\n(M-N) rule) and the "
          "diagnosis names the exact instance — down to the\nqueue "
          "(`q2:vmcnt`) for per-queue pools.")


def wide_ops_demo(service) -> None:
    """The multi-stream payoff: 12 dependency-free op chains are ready at
    t=0, so throughput is bounded by the issue fabric alone — narrow
    4-queue parts charge `not_selected`/`pipe_busy` scheduler-contention
    cycles the single-stream model structurally could not emit, Intel's
    16 ports issue the front cleanly, and the in-order TPU VLIW stream
    never arbitrates at all."""
    from ..launch.analysis_server import wide_ops_hlo
    print("\n--- wide ops: 12 independent chains vs the issue fabric ---")
    print(f"{'backend':<14s} {'issue model':<22s} {'not_selected':>12s} "
          f"{'pipe_busy':>10s}  top stall (native)")
    for name, diag in service.diagnose_fanout(wide_ops_hlo()).items():
        top = diag.top_stalls[0]["breakdown"]
        dominant = max(top, key=top.get)
        ip = diag.issue_pressure
        model = (f"{ip['queues']}q x {ip['width']}w "
                 f"{ip['policy'][:6]}")
        print(f"{name:<14s} {model:<22s} "
              f"{ip['not_selected_cycles']:>12,.0f} "
              f"{ip['pipe_busy_cycles']:>10,.0f}  "
              f"{dominant} ({diag.stall_taxonomy[dominant]})")
    print("Same program, three scheduler stories: NVIDIA's greedy "
          "arbiter loses to\nother-pipe work (not_selected), AMD's "
          "static SIMD rotation queues same-pipe\nchains (pipe_busy), "
          "and wide/in-order parts show neither — divergence the\n"
          "single-stream sampler could never produce.")


def occupancy_demo(service) -> None:
    """The wave-residency story on the same storm: engaging each
    part's *native* occupancy (``DiagnoseOptions(occupancy=True)`` →
    ``Backend.with_occupancy()``) yields a different verdict per vendor —
    AMD's queue-scoped waitcnt counters let 4 wavefronts hide the copy
    latency decisively, Intel's 2 threads of hiding credit run dry
    (stalls reclassify as ``occupancy_limited``), NVIDIA's 8 warps
    *share* the device-scope named barriers so residency backfires, and
    the TPUs have no residency knob at all."""
    from ..core import DiagnoseOptions
    from ..launch.analysis_server import copy_storm_hlo
    print("\n--- wave occupancy: the same storm under native residency ---")
    print(f"{'backend':<14s} {'residency':<22s} {'hidden':<14s} "
          f"{'speedup':>8s}  top occupancy-limited wait")
    storm = copy_storm_hlo(12)
    plain = service.diagnose_fanout(storm)
    engaged = service.diagnose_fanout(
        storm, options=DiagnoseOptions(occupancy=True))
    for name, diag in engaged.items():
        occ = diag.occupancy
        if not occ.get("recorded"):
            print(f"{name:<14s} {'single-wave (no knob)':<22s} "
                  f"{'-':<14s} {1.0:>7.2f}x  -")
            continue
        residency = f"W={occ['waves']} ({occ['limiter']})"
        hidden = (f"{occ['hidden_fraction']:.0%} of "
                  f"{occ['hidden_cycles'] + occ['exposed_cycles']:,.0f}cyc")
        speedup = (plain[name].estimated_step_seconds
                   / diag.estimated_step_seconds)
        blame = occ.get("blame") or []
        if blame:
            top = max(blame, key=lambda b: b["exposed_cycles"])
            leak = (f"{top['consumer']} <- {top['blocker']} "
                    f"({top['exposed_cycles']:,.0f}cyc exposed)")
        else:
            leak = "(everything hidden)"
        print(f"{name:<14s} {residency:<22s} {hidden:<14s} "
              f"{speedup:>7.2f}x  {leak}")
    print("One knob, three verdicts: decisive on AMD (queue-scoped "
          "counters, free\nwaves), marginal on Intel (credit runs dry — "
          "the leak is named, line by\nline), harmful on NVIDIA (8 warps "
          "share 6 device-scope barriers) — which\nis why `raise_"
          "occupancy` advice is priced by replay per part, never\n"
          "handed out as generic prose.")


def advice_demo(service) -> None:
    """Observation 2's converse, closed by the what-if advisor: where access
    patterns are *irregular* (a 48-copy storm against finite, differently
    shaped sync files), the fix does NOT transfer — each vendor's top
    what-if-replayed advice is a different mutation, each priced by
    rerunning the virtual sampler against the mutated machine."""
    from ..core import DiagnoseOptions
    from ..launch.analysis_server import copy_storm_hlo
    print("\n--- what-if advisor: same 48-copy storm, a different fix "
          "per vendor ---")
    print(f"{'backend':<14s} {'top rule':<28s} {'mutation':<28s} "
          f"{'speedup':>8s} {'conf':>5s}")
    fanned = service.diagnose_fanout(copy_storm_hlo(48),
                                     options=DiagnoseOptions(advise=True))
    for name, diag in fanned.items():
        adv = diag.advice
        if not adv.get("recorded") or not adv.get("items"):
            print(f"{name:<14s} (no profitable mutation found)")
            continue
        top = adv["items"][0]
        mut = dict(top["mutation"])
        kind = mut.pop("kind")
        knobs = ", ".join(f"{k}={v}" for k, v in sorted(mut.items()))
        print(f"{name:<14s} {top['rule']:<28s} "
              f"{kind + ('(' + knobs + ')' if knobs else ''):<28s} "
              f"{top['modeled_speedup']:>7.2f}x "
              f"{top['confidence']:>5.2f}")
    print("Three vendors, three different top fixes for one program: "
          "batch the\nbarrier allocations where 6 CTA-shared slots thrash "
          "(NVIDIA), raise\nresidency where 4 free wavefront slots hide "
          "the waits (AMD), and re-tree\nthe serial reduction where "
          "16 SBIDs never contend and issue is the\nbottleneck (Intel) — "
          "each speedup is a replay, not a heuristic.")


if __name__ == "__main__":
    main()
