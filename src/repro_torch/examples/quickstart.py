"""Quickstart: train a reduced model end to end through the port's driver,
checkpoint it, and run LEO root-cause analysis on the captured train step
on the H100 backend.

  python -m repro_torch.examples.quickstart                 # on the card
  python -m repro_torch.examples.quickstart --device cpu    # plain versions
"""
import argparse
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    from ..launch.train import build
    from ..launch.train import main as train_main

    with tempfile.TemporaryDirectory(prefix="repro_torch_quickstart_") as d:
        result = train_main([
            "--arch", "qwen2-0.5b", "--smoke",
            "--steps", str(args.steps), "--batch", "8", "--seq", "64",
            "--checkpoint-dir", d,
            "--checkpoint-every", str(max(1, args.steps // 2)),
            "--device", args.device,
        ])
    print(f"\nloss: {result['first_loss']:.3f} -> {result['final_loss']:.3f}")
    if not result["final_loss"] < result["first_loss"]:
        raise AssertionError("training regressed")

    # LEO on the captured step: where would this program stall on an H100?
    from ..core import LeoService, capture

    _, state, pipeline, step_fn = build("qwen2-0.5b", True, 8, 64,
                                        args.device)
    module = capture(step_fn, state, pipeline.device_batch(0),
                     name="train_step", device=args.device)
    service = LeoService()
    an = service.analyze(module, backend="nvidia_h100_sxm")
    print("\n=== LEO analysis of the captured train step ===")
    print(an.summary())
    print("per-pass timing: " + ", ".join(
        f"{name}={secs*1e3:.1f}ms" for name, secs in an.pass_seconds.items()))
    if an.chains:
        print("\ntop dependency chain:")
        print(an.chains[0].describe())

    # the serializable Diagnosis: what a queue/agent consumer receives
    diag = service.diagnose(module, backend="nvidia_h100_sxm")
    payload = diag.to_json()
    print(f"\nDiagnosis payload: {len(payload)} bytes of JSON "
          f"(schema v{diag.schema_version}); markdown preview:\n")
    print("\n".join(diag.to_markdown().splitlines()[:8]))
    return {"train": result, "analysis": an, "diagnosis": diag}


if __name__ == "__main__":
    main()
