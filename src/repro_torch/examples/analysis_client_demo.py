"""Networked diagnosis demo: LeoClient against a live `--serve` front-end.

Exercises the full serving contract from the outside:

  1. health — wait for ``/readyz`` (fresh server processes take a moment
     to bind);
  2. round trips — single-backend and fan-out diagnoses over the wire,
     plus a pipelined ``diagnose_batch``;
  3. backpressure — with ``--expect-shed`` (run the server with
     ``--slots 1 --max-queue 1``) a burst of concurrent requests must
     observe at least one 429 shed, and the client's backoff must still
     land every diagnosis;
  4. telemetry — dump ``/metrics`` (optionally to ``--metrics-out`` for
     the CI lane to grep).

Start a server, then point this at it:

  PYTHONPATH=src python -m repro_torch.launch.analysis_server \\
      --serve 0 --slots 1 --max-queue 1 --port-file /tmp/leo.port &
  PYTHONPATH=src python -m repro_torch.examples.analysis_client_demo \\
      --port $(cat /tmp/leo.port) --expect-shed
"""
import argparse
import sys

from ..core.service import AnalyzeRequest
from ..serve import LeoClient


def demo_traces(n):
    # imported lazily: the demo builders are plain string templates
    from ..launch.analysis_server import demo_hlo
    return [demo_hlo(seed=i, n=128 + 32 * (i % 3)) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--requests", type=int, default=6,
                    help="burst size for the batch phase")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the pipelined burst this many times "
                         "(the worker-kill CI lane SIGKILLs a pool "
                         "worker mid-run; every request must still "
                         "complete via the client's retry path)")
    ap.add_argument("--expect-shed", action="store_true",
                    help="fail unless the burst observes >= 1 429 shed "
                         "(run the server with --slots 1 --max-queue 1)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the server's /metrics text here at the end")
    args = ap.parse_args(argv)

    traces = demo_traces(max(2, args.requests // 2))
    with LeoClient(host=args.host, port=args.port, max_retries=8,
                   backoff_base_seconds=0.05) as client:
        if not client.wait_ready(15.0):
            print("server never became ready", file=sys.stderr)
            return 1

        print("-- single round trip --")
        diag = client.diagnose(traces[0], backend="tpu_v5e")
        top = diag.root_causes[0]["instruction"] if diag.root_causes else "-"
        print(f"[{diag.backend}] est {diag.estimated_step_seconds*1e6:.1f} "
              f"us, top root cause: {top}")

        print("-- cross-vendor fan-out --")
        fanout = client.diagnose(traces[0],
                                 backends=["tpu_v5e", "amd_mi300a"])
        for name, d in sorted(fanout.items()):
            print(f"[{name}] est {d.estimated_step_seconds*1e6:.1f} us")

        print(f"-- pipelined burst of {args.requests} "
              f"x {args.rounds} round(s) --")
        reqs = [AnalyzeRequest(hlo_text=traces[i % len(traces)],
                               backend="tpu_v5e")
                for i in range(args.requests)]
        for round_no in range(args.rounds):
            diags = client.diagnose_batch(reqs,
                                          max_connections=args.requests)
            if len(diags) != len(reqs):
                print(f"round {round_no}: {len(diags)}/{len(reqs)} "
                      f"diagnoses back", file=sys.stderr)
                return 1
        print(f"{args.rounds * len(reqs)} diagnoses back; "
              f"client stats: {client.stats}")

        sheds = client.stats["sheds_seen"]
        if args.expect_shed and sheds == 0:
            print("expected >= 1 shed (429) during the burst but saw "
                  "none — is the server running with --slots 1 "
                  "--max-queue 1?", file=sys.stderr)
            return 1
        if sheds:
            print(f"backpressure observed: {sheds} shed(s), all retried "
                  f"to completion")

        metrics = client.metrics_text()
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(metrics)
            print(f"wrote /metrics to {args.metrics_out}")
        else:
            wanted = ("leo_requests_total", "leo_sheds_total",
                      "leo_queue_depth")
            print("-- /metrics (excerpt) --")
            for line in metrics.splitlines():
                if line.startswith(wanted):
                    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
