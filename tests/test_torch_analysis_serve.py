"""The port's serving tier (`repro_torch.serve` and
`repro_torch.launch.analysis_server`, copies of `repro.serve` and
`repro.launch.analysis_server`) against the originals.

The wire protocol and the metrics text are pure functions of their
inputs, so both packages must give the same bytes.  A `LeoHttpd` on an
ephemeral port must answer each request with the Diagnosis the service
gives in-process, byte for byte (as `tests/test_serve_net.py` holds the
reference), and each package's client must talk to the other's server.
The pool's restart backoff is held to the reference's on a table of
histories, and one two-worker pool serves a round trip and drains, forked
from a fresh interpreter.  Every socket has a timeout, and no test waits
on a wall clock.
"""
import json
import os
import subprocess
import sys

import pytest

import repro.core as ref
import repro.launch.analysis_server as ref_server
import repro.serve as ref_serve
import repro.serve.pool as ref_pool
import repro_torch.core as port
import repro_torch.launch.analysis_server as port_server
import repro_torch.serve as port_serve
import repro_torch.serve.pool as port_pool
from test_torch_advisor import assert_copy

TIMEOUT = 30.0
BACKEND = "nvidia_gh200"
FANOUT = ["nvidia_h100_sxm", "tpu_v5e"]


def traces(server):
    return {"demo": server.demo_hlo(0),
            "copy_storm": server.copy_storm_hlo(),
            "wide_ops": server.wide_ops_hlo()}


def request(pkg, text, **kw):
    return pkg.AnalyzeRequest(
        hlo_text=text, hints={"total_devices": 8},
        options=pkg.DiagnoseOptions(advise=True, rewrite=True), **kw)


@pytest.mark.parametrize("name", ["serve/protocol.py", "serve/metrics.py",
                                  "launch/analysis_server.py",
                                  "serve/httpd.py", "serve/client.py",
                                  "serve/pool.py", "serve/__init__.py"])
def test_copies_are_verbatim(name):
    assert_copy(name)


def test_demo_traces_equal_reference():
    assert traces(port_server) == traces(ref_server)
    assert port_server.demo_hlo(3, n=160, trips=2) == \
        ref_server.demo_hlo(3, n=160, trips=2)
    assert port_server.copy_storm_hlo(48) == ref_server.copy_storm_hlo(48)


@pytest.mark.parametrize("name", ["demo", "copy_storm", "wide_ops"])
def test_wire_encoding_equals_reference(name):
    """Requests and results encode to the same bytes in both packages,
    and each package decodes the other's."""
    text = traces(ref_server)[name]
    for kw in ({"backend": BACKEND},
               {"backends": ["tpu_v5e", "amd_mi300a"]}):
        p_body = port_serve.encode_request(request(port, text, **kw),
                                           deadline_seconds=2.5,
                                           accept_schema=3)
        r_body = ref_serve.encode_request(request(ref, text, **kw),
                                          deadline_seconds=2.5,
                                          accept_schema=3)
        assert p_body == r_body
        p_wire = port_serve.decode_request(r_body)
        r_wire = ref_serve.decode_request(p_body)
        assert (p_wire.deadline_seconds, p_wire.negotiated_schema,
                p_wire.protocol_version) == \
            (r_wire.deadline_seconds, r_wire.negotiated_schema,
             r_wire.protocol_version)
        assert p_wire.request.to_dict() == r_wire.request.to_dict()
    p_diag = port.LeoService().diagnose(
        text, backend=BACKEND,
        options=port.DiagnoseOptions(advise=True, rewrite=True))
    r_diag = ref.LeoService().diagnose(
        text, backend=BACKEND,
        options=ref.DiagnoseOptions(advise=True, rewrite=True))
    timing = {"queue_seconds": 0.25, "service_seconds": 0.5,
              "seconds": 0.75}
    for schema in (ref.SCHEMA_VERSION, 2):
        got = port_serve.encode_result(p_diag, request_id="r1",
                                       timing=timing, schema_version=schema)
        assert got == ref_serve.encode_result(
            r_diag, request_id="r1", timing=timing, schema_version=schema)
        assert port_serve.decode_response(got).result().to_json() == \
            ref_serve.decode_response(got).result().to_json()
    assert port_serve.encode_result({"a": p_diag, "b": p_diag}) == \
        ref_serve.encode_result({"a": r_diag, "b": r_diag})
    assert port_serve.downgrade_diagnosis_dict(
        json.loads(p_diag.to_json()), 3) == \
        ref_serve.downgrade_diagnosis_dict(json.loads(r_diag.to_json()), 3)


def test_protocol_constants_and_errors_equal_reference():
    assert (port_serve.PROTOCOL_VERSION, port_serve.MIN_PROTOCOL_VERSION,
            port_serve.ERROR_CODES) == \
        (ref_serve.PROTOCOL_VERSION, ref_serve.MIN_PROTOCOL_VERSION,
         ref_serve.ERROR_CODES)
    for schema in range(0, ref.SCHEMA_VERSION + 2):
        got = want = None
        try:
            got = port_serve.negotiate_schema(schema)
        except port_serve.ProtocolError as e:
            got = (e.code, str(e))
        try:
            want = ref_serve.negotiate_schema(schema)
        except ref_serve.ProtocolError as e:
            want = (e.code, str(e))
        assert got == want, schema
    for code in sorted(ref_serve.ERROR_CODES):
        assert port_serve.encode_error(code, "m", retry_after=0.25,
                                       request_id="r") == \
            ref_serve.encode_error(code, "m", retry_after=0.25,
                                   request_id="r")
    for bad in (b"{nope", b'{"protocol_version": 99}', b"[]"):
        with pytest.raises(port_serve.ProtocolError) as p_err:
            port_serve.decode_request(bad)
        with pytest.raises(ref_serve.ProtocolError) as r_err:
            ref_serve.decode_request(bad)
        assert (p_err.value.code, str(p_err.value)) == \
            (r_err.value.code, str(r_err.value))


def _fill(serve):
    reg = serve.MetricsRegistry()
    c = reg.counter("leo_requests_total", "requests",
                    labelnames=("endpoint", "code"))
    c.inc(3, endpoint="analyze", code="200")
    c.inc(endpoint="healthz", code="503")
    reg.gauge("leo_queue_depth", "queued").set(2)
    reg.gauge("leo_ready", "ready").set_function(lambda: 1)
    h = reg.histogram("leo_queue_seconds", "queue wait",
                      buckets=serve.LATENCY_BUCKETS)
    for v in (0.0004, 0.02, 0.5, 7.0, 100.0):
        h.observe(v)
    reg.counter("leo_odd_total", 'a "quoted"\\ help\nline').inc(
        0.5)
    return reg


def test_metrics_text_equals_reference():
    p, r = _fill(port_serve), _fill(ref_serve)
    assert p.render() == r.render()
    assert p.dump() == r.dump()
    dumps = {"0": p.dump(), "1": _fill(port_serve).dump()}
    assert port_serve.aggregate_dumps(dumps) == \
        ref_serve.aggregate_dumps(dumps)


def test_analysis_server_smoke_equals_reference(capsys):
    got = port_server.main(["--smoke", "--requests", "4", "--slots", "2",
                            "--backends", "tpu_v5e,amd_mi300a"])
    want = ref_server.main(["--smoke", "--requests", "4", "--slots", "2",
                            "--backends", "tpu_v5e,amd_mi300a"])
    assert sorted(got) == sorted(want) and len(got) == 4
    for rid in got:
        assert got[rid].error is None and want[rid].error is None
        assert {k: d.to_json() for k, d in got[rid].fanout.items()} == \
            {k: d.to_json() for k, d in want[rid].fanout.items()}
    assert "4 requests via 2 slots" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["demo", "copy_storm", "wide_ops"])
def test_wire_equals_in_process(name):
    """A `LeoHttpd` round trip, one backend and fanned out, with advise and
    rewrite: the wire's Diagnosis JSON is the in-process one."""
    text = traces(port_server)[name]
    svc = port.LeoService()
    with port_serve.LeoHttpd(service=svc, port=0, slots=2) as app:
        with port_serve.LeoClient(port=app.port, timeout=TIMEOUT,
                                  max_retries=2) as client:
            single = client.submit(request(port, text, backend=BACKEND))
            fanout = client.submit(request(port, text, backends=FANOUT))
    assert single.to_json() == svc.submit(
        request(port, text, backend=BACKEND)).to_json()
    assert single.advice["recorded"] and single.rewrites["recorded"]
    inproc = svc.submit(request(port, text, backends=FANOUT))
    assert sorted(fanout) == sorted(FANOUT)
    for b in FANOUT:
        assert fanout[b].to_json() == inproc[b].to_json()


@pytest.mark.parametrize("direction", ["ref_client_port_server",
                                       "port_client_ref_server"])
def test_clients_and_servers_interoperate(direction):
    """Each package's client against the other's server: the answer is
    the server's in-process Diagnosis, and equals the reference's."""
    text = traces(ref_server)["copy_storm"]
    server_pkg, serve_s, client_s, client_pkg = \
        (port, port_serve, ref_serve, ref) \
        if direction == "ref_client_port_server" else \
        (ref, ref_serve, port_serve, port)
    svc = server_pkg.LeoService()
    with serve_s.LeoHttpd(service=svc, port=0, slots=2) as app:
        with client_s.LeoClient(port=app.port, timeout=TIMEOUT,
                                max_retries=2) as client:
            got = client.submit(request(client_pkg, text, backend=BACKEND))
            fan = client.submit(request(client_pkg, text,
                                        backends=["tpu_v5e", BACKEND]))
    assert got.to_json() == svc.submit(
        request(server_pkg, text, backend=BACKEND)).to_json()
    assert got.to_json() == ref.LeoService().diagnose(
        text, backend=BACKEND,
        hints={"total_devices": 8},
        options=ref.DiagnoseOptions(advise=True, rewrite=True)).to_json()
    assert sorted(fan) == ["nvidia_gh200", "tpu_v5e"]


def test_respawn_delay_equals_reference():
    histories = [[], [99.0], [99.0, 99.5], [99.0, 99.5, 100.0],
                 [99.0, 99.5, 100.0, 100.2], [100.0 - i * 0.1
                                              for i in range(12)],
                 [10.0, 20.0, 60.0, 70.0], [0.0] * 5]
    for history in histories:
        for now in (50.0, 100.3, 129.0, 200.0):
            for kw in ({}, {"base": 0.25, "cap": 2.0},
                       {"window": 5.0, "free_restarts": 1}):
                assert port_pool.respawn_delay(history, now, **kw) == \
                    ref_pool.respawn_delay(history, now, **kw), \
                    (history, now, kw)


# Forks the pool from an interpreter that has imported no JAX and run no
# torch op: forked from the test process, which has (JAX is multithreaded),
# a worker can deadlock.  It prints what the test checks as one JSON line.
POOL_ROUND_TRIP = """
import json, sys
import repro_torch.launch.analysis_server as port_server
import repro_torch.serve as port_serve
from repro_torch.core import AnalyzeRequest
timeout, backend = float(sys.argv[1]), sys.argv[2]
text = port_server.demo_hlo(0)
pool = port_serve.LeoWorkerPool(workers=2, port=0, slots=2,
                                control_port=None).start()
try:
    ready = pool.wait_ready(timeout)
    with port_serve.LeoClient(port=pool.port, timeout=timeout,
                              max_retries=3) as client:
        reqs = [AnalyzeRequest(hlo_text=text, backend=b)
                for b in ("tpu_v5e", backend, "tpu_v5e", backend)]
        out = client.diagnose_batch(reqs, max_connections=2)
finally:
    drained = pool.drain(timeout)
print(json.dumps({
    "ready": ready, "drained": drained,
    "jax_imported": "jax" in sys.modules,
    "backends": [d.backend for d in out],
    "diagnoses": [d.to_json() for d in out],
    "drain_events": [[kind, idx] for kind, idx, _ in pool.drain_events],
    "exit_codes": [rec.exit_code for rec in pool._records.values()]}))
"""


@pytest.mark.skipif(not hasattr(os, "fork"),
                    reason="LeoWorkerPool needs os.fork")
def test_two_worker_pool_round_trip_drains():
    """Bind once, fork two workers, serve a pipelined batch, then drain
    rolling: each worker told in turn and each exiting 0.  The pool runs
    in a fresh interpreter (POOL_ROUND_TRIP) with a time limit of its
    own."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(
        [sys.executable, "-c", POOL_ROUND_TRIP, str(TIMEOUT), BACKEND],
        capture_output=True, text=True, timeout=4 * TIMEOUT, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["ready"] and got["drained"] is True
    assert got["jax_imported"] is False
    assert got["backends"] == ["tpu_v5e", BACKEND] * 2
    assert got["diagnoses"][0] == got["diagnoses"][2]
    text = traces(port_server)["demo"]
    assert got["diagnoses"][1] == port.LeoService().submit(
        port.AnalyzeRequest(hlo_text=text, backend=BACKEND)).to_json()
    assert got["drain_events"] == \
        [["sigterm", 0], ["exit", 0], ["sigterm", 1], ["exit", 1]]
    assert got["exit_codes"] and all(c == 0 for c in got["exit_codes"])
