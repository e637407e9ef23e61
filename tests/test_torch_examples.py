"""The port's examples (`python -m repro_torch.examples.<name>`) on the CPU:
the quickstart at a reduced step count (its own assertion: the loss fell)
and the serve demo (a request admitted mid-stream yields its solo run's
tokens), each through the port's entry points with `--device cpu`; the
rewrite demo's smoke lane and the analysis client against a server on an
ephemeral port, which run on the host only."""
from repro_torch.examples import (analysis_client_demo, quickstart,
                                  rewrite_demo, serve_demo)


def test_quickstart_trains_and_diagnoses_the_step(capsys):
    out = quickstart.main(["--device", "cpu", "--steps", "20"])
    assert out["train"]["final_loss"] < out["train"]["first_loss"]
    assert out["analysis"].module.name == "train_step"
    assert out["analysis"].estimated_step_seconds > 0 and \
        out["analysis"].chains
    assert out["diagnosis"].backend == "nvidia_h100_sxm"
    text = capsys.readouterr().out
    assert "=== LEO analysis of the captured train step ===" in text
    assert "LEO diagnosis — `train_step` on `nvidia_h100_sxm`" in text


def test_serve_demo_admits_mid_stream(capsys):
    out = serve_demo.main(["--device", "cpu"])
    late = out["requests"][-1]
    assert late.rid == 99 and late.done
    assert out["solo"].generated == late.generated
    assert [len(r.generated) for r in out["requests"]] == [6, 12, 18, 8]
    assert "its tokens match a solo run exactly" in capsys.readouterr().out


def test_rewrite_demo_smoke(capsys):
    assert rewrite_demo.main(["--smoke"]) == 0
    text = capsys.readouterr().out
    assert "nvidia_gh200   advice         CoalesceSyncTags(group=2)" in text
    assert "intel_pvc      advice         TreeReduceChain(min_length=4)" \
        in text
    assert "rewrite demo OK" in text


def test_analysis_client_demo_against_a_server(tmp_path, capsys):
    from repro_torch.serve import LeoHttpd
    out = tmp_path / "metrics.txt"
    with LeoHttpd(port=0, slots=2) as app:
        assert analysis_client_demo.main(
            ["--port", str(app.port), "--requests", "4",
             "--metrics-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "-- cross-vendor fan-out --" in text
    assert "4 diagnoses back" in text
    assert "leo_requests_total" in out.read_text()
