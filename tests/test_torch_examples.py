"""The port's examples (`python -m repro_torch.examples.<name>`) on the CPU:
the quickstart at a reduced step count (its own assertion: the loss fell)
and the serve demo (a request admitted mid-stream yields its solo run's
tokens), each through the port's entry points with `--device cpu`."""
from repro_torch.examples import quickstart, serve_demo


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
