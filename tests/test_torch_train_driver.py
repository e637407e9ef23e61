"""The port's train driver (`python -m repro_torch.launch.train`) on the CPU.

The reference's own driver fails on this tree (ROADMAP C-watch 1), so its
`TestTrainDriver` cases are mirrored on the port, and the driver's steps
are held to the reference's `make_train_step` under plain `jax.jit` with
the options the reference's `launch/train.py::build` computes (remat
"group", chunk `min(512, seq)`, warmup `max(1, min(100, steps // 10))`
over `steps`, lr 3e-3 on a smoke config), both from the reference's train
state carried across by `train_state_from_numpy` and on the same synthetic
batches.  The parity runs in f32, with `tests/test_torch_train.py`'s
tolerances: loss and grad norm rel 1e-5 (the same f32 program, sums in
another order), `lr_scale` 1e-7 (f32 arithmetic on exact inputs).  In bf16
the two packages' gradients are too far apart for a parity test (there).

No test here captures a backward with `device="cuda"`: on a CPU-only torch
that aborts the process (a C++ error from autograd's `AccumulateGrad`), so
`--analyze` is driven with `--device cpu`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.data import SyntheticConfig as JSyntheticConfig
from repro.data import SyntheticTokenDataset as JSyntheticTokenDataset
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import TrainOptions as JTrainOptions
from repro.runtime import init_train_state as j_init_train_state
from repro.runtime import make_train_step as j_make_train_step
import repro_torch.core as core
from repro_torch.configs import get_config
from repro_torch.core import capture
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import main
from repro_torch.models import loss_fn, train_state_from_numpy

ARCH = "qwen2-0.5b"
CPU = ["--device", "cpu"]


def test_smoke_train_loss_decreases(tmp_path):
    res = main(["--arch", ARCH, "--smoke", "--steps", "30", "--batch", "8",
                "--seq", "32", "--checkpoint-dir", str(tmp_path)] + CPU)
    assert res["final_loss"] < res["first_loss"]
    assert res["steps"] == 30 and len(res["history"]) == 30
    # the final save, and the one every 25 steps
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000025", "step_00000030"]


def test_restore_resumes(tmp_path, capsys):
    main(["--arch", ARCH, "--smoke", "--steps", "10", "--batch", "4",
          "--seq", "16", "--checkpoint-dir", str(tmp_path),
          "--checkpoint-every", "5"] + CPU)
    res = main(["--arch", ARCH, "--smoke", "--steps", "12", "--batch", "4",
                "--seq", "16", "--checkpoint-dir", str(tmp_path),
                "--restore"] + CPU)
    assert res["steps"] == 2  # resumed from step 10
    assert "restored from step 10" in capsys.readouterr().out
    assert [h["step"] for h in res["history"]] == [10, 11]


def test_restored_run_continues_the_uninterrupted_one(tmp_path):
    """Two steps, saved and restored, then two more: the same losses, bit
    for bit, as four steps in one run (the CPU is deterministic)."""
    args = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32"] + CPU
    whole = main(args + ["--steps", "4"])
    main(args + ["--steps", "2", "--checkpoint-dir", str(tmp_path)])
    resumed = main(args + ["--steps", "4", "--checkpoint-dir",
                           str(tmp_path), "--restore"])
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][2:]]


def test_first_steps_match_the_reference_jitted_step(monkeypatch):
    steps, batch, seq = 3, 4, 64
    jcfg = dataclasses.replace(j_smoke(j_get_config(ARCH)), dtype="float32")
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)

    def f32_config(name):
        return dataclasses.replace(get_config(name), dtype="float32")

    def carried(cfg, generator=None, device="cuda"):
        return train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                      device)
    monkeypatch.setattr(train_mod, "get_config", f32_config)
    monkeypatch.setattr(train_mod, "init_train_state", carried)
    res = main(["--arch", ARCH, "--smoke", "--steps", str(steps),
                "--batch", str(batch), "--seq", str(seq)] + CPU)

    # the options the reference's build computes for this run
    options = JTrainOptions(remat="group", chunk=min(512, seq),
                            warmup_steps=max(1, min(100, steps // 10)),
                            total_steps=steps)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=3e-3), options))
    ds = JSyntheticTokenDataset(JSyntheticConfig(
        vocab_size=jcfg.vocab_size, seq_len=seq, d_model=jcfg.d_model,
        frontend=jcfg.frontend))
    for i, row in enumerate(res["history"]):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray,
                                                ds.batch(i, 0, batch)))
        assert row["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5), i
        assert row["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                                 rel=1e-5), i
        assert row["lr_scale"] == pytest.approx(float(jm["lr_scale"]),
                                                abs=1e-7), i
    assert [row["lr_scale"] for row in res["history"]][:2] == [0.0, 1.0]
    assert len(res["history"]) == steps


def test_analyze_captures_the_whole_step(capsys, monkeypatch):
    seq = 64
    captured = []

    def recording_capture(*args, **kwargs):
        captured.append(capture(*args, **kwargs))
        return captured[-1]
    monkeypatch.setattr(core, "capture", recording_capture)
    res = main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", str(seq), "--analyze"] + CPU)
    assert res["leo_step_seconds"] > 0
    out = capsys.readouterr().out
    assert "LEO analysis [nvidia_h100_sxm] module=train_step" in out
    cfg, state, pipeline, _ = train_mod.build(ARCH, True, 2, seq, "cpu")
    loss = capture(lambda p, b: loss_fn(p, cfg, b, chunk=min(512, seq)),
                   state["params"], pipeline.device_batch(0), device="cpu")
    loss_flops = sum(i.flops for i in loss.all_instructions())
    # forward, the backward through the recomputed layers, clipping, AdamW
    (step,) = captured
    assert step.name == "train_step"
    assert sum(i.flops for i in step.all_instructions()) > 3 * loss_flops
    assert sum(1 for _ in step.all_instructions()) > \
        3 * sum(1 for _ in loss.all_instructions())


def test_one_card_only():
    with pytest.raises(ValueError, match="model-parallel"):
        main(["--smoke", "--model-parallel", "2"] + CPU)


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        main(["--smoke", "--steps", "1"])
