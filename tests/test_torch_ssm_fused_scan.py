"""A model of one step of K4's fused entry, in numpy float32, on the CPU.

The CUDA kernel (`csrc/ssm_scan.cu`, `repro_ssm_scan_fused_fwd`) runs only
on the card, and its own checks are the card tests
(`tests/test_torch_gpu.py::test_ssm_scan_fused` and
`test_ssm_scan_fused_carries_the_state_across_chunks`).  This file checks
one choice of its arithmetic that those tests see only through y: a
thread composes its `kFusedSteps` consecutive steps into `h -> A h + B`,
and forms A as one exponential of the summed dt, `2^(na * sum dt)` with
`na = -exp(a_log) log2(e)`, instead of multiplying the steps' `a`.  The
number of steps is read from the source; `ex2.approx` is modelled by
float32 `exp2`.
"""
import re
from pathlib import Path

import numpy as np
import pytest

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "ssm_scan.cu").read_text()
STEPS = int(re.search(r"constexpr int kFusedSteps = (\d+);", SOURCE)[1])
LOG2E = np.float32(1.4426950408889634)
F32 = np.float32


@pytest.mark.parametrize("a_log", [-4.0, 0.0, float(np.log(16))],
                         ids=["slow-decay", "unit", "fast-decay"])
def test_segment_decay_is_one_exponential_of_the_summed_dt(a_log):
    """A = 2^(na * sum dt) against the product of the steps' 2^(na * dt),
    both in float32, at (din, N) = (4096, 16) of one regime of a_log.

    Each of the R = kFusedSteps terms rounds at most twice in either form
    (the product na * dt and the sum or the running product), and A <= 1
    turns the argument's error dx into at most A |x| ln2 dx <= dx / e, so
    the two differ by at most 4 R eps: ~7.6e-6 at R 16, under the card
    tests' 1e-4 by more than ten times."""
    rng = np.random.default_rng(int(a_log * 10) + 40)
    n_ch, n = 4096, 16
    a_log = (a_log + 0.1 * rng.standard_normal((n_ch, n))).astype(F32)
    na = (-np.exp(a_log) * LOG2E).astype(F32)
    v = (2 * rng.standard_normal((n_ch, STEPS))).astype(F32)
    dt = np.maximum(v, F32(0)) + np.log1p(np.exp(-np.abs(v)))  # softplus
    prod = np.ones((n_ch, n), F32)
    dts = np.zeros(n_ch, F32)
    for r in range(STEPS):
        prod = prod * np.exp2(na * dt[:, r, None])
        dts = dts + dt[:, r]
    got = np.exp2(na * dts[:, None])
    assert got.dtype == prod.dtype == F32
    np.testing.assert_allclose(
        got, prod, rtol=0, atol=4 * STEPS * np.finfo(F32).eps)
