"""How far bf16 moves the logits of a hybrid model from its f32 logits, in
the JAX package and in the port, on the same weights and tokens.

bf16 rounds the residual stream, the projections and attention's
probabilities; with random weights the error grows with depth and length.
If the port rounds at the places the reference does, bf16 moves both by
about as much: the test holds the port's mean drift to within 25% of the
reference's, and its top-1 agreement with its own f32 logits to within 0.02
of the reference's, at smoke size.

The same comparison at full width, depth cut, on the CPU:

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_drift.py \\
      --arch hymba-1.5b --layers 8 --seq 512

(8 layers of hymba-1.5b at S 512 hold about 6 GiB.)  It prints one JSON
object: each drift as max and mean abs difference over the largest f32
logit, and top-1 agreement.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke
from repro.models import transformer as jt
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import convert
from repro_torch.models import transformer as tt


def drift(arch: str, n_layers: int, seq: int, smoke: bool = True,
          seed: int = 0) -> dict:
    """Logits of one sequence of `seq` tokens in f32 and in bf16, through
    the reference and through the port's plain path, with the bf16 weights
    the f32 weights rounded (the f32 leaves of the SSM stay f32)."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if smoke:
        jcfg, tcfg = j_smoke(jcfg), smoke_config(tcfg)
    jcfg32 = dataclasses.replace(jcfg, n_layers=n_layers, dtype="float32")
    tcfg32 = dataclasses.replace(tcfg, n_layers=n_layers, dtype="float32")
    jcfg16 = dataclasses.replace(jcfg32, dtype="bfloat16")
    tcfg16 = dataclasses.replace(tcfg32, dtype="bfloat16")
    p32 = jt.init_params(jax.random.PRNGKey(seed), jcfg32)
    like16 = jax.eval_shape(
        lambda: jt.init_params(jax.random.PRNGKey(seed), jcfg16))
    p16 = jax.tree.map(lambda a, s: a.astype(s.dtype), p32, like16)
    tokens = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, size=(1, seq))
    logits = {}
    for name, jc, tc, p in (("32", jcfg32, tcfg32, p32),
                            ("16", jcfg16, tcfg16, p16)):
        logits["ref" + name] = np.asarray(jt.forward(
            p, jc, tokens=jnp.asarray(tokens), chunk=256)[0], np.float32)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), tc,
                                       "cpu")
        with torch.no_grad():
            logits["port" + name] = tt.forward(
                tp, tc, tokens=torch.from_numpy(tokens),
                chunk=256)[0].float().numpy()
        del tp
    scale = float(np.abs(logits["ref32"]).max())

    def apart(a, b):
        diff = np.abs(logits[a] - logits[b])
        return {"max": float(diff.max()) / scale,
                "mean": float(diff.mean()) / scale,
                "top1": float((logits[a].argmax(-1) ==
                               logits[b].argmax(-1)).mean())}

    return {"arch": arch, "smoke": smoke, "layers": n_layers, "seq": seq,
            "max_abs_logit": scale,
            "ref_bf16_vs_f32": apart("ref16", "ref32"),
            "port_bf16_vs_f32": apart("port16", "port32"),
            "port_vs_ref_f32": apart("port32", "ref32"),
            "port_vs_ref_bf16": apart("port16", "ref16")}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "h2o-danube-3-4b"])
def test_bf16_moves_port_and_reference_alike(arch):
    """S 128 is twice the smoke window."""
    d = drift(arch, n_layers=2, seq=128)
    ref, port = d["ref_bf16_vs_f32"], d["port_bf16_vs_f32"]
    assert ref["mean"] > 0  # bf16 does move the reference
    assert abs(port["mean"] - ref["mean"]) <= 0.25 * ref["mean"], d
    assert abs(port["top1"] - ref["top1"]) <= 0.02, d
    assert d["port_vs_ref_f32"]["max"] <= 1e-4, d


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's widths (default: full width)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(drift(args.arch, args.layers, args.seq, args.smoke,
                           args.seed), indent=1))
