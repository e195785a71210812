"""Jamba's train step (Mamba mixers, MoE, attention) against the live
jitted reference on the CPU, and the reference's own sensitivity that
leaves its step-2 grad norm and moments unheld
(``chip_smoke.TRAIN_CHAOTIC``).

Step 1, and step 2's loss, ce and aux, are held as every arch's are
(``chip_smoke.train_vs``, 5e-3). Step 2's gradients start from params
that Adam's sign-like first update (g / |g|) has moved by +-lr wherever
a gradient sits near 0, and jamba amplifies that: an ulp of noise on
JAX's own embedding moves JAX's own step-2 grad norm and moments past
any tolerance of that size. Kept apart from ``test_torch_train_step.py``
because its jitted reference compiles for ~20 s.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = "cpu"
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def runs():
    """The reference (inputs as drawn, and with the embedding one ulp
    up) and the port, every entry recorded."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference", REPO / "scripts" / "torch_port_reference.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    size = chip_smoke.TRAIN_GOLDEN
    arrays, batch = chip_smoke.train_inputs(ARCH, size)
    nudged = dict(arrays, embed=np.nextafter(
        arrays["embed"], np.float32(np.inf)).astype(np.float32))
    return {"jax": ref.jax_train(ARCH, size, full=True),
            "jax_ulp": ref.jax_train(ARCH, size, full=True,
                                     inputs=(nudged, batch)),
            "port": chip_smoke.run_train(ARCH, CPU, full=True),
            "params0": arrays}


def _gaps(a: dict, b: dict) -> dict:
    """Step-2 grad norm's relative gap, and the moments' largest gap
    over their leaf's largest magnitude."""
    out = {"grad_norm": abs(float(a["s2/grad_norm"]) - float(
        b["s2/grad_norm"])) / float(b["s2/grad_norm"])}
    for tag in ("m", "v"):
        out[tag] = max(float(np.abs(a[k] - b[k]).max()
                             / np.abs(b[k]).max())
                       for k in b if k.startswith(tag + "/"))
    return out


def test_jamba_train_step_matches_the_jitted_reference(runs):
    cfg = configs.reduced(ARCH, seq=chip_smoke.TRAIN_GOLDEN["seq"])
    worst = chip_smoke.train_vs(ARCH, runs["port"], runs["jax"],
                                chip_smoke.lm_family(cfg), runs["params0"],
                                full=True)
    unheld = worst.pop("step2_unheld")
    assert max(worst.values()) <= 1, worst
    assert set(unheld) == {"grad_norm", "m", "v"}


def test_jamba_step2_is_chaotic_in_the_reference_itself(runs):
    own = _gaps(runs["jax_ulp"], runs["jax"])
    port = _gaps(runs["port"], runs["jax"])
    print(f"\njamba step 2: an ulp on JAX's embedding moves JAX by {own}; "
          f"the port sits {port} from JAX")
    assert ARCH in chip_smoke.TRAIN_CHAOTIC
    rtol = chip_smoke.TRAIN_RTOL["moe"]
    # the reference's own step-2 grad norm and moments move past the
    # tolerance under one ulp on one leaf ...
    assert own["grad_norm"] > rtol and min(own["m"], own["v"]) > rtol
    # ... while its step 1 and step 2's loss stay within it
    for k in ("s1/loss", "s1/ce", "s1/moe_aux", "s1/grad_norm", "s2/loss",
              "s2/ce", "s2/moe_aux"):
        w = float(runs["jax"][k])
        assert abs(float(runs["jax_ulp"][k]) - w) <= rtol * abs(w), k
