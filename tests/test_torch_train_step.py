"""The port's training step (``repro_torch.train.train_step``) against the
reference's, on the CPU.

* ``chunked_ce_loss``: value and gradients against the jitted reference,
  over several chunks.
* The train step at ``configs.reduced`` widths on ``chip_smoke.
  train_inputs`` (phase 10 (a)'s params and batch), two steps with
  ``chip_smoke.TRAIN_OPT`` against the live jitted ``make_train_step``
  (``scripts/torch_port_reference.py``'s ``jax_train``): metrics of
  both steps, every entry of the step-1 gradients, the params and
  moments after step 2, by ``chip_smoke.train_vs``'s rules (1e-4 of a
  leaf's largest magnitude dense, 5e-3 with MoE; params after step 2
  within two learning rates anywhere, Adam's first steps being
  sign-like, and within 4 / 10 of them where the gradient clears its
  tolerance tenfold) for a dense GQA arch (glm4-9b), mixtral-8x22b,
  rwkv6-3b and internvl2-1b's precomputed embeds; jamba is in
  ``tests/test_torch_train_jamba.py``. ``microbatches=2`` the same way.
* remat on and off and both ``remat_policy`` values give bitwise equal
  gradients.
* Phase 10 (a) on the port's CPU path against
  ``tests/golden/torch_port_train.npz``, all ten archs, and the golden
  against a live JAX run of one arch.
* The twin of ``tests/test_smoke_archs.py::
  test_train_step_reduces_shapes_and_is_finite`` (slow, as the
  reference's).
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch import tree as T
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (chunked_ce_loss, make_loss_fn,
                                          make_train_step, value_and_grad)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = "cpu"
LIVE = ("glm4-9b", "mixtral-8x22b", "rwkv6-3b", "internvl2-1b")


@pytest.fixture(scope="module")
def reference():
    """``scripts/torch_port_reference.py`` (the JAX side's runner)."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_reference", REPO / "scripts" / "torch_port_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _family(arch: str) -> str:
    return chip_smoke.lm_family(configs.reduced(
        arch, seq=chip_smoke.TRAIN_GOLDEN["seq"]))


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_ce_loss_value_and_grads(chunk):
    rng = np.random.default_rng(3)
    B, S, D, V = 2, 16, 32, 64
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(
        lambda a, b: jts.chunked_ce_loss(a, b, jnp.asarray(lab), chunk),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = chunked_ce_loss(th, tw, torch.as_tensor(lab), chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("arch", LIVE)
def test_train_step_matches_the_jitted_reference(arch, reference):
    size = chip_smoke.TRAIN_GOLDEN
    want = reference.jax_train(arch, size, full=True)
    got = chip_smoke.run_train(arch, CPU, full=True)
    params0, _ = chip_smoke.train_inputs(arch, size)
    worst = chip_smoke.train_vs(arch, got, want, _family(arch), params0,
                                full=True)
    assert max(worst.values()) <= 1, worst
    if arch == "internvl2-1b":     # precomputed embeds: no embedding grad
        assert not got["grad/embed"].any()


def test_microbatches_match_the_reference(reference):
    arch = "glm4-9b"
    size = chip_smoke.TRAIN_GOLDEN
    want = reference.jax_train(arch, size, full=True, microbatches=2)
    got = chip_smoke.run_train(arch, CPU, full=True, microbatches=2)
    params0, _ = chip_smoke.train_inputs(arch, size)
    chip_smoke.train_vs(arch, got, want, _family(arch), params0, full=True)
    # and it is not the one-batch step
    one = chip_smoke.run_train(arch, CPU, full=True)
    assert float(one["s2/loss"]) != float(got["s2/loss"])


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "rwkv6-3b"])
def test_remat_changes_no_gradient(arch):
    cfg = configs.reduced(arch, seq=16)
    arrays, batch = chip_smoke.train_inputs(arch)
    params = convert.lm_params_from_numpy(cfg, arrays, CPU)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    fwd = lm.build_forward(cfg, remat=False, output="hidden")

    def plain(p, b):
        hidden, aux, _ = fwd(p, b["inputs"])
        ce = chunked_ce_loss(hidden, p["head"], b["labels"])
        return ce + 0.01 * aux, (ce, aux)

    runs = [value_and_grad(plain, params, batch)] + [
        value_and_grad(make_loss_fn(cfg, remat_policy=pol), params, batch)
        for pol in ("nothing", "save_mixer")]
    for loss, ce, aux, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(aux, runs[0][2])
        for (path, a), b in zip(T.leaves_with_paths(grads),
                                T.leaves(runs[0][3])):
            assert torch.equal(a, b), path


def test_train_step_updates_in_place():
    cfg = configs.reduced("glm4-9b", seq=16)
    arrays, batch = chip_smoke.train_inputs("glm4-9b")
    params = convert.lm_params_from_numpy(cfg, arrays, CPU)
    ocfg = AdamWConfig(**chip_smoke.TRAIN_OPT)
    opt = init_opt_state(params, ocfg)
    ids = [id(t) for t in T.leaves(params)] + [id(t) for t in T.leaves(opt)]
    p2, o2, mt = make_train_step(cfg, opt_cfg=ocfg)(
        params, opt, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert [id(t) for t in T.leaves(p2)] + [id(t) for t in T.leaves(o2)] \
        == ids
    assert int(o2["step"]) == 1 and o2["step"].dtype == torch.int32
    assert not np.array_equal(params["head"].numpy(), arrays["head"])


def test_phase10a_matches_the_golden_on_the_cpu_path():
    res = chip_smoke.train_golden_phase(CPU)
    assert set(res) == set(configs.ARCH_NAMES)


def test_golden_matches_a_live_reference_run(reference):
    arch = "glm4-9b"
    gold = np.load(chip_smoke.TRAIN)
    live = reference.jax_train(arch, chip_smoke.TRAIN_GOLDEN)
    keys = {k[len(arch) + 1:] for k in gold.files
            if k.startswith(arch + "/") and not k.endswith("_sha256")}
    assert keys == set(live)
    for k in sorted(keys):
        np.testing.assert_array_equal(gold[f"{arch}/{k}"], live[k], k)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.slow
def test_train_step_reduces_shapes_and_is_finite(arch):
    seq = 32
    cfg = configs.reduced(arch, seq=seq)
    gen = torch.Generator().manual_seed(1)
    params = lm.init_params(cfg, gen, torch.float32, device=CPU)
    ocfg = AdamWConfig(lr=1e-3)
    opt = init_opt_state(params, ocfg)
    before = {k: v.clone() for k, v in lm.flatten(params).items()}
    step = make_train_step(cfg, mesh=None, opt_cfg=ocfg)
    inputs = (torch.randn((2, seq, cfg.d_model), generator=gen)
              if cfg.frontend == "vit_stub"
              else torch.randint(0, cfg.vocab, (2, seq), generator=gen))
    batch = {"inputs": inputs,
             "labels": torch.randint(0, cfg.vocab, (2, seq), generator=gen)}
    params2, opt2, metrics = step(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    delta = sum(float((before[k] - v).abs().sum())
                for k, v in lm.flatten(params2).items())
    assert delta > 0.0
