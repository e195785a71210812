"""The port's serving path (``repro_torch.serve.serve_step``) and its
example against the reference's, on the CPU.

* ``make_prefill`` and ``make_decode_step`` (the slice write; the select
  write with the sharded cache attention on a one-device mesh) on the
  reference's params carried across by ``convert``: logits within
  ``chip_smoke.LM_ATOL`` (``tests/test_decode_parity.py``'s 5e-3 for a
  MoE arch; rtol 1e-4), cache positions and valid bits equal.
* ``sample_greedy``: the reference's argmax, the lowest index on ties.
* ``serving_rate`` ``==`` the reference's, every field, floats included
  (the pricing sums python floats in the reference's order, over a
  bitwise-equal simulator run), on a small leaf-spine.
* ``examples/serve_decode_torch.py``'s ``generate`` on the JAX example's
  params and prompts gives the ids ``examples/serve_decode.py`` prints.
"""
import ast
import contextlib
import importlib.util
import io
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import lm as jlm
from repro.network.topology import leaf_spine as j_leaf_spine
from repro.serve import serve_step as jserve
from repro_torch import configs, convert
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.network.topology import leaf_spine
from repro_torch.serve import serve_step

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = "cpu"
ARCH = "mixtral-8x22b"
ATOL = chip_smoke.LM_ATOL["moe"]


def jflat(tree) -> dict:
    return {k: np.asarray(v) for k, v in lm.flatten(tree).items()}


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.reduced(ARCH, seq=16), configs.reduced(ARCH, seq=16)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(11), jnp.float32)
    return jcfg, cfg, jp, convert.lm_params_from_numpy(cfg, jflat(jp), CPU)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=chip_smoke.LM_RTOL)


def test_make_prefill_matches_the_reference(model):
    jcfg, cfg, jp, params = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 16)) \
        .astype(np.int32)
    want = jax.jit(jserve.make_prefill(jcfg))(jp, jnp.asarray(toks))
    got = serve_step.make_prefill(cfg)(params, torch.as_tensor(toks))
    assert tuple(got.shape) == (3, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("kw", [{}, {"mesh": "host", "select_write": True,
                                     "sharded_cache_attn": True}])
def test_make_decode_step_matches_the_reference(model, kw):
    """20 steps into a ring of 16 slots (the window): it wraps."""
    jcfg, cfg, jp, params = model
    jkw, pkw = dict(kw), dict(kw)
    if "mesh" in kw:
        jkw["mesh"], pkw["mesh"] = j_host_mesh(), make_host_mesh(CPU)
    jstep = jax.jit(jserve.make_decode_step(jcfg, **jkw))
    pstep = serve_step.make_decode_step(cfg, **pkw)
    jc = jlm.init_cache(jcfg, 2, 16, jnp.float32)
    pc = lm.init_cache(cfg, 2, 16, torch.float32, device=CPU)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 20)) \
        .astype(np.int32)
    for i in range(20):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        pl, pc = pstep(params, pc, torch.as_tensor(toks[:, i:i + 1]), i)
        assert tuple(pl.shape) == (2, cfg.vocab)
        _close(pl, jl)
    for k in ("pos", "valid"):
        np.testing.assert_array_equal(
            pc["pos0"]["attn"][k].numpy(), np.asarray(jc["pos0"]["attn"][k]))


def test_sample_greedy():
    logits = np.array([[0.1, 3.0, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0],
                       [-5.0, -4.0, -6.0, -4.5]], np.float32)
    got = serve_step.sample_greedy(torch.as_tensor(logits))
    want = jserve.sample_greedy(jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 0, 1]


def test_serving_rate_equals_the_reference():
    """(``step_time`` under both layouts is held in
    ``test_torch_traffic.py``; ``serving_rate`` adds the plan and the
    dict.)"""
    cfg = configs.get(ARCH)
    want = jserve.serving_rate(jconfigs.get(ARCH), dp=2, tp=2,
                               g=j_leaf_spine(2, 2, 4))
    got = serve_step.serving_rate(cfg, dp=2, tp=2, g=leaf_spine(2, 2, 4),
                                  device=CPU)
    assert got == want
    assert got["sim_ticks"] > 0 and got["tokens_per_sec_served"] > 0


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_generates_the_reference_examples_ids():
    """``examples/serve_decode.py`` run as its command line would, and the
    port's ``generate`` on the same params (``init_params`` of
    ``PRNGKey(0)``) and prompts (``randint`` of the same key): the same
    greedy ids for request 0, which the JAX example prints, and for
    every request."""
    B, P, N = 2, 6, 5
    argv = ["serve_decode.py", "--batch", str(B), "--prompt-len", str(P),
            "--tokens", str(N)]
    out = io.StringIO()
    old = sys.argv
    try:
        sys.argv = argv
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(REPO / "examples" / "serve_decode.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("generated ids (request 0):")][0]
    want0 = ast.literal_eval(line.split(":", 1)[1].strip())

    jcfg = jconfigs.reduced(ARCH, seq=64)
    key = jax.random.PRNGKey(0)
    jp = jlm.init_params(jcfg, key, jnp.float32)
    prompts = np.asarray(jax.random.randint(key, (B, P), 0, jcfg.vocab))
    cfg = configs.reduced(ARCH, seq=64)
    example = _load("serve_decode_torch",
                    REPO / "examples" / "serve_decode_torch.py")
    r = example.generate(cfg, convert.lm_params_from_numpy(cfg, jflat(jp),
                                                           CPU),
                         torch.as_tensor(prompts), N)
    assert r["ids"][0].tolist() == want0
    # every request, against the reference's own loop
    jstep = jax.jit(jserve.make_decode_step(jcfg))
    cache = jlm.init_cache(jcfg, B, P + N, jnp.float32)
    for i in range(P):
        lg, cache = jstep(jp, cache, jnp.asarray(prompts[:, i:i + 1]),
                          jnp.int32(i))
    ids = []
    tok = jserve.sample_greedy(lg)[:, None]
    for i in range(N):
        ids.append(np.asarray(tok))
        lg, cache = jstep(jp, cache, tok, jnp.int32(P + i))
        tok = jserve.sample_greedy(lg)[:, None]
    np.testing.assert_array_equal(r["ids"].numpy(), np.concatenate(ids, 1))


def test_example_main_runs_on_the_cpu(capsys):
    example = _load("serve_decode_torch",
                    REPO / "examples" / "serve_decode_torch.py")
    example.main(["--device", CPU, "--batch", "2", "--prompt-len", "4",
                  "--tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: 4 steps")
    assert lines[1].startswith("decode: 3 tokens x 2 requests")
    assert lines[2].startswith("generated ids (request 0): [")
