"""The port's last entry points against the reference, on the CPU:
``commit_selection``, ``INVALID``, ``__version__``,
``model_flops_per_device``, the Chrome-trace export, the CLI canaries'
``__main__`` blocks, the traffic and shard canaries' printed lines, and
the entry golden's layout.

* ``commit_selection`` bitwise against the reference's on a seeded
  ``LBState`` (F = 16, K = 8, a random ``injected`` mask); the constants
  and ``model_flops_per_device`` ``==``.
* ``scripts/trace_export_torch.py`` at ``--ticks 400 --probe-every 8
  --slots 16`` against a live ``scripts/trace_export.py`` at the same
  flags: the JSON text ``==``, the printed lines ``==``.
* The traffic canary through ``python -m repro_torch.network.traffic
  --device cpu`` and the shard canary over ``(cpu,) * 4``: their lines
  ``==`` the golden's (``tests/golden/torch_port_entry.npz``, written by
  ``scripts/torch_port_reference.py --which entry``) once the golden's
  ``mask`` has replaced the wall seconds and the device count on both.
* Every canary module's ``__main__`` block, run as ``python -m`` runs it
  (a second copy of the module), calls the canonical module's function
  with the ``--device`` it was given.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.lb import schemes as jschemes
from repro.launch import roofline as jroofline
from repro.network import ecmp as jecmp
import repro_torch
from repro_torch.core.lb import schemes
from repro_torch.launch import roofline
from repro_torch.network import ecmp

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import ENTRY, masked  # noqa: E402

#: the canary modules' ``__main__`` blocks: (module, arguments, function)
MAINS = (("repro_torch.network.faults", [], "_smoke"),
         ("repro_torch.network.faults", ["--endpoint"], "_endpoint_smoke"),
         ("repro_torch.network.telemetry", [], "_smoke"),
         ("repro_torch.core.link", [], "_smoke"),
         ("repro_torch.network.traffic", [], "_canary"),
         ("repro_torch.network.shard", [], "_smoke"))


@pytest.fixture(scope="module")
def gold():
    return np.load(ENTRY)


def _lines(a) -> "list[str]":
    return [str(x) for x in np.atleast_1d(a)]


def _lb_lanes(f: int, k: int, seed: int) -> dict:
    """Seeded lanes of every ``LBState`` field (uint32 ``salt`` included)."""
    rng = np.random.default_rng(seed)
    i32 = lambda *s: rng.integers(-1, 1 << 20, s).astype(np.int32)  # noqa: E731
    return {"rr_ptr": i32(f), "reps_ring": i32(f, k), "reps_head": i32(f),
            "reps_size": i32(f), "ev_set": i32(f, k),
            "cong_bits": rng.random((f, k)) < 0.5,
            "salt": rng.integers(0, 1 << 32, f, dtype=np.uint64)
            .astype(np.uint32),
            "bad_ev": i32(f, k), "bad_n": i32(f), "last_ev": i32(f)}


def _torch_lb(lanes: dict) -> schemes.LBState:
    return schemes.LBState(**{
        k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
        for k, v in lanes.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_selection_is_the_references(seed):
    f, k = 16, 8
    old, new = _lb_lanes(f, k, 2 * seed), _lb_lanes(f, k, 2 * seed + 1)
    injected = np.random.default_rng(seed + 100).random(f) < 0.5
    want = jschemes.commit_selection(
        jschemes.LBState(**{n: jnp.asarray(v) for n, v in old.items()}),
        jschemes.LBState(**{n: jnp.asarray(v) for n, v in new.items()}),
        jnp.asarray(injected))
    got = schemes.commit_selection(_torch_lb(old), _torch_lb(new),
                                   torch.from_numpy(injected))
    for name in old:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == (np.int32 if w.dtype == np.uint32 else w.dtype)
        np.testing.assert_array_equal(g.view(w.dtype), w, err_msg=name)


def test_constants_are_the_references():
    assert ecmp.INVALID == int(jecmp.INVALID)
    assert ecmp.DELIVERED == int(jecmp.DELIVERED)
    assert repro_torch.__version__ == repro.__version__


@pytest.mark.parametrize("kind", ["train", "forward"])
def test_model_flops_per_device_is_the_references(kind):
    assert roofline._SHAPE_TOKENS == jroofline._SHAPE_TOKENS
    for shape in jroofline._SHAPE_TOKENS:
        rep = {"active_params": 33.3e9, "kind": kind, "shape": shape,
               "devices": 256}
        assert roofline.model_flops_per_device(rep) \
            == jroofline.model_flops_per_device(rep)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_export_is_the_references(tmp_path):
    flags = ["--ticks", "400", "--probe-every", "8", "--slots", "16"]
    out = {}
    for tag, script, extra in (
            ("jax", "trace_export.py", []),
            ("torch", "trace_export_torch.py", ["--device", "cpu"])):
        path = tmp_path / f"{tag}.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _load(REPO / "scripts" / script, f"export_{tag}").main(
                flags + ["--out", str(path)] + extra)
        assert rc == 0
        out[tag] = (path.read_text(),
                    buf.getvalue().replace(str(path), "<out>"))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]


def test_traffic_canary_under_python_m_prints_the_golden(gold):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.network.traffic", "--device",
         "cpu"], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    mask = str(gold["mask"])
    assert masked(proc.stdout.splitlines(), mask) \
        == masked(_lines(gold["canary/traffic"]), mask)


def test_shard_canary_over_four_cpus_prints_the_golden(gold, monkeypatch):
    from repro_torch.network import fabric, shard
    seen = []
    orig = fabric.simulate_batch

    def spy(*args, **kw):
        if kw.get("devices") is not None:
            seen.append(tuple(str(d) for d in kw["devices"]))
        return orig(*args, **kw)
    monkeypatch.setattr(fabric, "simulate_batch", spy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert shard._smoke("cpu") == 0
    assert seen == [("cpu",) * 4]
    mask = str(gold["mask"])
    lines = buf.getvalue().splitlines()
    assert lines == ["shard smoke ok: 4 devices, B=6 (ragged), bitwise "
                     "parity with the unsharded engine"]
    assert masked(lines, mask) == masked(_lines(gold["canary/shard"]),
                                           mask)


@pytest.mark.filterwarnings(
    "ignore:.*found in sys.modules after import:RuntimeWarning")
@pytest.mark.parametrize("module,args,fn", MAINS,
                         ids=[f"{m}{''.join(a)}" for m, a, _ in MAINS])
def test_canary_main_calls_the_canonical_module(module, args, fn,
                                                monkeypatch):
    """Under ``python -m`` the module file runs a second time as
    ``__main__``, with classes of its own; fabric's ``isinstance``
    checks need the canonical ones, so the block calls the canonical
    module's function."""
    canonical = importlib.import_module(module)
    calls = []
    monkeypatch.setattr(canonical, fn, lambda device: calls.append(device)
                        or 0)
    monkeypatch.setattr(sys, "argv", [module, *args, "--device", "cpu"])
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(module, run_name="__main__")
    assert exit_.value.code == 0
    assert calls == ["cpu"]


def test_the_entry_golden_holds_what_its_readers_expect(gold):
    want = {"mask", "quickstart", "tour", "export", "export_sha256",
            "export_events"} | {f"canary/{c}" for c in (
                "faults", "endpoint", "telemetry", "link", "traffic",
                "shard")}
    assert want <= set(gold.files)
    qs = _lines(gold["quickstart"])
    assert len(qs) == 62 and qs[0] == "=== UET quickstart ==="
    assert [ln.split("]")[0] for ln in qs if re.match(r"\[\d+\] ", ln)] \
        == [f"[{i}" for i in range(1, 13)]
    assert len(_lines(gold["tour"])) == 19
    assert len(_lines(gold["export"])) == 4
    assert int(gold["export_events"]) == 423
    assert re.fullmatch(r"[0-9a-f]{64}", str(gold["export_sha256"]))
    counts = {c: len(_lines(gold[f"canary/{c}"])) for c in (
        "faults", "endpoint", "telemetry", "link", "traffic", "shard")}
    assert counts == {"faults": 1, "endpoint": 1, "telemetry": 1,
                      "link": 3, "traffic": 2, "shard": 1}
    mask = str(gold["mask"])
    # the mask takes the traffic canary's seconds and the shard canary's
    # device count, and nothing else of any line
    after = {k: masked(_lines(gold[k]), mask) for k in gold.files
             if k in want and k not in ("mask", "export_sha256",
                                        "export_events")}
    changed = {k: sum(a != b for a, b in zip(v, _lines(gold[k])))
               for k, v in after.items()}
    assert changed == {k: int(k in ("canary/traffic", "canary/shard"))
                       for k in after}
