"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's ``repro.train.optimizer``, on the CPU.

* ``apply_updates`` over three steps of a small tree whose dict order
  is not JAX's sorted order (so the gradient norm's leaf order shows),
  f32 and bf16 params x f32 and bf16 moments, against the eager and the
  jitted reference: the gradient norm within 2e-7 (its sums run in
  another order, so the clip scale may differ in its last bit), f32
  state within 4 ulps of the leaf's largest magnitude plus, for params,
  4e-7 of the learning rates summed (the update's chain rounded
  otherwise, and fused under ``jit``), bf16 state within one bf16 ulp.
* The warmup schedule, the clip, the step counter (0-d int32, in place),
  updates in place over slices of a leaf (the same bits as whole), and
  the twins of ``tests/test_substrate.py``'s optimizer tests.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tree(rng) -> dict:
    """Leaves in an order that sorted keys change: b before a, nested."""
    return {"b": rng.standard_normal((7, 5)),
            "a": {"z": rng.standard_normal((300,)),
                  "y": rng.standard_normal(())},
            "c": 1e-3 * rng.standard_normal((4, 3, 2))}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t).astype(np.float32) if np.asarray(t).dtype == \
        ml_dtypes.bfloat16 else np.asarray(t)


def _run(pdt: str, mdt: str, jit: bool, steps: int = 3, clip=1.0):
    rng = np.random.default_rng(5)
    p0 = _tree(rng)
    grads = [jax.tree_util.tree_map(lambda a: 3 * a, _tree(rng))
             for _ in range(steps)]
    tdt, jdt = DTYPES[pdt]
    tm, jm = DTYPES[mdt]
    kw = dict(lr=1e-2, warmup_steps=2, grad_clip=clip)
    tcfg = opt.AdamWConfig(moment_dtype=tm, **kw)
    jcfg = jopt.AdamWConfig(moment_dtype=jm, **kw)

    def tt(tree, dt):
        return {k: tt(v, dt) if isinstance(v, dict) else
                torch.as_tensor(np.asarray(v, np.float32)).to(dt)
                for k, v in tree.items()}
    tp = tt(p0, tdt)
    ts = opt.init_opt_state(tp, tcfg)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32)
                                .astype(jdt), p0)
    js = jopt.init_opt_state(jp, jcfg)
    upd = jax.jit(jopt.apply_updates, static_argnums=3) if jit else \
        jopt.apply_updates
    out = []
    for g in grads:
        tp, ts, tn = opt.apply_updates(tp, tt(g, tdt), ts, tcfg)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(
            a, jnp.float32).astype(jdt), g)
        jp, js, jn = upd(jp, jg, js, jcfg)
        out.append((float(tn), float(jn)))
    return tp, ts, jp, js, out


def _pairs(t: dict, j: dict, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _pairs(v, j[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", _np(v), _np(j[k])


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
@pytest.mark.parametrize("pdt", ["f32", "bf16"])
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_apply_updates_matches_the_reference(pdt, mdt, jit):
    tp, ts, jp, js, norms = _run(pdt, mdt, jit)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for tn, jn in norms:
        assert tn == pytest.approx(jn, rel=2e-7)
    lr_sum = 1e-2 * (0.5 + 1 + 1)
    trees = [(tp, jp, pdt, 4e-7 * lr_sum)] + [
        (ts[w], js[w], mdt, 0.0) for w in ("m", "v")]
    for t, j, dt, slack in trees:
        for path, a, b in _pairs(t, j):
            if dt == "f32":
                # an entry's terms are of the leaf's scale, so its
                # rounding is too (a moment that cancels to ~0 keeps it)
                ulp = np.spacing(np.maximum(np.abs(b), np.abs(b).max())
                                 .astype(np.float32))
                assert (np.abs(a - b) <= 4 * ulp + slack).all(), path
            else:
                ulp = np.abs(b) * 2.0 ** -7 + 1e-30
                assert (np.abs(a - b) <= ulp).all(), path


@pytest.mark.parametrize("step", [0, 1, 7, 100, 1000])
def test_schedule_matches_the_reference(step):
    for warm in (1, 100, 0):
        tc = opt.AdamWConfig(lr=3e-4, warmup_steps=warm)
        jc = jopt.AdamWConfig(lr=3e-4, warmup_steps=warm)
        got = opt._schedule(tc, torch.tensor(step, dtype=torch.int32))
        want = jopt._schedule(jc, jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == float(want)


def test_clip_scales_as_the_reference():
    tp, ts, jp, js, norms = _run("f32", "f32", False, steps=1, clip=0.5)
    assert norms[0][0] > 0.5        # the clip is active
    for path, a, b in _pairs(ts["m"], js["m"]):
        ulp = np.spacing(np.abs(b).astype(np.float32))
        assert (np.abs(a - b) <= 4 * ulp).all(), path


def test_update_in_place_over_slices_is_the_whole(monkeypatch):
    rng = np.random.default_rng(9)
    p = {"w": torch.as_tensor(rng.standard_normal((33, 17)),
                              dtype=torch.float32)}
    g = {"w": torch.as_tensor(rng.standard_normal((33, 17)),
                              dtype=torch.float32)}
    cfg = opt.AdamWConfig(warmup_steps=1)
    whole = {"w": p["w"].clone()}
    s_whole = opt.init_opt_state(whole, cfg)
    opt.apply_updates(whole, g, s_whole, cfg)
    monkeypatch.setattr(opt, "SLICE", 100)
    s = opt.init_opt_state(p, cfg)
    ids = (id(p["w"]), id(s["m"]["w"]), id(s["v"]["w"]), id(s["step"]))
    p2, s2, _ = opt.apply_updates(p, g, s, cfg)
    assert (id(p2["w"]), id(s2["m"]["w"]), id(s2["v"]["w"]),
            id(s2["step"])) == ids
    for a, b in ((p["w"], whole["w"]), (s["m"]["w"], s_whole["m"]["w"]),
                 (s["v"]["w"], s_whole["v"]["w"])):
        assert torch.equal(a, b)


def test_init_opt_state_matches_the_reference():
    p = {"b": torch.zeros((3, 2), dtype=torch.bfloat16),
         "a": torch.zeros((4,))}
    jp = {"b": jnp.zeros((3, 2), jnp.bfloat16), "a": jnp.zeros((4,))}
    for tm, jm in DTYPES.values():
        s = opt.init_opt_state(p, opt.AdamWConfig(moment_dtype=tm))
        js = jopt.init_opt_state(jp, jopt.AdamWConfig(moment_dtype=jm))
        for w in ("m", "v"):
            for k in ("a", "b"):
                assert tuple(s[w][k].shape) == js[w][k].shape
                assert str(s[w][k].dtype).split(".")[-1] == \
                    str(js[w][k].dtype)
                assert not s[w][k].any()
        assert s["step"].dtype == torch.int32 and int(s["step"]) == 0


def test_adamw_descends_quadratic():
    params = {"x": torch.tensor([3.0, -2.0])}
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    state = opt.init_opt_state(params, cfg)
    for _ in range(150):
        grads = {"x": 2 * params["x"]}
        params, state, gnorm = opt.apply_updates(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.15
    assert int(state["step"]) == 150


def test_adamw_grad_clip():
    params = {"x": torch.tensor([0.0])}
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=1.0)
    state = opt.init_opt_state(params, cfg)
    _, _, gnorm = opt.apply_updates(params, {"x": torch.tensor([1e6])},
                                    state, cfg)
    assert float(gnorm) == pytest.approx(1e6)
