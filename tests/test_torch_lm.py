"""The port's decoder LM (``repro_torch.models.lm``) against the
reference's, on the CPU, and the port's own decode parity.

* The ten archs at ``configs.reduced`` widths (seq 20: mixtral-8x22b's
  window is 16, so its ring cache wraps): the reference's params
  (``jax.random``, f32) carried across by ``convert``, the same numpy
  tokens; the full forward's logits and aux, every decode step's logits
  (``make_decode_step`` from an empty cache) and the final cache, within
  ``chip_smoke.LM_ATOL`` (``tests/test_decode_parity.py``'s tolerances,
  2e-4 dense and 5e-3 where MoE routing or Mamba's exp chain takes part;
  rtol 1e-4). The precomputed-embeds input of the vit_stub frontend and
  the hidden output, against the reference.
* The golden: ``chip_smoke.py`` phase 9 (a)'s logic, the ten archs,
  and (d)'s ``serving_rate`` against ``tests/golden/torch_port_lm.npz``
  on the port's CPU path.
* The twins of ``tests/test_decode_parity.py`` on the port (decode
  against its own full forward, the SWA mask, the sharded cache
  attention on a one-device mesh), the select write and the unrolled
  layer loop against the defaults.
* ``init_params`` against ``jax.eval_shape`` of the reference's (paths,
  shapes, dtypes), for every arch at full size; the converters' round
  trips and refusals; the mesh.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.serve.serve_step import make_decode_step as j_make_decode_step
from repro_torch import configs, convert
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve.serve_step import make_decode_step

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SEQ = 20
BATCH = 2
CPU = "cpu"


def jflat(tree) -> dict:
    """A JAX tree as {path: numpy array}."""
    return {k: np.asarray(v) for k, v in lm.flatten(tree).items()}


def _within(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=chip_smoke.LM_RTOL, err_msg=what)


_RUNS: dict = {}


def _both(arch: str):
    """The reference and the port on one arch (run once per module)."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, cfg = jconfigs.reduced(arch, seq=SEQ), configs.reduced(arch,
                                                                 seq=SEQ)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = convert.lm_params_from_numpy(cfg, jflat(jp), CPU)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    jl, ja, _ = jax.jit(jlm.build_forward(jcfg, remat=False))(
        jp, jnp.asarray(toks))
    jstep = jax.jit(j_make_decode_step(jcfg))
    jc = jlm.init_cache(jcfg, BATCH, SEQ, jnp.float32)
    pl, pa, _ = lm.build_forward(cfg, remat=False)(params, torch.as_tensor(
        toks))
    pstep = make_decode_step(cfg)
    pc = lm.init_cache(cfg, BATCH, SEQ, torch.float32, device=CPU)
    jd, pd = [], []
    for i in range(SEQ):
        lg, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jd.append(np.asarray(lg))
        lg, pc = pstep(params, pc, torch.as_tensor(toks[:, i:i + 1]), i)
        pd.append(lg.numpy())
    _RUNS[arch] = (
        {"logits": np.asarray(jl), "aux": np.asarray(ja),
         "decode": np.stack(jd, 1), "cache": jflat(jc)},
        {"logits": pl.numpy(), "aux": pa.numpy(), "decode": np.stack(pd, 1),
         "cache": convert.lm_cache_to_numpy(pc)},
        cfg)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_reduced_arch_matches_the_reference(arch):
    want, got, cfg = _both(arch)
    atol = chip_smoke.LM_ATOL[chip_smoke.lm_family(cfg)]
    for k in ("logits", "aux", "decode"):
        _within(got[k], want[k], atol, f"{arch} {k}")
    assert set(got["cache"]) == set(want["cache"])
    for k, w in want["cache"].items():
        if w.dtype.kind == "f":
            _within(got["cache"][k], w, atol, f"{arch} cache {k}")
        else:
            np.testing.assert_array_equal(got["cache"][k], w, err_msg=k)
    if arch == "mixtral-8x22b":      # the ring wrapped: slots hold 4..19
        pos = got["cache"]["pos0/attn/pos"][0]
        assert cfg.sliding_window == 16 and sorted(pos) == list(range(4, 20))


def _unit_layer(Lm, moe, p, x, pos, kind, cfg):
    """One layer of ``build_forward``'s unit, full sequence, on either
    side (``Lm`` the layers module, ``moe`` its ``local_moe``)."""
    mixer, ffn = kind
    h = Lm.rms_norm(x, p["norm1"]["scale"])
    if mixer == "attn":
        out, _ = Lm.attention_fwd(
            p["mixer"], h, pos, n_q=cfg.n_q, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window)
    else:
        out, _ = Lm.mamba_fwd(p["mixer"], h)
    x = x + out
    h = Lm.rms_norm(x, p["norm2"]["scale"])
    if ffn == "mlp":
        return x + Lm.mlp_fwd(p["ffn"], h)
    B, S, D = h.shape
    out, _ = moe(h.reshape(B * S, D), *(p["ffn"][k] for k in (
        "router", "w_gate", "w_up", "w_down")))
    return x + out.reshape(B, S, D)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _row_gap(a, b) -> float:
    """The largest gap of a token's residual row, relative to the row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


def test_jamba_gap_is_the_references_own_rounding_sensitivity():
    """Jamba's logits sit ~2e-3 from the reference's (the other archs
    ~1e-5). Layer by layer on phase 9 (a)'s inputs, the residual stream's
    gap (each side its own chain) against the gap one ulp of the input
    embeddings makes inside the reference itself: the port's is no
    larger than a few times that at every layer, so it is f32 rounding
    that the model amplifies, not an order of operations. ``-s`` prints
    the table; "local" is the port's layer on the reference's input."""
    arch = "jamba-1.5-large-398b"
    seq = chip_smoke.LM_GOLDEN["seq"]
    cfg, jcfg = configs.reduced(arch, seq=seq), jconfigs.reduced(arch,
                                                                 seq=seq)
    arrays, toks = chip_smoke.lm_inputs(arch)
    moe = lm._moe_block(cfg, None)
    jmoe = jlm._moe_block(jcfg, None, ("data",), None)
    x0 = arrays["embed"][toks]
    rng = np.random.default_rng(1)
    x1 = np.where(rng.random(x0.shape) < 0.5,
                  np.nextafter(x0, np.float32(np.inf)),
                  np.nextafter(x0, np.float32(-np.inf))).astype(np.float32)
    xj, xu, xt = jnp.asarray(x0), jnp.asarray(x1), torch.as_tensor(x0)
    jpos = jnp.arange(seq, dtype=jnp.int32)
    tpos = torch.arange(seq, dtype=torch.int32)
    P = len(cfg.pattern)
    jlayer = jax.jit(functools.partial(_unit_layer, JL, jmoe),
                     static_argnums=(3, 4))
    rows = []
    for n in range(cfg.num_layers):
        r, i = divmod(n, P)
        pre = f"blocks/pos{i}/"
        flat = {k[len(pre):]: a[r] for k, a in arrays.items()
                if k.startswith(pre)}
        pj = _nest({k: jnp.asarray(v) for k, v in flat.items()})
        pt = _nest({k: torch.as_tensor(v) for k, v in flat.items()})
        kind = cfg.pattern[i]
        local = _unit_layer(L, moe, pt, torch.as_tensor(np.array(xj)),
                            tpos, kind, cfg)
        xj = jlayer(pj, xj, jpos, kind, jcfg)
        xu = jlayer(pj, xu, jpos, kind, jcfg)
        xt = _unit_layer(L, moe, pt, xt, tpos, kind, cfg)
        rows.append((n + 1, kind, _row_gap(local, xj), _row_gap(xt, xj),
                     _row_gap(xu, xj)))
    print("\nlayer  kind           local     port      1-ulp reference")
    for n, kind, loc, port, ulp in rows:
        print(f"{n:5d}  {'/'.join(kind):13s}  {loc:.3g}  {port:.3g}  {ulp:.3g}")
    for n, kind, loc, port, ulp in rows:
        assert port <= 4 * ulp, (n, kind, port, ulp)


def test_precomputed_embeds_and_hidden_output_match_the_reference():
    """internvl2-1b's vit_stub frontend takes [B, S, D] embeds; the hidden
    output is the final norm's."""
    arch = "internvl2-1b"
    jcfg, cfg = jconfigs.reduced(arch), configs.reduced(arch)
    assert cfg.frontend == "vit_stub"
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    params = convert.lm_params_from_numpy(cfg, jflat(jp), CPU)
    emb = np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    want, _, _ = jax.jit(jlm.build_forward(jcfg, remat=False,
                                           output="hidden"))(
        jp, jnp.asarray(emb))
    got, _, _ = lm.build_forward(cfg, output="hidden")(params,
                                                       torch.as_tensor(emb))
    _within(got, want, chip_smoke.LM_ATOL["dense"], "hidden")


# -------------------------------------------------------------- golden --

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_phase9a_matches_the_golden_on_the_cpu_path(arch):
    """``chip_smoke.py`` phase 9 (a) for one arch, on the port's CPU path:
    the generator still makes the golden's inputs, and every output is
    within the golden's tolerance."""
    gold = np.load(chip_smoke.LM)
    arrays, toks = chip_smoke.lm_inputs(arch)
    assert chip_smoke.control_digest({**arrays, "tokens": toks}) == \
        str(gold[f"{arch}/params_sha256"])
    np.testing.assert_array_equal(toks, gold[f"{arch}/tokens"])
    chip_smoke.lm_vs_golden(arch, chip_smoke.run_lm(arch, CPU), gold)


def test_phase9b_ring_attention_on_the_cpu_path():
    """``chip_smoke.py`` phase 9 (b)'s layer check on the port's CPU path,
    at reduced width: 48 tokens through mixtral-8x22b's ring of 16 slots
    (its window at seq 32; it wraps twice) against the full-sequence
    form."""
    cfg = configs.reduced("mixtral-8x22b", seq=32)
    got = chip_smoke.attention_ring(cfg, {"batch": 2, "seq": 48}, CPU, 3)
    assert got["cache_slots"] == cfg.sliding_window == 16
    assert got["max_abs_err"] <= chip_smoke.LM_ATOL["dense"]


def test_phase9d_serving_rate_equals_the_golden_on_the_cpu_path():
    """``chip_smoke.py`` phase 9 (d) on the port's CPU path: every field
    of ``serving_rate`` ``==`` the golden's."""
    from repro_torch.serve.serve_step import serving_rate
    gold = np.load(chip_smoke.LM)
    got = lm.flatten(serving_rate(configs.get(chip_smoke.LM_ARCH),
                                  **chip_smoke.LM_RATE, device=CPU),
                     "serve/")
    assert set(got) == {k for k in gold.files if k.startswith("serve/")}
    for k, v in got.items():
        assert v == gold[k].item(), (k, v, gold[k])
    assert got["serve/sim_ticks"] == 158


# ---------------------------------------------- twins of decode parity --

def _port_parity(arch: str, atol: float, seq: int = 24):
    """``tests/test_decode_parity.py::_parity`` on the port."""
    cfg = configs.reduced(arch, seq=seq)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, num_experts=2, experts_per_token=2)
    params = lm.init_params(cfg, 0, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab, (BATCH, seq),
                         generator=torch.Generator().manual_seed(0))
    full, _, _ = lm.build_forward(cfg, remat=False)(params, toks)
    dfwd = lm.build_forward(cfg, decode=True, remat=False)
    cache = lm.init_cache(cfg, BATCH, seq, torch.float32, device=CPU)
    outs = []
    for i in range(seq):
        lg, _, cache = dfwd(params, toks[:, i:i + 1], cache=cache, pos0=i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=atol, rtol=1e-4)


@pytest.mark.parametrize("arch,atol", [
    ("glm4-9b", 2e-4),            # dense GQA + RoPE
    ("starcoder2-15b", 2e-4),     # GQA kv=4
    ("rwkv6-3b", 2e-4),           # wkv state + token shift
    ("mixtral-8x22b", 5e-3),      # SWA ring cache + MoE (top2-of-2 exact)
    ("jamba-1.5-large-398b", 5e-3),  # mamba state + attn + MoE interleave
])
def test_decode_matches_full_forward(arch, atol):
    _port_parity(arch, atol)


def test_swa_window_masks_old_tokens():
    """SWA: a token further than ``window`` back does not affect logits."""
    cfg = dataclasses.replace(configs.reduced("mixtral-8x22b", seq=24),
                              sliding_window=8, num_experts=2,
                              experts_per_token=2)
    params = lm.init_params(cfg, 1, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab, (1, 24),
                         generator=torch.Generator().manual_seed(1))
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab
    fwd = lm.build_forward(cfg, remat=False)
    l1, _, _ = fwd(params, toks)
    l2, _, _ = fwd(params, toks2)
    np.testing.assert_allclose(l1[0, -1].numpy(), l2[0, -1].numpy(),
                               atol=1e-5)
    assert float((l1[0, 4] - l2[0, 4]).abs().max()) > 1e-5


def _decode_run(cfg, params, toks, **kw):
    step = make_decode_step(cfg, **kw)
    cache = lm.init_cache(cfg, BATCH, toks.shape[1], torch.float32,
                          device=CPU)
    outs = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, i:i + 1], i)
        outs.append(lg)
    return torch.stack(outs, 1), cache


def test_sharded_cache_attention_matches_dense():
    """The distributed-softmax decode path on a 1 x 1 mesh equals the
    dense cache attention (``test_decode_parity.py``'s tolerance)."""
    cfg = configs.reduced("glm4-9b", seq=24)
    params = lm.init_params(cfg, 3, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab, (BATCH, 24),
                         generator=torch.Generator().manual_seed(3))
    mesh = make_host_mesh(CPU)
    a, _ = _decode_run(cfg, params, toks, mesh=mesh, select_write=True,
                       sharded_cache_attn=True)
    b, _ = _decode_run(cfg, params, toks, mesh=mesh)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=1e-4)


def test_select_write_and_unrolled_layers_match_the_defaults():
    cfg = configs.reduced("mixtral-8x22b", seq=20)     # the ring wraps
    params = lm.init_params(cfg, 4, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab, (BATCH, 20),
                         generator=torch.Generator().manual_seed(4))
    a, ca = _decode_run(cfg, params, toks)
    b, cb = _decode_run(cfg, params, toks, select_write=True,
                        scan_layers=False)
    assert torch.equal(a, b)
    for k, v in lm.flatten(ca).items():
        assert torch.equal(v, lm.flatten(cb)[k]), k
    f1 = lm.build_forward(cfg)(params, toks)
    f2 = lm.build_forward(cfg, scan_layers=False, remat=False,
                          mesh=make_host_mesh(CPU))(params, toks)
    assert torch.equal(f1[0], f2[0]) and torch.equal(f1[1], f2[1])


# ---------------------------------------------------- init and convert --

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_init_params_has_the_references_paths_shapes_and_dtypes(arch):
    want = jax.eval_shape(lambda k: jlm.init_params(jconfigs.get(arch), k),
                          jax.random.PRNGKey(0))
    got = lm.param_shapes(configs.get(arch))
    assert {k: (v[0], str(v[1]).split(".")[-1]) for k, v in got.items()} \
        == {k: (tuple(v.shape), str(v.dtype))
            for k, v in lm.flatten(want).items()}


def test_init_params_draws_from_its_seed():
    cfg = configs.reduced("jamba-1.5-large-398b")
    a = lm.init_params(cfg, 5, torch.float32, device=CPU)
    b = lm.init_params(cfg, torch.Generator().manual_seed(5),
                       torch.float32, device=CPU)
    c = lm.init_params(cfg, 6, torch.float32, device=CPU)
    fa, fb, fc = lm.flatten(a), lm.flatten(b), lm.flatten(c)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["blocks/pos0/mixer/w_in"],
                           fc["blocks/pos0/mixer/w_in"])
    # the R repeats are separate draws
    w = fa["blocks/pos0/mixer/w_in"]
    assert w.shape[0] == cfg.repeats and not torch.equal(w[0], w[1])


def test_init_cache_has_the_references_paths_shapes_and_dtypes():
    for arch in ("jamba-1.5-large-398b", "rwkv6-3b", "mixtral-8x22b"):
        jcfg, cfg = jconfigs.reduced(arch), configs.reduced(arch)
        want = jflat(jlm.init_cache(jcfg, 3, 40))
        got = convert.lm_cache_to_numpy(lm.init_cache(cfg, 3, 40,
                                                      device=CPU))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b"])
def test_convert_round_trips(arch):
    jcfg, cfg = jconfigs.reduced(arch), configs.reduced(arch)
    arrays = jflat(jlm.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(cfg, arrays, CPU))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    cache = jflat(jlm.init_cache(jcfg, 2, 8, jnp.float32))
    cache = {k: (np.random.default_rng(0).standard_normal(v.shape).astype(
        v.dtype) if v.dtype.kind == "f" else v) for k, v in cache.items()}
    cback = convert.lm_cache_to_numpy(
        convert.lm_cache_from_numpy(cfg, cache, CPU))
    for k, v in cache.items():
        assert cback[k].dtype == v.dtype and np.array_equal(cback[k], v), k


def test_convert_carries_bf16_and_refuses_unknown_or_missing_paths():
    arch = "glm4-9b"
    jcfg, cfg = jconfigs.reduced(arch), configs.reduced(arch)
    arrays = jflat(jlm.init_params(jcfg, jax.random.PRNGKey(3)))  # bf16
    assert arrays["embed"].dtype == ml_dtypes.bfloat16
    params = convert.lm_params_from_numpy(cfg, arrays, CPU)
    assert params["embed"].dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(params)
    np.testing.assert_array_equal(back["embed"],
                                  arrays["embed"].astype(np.float32))
    with pytest.raises(NotImplementedError, match="not in the port"):
        convert.lm_params_from_numpy(cfg, {**arrays, "blocks/pos0/x": 0},
                                     CPU)
    short = dict(arrays)
    del short["head"]
    with pytest.raises(NotImplementedError, match="missing"):
        convert.lm_params_from_numpy(cfg, short, CPU)
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(
            cfg, {**arrays, "head": arrays["head"][:, :3]}, CPU)
    with pytest.raises(NotImplementedError, match="not in the port"):
        convert.lm_cache_from_numpy(cfg, {"pos0/mamba": np.zeros(3)}, CPU)


# ---------------------------------------------------------------- mesh --

def test_meshes():
    m = make_host_mesh(CPU)
    assert m.axis_names == ("data", "model") and m.shape == (1, 1)
    assert m.devices == (torch.device("cpu"),) and m.size == 1
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"names {n} cards"):
            make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError, match="needs 2 devices"):
        Mesh(("data", "model"), (1, 2), (torch.device("cpu"),))
