"""The port's model building blocks (``repro_torch.models.layers`` and the
MoE block of ``repro_torch.models.lm``) against the reference's, on the
CPU: the same numpy inputs and params through both, in f32 unless a
case says bf16.

Tolerances: f32 results within 1e-5 absolute + 1e-5 relative (both
sides round each f32 product and sum once; they differ only in the order
of a matmul's sums and in their exp / log / sin implementations, a few
ulps); bf16 results within one bf16 ulp of the f32 result's size
(2**-8 relative, atol 2**-8), as the two frameworks round their bf16
products at different points. Index lanes (cache positions and valid
bits, MoE routing) are equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -8, rtol=2 ** -8)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    a = jnp.asarray(np.asarray(a))
    return a if dtype is None else a.astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def jit(fn, **static):
    """The reference function jitted once with its static arguments
    bound (one compile per call site instead of one per primitive)."""
    return jax.jit(functools.partial(fn, **static))


def close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tree(params: dict, conv):
    return {k: (_tree(v, conv) if isinstance(v, dict) else conv(v))
            for k, v in params.items()}


def _attn_params(rng, d=32, n_q=4, n_kv=2, hd=8):
    return {"wq": _f(rng, d, n_q * hd, scale=d ** -0.5),
            "wk": _f(rng, d, n_kv * hd, scale=d ** -0.5),
            "wv": _f(rng, d, n_kv * hd, scale=d ** -0.5),
            "wo": _f(rng, n_q * hd, d, scale=d ** -0.5)}


ATTN = dict(n_q=4, n_kv=2, head_dim=8, rope_theta=10000.0)


# ------------------------------------------------------------ basics --

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm(dtype):
    rng = _rng(1)
    x, s = _f(rng, 2, 5, 48, scale=3.0), 1 + _f(rng, 48, scale=0.1)
    if dtype == "f32":
        close(L.rms_norm(_t(x), _t(s)), jit(JL.rms_norm)(_j(x), _j(s)))
    else:
        got = L.rms_norm(_t(x, torch.bfloat16), _t(s, torch.bfloat16))
        want = jit(JL.rms_norm)(_j(x, jnp.bfloat16), _j(s, jnp.bfloat16))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        close(got, want, BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope(dtype):
    rng = _rng(2)
    x = _f(rng, 2, 7, 3, 16)
    pos = np.array([0, 1, 5, 9, 100, 4095, 31000], np.int32)
    if dtype == "f32":
        close(L.rope(_t(x), _t(pos), 1e6), jit(JL.rope, theta=1e6)(_j(x), _j(pos)),
              dict(atol=1e-5, rtol=1e-4))
    else:
        got = L.rope(_t(x, torch.bfloat16), _t(pos), 10000.0)
        want = jit(JL.rope, theta=10000.0)(_j(x, jnp.bfloat16), _j(pos))
        assert got.dtype == torch.bfloat16
        close(got, want, dict(atol=2 ** -7, rtol=2 ** -7))


# --------------------------------------------------------- attention --

@pytest.mark.parametrize("window,sq,sk,chunk", [
    (0, 16, 16, 1024),       # one tile
    (0, 16, 16, 4),          # 4 x 4 tiles, the online softmax across them
    (5, 16, 16, 4),          # a sliding window across tile edges
    (0, 8, 16, 4),           # Sq != Sk: queries at the last 8 positions
    (3, 4, 12, 4),
])
def test_flash_attention(window, sq, sk, chunk):
    rng = _rng(3)
    q, k, v = _f(rng, 2, 4, sq, 8), _f(rng, 2, 2, sk, 8), _f(rng, 2, 2, sk, 8)
    qp = np.arange(sk - sq, sk, dtype=np.int32)
    kp = np.arange(sk, dtype=np.int32)
    got = L.flash_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp), window,
                            q_chunk=chunk, kv_chunk=chunk)
    want = jit(JL.flash_attention, window=window, q_chunk=chunk,
               kv_chunk=chunk)(_j(q), _j(k), _j(v), _j(qp), _j(kp))
    close(got, want)


def test_flash_attention_ragged_length_fails_as_the_reference():
    rng = _rng(4)
    q = _f(rng, 1, 2, 12, 8)
    pos = np.arange(12, dtype=np.int32)
    with pytest.raises(TypeError):
        JL.flash_attention(_j(q), _j(q), _j(q), _j(pos), _j(pos), 0,
                           q_chunk=8, kv_chunk=8)
    with pytest.raises(RuntimeError):
        L.flash_attention(_t(q), _t(q), _t(q), _t(pos), _t(pos), 0,
                          q_chunk=8, kv_chunk=8)


def _cache_np(rng, c, b=2, n_kv=2, hd=8, filled=0):
    pos = np.zeros(c, np.int32)
    valid = np.zeros(c, bool)
    pos[:filled] = np.arange(filled)
    valid[:filled] = True
    return {"k": _f(rng, b, n_kv, c, hd), "v": _f(rng, b, n_kv, c, hd),
            "pos": pos, "valid": valid}


@pytest.mark.parametrize("select_write", [False, True])
@pytest.mark.parametrize("window,c,pos0,filled", [
    (0, 8, 5, 5),        # the next free slot
    (0, 8, 11, 8),       # a wrapped ring: slot 3 overwritten
    (6, 6, 20, 6),       # SWA, window == C, wrapped many times
    (0, 8, 0, 0),        # an empty cache
])
def test_attention_fwd_decode_writes_and_attends(select_write, window, c,
                                                 pos0, filled):
    rng = _rng(5)
    p = _attn_params(rng)
    x = _f(rng, 2, 1, 32)
    cache = _cache_np(rng, c, filled=filled)
    pos = np.array([pos0], np.int32)
    got, gc = L.attention_fwd(_tree(p, _t), _t(x), _t(pos), window=window,
                              cache=_tree(cache, _t),
                              select_write=select_write, **ATTN)
    want, wc = jit(JL.attention_fwd, window=window,
                   select_write=select_write, **ATTN)(
        _tree(p, _j), _j(x), _j(pos), cache=_tree(cache, _j))
    close(got, want)
    for k in ("k", "v"):
        close(gc[k], wc[k])
    for k in ("pos", "valid"):
        np.testing.assert_array_equal(_np(gc[k]), _np(wc[k]))


def test_attention_fwd_slice_write_clamps_its_start():
    """S = 3 tokens at slot 6 of C = 8: ``dynamic_update_slice`` starts the
    write at C - S = 5, and ``valid`` marks slot 6 alone."""
    rng = _rng(6)
    p = _attn_params(rng)
    x = _f(rng, 2, 3, 32)
    cache = _cache_np(rng, 8, filled=3)
    pos = np.array([14, 15, 16], np.int32)
    got, gc = L.attention_fwd(_tree(p, _t), _t(x), _t(pos), cache=_tree(
        cache, _t), **ATTN)
    want, wc = jit(JL.attention_fwd, **ATTN)(_tree(p, _j), _j(x), _j(pos),
                                             cache=_tree(cache, _j))
    close(got, want)
    np.testing.assert_array_equal(_np(gc["pos"]), _np(wc["pos"]))
    np.testing.assert_array_equal(_np(gc["valid"]), _np(wc["valid"]))
    assert _np(gc["pos"])[5:].tolist() == [14, 15, 16]
    assert _np(gc["valid"]).tolist() == [True] * 3 + [False] * 3 + [True,
                                                                    False]
    close(gc["k"], wc["k"])


@pytest.mark.parametrize("window", [0, 7])
def test_attention_fwd_full_sequence(window):
    rng = _rng(7)
    p = _attn_params(rng)
    x = _f(rng, 2, 16, 32)
    pos = np.arange(16, dtype=np.int32)
    got, gc = L.attention_fwd(_tree(p, _t), _t(x), _t(pos), window=window,
                              **ATTN)
    want, _ = jit(JL.attention_fwd, window=window, **ATTN)(
        _tree(p, _j), _j(x), _j(pos))
    assert gc is None
    close(got, want)


def test_attention_fwd_bf16():
    """bf16 params, activations and cache: the f32 score and value sums
    (``preferred_element_type``) are taken from f32 casts of both
    operands, so only the bf16 roundings of the projections differ."""
    rng = _rng(8)
    p = _attn_params(rng)
    x = _f(rng, 2, 1, 32)
    cache = _cache_np(rng, 8, filled=6)
    pos = np.array([6], np.int32)
    got, gc = L.attention_fwd(_tree(p, lambda a: _t(a, torch.bfloat16)),
                              _t(x, torch.bfloat16), _t(pos),
                              cache=_tree(cache, lambda a: _t(a).to(
                                  torch.bfloat16) if a.dtype == np.float32
                                  else _t(a)), **ATTN)
    want, wc = jit(JL.attention_fwd, **ATTN)(
        _tree(p, lambda a: _j(a, jnp.bfloat16)), _j(x, jnp.bfloat16),
        _j(pos), cache=_tree(cache, lambda a: _j(a, jnp.bfloat16)
                             if a.dtype == np.float32 else _j(a)))
    assert got.dtype == torch.bfloat16 and gc["k"].dtype == torch.bfloat16
    close(got, want, dict(atol=2 ** -6, rtol=2 ** -6))
    close(gc["k"], wc["k"], dict(atol=2 ** -6, rtol=2 ** -6))


def test_sharded_cache_attention_at_mesh_size_one():
    """The local body with -inf masking against the reference's
    ``shard_map`` on a 1 x 1 mesh, masked slots and a window included."""
    rng = _rng(9)
    q, kk, vv = _f(rng, 2, 4, 1, 8), _f(rng, 2, 4, 8, 8), _f(rng, 2, 4, 8, 8)
    kpos = np.array([8, 9, 2, 3, 4, 5, 6, 7], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    for window in (0, 4):
        w = np.array([window], np.int32)
        got = L.sharded_cache_attention(make_host_mesh("cpu"), ("data",))(
            _t(q), _t(kk), _t(vv), _t(kpos), _t(valid), _t(np.int32(9)),
            _t(w))
        want = jax.jit(JL.sharded_cache_attention(j_host_mesh(),
                                                  ("data",)))(
            _j(q), _j(kk), _j(vv), _j(kpos), _j(valid), _j(np.int32(9)),
            _j(w))
        close(got, want)


def test_a_mesh_of_more_than_one_device_raises():
    cpu = torch.device("cpu")
    mesh = Mesh(("data", "model"), (1, 2), (cpu, cpu))
    with pytest.raises(NotImplementedError, match="unverified"):
        L.sharded_cache_attention(mesh, ("data",))
    with pytest.raises(NotImplementedError, match="unverified"):
        lm.build_forward(configs.reduced("glm4-9b"), mesh=mesh)


def test_init_attention_cache():
    got = L.init_attention_cache(2, 3, 5, 8, torch.bfloat16, "cpu")
    want = JL.init_attention_cache(2, 3, 5, 8, jnp.bfloat16)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not _np(got[k]).any()


def _gen():
    return torch.Generator(
        "cuda" if torch.cuda.is_available() else "cpu").manual_seed(0)


f32 = torch.float32
_REDUCED = configs.reduced("jamba-1.5-large-398b")


@pytest.mark.parametrize("make", [
    lambda: L.init_rms(8, f32),
    lambda: L.init_attention(_gen(), 8, 2, 1, 4, f32),
    lambda: L.init_attention_cache(1, 1, 4, 4, f32),
    lambda: L.init_mlp(_gen(), 8, 12, f32),
    lambda: L.init_moe(_gen(), 8, 12, 4, f32),
    lambda: L.init_mamba(_gen(), 8, 4, 2, f32),
    lambda: L.init_rwkv(_gen(), 8, 2, f32),
    lambda: L.init_rwkv_mlp(_gen(), 8, 12, f32),
    lambda: lm.init_params(_REDUCED, 0, f32),
    lambda: lm.init_cache(_REDUCED, 1, 8, f32),
], ids=["init_rms", "init_attention", "init_attention_cache", "init_mlp",
        "init_moe", "init_mamba", "init_rwkv", "init_rwkv_mlp",
        "init_params", "init_cache"])
def test_initialisers_default_to_cuda(make):
    """No device means ``cuda``: on a machine without one the initialiser
    raises rather than put its tensors on the CPU."""
    if torch.cuda.is_available():
        leaves = lm.flatten(make()).values()
        assert all(x.device.type == "cuda" for x in leaves)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# --------------------------------------------------------------- FFNs --

def test_mlp_fwd():
    rng = _rng(10)
    p = {"w_gate": _f(rng, 32, 48, scale=0.2), "w_up": _f(rng, 32, 48,
                                                         scale=0.2),
         "w_down": _f(rng, 48, 32, scale=0.15)}
    x = _f(rng, 2, 5, 32)
    close(L.mlp_fwd(_tree(p, _t), _t(x)), jit(JL.mlp_fwd)(_tree(p, _j), _j(x)))


def _moe_params(rng, d=16, ff=24, e=4):
    return {"router": _f(rng, d, e, scale=d ** -0.5),
            "w_gate": _f(rng, e, d, ff, scale=d ** -0.5),
            "w_up": _f(rng, e, d, ff, scale=d ** -0.5),
            "w_down": _f(rng, e, ff, d, scale=ff ** -0.5)}


def test_moe_fwd_ragged_dot():
    rng = _rng(11)
    p = _moe_params(rng)
    x = _f(rng, 2, 9, 16)
    got, gaux = L.moe_fwd(_tree(p, _t), _t(x), top_k=2)
    want, waux = jit(JL.moe_fwd, top_k=2)(_tree(p, _j), _j(x))
    close(got, want)
    close(gaux, waux)


def test_top_k_takes_the_lower_index_first_on_ties():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4,
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    gv, gi = L.top_k_low_first(_t(probs), 2)
    wv, wi = jax.lax.top_k(_j(probs), 2)
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))
    np.testing.assert_array_equal(_np(gv), np.asarray(wv))


def _local_moe(cfg, xt, p, sequential=True):
    jfn = jlm._moe_block(cfg, None, ("data",), None, sequential=sequential)
    want = jax.jit(jfn)(_j(xt), *(_j(p[k]) for k in (
        "router", "w_gate", "w_up", "w_down")))
    drops: list = []
    pfn = lm._moe_block(cfg, None, drops=drops)
    got = pfn(_t(xt), *(_t(p[k]) for k in ("router", "w_gate", "w_up",
                                             "w_down")))
    return got, want, drops


def _moe_cfg(e=4):
    return dataclasses.replace(jconfigs.reduced("mixtral-8x22b"),
                               num_experts=e, experts_per_token=2)


def test_local_moe_drops_over_capacity():
    """A router that sends most tokens to expert 0: T = 40 tokens, cap =
    max(8, 40 * 2 * 1.25 // 4) = 25, so expert 0's assignments past 25
    drop, on both sides the same."""
    rng = _rng(12)
    p = _moe_params(rng)
    p["router"][:, 0] += 1.5
    xt = _f(rng, 40, 16) + 0.8
    cfg = _moe_cfg()
    (got, gaux), (want, waux), drops = _local_moe(cfg, xt, p)
    assert int(drops[0]) > 0
    assert lm.moe_capacity(40, 2, 4) == 25
    close(got, want)
    close(gaux, waux)
    # a dropped token's row lacks that expert's share
    assert (np.abs(_np(got)).sum(-1) > 0).all()


@pytest.mark.parametrize("sequential", [True, False])
def test_local_moe_chunks_past_16384_tokens(sequential):
    """T = 32768 tokens take two chunks of 16384, each with its own sort
    and capacity: the reference's chunk scan and its unrolled loop."""
    rng = _rng(13)
    p = _moe_params(rng, d=8, ff=8)
    xt = _f(rng, 32768, 8)
    cfg = _moe_cfg()
    (got, gaux), (want, waux), drops = _local_moe(cfg, xt, p, sequential)
    assert len(drops) == 2
    close(got, want)
    close(gaux, waux)


def test_local_moe_refuses_more_than_two_experts_a_token():
    cfg = dataclasses.replace(configs.reduced("mixtral-8x22b"),
                              experts_per_token=3)
    with pytest.raises(NotImplementedError, match="add_at_ordered"):
        lm._moe_block(cfg, None)


# ------------------------------------------------------ Mamba / RWKV --

def _mamba_params(rng, d=16, n=4, expand=2):
    di = expand * d
    return {"w_in": _f(rng, d, 2 * di, scale=d ** -0.5),
            "w_out": _f(rng, di, d, scale=di ** -0.5),
            "w_bcdt": _f(rng, di, 2 * n + 1, scale=di ** -0.5),
            "a_log": (np.log(np.arange(1, n + 1)) + _f(rng, di, n, scale=0.1)
                      ).astype(np.float32),
            "dt_bias": np.float32(0.1)}


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_fwd(with_state):
    rng = _rng(14)
    p = _mamba_params(rng)
    x = _f(rng, 2, 6, 16)
    st = _f(rng, 2, 32, 4) if with_state else None
    got, gh = L.mamba_fwd(_tree(p, _t), _t(x),
                          None if st is None else _t(st))
    want, wh = jit(JL.mamba_fwd)(_tree(p, _j), _j(x),
                                 None if st is None else _j(st))
    close(got, want)
    close(gh, wh)


def _rwkv_params(rng, d=16, heads=2):
    hd = d // heads
    p = {k: _f(rng, d, d, scale=d ** -0.5)
         for k in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_decay")}
    p.update(decay_bias=rng.uniform(-7, -5, d).astype(np.float32),
             bonus=_f(rng, heads, hd, scale=0.1),
             mix=rng.uniform(0.1, 0.9, (5, d)).astype(np.float32))
    return p


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_fwd(with_state):
    rng = _rng(15)
    p = _rwkv_params(rng)
    x = _f(rng, 2, 5, 16)
    st = ({"wkv": _f(rng, 2, 2, 8, 8), "prev": _f(rng, 2, 16)}
          if with_state else None)
    got, gs = L.rwkv_fwd(_tree(p, _t), _t(x),
                         None if st is None else _tree(st, _t), n_heads=2)
    want, ws = jit(JL.rwkv_fwd, n_heads=2)(
        _tree(p, _j), _j(x), None if st is None else _tree(st, _j))
    close(got, want)
    close(gs["wkv"], ws["wkv"])
    close(gs["prev"], ws["prev"])


@pytest.mark.parametrize("with_prev", [False, True])
def test_rwkv_mlp_fwd(with_prev):
    rng = _rng(16)
    p = {"w_k": _f(rng, 16, 24, scale=0.25), "w_v": _f(rng, 24, 16,
                                                       scale=0.2),
         "w_r": _f(rng, 16, 16, scale=0.25),
         "mix": rng.uniform(0.1, 0.9, (2, 16)).astype(np.float32)}
    x = _f(rng, 2, 4, 16)
    prev = _f(rng, 2, 16) if with_prev else None
    got, gp = L.rwkv_mlp_fwd(_tree(p, _t), _t(x),
                             None if prev is None else _t(prev))
    want, wp = jit(JL.rwkv_mlp_fwd)(_tree(p, _j), _j(x),
                                    None if prev is None else _j(prev))
    close(got, want)
    close(gp, wp)


# --------------------------------------------------------------- init --

def _shapes_of(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in lm.flatten(tree).items()}


def _jshapes_of(tree):
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in lm.flatten(tree).items()}


@pytest.mark.parametrize("name,args", [
    ("attention", (32, 4, 2, 8)), ("mlp", (32, 48)), ("moe", (32, 48, 4)),
    ("mamba", (16, 4, 2)), ("rwkv", (16, 2)), ("rwkv_mlp", (16, 24)),
])
def test_init_functions_give_the_references_shapes_and_dtypes(name, args):
    gen = torch.Generator().manual_seed(0)
    got = getattr(L, f"init_{name}")(gen, *args, torch.bfloat16, "cpu")
    want = jax.eval_shape(lambda k: getattr(JL, f"init_{name}")(
        k, *args, jnp.bfloat16), jax.random.PRNGKey(0))
    assert _shapes_of(got) == _jshapes_of(want)
