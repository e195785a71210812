"""The port's substrate (``repro_torch.ckpt``, ``data``, ``distributed.
compression``, ``train.trainer``) against the reference's, on the CPU:
the twins of ``tests/test_substrate.py`` and the cross-package checks.

* Checkpoints: round trip, the ``latest`` pointer and atomicity, async
  overlap, elastic restore onto another device; a checkpoint written by
  the JAX package restores in the port bitwise and the reverse, and an
  LM trainer tree (params + AdamW state) writes the same manifest from
  both packages.
* Data: the port's pipeline is bitwise the reference's; host slices
  tile the global batch.
* Compression: the quantize property test under hypothesis, bitwise
  against JAX (q, scales, dequantized); error feedback; ``compress_tree``
  bitwise against JAX.
* Trainer: the checkpoint / restart drill with the port's deterministic
  outcome pinned (the 7th call fails, the run resumes at step 6, its
  history is steps 1-10 exactly), and ``AsyncCheckpointer.wait``
  re-raising a writer's error.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
pytest.importorskip("zstandard", reason="checkpoint IO needs zstandard")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.ckpt import checkpointing as jckpt  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.ckpt import checkpointing as ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa

torch.set_num_threads(1)


def _tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((32, 16), generator=g),
            "nested": {"b": torch.randn((8,), generator=g),
                       "h": torch.randn((3, 4), generator=g).to(
                           torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _same(a, b) -> None:
    for (path, x), y in zip(T.leaves_with_paths(a), T.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 42, tree)
    assert ckpt.latest_step(str(tmp_path)) == 42
    _same(tree, ckpt.restore(str(tmp_path), 42, tree))


def test_checkpoint_latest_pointer_and_atomicity(tmp_path):
    tree = _tree(1)
    ckpt.save(str(tmp_path), 1, tree)
    tree2 = T.map(lambda x: x + 1 if x.dtype != torch.int32 else x, tree)
    ckpt.save(str(tmp_path), 2, tree2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    # a stale tmp dir never corrupts restores
    os.makedirs(os.path.join(str(tmp_path), "step_00000003.tmp"),
                exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 2
    r = ckpt.restore(str(tmp_path), 2, tree)
    assert torch.equal(r["a"], tree2["a"])


def test_async_checkpointer_overlap(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree(2)
    c.save(5, tree)
    c.save(6, tree)  # joins the previous write first
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_async_checkpointer_wait_reraises_a_writer_error(tmp_path):
    """A re-save of a published step (the reference's resume race) fails
    in the writer thread; ``wait`` hands the error to the caller."""
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree(3)
    c.save(6, tree)
    c.wait()
    c.save(6, tree)
    with pytest.raises(OSError):
        c.wait()
    c.wait()                          # handed over once
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_elastic_restore_onto_another_device(tmp_path):
    """The device comes from ``shardings``, not from the target tree (a
    tree of meta tensors here) nor from the writer."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "s": {"x": torch.ones((2,), dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path), 0, tree)
    target = T.map(lambda x: torch.empty_like(x, device="meta"), tree)
    for sh in ("cpu", torch.device("cpu"), {"w": "cpu", "s": "cpu"},
               {"w": "cpu", "s": {"x": torch.device("cpu")}}):
        r = ckpt.restore(str(tmp_path), 0, target, sh)
        assert all(x.device.type == "cpu" for x in T.leaves(r))
        _same(tree, r)


@pytest.mark.cuda
def test_restore_onto_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tree = _tree(4)
    ckpt.save(str(tmp_path), 3, tree)
    r = ckpt.restore(str(tmp_path), 3, tree, torch.device("cuda"))
    assert all(x.device.type == "cuda" for x in T.leaves(r))
    _same(tree, T.map(lambda x: x.cpu(), r))


def _jax_tree(tree):
    def one(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return T.map(one, tree)


def _as_np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_a_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    tree = _tree(5)
    jtree = _jax_tree(tree)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), pdir.mkdir()
    jckpt.save(str(jdir), 9, jtree)
    _same(tree, ckpt.restore(str(jdir), 9, tree))
    ckpt.save(str(pdir), 9, tree)
    back = jckpt.restore(str(pdir), 9, jtree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_as_np(a), _as_np(b))
    # the manifests agree leaf by leaf
    man = [json.load(open(d / "step_00000009" / "manifest.json"))
           for d in (jdir, pdir)]
    assert man[0] == man[1]


def test_an_lm_trainer_tree_writes_the_references_manifest(tmp_path):
    """``{"params", "opt"}`` of a reduced arch (bf16 params, f32 AdamW
    state): the port's leaf paths, shapes and dtypes are JAX's."""
    from repro.models import lm as jlm
    from repro.train.optimizer import AdamWConfig as JAdamW
    from repro.train.optimizer import init_opt_state as jinit
    cfg = configs.reduced("mixtral-8x22b", seq=16)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    jtree = {"params": jp, "opt": jinit(jp, JAdamW())}
    params = convert.lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in lm.flatten(jp).items()}, "cpu")
    tree = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), pdir.mkdir()
    jckpt.save(str(jdir), 1, jtree)
    ckpt.save(str(pdir), 1, tree)
    man = [json.load(open(d / "step_00000001" / "manifest.json"))
           for d in (jdir, pdir)]
    assert man[0] == man[1]
    assert "params/blocks/pos0/ffn/w_gate" in [x["path"]
                                               for x in man[1]["leaves"]]
    _same(tree, ckpt.restore(str(jdir), 1, tree))
    # the opt-state converters take the same paths
    back = convert.lm_opt_state_to_numpy(tree["opt"])
    assert sorted(back) == sorted(
        x["path"][4:] for x in man[1]["leaves"] if x["path"][:4] == "opt/")


# ------------------------------------------------------------------ data
def test_data_is_the_references_bitwise_and_slices_by_host():
    jcfg = jpipe.DataConfig(vocab_size=512, seq_len=64, global_batch=8)
    cfg = DataConfig(vocab_size=512, seq_len=64, global_batch=8)
    d1, d2, ref = SyntheticTokens(cfg), SyntheticTokens(cfg), \
        jpipe.SyntheticTokens(jcfg)
    for step in (0, 13):
        b1, b2, w = d1.global_batch(step), d2.global_batch(step), \
            ref.global_batch(step)
        for k in ("inputs", "labels"):
            assert b1[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(b1[k], w[k])
            np.testing.assert_array_equal(b1[k], b2[k])
    b1 = d1.global_batch(13)
    assert not np.array_equal(b1["inputs"], d1.global_batch(14)["inputs"])
    h0, h1 = d1.host_batch(13, 0, 2), d1.host_batch(13, 1, 2)
    np.testing.assert_array_equal(
        np.concatenate([h0["inputs"], h1["inputs"]]), b1["inputs"])
    for i in range(4):
        np.testing.assert_array_equal(d1.host_batch(13, i, 4)["labels"],
                                      ref.host_batch(13, i, 4)["labels"])
    # labels are inputs shifted by one
    np.testing.assert_array_equal(b1["inputs"][:, 1:], b1["labels"][:, :-1])


# ----------------------------------------------------------- compression
@given(st.integers(1, 2000), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_quantize_roundtrip_bounded_error_and_bitwise(n, seed):
    rng = np.random.default_rng(seed)
    g_np = rng.normal(0, 3, n).astype(np.float32)
    g = torch.as_tensor(g_np)
    q, s = comp.quantize(g)
    deq = comp.dequantize(q, s, g.shape, g.dtype)
    jq, js = jcomp.quantize(jnp.asarray(g_np))
    jdeq = jcomp.dequantize(jq, js, g_np.shape, jnp.float32)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    blocks, _ = comp._pad_to_block(g)
    maxabs = blocks.abs().amax(dim=1).numpy()
    err = np.abs((deq - g).numpy())
    bidx = np.arange(n) // comp.BLOCK
    assert (err <= maxabs[bidx] / 127.0 * 0.5001 + 1e-7).all()


def test_error_feedback_accumulates():
    g = {"w": torch.tensor([0.3, -0.2, 0.7, 1.4])}
    qt, err = comp.compress_tree(g, None)
    deq = comp.decompress_tree(qt, g)
    resid = g["w"] - deq["w"]
    np.testing.assert_allclose(err["w"].numpy(), resid.numpy(), atol=1e-7)
    big = {"w": torch.ones((4096,))}
    assert comp.compressed_bytes(big) < 4 * 4096 / 3.5
    assert comp.compressed_bytes(big) == jcomp.compressed_bytes(
        {"w": jnp.ones((4096,))})


def test_compress_tree_is_the_references_bitwise():
    rng = np.random.default_rng(11)
    grads = {"b": rng.normal(0, 2, (300, 7)).astype(np.float32),
             "a": {"x": rng.normal(0, 1e-3, (513,)).astype(np.float32)}}
    err0 = T.map(lambda a: (1e-2 * rng.standard_normal(a.shape))
                 .astype(np.float32), grads)
    tg, te = T.map(torch.as_tensor, grads), T.map(torch.as_tensor, err0)
    jg, je = T.map(jnp.asarray, grads), T.map(jnp.asarray, err0)
    for terr, jerr in ((None, None), (te, je)):
        (qt, et), (jqt, jet) = comp.compress_tree(tg, terr), \
            jcomp.compress_tree(jg, jerr)
        for got, want in ((qt, jqt), (et, jet)):
            for (path, a), b in zip(T.leaves_with_paths(got),
                                    T.leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=str(path))
        back = comp.decompress_tree(qt, tg)
        jback = jcomp.decompress_tree(jqt, jg)
        np.testing.assert_array_equal(back["a"]["x"].numpy(),
                                      np.asarray(jback["a"]["x"]))


# ---------------------------------------------------------------- trainer
def test_trainer_resumes_after_failure_at_the_last_checkpoint(tmp_path):
    """A poisoned step triggers restore-from-checkpoint, then the run
    completes. The port joins the write in flight before it reads
    ``latest``, so the drill's outcome is fixed: the 7th call fails at
    step 6, the run resumes from step 6 and replays nothing."""
    from repro_torch.train.trainer import Trainer, TrainerConfig

    for i in range(3):                 # the same outcome every time
        run = tmp_path / f"run{i}"
        calls = {"n": 0}

        def train_step(params, opt, batch):
            calls["n"] += 1
            if calls["n"] == 7:  # simulated node failure mid-run
                raise RuntimeError("injected failure")
            p = {"w": params["w"] + 1.0}
            return p, opt, {"loss": torch.tensor(1.0 / calls["n"]),
                            "grad_norm": torch.tensor(1.0)}

        tr = Trainer(TrainerConfig(total_steps=10, ckpt_every=2,
                                   log_every=100, ckpt_dir=str(run)),
                     train_step, lambda s: {"x": np.zeros(1)},
                     {"w": torch.zeros(())},
                     {"step": torch.tensor(0, dtype=torch.int32)})
        hist = tr.run()
        assert tr.state.step == 10 and tr.state.failures == 1
        assert [h["step"] for h in hist] == list(range(1, 11))
        # calls 1-6 are steps 1-6, call 7 failed, calls 8-11 steps 7-10
        assert [h["loss"] for h in hist] == pytest.approx(
            [1 / n for n in (1, 2, 3, 4, 5, 6, 8, 9, 10, 11)])
        assert float(tr.params["w"]) == 10.0
        assert ckpt.latest_step(str(run)) == 10


def test_trainer_surfaces_a_lost_checkpoint(tmp_path):
    """A checkpoint write that fails is not dropped: the next save (or
    the end of the run) raises it."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    os.makedirs(tmp_path / "step_00000002" / "taken")

    def train_step(params, opt, batch):
        return params, opt, {"loss": torch.tensor(1.0),
                             "grad_norm": torch.tensor(1.0)}

    tr = Trainer(TrainerConfig(total_steps=3, ckpt_every=2, log_every=100,
                               ckpt_dir=str(tmp_path)),
                 train_step, lambda s: {}, {"w": torch.zeros(())}, {})
    with pytest.raises(OSError):
        tr.run()
