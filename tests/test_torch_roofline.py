"""The roofline's collective pieces (``repro_torch.launch.roofline``) and
the sharding rules (``repro_torch.distributed.sharding``) against the
reference's, on the CPU.

* ``uet_efficiencies`` ``==`` the reference's at a small size (two
  kinds, 8 packets a rank, 8 hosts), and its ``simulate_batch`` call
  form; ``ring_time`` and ``kind_sizes_from_reports`` ``==``.
* Every spec function (``param_pspecs`` and its ``tp_only`` /
  ``dp_wide`` / ``decode_row`` / ``zero2`` variants, ``batch_pspec``
  and ``batch_pspec_dp_wide``, ``activation_pspec``, ``cache_pspecs``
  and ``cache_pspecs_decode_row``, ``attn_head_specs``, ``named``)
  against the reference's ``PartitionSpec``s over every arch's reduced
  tree, on host meshes of the production axis names: (data, model) at
  1 x 1 and 2 x 2, and (pod, data, model) at 1 x 2 x 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import roofline as jroof
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm

torch.set_num_threads(1)
CPU = "cpu"
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 2)),
          (("pod", "data", "model"), (1, 2, 2))]


def test_uet_efficiencies_equal_the_references():
    kinds = ["all-reduce", "all-gather", "total", "collective-permute"]
    got = roofline.uet_efficiencies(kinds, hosts=8, size_pkts=8,
                                    device=CPU)
    want = jroof.uet_efficiencies(kinds, hosts=8, size_pkts=8)
    assert set(got) == {"all-reduce", "all-gather"}
    assert got == want
    assert roofline.uet_efficiencies(["total"], device=CPU) == {}


def test_ring_time_and_kind_sizes_equal_the_references():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute", "other"):
        for chips in (1, 2, 16, 256):
            for b in (0.0, 4096.0, 3.7e9):
                assert roofline.ring_time(kind, b, chips) == \
                    jroof.ring_time(kind, b, chips)
    reps = [{"collectives": {"bytes": {"all-reduce": 3e9, "total": 9e9,
                                       "all-gather": 1000.0}}},
            {"collectives": {"bytes": {"all-reduce": 4e5,
                                       "all-to-all": 2.5e5,
                                       "collective-permute": 4097.0}}}]
    for kw in ({}, {"mtu": 1024, "max_pkts": 64, "min_pkts": 2}):
        assert roofline.kind_sizes_from_reports(reps, **kw) == \
            jroof.kind_sizes_from_reports(reps, **kw)


def _meshes(names, shape):
    n = int(np.prod(shape))
    jm = jax.make_mesh(shape, names, devices=jax.devices()[:n])
    return Mesh(names, shape, (torch.device(CPU),) * n), jm


def _specs(tree) -> dict:
    """{path: tuple} of a tree of specs (JAX's PartitionSpecs as
    tuples)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (tuple, jax.sharding.
                                               PartitionSpec)))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in p): tuple(v)
            for p, v in flat}


@pytest.mark.parametrize("names,shape", MESHES,
                         ids=["1x1", "2x2", "pod1x2x2"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_spec_rules_equal_the_references(arch, names, shape):
    mesh, jmesh = _meshes(names, shape)
    cfg, jcfg = configs.reduced(arch, seq=16), jconfigs.reduced(arch, seq=16)
    params = lm.init_params(cfg, dtype=torch.float32, device="meta")
    jparams = jax.eval_shape(lambda: jlm.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    assert shd.dp_axes(mesh) == jshd.dp_axes(jmesh)
    assert shd.tp_size(mesh) == jshd.tp_size(jmesh)
    for name in ("param_pspecs", "param_pspecs_tp_only",
                 "param_pspecs_dp_wide", "param_pspecs_decode_row",
                 "param_pspecs_zero2"):
        got = _specs(getattr(shd, name)(params, mesh))
        assert got == _specs(getattr(jshd, name)(jparams, jmesh)), name
    assert shd.activation_pspec(cfg, mesh) == tuple(
        jshd.activation_pspec(jcfg, jmesh))
    for decode in (False, True):
        got = shd.attn_head_specs(cfg, mesh, decode=decode)
        want = jshd.attn_head_specs(jcfg, jmesh, decode=decode)
        assert (got is None) == (want is None)
        if want is not None:
            assert got == tuple(tuple(s.spec) for s in want)
    cache = lm.init_cache(cfg, 2, 16, device="meta")
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 16))
    for shape_name in configs.SHAPES:
        sh, jsh = configs.SHAPES[shape_name], jconfigs.SHAPES[shape_name]
        for name in ("batch_pspec", "batch_pspec_dp_wide"):
            assert _specs(getattr(shd, name)(cfg, sh, mesh)) == _specs(
                getattr(jshd, name)(jcfg, jsh, jmesh)), (name, shape_name)
        for name in ("cache_pspecs", "cache_pspecs_decode_row"):
            got = _specs(getattr(shd, name)(cfg, sh, mesh, cache))
            want = _specs(getattr(jshd, name)(jcfg, jsh, jmesh, jcache))
            assert got == want, (name, shape_name)
    specs = shd.param_pspecs(params, mesh)
    assert shd.named(mesh, specs) is specs
    named = jshd.named(jmesh, jshd.param_pspecs(jparams, jmesh))
    assert _specs(jax.tree_util.tree_map(
        lambda s: s.spec, named,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))) \
        == _specs(specs)
