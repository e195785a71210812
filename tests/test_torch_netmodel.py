"""The port's collective network model against the reference's, on the
CPU — the twins of the netmodel tests of ``tests/test_collectives.py``.

The analytic forms are held with ``==`` over kinds, sizes and fabrics;
each simulated collective runs through both packages' simulator, and the
seconds (a completion tick times the MTU's serialization time) are ``==``
to the reference's before the reference test's own assertions run on
the port's numbers.
"""
from dataclasses import asdict

import pytest
import torch

from repro.distributed import netmodel as jnm
from repro_torch.distributed import netmodel
from repro_torch.distributed.netmodel import (FabricSpec,
                                              analytic_collective_time,
                                              analytic_time_for_spec,
                                              simulated_collective_time,
                                              simulated_efficiency)
from repro_torch.network.profile import TransportProfile

torch.set_num_threads(1)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "other")
FABRICS = (FabricSpec(), FabricSpec(link_gbps=200.0, links_per_chip=4,
                                    mtu=9000))


def _jfabric(fs: FabricSpec):
    return jnm.FabricSpec(**asdict(fs))


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_forms_equal_reference(kind):
    for fs in FABRICS:
        assert fs.tick_seconds == _jfabric(fs).tick_seconds
        for chips in (0, 1, 2, 8, 16):
            for b in (1.0, 4096.0, 3.7e9):
                assert analytic_collective_time(kind, b, chips, fs) \
                    == jnm.analytic_collective_time(kind, b, chips,
                                                    _jfabric(fs))
            assert analytic_time_for_spec(kind, 24, max(chips, 1), fs) \
                == jnm.analytic_time_for_spec(kind, 24, max(chips, 1),
                                              _jfabric(fs))
    hlo = {"all-reduce": 1e6, "all-gather": 2e6, kind: 5e5, "total": 9e9}
    for eff in (1.0, 0.5, 0.0):
        assert netmodel.collective_term_seconds(hlo, 8, efficiency=eff) \
            == jnm.collective_term_seconds(hlo, 8, efficiency=eff)


@pytest.mark.parametrize("chips,hosts_per_leaf,oversub",
                         [(8, 4, 1), (4, 4, 1), (9, 4, 2), (16, 4, 2)])
def test_collective_fabric_equals_reference(chips, hosts_per_leaf, oversub):
    g = netmodel._collective_fabric(chips, hosts_per_leaf, oversub)
    jg = jnm._collective_fabric(chips, hosts_per_leaf, oversub)
    assert (g.name, g.num_queues, g.num_hosts) \
        == (jg.name, jg.num_queues, jg.num_hosts)


@pytest.mark.parametrize("kind,algo", [("all-reduce", "ring"),
                                       ("all-reduce", "tree"),
                                       ("all-gather", "ring")])
def test_simulated_collective_time_ge_analytic(kind, algo):
    fs = FabricSpec()
    t_sim = simulated_collective_time(kind, chips=8, size_pkts=24,
                                      algo=algo, fabric=fs, device="cpu")
    assert t_sim == jnm.simulated_collective_time(
        kind, chips=8, size_pkts=24, algo=algo, fabric=_jfabric(fs))
    t_ana = analytic_time_for_spec(kind, 24, 8, fs)
    assert t_sim >= t_ana, (kind, algo, t_sim, t_ana)


def test_bytes_total_matches_size_pkts_denomination():
    fs = FabricSpec()
    n, s = 4, 8
    t_pkts = simulated_collective_time("all-gather", chips=n, size_pkts=s,
                                       fabric=fs, device="cpu")
    t_bytes = simulated_collective_time(
        "all-gather", bytes_total=n * n * s * fs.mtu, chips=n, fabric=fs,
        device="cpu")
    assert t_bytes == t_pkts
    assert t_pkts == jnm.simulated_collective_time(
        "all-gather", chips=n, size_pkts=s, fabric=_jfabric(fs))
    t_pkts = simulated_collective_time("all-reduce", chips=n, size_pkts=s,
                                       fabric=fs, device="cpu")
    t_bytes = simulated_collective_time(
        "all-reduce", bytes_total=n * s * fs.mtu, chips=n, fabric=fs,
        device="cpu")
    assert t_bytes == t_pkts
    with pytest.raises(ValueError, match="bytes_total or size_pkts"):
        simulated_collective_time("all-reduce", chips=n, device="cpu")


def test_simulated_collective_time_with_inc():
    """``inc=True`` on a profile without INC goes through the profile's
    own checks (``dataclasses.replace``) and prices the tree all-reduce
    as the reference does."""
    t = simulated_collective_time("all-reduce", chips=8, size_pkts=16,
                                  algo="tree", inc=True, device="cpu")
    assert t == jnm.simulated_collective_time("all-reduce", chips=8,
                                              size_pkts=16, algo="tree",
                                              inc=True)
    assert t < simulated_collective_time("all-reduce", chips=8,
                                         size_pkts=16, algo="tree",
                                         device="cpu")


def test_simulated_efficiency_in_unit_interval():
    eff = simulated_efficiency("all-reduce", hosts=4, size_pkts=16,
                               device="cpu")
    assert eff == jnm.simulated_efficiency("all-reduce", hosts=4,
                                           size_pkts=16)
    assert 0.0 < eff <= 1.0
    with pytest.raises(ValueError, match="either profile= or lb="):
        simulated_efficiency(profile=TransportProfile.ai_full(),
                             lb=TransportProfile.ai_full().lb, device="cpu")


def test_pattern_workload_proxy_removed():
    assert not hasattr(netmodel, "_pattern_workload")
