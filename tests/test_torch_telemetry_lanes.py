"""The port's telemetry lanes against the reference package on the CPU,
bitwise (helpers: ``test_torch_telemetry.py``): the channel-gating,
idle-lane and shared-scenario twins of ``tests/test_telemetry.py``; the
link layer's telemetry test (``tests/test_link_layer.py``) and the CBFC
stall channel; the EWMA against the reference's jitted ``make_update``
where it reaches the subnormal range (the compiled reference flushes it
to zero); the probe's largest temporary against one [Q, Q] plane; and
the host-side report (summary, window rates, Chrome-trace export)
against the reference's on the same lanes.
"""
import collections
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.network import fabric as jf
from repro.network import telemetry as jtel
from repro.network import workloads as jw
from repro_torch.network import fabric as tf
from repro_torch.network import telemetry as tt
from repro_torch.network import workloads as tw
from repro_torch.network.telemetry import TelemetrySpec
from test_torch_batch import _same_state, assert_same_results
from test_torch_faults import jprofile
from test_torch_telemetry import (_capture, _small_flap, assert_same_lanes,
                                  jspec, run_both)

torch.set_num_threads(1)


# ------------------------------------------------------------------------
# channel gating + idle lanes
# ------------------------------------------------------------------------

def test_disabled_channel_groups_carry_no_lanes(monkeypatch):
    tr = run_both(monkeypatch, TelemetrySpec.on(queues=False,
                                                gauges=False)).telemetry
    assert tr.occ.shape[1] == 0 and tr.ecn.shape[1] == 0
    assert tr.inflight is None and tr.delivered is None
    assert tr.rtt.shape[1] > 0, "flow channels stay on"
    with pytest.raises(ValueError, match="queue channels"):
        tr.window_rates(0, 100)


def test_idle_lane_rings_are_all_zero(monkeypatch):
    """A zero-size lane (the shard padding) never injects: its rings are
    identically zero, in both packages, and its busy neighbour is
    unaffected."""
    (g, wl, _), (jg, jwl, _), prof, params = _small_flap()
    F = int(wl.src.shape[0])
    idle = tf.take_lane(tw.noop_scenarios(F, 1), 0)
    jidle = jax.tree_util.tree_map(lambda a: a[0], jw.noop_scenarios(F, 1))
    spec = TelemetrySpec.on()
    carries = _capture(monkeypatch)
    rs = tf.simulate_batch(g, [wl, idle], prof, tf.SimParams(**params),
                           telemetry=spec, device="cpu")
    js = jf.simulate_batch(jg, jf.Workload.stack([jwl, jidle]),
                           jprofile(prof), jf.SimParams(**params),
                           telemetry=jspec(spec))
    assert_same_results(rs, js)
    for b in range(2):
        assert_same_lanes(rs[b].telemetry.lanes, carries[b], f"lane {b}")
    tr = rs[1].telemetry
    for f in ("occ", "ecn", "trim", "drop", "rtt"):
        assert (np.asarray(getattr(tr, f)) == 0).all(), f
    assert (tr.inflight == 0).all() and (tr.delivered == 0).all()
    assert int(rs[1].state.delivered.sum()) == 0
    assert (np.asarray(rs[0].telemetry.ecn) != 0).any()


# ------------------------------------------------------------------------
# the shared victim-share definition and the canary scenario
# ------------------------------------------------------------------------

def test_victim_sweep_is_the_shared_definition():
    g, wl, exp = tw.victim_sweep(pairs=6, uplinks=2, size=500)
    assert exp["victim_flow"] == 6
    assert len(exp["uplinks"]) == 2
    assert wl.src.shape[0] == 7
    ga, wls, profiles, names, exp_a = tw.profile_ablation_sweep(
        pairs=6, uplinks=2, size=500)
    assert exp_a["victim_flow"] == exp["victim_flow"]
    assert exp_a["uplinks"] == exp["uplinks"]
    for i in range(len(profiles)):
        np.testing.assert_array_equal(wls.src[i].numpy(), wl.src.numpy())
        np.testing.assert_array_equal(wls.size[i].numpy(), wl.size.numpy())
    port = tt.flap_victim_scenario()
    ref = jtel.flap_victim_scenario()
    g2, wl2, prof, p, sched, spec, (fail_at, heal_at) = port
    assert spec.enabled and fail_at < heal_at <= p.ticks
    assert sched.num_queues == g2.num_queues
    # the same scenario as the reference's canary, field by field
    assert (fail_at, heal_at) == ref[6] and dataclasses.asdict(p) == \
        dataclasses.asdict(ref[3])
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref[5])
    assert jprofile(prof) == ref[2]
    for f in ("src", "dst", "size", "start", "dep"):
        np.testing.assert_array_equal(getattr(wl2, f).numpy(),
                                      np.asarray(getattr(ref[1], f)))
    for f in ("fail_at", "heal_at", "loss_p", "corrupt_p"):
        np.testing.assert_array_equal(getattr(sched, f).numpy(),
                                      np.asarray(getattr(ref[4], f)))


# ------------------------------------------------------------------------
# the link-layer channels (tests/test_link_layer.py's telemetry test)
# ------------------------------------------------------------------------

def test_telemetry_llr_channel_mirrors_the_replay_scalar(monkeypatch):
    (g, wls, scheds, exp) = tw.corruption_sweep(bers=(0.04,), size=120,
                                                budget=600)
    (jg, jwls, jscheds, jexp) = jw.corruption_sweep(bers=(0.04,), size=120,
                                                    budget=600)
    wl = tf.take_lane(wls, 0)
    sched = scheds.lanes(torch.tensor([0]))
    prof, p, link = exp["profile"], exp["params"], exp["link"]
    spec = TelemetrySpec.on()
    carries = _capture(monkeypatch)
    r = tf.simulate_batch(g, tf.Workload.stack([wl]), prof, p, faults=sched,
                          link=link, telemetry=spec, device="cpu")[0]
    j = jf.simulate_batch(jg, jax.tree_util.tree_map(lambda a: a[:1], jwls),
                          jexp["profile"], jexp["params"],
                          faults=jax.tree_util.tree_map(lambda a: a[:1],
                                                        jscheds),
                          link=jexp["link"], telemetry=jspec(spec))[0]
    assert_same_results([r], [j])
    assert_same_lanes(r.telemetry.lanes, carries[0])
    bare = tf.simulate_batch(g, tf.Workload.stack([wl]), prof, p,
                             faults=sched, link=link, device="cpu")[0]
    _same_state(r.state, bare.state)
    tr = r.telemetry
    llr_q = tr.final["llr_q"]
    assert int(llr_q.sum()) == r.llr_replays > 0
    hot = set(np.nonzero(llr_q)[0].tolist())
    assert hot <= set(exp["uplinks"]), (hot, exp["uplinks"])
    assert int(tr.llr[-1].sum()) == int(llr_q.sum())
    assert int(tr.final["stall_q"].sum()) == 0


def test_cbfc_stall_channel_counts_at_the_target_queue(monkeypatch):
    """Under LLR + CBFC the stall channel counts each back-pressured
    enqueue at its target queue, bitwise the reference's dense count."""
    g, wls, scheds, exp = tw.corruption_sweep(bers=(0.0, 0.08), size=120,
                                              budget=600)
    jg, jwls, jscheds, jexp = jw.corruption_sweep(bers=(0.0, 0.08),
                                                  size=120, budget=600)
    spec = TelemetrySpec.on(probe_every=8, slots=16)
    carries = _capture(monkeypatch)
    rs = tf.simulate_batch(g, wls, exp["profile"], exp["params"],
                           faults=scheds, link=exp["cbfc"], telemetry=spec,
                           device="cpu")
    js = jf.simulate_batch(jg, jwls, jexp["profile"], jexp["params"],
                           faults=jscheds, link=jexp["cbfc"],
                           telemetry=jspec(spec))
    assert_same_results(rs, js)
    for b, r in enumerate(rs):
        assert_same_lanes(r.telemetry.lanes, carries[b], f"lane {b}")
    assert any(int(r.telemetry.final["stall_q"].sum()) for r in rs)
    assert int(rs[1].telemetry.final["llr_q"].sum()) == rs[1].llr_replays > 0


# ------------------------------------------------------------------------
# the pieces on their own
# ------------------------------------------------------------------------

def test_ewma_matches_the_jitted_reference_into_the_subnormal_range():
    """The f32 EWMA lane against the reference's jitted ``make_update``
    over 1000 ticks of random occupancy that drains to zero after tick
    100: at ``ewma_shift`` 3 the values pass through the range where the
    compiled reference flushes subnormal results to zero; 0 and 16 are
    the edges of the shift's range."""
    rng = np.random.default_rng(19)
    B, Q, F = 3, 64, 4
    for shift in (0, 3, 16):
        spec = TelemetrySpec.on(probe_every=4, slots=8, ewma_shift=shift)
        up = tt.make_update(spec, Q, F, "cpu")
        jup = jax.jit(jax.vmap(jtel.make_update(jspec(spec), Q, F),
                               in_axes=(0, 0, 0, None)))
        tel = tt.create(spec, B, Q, F, "cpu")
        jt = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape),
            jtel.create(jspec(spec), Q, F))
        for tick in range(1000):
            busy = tick < 100
            q = rng.integers(0, 40 if busy else 1, (B, Q)).astype(np.int32)
            probe = {"rtt": rng.uniform(1, 90, (B, F)).astype(np.float32),
                     "has_rtt": rng.random((B, F)) < 0.3,
                     "cwnd": rng.uniform(1, 48, (B, F)).astype(np.float32)}
            cnt = rng.integers(0, 3, (B, 5, Q)).astype(np.int32)
            s = _Lanes(q_len=torch.as_tensor(q),
                       inflight=torch.as_tensor(q[:, :F]),
                       ticks_degraded=torch.full((B,), tick, dtype=torch.int32),
                       delivered=torch.as_tensor(q[:, -F:]))
            tel = up(tel, s, {"cnt": torch.as_tensor(cnt),
                              **{k: torch.as_tensor(v)
                                 for k, v in probe.items()}}, tick)
            jprobe = {**{k: jnp.asarray(v) for k, v in probe.items()},
                      **{k: jnp.asarray(cnt[:, c])
                         for c, k in enumerate(("mark", "trim", "drop",
                                                "llr", "stall"))}}
            jt = jup(jt, _Lanes(q_len=jnp.asarray(q),
                                inflight=jnp.asarray(q[:, :F]),
                                ticks_degraded=jnp.full((B,), tick,
                                                        jnp.int32),
                                delivered=jnp.asarray(q[:, -F:])),
                     jprobe, jnp.int32(tick))
        for b in range(B):
            assert_same_lanes(tt.lanes(spec, Q, F,
                                       {k: v[b] for k, v in tel.items()}),
                              {k: np.asarray(v[b]) for k, v in jt.items()},
                              f"shift {shift} lane {b}")
        ewma = tel["ewma_q"].numpy()
        if shift == 3:
            # the drained queues reached exactly zero through the flush
            assert (ewma == 0).all()
        assert not ((ewma != 0) & (np.abs(ewma) < 2.0 ** -126)).any()


#: the state lanes the probe update reads (a pytree for the reference)
_Lanes = collections.namedtuple("_Lanes", "q_len inflight ticks_degraded "
                                "delivered")


def test_probe_has_no_quadratic_temporary():
    """Every tensor the probe's event count makes is smaller than one
    [Q, Q] plane (the reference's ``hot_cand`` is [Q, Q + F] per
    channel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    Largest.numel = max(Largest.numel, o.numel())
            return out

    rng = np.random.default_rng(3)
    B, Q, F = 2, 512, 512
    n = Q + F
    target = torch.as_tensor(rng.integers(0, Q, (B, n)))
    kind = rng.integers(0, 4, (B, n))
    lanes = {k: torch.as_tensor(kind == i)
             for i, k in enumerate(("trim_ev", "drop_ev", "stall"), 1)}
    mark, hit = (torch.as_tensor(rng.random((B, Q)) < 0.2) for _ in range(2))
    rows = tt.event_rows(B, Q, n, "cpu")
    with Largest():
        cnt = tt.queue_events(rows, Q, mark, target, tx_drop=hit, llr=hit,
                              **lanes)
    assert 0 < Largest.numel < Q * Q, Largest.numel
    assert rows[1].numel() < Q * Q
    # and the counts are the dense per-queue sums
    hot = target.numpy()[:, None, :] == np.arange(Q)[None, :, None]
    want = np.stack([mark.numpy()] + [
        (hot & lanes[k].numpy()[:, None, :]).sum(-1)
        for k in ("trim_ev", "drop_ev")] + [hit.numpy(), (
            hot & lanes["stall"].numpy()[:, None, :]).sum(-1)], axis=1)
    want[:, tt.DROP] += hit.numpy()
    np.testing.assert_array_equal(cnt.numpy(), want)


def test_report_matches_the_reference_on_the_same_lanes(monkeypatch,
                                                         tmp_path):
    """``summary``, ``window_rates`` and the Chrome-trace export of the
    port's FabricTrace equal the reference's on the same run."""
    (g, wl, sched), (jg, jwl, jsched), prof, params = _small_flap()
    r = tf.simulate(g, wl, prof, tf.SimParams(**params), faults=sched,
                    telemetry=TelemetrySpec.on(slots=16), device="cpu")
    ref = jtel.FabricTrace.from_lanes(jspec(r.telemetry.spec),
                                      r.telemetry.lanes, r.horizon)
    tr = r.telemetry
    assert tr.summary() == ref.summary()
    for w in ((0, 300), (200, 700), (650, 960)):
        got, want = tr.window_rates(*w), ref.window_rates(*w)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.to_chrome_trace("x") == ref.to_chrome_trace("x")
    path = tr.save_chrome_trace(str(tmp_path / "t.json"))
    assert os.path.getsize(path) > 0
