"""Traffic generator: an incast onto ``dests_per_pod`` destinations in
every pod, each fed by ``sources`` flows of ``packets`` packets from as
many distinct pods other than its own, all starting at tick 0.

Every host sources the same number of flows, ``dests_per_pod`` x
``sources`` / (hosts a pod): on the k = 16 tree with 16 destinations a
pod and 8 sources, each of the 1024 hosts sends 2 flows, F = 2048, and
each of the 256 destinations' downlinks is an 8:1 incast. The source pod
of a destination's t-th flow is its own pod plus an offset, the
(j + t)-th of a ring of the nonzero offsets drawn from ``rng`` (j: the
destination's rank in its pod), so a destination's sources lie in
distinct pods, every pod feeds as many flows as its hosts send, and no
host sends twice to one destination. Which hosts are destinations, the
ring, and which host of a pod feeds which destination are drawn from
``rng``.
"""
from __future__ import annotations

import numpy as np


def generate(rng: np.random.Generator, topo, mix: dict) -> dict:
    """{src, dst, size}: [F] int32 flow lanes, each host's first flow in
    host order, then each host's second, and so on."""
    pod = np.unique(np.asarray(topo.host_pod), return_inverse=True)[1]
    P = int(pod.max()) + 1
    members = [np.flatnonzero(pod == p) for p in range(P)]
    n = members[0].size
    D, S = int(mix["dests_per_pod"]), int(mix["sources"])
    if any(m.size != n for m in members) or not (
            0 < S < P and 0 < D <= n and D * S % n == 0):
        raise ValueError(f"no incast of {D} destinations a pod with {S} "
                         f"sources each over {P} pods of {n} hosts")
    per = D * S // n
    ring = rng.permutation(np.arange(1, P))
    dests = [rng.permutation(m)[:D] for m in members]
    feeds: list = [[] for _ in range(P)]    # the destinations pod p feeds
    for q in range(P):
        for j, d in enumerate(dests[q]):
            for t in range(S):
                feeds[(q + ring[(j + t) % (P - 1)]) % P].append(d)
    dst = np.empty((per, pod.size), np.int32)
    for p in range(P):
        # each host of the pod takes `per` of its feeds, in a random order
        dst[:, members[p]] = rng.permutation(feeds[p]).reshape(n, per).T
    src = np.tile(np.arange(pod.size, dtype=np.int32), per)
    size = np.full(src.shape, int(mix["packets"]), np.int32)
    return {"src": src, "dst": dst.reshape(-1), "size": size}
