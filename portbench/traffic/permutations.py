"""Traffic generator: ``perms`` random cross-pod permutations of the
hosts, one flow of ``packets`` packets from each host in each, all
starting at tick 0.

Every flow leaves its pod, and a host never sends twice to one
destination, so every destination has exactly ``perms`` distinct
sources: with two permutations each host downlink is a 2:1 incast. This
is the full-width traffic of ``chip_smoke.py`` (``_fullsize``: host h
sends to h + 512 and h + 256), drawn from the seed instead of fixed.
"""
from __future__ import annotations

import numpy as np


def _cross_pod_perm(rng: np.random.Generator, pod: np.ndarray,
                    taken: list) -> np.ndarray:
    """A permutation of the hosts in which no host maps into its own pod
    nor onto a destination it already has in ``taken``: a uniform draw,
    then each host that breaks the rule swaps its destination with a
    random host's, where the swap breaks the rule for neither."""
    n = pod.shape[0]
    perm = rng.permutation(n)

    def bad(i: int, d: int) -> bool:
        return pod[d] == pod[i] or any(t[i] == d for t in taken)

    for i in range(n):
        while bad(i, perm[i]):
            j = int(rng.integers(n))
            if not bad(i, perm[j]) and not bad(j, perm[i]):
                perm[i], perm[j] = perm[j], perm[i]
    return perm


def generate(rng: np.random.Generator, topo, mix: dict) -> dict:
    """{src, dst, size}: [F] int32 flow lanes, F = perms x hosts."""
    pod = np.asarray(topo.host_pod)
    perms: list = []
    for _ in range(int(mix["perms"])):
        perms.append(_cross_pod_perm(rng, pod, perms))
    hosts = np.arange(pod.shape[0])
    src = np.concatenate([hosts] * len(perms)).astype(np.int32)
    dst = np.concatenate(perms).astype(np.int32)
    size = np.full(src.shape, int(mix["packets"]), np.int32)
    return {"src": src, "dst": dst, "size": size}
