"""Parametric Clos / fat-tree topologies (Sec. 2.1, Fig. 2).

Two families:

* `LeafSpine` — 2-level Clos: L leaves × S spines, H hosts per leaf.
  Oversubscription = hosts_per_leaf / S (Fig. 7 uses 2:1-style oversub).
* `FatTree3` — 3-level k-ary fat tree (the Fig. 2 topology): pods of
  (k/2 leaves × k/2 hosts each) + k/2 aggs, (k/2)^2 cores. With k=8 and
  4 pods this is exactly the paper's 64-endpoint example: 4 equal-cost
  paths within a pod, 16 across pods.

The simulator operates on directed *queues* (one egress FIFO per link).
`QueueGraph` enumerates them and provides static routing metadata; the
per-packet ECMP choice happens in `repro_torch/network/ecmp.py`.

This module is numpy only and is kept as the port's own copy of the
reference package's `network/topology.py`: the port imports nothing of
the reference package, and the parity tests check that both build the
same tables.

Queue stages (generic across both families):
  UP1:  leaf -> spine/agg          DOWN1: agg/spine -> leaf
  UP2:  agg  -> core   (3-level)   DOWN2: core -> agg (3-level)
  HOST: leaf -> host (the destination downlink)
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class Stage(enum.IntEnum):
    UP1 = 0
    UP2 = 1
    DOWN2 = 2
    DOWN1 = 3
    HOST = 4
    DELIVERED = 5


@dataclass(frozen=True)
class QueueGraph:
    """Static queue enumeration + routing tables (NumPy; built once).

    num_queues:   total directed-link FIFOs
    stage:        [Q] Stage code of each queue
    host_queue:   [H] queue id of each host's final downlink
    up1:          [L, S1] queue ids leaf->spine(2lvl) or leaf->agg(3lvl,
                  S1 = aggs per pod)
    down1:        [S1_total, L_local] spine->leaf or agg->leaf queue ids
    up2/down2:    3-level only (else shape (0,0))
    host_leaf:    [H] leaf id of each host
    host_pod:     [H] pod id (2-level: == leaf id)
    fanout1:      spray choices at injection (== S for 2lvl, aggs/pod 3lvl)
    fanout2:      second spray stage (cores per agg; 0 for 2-level)
    """

    name: str
    num_queues: int
    num_hosts: int
    stage: np.ndarray
    host_queue: np.ndarray
    host_leaf: np.ndarray
    host_pod: np.ndarray
    # routing helper tables, -1 where n/a
    up1_table: np.ndarray     # [L, F1] leaf-local uplink choice -> queue id
    down1_table: np.ndarray   # [A, Lp] agg/spine -> leaf queue id
    up2_table: np.ndarray     # [A, F2] agg -> core queue id
    down2_table: np.ndarray   # [C, P] core -> (pod) agg queue id
    queue_next_switch: np.ndarray  # [Q] switch id the queue feeds into (-1 host)
    fanout1: int
    fanout2: int
    num_paths_same_pod: int
    num_paths_cross_pod: int
    diameter_hops: int


def leaf_spine(leaves: int, spines: int, hosts_per_leaf: int) -> QueueGraph:
    """2-level Clos. Queues: UP1 (L*S), DOWN1 (S*L), HOST (H)."""
    L, S, Hp = leaves, spines, hosts_per_leaf
    H = L * Hp
    q = 0
    up1 = np.zeros((L, S), np.int32)
    for l in range(L):
        for s in range(S):
            up1[l, s] = q
            q += 1
    down1 = np.zeros((S, L), np.int32)
    for s in range(S):
        for l in range(L):
            down1[s, l] = q
            q += 1
    host_q = np.arange(q, q + H, dtype=np.int32)
    q += H
    stage = np.zeros((q,), np.int32)
    stage[up1.ravel()] = Stage.UP1
    stage[down1.ravel()] = Stage.DOWN1
    stage[host_q] = Stage.HOST
    host_leaf = np.repeat(np.arange(L, dtype=np.int32), Hp)
    # queue -> switch it feeds into: up1 -> spine s; down1 -> leaf l; host -> -1
    nxt = np.full((q,), -1, np.int32)
    for l in range(L):
        for s in range(S):
            nxt[up1[l, s]] = L + s        # switches: leaves [0,L), spines [L, L+S)
            nxt[down1[s, l]] = l
    return QueueGraph(
        name=f"leafspine_L{L}_S{S}_H{Hp}",
        num_queues=q, num_hosts=H, stage=stage, host_queue=host_q,
        host_leaf=host_leaf, host_pod=host_leaf,
        up1_table=up1, down1_table=down1,
        up2_table=np.zeros((0, 0), np.int32),
        down2_table=np.zeros((0, 0), np.int32),
        queue_next_switch=nxt,
        fanout1=S, fanout2=0,
        num_paths_same_pod=S, num_paths_cross_pod=S,
        diameter_hops=3,  # host->leaf->spine->leaf->host: 3 queue traversals
    )


def fat_tree3(k: int, pods: int) -> QueueGraph:
    """3-level k-ary fat tree with `pods` pods (pods <= k).

    Per pod: k/2 leaves (each k/2 hosts down, k/2 aggs up), k/2 aggs.
    Cores: (k/2)^2; agg j in every pod connects to cores
    [j*(k/2), (j+1)*(k/2)).  Paper example: k=8, pods=4 -> 64 hosts,
    4 same-pod paths, 16 cross-pod paths.
    """
    half = k // 2
    Lp = half           # leaves per pod
    Ap = half           # aggs per pod
    Hp = half           # hosts per leaf
    C = half * half     # cores
    L = pods * Lp
    A = pods * Ap
    H = L * Hp

    q = 0
    up1 = np.zeros((L, Ap), np.int32)          # leaf -> agg (within pod)
    for l in range(L):
        for a in range(Ap):
            up1[l, a] = q
            q += 1
    up2 = np.zeros((A, half), np.int32)        # agg -> its k/2 cores
    for a in range(A):
        for c in range(half):
            up2[a, c] = q
            q += 1
    down2 = np.zeros((C, pods), np.int32)      # core -> agg (one per pod)
    for c in range(C):
        for p in range(pods):
            down2[c, p] = q
            q += 1
    down1 = np.zeros((A, Lp), np.int32)        # agg -> leaf (within pod)
    for a in range(A):
        for l in range(Lp):
            down1[a, l] = q
            q += 1
    host_q = np.arange(q, q + H, dtype=np.int32)
    q += H

    stage = np.zeros((q,), np.int32)
    stage[up1.ravel()] = Stage.UP1
    stage[up2.ravel()] = Stage.UP2
    stage[down2.ravel()] = Stage.DOWN2
    stage[down1.ravel()] = Stage.DOWN1
    stage[host_q] = Stage.HOST

    host_leaf = np.repeat(np.arange(L, dtype=np.int32), Hp)
    host_pod = host_leaf // Lp

    # switch ids: leaves [0,L), aggs [L, L+A), cores [L+A, L+A+C)
    nxt = np.full((q,), -1, np.int32)
    for l in range(L):
        pod = l // Lp
        for a in range(Ap):
            nxt[up1[l, a]] = L + pod * Ap + a
    for a in range(A):
        j = a % Ap
        for c in range(half):
            nxt[up2[a, c]] = L + A + j * half + c
    for c in range(C):
        for p in range(pods):
            nxt[down2[c, p]] = L + p * Ap + (c // half)
    for a in range(A):
        pod = a // Ap
        for l in range(Lp):
            nxt[down1[a, l]] = pod * Lp + l

    return QueueGraph(
        name=f"fattree3_k{k}_p{pods}",
        num_queues=q, num_hosts=H, stage=stage, host_queue=host_q,
        host_leaf=host_leaf, host_pod=host_pod,
        up1_table=up1, down1_table=down1, up2_table=up2, down2_table=down2,
        queue_next_switch=nxt,
        fanout1=Ap, fanout2=half,
        num_paths_same_pod=Ap, num_paths_cross_pod=Ap * half,
        diameter_hops=5,
    )


def paper_fig2() -> QueueGraph:
    """The paper's Fig. 2 example: 8-port switches, 64 endpoints, 4 groups."""
    return fat_tree3(k=8, pods=4)
