"""Sharded checkpointing with elastic restore, and the checkpoint-restart
economics (Young/Daly) — the port of ``repro.ckpt.checkpointing``.

The IO keeps the reference's on-disk format, so a checkpoint written by
either package restores in the other:

* ``step_XXXXXXXX/`` holds ``manifest.json`` (the step, the process
  count, and each leaf's path, shape and dtype) and one
  ``shards_00000.msgpack``: {leaf path: {data: zstd of the raw bytes,
  shape, dtype}} per process;
* leaf paths are the tree's keys joined by ``/`` in JAX's leaf order
  (``params/blocks/pos0/ffn/w_gate``, ``opt/m/...``, ``opt/step``);
* the write goes to ``step_XXXXXXXX.tmp`` and is published by an atomic
  rename, then the ``latest`` pointer is replaced atomically, so a
  failed or partial write never corrupts the previous checkpoint;
* ``restore`` reassembles each leaf on the host and places it on the
  live device (the elastic path: the layout at save time does not
  matter).

``AsyncCheckpointer`` overlaps the write with the next steps; ``wait``
joins it and re-raises an error of the writer thread, since a lost
checkpoint is a failure the caller must see. The IO needs ``msgpack``
and ``zstandard``; without them it refuses, and only the economics
work.

The economics price the endpoint-failure recovery loop: given a failure
rate (MTBF), a checkpoint write cost, and the measured recovery costs —
detection time from the fabric's PDC-teardown signal, elastic restore,
replan — what fraction of wall time is NEW forward progress, and what
checkpoint interval maximizes it?
`repro_torch.network.traffic.price_recovery` measures the costs and these
forms price effective throughput over an MTBF x checkpoint-interval grid.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T

try:  # IO deps gated: the economics functions need neither
    import msgpack
    import zstandard
except ImportError:  # pragma: no cover — slim containers
    msgpack = None
    zstandard = None


def _require_io():
    if msgpack is None or zstandard is None:
        raise ImportError("checkpoint IO needs msgpack + zstandard; only "
                          "the Young/Daly economics work without them")


def young_daly_interval(mtbf_s: float, write_s: float) -> float:
    """Young/Daly first-order optimal checkpoint interval:
    ``tau* = sqrt(2 * write_s * mtbf_s)``.

    Within :func:`availability`'s overhead model this tau is EXACTLY the
    argmax (d/dtau of ``write/tau + tau/(2*MTBF)`` vanishes there), so
    any fixed interval != tau* prices strictly worse — the inequality
    the resilience bench asserts."""
    if mtbf_s <= 0:
        raise ValueError(f"mtbf_s must be > 0, got {mtbf_s}")
    if write_s < 0:
        raise ValueError(f"write_s must be >= 0, got {write_s}")
    return math.sqrt(2.0 * write_s * mtbf_s)


def availability(interval_s: float, mtbf_s: float, *, write_s: float,
                 detect_s: float = 0.0, restore_s: float = 0.0,
                 replan_s: float = 0.0) -> float:
    """Fraction of wall time spent on new forward progress under
    periodic checkpointing with exponential failures of rate 1/MTBF:

    * every interval pays one checkpoint write (``write_s / interval_s``
      of the time);
    * every failure pays detection (the fabric's fault -> PDC-teardown
      latency), checkpoint restore, collective replan, and on average
      half an interval of lost work (``interval_s / 2``).

    ``availability = 1 / (1 + write/tau + (tau/2 + D + R + P) / MTBF)``

    Strictly increasing in MTBF and strictly unimodal in ``interval_s``
    with its maximum at :func:`young_daly_interval`."""
    if interval_s <= 0:
        raise ValueError(f"interval_s must be > 0, got {interval_s}")
    if mtbf_s <= 0:
        raise ValueError(f"mtbf_s must be > 0, got {mtbf_s}")
    for name, v in (("write_s", write_s), ("detect_s", detect_s),
                    ("restore_s", restore_s), ("replan_s", replan_s)):
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")
    per_failure = detect_s + restore_s + replan_s + interval_s / 2.0
    overhead = write_s / interval_s + per_failure / mtbf_s
    return 1.0 / (1.0 + overhead)


def effective_rate(healthy_rate: float, interval_s: float, mtbf_s: float,
                   **costs) -> float:
    """Throughput after the checkpoint-restart tax: e.g. effective
    tokens/sec = healthy tokens/sec x :func:`availability`."""
    return healthy_rate * availability(interval_s, mtbf_s, **costs)


# ---------------------------------------------------------------------------
# checkpoint IO, in the reference's format
# ---------------------------------------------------------------------------

_NP_DTYPE = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int64: "int64", torch.int32: "int32",
             torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
             torch.bool: "bool"}
_TORCH_DTYPE = {v: k for k, v in _NP_DTYPE.items()}


def _host(leaf) -> "tuple[bytes, list, str]":
    """A leaf's raw bytes (C order), shape and numpy dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _NP_DTYPE[t.dtype]
        if t.dtype == torch.bfloat16:     # numpy has no bf16: its bits
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(t.shape), name
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf(data: bytes, shape: list, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(data, dtype=np.int16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(data, dtype=np.dtype(dtype))
                             .copy())
    return t.reshape(shape).to(device)


def save(ckpt_dir: str, step: int, tree: Any, process_index: int = 0,
         num_processes: int = 1) -> str:
    """Write one checkpoint of a tree of tensors (or numpy arrays).
    Returns the checkpoint path."""
    _require_io()
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)

    cctx = zstandard.ZstdCompressor(level=3)
    leaves = []
    shard_blobs = {}
    for path, leaf in T.leaves_with_paths(tree):
        p = T.path_str(path)
        data, shape, dtype = _host(leaf)
        leaves.append({"path": p, "shape": shape, "dtype": dtype})
        shard_blobs[p] = {"data": cctx.compress(data), "shape": shape,
                          "dtype": dtype}
    manifest = {"step": step, "num_processes": num_processes,
                "leaves": leaves}
    with open(os.path.join(tmp, f"shards_{process_index:05d}.msgpack"),
              "wb") as f:
        f.write(msgpack.packb(shard_blobs, use_bin_type=True))
    if process_index == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    os.replace(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return final


class AsyncCheckpointer:
    """Overlap checkpoint IO with compute: ``save`` copies the tree to
    the host and returns; the previous write is joined before a new one
    starts. ``wait`` joins the write in flight and re-raises its error."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, step: int, tree: Any):
        try:
            save(self.ckpt_dir, step, tree)
        except BaseException as e:  # noqa: BLE001 — handed to wait()
            self._error = e

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = T.map(lambda x: x.detach().cpu().clone()
                          if isinstance(x, torch.Tensor) else np.asarray(x),
                          tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "latest")) as f:
            name = f.read().strip()
        return int(name.split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(ckpt_dir: str, step: int, target_tree: Any,
            shardings: Any = None) -> Any:
    """Load a checkpoint into the structure of ``target_tree``.

    ``shardings``: the device to place every leaf on, or a tree of
    devices over ``target_tree``'s keys (a device stands for a whole
    subtree) — the elastic path: the checkpoint's layout at save time is
    irrelevant. Without it a leaf goes to its
    target leaf's device (the CPU for a numpy target). Each leaf keeps
    the dtype it was saved with."""
    _require_io()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    dctx = zstandard.ZstdDecompressor()
    blobs: dict = {}
    for fn in sorted(os.listdir(final)):
        if not fn.startswith("shards_"):
            continue
        with open(os.path.join(final, fn), "rb") as f:
            blobs.update(msgpack.unpackb(f.read(), raw=False))

    out = []
    for (path, _), dev in zip(T.leaves_with_paths(target_tree),
                              _devices(target_tree, shardings)):
        blob = blobs[T.path_str(path)]
        out.append(_leaf(dctx.decompress(blob["data"]), blob["shape"],
                         blob["dtype"], dev))
    return T.unflatten_like(target_tree, out)


def _devices(target: Any, shardings: Any) -> list:
    """The device of every leaf of ``target`` (JAX's order): ``shardings``
    is a device for the whole subtree, or a dict of such by key; None
    keeps the target leaf's device (the CPU for a numpy leaf)."""
    if shardings is None or isinstance(shardings, (str, torch.device)):
        return [shardings if shardings is not None else
                (leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
                for leaf in T.leaves(target)]
    if isinstance(target, dict):
        return [d for k in sorted(target)
                for d in _devices(target[k], shardings[k])]
    if isinstance(target, (list, tuple)):
        return [d for t, s in zip(target, shardings)
                for d in _devices(t, s)]
    raise TypeError(f"no device in {shardings!r} for a leaf")
