"""The port's one uint32 representation.

Every lane that the JAX engine keeps as ``uint32`` (PSN bases and rings,
the retransmit ring, hash state, EV salts) is stored here as
``torch.int32`` holding the same 32-bit pattern, so a JAX array carries
across with ``np_uint32.view(np.int32)``. The choice is forced: on this
torch build ``torch.uint32`` has no subtraction, shifts, comparisons or
``%``.

Which operations are already exact on the int32 pattern:

* ``+``, ``-``, ``*`` wrap modulo 2**32 exactly as uint32 does;
* ``^``, ``&``, ``|``, ``~`` are bitwise;
* ``==`` / ``!=`` compare patterns.

Which go through a helper in this module (nowhere else decides them):

* logical right shift (:func:`shr`) — int32 ``>>`` sign-fills;
* unsigned ``<`` (:func:`ult`), unsigned ``%`` (:func:`umod`), unsigned
  scatter-max (:func:`scatter_umax`);
* shifts by a per-lane tensor amount (:func:`bit`, :func:`funnel_r`);
* conversion to float (:func:`to_f32`);
* hash constants >= 2**31 (:func:`c32`): ``int32_tensor * 0x9E3779B1``
  raises, so constants go in as their int32 bit pattern; :func:`lane`
  makes an int32 tensor of a value that may be such a Python int.

The helpers that need more than 32 bits widen to int64 and mask with
``0xFFFFFFFF``; int64 shifts below 64 are well defined on every device.
A signed ``%`` by a modulus that is not a power of two is silently wrong
whenever the top bit is set, which is why :func:`umod` exists.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
INT_MIN = -(1 << 31)


def c32(v: int) -> int:
    """The int32 bit pattern of a 32-bit constant, as a Python int."""
    v &= M32
    return v - (1 << 32) if v >= (1 << 31) else v


def lane(x, device=None) -> torch.Tensor:
    """An int32 tensor of ``x`` (a tensor, array or Python int), on
    ``device`` if given; a Python int may be given unsigned and enters as
    its int32 pattern."""
    if isinstance(x, int):
        x = c32(x)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 pattern, as int64 in [0, 2**32)."""
    return x.to(torch.int64) & M32


def from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 pattern of its low 32 bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of an int32 pattern by a constant 0 <= n < 32."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def bit(n: torch.Tensor) -> torch.Tensor:
    """``1u << n`` for a per-lane amount n in [0, 32)."""
    return from_u64(torch.ones_like(n, dtype=torch.int64)
                    << n.to(torch.int64))


def funnel_r(lo: torch.Tensor, hi: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Low word of the 64-bit ``(hi:lo) >> b`` for b in [0, 32): the
    cross-word ring shift (``lo`` for b == 0)."""
    b = b.to(torch.int64)
    return from_u64((u64(lo) >> b) | (u64(hi) << (32 - b)))


def ult(a: torch.Tensor, b: "torch.Tensor | int") -> torch.Tensor:
    """Unsigned ``a < b`` on int32 patterns (flip the sign bit)."""
    bb = (c32(b) ^ INT_MIN) if isinstance(b, int) else (b ^ INT_MIN)
    return (a ^ INT_MIN) < bb


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned ``x % m`` for a positive modulus m < 2**31, as int32."""
    return (u64(x) % m).to(torch.int32)


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 (round to nearest, as ``astype`` does)."""
    return u64(x).to(torch.float32)


def scatter_umax(x: torch.Tensor, row: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """Unsigned scatter-max into [n] int32 patterns: a copy of ``x`` with
    ``x[row[l]] = umax(x[row[l]], val[l])`` for every lane (rows int64 in
    [0, n)). Flipping the sign bit maps unsigned order onto signed order,
    so one signed "amax" scatter decides it, exactly in any order."""
    out = x ^ INT_MIN
    out.scatter_reduce_(0, row, val ^ INT_MIN, "amax")
    return out ^ INT_MIN
