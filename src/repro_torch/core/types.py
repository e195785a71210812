"""Constants shared across the port (copied from the reference package's
``core/types.py``; the port imports nothing of the reference package),
and the two shape rules of its scenario axis."""
import math

import torch

#: Entropy Value space: the EV replaces the 16-bit UDP source port (Sec. 2.1).
EV_BITS = 16
EV_SPACE = 1 << EV_BITS

#: Sentinel tick meaning "never" in fault-schedule lanes (int32 max, so
#: `tick < NEVER_TICK` is always true for any reachable simulator tick).
#: A statically-failed queue is `fail_at=0, heal_at=NEVER_TICK`; a healthy
#: one is `fail_at=NEVER_TICK` (see repro_torch.network.faults).
NEVER_TICK = 2 ** 31 - 1


def lane_shape(n: "int | tuple[int, ...]") -> "tuple[int, ...]":
    """The shape of a per-flow lane: ``n`` flows ([n]), or a shape with
    leading scenario axes ((B, F): one scenario per row)."""
    return (int(n),) if isinstance(n, int) else tuple(int(d) for d in n)


def scenario_rows(lanes: torch.Tensor, rows: int) -> torch.Tensor:
    """[..., 1] first flat row of each lane's scenario, for [..., L]
    lanes scattered into [..., R] state flattened to one row axis: with
    lanes [B, L], b*R (0 for unbatched [L] lanes)."""
    lead = tuple(lanes.shape[:-1])
    return (torch.arange(math.prod(lead), dtype=torch.int32,
                         device=lanes.device).view(lead + (1,)) * rows)
