"""Constants shared across the port (copied from the reference package's
``core/types.py``; the port imports nothing of the reference package)."""

#: Entropy Value space: the EV replaces the 16-bit UDP source port (Sec. 2.1).
EV_BITS = 16
EV_SPACE = 1 << EV_BITS

#: Sentinel tick meaning "never" in fault-schedule lanes (int32 max, so
#: `tick < NEVER_TICK` is always true for any reachable simulator tick).
#: A statically-failed queue is `fail_at=0, heal_at=NEVER_TICK`; a healthy
#: one is `fail_at=NEVER_TICK` (see repro_torch.network.faults).
NEVER_TICK = 2 ** 31 - 1
