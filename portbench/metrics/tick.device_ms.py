"""tick.device_ms (ms): device busy time per group tick in the traced
chunk: the union of the intervals of every kernel, memset and copy,
over the ticks of the chunk (the arithmetic of
``scripts/torch_port_profile.py``, with overlaps counted once)."""
from portbench.harness import busy_seconds


def read(ctx: dict):
    t = ctx["trace"]
    if not t["device"]:
        return None
    return busy_seconds(t["device"]) * 1e3 / t["ticks"]
