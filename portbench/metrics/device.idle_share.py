"""device.idle_share (%): 1 - device busy / wall over the traced chunk,
with the wall of the same call made just before without the profiler
(as ``scripts/torch_port_profile.py`` takes it), so the profiler's own
host cost does not count as idle."""
from portbench.harness import busy_seconds


def read(ctx: dict):
    t = ctx["trace"]
    if not t["device"]:
        return None
    return 100.0 * (1.0 - busy_seconds(t["device"]) / t["plain_wall_s"])
