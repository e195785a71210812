"""tick.device_ops (ops): device operations (kernels, memsets, copies)
per group tick in the traced chunk."""


def read(ctx: dict):
    t = ctx["trace"]
    if not t["device"]:
        return None
    return len(t["device"]) / t["ticks"]
