"""kernels.launches_per_tick (launches): launches of the port's
hand-written kernels (``repro_torch.kernels.ops.LAUNCHES``) over the
window, per group tick (each sweep steps its largest horizon)."""


def read(ctx: dict):
    ticks = sum(max(h) for h in ctx["horizons"] if h)
    if not ticks:
        return None
    return ctx["launches"] / ticks
