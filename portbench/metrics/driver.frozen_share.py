"""driver.frozen_share (%): the share of the lane-ticks that the window's
sweeps stepped on lanes that had already stopped. A sweep steps all of
its B lanes until its last lane stops, so it steps B x (its largest
horizon) lane-ticks, of which the sum of its horizons are useful."""


def read(ctx: dict):
    stepped = sum(len(h) * max(h) for h in ctx["horizons"] if h)
    if not stepped:
        return None
    useful = sum(sum(h) for h in ctx["horizons"])
    return 100.0 * (1.0 - useful / stepped)
