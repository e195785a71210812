"""driver.masked_tick_share (%): the share of the group ticks the chunk
loops issued under the masked body (chunks after some lane of the sweep
stopped, whose selects keep the stopped lanes frozen), from the
program's counters ``fabric.DRIVER_COUNTS``, over every chunk the run
issued before the read: the warm-up chunk, the window and the traced
sweep. None for a program without them."""


def read(ctx: dict):
    from repro_torch.network import fabric
    counts = getattr(fabric, "DRIVER_COUNTS", None)
    if not counts or not counts["ticks"]:
        return None
    return 100.0 * counts["masked_ticks"] / counts["ticks"]
