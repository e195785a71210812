"""kernels.wrapper_us (us): the host's time of one tick kernel's
dispatch in the traced sweep (its checks, allocations and launch: a
``kernels.<name>`` span of ``repro_torch.kernels.ops``), the mean over
the nine tick forms' calls. None for a program without spans."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    calls = durations_ns(records(ctx) or [], "kernels.")
    if not calls:
        return None
    return sum(calls) / 1e3 / len(calls)
