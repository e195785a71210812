"""driver.build_ms (ms): the host's time to build the traced sweep's
tick and state (the ``driver.build`` span of each group: ``make_step``,
``init_state``, the workload and fault lanes copied to the card). None
for a program without spans."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    builds = durations_ns(records(ctx) or [], "driver.build")
    if not builds:
        return None
    return sum(builds) / 1e6
