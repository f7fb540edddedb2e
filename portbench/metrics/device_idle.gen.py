"""device_idle.gen: the share (%) of the profiled slice's wall time in which
no operation ran on the device."""
from portbench.harness.stats import idle_share


def read(ctx):
    return idle_share(ctx, "gen")
