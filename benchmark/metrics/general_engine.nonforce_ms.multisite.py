"""Device busy time per step of the general engine outside K5 on the
rigid multi-site path: binning, the packed rows, rotation, head-halo
rows, gather back, half-kicks, thermostat and globals, in ms/step."""

from benchmark.work import nonforce_ms


def read(trace):
    return nonforce_ms(trace, "ms_kernel")
