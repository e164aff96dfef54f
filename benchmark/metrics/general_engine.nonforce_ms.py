"""Device busy time per step of the general engine outside K3 on the
1CLJ path: sort binning, the kernel's layout, gather back, half-kicks,
thermostat and globals, in ms/step."""

from benchmark.work import nonforce_ms


def read(trace):
    return nonforce_ms(trace, "warp_cells_kernel")
