"""Device busy time per step of the RMM engine outside K1: the Kahan
leapfrog, thermostat, global sums and the shift rebin (K2 with its fold
and split), in ms/step."""

from benchmark.work import nonforce_ms


def read(trace):
    return nonforce_ms(trace, "warp_cells_kernel")
