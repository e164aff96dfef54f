"""K1 (csrc/lj_cells.cu on the warp skeleton of lj_warp.cuh) against
its roofline: the bound of the state's in-cutoff pairs and needed bytes
(work.py) over K1's mean device time per launch, in %."""

from benchmark.work import roofline_percent


def read(trace):
    return roofline_percent(trace, "warp_cells_kernel")
