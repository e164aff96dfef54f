"""K5 (csrc/ms_packed.cu on the skeleton of ms_pair.cuh) against its
roofline: the bound of the state's in-cutoff pairs times the site-pair
program's operations and the needed bytes (work.py) over K5's mean
device time per launch, in %."""

from benchmark.work import roofline_percent


def read(trace):
    return roofline_percent(trace, "ms_kernel")
