"""The whole step's share of the card's float32 peak, in %: the
operations the state's in-cutoff pairs need (work.py) times the steps,
over the traced window's wall time and 67 TFLOP/s; the 1CLJ cells."""

from benchmark.work import step_mfu as read  # noqa: F401
