"""Device kernel launches per step over the traced window (host
dispatch of the driver and the engines); the 1CLJ cells."""

from benchmark.trace import launches_per_step as read  # noqa: F401
