"""dispatch.launches_per_step of the rigid multi-site cells, whose rate
is mol_updates_per_s.multisite."""

from benchmark.trace import launches_per_step as read  # noqa: F401
