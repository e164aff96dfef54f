"""device.idle_share of the rigid multi-site cells, whose rate is
mol_updates_per_s.multisite."""

from benchmark.trace import idle_share as read  # noqa: F401
