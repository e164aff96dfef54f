"""step_mfu of the rigid multi-site cells, whose rate is
mol_updates_per_s.multisite."""

from benchmark.work import step_mfu as read  # noqa: F401
