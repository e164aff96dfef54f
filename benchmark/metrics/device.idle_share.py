"""Share of the traced window in which no kernel, memcpy or memset ran
on the card: 1 - union of device intervals / window (fraction); the
1CLJ cells."""

from benchmark.trace import idle_share as read  # noqa: F401
