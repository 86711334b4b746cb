"""The device's idle share over the traced window (torch.profiler): 100 x
(1 - busy / window), busy the union of every kernel, copy and set."""

from benchkit.readers import idle_pct as read  # noqa: F401
