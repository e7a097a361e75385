"""95th percentile, over the requests submitted in the traced serving window, of batch formed -> answer on the host (the engine's request record)."""

from gpubench.spans import service_p95_ms as read  # noqa: F401
