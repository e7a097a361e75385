"""95th percentile, over the requests submitted in the traced serving window, of submitted -> batch formed (the engine's request record)."""

from gpubench.spans import queue_wait_p95_ms as read  # noqa: F401
