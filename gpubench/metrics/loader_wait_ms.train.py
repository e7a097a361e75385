"""Ms per step the training window's consumer spent in the Loader's loader.wait span, blocked on its producer thread."""

from gpubench.spans import loader_wait_ms as read  # noqa: F401
