"""Host ms per batch inside the Loader's next(), over the traced window's steps."""

from gpubench.layers import loader_ms as read  # noqa: F401
