"""Share of the traced training window with no device work."""

from gpubench.layers import idle_share_pct as read  # noqa: F401
