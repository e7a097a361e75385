"""Share of the traced serving window in which the card ran nothing while the engine staged and launched a formed batch."""

from gpubench.spans import idle_held_pct as read  # noqa: F401
