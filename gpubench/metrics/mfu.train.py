"""The train step's share of the card's dense peak: the reference's operations per image (forward and backward) times the images of the traced window, over its length."""

from gpubench.layers import mfu_pct as read  # noqa: F401
