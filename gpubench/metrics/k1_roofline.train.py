"""K1's share of its roofline in training: the bound time of its forward-with-hist and backward calls over the device time of the kernels their custom ops launched."""

from gpubench.layers import k1_roofline_pct as read  # noqa: F401
