"""Device ms per step of the kernels under the profiler's Optimizer.step range (AdamW)."""

from gpubench.layers import optimizer_ms as read  # noqa: F401
