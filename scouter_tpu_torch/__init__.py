"""SCOUTER in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package ``scouter_tpu`` that stays beside it as the
reference. Module paths and public names mirror the JAX package; the
TPU kernels on the ported paths are hand-written CUDA kernels under ``csrc/``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
