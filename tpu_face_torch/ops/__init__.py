"""Tensor ops of the cascade: image warps, post-processing, the warp
kernel's wrapper and its build."""
