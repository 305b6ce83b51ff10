"""repro_torch — the LIFL platform on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that sits beside it and keeps its
layout and wire format: flat updates in ``jax.tree.flatten`` leaf order
with HWIO conv weights, so an update from either package folds into the
other.  The public surface is :class:`repro_torch.api.Session`; the
fold runs in the hand-written CUDA kernels of ``kernels/fedavg``.  See
README.md in this directory.
"""
