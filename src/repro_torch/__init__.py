"""PyTorch + CUDA port of the SoftmAP reference package (``src/repro``).

The JAX package stays the reference; this package mirrors its module names
so each counterpart is easy to find, and imports nothing from it (not even
framework-neutral modules: importing any ``repro.*`` module runs
``repro/core/__init__.py``, which imports JAX). Every TPU kernel on the
ported path is a hand-written Hopper kernel under ``kernels/``; its plain
PyTorch version serves CPU tensors.

Entry points run on the card (``torch.device("cuda")``) unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise (see :mod:`repro_torch.device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
