"""Hand-written Hopper kernels of the port, one per TPU kernel of the
reference (``src/repro/kernels/``). Sources live in ``csrc/`` and are built
with ``nvcc`` into ``build/`` at the repository root on first use
(:mod:`repro_torch.kernels.build`). Each kernel package holds a wrapper with a
launch counter (``ops.py``) and its plain PyTorch version (``ref.py``)."""
