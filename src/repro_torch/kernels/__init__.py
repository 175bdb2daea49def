"""Hand-written Hopper kernels of the port, one per TPU kernel of the
reference (``src/repro/kernels/``). Sources live in ``csrc/`` and are built
with ``nvcc`` into ``build/`` at the repository root on first use
(:mod:`repro_torch.kernels.build`). Each kernel package holds a wrapper with a
launch counter (``ops.py``) and its plain PyTorch version (``ref.py``)."""

import torch


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>``, a kernel launch count, where the
    wrapper launches its kernel. A call under CUDA-graph capture records the
    kernel into the graph and launches nothing, so it adds nothing; a replay
    launches the kernel without calling the wrapper, and the device trace
    counts those launches (``chip_smoke.py``)."""
    if not torch.cuda.is_current_stream_capturing():
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
