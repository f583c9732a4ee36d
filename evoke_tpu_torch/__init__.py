"""evoke_tpu_torch: the PyTorch / CUDA (Hopper) port of evoke_tpu.

The layout mirrors ``evoke_tpu/`` so each module's counterpart is found at the
same relative path. The package imports ``torch`` and ``numpy`` only; the
hand-written CUDA kernels under ``csrc/`` are compiled by ``nvcc`` at first use
on the card (``ops/_build.py``), never at import time.

Entry points take an explicit ``device`` (default ``"cuda"``) and never drift
to the CPU: ask for ``device="cpu"`` to run the kernels' plain PyTorch
versions, as the CPU tests do.
"""

__version__ = "0.1.0"
