"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model and serving path.

Mirrors ``ray_tpu``'s module paths and public names (``ops``, ``models``,
``serve.llm``) so each function has an obvious counterpart. Hot kernels are
hand-written CUDA C++ for Hopper under ``csrc/``; they are compiled at their
first launch (``_kernels.py``), never on import, so importing the package
needs neither a card nor ``nvcc``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card present they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"
