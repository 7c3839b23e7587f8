"""Hand-written CUDA kernels for the model zoo's hot spots (Hopper, sm_90a).

Each kernel package mirrors its Pallas counterpart in ``repro/kernels``:
  csrc/*.cu — the CUDA source, with a plain C launch function
  kernel.py — the ctypes binding and the launch counter ``LAUNCHES``
  ops.py    — the public wrapper: checks, then the kernel on a CUDA tensor
              or the plain version on a CPU tensor (never a fallback)
  ref.py    — the plain PyTorch version the kernel is held against

``build.py`` compiles every source into one shared library at first use.
"""
