"""PyTorch/CUDA port of the StreamFlow model zoo.

A second package beside the JAX reference (``src/repro``), laid out the
same way so that every module has a counterpart there:
``repro_torch/models/layers.py`` pairs with ``repro/models/layers.py``, and
so on.  It imports ``torch``, ``numpy`` and the standard library only.

Entry points run on the GPU (``cuda``) unless the caller passes
``device="cpu"``; with no device given and no GPU they raise instead of
carrying on on the CPU (``repro_torch.device``).  Hot spots that the JAX
package wrote as Pallas TPU kernels are hand-written CUDA kernels under
``repro_torch/kernels``.
"""
