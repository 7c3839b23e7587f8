"""Device and dtype policy of the port.

Every entry point takes ``device=``.  ``None`` means the GPU: if there is
none, :func:`resolve_device` raises rather than running quietly on the CPU.
The CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` (a string) as a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def check_on_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise if ``t`` does not lie on ``device`` (``cuda`` matches any index)."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} is on {t.device}, the call runs on {device}")
