"""PyTorch/CUDA port of the ``repro`` package (NVMM cache design: logging
vs paging), for one NVIDIA H100.

The port keeps its own copies of everything it needs and imports nothing
from ``repro`` or JAX. Entry points run on the GPU (``device="cuda"``)
unless the caller passes ``device="cpu"``; they raise when asked for a GPU
that is not there.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising if it names a missing GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch sees no GPU; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
