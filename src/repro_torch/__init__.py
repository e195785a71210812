"""PyTorch port of the UET fabric engine, with hand-written CUDA kernels
for NVIDIA Hopper.

``repro`` (JAX) is the reference; this package imports ``torch`` and
``numpy`` only and is held bitwise against it by ``tests/test_torch_*.py``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch

__version__ = "1.0.0"


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is asked for and there is none —
    a CPU run is never substituted silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
