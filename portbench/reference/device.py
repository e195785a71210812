"""Where the reference runs: the device it is given, never a silent
fallback."""
import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the reference was asked for CUDA and there is "
                           "no CUDA device")
    return dev
