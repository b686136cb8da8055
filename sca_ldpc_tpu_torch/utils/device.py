"""The device rule of the port's entry points: the card unless the caller
passes ``device="cpu"``; no fallback."""

import torch


def resolve_device(device):
    """``torch.device(device)``; raises when a CUDA device is asked for and
    there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False; "
                           'pass device="cpu" to run on the CPU')
    return device
