import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device."""
    return torch.device("cuda" if device is None else device)
