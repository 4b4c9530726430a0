"""Element formulations."""
import torch


def per_element(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-element section value broadcast to ``like``'s
    shape, in its dtype on its device."""
    return torch.broadcast_to(torch.as_tensor(value, dtype=like.dtype, device=like.device), like.shape)
