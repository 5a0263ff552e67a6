"""Device selection and scalar constants shared by the port's modules."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "const", "pin_fp32_matmul"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Asking for ``cuda`` on a machine without one raises; the
    port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype and device.

    Used as the divisor wherever the JAX code divides by a Python float:
    PyTorch's CUDA ``div`` turns division by a Python scalar into a multiply
    by its reciprocal, which can move a result by one ulp (and a truncated
    cell index by one cell).  A tensor divisor keeps true IEEE division on
    both devices, as XLA does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def pin_fp32_matmul() -> None:
    """Pin float32 matrix products on the card to true fp32.  TF32 keeps
    about three decimal digits: the QP's ADMM then converges to garbage
    (ops/qp.py), and the arbiter's gates, each a threshold on a float that
    the actor's layers feed, drift from the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
