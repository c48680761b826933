"""The one device gate of the port.

Every kernel entry point decides its route from the device of the tensors it
is given: a CPU tensor takes the plain PyTorch version, a CUDA tensor takes
the hand-written Hopper kernel. The kernels are built for ``sm_90a`` only, so
a CUDA route on anything but a compute-capability (9, 0) card raises here.
Nothing in the port drops a CUDA request to the CPU. Constructors given no
device put their tensors on the card (:func:`default_device`); the CPU is
asked for with ``device="cpu"``.
"""

from __future__ import annotations

import torch

#: the only compute capability the kernels are built for (``sm_90a``)
HOPPER = (9, 0)


def common_device(*tensors: torch.Tensor) -> torch.device:
    """The single device all ``tensors`` live on; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span several devices: {sorted(map(str, devices))}")
    return devices.pop()


def require_hopper(device: torch.device | str) -> torch.device:
    """Check that ``device`` is a CUDA device of compute capability (9, 0).

    Raises ``RuntimeError`` when CUDA is missing or the card is not a
    Hopper part; returns the normalised ``torch.device`` otherwise.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the Hopper kernels need a CUDA device, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for but torch.cuda.is_available() is False"
        )
    index = device.index if device.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if cap != HOPPER:
        raise RuntimeError(
            f"the kernels are built for sm_90a (compute capability {HOPPER}); "
            f"{torch.cuda.get_device_name(index)} has {cap}"
        )
    return torch.device("cuda", index)


def default_device() -> torch.device:
    """The device a constructor uses when the caller names none: the current
    CUDA device, after :func:`require_hopper`.

    Raises where there is no Hopper card; it never returns the CPU, which a
    caller asks for with ``device="cpu"``.
    """
    return require_hopper("cuda")


def resolve(device: torch.device | str | None) -> torch.device:
    """``device`` as given, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)


def uses_kernel(device: torch.device) -> bool:
    """True when ``device`` routes to a kernel (after the Hopper check).

    CPU -> False (the plain version); CUDA -> checked by
    :func:`require_hopper`, then True; any other device raises.
    """
    if device.type == "cpu":
        return False
    require_hopper(device)
    return True
