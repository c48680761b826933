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

import contextlib

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


def scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype`` on ``device``.

    A Python number is written there by a fill kernel and never copied from
    the host, so a call that builds its constants this way can be captured
    in a CUDA graph (a host-to-device copy from pageable memory
    synchronises, which capture forbids). The value is the one
    ``torch.as_tensor(x, dtype=dtype)`` holds.
    """
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype, device=device)


#: the stores :func:`constant` fills, innermost last (:func:`keep_constants`)
_STORES: list = []


@contextlib.contextmanager
def keep_constants(store: dict):
    """Within the block, :func:`constant` copies each content to the device
    once and keeps it in ``store``.

    A CUDA graph captured after a first (warm-up) call inside the block
    holds no host-to-device copy, and reads the kept tensors at every
    replay: the owner of the graph keeps ``store`` as long as the graph.
    """
    _STORES.append(store)
    try:
        yield store
    finally:
        _STORES.pop()


def constant(host: torch.Tensor, device) -> torch.Tensor:
    """The CPU tensor ``host`` on ``device``.

    On the CPU ``host`` itself; inside :func:`keep_constants`, the tensor
    its store holds for equal contents (copied on the first call);
    otherwise a fresh copy. ``host`` must be a plain tensor, made outside
    any ``torch.func`` transform (:func:`from_host`): inside one, a new
    tensor has no storage the host can read. The copy is made outside the
    transform too, so a kept tensor outlives it.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return host
    with torch._C._DisableFuncTorch():
        if not _STORES:
            return host.to(device)
        store = _STORES[-1]
        key = (host.numpy().tobytes(), host.dtype, tuple(host.shape), str(device))
        if key not in store:
            store[key] = host.to(device)
        return store[key]


def from_host(values, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``values`` (numbers, nested sequences, a numpy array or a CPU tensor)
    as a tensor on ``device``, in ``dtype`` when given.

    The tensor is built on the host, outside any ``torch.func`` transform,
    with the values ``torch.as_tensor(values, dtype=dtype)`` holds, and
    placed by :func:`constant`: a call inside a CUDA-graph capture reads
    the copy its warm-up kept, and never copies from the host.
    """
    with torch._C._DisableFuncTorch():
        host = torch.as_tensor(values, dtype=dtype, device="cpu").detach()
    return constant(host, device)
