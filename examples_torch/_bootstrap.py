"""What every example of the port shares: the import path, its command
line and the saving of its figure.

``python examples_torch/<name>.py`` puts ``examples_torch/`` on ``sys.path``
but not the repo root; importing this module first fixes that.

- ``--device``: where the example computes. By default the card
  (``_device.default_device()``), which raises where there is none: nothing
  drops to the CPU unless ``--device cpu`` asks for it.
- ``--float64``: compute in float64 instead of the examples' float32.
- ``DYNODE_FAST_EXAMPLES=1`` shrinks the inference-heavy workloads
  (:func:`fast_mode`), as for ``examples/``.

Each script's ``run(...)`` computes and returns the arrays it plots; its
``__main__`` hands them to :func:`save`, which writes ``<figure>.npz``
always and ``<figure>.png`` where matplotlib imports.
"""

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dynode_tpu_torch import _device  # noqa: E402


def fast_mode() -> bool:
    """True when CI asks the examples to shrink their workloads."""
    return bool(os.environ.get("DYNODE_FAST_EXAMPLES"))


def parse_args(description: str) -> argparse.Namespace:
    """The examples' command line: ``device`` (a ``torch.device``, the card
    by default) and ``dtype`` (float32, or float64 with ``--float64``)."""
    parser = argparse.ArgumentParser(description=description.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device to compute on (default: the card)")
    parser.add_argument("--float64", action="store_true", help="compute in float64 (default float32)")
    args = parser.parse_args()
    args.device = _device.resolve(args.device)
    args.dtype = torch.float64 if args.float64 else torch.float32
    return args


@contextlib.contextmanager
def timed(walls: dict, name: str, device):
    """Add the block's wall seconds, up to the end of its work on
    ``device``, to ``walls[name]``."""
    t = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls[name] = walls.get(name, 0.0) + time.perf_counter() - t


def host(x) -> np.ndarray:
    """``x`` as a host numpy array (a bfloat16 tensor as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def save(figure: str, arrays: dict, draw) -> None:
    """Write ``arrays`` to ``<figure>.npz``, then ``draw(plt, arrays)``'s
    figure to ``<figure>.png`` when matplotlib imports."""
    arrays = {k: host(v) for k, v in arrays.items()}
    np.savez(f"{figure}.npz", **arrays)
    print(f"saved {figure}.npz")
    try:
        import matplotlib
    except ImportError:
        print(f"no {figure}.png drawn: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = draw(plt, arrays)
    fig.savefig(f"{figure}.png", dpi=100)
    plt.close(fig)
    print(f"saved {figure}.png")
