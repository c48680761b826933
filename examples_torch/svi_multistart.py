"""SVI as a multi-start bank, splittable over the cards.

The port of examples/svi_multistart.py. A single Adam trajectory from one
init can fall into an ELBO local optimum without a sign; a bank of
independently initialized optimizations runs as one vmapped program (the
starts fill the card as chain width does for MCMC), the finished guides
are ranked by a multi-particle ELBO and the winner is kept. This fits
sir_infer_parameters.py's posterior with a 64-start bank and prints the
spread of final ELBOs across starts, then hands the fitted guide to an
SVI-initialized ChEES bank with zero warmup::

    python examples_torch/svi_multistart.py [--device cpu]

With several cards visible the starts are split over a mesh of them.
"""

import _bootstrap

import numpy as np
import torch

from dynode_tpu_torch import SVIProcess
from dynode_tpu_torch.infer import MCMC, ChEES, chees_warm_start_from_guide
from dynode_tpu_torch.parallel import create_mesh
from sir_infer_parameters import get_config, model, observed

#: fit window, starts, Adam steps, guide draws, ChEES chains and draws (zero warmup), burn-in
COUNTS = dict(tf_fit=100, starts=64, iterations=500, num_samples=200, chains=256, draws=24, burn=4)
FAST_COUNTS = dict(tf_fit=50, starts=4, iterations=80, num_samples=200, chains=32, draws=8, burn=2)


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def start_mesh(device, starts: int):
    """A mesh of every card over the start axis, when there are several
    and they divide the starts; else None."""
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_cards > 1 and starts % n_cards == 0:
        return create_mesh(("start",))
    return None


def run(device, fast=False, dtype=torch.float32, overrides=None) -> dict:
    """The multi-start fit, then the SVI-initialized ChEES bank, and the
    walls of both (``walls``); ``overrides`` replaces entries of
    :func:`counts`."""
    n = {**counts(fast), **(overrides or {})}
    incidence = observed(device, n["tf_fit"], dtype)
    config = get_config(dtype, device)
    proc = SVIProcess(
        numpyro_model=model,
        num_iterations=n["iterations"],
        num_samples=n["num_samples"],
        num_starts=n["starts"],
        init_jitter=1.0,
        svi_mesh=start_mesh(device, n["starts"]),
        progress_bar=not fast,
    )
    walls = {}
    with _bootstrap.timed(walls, "svi", device):
        proc.infer(config=config, tf=n["tf_fit"], obs_data=incidence)
    res = proc._inference_state

    # the guide's draws are the chain positions and its covariance is the
    # mass matrix, so the bank samples with zero warmup transitions
    warm = chees_warm_start_from_guide(proc._inferer.guide, res.params, num_chains=n["chains"],
                                       rng_key=torch.Generator(device=device).manual_seed(7))
    mcmc = MCMC(ChEES(model), num_warmup=0, num_samples=n["draws"], num_chains=n["chains"], progress_bar=False)
    with _bootstrap.timed(walls, "chees", device):
        mcmc.run(torch.Generator(device=device).manual_seed(8), config=config, tf=n["tf_fit"], obs_data=incidence,
                 warm_start=warm)
    post = mcmc.get_samples(group_by_chain=True)
    return {"incidence": incidence, "proc": proc, "final_elbos": res.final_elbos, "best_idx": int(res.best_idx),
            "svi_samples": proc.get_samples(), "chees_r0": post["strains_0_r0"][:, n["burn"]:], "mcmc": mcmc,
            "walls": walls}


def draw(plt, out):
    fig, (left, right) = plt.subplots(1, 2, figsize=(10, 4))
    left.hist(out["final_elbos"], bins=20)
    left.set_xlabel("final ELBO per start")
    right.hist(out["svi_r0"], bins=30, alpha=0.5, density=True, label="SVI guide")
    right.hist(out["chees_r0"].ravel(), bins=30, alpha=0.5, density=True, label="SVI-init ChEES")
    right.set_xlabel("r0")
    right.legend()
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    elbos = _bootstrap.host(out["final_elbos"])
    print(f"{elbos.shape[0]} starts: best ELBO {elbos.max():.2f} (start {out['best_idx']}), worst {elbos.min():.2f}, "
          f"spread {elbos.max() - elbos.min():.2f} nats")
    r0 = _bootstrap.host(out["svi_samples"]["strains_0_r0"])
    ip = _bootstrap.host(out["svi_samples"]["strains_0_infectious_period"])
    print(f"posterior r0: {r0.mean():.4f} +- {r0.std():.4f} (true 2.0)")
    print(f"posterior infectious_period: {ip.mean():.4f} +- {ip.std():.4f} (true 7.0)")
    r0_mc = _bootstrap.host(out["chees_r0"]).astype(np.float64)
    print(f"SVI-init ChEES (0 warmup): r0 {r0_mc.mean():.4f} +- {r0_mc.std():.4f} (true 2.0)")
    _bootstrap.save("svi_multistart", {"final_elbos": elbos, "svi_r0": r0, "chees_r0": r0_mc}, draw)
