"""The golden SEIP fit on the card: the port of
``tests/test_infer/test_seip_quadrature.py::test_chees_matches_quadrature_posterior``.

ChEES through the reduced-rank SEIP model with every mechanism of the
production model active lands on the exact quadrature posterior of
``tests/golden/seip_quadrature.npz`` (its pinned counts are the data), with
the JAX test's schedule (50 warmup + 150 draws, 8 chains, at most 8
leapfrogs a transition) and tolerances: each mean within the larger of 1%
of the quadrature mean and 5 Monte-Carlo standard errors, each sd within
0.75-1.25 of the quadrature sd. The generic potential is captured into a
CUDA graph and replayed at every leapfrog. It runs on an H100 only and
imports no JAX (the card's machine has none)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch -m "cuda and slow" -k golden_seip
"""

import time

import numpy as np
import pytest
import torch

import torch_golden_seip as golden
from dynode_tpu_torch.infer import MCMC, ChEES
from dynode_tpu_torch.infer.diagnostics import effective_sample_size


@pytest.mark.cuda
@pytest.mark.slow
def test_chees_matches_quadrature_posterior_on_the_card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an H100 (CUDA compute capability 9.0)")
    cuda = torch.device("cuda")
    ref = np.load(golden.GOLDEN)
    _, base, y0, sp = golden.build_fit(cuda)
    model = golden.make_model(base, y0, sp)
    mcmc = MCMC(ChEES(model, max_num_steps=8), num_warmup=50, num_samples=150, num_chains=8)
    t = time.perf_counter()
    mcmc.run(torch.Generator(device=cuda).manual_seed(11), obs_data=torch.as_tensor(ref["obs"], device=cuda))
    wall = time.perf_counter() - t
    assert len(mcmc.graphs) == 1 and mcmc.graph.replays > 0
    arr = mcmc.get_samples(group_by_chain=True)["beta_scales"].cpu().numpy()
    flat = arr.reshape(-1, arr.shape[-1])
    q_mean, q_std = ref["mean"], ref["std"]
    print(f"golden SEIP ChEES on {torch.cuda.get_device_name(0)}: {wall:.1f} s, {mcmc.graph.replays} replays; "
          f"means {flat.mean(axis=0).tolist()} sds {flat.std(axis=0).tolist()} (quadrature {q_mean.tolist()}, "
          f"{q_std.tolist()})")
    for k in range(flat.shape[-1]):
        ess = max(effective_sample_size(arr[:, :, k]), 8.0)
        tol = max(0.01 * abs(q_mean[k]), 5.0 * float(q_std[k]) / np.sqrt(ess))
        assert abs(flat[:, k].mean() - q_mean[k]) < tol, (k, flat[:, k].mean(), q_mean[k], tol)
        assert 0.75 * q_std[k] < flat[:, k].std() < 1.25 * q_std[k], (k, flat[:, k].std(), q_std[k])
