"""Shared settings of the port's tests.

The tier-1 run uses several pytest-xdist workers on a few cores, so every
worker keeps torch to one intra-op thread.
"""

import torch

torch.set_num_threads(1)
