"""One process of the port's two-process ``torch.distributed`` test.

Usage: python _torch_dist_worker.py <process_id> <port>

Each of the two processes owns 2 devices (the CPU listed twice), 4 in
the mesh. Steps:

1. ``initialize_distributed`` against a ``gloo`` group on localhost;
2. ``create_hybrid_mesh`` with the process boundary as the slice axis;
3. a split program over both axes whose gathered result every process
   holds (the sum of squares of 0..7, 140);
4. the multi-strain ensemble (16 members, constant step 0.5, 20 days,
   cumulative incidence kept) through ``simulate_ensemble(mesh=)``: each
   process solves its 8 members, the solution is gathered on both, and
   its sum over the members must equal the unsplit solve's in this
   process within 1e-12 relative.

Imports no JAX. Prints WORKER_OK as its last line on success.
"""

import os
import sys

pid, port = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from dynode_tpu_torch import simulate_ensemble  # noqa: E402
from dynode_tpu_torch.config import SolverParams  # noqa: E402
from dynode_tpu_torch.models.multistrain import (  # noqa: E402
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu_torch.parallel import create_hybrid_mesh, initialize_distributed  # noqa: E402
from dynode_tpu_torch.parallel.mesh import gather_shards, run_shards, shard_plan, split  # noqa: E402

assert initialize_distributed(coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid)
assert initialize_distributed()  # idempotent
assert torch.distributed.get_world_size() == 2 and torch.distributed.get_backend() == "gloo"

cpu = torch.device("cpu")
mesh = create_hybrid_mesh(("slice", "chain"), devices=[cpu, cpu])
assert mesh.shape == {"slice": 2, "chain": 2}, mesh.shape
assert mesh.processes.tolist() == [[0, 0], [1, 1]], mesh.processes

# --- 1. a split program over both axes, gathered on every process --------
x = torch.arange(8.0).reshape(4, 2)
plan = shard_plan(mesh, ("slice", "chain"), 4)
assert plan.local == (2 * pid, 2 * pid + 1) and plan.spans_processes
rows = gather_shards(plan, run_shards(plan, lambda s: (split(x, plan, s) ** 2).sum(dim=1)))
assert abs(float(rows.sum()) - 140.0) < 1e-9, rows

# --- 2. the ensemble's members across both processes ----------------------
B = 16
cfg = multistrain_config()
base = multistrain_odeparams(cfg, dtype=torch.float64, device=cpu)
y0 = multistrain_initial_state(dtype=torch.float64, device=cpu)
sp = SolverParams(constant_step_size=0.5)
scales = torch.as_tensor(np.linspace(0.9, 1.1, B))
batch = torch.utils._pytree.tree_map(lambda leaf: leaf.expand((B,) + leaf.shape).clone(), base)
batch = batch.replace(beta=base.beta * scales[:, None])

solved = []
real = torch.distributed.all_gather


def counting(out, piece, *a, **k):
    solved.append(piece.shape)
    return real(out, piece, *a, **k)


torch.distributed.all_gather = counting
got = simulate_ensemble(multistrain_ode, 20, y0, batch, sp, sub_save_indices=(4,), mesh=mesh,
                        axis_name=("slice", "chain"))
torch.distributed.all_gather = real
assert solved and all(shape[0] == 2 and shape[1] == B // 4 for shape in solved), solved  # 2 shards of 4 here
summary = got.ys[4][:, -1].sum(dim=0)  # final cumulative incidence (A, K)

want = simulate_ensemble(multistrain_ode, 20, y0, batch, sp, sub_save_indices=(4,)).ys[4][:, -1].sum(dim=0)
np.testing.assert_allclose(summary.numpy(), want.numpy(), rtol=1e-12)
assert torch.equal(got.ys[4], simulate_ensemble(multistrain_ode, 20, y0, batch, sp, sub_save_indices=(4,)).ys[4])

torch.distributed.destroy_process_group()
print(f"[p{pid}] WORKER_OK", flush=True)
