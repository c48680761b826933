"""Two real processes in one ``gloo`` group, the port's mesh across them.

Mirrors ``tests/test_parallel/test_distributed_multiprocess.py``: the two
workers (``_torch_dist_worker.py``, which imports no JAX) join through
``initialize_distributed``, build a hybrid mesh with the process boundary
as its slice axis, gather a split program on both, and solve the
multi-strain ensemble with its members across both processes, the
gathered sum within 1e-12 of the unsplit solve. The workers have 120 s;
on expiry both are killed and the test fails.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_split_ensemble():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), str(port)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"distributed workers took over {TIMEOUT_S} s")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}\n{out[-3000:]}"
        assert "WORKER_OK" in out, f"worker {i} incomplete\n{out[-3000:]}"
