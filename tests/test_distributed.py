"""True multi-process jax.distributed smoke test (2 CPU processes).

The reference has no distributed capability (SURVEY.md §2.7); this verifies
the multi-host runtime layer (parallel/distributed.py) with a REAL process
group: two spawned python processes, each with 4 virtual CPU devices, form
one 8-device global mesh, shard host-side work, assemble a global array
from process-local shards and agree on a psum over the host axis.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, os.environ["REPO"])

from sfm_mvs_pipeline.parallel.distributed import (
    all_hosts_agree, assemble_global, host_shard, initialize_distributed,
)

pid = int(os.environ["PID"])
multi = initialize_distributed(os.environ["COORD"], 2, pid)
assert multi, "process group did not form"
assert jax.process_count() == 2
assert jax.device_count() == 8
assert jax.local_device_count() == 4

# host-level work sharding: disjoint, covering
work = host_shard(list(range(10)))
assert work == list(range(10))[pid::2]

# global array assembly from process-local data
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.asarray(jax.devices()).reshape(2, 4)
mesh = Mesh(devs, ("host", "chip"))
sharding = NamedSharding(mesh, P("host"))
local = np.full((2, 3), pid, np.float32)  # each host contributes 2 rows
arr = assemble_global(mesh, sharding, local)
assert arr.shape == (4, 3)
total = float(jax.numpy.sum(arr))  # 0*6 + 1*6
assert total == 6.0, total

assert all_hosts_agree(42)
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_group(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            COORD=coord,
            PID=str(pid),
            REPO=repo,
            JAX_PLATFORMS="cpu",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out
