"""Two-process ``jax.distributed`` smoke test of init_multihost.

The explicit-env branch of ``parallel/multihost.py::init_multihost`` calls
``jax.distributed.initialize(coordinator, n, pid)`` — this test actually
EXECUTES that call: it spawns two fresh Python processes on localhost
(CPU backend, gloo collectives), each configured through the
MOJOSPLAT_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID env contract, builds
a global 2-device mesh spanning both processes, and runs a tiny psum
across them. SURVEY.md section 2.3 (comm backend row) commits to the
``jax.distributed.initialize()`` path; everything else in the suite tests
it only as a no-op or env-validation error.
"""

import os
import socket
import subprocess
import sys

CHILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import jax
jax.config.update("jax_platforms", "cpu")

from mojosplat_jax.parallel import init_multihost, is_primary

ran = init_multihost()
assert ran is True, "explicit env contract set but initialize did not run"
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()
assert jax.local_device_count() == 1
assert is_primary() == (jax.process_index() == 0)

# Tiny psum across the two processes: each contributes (process_index+1),
# so every process must see 1 + 2 = 3.
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

mesh = Mesh(np.array(jax.devices()), ("p",))
local = jnp.array([float(jax.process_index() + 1)])
garr = jax.make_array_from_single_device_arrays(
    (2,), NamedSharding(mesh, P("p")),
    [jax.device_put(local, jax.local_devices()[0])],
)

@jax.jit
def total(x):
    return jax.shard_map(
        lambda v: jax.lax.psum(v, "p"), mesh=mesh,
        in_specs=P("p"), out_specs=P("p"),
    )(x)

# A global array spans non-addressable devices; read this process's shard.
out = np.asarray(total(garr).addressable_shards[0].data)
assert np.allclose(out, 3.0), out
print(f"MULTIHOST_OK pid={jax.process_index()} psum={out[0]}", flush=True)
"""


def test_two_process_distributed_init_and_psum(tmp_path):
    # Reserve a coordinator port (bind-then-close; the race window is
    # acceptable for a test on an otherwise idle machine).
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env_base = dict(os.environ)
    env_base.update({
        "JAX_PLATFORMS": "cpu",
        # One CPU device per process (the parent conftest forces 8 virtual
        # devices; children must not inherit that).
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        "MOJOSPLAT_COORDINATOR": f"127.0.0.1:{port}",
        "MOJOSPLAT_NUM_PROCESSES": "2",
    })

    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["MOJOSPLAT_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=220)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed (rc={p.returncode}):\n{out[-3000:]}"
        )
        assert f"MULTIHOST_OK pid={pid} psum=3.0" in out, out[-3000:]
