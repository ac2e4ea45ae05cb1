"""Multi-host entry point: ``jax.distributed.initialize`` gating.

SURVEY.md section 2.3 (comm backend row) calls for multi-host runs via
``jax.distributed.initialize()`` — after it, ``jax.devices()`` spans every
process's chips and the existing mesh helpers (make_mesh / make_gauss_mesh)
transparently build cross-host meshes, with XLA routing collectives through
NCCL (NVLink within a host, the network across hosts). The reference has no distributed
code of any kind (its only trace is a commented-out world_rank print,
/root/reference/mojosplat/binning.py:83).

Call ``init_multihost()`` FIRST THING in a CLI (before any jax array work:
the runtime must initialize before the backend does). It is a no-op unless
multi-host is requested, so every CLI stays single-host-correct by default.
"""

from __future__ import annotations

import os

import jax

# Environment contract (all three must be set together for explicit
# configuration; clusters whose launcher JAX auto-detects can instead pass
# require=True with nothing set):
ENV_COORD = "MOJOSPLAT_COORDINATOR"  # e.g. "10.0.0.2:8476"
ENV_NPROC = "MOJOSPLAT_NUM_PROCESSES"
ENV_PID = "MOJOSPLAT_PROCESS_ID"


def init_multihost(require: bool = False) -> bool:
    """Initialize the JAX distributed runtime when configured; else no-op.

    Returns True when multi-host initialization ran. Resolution order:

      1. ``MOJOSPLAT_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``
         env vars -> explicit ``jax.distributed.initialize(coord, n, pid)``.
      2. ``require=True`` with none of them set -> bare
         ``jax.distributed.initialize()`` (JAX auto-detects coordinator and
         process topology where the cluster launcher tells it, e.g. SLURM).
      3. Nothing set, ``require=False`` -> no-op (single host), returns
         False.
    """
    # Empty strings (e.g. an unexpanded shell variable) count as unset so
    # validation fails with the intended message, not int('').
    coord = os.environ.get(ENV_COORD) or None
    nproc = os.environ.get(ENV_NPROC) or None
    pid = os.environ.get(ENV_PID) or None
    if coord or nproc or pid:
        if not (coord and nproc and pid):
            raise ValueError(
                f"set all three of {ENV_COORD}, {ENV_NPROC}, {ENV_PID} "
                f"(got coord={coord!r}, nproc={nproc!r}, pid={pid!r})"
            )
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(pid),
        )
        return True
    if require:
        jax.distributed.initialize()
        return True
    return False


def is_primary() -> bool:
    """True on the process that should print/log/checkpoint (process 0)."""
    return jax.process_index() == 0
