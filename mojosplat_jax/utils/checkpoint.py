"""Orbax checkpointing of the gaussian parameter pytree / train state.

The reference has no checkpoint/resume of any kind (SURVEY.md section 5: its
only persisted artifact is the demo PNG, /root/reference/render_sample.py:
129-136). Training (train.py) makes persistence necessary; Orbax is JAX's
own choice (multi-host-safe, async-capable). It is an optional dependency
(the ``io`` extra).
"""

from __future__ import annotations

import os
from typing import Any

import jax


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save_checkpoint(path: str, state: Any) -> None:
    """Save a pytree (params dict or TrainState) to ``path``."""
    path = os.path.abspath(path)
    _checkpointer().save(path, jax.device_get(state))


def restore_checkpoint(path: str, like: Any | None = None) -> Any:
    """Restore a pytree saved by save_checkpoint.

    ``like`` (optional) provides the target structure/dtypes for restoration.
    """
    path = os.path.abspath(path)
    if like is not None:
        import orbax.checkpoint as ocp

        return _checkpointer().restore(
            path, item=jax.tree_util.tree_map(lambda x: x, like)
        )
    return _checkpointer().restore(path)
