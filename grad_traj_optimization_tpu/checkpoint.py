"""Checkpoint / resume for long batched runs.

The reference has no checkpointing (benchmark results are append-only
text files, compare2.cpp:219).  Here everything is a pytree, so saving
and restoring solver state is trivial; this module stores the leaves in
one NumPy ``.npz`` file for long Monte-Carlo runs (SURVEY.md section 5).
"""

from __future__ import annotations

import numpy as np
import jax


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree) -> str:
    """Save a pytree (Scenario/Solution batch, solver state, ...) as
    ``.npz``; returns the file written."""
    flat, _ = jax.tree_util.tree_flatten(tree)
    out = _npz_path(path)
    np.savez_compressed(
        out, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)}
    )
    return out


def restore(path: str, like):
    """Restore a pytree saved by :func:`save`; ``like`` provides the
    structure."""
    flat, treedef = jax.tree_util.tree_flatten(like)
    with np.load(_npz_path(path)) as npz:
        leaves = [npz[f"leaf_{i}"] for i in range(len(flat))]
    return jax.tree_util.tree_unflatten(treedef, leaves)
