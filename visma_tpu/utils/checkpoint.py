"""Checkpoint / resume for filter, pipeline, and BA state.

The reference has no in-process checkpointing — its dataset files ARE the
checkpoint (SURVEY.md §5). Here both idioms exist:

* `save_state`/`load_state`: orbax-backed pytree checkpoints of live state
  (FilterState, PipelineState, BaProblem — anything tree-mappable), the
  production recovery path (periodic snapshot every K frames; on host
  failure, restart and resume from the last snapshot);
* `export_packets` (visma_tpu.pipeline) writes the reference-compatible
  dataset file, the interop checkpoint.

Falls back to a numpy .npz container when orbax is unavailable or cannot
store the tree.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np


def _tree_to_flat(tree) -> Tuple[dict, Any]:
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    flat = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    return flat, treedef


def save_state(path: str, tree, step: int = 0) -> None:
    """Snapshot a pytree to `path` (directory): orbax when it is installed
    and every leaf is non-empty (orbax refuses zero-size arrays, such as
    the SLAM slots of a filter with num_slam=0), else npz."""
    import jax

    os.makedirs(path, exist_ok=True)
    host_tree = jax.tree.map(lambda x: np.asarray(x), tree)
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        ocp = None
    if ocp is not None and all(
            x.size for x in jax.tree_util.tree_leaves(host_tree)):
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.join(os.path.abspath(path), f"step_{step}"),
                   host_tree, force=True)
        ckptr.wait_until_finished()
    else:
        flat, _ = _tree_to_flat(host_tree)
        np.savez(os.path.join(path, f"step_{step}.npz"), **flat)
    with open(os.path.join(path, "latest.json"), "w") as fp:
        json.dump({"step": step}, fp)


def latest_step(path: str) -> int:
    with open(os.path.join(path, "latest.json")) as fp:
        return int(json.load(fp)["step"])


def load_state(path: str, template, step: int = None):
    """Restore into the structure of `template` (same pytree shape)."""
    import jax

    if step is None:
        step = latest_step(path)
    orbax_path = os.path.join(os.path.abspath(path), f"step_{step}")
    npz_path = os.path.join(path, f"step_{step}.npz")
    if os.path.isdir(orbax_path):
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        host_template = jax.tree.map(lambda x: np.asarray(x), template)
        restored = ckptr.restore(orbax_path, target=host_template)
        return jax.tree.map(lambda _, r: jax.numpy.asarray(r), template,
                            restored)
    data = np.load(npz_path)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    new_leaves = [jax.numpy.asarray(data[f"leaf_{i}"])
                  for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
