"""Checkpoint and resume of inverse-rendering training.

The counterpart of ``quadray_tpu.parallel.checkpoint`` for the training
triple (step, params, Adam state) as one numpy ``.npz``. Arrays are stored
under their names (``params.<field>``, ``opt.mu.<field>``,
``opt.nu.<field>``, ``opt.count``, ``__step__``), so loading needs no
template of the structure. The path tracer's accumulation planes are not
checkpointed yet (the path tracer is not ported).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from quadray_tpu_torch.parallel.train import (
    AdamState, Params, opt_state_from_numpy, opt_state_to_numpy,
    params_from_numpy, params_to_numpy)


def save_checkpoint(path: str, step: int, params: Params,
                    opt_state: AdamState) -> str:
    """Write a checkpoint; returns the file path. ``path`` may be a
    directory (a step-numbered file is created inside) or a .npz file."""
    count, mu, nu = opt_state_to_numpy(opt_state)
    arrays = {"__step__": np.asarray(step, np.int64), "opt.count": count}
    for prefix, tree in (("params", params_to_numpy(params)),
                         ("opt.mu", mu), ("opt.nu", nu)):
        arrays.update({f"{prefix}.{k}": v for k, v in tree.items()})
    if os.path.isdir(path) or not path.endswith(".npz"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(path, **arrays)
    return path


def latest_checkpoint(directory: str) -> str:
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, files[-1])


def load_checkpoint(path: str, device="cuda") -> Tuple[int, Params,
                                                      AdamState]:
    """Restore (step, params, opt_state) onto ``device``; ``path`` may be
    a checkpoint directory (its latest file is read)."""
    if os.path.isdir(path):
        path = latest_checkpoint(path)
    with np.load(path) as data:
        def tree(prefix):
            n = len(prefix) + 1
            return {k[n:]: data[k] for k in data.files
                    if k.startswith(prefix + ".")}
        step = int(data["__step__"])
        params = params_from_numpy(tree("params"), device)
        opt_state = opt_state_from_numpy(
            (data["opt.count"], tree("opt.mu"), tree("opt.nu")), device)
    return step, params, opt_state
