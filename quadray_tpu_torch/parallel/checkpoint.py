"""Checkpoint and resume of inverse-rendering training and of a
progressive path-traced render.

The counterpart of ``quadray_tpu.parallel.checkpoint``: the training
triple (step, params, Adam state) and, optionally, the path tracer's
accumulation state (``Scene.pt_state``: the running sum, the per-pixel
LCG seeds and the sample count) as one numpy ``.npz``. Arrays are stored
under their names (``params.<field>``, ``opt.mu.<field>``,
``opt.nu.<field>``, ``opt.count``, ``pt.acc``, ``pt.seeds``,
``pt.samples``, ``__step__``), so loading needs no template of the
structure. A checkpoint of the JAX package does not load here: it stores
its arrays as ``leaf_{i}``, in the order of jax's flattening of the
template it was saved with, and carries no names; read it with that
package and hand its arrays to ``params_from_numpy`` and
``opt_state_from_numpy``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from quadray_tpu_torch.parallel.train import (
    AdamState, Params, opt_state_from_numpy, opt_state_to_numpy,
    params_from_numpy, params_to_numpy)


def save_checkpoint(path: str, step: int, params: Optional[Params],
                    opt_state: Optional[AdamState],
                    pt_state: Optional[dict] = None) -> str:
    """Write a checkpoint; returns the file path. ``path`` may be a
    directory (a step-numbered file is created inside) or a .npz file.
    params or opt_state may be None (a render's checkpoint); pt_state is
    ``Scene.pt_state()``'s dict or None."""
    arrays = {"__step__": np.asarray(step, np.int64)}
    trees = [] if params is None else [("params", params_to_numpy(params))]
    if opt_state is not None:
        count, mu, nu = opt_state_to_numpy(opt_state)
        arrays["opt.count"] = count
        trees += [("opt.mu", mu), ("opt.nu", nu)]
    for prefix, tree in trees:
        arrays.update({f"{prefix}.{k}": v for k, v in tree.items()})
    if pt_state is not None:
        arrays["pt.acc"] = pt_state["acc"].detach().cpu().numpy()
        arrays["pt.seeds"] = pt_state["seeds"].detach().cpu().numpy()
        arrays["pt.samples"] = np.asarray(pt_state["samples"], np.int64)
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


def load_checkpoint(path: str, device="cuda", with_pt: bool = False):
    """Restore (step, params, opt_state) onto ``device``, and with
    ``with_pt`` also the path tracer's state (``Scene.set_pt_state``'s
    dict, None if the checkpoint has none) as a fourth value; ``path``
    may be a checkpoint directory (its latest file is read). params is
    {} and opt_state None where the checkpoint holds none."""
    if os.path.isdir(path):
        path = latest_checkpoint(path)
    with np.load(path) as data:
        def tree(prefix):
            n = len(prefix) + 1
            return {k[n:]: data[k] for k in data.files
                    if k.startswith(prefix + ".")}
        step = int(data["__step__"])
        params = params_from_numpy(tree("params"), device)
        opt_state = None
        if "opt.count" in data.files:
            opt_state = opt_state_from_numpy(
                (data["opt.count"], tree("opt.mu"), tree("opt.nu")), device)
        pt_state = None
        if "pt.acc" in data.files:
            pt_state = dict(
                acc=torch.from_numpy(data["pt.acc"]).to(device),
                seeds=torch.from_numpy(data["pt.seeds"]).to(device),
                samples=int(data["pt.samples"]))
    if with_pt:
        return step, params, opt_state, pt_state
    return step, params, opt_state
