"""The scene update's kernel (``csrc/update.cu``): its host side and its
plain version.

The counterpart of the JAX engine's per-frame update under ``_update_jit``
(``quadray_tpu/engine.py:195``, over ``_compile_scene_impl``,
``quadray_tpu/scene/compile.py:635``): a later frame's transform-dependent
fields (``scene.compile.MOVED_GROUPS``) from the moving nodes' local
transforms, bit for bit ``SceneStructure.moved_fields``, its plain version.
``update_tables`` puts a structure's plan (``SceneStructure.plan``, the
static nodes' matrices and the bounded surfaces' boxes) on its device
once; ``launch`` writes the fields of the groups it is given outputs for,
from the staged values (``SceneStructure.local_inputs``: each moving
node's scale, position, and the cos and sin of its angles, evaluated on
the host in float64, as the plain version does); the interactive frame's
CUDA graph captures it (``ops.graphs.InteractiveProgram``);
``moved_fields`` is the eager update's launch, into new tensors.

On CUDA tensors ``launch`` launches the kernel (``launches`` counts the
calls) or raises; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from quadray_tpu_torch.ops.cuda_kernel import _check
from quadray_tpu_torch.scene.compile import MOVED_GROUPS

F32 = torch.float32
I32 = torch.int32
THREADS = 256   # csrc/update.cu THREADS: the launch's one block
IN_W = 12       # a moving node's staged values

# calls of the kernel
launches = 0


class UpdateTables(NamedTuple):
    """A structure's plan on a device (``update_tables``)."""
    l_static: torch.Tensor     # (nn, 16) f32
    w_static: torch.Tensor     # (nn + 1, 16) f32
    lv_start: torch.Tensor     # (nlev + 1,) i32
    par: torch.Tensor          # (nq,) i32
    src: torch.Tensor          # (nq,) i32
    surf: torch.Tensor         # (nsurf,) i32
    light: torch.Tensor        # (nlight,) i32
    box: torch.Tensor          # (nsurf,) i32
    box_ctr: torch.Tensor      # (nbox, 3) f32
    box_corners: torch.Tensor  # (nbox, 8, 3) f32
    cam: int
    nd: int                    # moving nodes (rows of the staged values)
    nq: int                    # scratch rows


def update_tables(st, device) -> UpdateTables:
    """The structure's plan and static tables on ``device``, uploaded
    once (``structure_pass`` keeps them as ``st.tables``)."""
    dev = torch.device(device)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(dev)
    i32 = lambda k: torch.from_numpy(st.plan[k]).to(dev)
    nn = st.L_static.shape[0]
    return UpdateTables(
        f32(st.L_static.reshape(nn, 16)),
        f32(st.W_static.reshape(nn + 1, 16)),
        i32("lv_start"), i32("par"), i32("src"), i32("surf"), i32("light"),
        i32("box"), f32(st.box_ctr), f32(st.box_corners),
        int(st.plan["cam"]), len(st.dyn), int(st.n_scratch))


def field_shapes(st, groups) -> Dict[str, tuple]:
    """The shapes of the fields of ``groups``, in MOVED_GROUPS order."""
    shapes = {"s_pos": (st.ns, 3), "s_inv": (st.ns, 3, 3),
              "s_fwd": (st.ns, 3, 3), "s_bsph": (st.ns, 4),
              "l_pos": (st.nl, 3)}
    return {k: shapes.get(k, (3,)) for g in MOVED_GROUPS if g in groups
            for k in MOVED_GROUPS[g]}


def groups_of(outs) -> tuple:
    """The groups whose every field ``outs`` holds; raises where it holds
    part of a group."""
    groups = tuple(g for g in MOVED_GROUPS if MOVED_GROUPS[g][0] in outs)
    if set(outs) != {k for g in groups for k in MOVED_GROUPS[g]}:
        raise ValueError(f"update: the outputs {sorted(outs)} are not whole "
                         f"groups of {dict(MOVED_GROUPS)}")
    return groups


# csrc/update.cu UpdateArgs: its pointers in its order, then its ints
_POINTERS = ("local", "l_static", "w_static", "lv_start", "par", "src",
             "surf", "light", "box", "box_ctr", "box_corners", "w", "s_pos",
             "s_inv", "s_fwd", "s_bsph", "l_pos", "cam_pos", "cam_hor",
             "cam_ver", "cam_nrm")
_INTS = ("cam", "nlev", "nsurf", "ns", "nlight", "nl")


class _UpdateArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int) for k in _INTS])


def update_args(st, local: torch.Tensor, scratch: torch.Tensor,
                outs: Dict[str, torch.Tensor]) -> _UpdateArgs:
    """csrc/update.cu's UpdateArgs for the structure's tables (on the
    launch's device), the staged values ``local`` (nd, 12), the scratch
    (nq, 16) and the outputs of whole groups (``field_shapes``), each
    checked (device, type, shape, contiguity)."""
    tab, dev = st.tables, local.device
    if tab.par.device != dev:
        raise ValueError(f"update: the structure's tables are on "
                         f"{tab.par.device}, the launch on {dev}")
    _check("local", local, F32, (tab.nd, IN_W), dev)
    _check("scratch", scratch, F32, (tab.nq, 16), dev)
    for k, shape in field_shapes(st, groups_of(outs)).items():
        _check(k, outs[k], F32, shape, dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    ptrs = dict(local=local, w=scratch, **outs,
                **{k: getattr(tab, k) for k in _POINTERS[1:11]})
    return _UpdateArgs(*(ptr(ptrs.get(k)) for k in _POINTERS), tab.cam,
                       tab.lv_start.shape[0] - 1, tab.surf.shape[0], st.ns,
                       tab.light.shape[0], st.nl)


def _lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("update")
    if lib.update_launch.argtypes is None:
        lib.update_launch.argtypes = [ctypes.POINTER(_UpdateArgs),
                                      ctypes.c_void_p]
        lib.update_launch.restype = ctypes.c_int
    return lib


def plain(st, local: torch.Tensor, groups) -> Dict[str, torch.Tensor]:
    """The kernel's plain version: ``SceneStructure.fields_from_inputs``
    on the staged values, as CPU tensors."""
    out = st.fields_from_inputs(groups, local.numpy())
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def launch(st, local: torch.Tensor, outs: Dict[str, torch.Tensor],
           scratch: torch.Tensor = None):
    """Writes the fields of the groups ``outs`` holds (whole groups, in
    place) from the staged values ``local``. On a CUDA device one launch
    of csrc/update.cu on the current stream, no wait (a CUDA graph may
    capture it); on the CPU the plain version."""
    global launches
    dev = local.device
    if dev.type == "cpu":
        for k, v in plain(st, local, groups_of(outs)).items():
            outs[k].copy_(v.view(outs[k].shape))
        return
    if dev.type != "cuda":
        raise ValueError(f"update: unsupported device {dev}")
    if scratch is None:
        scratch = torch.empty((st.tables.nq, 16), dtype=F32, device=dev)
    args = update_args(st, local, scratch, outs)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.update_launch(ctypes.byref(args),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"update kernel launch failed: CUDA error {err}")
    launches += 1


def moved_fields(st, groups, inp: np.ndarray) -> Dict[str, torch.Tensor]:
    """The fields of ``groups`` as new tensors on the structure's card:
    the staged values ``inp`` (``local_inputs``) in one pinned copy, then
    one launch into views of one new buffer."""
    dev = st.device
    host = torch.empty((st.tables.nd, IN_W), dtype=F32,
                       pin_memory=dev.type == "cuda")
    host.numpy()[...] = inp
    local = host.to(dev, non_blocking=True)
    shapes = field_shapes(st, groups)
    buf = torch.empty((sum(int(np.prod(s)) for s in shapes.values()),),
                      dtype=F32, device=dev)
    outs, o = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        outs[k] = buf[o:o + n].view(s)
        o += n
    launch(st, local, outs)
    return outs
