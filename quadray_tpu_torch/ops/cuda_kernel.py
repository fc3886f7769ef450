"""Host side of the CUDA Whitted megakernel (``csrc/whitted.cu``).

The counterpart of the host half of ``quadray_tpu.ops.pallas_kernel``:
the static scene structure (``KernelStruct``/``scene_struct``, which
permutes surfaces into contiguous classes with shadow blockers first), the
packed scene tables the kernel reads (``pack_scene``, one part a table,
on the card any subset of the parts in one launch of ``csrc/pack.cu``,
``pack_parts``; ``_get_packed`` re-packs only the parts whose fields are
new), the launch wrapper ``trace_rays_cuda`` with ``render_cuda`` around
it, the
path-record wrappers ``trace_paths`` / ``trace_paths_with_struct``
(counterparts of ``pallas_kernel.py:2296, 2475``) that trace-replay
training calls, and the path-tracing wrappers ``trace_pt_cuda`` /
``render_pt_cuda`` (counterparts of ``trace_pt_pallas`` and
``render_pt_pallas``, ``pallas_kernel.py:2349, 2450``), and two-round
retirement: ``trace_rays_emit_cuda`` / ``trace_rays_resume_cuda`` around
the kernel's EMIT and RESUME modes, ``compact_active`` between them and
the driver ``trace_rays_rounds`` (the counterpart of
``trace_rays_pallas_rounds``, ``_trace_rounds_impl`` and
``_trace_wavefront_impl``, ``pallas_kernel.py:2756, 2614, 2647``).
``launch_whitted`` and ``launch_pt`` are the Whitted and PT launches on
given packed tables, which the interactive and pass programs of
``ops.graphs`` capture in CUDA graphs on their own copies of the tables.

Where the TPU kernel is compiled per scene structure, the CUDA kernel
takes the structure at run time (surface kind, singularity and clip count
from ``sp_i``, material property bits and texture addressing from
``mat_i``), so one build serves every scene. Bounding-sphere culling
reads the tables ``bsph_t``/``shad_msk``/``cont_msk`` (bitwise the JAX
package's; on the card written with the other parts by the pack's one
launch) and is switched per launch by ``cull_gates``, the one predicate
that the wrappers and the plain tracer both call.

Each wrapper on CPU tensors runs its plain version
(``ops.trace.trace_rays`` / ``trace_paths`` / ``trace_rays_emit`` /
``trace_rays_resume``, ``ops.pt.trace_pt``); on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from quadray_tpu_torch.scene.compile import (
    FIELDS, SceneArrays, PROP_LIGHT, PROP_OPAQUE, PROP_REFLECT,
    PROP_REFRACT, PROP_TEXTURE, PROP_FRESNEL, PROP_TRANSP, CLIP_NONE)
from quadray_tpu_torch.ops.trace import (
    ACTIVE_ROW, STATE_I32, STATE_ROWS, TraceConfig, _rsqrt, _sqrt,
    trace_paths as _trace_paths_plain, trace_rays, trace_rays_emit,
    trace_rays_resume)
from quadray_tpu_torch.ops.pt import pt_camera_rays, trace_pt

F32 = torch.float32
I32 = torch.int32
BIG = 1e30
LANES = 128       # texture atlas row width (texels)
# branch-stack slots a thread holds in local memory; a deeper stack (min(
# stack, max_segments) slots, since a ray pushes at most once a segment)
# goes to a device-memory scratch (stack_scratch)
MAX_STACK = 16
SLOT = 15         # values a branch-stack slot holds (csrc/whitted.cu SLOT)
MAX_PATH_LIGHTS = 16   # path records hold one bit per light in bits 16-31
# the PT kernel packs a stack slot's depth into 10 bits and its surface's
# original id into 20
PT_MAX_DEPTH = (1 << 10) - 1
PT_MAX_SURFACES = 1 << 20
# round-1 segment budgets of the TPU package's two-round drivers: the
# rounds driver (pallas_kernel.py:2803) and the wavefront driver (:2806).
# At ray granularity the two drivers are one, trace_rays_rounds.
ROUNDS_K1 = 4
WAVE_K1 = 1

PF = 44           # per-surface floats: pos 0-2, inv 3-11, sci 12-14,
#                   scjh 15-17, sciw 18, cmin 19-21, cmax 22-24, fwd 25-33,
#                   bounding sphere 34-37, PT emission outer/inner 38-43
CF = 22           # per-clip-entry floats
MF = 14           # per-material floats: col 0-2, dff/spc/pow 3-5,
#                   rfl/trn/rfr/ext 6-9, tex scl 10-11, tex off 12-13
LF = 10           # per-light floats
MI = 5            # per-material ints: props, tex base/xmask/ymask/xshift

# texel u8 -> f32 decode LUT, built with the same numpy f32 division as
# scene.compile._texture_array so kernel texels match tex_data bitwise
_TEX_LUT = (np.arange(256, dtype=np.float32) / 255.0).reshape(2, 128)


class PackedScene(NamedTuple):
    sp_f: torch.Tensor     # (NS, PF) f32, permuted by struct.perm
    sp_i: torch.Tensor     # (NS, 8) i32: kind, mo, mi, blk, sing, ncl,
    #                        origid, bounded
    cl_f: torch.Tensor     # (NS, NC*CF) f32 pre-gathered clip tables
    mat_f: torch.Tensor    # (NM, MF) f32
    lg_f: torch.Tensor     # (NL, LF) f32
    misc: torch.Tensor     # (8,) f32: amb_rgb, use_gamma, use_fresnel, pad
    tex_pk: torch.Tensor   # (G, 128) i32 texture atlas, u8 rgb packed
    tex_lut: torch.Tensor  # (2, 128) f32 u8 -> f32 texel decode LUT
    mat_i: torch.Tensor    # (NM, MI) i32: the per-material structure the
    #                        TPU kernel compiles in (KernelStruct.props/tex)
    bsph_t: torch.Tensor   # (4, 1, NSR*128) f32 bounding spheres of the
    #                        permuted rows, transposed: cx, cy, cz, radius
    #                        (+inf where unbounded)
    shad_msk: torch.Tensor  # (NS, max(1, NL*NW)) i32: bit b of word
    #                        (r, l*NW + w) says blocker 32w+b may shadow
    #                        receiver r from light l
    cont_msk: torch.Tensor  # (NS, 2*NW) i32: the surfaces a continuation
    #                        from row r may hit, words of side > 0 first


class Group(NamedTuple):
    """One contiguous class of surfaces in the permuted tables."""
    is_plane: bool
    has_sing: bool
    has_clips: bool
    start: int
    count: int       # all surfaces of the class
    n_block: int     # leading shadow blockers of the class


class KernelStruct(NamedTuple):
    """Static scene structure (fields as in the JAX package's)."""
    ns: int                 # padded table height
    nc: int                 # clip program width
    nm: int                 # real material count
    nl: int                 # real light count
    groups: tuple           # tuple[Group]
    perm: tuple             # permuted-row -> original surface id
    ncl: tuple              # per PERMUTED row: clip entries
    blk: tuple              # per PERMUTED row: blocker side bits
    props: tuple            # per material: property bits
    gamma_on: bool
    fres_on: bool
    any_cont: bool          # any material reflects or transmits
    can_push: bool          # any material can spawn BOTH branches
    tex: tuple              # per textured material: (mat_idx, base,
    #                         xmask, ymask, xshift)
    tex_rows: int           # texture table height G (128 texels per row)
    bnd: tuple              # per PERMUTED row: finite bounding sphere
    emis_rows: tuple        # (permuted_row, origid) of LIGHT-tagged rows

    @property
    def n_real(self) -> int:
        """Real (non-padding) surfaces: a prefix of the permuted rows."""
        return sum(g.count for g in self.groups)


# a culled launch walks the surfaces of warp masks in which lane w of a
# warp holds word w: at most 32 words of 32 surfaces; larger scenes run
# unculled
MAX_SURFACES = 32 * 32
# the fewest real surfaces a culled launch has: building a warp's masks
# costs about what a few surface tests do, and on the H100 culling lost
# on 9 of the 11 golden scenes of 3 to 8 surfaces and won on every one of
# 9 or more (chip_smoke.py H3, culling forced on every scene)
CULL_MIN_SURFACES = 9
# the same for the PT kernel, whose lanes test their own rays against the
# spheres and walk the surfaces they keep apart from each other: with
# culling forced on every golden scene (chip_smoke.py E6, one 800x480 pass
# at depth 10 on an H100, three runs), culled / unculled kernel ms was
# 1.04-1.44 on test03 (9 surfaces), 0.95-1.04 on test10 (11), 0.71-0.93
# on test11 (12), 0.58-0.65 on test12 (21) and 0.25-0.49 from 43 surfaces
# up; below 9 it ran from 0.70 (test02) to 1.29 (test01)
PT_CULL_MIN_SURFACES = 12
# the cooperative tail of the culled Whitted kernel (csrc/whitted.cu, the
# whitted_launch argument coop_max): a warp with at most this many rays
# left runs them one at a time on all 32 lanes; 0 never, 32 from the first
# segment (the same bits either way). On an H100 (scripts/ab_whitted.py
# --coop, the 10 golden scenes the gate culls, 800x480) the ten kernels
# took 4.3432 ms at 0, 4.3498 at 1, 4.3022 at 2, 4.3568 at 4 and 4.9409 at
# 8 (16 and 32 more): 2 gains on test13, demo01 and demo02, whose last
# rays scatter, and loses 2-3% where they stay together (test14, test16,
# demo03)
COOP_MAX_LIVE = 2
# two-round retirement's RESUME (csrc/whitted.cu, the whitted_resume_launch
# argument warp_max): up to this many survivors of round 1 run a warp each
# (resume_sparse), more run a thread each with per-ray masks; the kernel
# compares it with the survivor count on the device. The same bits either
# way; 0 forces a thread each, the ray count or more a warp each. From a
# sweep of phase F2's 19 single-branch golden scenes at 800x480 and k1 =
# 1 and 4 (chip_smoke.py phase I2; one run on an H100 80GB HBM3 at 700 W),
# the sums of the 38 resume device ms: 3.6787 at 0, 3.2812 at 1024, 2.8642
# at 4096, 2.8790 at 8192, 3.1281 at 32768 and 11.1999 at every ray. 4096
# and 8192 tie within the spread between runs (they differ only on
# test08's 4,148 survivors at k1 = 4), so the value stands for one to four
# waves of the ~2,100 warps of resume_sparse an H100 holds, not a measured
# optimum. A warp each wins where few survivors are scattered over the
# frame (test13's 1,002 at k1 = 4: 0.0438 ms against 0.2545 at 0)
RESUME_WARP_MAX = 4096
# the two-round modes' per-ray masks (csrc/whitted.cu nearest_own and
# occluded_own; the launch argument own_min of whitted_emit_launch and
# whitted_resume_launch, which the plain trace_rays_emit and
# trace_rays_resume read here too): a warp's mask that keeps more than
# this many surfaces is refined by each lane's own ray; one that keeps
# fewer, the lanes walk as it is. EMIT's later segments hold neighbouring
# camera rays, whose narrow masks their own tests seldom shrink; RESUME's
# dense mode holds survivors from all over the frame. Set from sweeps of
# 0, 8, 16, 32 and 64 (scripts/ab_whitted.py, the 10 culled golden scenes
# at 800x480 on an H100): the smallest sums of kernel ms. The main path's
# culled walk (whitted_launch) and the path records take EMIT's too: the
# same sweep of the main path's kernel gave 64 the smallest sum
# (ab_whitted.py --own-min)
EMIT_OWN_MIN_KEPT, RESUME_OWN_MIN_KEPT = 64, 0
# the main path's per-ray masks only in a launch of at most this many rays:
# a frame launched alone ends in a tail of few busy warps, whose walks the
# masks shorten, while a batch of frames keeps the card busy and pays the
# refinement on every ray. Set from one launch of 1, 2, 4, 8, 16 and 64
# frames at 800x480 on the 10 culled golden scenes, masks on against off
# (ab_whitted.py --frames, on an H100): the masks' sums 0.922, 0.966,
# 0.994, 1.009, 1.016 and 1.021 of the warp's masks alone
WHOLE_OWN_MAX_RAYS = 4 * 800 * 480
# the path-record kernel (csrc/whitted.cu paths_kernel, PATHS_SMEM there):
# each block of its persistent grid copies the scene tables it walks into
# its shared memory where they fit in this many bytes, so that two blocks
# an SM (what their registers allow) still fit in the SM's 228 KB; a scene
# whose tables do not fit runs the instantiation that reads them in
# device memory
PATHS_SMEM_BYTES = 112 * 1024
# the tables a block copies, in the kernel's order; their rows are the
# real surfaces, the materials and the active lights, and misc's 8 values
PATHS_TABLES = ("sp_f", "sp_i", "cl_f", "mat_f", "mat_i", "lg_f", "misc")


class PathsStaging(NamedTuple):
    """A block's plan for its shared memory (``paths_staging``)."""
    off: tuple     # byte offset of each of PATHS_TABLES (a multiple of 16;
    #                the mbarrier of the copies takes bytes 0-15)
    bytes: tuple   # its bytes (cl_f 0: it stays in device memory)
    total: int     # the dynamic shared memory a block takes


def paths_staging(struct: KernelStruct):
    """The shared-memory plan of the path-record kernel for the scene
    (csrc/whitted.cu ``paths_staging``, mirrored): None where the tables
    but cl_f do not fit in PATHS_SMEM_BYTES (the instantiation that reads
    device memory runs); cl_f goes in where it fits too."""
    ns = struct.n_real
    nbytes = [4 * ns * PF, 4 * ns * 8, 4 * ns * struct.nc * CF,
              4 * struct.nm * MF, 4 * struct.nm * MI, 4 * struct.nl * LF,
              4 * 8]
    pad = lambda b: -(-b // 16) * 16
    core = 16 + sum(pad(b) for k, b in enumerate(nbytes) if k != 2)
    if core > PATHS_SMEM_BYTES:
        return None
    if core + pad(nbytes[2]) > PATHS_SMEM_BYTES:
        nbytes[2] = 0
    off, at = [], 16
    for b in nbytes:
        off.append(at)
        at += pad(b)
    return PathsStaging(tuple(off), tuple(nbytes), at)


def whitted_instance(struct: KernelStruct, cfg, n: int) -> dict:
    """The instantiation of ``whole_kernel`` that ``whitted_launch`` runs
    for the scene, config and n rays (its own choice, mirrored): can_push,
    cull (the gate's), own (culled, per-ray masks after the camera
    segment, in a launch of at most WHOLE_OWN_MAX_RAYS rays) and deep
    (the branch stacks in a device-memory scratch: ``whitted_scratch``)."""
    cull = cull_gates(struct, cfg).flags != 0
    return dict(can_push=struct.can_push, cull=cull,
                own=cull and cfg.max_segments > 1
                and struct.n_real > EMIT_OWN_MIN_KEPT
                and n <= WHOLE_OWN_MAX_RAYS,
                deep=whitted_scratch(struct, cfg, n) is not None)


class CullGates(NamedTuple):
    """Which parts of bounding-sphere culling run (``cull_gates``)."""
    cull: bool    # reach masks of ray bundles against the bounding spheres
    lsort: bool   # shadow passes AND the receivers' shad_msk rows
    cont: bool    # nearest passes AND the previous hits' cont_msk rows

    @property
    def flags(self) -> int:
        """The kernel's Cfg.cull bits: 1 reach, 2 lsort, 4 cont."""
        return int(self.cull) | int(self.lsort) << 1 | int(self.cont) << 2


def cull_gates(struct: KernelStruct, cfg, pt: bool = False) -> CullGates:
    """The one gate of culling, for the CUDA kernel's modes and their
    plain versions (the TPU kernel's ``cull_on``/``lsort_on``/``cont_on``,
    pallas_kernel.py:524-539, and ``_static_gates`` :2182, without its
    chunk and candidate tiers). Culling needs bounding spheres and
    CULL_MIN_SURFACES (PT_CULL_MIN_SURFACES for the path tracer, ``pt``)
    to MAX_SURFACES real surfaces; the static masks only prune scenes of
    more than cfg.unroll surfaces, lsort needs lights, and cont needs a
    single-branch scene: a popped branch-stack ray does not come from the
    previous segment's hit. PT culls by reach alone, as the TPU kernel
    does (:532-539): it has no shadow pass, and a popped sibling does not
    come from the previous node's hit."""
    floor = PT_CULL_MIN_SURFACES if pt else CULL_MIN_SURFACES
    cull = bool(cfg.cull and any(struct.bnd)
                and floor <= struct.n_real <= MAX_SURFACES)
    big = cull and cfg.lsort and not pt and struct.n_real > cfg.unroll
    return CullGates(cull, big and struct.nl > 0,
                     big and not struct.can_push)


def _mat_blocks(props: np.ndarray) -> np.ndarray:
    """CHECK_SHAD blocker rule per material (tracer.cpp:549-589):
    emissive and unbent fully-transparent surfaces don't occlude."""
    return (((props & PROP_LIGHT) == 0)
            & ~(((props & PROP_TRANSP) != 0)
                & ((props & PROP_REFRACT) == 0)))


# the SceneArrays fields scene_struct reads (tex_data for its length only)
STRUCT_FIELDS = ("s_kind", "s_sing", "c_op", "m_props", "s_mat", "l_on",
                 "use_fresnel", "use_gamma", "m_tex_base", "m_tex_xmask",
                 "m_tex_ymask", "m_tex_xshift", "s_bnd", "tex_data")


def scene_struct(sc: SceneArrays) -> KernelStruct:
    """Extract the static structure (host-side numpy)."""
    h = {k: getattr(sc, k).detach().cpu().numpy()
         for k in STRUCT_FIELDS if k != "tex_data"}
    kind, sing, cop = h["s_kind"], h["s_sing"], h["c_op"]
    props, smat = h["m_props"], h["s_mat"]
    NS, NC = cop.shape

    nz = cop != CLIP_NONE
    ncl = np.where(nz.any(1), NC - np.argmax(nz[:, ::-1], axis=1), 0)
    mb = _mat_blocks(props)
    blk = mb[smat[:, 0]].astype(np.int32) + 2 * mb[smat[:, 1]].astype(
        np.int32)

    perm: list = []
    groups: list = []
    for is_plane in (True, False):
        for has_sing in ((False,) if is_plane else (False, True)):
            for has_clips in (False, True):
                sel = ((kind > 0)
                       & ((kind == 1) == is_plane)
                       & ((sing > 0) == has_sing)
                       & ((ncl > 0) == has_clips))
                ids = np.nonzero(sel)[0]
                if ids.size == 0:
                    continue
                blockers = ids[blk[ids] != 0]
                rest = ids[blk[ids] == 0]
                groups.append(Group(is_plane, has_sing, has_clips,
                                    len(perm), int(ids.size),
                                    int(blockers.size)))
                perm.extend(int(i) for i in blockers)
                perm.extend(int(i) for i in rest)
    # pad rows keep table height NS
    perm.extend(i for i in range(NS) if kind[i] == 0)
    perm_a = np.array(perm, np.int32)

    l_on = h["l_on"]
    nl = int(l_on.sum())
    # the kernel walks lights over the first nl table rows; compile_scene
    # guarantees active lights form a contiguous prefix
    assert np.all(l_on[:nl] == 1) and np.all(l_on[nl:] == 0), \
        "active lights must form a contiguous prefix of the light tables"
    any_cont = bool(np.any(((props & PROP_REFLECT) != 0)
                           | ((props & PROP_OPAQUE) == 0)))
    fres_on = bool(h["use_fresnel"] > 0)
    # both branches (reflect AND transmit) can fire only for materials with
    # trn>0 and a reflective term (rfl>0, or Fresnel moving trn*F into rfl)
    can_push = bool(np.any(
        ((props & PROP_OPAQUE) == 0)
        & (((props & PROP_REFLECT) != 0)
           | (fres_on & ((props & PROP_FRESNEL) != 0)))))
    t_base, t_xm = h["m_tex_base"], h["m_tex_xmask"]
    t_ym, t_xs = h["m_tex_ymask"], h["m_tex_xshift"]
    tex = tuple(
        (int(m), int(t_base[m]), int(t_xm[m]), int(t_ym[m]), int(t_xs[m]))
        for m in range(props.shape[0])
        if (props[m] & PROP_TEXTURE) and t_base[m] >= 0)
    g = -(-int(sc.tex_data.shape[0]) // LANES)
    tex_rows = max(8, (g + 7) & ~7)
    return KernelStruct(
        ns=NS, nc=NC, nm=int(props.shape[0]), nl=nl,
        groups=tuple(groups), perm=tuple(int(i) for i in perm_a),
        ncl=tuple(int(v) for v in ncl[perm_a]),
        blk=tuple(int(v) for v in blk[perm_a]),
        props=tuple(int(p) for p in props),
        gamma_on=bool(h["use_gamma"] > 0),
        fres_on=fres_on,
        any_cont=any_cont,
        can_push=can_push,
        tex=tex,
        tex_rows=tex_rows,
        bnd=tuple(int(v) for v in h["s_bnd"][perm_a]),
        emis_rows=tuple(
            (int(r), int(perm_a[r])) for r in range(NS)
            if kind[perm_a[r]] > 0
            and ((props[smat[perm_a[r], 0]] | props[smat[perm_a[r], 1]])
                 & PROP_LIGHT)))


class _SceneCache:
    """Bounded cache of ``fn(sc, *args)`` keyed on the identity of the
    SceneArrays fields it reads (``fields``, STRUCT_FIELDS for
    ``scene_struct``) and on the value of ``args`` (hashable), so a
    SceneArrays with any of those fields replaced misses and recomputes
    instead of reusing a stale value, and the frames of an incremental
    update, which move none of them, share one; LRU-bounded so animations
    don't retain every frame's entry."""

    def __init__(self, fn, fields: tuple = STRUCT_FIELDS, maxlen: int = 8):
        self._fn = fn
        self._fields = fields
        self._maxlen = maxlen
        self._entries = OrderedDict()

    def __call__(self, sc: SceneArrays, *args):
        leaves = [getattr(sc, k) for k in self._fields]
        key = tuple(id(x) for x in leaves) + args
        ent = self._entries.get(key)
        if ent is not None and all(a is b for a, b in zip(ent[0], leaves)):
            self._entries.move_to_end(key)
            return ent[1]
        val = self._fn(sc, *args)
        self._entries[key] = (leaves, val)
        while len(self._entries) > self._maxlen:
            self._entries.popitem(last=False)
        return val


_get_struct = _SceneCache(scene_struct)


def check_paths_struct(struct: KernelStruct) -> None:
    """The path-record kernel's preconditions (pallas_kernel.py:499, 504,
    2306): one linear chain per lane and one record bit per light."""
    if struct.can_push:
        raise ValueError("trace_paths requires a single-branch scene: a "
                         "material here can spawn both a reflection and a "
                         "transmission (can_push)")
    if struct.nl > MAX_PATH_LIGHTS:
        raise ValueError(f"trace_paths supports at most {MAX_PATH_LIGHTS} "
                         f"active lights, the scene has {struct.nl}")


class _StructTensors(NamedTuple):
    perm: torch.Tensor     # (NS,) i64
    blk: torch.Tensor      # (NS,) i32
    ncl: torch.Tensor      # (NS,) i32
    mat_i: torch.Tensor    # (NM, MI) i32
    tex_lut: torch.Tensor  # (2, 128) f32
    no_cull: tuple         # zeros in the shapes of bsph_t, shad_msk and
    #                        cont_msk, for launches that do not cull


_STRUCT_TENSORS: OrderedDict = OrderedDict()


def _struct_tensors(struct: KernelStruct, dev) -> _StructTensors:
    """The tables that depend on the structure alone, uploaded once per
    (structure, device): re-packing a scene every training step then
    makes no host-to-device copy, which would wait for the stream."""
    key = (struct, str(dev))
    ent = _STRUCT_TENSORS.get(key)
    if ent is not None:
        _STRUCT_TENSORS.move_to_end(key)
        return ent
    mat_i = np.zeros((struct.nm, MI), np.int32)
    mat_i[:, 0] = struct.props
    mat_i[:, 1] = -1
    for (m, base, xm, ym, xs) in struct.tex:
        mat_i[m, 1:] = (base, xm, ym, xs)
    i32 = lambda v: torch.tensor(v, dtype=I32, device=dev)
    NS, NW = struct.ns, -(-struct.ns // 32)
    ent = _StructTensors(
        torch.tensor(struct.perm, dtype=torch.long, device=dev),
        i32(struct.blk), i32(struct.ncl), torch.from_numpy(mat_i).to(dev),
        torch.from_numpy(_TEX_LUT.copy()).to(dev),
        (torch.zeros((4, 1, -(-NS // LANES) * LANES), dtype=F32, device=dev),
         torch.zeros((NS, max(1, struct.nl * NW)), dtype=I32, device=dev),
         torch.zeros((NS, 2 * NW), dtype=I32, device=dev)))
    _STRUCT_TENSORS[key] = ent
    while len(_STRUCT_TENSORS) > 8:
        _STRUCT_TENSORS.popitem(last=False)
    return ent


def _check_f32(sc: SceneArrays):
    for k in FIELDS:
        v = getattr(sc, k)
        if v.is_floating_point() and v.dtype != F32:
            raise ValueError(f"pack_scene: the CUDA kernels take f32 scenes, "
                             f"{k} is {v.dtype}")


# Each table the kernel reads is packed by its own function from the
# fields it reads (PACK_PARTS), so a frame re-packs only the tables whose
# fields moved (_get_packed). A part takes the device from the
# structure's tensors, never from a field it does not declare.

def _pack_sp_f(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    NS = sc.s_pos.shape[0]
    return torch.cat([
        sc.s_pos, sc.s_inv.reshape(NS, 9), sc.s_sci, sc.s_scjh,
        sc.s_sciw[:, None],
        torch.clamp(sc.s_cmin, -BIG, BIG), torch.clamp(sc.s_cmax, -BIG, BIG),
        sc.s_fwd.reshape(NS, 9), sc.s_bsph, sc.s_emis.reshape(NS, 6),
    ], dim=1).to(F32)[stt.perm].contiguous()


def _pack_sp_i(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    perm = stt.perm
    return torch.cat([
        sc.s_kind[perm][:, None], sc.s_mat[perm],
        stt.blk[:, None], sc.s_sing[perm][:, None],
        stt.ncl[:, None], perm.to(I32)[:, None],
        sc.s_bnd[perm][:, None]], dim=1).to(I32).contiguous()


def _pack_cl_f(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    NS, NC = sc.c_op.shape
    ref = torch.clamp(sc.c_ref, min=0).long()
    return torch.cat([
        sc.s_pos[ref], sc.s_inv[ref].reshape(NS, NC, 9), sc.s_sci[ref],
        sc.s_scjh[ref], sc.s_sciw[ref][..., None],
        sc.s_kind[ref][..., None].to(F32), sc.c_side[..., None],
        sc.c_op[..., None].to(F32),
    ], dim=2).to(F32)[stt.perm].reshape(NS, NC * CF).contiguous()


def _pack_mat_f(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    return torch.stack([
        sc.m_col[:, 0], sc.m_col[:, 1], sc.m_col[:, 2], sc.m_dff, sc.m_spc,
        sc.m_pow, sc.m_rfl, sc.m_trn, sc.m_rfr, sc.m_ext,
        sc.m_tex_scl[:, 0], sc.m_tex_scl[:, 1],
        sc.m_tex_off[:, 0], sc.m_tex_off[:, 1]], dim=1).contiguous()


def _pack_lg_f(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    return torch.cat([
        sc.l_pos, sc.l_col, sc.l_cnt[:, None], sc.l_lnr[:, None],
        sc.l_qdr[:, None], sc.l_on[:, None]], dim=1).to(F32).contiguous()


def _pack_misc(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    return torch.cat([sc.amb_col, sc.use_gamma[None], sc.use_fresnel[None],
                      torch.zeros((3,), dtype=F32, device=stt.perm.device)
                      ]).contiguous()


def _pack_tex_pk(sc: SceneArrays, struct: KernelStruct, stt) -> torch.Tensor:
    # the texture atlas packed for the kernel's gather: u8 rgb in one i32
    # per texel, 128 texels per row (tex_data is u8/255, so this is
    # lossless; the kernel decodes through the same-division LUT)
    G = struct.tex_rows
    k8 = torch.round(sc.tex_data * 255.0).to(I32)
    pk = (k8[:, 0] << 16) | (k8[:, 1] << 8) | k8[:, 2]
    return torch.cat([pk, torch.zeros((G * LANES - pk.shape[0],), dtype=I32,
                                      device=stt.perm.device)]) \
        .reshape(G, LANES).contiguous()


def _pack_bits(bits) -> torch.Tensor:
    """(R, C) bool -> (R, ceil(C/32)) i32 words, bit b of word w = column
    32w + b (the JAX package's shift-and-sum packing)."""
    R, C = bits.shape
    nw = -(-C // 32)
    b = torch.zeros((R, nw * 32), dtype=torch.int64, device=bits.device)
    b[:, :C] = bits.to(torch.int64)
    shift = torch.arange(nw * 32, device=bits.device) % 32
    w = (b << shift).reshape(R, nw, 32).sum(2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(I32)


# The culling tables bsph_t, shad_msk and cont_msk (pallas_kernel.py:346-
# 435) on the permuted rows, in the JAX package's f32 operations and order.

def _spheres(sc: SceneArrays, perm):
    """The permuted rows' bounding spheres: bounded flags, radii (+inf
    where unbounded) and centres."""
    bperm = sc.s_bsph[perm]
    bounded = sc.s_bnd[perm] > 0
    rs = torch.where(bounded, _sqrt(bperm[:, 3]), float("inf"))
    return bounded, rs, bperm[:, :3]


def _sum3(v):
    return v[..., 0] + v[..., 1] + v[..., 2]


def _bsph_t_plain(sc: SceneArrays, struct: KernelStruct,
                  stt) -> torch.Tensor:
    _, rs, cb = _spheres(sc, stt.perm)
    NS = cb.shape[0]
    nsl = -(-NS // LANES) * LANES
    bsph_t = torch.zeros((4, 1, nsl), dtype=F32, device=stt.perm.device)
    bsph_t[:, 0, :NS] = torch.stack([cb[:, 0], cb[:, 1], cb[:, 2], rs])
    return bsph_t


def _shad_msk_plain(sc: SceneArrays, struct: KernelStruct,
                    stt) -> torch.Tensor:
    # lsort analog (engine.cpp:2456-2757): blocker b can shadow receiver r
    # from light l only if b's sphere meets the capsule from l to r's
    # sphere; unbounded receivers and blockers keep every bit
    bounded, rs, cb = _spheres(sc, stt.perm)
    words = []
    for l in range(struct.nl):
        p = sc.l_pos[l]
        u = cb - p[None, :]                              # (NS, 3) receiver
        uu = torch.clamp(_sum3(u * u), min=1e-30)
        lc = cb[None, :, :] - p[None, None, :]           # (1, NS, 3)
        tp = torch.clamp(_sum3(lc * u[:, None, :]) / uu[:, None], 0.0, 1.0)
        q = lc - tp[..., None] * u[:, None, :]
        re = rs[:, None] + rs[None, :] + 1e-3
        occ = ~(_sum3(q * q) > re * re) | ~bounded[None, :]
        words.append(_pack_bits(occ))
    if not words:
        return torch.zeros((cb.shape[0], 1), dtype=I32,
                           device=stt.perm.device)
    return torch.cat(words, dim=1).contiguous()


def _cont_msk_plain(sc: SceneArrays, struct: KernelStruct,
                    stt) -> torch.Tensor:
    # lst_p analog (tracer.h:955-968): a ray reflected off a plane stays in
    # the closed halfspace of its hit side and a transmitted one crosses
    # it, so plane rows keep the surfaces whose sphere meets the
    # halfspaces their materials send rays into; curved rows and unbounded
    # targets keep everything, and materials that cannot continue nothing
    perm = stt.perm
    bounded, rs, cb = _spheres(sc, perm)
    nrm = sc.s_inv[perm][:, 2, :]
    nrm = nrm * _rsqrt(torch.clamp(_sum3(nrm * nrm), min=1e-30))[:, None]
    dvec = cb[None, :, :] - sc.s_pos[perm][:, None, :]
    signed = _sum3(dvec * nrm[:, None, :])
    distb = _sqrt(torch.clamp(_sum3(dvec * dvec), min=0.0))
    slack = rs[None, :] + 1e-3 + 1e-3 * distb
    h_pos = ~(signed < -slack)
    h_neg = ~(signed > slack)
    fres_s = sc.use_fresnel > 0
    plane = (sc.s_kind[perm] == 1)[:, None]
    sides = []
    for si in range(2):
        pm = sc.m_props[sc.s_mat[perm][:, si].long()]
        can_rfl = ((pm & PROP_REFLECT) != 0) | (fres_s & ((pm & PROP_OPAQUE)
                                                          == 0))
        can_trn = (pm & PROP_OPAQUE) == 0
        same, opp = (h_pos, h_neg) if si == 0 else (h_neg, h_pos)
        mk = (can_rfl[:, None] & same) | (can_trn[:, None] & opp)
        anyc = (can_rfl | can_trn)[:, None]
        mk = torch.where(plane, mk, anyc) | ~bounded[None, :]
        sides.append(_pack_bits(mk & anyc))
    return torch.cat(sides, dim=1).contiguous()


# the culling tables, in PackedScene order, and their plain versions
CULL_PARTS = ("bsph_t", "shad_msk", "cont_msk")
CULL_PLAIN = {"bsph_t": _bsph_t_plain, "shad_msk": _shad_msk_plain,
              "cont_msk": _cont_msk_plain}

_SPHERES = ("s_bsph", "s_bnd")
# (table, its plain version, the SceneArrays fields it reads), in
# PackedScene order, which is csrc/pack.cu's part order; on the card
# pack_parts writes any subset of them in one launch
PACK_PARTS = (
    ("sp_f", _pack_sp_f, ("s_pos", "s_inv", "s_sci", "s_scjh", "s_sciw",
                          "s_cmin", "s_cmax", "s_fwd", "s_bsph", "s_emis")),
    ("sp_i", _pack_sp_i, ("s_kind", "s_mat", "s_sing", "s_bnd")),
    ("cl_f", _pack_cl_f, ("c_ref", "c_side", "c_op", "s_pos", "s_inv",
                          "s_sci", "s_scjh", "s_sciw", "s_kind")),
    ("mat_f", _pack_mat_f, ("m_col", "m_dff", "m_spc", "m_pow", "m_rfl",
                            "m_trn", "m_rfr", "m_ext", "m_tex_scl",
                            "m_tex_off")),
    ("lg_f", _pack_lg_f, ("l_pos", "l_col", "l_cnt", "l_lnr", "l_qdr",
                          "l_on")),
    ("misc", _pack_misc, ("amb_col", "use_gamma", "use_fresnel")),
    ("tex_pk", _pack_tex_pk, ("tex_data",)),
    ("bsph_t", _bsph_t_plain, _SPHERES),
    ("shad_msk", _shad_msk_plain, _SPHERES + ("l_pos",)),
    ("cont_msk", _cont_msk_plain, _SPHERES + (
        "s_inv", "s_pos", "use_fresnel", "s_kind", "m_props", "s_mat")),
)
PART_NAMES = tuple(name for name, _, _ in PACK_PARTS)
_PART_FIELDS = {name: fields for name, _, fields in PACK_PARTS}
_PART_PLAIN = {name: fn for name, fn, _ in PACK_PARTS}
# launches of csrc/pack.cu (pack_launch), and those of them that wrote a
# culling table
pack_launches = 0
cull_launches = 0

# csrc/pack.cu PackArgs: the pointers, in its order, then the outputs, the
# parts' block ranges and thread counts, and the shapes
_PACK_STRUCT = ("perm", "blk", "ncl")
# each SceneArrays field the pack reads: its type and shape, in the
# dimensions ns (surface rows), nc (clip width), nm (materials), nlr
# (light rows) and ntex (texels)
_PACK_FIELDS = {
    "s_pos": (F32, ("ns", 3)), "s_inv": (F32, ("ns", 3, 3)),
    "s_sci": (F32, ("ns", 3)), "s_scjh": (F32, ("ns", 3)),
    "s_sciw": (F32, ("ns",)), "s_cmin": (F32, ("ns", 3)),
    "s_cmax": (F32, ("ns", 3)), "s_fwd": (F32, ("ns", 3, 3)),
    "s_bsph": (F32, ("ns", 4)), "s_emis": (F32, ("ns", 2, 3)),
    "s_kind": (I32, ("ns",)), "s_mat": (I32, ("ns", 2)),
    "s_sing": (I32, ("ns",)), "s_bnd": (I32, ("ns",)),
    "c_ref": (I32, ("ns", "nc")), "c_op": (I32, ("ns", "nc")),
    "c_side": (F32, ("ns", "nc")),
    "m_col": (F32, ("nm", 3)), "m_dff": (F32, ("nm",)),
    "m_spc": (F32, ("nm",)), "m_pow": (F32, ("nm",)),
    "m_rfl": (F32, ("nm",)), "m_trn": (F32, ("nm",)),
    "m_rfr": (F32, ("nm",)), "m_ext": (F32, ("nm",)),
    "m_tex_scl": (F32, ("nm", 2)), "m_tex_off": (F32, ("nm", 2)),
    "m_props": (I32, ("nm",)),
    "l_pos": (F32, ("nlr", 3)), "l_col": (F32, ("nlr", 3)),
    "l_cnt": (F32, ("nlr",)), "l_lnr": (F32, ("nlr",)),
    "l_qdr": (F32, ("nlr",)), "l_on": (F32, ("nlr",)),
    "amb_col": (F32, (3,)), "use_gamma": (F32, ()),
    "use_fresnel": (F32, ()), "tex_data": (F32, ("ntex", 3)),
}
_PACK_SHAPES = ("ns", "nc", "nm", "nlr", "nl", "ntex", "nsl", "nw")
_PACK_POINTERS = _PACK_STRUCT + tuple(_PACK_FIELDS)
PACK_THREADS = 128    # csrc/pack.cu THREADS
_N_PARTS = len(PART_NAMES)
_Pointers = ctypes.c_void_p * _N_PARTS


class _PackArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _PACK_POINTERS]
                + [("out", _Pointers),
                   ("start", ctypes.c_int * (_N_PARTS + 1)),
                   ("count", ctypes.c_int * _N_PARTS)]
                + [(k, ctypes.c_int) for k in _PACK_SHAPES])


class PackPlan(NamedTuple):
    """One launch's layout (``pack_plan``): the parts, their tables'
    shapes and types, the threads and blocks of each part, and the fields
    it reads."""
    names: tuple     # the parts, in PART_NAMES order
    shapes: dict     # name -> (shape, dtype) of its table
    count: tuple     # threads of each of the ten parts (0: not written)
    start: tuple     # block ranges: part p's are [start[p], start[p + 1])
    fields: tuple    # (field, its slot in _PACK_POINTERS, dtype, shape)
    #                  the launch reads
    tail: tuple      # PackArgs' start, count and shapes, as ctypes takes
    #                  them


_PLANS: dict = {}


def pack_plan(names, struct: KernelStruct, nlr: int, ntex: int) -> PackPlan:
    """The layout of one launch of ``names`` for the structure's shapes,
    ``nlr`` light rows and ``ntex`` texels: each part's table shape, a
    thread an element (sp_f, sp_i, cl_f, mat_f, lg_f, misc, tex_pk), a
    column (bsph_t) or an output word (shad_msk, cont_msk), and its blocks
    of PACK_THREADS, contiguous and in PART_NAMES order."""
    unknown = set(names) - set(PART_NAMES)
    if unknown:
        raise ValueError(f"pack: no part named {sorted(unknown)}")
    names = tuple(n for n in PART_NAMES if n in names)
    key = (names, struct.ns, struct.nc, struct.nm, struct.nl,
           struct.tex_rows, nlr, ntex)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    ns, nc, nm, nl = struct.ns, struct.nc, struct.nm, struct.nl
    nw, nsl = -(-ns // 32), -(-ns // LANES) * LANES
    dims = dict(ns=ns, nc=nc, nm=nm, nlr=nlr, nl=nl, ntex=ntex, nsl=nsl,
                nw=nw)
    if not 0 <= nl <= nlr or ntex > struct.tex_rows * LANES:
        raise ValueError(f"pack: {nl} active lights of {nlr} rows, {ntex} "
                         f"texels for {struct.tex_rows} rows of {LANES}")
    table = {"sp_f": ((ns, PF), F32, ns * PF),
             "sp_i": ((ns, 8), I32, ns * 8),
             "cl_f": ((ns, nc * CF), F32, ns * nc * CF),
             "mat_f": ((nm, MF), F32, nm * MF),
             "lg_f": ((nlr, LF), F32, nlr * LF),
             "misc": ((8,), F32, 8),
             "tex_pk": ((struct.tex_rows, LANES), I32,
                        struct.tex_rows * LANES),
             "bsph_t": ((4, 1, nsl), F32, nsl),
             "shad_msk": ((ns, max(1, nl * nw)), I32, ns * max(1, nl * nw)),
             "cont_msk": ((ns, 2 * nw), I32, ns * 2 * nw)}
    count = tuple(table[n][2] if n in names else 0 for n in PART_NAMES)
    start = [0]
    for c in count:
        start.append(start[-1] + -(-c // PACK_THREADS))
    read = dict.fromkeys(k for n in names for k in _PART_FIELDS[n])
    fields = tuple((k, _PACK_POINTERS.index(k), _PACK_FIELDS[k][0], tuple(
        dims[d] if isinstance(d, str) else d for d in _PACK_FIELDS[k][1]))
        for k in read)
    tail = ((ctypes.c_int * (_N_PARTS + 1))(*start),
            (ctypes.c_int * _N_PARTS)(*count),
            *(dims[k] for k in _PACK_SHAPES))
    plan = PackPlan(names, {n: table[n][:2] for n in names}, count,
                    tuple(start), fields, tail)
    _PLANS[key] = plan
    return plan


def _pack_lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("pack")
    if lib.pack_launch.argtypes is None:
        lib.pack_launch.argtypes = [ctypes.POINTER(_PackArgs),
                                    ctypes.c_void_p]
        lib.pack_launch.restype = ctypes.c_int
    return lib


def pack_args(plan: PackPlan, sc: SceneArrays, stt, dev,
              out: dict = None) -> tuple:
    """csrc/pack.cu's PackArgs for ``plan`` on the scene's fields, each
    checked (device, type, shape, contiguity), and the structure's tensors
    (``_struct_tensors``' for the structure, on ``dev``); and the tables
    it writes: ``out``'s (checked), or allocated with torch.empty on
    ``dev``."""
    if stt.perm.device != dev:
        raise ValueError(f"pack: the structure's tensors are on "
                         f"{stt.perm.device}, the launch on {dev}")
    ptrs = [None] * len(_PACK_POINTERS)
    ptrs[:3] = stt.perm.data_ptr(), stt.blk.data_ptr(), stt.ncl.data_ptr()
    for k, slot, dtype, shape in plan.fields:
        t = getattr(sc, k)
        if t.dtype != dtype or t.shape != shape or t.device != dev \
                or not t.is_contiguous():
            _check(k, t, dtype, shape, dev)
        ptrs[slot] = t.data_ptr()
    tables = {n: torch.empty(shape, dtype=dtype, device=dev)
              if out is None else out[n]
              for n, (shape, dtype) in plan.shapes.items()}
    if out is not None:
        for n, (shape, dtype) in plan.shapes.items():
            _check(n, tables[n], dtype, shape, dev)
    ptr_out = _Pointers(*(tables[n].data_ptr() if n in tables else None
                      for n in PART_NAMES))
    return _PackArgs(*ptrs, ptr_out, *plan.tail), tables


def pack_parts(names, sc: SceneArrays, struct: KernelStruct,
               stt, out: dict = None) -> dict:
    """The tables ``names`` (of PART_NAMES) by name, new tensors or, where
    ``out`` is given, its tables written in place (the interactive
    frame's program's). On a CUDA scene one launch of csrc/pack.cu writes
    all of them, bitwise their plain versions (PACK_PARTS), on the current
    stream without a wait (a CUDA graph may capture it); a CPU scene takes
    the plain versions. The device is that of the first field the first
    part reads."""
    global pack_launches, cull_launches
    if not names:
        return {}
    dev = getattr(sc, _PART_FIELDS[names[0]][0]).device
    if dev.type == "cpu":
        tables = {n: _PART_PLAIN[n](sc, struct, stt) for n in names}
        if out is None:
            return tables
        for n, t in tables.items():
            _check(n, out[n], t.dtype, tuple(t.shape), dev)
            out[n].copy_(t)
        return {n: out[n] for n in names}
    if dev.type != "cuda":
        raise ValueError(f"pack: unsupported device {dev}")
    plan = pack_plan(names, struct, sc.l_pos.shape[0],
                     sc.tex_data.shape[0])
    args, tables = pack_args(plan, sc, stt, dev, out)
    lib = _pack_lib()
    with torch.cuda.device(dev):
        err = lib.pack_launch(ctypes.byref(args),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {err}")
    pack_launches += 1
    cull_launches += any(n in CULL_PARTS for n in plan.names)
    return tables


def cull_table(name: str, sc: SceneArrays, struct: KernelStruct,
               stt) -> torch.Tensor:
    """One culling table (``name`` in CULL_PARTS) of the permuted rows:
    one launch of csrc/pack.cu on a CUDA scene, bitwise its plain version
    (CULL_PLAIN), which a CPU scene takes."""
    if name not in CULL_PARTS:
        raise ValueError(f"cull_table: {name} is not a culling table")
    return pack_parts((name,), sc, struct, stt)[name]


def _assemble(parts: dict, stt, cull: bool) -> PackedScene:
    return PackedScene(
        parts["sp_f"], parts["sp_i"], parts["cl_f"], parts["mat_f"],
        parts["lg_f"], parts["misc"], parts["tex_pk"], stt.tex_lut,
        stt.mat_i, *((parts[k] for k in CULL_PARTS) if cull
                     else stt.no_cull))


def _part_names(cull: bool) -> tuple:
    return PART_NAMES if cull else PART_NAMES[:-len(CULL_PARTS)]


def pack_scene(sc: SceneArrays, struct: KernelStruct,
               cull: bool = True) -> PackedScene:
    """The tables the Whitted kernel reads, on the scene's device; rows
    permuted by ``struct.perm`` (bitwise the JAX package's pack_scene for
    the tables both have), every part packed afresh: on the card one
    launch of csrc/pack.cu (``pack_parts``). ``cull`` False leaves the
    culling tables zero, for launches that do not cull (``cull_gates``).
    The kernels are f32 only: a scene with another float type (the fp64
    tier's) raises ValueError, never a silent down-cast."""
    _check_f32(sc)
    stt = _struct_tensors(struct, sc.device)
    return _assemble(pack_parts(_part_names(cull), sc, struct, stt), stt,
                     cull)


class _PackCache:
    """``pack_scene`` by parts (``parts``: PACK_PARTS, or entries of its
    form): a part is re-packed only when the structure, or a field it
    reads, is a new object, and kept otherwise, so a frame of the
    incremental update re-packs only the tables its moved fields feed (a
    camera-only frame none). The stale parts are written together, by one
    ``pack_parts`` call (``one_launch``: one launch on the card), or each
    by its own function. Each part's cache is LRU-bounded, as
    ``_SceneCache`` is."""

    def __init__(self, parts: tuple = PACK_PARTS, maxlen: int = 8,
                 one_launch: bool = True):
        self._def = parts
        self._maxlen = maxlen
        self._one_launch = one_launch
        self._parts = {name: OrderedDict() for name, _, _ in parts}

    def tables(self, sc: SceneArrays, struct: KernelStruct,
               cull: bool = True):
        """The parts by name (without the culling tables unless
        ``cull``), and the structure's tensors."""
        _check_f32(sc)
        stt = _struct_tensors(struct, sc.device)
        out, stale = {}, []
        for name, fn, fields in self._def:
            if not cull and name in CULL_PARTS:
                continue
            leaves = tuple(getattr(sc, k) for k in fields)
            key = (id(struct),) + tuple(map(id, leaves))
            # the entry holds the structure and the leaves its key names,
            # so no other object can have their ids: a hit is identity
            ent = self._parts[name].get(key)
            if ent is not None:
                self._parts[name].move_to_end(key)
                out[name] = ent[2]
            else:
                out[name] = None
                stale.append((name, fn, key, leaves))
        new = (pack_parts(tuple(s[0] for s in stale), sc, struct, stt)
               if self._one_launch else
               {name: fn(sc, struct, stt) for name, fn, _, _ in stale})
        for name, _, key, leaves in stale:
            cache = self._parts[name]
            cache[key] = (struct, leaves, new[name])
            out[name] = new[name]
            while len(cache) > self._maxlen:
                cache.popitem(last=False)
        return out, stt

    def __call__(self, sc: SceneArrays, struct: KernelStruct,
                 cull: bool = True) -> PackedScene:
        out, stt = self.tables(sc, struct, cull)
        return _assemble(out, stt, cull)


_get_packed = _PackCache()
# the plain tracer's culling tables (ops/trace.py Cull): their plain
# versions on every device, so that no kernel of csrc/pack.cu is shared by
# a kernel under test and the plain tracer it is held against
_get_cull_plain = _PackCache(tuple(
    part for part in PACK_PARTS if part[0] in CULL_PARTS), one_launch=False)

# kernel launches by trace_rays_cuda, by the path-record wrappers, by
# trace_pt_cuda and by the two rounds; a run that must have gone through a
# kernel reads its count before and after
launches = 0
paths_launches = 0
pt_launches = 0
emit_launches = 0
resume_launches = 0

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_SCENE_ARGS = [_VOIDP] * 12 + [_INT]   # sp_f ... cont_msk, rows
# the C entry points' arguments, in csrc/whitted.cu order
ARGTYPES = {
    "whitted_launch": ([_VOIDP] * 2 + _SCENE_ARGS + [_INT] * 7
                       + [ctypes.c_float, _INT, _INT, _VOIDP, _INT, _INT,
                          _INT, _INT, _VOIDP]),
    "whitted_paths_launch": ([_VOIDP] * 3 + _SCENE_ARGS + [_INT] * 6
                             + [ctypes.c_float, _INT, _VOIDP, _VOIDP, _INT,
                                _INT, _INT]),
    "whitted_pt_launch": ([_VOIDP] * 5 + _SCENE_ARGS + [_INT] * 5
                          + [_VOIDP, _INT]),
    "whitted_emit_launch": ([_VOIDP] * 3 + _SCENE_ARGS + [_INT] * 6
                            + [ctypes.c_float, _INT, _VOIDP, _INT, _INT]),
    "whitted_resume_launch": ([_VOIDP] * 4 + _SCENE_ARGS + [_INT] * 6
                              + [ctypes.c_float, _INT, _VOIDP, _INT, _INT,
                                 _INT]),
    "whitted_tape_launch": ([_VOIDP] * 4 + _SCENE_ARGS + [_INT] * 8
                            + [ctypes.c_float, _INT, _VOIDP, _VOIDP]),
}


def _lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("whitted")
    if lib.whitted_launch.argtypes is None:
        for fn, types in ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape {shape} on "
            f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stack_slots_held(cfg: TraceConfig) -> int:
    """The most branch-stack slots a ray holds: it pushes at most once a
    segment."""
    return min(cfg.stack, cfg.max_segments)


def stack_scratch(threads: int, cfg: TraceConfig, floats: int, dev, what):
    """A kernel's device-memory scratch for a stack past MAX_STACK slots:
    (threads, d, floats) f32, d = ``stack_slots_held(cfg)``, from the
    caching allocator (a CUDA graph's pool during a capture); None where
    the slots fit in local memory. Raises MemoryError, with the size,
    where it cannot be had."""
    d = stack_slots_held(cfg)
    if d <= MAX_STACK:
        return None
    try:
        return torch.empty((threads, d, floats), dtype=F32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(
            f"{what}: a branch stack of {d} slots needs "
            f"{4 * threads * d * floats} B of scratch on {dev}, which cannot "
            f"be had") from e


def whitted_scratch(struct: KernelStruct, cfg: TraceConfig, n: int):
    """What the Whitted modes (whole traces, path records, emit, resume)
    read of cfg's stack, as a pure function of the scene's structure: the
    shape (n, d, SLOT) of the device-memory scratch ``whole_kernel``'s
    branch stacks take for n rays where the scene can push and d =
    ``stack_slots_held(cfg)`` passes MAX_STACK, else None (a scene that
    cannot push reads no stack; MAX_STACK local slots hold the rest).
    ValueError for a stack below 1. Exact and Schlick Fresnel
    (cfg.schlick) are both taken, as the jnp tracer takes them."""
    if cfg.stack < 1:
        raise ValueError(f"cfg.stack must be >= 1, got {cfg.stack}")
    d = stack_slots_held(cfg)
    return (n, d, SLOT) if struct.can_push and d > MAX_STACK else None


def _launch_inputs(fn: str, sc: SceneArrays, org, dirs, t_min,
                   struct: KernelStruct, ps: PackedScene):
    """Checks what a CUDA launch takes; returns the (7, N) SoA rays (ox oy
    oz dx dy dz tmin, caller order) and the scene-table pointers."""
    dev = dirs.device
    _check_device(fn, sc, dev)
    N = dirs.shape[0]
    for name, t, shapes in (("org", org, ((3,), (N, 3))),
                            ("dirs", dirs, ((N, 3),)),
                            ("t_min", t_min, ((N,),))):
        if t.device != dev or t.dtype != F32 or tuple(t.shape) not in shapes:
            raise ValueError(f"{name}: need f32 of shape {shapes} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    tables = _scene_tables(sc, struct, ps, dev)
    rays = torch.empty((7, N), dtype=F32, device=dev)
    with torch.no_grad():
        rays[0:3] = (org[:, None] if org.dim() == 1 else org.T)
        rays[3:6] = dirs.T
        rays[6] = t_min
    return rays, tables


def _check_device(fn: str, sc: SceneArrays, dev):
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if sc.device != dev:
        raise ValueError(f"scene on {sc.device}, rays on {dev}")


def _scene_tables(sc: SceneArrays, struct: KernelStruct, ps: PackedScene,
                  dev) -> tuple:
    """Checks the packed tables; returns their pointers in launch order
    and the table height."""
    NS, NM = struct.ns, struct.nm
    NW = -(-NS // 32)
    for name, t, dtype, shape in (
            ("sp_f", ps.sp_f, F32, (NS, PF)),
            ("sp_i", ps.sp_i, I32, (NS, 8)),
            ("cl_f", ps.cl_f, F32, (NS, struct.nc * CF)),
            ("mat_f", ps.mat_f, F32, (NM, MF)),
            ("mat_i", ps.mat_i, I32, (NM, MI)),
            ("lg_f", ps.lg_f, F32, (sc.l_pos.shape[0], LF)),
            ("misc", ps.misc, F32, (8,)),
            ("tex_pk", ps.tex_pk, I32, (struct.tex_rows, LANES)),
            ("tex_lut", ps.tex_lut, F32, (2, LANES)),
            ("bsph_t", ps.bsph_t, F32, (4, 1, -(-NS // LANES) * LANES)),
            ("shad_msk", ps.shad_msk, I32, (NS, max(1, struct.nl * NW))),
            ("cont_msk", ps.cont_msk, I32, (NS, 2 * NW))):
        _check(name, t, dtype, shape, dev)
    return (ps.sp_f.data_ptr(), ps.sp_i.data_ptr(), ps.cl_f.data_ptr(),
            ps.mat_f.data_ptr(), ps.mat_i.data_ptr(), ps.lg_f.data_ptr(),
            ps.misc.data_ptr(), ps.tex_pk.data_ptr(), ps.tex_lut.data_ptr(),
            ps.bsph_t.data_ptr(), ps.shad_msk.data_ptr(),
            ps.cont_msk.data_ptr(), NS)


def trace_rays_cuda(sc: SceneArrays, org, dirs, t_min,
                    cfg: TraceConfig = TraceConfig(),
                    struct: KernelStruct = None) -> torch.Tensor:
    """Trace N rays to completion through the CUDA kernel; returns (N, 3)
    linear radiance. org (3,) or (N, 3), dirs (N, 3), t_min (N,), all
    f32 on the scene's device. A culled launch runs the cooperative tail
    from COOP_MAX_LIVE rays a warp, and, where it holds at most
    WHOLE_OWN_MAX_RAYS rays, refines the warp's masks after the camera
    segment by each ray's own (EMIT_OWN_MIN_KEPT). CPU tensors take the
    plain tracer."""
    _check_coop()
    if dirs.device.type == "cpu":
        return trace_rays(sc, org, dirs, t_min, cfg)
    struct = struct or _get_struct(sc)
    whitted_scratch(struct, cfg, 0)
    return launch_whitted(sc, struct, _get_packed(sc, struct), org, dirs,
                          t_min, cfg)


def _check_coop():
    if not 0 <= COOP_MAX_LIVE <= 32:
        raise ValueError(f"COOP_MAX_LIVE must be in 0..32, got "
                         f"{COOP_MAX_LIVE}")


def launch_whitted(sc: SceneArrays, struct: KernelStruct, ps: PackedScene,
                   org, dirs, t_min, cfg: TraceConfig) -> torch.Tensor:
    """``trace_rays_cuda`` on the packed tables ``ps`` (the scene's, or
    the interactive program's own: ``ops.graphs``): one Whitted launch on
    the current stream, which reads sc for its shapes and device only; a
    stack past MAX_STACK slots on a scene that can push takes a scratch
    from the caching allocator (``whitted_scratch``; in a capture, the
    graph's pool). CPU rays take the plain tracer, which reads sc and not
    ps."""
    global launches
    _check_coop()
    if dirs.device.type == "cpu":
        return trace_rays(sc, org, dirs, t_min, cfg)
    rays, tables = _launch_inputs("trace_rays_cuda", sc, org, dirs, t_min,
                                  struct, ps)
    N, dev = dirs.shape[0], dirs.device
    deep = None
    if whitted_scratch(struct, cfg, N) is not None:
        deep = stack_scratch(N, cfg, SLOT, dev, "trace_rays_cuda")
    out = torch.empty((3, N), dtype=F32, device=dev)
    if N == 0:
        return out.T
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_launch(
            rays.data_ptr(), out.data_ptr(), *tables,
            N, struct.n_real, struct.nc, struct.nl,
            cfg.depth, cfg.max_segments, cfg.stack,
            cfg.cutoff, int(struct.can_push),
            cull_gates(struct, cfg).flags, stream, COOP_MAX_LIVE,
            EMIT_OWN_MIN_KEPT, WHOLE_OWN_MAX_RAYS, int(cfg.schlick),
            None if deep is None else deep.data_ptr())
    if err != 0:
        raise RuntimeError(f"whitted kernel launch failed: CUDA error {err}")
    launches += 1
    return out.T


def trace_paths(sc: SceneArrays, org, dirs, t_min,
                cfg: TraceConfig = TraceConfig(), k_paths: int = 8):
    """Kernel forward that also returns the per-segment path records:
    (colors (N, 3) f32, paths (K, N) i32), K = k_paths, segments capped
    at K (record layout: ``ops.trace.trace_paths``). Single-branch scenes
    with at most 16 active lights (ValueError otherwise). Culled, the
    segments after the camera's refine the warp's masks by each ray's own
    (EMIT_OWN_MIN_KEPT). CPU tensors take the plain version."""
    return _paths(sc, _get_struct(sc), _get_packed, org, dirs, t_min, cfg,
                  k_paths)


def trace_paths_with_struct(sc: SceneArrays, struct: KernelStruct, org,
                            dirs, t_min, cfg: TraceConfig = TraceConfig(),
                            k_paths: int = 8):
    """trace_paths for a caller holding the scene's KernelStruct, which
    parameter updates cannot change: the training loop re-packs the scene
    from its current parameters every step. It traces unculled, whatever
    cfg.cull says: ``compile_scene`` made the bounding spheres (s_bsph)
    from the compiled surfaces, and a parameter update moves a surface
    without moving its sphere, so a culled walk could skip its hits.
    Nothing here is differentiable: the tables are packed and the kernel
    runs under ``torch.no_grad()``, the counterpart of the JAX
    ``stop_gradient`` on the scene (parallel/train.py:82)."""
    return _paths(sc, struct, lambda s, st: pack_scene(s, st, cull=False),
                  org, dirs, t_min, cfg._replace(cull=False), k_paths)


def _paths(sc, struct, pack, org, dirs, t_min, cfg, k_paths):
    global paths_launches
    check_paths_struct(struct)
    if k_paths < 1:
        raise ValueError(f"k_paths must be >= 1, got {k_paths}")
    with torch.no_grad():
        if dirs.device.type == "cpu":
            return _trace_paths_plain(sc, org, dirs, t_min, cfg, k_paths)
        whitted_scratch(struct, cfg, 0)
        ps = pack(sc, struct)
        rays, tables = _launch_inputs("trace_paths", sc, org, dirs, t_min,
                                      struct, ps)
        N, dev = dirs.shape[0], dirs.device
        out = torch.empty((3, N), dtype=F32, device=dev)
        paths = torch.empty((k_paths, N), dtype=I32, device=dev)
        if N == 0:
            return out.T, paths
        queue = torch.empty((1,), dtype=I32, device=dev)   # the work queue
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.whitted_paths_launch(
                rays.data_ptr(), out.data_ptr(), paths.data_ptr(), *tables,
                N, struct.n_real, struct.nc, struct.nl,
                cfg.depth, k_paths, cfg.cutoff,
                cull_gates(struct, cfg).flags, stream, queue.data_ptr(),
                struct.nm, EMIT_OWN_MIN_KEPT, int(cfg.schlick))
    if err != 0:
        raise RuntimeError(
            f"whitted paths kernel launch failed: CUDA error {err}")
    paths_launches += 1
    return out.T, paths


def render_cuda(sc: SceneArrays, width: int, height: int, fsaa: int = 1,
                cfg: TraceConfig = TraceConfig(),
                struct: KernelStruct = None) -> torch.Tensor:
    """Full frame through the kernel: ray gen -> kernel -> clip -> AA
    mean; returns (H, W, 3) linear radiance on the scene's device."""
    from quadray_tpu_torch.ops.rays import camera_rays, resolve_aa
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, width, height, fsaa)
    t_min = sc.cam_pov.expand(dirs.shape[0])
    cols = trace_rays_cuda(sc, org, dirs, t_min, cfg, struct)
    return resolve_aa(torch.clamp(cols, 0.0, 1.0), width, height, fsaa)


def trace_pt_cuda(sc: SceneArrays, org, dirs, t_min, seeds,
                  cfg: TraceConfig = TraceConfig(),
                  struct: KernelStruct = None):
    """One path-traced sample per ray through the CUDA kernel (the
    signature and returns of ``ops.pt.trace_pt``): (radiance (N, 3) f32,
    seeds (N,) int32, each advanced four draws per iteration of the call).
    org (3,) or (N, 3), dirs (N, 3), t_min (N,) f32 and seeds (N,) int32,
    all on the scene's device; reads cfg.depth, and cfg.cull through
    ``cull_gates`` (each node walks the surfaces its ray may reach). CPU
    tensors take the plain ``trace_pt``. Launches the PT kernel (a
    persistent grid that pulls the samples from a work queue) and its seed
    tail on the current stream without waiting for the card."""
    if dirs.device.type == "cpu":
        return trace_pt(sc, org, dirs, t_min, seeds, cfg)
    struct = struct or _get_struct(sc)
    return launch_pt(sc, struct, pt_tables(sc, struct, cfg), org, dirs,
                     t_min, seeds, cfg)


def pt_tables(sc: SceneArrays, struct: KernelStruct,
              cfg: TraceConfig) -> PackedScene:
    """The packed tables of a PT launch: the culling tables only where
    PT's gate culls (``cull_gates(..., pt=True)``)."""
    return _get_packed(sc, struct, cull_gates(struct, cfg, pt=True).cull)


def launch_pt(sc: SceneArrays, struct: KernelStruct, ps: PackedScene, org,
              dirs, t_min, seeds, cfg: TraceConfig):
    """``trace_pt_cuda`` on the packed tables ``ps`` (``pt_tables``'s, or
    a pass program's copies of them: ``ops.graphs``): the PT kernel and
    its seed tail on the current stream, which read sc for its shapes and
    device only. CPU rays take the plain ``trace_pt``, which reads sc and
    not ps."""
    global pt_launches
    if dirs.device.type == "cpu":
        return trace_pt(sc, org, dirs, t_min, seeds, cfg)
    if not 0 <= cfg.depth <= PT_MAX_DEPTH:
        raise ValueError(f"cfg.depth must be in 0..{PT_MAX_DEPTH}")
    if struct.ns > PT_MAX_SURFACES:
        raise ValueError(f"the PT kernel takes at most {PT_MAX_SURFACES} "
                         f"surfaces, got {struct.ns}")
    gates = cull_gates(struct, cfg, pt=True)
    rays, tables = _launch_inputs("trace_pt_cuda", sc, org, dirs, t_min,
                                  struct, ps)
    N, dev = dirs.shape[0], dirs.device
    _check("seeds", seeds, I32, (N,), dev)
    out = torch.empty((3, N), dtype=F32, device=dev)
    seeds_out = torch.empty((N,), dtype=I32, device=dev)
    iters = torch.empty((2,), dtype=I32, device=dev)   # M, work queue
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_pt_launch(
            rays.data_ptr(), seeds.data_ptr(), out.data_ptr(),
            seeds_out.data_ptr(), iters.data_ptr(), *tables,
            N, struct.n_real, struct.nc, struct.nl, cfg.depth, stream,
            gates.flags)
    if err != 0:
        raise RuntimeError(f"whitted PT kernel launch failed: CUDA error "
                           f"{err}")
    pt_launches += 1
    return out.T, seeds_out


def pt_passes(sc: SceneArrays, width: int, height: int, acc, seeds,
              passes: int, cfg: TraceConfig = TraceConfig(),
              struct: KernelStruct = None):
    """``passes`` path-traced passes added into a running sum, issued op
    by op: per pass, jittered primary rays on the seeds' device
    (``pt_camera_rays``), one ``trace_pt_cuda`` call and the sum, with no
    wait for the card. acc (W*H, 3) f32 and seeds (W*H,) int32; returns
    the new (acc, seeds). The pass loop of ``Scene.render_pt_pass`` on the
    CPU, and the eager yardstick of the pass programs that replay a pass
    on the card (``ops.graphs.PassProgram``)."""
    t_min = sc.cam_pov.expand(width * height)
    for _ in range(passes):
        org, dirs, seeds = pt_camera_rays(sc, width, height, seeds)
        rad, seeds = trace_pt_cuda(sc, org, dirs, t_min, seeds, cfg, struct)
        acc = acc + rad
    return acc, seeds


def render_pt_cuda(sc: SceneArrays, width: int, height: int, seeds,
                   spp: int, cfg: TraceConfig = TraceConfig(),
                   struct: KernelStruct = None):
    """spp passes from a zero sum (the counterpart of ``render_pt_pallas``,
    whose passes are one dispatch): on a CUDA device spp replays of a pass
    program's CUDA graph (``ops.graphs.pt_program``: one program a
    structure, frame size, config and device, the last few kept), on the
    CPU ``pt_passes``. Returns ((H, W, 3) mean radiance, the advanced
    (W*H,) int32 seeds), both the caller's: a later call writes neither."""
    if seeds.device.type == "cpu":
        acc = torch.zeros((width * height, 3), dtype=F32, device=seeds.device)
        acc, seeds = pt_passes(sc, width, height, acc, seeds, spp, cfg,
                               struct)
    else:
        from quadray_tpu_torch.ops.graphs import pt_program
        prog = pt_program(struct or _get_struct(sc), width, height, cfg,
                          seeds.device)
        acc, seeds = prog.passes(sc, None, seeds, spp)
        seeds = seeds.clone()
    return (acc / float(max(spp, 1))).reshape(height, width, 3), seeds


# ---- two-round retirement ---------------------------------------------------

def check_rounds_struct(struct: KernelStruct) -> None:
    """The emit and resume modes' precondition (pallas_kernel.py:498): no
    branch stack, so the state of a ray is one ray."""
    if struct.can_push:
        raise ValueError("two-round retirement requires a single-branch "
                         "scene: a material here can spawn both a "
                         "reflection and a transmission (can_push)")


def trace_rays_emit_cuda(sc: SceneArrays, org, dirs, t_min,
                         cfg: TraceConfig, k1: int,
                         struct: KernelStruct = None):
    """Round 1 through the kernel's EMIT mode (``ops.trace.trace_rays_emit``
    on CPU tensors): at most k1 segments per ray; returns (colors (N, 3),
    a transposed view of a (3, N) buffer, and the (21, N) f32 ray state,
    rows ``ops.trace.STATE_ROWS``). A culled launch bounds the camera
    segment by the warp's masks and the segments after it by per-ray
    masks within a warp's that keeps more than EMIT_OWN_MIN_KEPT
    surfaces. Single-branch scenes only."""
    global emit_launches
    _check_own_min()
    if dirs.device.type == "cpu":
        return trace_rays_emit(sc, org, dirs, t_min, cfg, k1)
    struct = struct or _get_struct(sc)
    whitted_scratch(struct, cfg, 0)
    check_rounds_struct(struct)
    if k1 < 1:
        raise ValueError(f"k1 must be >= 1, got {k1}")
    ps = _get_packed(sc, struct)
    rays, tables = _launch_inputs("trace_rays_emit_cuda", sc, org, dirs,
                                  t_min, struct, ps)
    N, dev = dirs.shape[0], dirs.device
    out = torch.empty((3, N), dtype=F32, device=dev)
    state = torch.empty((len(STATE_ROWS), N), dtype=F32, device=dev)
    if N == 0:
        return out.T, state
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_emit_launch(
            rays.data_ptr(), out.data_ptr(), state.data_ptr(), *tables,
            N, struct.n_real, struct.nc, struct.nl, cfg.depth, k1,
            cfg.cutoff, cull_gates(struct, cfg).flags, stream,
            EMIT_OWN_MIN_KEPT, int(cfg.schlick))
    if err != 0:
        raise RuntimeError(f"whitted emit kernel launch failed: CUDA error "
                           f"{err}")
    emit_launches += 1
    return out.T, state


def compact_active(state):
    """The rays still active in a (21, N) state, in ascending order, with
    plain torch ops on the state's device and no wait for it: (idx (N,)
    int32, count (1,) int32), idx[:count] the active rays. idx is the
    stable partition of 0..N-1, active rays first, so it is deterministic
    and holds every ray once."""
    N, dev = state.shape[1], state.device
    act = state[ACTIVE_ROW].view(I32) != 0
    pos = torch.cumsum(act, 0, dtype=I32)       # active rays up to i
    count = pos[-1:] if N else torch.zeros((1,), dtype=I32, device=dev)
    ar = torch.arange(N, dtype=I32, device=dev)
    # active ray i goes to pos[i] - 1, inactive ray i after every active
    # one, at count + (inactive rays before it)
    dest = torch.where(act, pos - 1, count + ar - pos)
    idx = torch.empty((N,), dtype=I32, device=dev)
    idx.scatter_(0, dest.long(), ar)
    return idx, count


def _check_own_min():
    for name, v in (("EMIT_OWN_MIN_KEPT", EMIT_OWN_MIN_KEPT),
                    ("RESUME_OWN_MIN_KEPT", RESUME_OWN_MIN_KEPT)):
        if not 0 <= v < 2**31:
            raise ValueError(f"{name} must be in 0..2**31-1, got {v}")


def resume_warp_max(struct: KernelStruct, n: int) -> int:
    """RESUME's switch for n rays (``whitted_resume_launch`` warp_max): up
    to this many survivors run a warp each. RESUME_WARP_MAX, at most n
    (so n or more: a warp per survivor always; 0: a thread each always),
    and 0 for a scene of more than MAX_SURFACES real surfaces, which the
    one-ray masks cannot hold. ValueError if RESUME_WARP_MAX < 0."""
    if RESUME_WARP_MAX < 0:
        raise ValueError(f"RESUME_WARP_MAX must be >= 0, got "
                         f"{RESUME_WARP_MAX}")
    return min(RESUME_WARP_MAX, n if struct.n_real <= MAX_SURFACES else 0)


def trace_rays_resume_cuda(sc: SceneArrays, state, cols, idx, count,
                           cfg: TraceConfig, k1: int,
                           struct: KernelStruct = None):
    """Round 2 through the kernel's RESUME mode: the rays idx[:count]
    (``compact_active``) of ``state`` (from ``trace_rays_emit_cuda`` with
    the same k1) run at most cfg.max_segments - k1 more segments, and
    their colors are written in place into ``cols``, the color buffer
    round 1 returned, which is returned. Up to RESUME_WARP_MAX
    (``resume_warp_max``) survivors run a warp each, more a thread each
    with per-ray masks (RESUME_OWN_MIN_KEPT); the kernel picks by the
    count on the device. CPU tensors take the plain
    ``ops.trace.trace_rays_resume``, which resumes every active ray (the
    same rays) and returns new colors. Single-branch scenes only."""
    global resume_launches
    struct = struct or _get_struct(sc)
    warp_max = resume_warp_max(struct, state.shape[1])
    _check_own_min()
    if state.device.type == "cpu":
        return trace_rays_resume(sc, state, cols, cfg, k1)
    whitted_scratch(struct, cfg, 0)
    check_rounds_struct(struct)
    segments = cfg.max_segments - k1
    if segments <= 0:
        return cols
    dev = state.device
    _check_device("trace_rays_resume_cuda", sc, dev)
    tables = _scene_tables(sc, struct, _get_packed(sc, struct), dev)
    N = state.shape[1]
    _check("state", state, F32, (len(STATE_ROWS), N), dev)
    _check("cols.T", cols.T, F32, (3, N), dev)
    _check("idx", idx, I32, (N,), dev)
    _check("count", count, I32, (1,), dev)
    if N == 0:
        return cols
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whitted_resume_launch(
            state.data_ptr(), idx.data_ptr(), count.data_ptr(),
            cols.data_ptr(), *tables, N, struct.n_real, struct.nc,
            struct.nl, cfg.depth, segments, cfg.cutoff,
            cull_gates(struct, cfg).flags, stream, warp_max,
            RESUME_OWN_MIN_KEPT, int(cfg.schlick))
    if err != 0:
        raise RuntimeError(f"whitted resume kernel launch failed: CUDA "
                           f"error {err}")
    resume_launches += 1
    return cols


def trace_rays_rounds(sc: SceneArrays, org, dirs, t_min,
                      cfg: TraceConfig = TraceConfig(), k1: int = ROUNDS_K1,
                      struct: KernelStruct = None) -> torch.Tensor:
    """Two-round retirement (``trace_rays_pallas_rounds``, pallas_kernel.py
    :2756, and the wavefront driver :2647): round 1 traces every ray for
    k1 segments and emits its state, the rays still active are compacted
    in ascending order, and round 2 finishes only them. Returns (N, 3)
    colors, bitwise those of ``trace_rays_cuda``. k1 = ROUNDS_K1 is the
    rounds driver's budget, WAVE_K1 the wavefront's. Nothing waits for the
    card between the rounds: the survivor count stays on the device, and
    round 2's grid covers every ray. A ``can_push`` scene takes the
    monolithic kernel (:2767); k1 >= cfg.max_segments returns round 1's
    colors. CPU tensors take the plain versions."""
    struct = struct or _get_struct(sc)
    if struct.can_push:
        return trace_rays_cuda(sc, org, dirs, t_min, cfg, struct)
    k1 = min(k1, cfg.max_segments)
    if k1 < 1:
        raise ValueError(f"k1 and cfg.max_segments must be >= 1, got k1="
                         f"{k1}, max_segments={cfg.max_segments}")
    cols, state = trace_rays_emit_cuda(sc, org, dirs, t_min, cfg, k1, struct)
    if cfg.max_segments - k1 <= 0:
        return cols
    idx, count = compact_active(state)
    return trace_rays_resume_cuda(sc, state, cols, idx, count, cfg, k1,
                                  struct)


def rounds_state_from_numpy(tiles, n: int, device="cuda") -> torch.Tensor:
    """The JAX package's 21 (R, 128) state tiles (``_trace_tiled_emit``'s
    outputs after the 3 color tiles; f32, and i32 in rows STATE_I32) as
    the port's (21, n) f32 state of their first n lanes."""
    if len(tiles) != len(STATE_ROWS):
        raise ValueError(f"need {len(STATE_ROWS)} state tiles, got "
                         f"{len(tiles)}")
    rows = [np.asarray(a, np.int32 if k in STATE_I32 else np.float32)
            .reshape(-1)[:n] for k, a in enumerate(tiles)]
    rows = [r.view(np.float32) for r in rows]
    return torch.from_numpy(np.stack(rows)).to(device)


def rounds_state_to_numpy(state, rows: int = None) -> list:
    """The port's (21, N) state as 21 (rows, 128) numpy tiles in the JAX
    package's dtypes (i32 rows STATE_I32); lanes past N are zero (retired).
    rows defaults to ceil(N / 128)."""
    s = state.detach().cpu().numpy()
    N = s.shape[1]
    rows = -(-N // LANES) if rows is None else rows
    out = []
    for k in range(len(STATE_ROWS)):
        v = s[k].view(np.int32) if k in STATE_I32 else s[k]
        t = np.zeros((rows * LANES,), v.dtype)
        t[:N] = v
        out.append(t.reshape(rows, LANES))
    return out
