"""Scene compiler: hierarchy -> flat static-shaped SoA tensors.

The PyTorch counterpart of ``quadray_tpu.scene.compile``: the same
hierarchy walk and relation pass (plain Python + numpy), and the same
numeric pass (transforms, inverses, quadric coefficients, bounding
spheres) written in torch. Every surface gets one uniform representation:
a canonical implicit ``F(p) = sum(sci*p^2) - 2*sum(scjh*p) - sciw`` plus an
affine world->canonical transform (pos + 3x3 linear); clip programs are
fixed-width padded op/ref/side tables.

The numeric pass runs on the CPU and the finished ``SceneArrays`` moves to
the scene's device in one hop (``SceneArrays.to``): it is hundreds of tiny
ops, which cost far more as kernel launches than as host arithmetic.

The incremental update (the counterpart of the JAX engine's jitted
per-frame pass) splits ``compile_scene`` in two: ``structure_pass`` walks
the hierarchy once and keeps every time-invariant field on the device;
``numeric_pass`` evaluates the animators and the camera on the host each
frame and recomputes only the transform-dependent fields
(``MOVED_FIELDS``): on a card in one launch of the scene update's kernel
(``ops.update``, ``csrc/update.cu``) from the moving nodes' values staged
in one copy, on the CPU through its plain version batched over nodes in
numpy (``SceneStructure.moved_fields``). Every element goes through the
scalar code's f32/f64 operations in the same order, so its fields are
``compile_scene``'s bit for bit.

f32 agreement with the JAX compiler: its small matmuls run as a chain of
fused multiply-adds from a zero accumulator, which ``_mm`` reproduces
(each step computed in float64, where the f32 product is exact, and
rounded once). sin/cos and sqrt go through float64 and round back, so they
are correctly rounded; JAX's CPU sin/cos are not always, so a transform
built from them may differ from JAX's by an ulp or two.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import operator
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from quadray_tpu_torch.scene import schema as S

F32 = torch.float32
I32 = torch.int32

# material property bits (analog of RT_PROP_*, tracer.h)
PROP_LIGHT = 1 << 0      # emissive, unshaded (RT_MAT_LIGHT)
PROP_METAL = 1 << 1      # metal specular blending (RT_MAT_METAL)
PROP_OPAQUE = 1 << 2     # trn == 0
PROP_REFLECT = 1 << 3    # rfl != 0
PROP_REFRACT = 1 << 4    # rfr != 1
PROP_DIFFUSE = 1 << 5
PROP_SPECULAR = 1 << 6
PROP_TEXTURE = 1 << 7
PROP_GAMMA = 1 << 8
PROP_FRESNEL = 1 << 9
PROP_TRANSP = 1 << 10    # trn == 1

# clip program opcodes
CLIP_NONE = 0
CLIP_SURF = 1      # AND with clipper keep-mask
CLIP_ENTER = 2     # open accumulator segment (tracer.cpp:1953-1959)
CLIP_LEAVE = 3     # close segment: mask = saved & ~segment (tracer.cpp:1961-1964)


@dataclass(frozen=True)
class SceneArrays:
    """Flat SoA scene, static shapes; fields, shapes and dtypes as in
    ``quadray_tpu.scene.compile.SceneArrays`` (f32 / i32 tensors)."""

    # surfaces, padded to NS
    s_tag: torch.Tensor     # (NS,) i32 surface tag, -1 = pad
    s_kind: torch.Tensor    # (NS,) i32 0=pad 1=plane 2=quadric 3=two-plane
    s_sing: torch.Tensor    # (NS,) i32 conic-singularity flag
    s_pos: torch.Tensor     # (NS,3) world position of local origin
    s_inv: torch.Tensor     # (NS,3,3) world->canonical linear map
    s_fwd: torch.Tensor     # (NS,3,3) canonical->world linear map
    s_sci: torch.Tensor     # (NS,3) quadratic coeffs
    s_scjh: torch.Tensor    # (NS,3) halved linear coeffs
    s_sciw: torch.Tensor    # (NS,) constant coeff
    s_cmin: torch.Tensor    # (NS,3) canonical axis clip min
    s_cmax: torch.Tensor    # (NS,3) canonical axis clip max
    s_mat: torch.Tensor     # (NS,2) i32 material index (outer, inner)
    s_bnd: torch.Tensor     # (NS,) i32 1 = finite world bounding sphere
    s_bsph: torch.Tensor    # (NS,4) f32 world bounding sphere cx cy cz r2
    s_emis: torch.Tensor    # (NS,2,3) per-side PT emission radiance
    # clip programs, padded to (NS, NC)
    c_op: torch.Tensor      # (NS,NC) i32 opcode
    c_ref: torch.Tensor     # (NS,NC) i32 clipper surface index
    c_side: torch.Tensor    # (NS,NC) f32 +1 remove-outer / -1 remove-inner
    # materials, padded to NM
    m_props: torch.Tensor   # (NM,) i32
    m_col: torch.Tensor     # (NM,3) plain color (linear 0..1)
    m_dff: torch.Tensor     # (NM,)
    m_spc: torch.Tensor     # (NM,)
    m_pow: torch.Tensor     # (NM,) specular power
    m_rfl: torch.Tensor     # (NM,)
    m_trn: torch.Tensor     # (NM,)
    m_rfr: torch.Tensor     # (NM,) refraction index ratio
    m_ext: torch.Tensor     # (NM,) extinction (metal Fresnel)
    m_tex_base: torch.Tensor   # (NM,) i32 offset into tex_data, -1 = none
    m_tex_xmask: torch.Tensor  # (NM,) i32 width-1
    m_tex_ymask: torch.Tensor  # (NM,) i32 height-1
    m_tex_xshift: torch.Tensor  # (NM,) i32 log2(width)
    m_tex_scl: torch.Tensor    # (NM,2) texel scale
    m_tex_off: torch.Tensor    # (NM,2) uv offset
    tex_data: torch.Tensor     # (T,3) f32 texture atlas
    # lights, padded to NL
    l_pos: torch.Tensor     # (NL,3)
    l_col: torch.Tensor     # (NL,3) color * src intensity
    l_cnt: torch.Tensor     # (NL,) attenuation constant
    l_lnr: torch.Tensor     # (NL,)
    l_qdr: torch.Tensor     # (NL,)
    l_on: torch.Tensor      # (NL,) f32 1.0 active / 0.0 pad
    # camera
    cam_pos: torch.Tensor   # (3,)
    cam_hor: torch.Tensor   # (3,)
    cam_ver: torch.Tensor   # (3,)
    cam_nrm: torch.Tensor   # (3,)
    cam_pov: torch.Tensor   # ()
    amb_col: torch.Tensor   # (3,) accumulated ambient (engine.cpp:3262-3272)
    use_gamma: torch.Tensor    # () 1.0 = enabled
    use_fresnel: torch.Tensor  # ()

    @property
    def device(self) -> torch.device:
        return self.s_pos.device

    def to(self, device) -> "SceneArrays":
        """Every field moved to ``device`` (one hop per field)."""
        return SceneArrays(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


FIELDS = tuple(f.name for f in dataclasses.fields(SceneArrays))
# the fields a transform moves, by the group of nodes they come from; the
# incremental update recomputes these and keeps every other field
MOVED_GROUPS = {"surf": ("s_pos", "s_inv", "s_fwd", "s_bsph"),
                "light": ("l_pos",),
                "cam": ("cam_pos", "cam_hor", "cam_ver", "cam_nrm")}
MOVED_FIELDS = tuple(k for g in MOVED_GROUPS.values() for k in g)


def scene_arrays_from_numpy(d: Dict[str, np.ndarray],
                            device="cuda") -> SceneArrays:
    """A SceneArrays from a dict of numpy arrays keyed by field name (for
    example ``np.asarray`` of each field of the JAX package's compiled
    scene), so both tracers can run on identical tables."""
    return SceneArrays(**{k: torch.from_numpy(np.array(d[k])).to(device)
                          for k in FIELDS})


def scene_arrays_to_numpy(sc: SceneArrays) -> Dict[str, np.ndarray]:
    return {k: getattr(sc, k).detach().cpu().numpy() for k in FIELDS}


# ---------------------------------------------------------------------------
# numeric helpers (f32, matching the JAX compiler's rounding)
# ---------------------------------------------------------------------------

def _f(v) -> torch.Tensor:
    return torch.tensor(float(np.asarray(v)), dtype=F32)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 matrix product as a chain of fused multiply-adds from zero,
    k = 0, 1, ...: the operation order of the JAX compiler's small dots.
    Each step is exact in float64 before its single rounding to f32."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    a64, b64 = a.double(), b.double()
    for k in range(a.shape[1]):
        acc = (a64[:, k:k + 1] * b64[k:k + 1, :] + acc).float().double()
    out = acc.float()
    return out[:, 0] if vec else out


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt."""
    return torch.sqrt(x.double()).float()


def _deg2rad(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tensor(math.pi / 180.0, dtype=F32)


def transform_matrix(trm: S.Transform3D) -> torch.Tensor:
    """4x4 world-from-local: T . Rz . Ry . Rx . Scl on column vectors
    (matches rtgeom.cpp:102-163 composition; angles in degrees)."""
    sx, sy, sz = [_f(v) for v in trm.scl]
    ax, ay, az = [_deg2rad(_f(v)).double() for v in trm.rot]
    px, py, pz = [_f(v) for v in trm.pos]
    cx, sxn = torch.cos(ax).float(), torch.sin(ax).float()
    cy, syn = torch.cos(ay).float(), torch.sin(ay).float()
    cz, szn = torch.cos(az).float(), torch.sin(az).float()
    one = torch.tensor(1.0, dtype=F32)
    zero = torch.tensor(0.0, dtype=F32)
    st = torch.stack
    rx = st([st([one, zero, zero]), st([zero, cx, -sxn]),
             st([zero, sxn, cx])])
    ry = st([st([cy, zero, syn]), st([zero, one, zero]),
             st([-syn, zero, cy])])
    rz = st([st([cz, -szn, zero]), st([szn, cz, zero]),
             st([zero, zero, one])])
    scl = torch.diag(st([sx, sy, sz]))
    lin = _mm(_mm(_mm(rz, ry), rx), scl)
    m = torch.zeros((4, 4), dtype=F32)
    m[:3, :3] = lin
    m[:3, 3] = st([px, py, pz])
    m[3, 3] = 1.0
    return m


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate/det), elementwise f32 ops in the
    JAX compiler's order (rtgeom.cpp:167 matrix_inverse)."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    st = torch.stack
    adj = st([st([A, c * h - b * i, b * f - c * e]),
              st([B, a * i - c * g, c * d - a * f]),
              st([C, b * g - a * h, a * e - b * d])])
    return adj / det


def quadric_coeffs(srf: S.Surface):
    """Canonical unit-frame implicit coefficients per surface tag (the
    shape tables of object.cpp:3120-3911; scale lives in the affine
    world->canonical matrix)."""
    t = srf.tag
    zero = _f(0.0)
    one = _f(1.0)
    st = torch.stack
    if t == S.TAG_PLANE:
        sci, scjh, sciw = st([zero, zero, zero]), st([zero, zero, zero]), zero
    elif t == S.TAG_CYLINDER:
        sci = st([one, one, zero])
        scjh = st([zero, zero, zero])
        sciw = _f(srf.rad) * _f(srf.rad)
    elif t == S.TAG_SPHERE:
        sci = st([one, one, one])
        scjh = st([zero, zero, zero])
        sciw = _f(srf.rad) * _f(srf.rad)
    elif t == S.TAG_CONE:
        sci = st([one, one, -_f(srf.rat) * _f(srf.rat)])
        scjh = st([zero, zero, zero])
        sciw = zero
    elif t == S.TAG_PARABOLOID:
        sci = st([one, one, zero])
        scjh = st([zero, zero, _f(srf.par) * 0.5])
        sciw = zero
    elif t == S.TAG_HYPERBOLOID:
        sci = st([one, one, -_f(srf.rat) * _f(srf.rat)])
        scjh = st([zero, zero, zero])
        sciw = _f(srf.hyp)
    elif t == S.TAG_PARACYLINDER:
        sci = st([one, zero, zero])
        scjh = st([zero, zero, _f(srf.par) * 0.5])
        sciw = zero
    elif t == S.TAG_HYPERCYLINDER:
        sci = st([one, zero, -_f(srf.rat) * _f(srf.rat)])
        scjh = st([zero, zero, zero])
        sciw = _f(srf.hyp)
    elif t == S.TAG_HYPERPARABOLOID:
        sci = st([one / torch.abs(_f(srf.pr1)),
                  -one / torch.abs(_f(srf.pr2)), zero])
        scjh = st([zero, zero, _f(0.5)])
        sciw = zero
    else:
        raise ValueError(f"unknown surface tag {t}")
    return sci, scjh, sciw


_BND_INF = 1e20   # clip values at/above this are "unclipped"


def _canonical_bounds(srf: S.Surface) -> Tuple[np.ndarray, np.ndarray]:
    """Static canonical-frame AABB of the axis-clipped surface: the
    per-shape intrinsic extent (adjust_minmax semantics,
    object.cpp:2508-2799) intersected with the axis clip box. Returns
    (cmin, cmax) float64 numpy, +-inf where unbounded. Custom clip
    programs only shrink the region, so ignoring them is conservative."""
    cmin = np.array(srf.min, np.float64)
    cmax = np.array(srf.max, np.float64)
    cmin[np.abs(cmin) >= _BND_INF] = -np.inf
    cmax[np.abs(cmax) >= _BND_INF] = +np.inf
    t = srf.tag
    f = lambda v: float(np.asarray(v))

    def clamp(axis, lo, hi):
        cmin[axis] = max(cmin[axis], lo)
        cmax[axis] = min(cmax[axis], hi)

    # largest |z| reachable inside the z clip window (inf if unclipped)
    zab = max(abs(cmin[2]), abs(cmax[2]))
    if t == S.TAG_PLANE:
        clamp(2, 0.0, 0.0)
    elif t == S.TAG_SPHERE:
        r = abs(f(srf.rad))
        for ax in range(3):
            clamp(ax, -r, r)
    elif t == S.TAG_CYLINDER:
        r = abs(f(srf.rad))
        clamp(0, -r, r)
        clamp(1, -r, r)
    elif t == S.TAG_CONE:
        r = abs(f(srf.rat)) * zab
        clamp(0, -r, r)
        clamp(1, -r, r)
    elif t in (S.TAG_PARABOLOID, S.TAG_PARACYLINDER):
        par = f(srf.par)
        # x^2 (+ y^2) = par*z: the surface lives on the sign(par) side of z
        if par >= 0.0:
            clamp(2, 0.0, np.inf)
        else:
            clamp(2, -np.inf, 0.0)
        zab2 = max(abs(cmin[2]), abs(cmax[2]))
        r = math.sqrt(abs(par) * zab2) if np.isfinite(zab2) else np.inf
        clamp(0, -r, r)
        if t == S.TAG_PARABOLOID:
            clamp(1, -r, r)
    elif t in (S.TAG_HYPERBOLOID, S.TAG_HYPERCYLINDER):
        rat, hyp = f(srf.rat), f(srf.hyp)
        r2 = rat * rat * zab * zab + hyp
        r = math.sqrt(max(r2, 0.0)) if np.isfinite(zab) else np.inf
        clamp(0, -r, r)
        if t == S.TAG_HYPERBOLOID:
            clamp(1, -r, r)
    elif t == S.TAG_HYPERPARABOLOID:
        # x^2/p1 - y^2/p2 = z (saddle): each axis bounded only through
        # the other two; interval arithmetic on the clip box. Degenerate
        # saddles (p1/p2 == 0) stay unbounded
        p1, p2 = abs(f(srf.pr1)), abs(f(srf.pr2))
        xab = max(abs(cmin[0]), abs(cmax[0]))
        yab = max(abs(cmin[1]), abs(cmax[1]))
        ok = p1 > 0.0 and p2 > 0.0
        if ok and np.isfinite(zab) and np.isfinite(yab):
            r = math.sqrt(p1 * (zab + yab * yab / p2))
            clamp(0, -r, r)
        if ok and np.isfinite(zab) and np.isfinite(xab):
            r = math.sqrt(p2 * (zab + xab * xab / p1))
            clamp(1, -r, r)
        if ok and np.isfinite(xab) and np.isfinite(yab):
            clamp(2, -yab * yab / p2, xab * xab / p1)
    return cmin, cmax


def _bounding_sphere(cmin: np.ndarray, cmax: np.ndarray, lin, pos):
    """World bounding sphere of a finite canonical box under the
    canonical->world affine (lin, pos): center = transformed box center,
    r = max corner distance, inflated for fp safety."""
    ctr = (cmin + cmax) * 0.5
    half = (cmax - cmin) * 0.5
    sgn = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)], np.float64)
    corners = torch.from_numpy((sgn * half[None, :]).astype(np.float32))
    center_w = _mm(lin, torch.from_numpy(ctr.astype(np.float32))) + pos
    off_w = _mm(corners, lin.T)                                  # (8,3)
    sq = off_w * off_w
    r = _sqrt(torch.max(sq[:, 0] + sq[:, 1] + sq[:, 2]))
    r = r * _f(1.001) + _f(1e-4)
    return center_w, r * r


def _unpack_color(val: int):
    r = ((val >> 16) & 0xFF) / 255.0
    g = ((val >> 8) & 0xFF) / 255.0
    b = (val >> 0) & 0xFF
    return np.array([r, g, b / 255.0], np.float32)


class _Collected:
    def __init__(self):
        self.surfaces: List[Dict[str, Any]] = []
        self.lights: List[Dict[str, Any]] = []
        self.cameras: List[Dict[str, Any]] = []
        self.materials: List[S.Material] = []
        self.mat_ids: Dict[int, int] = {}
        # surfaces UNTIE'd from bounding volumes (object.cpp:1498-1586)
        self.untied: set = set()

    def material_index(self, mat: Optional[S.Material]) -> int:
        if mat is None:
            mat = _DEFAULT_MAT
        key = id(mat)
        if key not in self.mat_ids:
            self.mat_ids[key] = len(self.materials)
            self.materials.append(mat)
        return self.mat_ids[key]


_DEFAULT_MAT = S.Material(tex=S.Texture.pcolor(0x808080))


class _Slot:
    """One object slot in an array: its own surface (if any) and, for
    arrays, the child slots (the obj_arr indexing of relation rows,
    object.cpp:1385-1394)."""

    def __init__(self):
        self.surface: Optional[int] = None
        self.children: List["_Slot"] = []

    def all_surfaces(self) -> List[int]:
        out = [] if self.surface is None else [self.surface]
        for c in self.children:
            out.extend(c.all_surfaces())
        return out


def _walk(col: _Collected, arr: S.Array, parent_mtx, time: float,
          cam_trm: "Optional[S.Transform3D]" = None):
    """Recursive hierarchy walk (rt_Array ctor + update_object,
    object.cpp:1170-1800). Returns the slot tree for relation resolution."""
    slots: List[_Slot] = []
    # sibling lights' color for emissive surfaces in this array
    # (rt_Light ctor object.cpp:622-632: col*(src+amb) summed into parent)
    lacc = np.zeros((3,), np.float32)
    direct_surfaces: List[int] = []
    for ob in arr.objects:
        item = ob.item
        if isinstance(item, S.Light):
            lacc += _unpack_color(item.col) * (
                float(np.asarray(item.src)) + float(np.asarray(item.amb)))
    for ob in arr.objects:
        trm = ob.anim(time) if ob.anim is not None else ob.trm
        item = ob.item
        if cam_trm is not None and isinstance(item, S.Camera):
            trm = cam_trm
        mtx = _mm(parent_mtx, transform_matrix(trm))
        slot = _Slot()
        if isinstance(item, S.Array):
            slot.children = _walk(col, item, mtx, time, cam_trm)
        elif isinstance(item, S.Surface):
            mo = ob.mat_outer if ob.mat_outer is not None else \
                item.side_outer.material
            mi = ob.mat_inner if ob.mat_inner is not None else \
                item.side_inner.material
            idx = len(col.surfaces)
            col.surfaces.append(dict(
                srf=item, mtx=mtx,
                mat_outer=col.material_index(mo),
                mat_inner=col.material_index(mi),
                side_outer=item.side_outer, side_inner=item.side_inner,
                clips=[], emis=np.zeros((2, 3), np.float32),
            ))
            slot.surface = idx
            direct_surfaces.append(idx)
        elif isinstance(item, S.Light):
            col.lights.append(dict(lgt=item, mtx=mtx))
        elif isinstance(item, S.Camera):
            col.cameras.append(dict(cam=item, mtx=mtx))
        slots.append(slot)

    # emissive PT radiance for LIGHT-tagged sides of direct child surfaces
    for si in direct_surfaces:
        sd = col.surfaces[si]
        for k, mk in ((0, "mat_outer"), (1, "mat_inner")):
            if col.materials[sd[mk]].tag == S.MAT_LIGHT:
                sd["emis"][k] = lacc * 100.0

    _apply_relations(col, arr, slots)
    return slots


def _apply_relations(col: _Collected, arr: S.Array, slots: List[_Slot]):
    """Resolve rt_RELATION rows into per-surface clip program entries
    (rt_Array ctor object.cpp:1376-1587 + add_relation
    object.cpp:2382-2454): MINUS rows clip every surface under slot a by
    every surface under slot b; {-1, MINUS_*, b} opens/extends an
    accumulator segment closed by {a, MINUS_ACCUM, -1}; INDEX_ARRAY rows
    descend the left/right index context; BOUND/UNTIE rows set culling
    membership."""
    pending_accum: List[Tuple[int, int]] = []
    acc_open = False
    ctx_l: List[_Slot] = slots
    ctx_r: List[_Slot] = slots

    for rel in arr.relations:
        r = rel.rel
        if rel.obj1 >= len(ctx_l) or rel.obj2 >= len(ctx_r):
            continue
        if r == S.REL_INDEX_ARRAY:
            if rel.obj1 >= 0 and ctx_l[rel.obj1].children:
                ctx_l = ctx_l[rel.obj1].children
            if rel.obj2 >= 0 and ctx_r[rel.obj2].children:
                ctx_r = ctx_r[rel.obj2].children
            continue
        if r in (S.REL_BOUND_ARRAY, S.REL_UNTIE_ARRAY,
                 S.REL_BOUND_INDEX, S.REL_UNTIE_INDEX):
            tie = r in (S.REL_BOUND_ARRAY, S.REL_BOUND_INDEX)
            if r in (S.REL_BOUND_ARRAY, S.REL_UNTIE_ARRAY):
                if 0 <= rel.obj2 < len(ctx_r):
                    targets = ctx_r[rel.obj2].all_surfaces()
                else:  # {-1, *, -1}: this whole array
                    targets = [si for s_ in slots
                               for si in s_.all_surfaces()]
            else:
                targets = (ctx_r[rel.obj2].all_surfaces()
                           if 0 <= rel.obj2 < len(ctx_r) else [])
            for si in targets:
                (col.untied.discard if tie else col.untied.add)(si)
            if rel.obj1 >= 0:
                ctx_l = slots
            if rel.obj2 >= 0:
                ctx_r = slots
            continue
        if r in (S.REL_MINUS_INNER, S.REL_MINUS_OUTER):
            side = +1 if r == S.REL_MINUS_OUTER else -1
            if rel.obj2 < 0:
                continue
            clippers = ctx_r[rel.obj2].all_surfaces()
            ctx_r = slots
            if rel.obj1 == -1:
                acc_open = True
                for ci in clippers:
                    pending_accum.append((ci, side))
            else:
                for ti in ctx_l[rel.obj1].all_surfaces():
                    for ci in clippers:
                        if ci != ti:
                            col.surfaces[ti]["clips"].append(
                                (CLIP_SURF, ci, side))
                ctx_l = slots
        elif r == S.REL_MINUS_ACCUM:
            if rel.obj1 < 0 or not acc_open:
                continue
            for ti in ctx_l[rel.obj1].all_surfaces():
                col.surfaces[ti]["clips"].append((CLIP_ENTER, -1, 0))
                for (ci, side) in pending_accum:
                    if ci != ti:
                        col.surfaces[ti]["clips"].append((CLIP_SURF, ci, side))
                col.surfaces[ti]["clips"].append((CLIP_LEAVE, -1, 0))
            pending_accum = []
            acc_open = False
            ctx_l = slots


def _texture_array(tex: S.Texture) -> Optional[np.ndarray]:
    """Return (H, W, 3) float RGB in [0,1] or None for plain color."""
    if tex.data is not None:
        d = np.asarray(tex.data)
        if d.ndim == 2:  # packed 0xAARRGGBB uint32
            d = d.astype(np.uint32)
            return np.stack([(d >> 16) & 0xFF, (d >> 8) & 0xFF, d & 0xFF],
                            axis=-1).astype(np.float32) / 255.0
        return d.astype(np.float32)
    if tex.path is not None:
        from quadray_tpu_torch.utils.image import load_bmp
        return load_bmp(tex.path).astype(np.float32) / 255.0
    return None


def _pad_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def compile_scene(scene: S.SceneDef, time: float = 0.0,
                  cam_index: int = 0,
                  ns: Optional[int] = None, nc: Optional[int] = None,
                  nl: Optional[int] = None,
                  cam_trm: Optional[S.Transform3D] = None,
                  device="cuda") -> SceneArrays:
    """Compile a SceneDef at a given time into SceneArrays on ``device``.

    NS surfaces / NC clip entries / NL lights are padded to powers of two
    unless given, so a later frame of the same scene keeps its shapes."""
    col = _Collected()
    _walk(col, scene.root, torch.eye(4, dtype=F32), time, cam_trm)

    n_srf = len(col.surfaces)
    if n_srf == 0:
        raise ValueError("scene has no surfaces")
    NS = ns or _pad_pow2(n_srf)
    NC = nc or max(1, _pad_pow2(max((len(s["clips"]) for s in col.surfaces),
                                    default=1)))
    NL = nl or max(1, _pad_pow2(len(col.lights)))
    NM = max(1, len(col.materials))

    # ---- surfaces
    tags, kinds, sings = [], [], []
    poss, invs, fwds, scis, scjhs, sciws, cmins, cmaxs, mats = (
        [] for _ in range(9))
    # culling gate: the tiling/bounding-volume optimization class
    use_cull = (scene.opts & S.OPTS_TILING) != 0
    bnds: List[int] = []
    bsphs: List[torch.Tensor] = []
    cops = np.zeros((NS, NC), np.int32)
    crefs = np.full((NS, NC), -1, np.int32)
    csides = np.zeros((NS, NC), np.float32)
    for i, sd in enumerate(col.surfaces):
        srf: S.Surface = sd["srf"]
        lin = sd["mtx"][:3, :3]
        pos = sd["mtx"][:3, 3]
        sci, scjh, sciw = quadric_coeffs(srf)
        tags.append(srf.tag)
        hyp0 = float(np.asarray(srf.hyp)) == 0.0
        # solver kind: 1 plane, 2 quadric, 3 two-plane (degenerate
        # hypercylinder i^2 = rat^2 k^2, update0 tracer.cpp:5785-5788)
        if srf.tag == S.TAG_PLANE:
            kinds.append(1)
        elif srf.tag == S.TAG_HYPERCYLINDER and hyp0:
            kinds.append(3)
        else:
            kinds.append(2)
        # conic-singularity flag (msc_p[1], update0 tracer.cpp:5801-5807)
        if srf.tag == S.TAG_CONE or (srf.tag == S.TAG_HYPERBOLOID and hyp0):
            sings.append(1)
        elif srf.tag == S.TAG_HYPERCYLINDER and hyp0:
            sings.append(2)
        else:
            sings.append(0)
        poss.append(pos)
        invs.append(_inv3(lin))
        fwds.append(lin)
        scis.append(sci)
        scjhs.append(scjh)
        sciws.append(sciw)
        cmins.append(torch.from_numpy(np.asarray(srf.min, np.float32)))
        cmaxs.append(torch.from_numpy(np.asarray(srf.max, np.float32)))
        mats.append((sd["mat_outer"], sd["mat_inner"]))
        bcmin, bcmax = _canonical_bounds(srf)
        finite = bool(np.all(np.isfinite(bcmin))
                      and np.all(np.isfinite(bcmax))
                      and np.all(np.abs(bcmin) < _BND_INF)
                      and np.all(np.abs(bcmax) < _BND_INF))
        if finite and use_cull and i not in col.untied:
            ctr_w, r2 = _bounding_sphere(bcmin, bcmax, lin, pos)
            bnds.append(1)
            bsphs.append(torch.cat([ctr_w, r2.reshape(1)]))
        else:
            bnds.append(0)
            bsphs.append(torch.zeros((4,), dtype=F32))
        for j, (op, ref, side) in enumerate(sd["clips"][:NC]):
            cops[i, j] = op
            crefs[i, j] = ref
            csides[i, j] = float(side)

    def pad_f(lst, shape):
        a = torch.stack(lst)
        pad = NS - a.shape[0]
        if pad:
            a = torch.cat([a, torch.zeros((pad,) + shape, dtype=F32)])
        return a.to(F32)

    s_tag = np.full((NS,), -1, np.int32)
    s_tag[:n_srf] = tags
    s_kind = np.zeros((NS,), np.int32)
    s_kind[:n_srf] = kinds
    s_sing = np.zeros((NS,), np.int32)
    s_sing[:n_srf] = sings

    # ---- materials + texture atlas
    m_props = np.zeros((NM,), np.int32)
    m_col = np.zeros((NM, 3), np.float32)
    m_f = {k: np.zeros((NM,), np.float32)
           for k in ("dff", "spc", "pow", "rfl", "trn", "rfr", "ext")}
    m_tex_base = np.full((NM,), -1, np.int32)
    m_tex_xmask = np.zeros((NM,), np.int32)
    m_tex_ymask = np.zeros((NM,), np.int32)
    m_tex_xshift = np.zeros((NM,), np.int32)
    m_tex_scl = np.ones((NM, 2), np.float32)
    m_tex_off = np.zeros((NM, 2), np.float32)
    atlas: List[np.ndarray] = []
    atlas_len = 0
    use_gamma = (scene.opts & S.OPTS_GAMMA) == 0
    use_fresnel = (scene.opts & S.OPTS_FRESNEL) == 0
    for mi, mat in enumerate(col.materials):
        props = 0
        props |= PROP_LIGHT if mat.tag == S.MAT_LIGHT else 0
        props |= PROP_METAL if mat.tag == S.MAT_METAL else 0
        trn = float(np.asarray(mat.trn))
        rfl = float(np.asarray(mat.rfl))
        props |= PROP_OPAQUE if trn == 0.0 else 0
        props |= PROP_TRANSP if trn == 1.0 else 0
        props |= PROP_REFLECT if rfl != 0.0 else 0
        props |= PROP_REFRACT if float(np.asarray(mat.rfr)) != 1.0 else 0
        dff, spc = float(np.asarray(mat.dff)), float(np.asarray(mat.spc))
        props |= PROP_DIFFUSE if dff != 0.0 else 0
        props |= PROP_SPECULAR if spc != 0.0 else 0
        if rfl + trn >= 1.0:  # object.cpp:4056-4060
            props &= ~(PROP_DIFFUSE | PROP_SPECULAR)
        props |= PROP_GAMMA if use_gamma else 0
        props |= PROP_FRESNEL if use_fresnel else 0
        tex_arr = _texture_array(mat.tex)
        if tex_arr is not None:
            h, w = tex_arr.shape[:2]
            assert (w & (w - 1)) == 0 and (h & (h - 1)) == 0, \
                "texture dims must be powers of two (reference contract)"
            props |= PROP_TEXTURE
            m_tex_base[mi] = atlas_len
            m_tex_xmask[mi] = w - 1
            m_tex_ymask[mi] = h - 1
            m_tex_xshift[mi] = int(math.log2(w))
            atlas.append(tex_arr.reshape(-1, 3))
            atlas_len += h * w
        m_props[mi] = props
        m_col[mi] = _unpack_color(mat.tex.color)
        for k in m_f:
            m_f[k][mi] = float(np.asarray(getattr(mat, k)))
        # refraction special case (object.cpp:4146-4152): partially
        # transparent with rfr==1 -> ext supplies the Fresnel index
        if 0.0 < trn < 1.0 and m_f["rfr"][mi] == 1.0 and m_f["ext"][mi] != 0.0:
            m_f["rfr"][mi] = m_f["ext"][mi]
    tex_data = (np.concatenate(atlas, axis=0) if atlas
                else np.zeros((1, 3), np.float32))

    # per-surface texture 2D transforms live on sides; fold them into the
    # material slots the surface references (one transform per material)
    for sd in col.surfaces:
        for key, side in (("mat_outer", sd["side_outer"]),
                          ("mat_inner", sd["side_inner"])):
            mi = sd[key]
            if side is not None:
                m_tex_scl[mi] = np.asarray(side.scl, np.float32)
                m_tex_off[mi] = np.asarray(side.pos, np.float32)

    # ---- lights + ambient accumulation (engine.cpp:3262-3272)
    l_col = np.zeros((NL, 3), np.float32)
    l_cnt = np.ones((NL,), np.float32)
    l_lnr = np.zeros((NL,), np.float32)
    l_qdr = np.zeros((NL,), np.float32)
    l_on = np.zeros((NL,), np.float32)
    amb = np.zeros((3,), np.float32)
    lp_rows = []
    for li, ld in enumerate(col.lights):
        lgt: S.Light = ld["lgt"]
        lp_rows.append(ld["mtx"][:3, 3])
        colr = _unpack_color(lgt.col)
        l_col[li] = colr * float(np.asarray(lgt.src))
        # reference biases constant attenuation by +1 (object.cpp:617)
        l_cnt[li] = float(np.asarray(lgt.cnt)) + 1.0
        l_lnr[li] = float(np.asarray(lgt.lnr))
        l_qdr[li] = float(np.asarray(lgt.qdr))
        l_on[li] = 1.0
        amb += colr * float(np.asarray(lgt.amb))
    lp_rows += [torch.zeros((3,), dtype=F32)] * (NL - len(col.lights))

    # ---- camera: index 0 is the LAST camera in hierarchy order (the
    # registry prepends, object.cpp:429-431; cam_head, engine.cpp:2923)
    if not col.cameras:
        raise ValueError("scene has no camera")
    cams = col.cameras[::-1]
    cd = cams[min(cam_index, len(cams) - 1)]
    cam: S.Camera = cd["cam"]
    cmtx = cd["mtx"]
    amb += np.asarray(_unpack_color(cam.col)) * float(np.asarray(cam.amb))

    t = torch.from_numpy
    sc = SceneArrays(
        s_tag=t(s_tag), s_kind=t(s_kind), s_sing=t(s_sing),
        s_pos=pad_f(poss, (3,)), s_inv=pad_f(invs, (3, 3)),
        s_fwd=pad_f(fwds, (3, 3)),
        s_sci=pad_f(scis, (3,)), s_scjh=pad_f(scjhs, (3,)),
        s_sciw=pad_f(sciws, ()),
        s_cmin=pad_f(cmins, (3,)), s_cmax=pad_f(cmaxs, (3,)),
        s_mat=t(np.array(mats + [(0, 0)] * (NS - n_srf), np.int32)),
        s_bnd=t(np.array(bnds + [0] * (NS - n_srf), np.int32)),
        s_bsph=pad_f(bsphs, (4,)),
        s_emis=t(np.concatenate(
            [np.stack([sd["emis"] for sd in col.surfaces]),
             np.zeros((NS - n_srf, 2, 3), np.float32)])),
        c_op=t(cops), c_ref=t(crefs), c_side=t(csides),
        m_props=t(m_props), m_col=t(m_col),
        m_dff=t(m_f["dff"]), m_spc=t(m_f["spc"]), m_pow=t(m_f["pow"]),
        m_rfl=t(m_f["rfl"]), m_trn=t(m_f["trn"]), m_rfr=t(m_f["rfr"]),
        m_ext=t(m_f["ext"]),
        m_tex_base=t(m_tex_base), m_tex_xmask=t(m_tex_xmask),
        m_tex_ymask=t(m_tex_ymask), m_tex_xshift=t(m_tex_xshift),
        m_tex_scl=t(m_tex_scl), m_tex_off=t(m_tex_off),
        tex_data=t(tex_data),
        l_pos=torch.stack(lp_rows).to(F32), l_col=t(l_col),
        l_cnt=t(l_cnt), l_lnr=t(l_lnr), l_qdr=t(l_qdr), l_on=t(l_on),
        cam_pos=cmtx[:3, 3].clone(), cam_hor=cmtx[:3, 0].clone(),
        cam_ver=cmtx[:3, 1].clone(), cam_nrm=cmtx[:3, 2].clone(),
        cam_pov=_f(cam.pov),
        amb_col=t(amb),
        use_gamma=torch.tensor(1.0 if use_gamma else 0.0, dtype=F32),
        use_fresnel=torch.tensor(1.0 if use_fresnel else 0.0, dtype=F32),
    )
    return sc.to(device)


# ---------------------------------------------------------------------------
# incremental update: the structure once, a batched numeric pass a frame
# (the JAX engine's first-frame compile and jitted later frames,
# quadray_tpu/engine.py:165-207)
# ---------------------------------------------------------------------------

def _bmm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``_mm`` over a batch in numpy, (B, M, K) @ (B, K, N) f32: every
    element through the same float64 steps, each rounded to f32, in the
    same order (numpy's f32/f64 arithmetic is IEEE, like torch's; small
    numpy ops cost a fraction of torch's on the host)."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float64)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k in range(a.shape[-1]):
        acc = (a64[..., k:k + 1] * b64[..., k:k + 1, :] + acc) \
            .astype(np.float32).astype(np.float64)
    return acc.astype(np.float32)


def _trm_values(trm: S.Transform3D) -> tuple:
    """A transform's nine numbers, scl, rot, pos, as ``_f`` reads them."""
    return tuple(float(np.asarray(v))
                 for v in (*trm.scl, *trm.rot, *trm.pos))


_DEG2RAD = np.float32(math.pi / 180.0)


def transform_inputs(vals) -> np.ndarray:
    """What a local matrix is built from, for B transforms given as rows
    of ``_trm_values``: (B, 12) f32 rows of the scale, the position, and
    the cos and sin of the rotation's three angles. sin and cos are
    torch's on a contiguous float64 tensor, whose every element gets the
    bits of the scalar code's 0-d call. The scene update's kernel
    (csrc/update.cu) takes these rows: the card's sin and cos are not
    correctly rounded."""
    v = np.array(vals, np.float64).reshape(-1, 9).astype(np.float32)
    ang = torch.from_numpy((v[:, 3:6] * _DEG2RAD).astype(np.float64))
    c = torch.cos(ang).float().numpy()
    s = torch.sin(ang).float().numpy()
    return np.concatenate([v[:, 0:3], v[:, 6:9], c, s], axis=1)


def local_matrices(inp: np.ndarray) -> np.ndarray:
    """(B, 4, 4) f32 local matrices from ``transform_inputs``' rows:
    Rz . Ry . Rx . Scl, each product ``_bmm``'s, and the position."""
    B = inp.shape[0]
    c, s = inp[:, 6:9], inp[:, 9:12]
    rx, ry, rz = (np.zeros((B, 3, 3), np.float32) for _ in range(3))
    rx[:, 0, 0] = ry[:, 1, 1] = rz[:, 2, 2] = 1.0
    rx[:, 1, 1], rx[:, 1, 2] = c[:, 0], -s[:, 0]
    rx[:, 2, 1], rx[:, 2, 2] = s[:, 0], c[:, 0]
    ry[:, 0, 0], ry[:, 0, 2] = c[:, 1], s[:, 1]
    ry[:, 2, 0], ry[:, 2, 2] = -s[:, 1], c[:, 1]
    rz[:, 0, 0], rz[:, 0, 1] = c[:, 2], -s[:, 2]
    rz[:, 1, 0], rz[:, 1, 1] = s[:, 2], c[:, 2]
    scl = np.zeros((B, 3, 3), np.float32)
    scl[:, 0, 0], scl[:, 1, 1], scl[:, 2, 2] = inp[:, 0], inp[:, 1], inp[:, 2]
    m = np.zeros((B, 4, 4), np.float32)
    m[:, :3, :3] = _bmm(_bmm(_bmm(rz, ry), rx), scl)
    m[:, :3, 3] = inp[:, 3:6]
    m[:, 3, 3] = 1.0
    return m


def transform_matrices(vals) -> np.ndarray:
    """``transform_matrix`` of B transforms at once, from rows of
    ``_trm_values``: (B, 4, 4) f32, each matrix bitwise
    ``transform_matrix``'s."""
    return local_matrices(transform_inputs(vals))


def _inv3_batch(m: np.ndarray) -> np.ndarray:
    """``_inv3`` of (B, 3, 3) f32, the same f32 operations per element."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = np.stack([np.stack([A, c * h - b * i, b * f - c * e], -1),
                    np.stack([B, a * i - c * g, c * d - a * f], -1),
                    np.stack([C, b * g - a * h, a * e - b * d], -1)], -2)
    return adj / det[:, None, None]


_R_SCALE, _R_PAD = np.float32(1.001), np.float32(1e-4)


def _bounding_spheres(ctr: np.ndarray, corners: np.ndarray,
                      lin: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``_bounding_sphere`` of B surfaces from their f32 box centres (B, 3)
    and corner offsets (B, 8, 3): (B, 4) f32 rows cx cy cz r2."""
    center = _bmm(lin, ctr[:, :, None])[:, :, 0] + pos
    off = _bmm(corners, lin.transpose(0, 2, 1))
    sq = off * off
    r2 = np.max(sq[..., 0] + sq[..., 1] + sq[..., 2], axis=1)
    r = np.sqrt(r2.astype(np.float64)).astype(np.float32)
    r = r * _R_SCALE + _R_PAD
    return np.concatenate([center, (r * r)[:, None]], axis=1)


def _box_corners(srf: S.Surface):
    """A bounded surface's canonical box as ``_bounding_sphere`` takes it:
    the f32 centre (3,) and corner offsets (8, 3)."""
    cmin, cmax = _canonical_bounds(srf)
    ctr = (cmin + cmax) * 0.5
    half = (cmax - cmin) * 0.5
    sgn = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)], np.float64)
    return ctr.astype(np.float32), (sgn * half[None, :]).astype(np.float32)


# a node's local transform: its own trm, its animator, or the camera slot
# (the controller's transform once there is one, as _walk gives every
# camera node cam_trm)
SRC_STATIC, SRC_ANIM, SRC_CAMERA = 0, 1, 2

_NODE_SIG = operator.attrgetter("item", "anim", "mat_outer", "mat_inner",
                                "trm")
_REL_SIG = operator.attrgetter("obj1", "rel", "obj2")
_TRM_SIG = operator.attrgetter("trm.scl", "trm.rot", "trm.pos")


def _array_sig(arrays) -> tuple:
    return tuple((tuple(a.objects), tuple(map(_REL_SIG, a.relations)))
                 for a in arrays)


def _static_sig(obs) -> tuple:
    return tuple(map(_TRM_SIG, obs))


class SceneStructure:
    """What ``structure_pass`` records of a scene: the node table (each
    object's parent, hierarchy level and local transform source), the
    nodes of the surfaces, lights and the rendered camera, the static
    nodes' local and world matrices, the bounded surfaces' canonical
    boxes, and the arrays of the last frame, whose time-invariant fields
    every later frame shares. ``numeric_pass`` reads it and updates its
    last frame."""

    def __init__(self, scene: S.SceneDef, cam_index: int, device,
                 sc0: SceneArrays):
        self.root = scene.root
        self.device = torch.device(device)
        obs, parent, level, arrays = [], [], [], []
        surf, light, cams = [], [], []

        def walk(arr, par, lv):
            arrays.append(arr)
            for ob in arr.objects:
                i = len(obs)
                obs.append(ob)
                parent.append(par)
                level.append(lv)
                if isinstance(ob.item, S.Array):
                    walk(ob.item, i, lv + 1)
                elif isinstance(ob.item, S.Surface):
                    surf.append(i)
                elif isinstance(ob.item, S.Light):
                    light.append(i)
                elif isinstance(ob.item, S.Camera):
                    cams.append(i)

        walk(scene.root, -1, 0)
        N = len(obs)
        self.obs = obs
        self.src = np.array(
            [SRC_CAMERA if isinstance(ob.item, S.Camera) else
             SRC_ANIM if ob.anim is not None else SRC_STATIC for ob in obs],
            np.int64)
        # the root's parent is row N of the world matrices, the identity
        self.parent = np.where(np.array(parent, np.int64) < 0, N,
                               np.array(parent, np.int64))
        self.level = np.array(level, np.int64)
        self.arrays_walked = arrays
        self.node_sig = tuple(map(_NODE_SIG, obs))
        self.static_nodes = np.nonzero(self.src == SRC_STATIC)[0]
        self.static_obs = [obs[i] for i in self.static_nodes]
        # a copy, so that a transform changed in place differs from it
        self.static_sig = copy.deepcopy(_static_sig(self.static_obs))
        self.array_sig = _array_sig(arrays)
        self.dyn = [int(i) for i in np.nonzero(self.src != SRC_STATIC)[0]]
        # moved: the node or an ancestor has a transform that can change
        moved = self.src != SRC_STATIC
        for i in range(N):          # parents come before their children
            if self.parent[i] < N and moved[self.parent[i]]:
                moved[i] = True

        def up(i):
            while i < N:
                yield i
                i = self.parent[i]

        cam_node = cams[::-1][min(cam_index, len(cams) - 1)]
        self.nodes = {"surf": np.array(surf, np.int64),
                      "light": np.array(light, np.int64),
                      "cam": np.array([cam_node], np.int64)}
        self.need, self.deps = {}, {}
        for g, ids in self.nodes.items():
            chain = sorted({int(a) for i in ids for a in up(i) if moved[a]})
            self.need[g] = np.array(chain, np.int64)
            self.deps[g] = [a for a in chain if self.src[a] != SRC_STATIC]
        # the groups a frame can move: those the interactive frame rewrites
        self.moving = tuple(g for g in MOVED_GROUPS if self.deps[g])
        self.ns = sc0.s_pos.shape[0]
        self.nl = sc0.l_pos.shape[0]
        self.shapes = dict(ns=self.ns, nc=sc0.c_op.shape[1], nl=self.nl)
        # local matrices of the static nodes and world matrices of the
        # nodes that nothing moves, level by level from the root
        L = np.zeros((N, 4, 4), np.float32)
        if self.static_nodes.size:
            L[self.static_nodes] = transform_matrices(
                [_trm_values(obs[i].trm) for i in self.static_nodes])
        self.L_static = L
        W = np.zeros((N + 1, 4, 4), np.float32)
        W[N] = np.eye(4, dtype=np.float32)
        still = np.nonzero(~moved)[0]
        for lv in np.unique(self.level[still]):
            ids = still[self.level[still] == lv]
            W[ids] = _bmm(W[self.parent[ids]], L[ids])
        self.W_static = W
        self.bnd = np.nonzero(sc0.s_bnd.numpy()[:len(surf)] > 0)[0]
        boxes = [_box_corners(obs[surf[i]].item) for i in self.bnd]
        self.box_ctr = np.array([c for c, _ in boxes],
                                np.float32).reshape(-1, 3)
        self.box_corners = np.array([k for _, k in boxes],
                                    np.float32).reshape(-1, 8, 3)
        self._plan_update()
        self.keys: Dict[str, bytes] = {}
        self.last: Optional[SceneArrays] = None
        # the plan on the structure's device (ops.update.update_tables),
        # made by structure_pass
        self.tables = None

    def _plan_update(self):
        """The scene update's kernel's view of the node table: every node
        that can move under a group (``need``) as a scratch row, ordered
        by level (``lv_start``: each level's rows); each row's parent and
        local matrix (``par``, ``src``) and each surface's, light's and
        the camera's world matrix as a reference: a scratch row (>= 0) or
        -(node + 1) for a row of ``W_static``/``L_static``; a row of
        ``src`` >= 0 is the node's row of ``local_inputs``; ``box`` each
        surface's row of ``box_ctr``/``box_corners``, or -1."""
        need = np.unique(np.concatenate([self.need[g] for g in self.need]))
        need = need[np.argsort(self.level[need], kind="stable")]
        slot = {int(n): q for q, n in enumerate(need)}
        dyn = {n: r for r, n in enumerate(self.dyn)}

        def ref(n):
            return slot.get(int(n), -int(n) - 1)

        i32 = lambda v: np.array(v, np.int32).reshape(-1)
        self.plan = dict(
            lv_start=i32(np.searchsorted(self.level[need], np.unique(
                self.level[need])).tolist() + [need.size]),
            par=i32([ref(self.parent[n]) for n in need]),
            src=i32([dyn.get(int(n), -int(n) - 1) for n in need]),
            surf=i32([ref(n) for n in self.nodes["surf"]]),
            light=i32([ref(n) for n in self.nodes["light"]]),
            cam=ref(self.nodes["cam"][0]))
        box = np.full(self.nodes["surf"].size, -1, np.int32)
        box[self.bnd] = np.arange(self.bnd.size)
        self.plan["box"] = box
        self.n_scratch = need.size

    def check(self):
        """Raise ValueError where the hierarchy is no longer the one this
        structure recorded: an object, item, animator, material override
        or relation added, removed or replaced, or a static transform
        changed. (What the items themselves hold, the structure pass read
        once, as the JAX engine's jitted pass does.)"""
        if tuple(map(_NODE_SIG, self.obs)) != self.node_sig \
                or _array_sig(self.arrays_walked) != self.array_sig:
            raise ValueError(
                "the scene's hierarchy changed after its structure was "
                "recorded (an object, item, animator, material or relation "
                "was added, removed or replaced): set_opts, or a new Scene, "
                "records it again")
        if _static_sig(self.static_obs) != self.static_sig:
            raise ValueError(
                "a static transform changed after the scene's structure was "
                "recorded: give the object an animator, or record the "
                "structure again (set_opts, or a new Scene)")

    def local_values(self, time: float, cam_trm) -> Dict[int, tuple]:
        """Each moving node's local transform at (time, cam_trm), as
        ``_walk`` picks it, in ``_trm_values`` form."""
        out = {}
        for i in self.dyn:
            ob = self.obs[i]
            if self.src[i] == SRC_CAMERA and cam_trm is not None:
                trm = cam_trm
            else:
                trm = ob.anim(time) if ob.anim is not None else ob.trm
            out[i] = _trm_values(trm)
        return out

    def group_keys(self, vals) -> Dict[str, bytes]:
        """Per group of ``MOVED_GROUPS``, the bits of the local transforms
        it depends on: a group moved when its key changed (bits, not
        values, so a zero that changes sign moves it too)."""
        return {g: np.array([vals[d] for d in self.deps[g]],
                            np.float64).tobytes() for g in MOVED_GROUPS}

    def local_inputs(self, vals) -> np.ndarray:
        """``transform_inputs`` of every moving node (``dyn``, in order)
        from ``local_values``' dict: (len(dyn), 12) f32."""
        return transform_inputs([vals[i] for i in self.dyn])

    def moved_fields(self, groups, vals) -> Dict[str, np.ndarray]:
        """The fields of ``groups`` on the host (f32 numpy), from the
        moving nodes' local transforms ``vals``: the plain version of the
        scene update's kernel (``fields_from_inputs``)."""
        return self.fields_from_inputs(groups, self.local_inputs(vals))

    def fields_from_inputs(self, groups, inp: np.ndarray
                           ) -> Dict[str, np.ndarray]:
        """The fields of ``groups`` (f32 numpy) from ``local_inputs``'
        rows: local matrices in one batch, world matrices composed level
        by level, then the surfaces' inverses and bounding spheres in one
        batch each."""
        W = self.W_static
        need = np.unique(np.concatenate([self.need[g] for g in groups]))
        if need.size:
            W = W.copy()
            L = self.L_static.copy()
            own = need[self.src[need] != SRC_STATIC]
            row = {n: r for r, n in enumerate(self.dyn)}
            L[own] = local_matrices(inp[[row[int(i)] for i in own]])
            for lv in np.unique(self.level[need]):
                ids = need[self.level[need] == lv]
                W[ids] = _bmm(W[self.parent[ids]], L[ids])
        out = {}
        if "surf" in groups:
            M = W[self.nodes["surf"]]
            n = M.shape[0]
            lin, pos = M[:, :3, :3], M[:, :3, 3]
            s_pos = np.zeros((self.ns, 3), np.float32)
            s_inv = np.zeros((self.ns, 3, 3), np.float32)
            s_fwd = np.zeros((self.ns, 3, 3), np.float32)
            s_bsph = np.zeros((self.ns, 4), np.float32)
            s_pos[:n] = pos
            s_inv[:n] = _inv3_batch(lin)
            s_fwd[:n] = lin
            if self.bnd.size:
                s_bsph[self.bnd] = _bounding_spheres(
                    self.box_ctr, self.box_corners, lin[self.bnd],
                    pos[self.bnd])
            out.update(s_pos=s_pos, s_inv=s_inv, s_fwd=s_fwd, s_bsph=s_bsph)
        if "light" in groups:
            l_pos = np.zeros((self.nl, 3), np.float32)
            ids = self.nodes["light"]
            l_pos[:ids.size] = W[ids][:, :3, 3]
            out["l_pos"] = l_pos
        if "cam" in groups:
            c = W[int(self.nodes["cam"][0])]
            out.update(cam_pos=c[:3, 3], cam_hor=c[:3, 0],
                       cam_ver=c[:3, 1], cam_nrm=c[:3, 2])
        return out


def _staged(fields: Dict[str, np.ndarray],
            device) -> Dict[str, torch.Tensor]:
    """Host f32 arrays to ``device`` in one copy: written into one (pinned,
    for a card) buffer, copied without a wait, split into views."""
    buf = torch.empty((sum(v.size for v in fields.values()),), dtype=F32,
                      pin_memory=device.type == "cuda")
    host, o = buf.numpy(), 0
    for v in fields.values():
        host[o:o + v.size] = v.reshape(-1)
        o += v.size
    buf = buf.to(device, non_blocking=True)
    out, o = {}, 0
    for k, v in fields.items():
        out[k] = buf[o:o + v.size].view(v.shape)
        o += v.size
    return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(I32) if a.dtype == F32 else a,
        b.view(I32) if b.dtype == F32 else b)


def structure_pass(scene: S.SceneDef, time: float = 0.0, cam_index: int = 0,
                   cam_trm: Optional[S.Transform3D] = None,
                   device="cuda") -> SceneStructure:
    """The incremental update's first half, run once per scene and options:
    ``compile_scene`` at (time, cam_trm) on the host for the fields that no
    transform moves (slots, clip programs, untied surfaces, cull
    eligibility, materials, the texture atlas, emission, lights' colours,
    the padded NS/NC/NL), which go to ``device`` once; a walk that records
    the node table ``numeric_pass`` composes; and that table's plan on the
    device (``ops.update.update_tables``). The pass's fields (on a card the
    scene update's launch, on the CPU its plain version) are held against
    that compile at once: a field that differs by a bit raises
    RuntimeError."""
    from quadray_tpu_torch.ops import update
    sc0 = compile_scene(scene, time, cam_index, cam_trm=cam_trm,
                        device="cpu")
    st = SceneStructure(scene, cam_index, device, sc0)
    st.tables = update.update_tables(st, st.device)
    vals = st.local_values(time, cam_trm)
    moved = _moved(st, tuple(MOVED_GROUPS), vals)
    bad = [k for k in MOVED_FIELDS
           if not _bits_equal(moved[k].cpu(), getattr(sc0, k))]
    if bad:
        raise RuntimeError(f"structure_pass: the batched numeric pass "
                           f"differs from compile_scene in {bad}")
    st.keys = st.group_keys(vals)
    fixed = {k: getattr(sc0, k).to(st.device) for k in FIELDS
             if k not in MOVED_FIELDS}
    st.last = SceneArrays(**fixed, **moved)
    return st


def _moved(st: SceneStructure, groups, vals) -> Dict[str, torch.Tensor]:
    """The fields of ``groups`` as new tensors on the structure's device:
    on a card one launch of the scene update's kernel (``ops.update``) on
    the moving nodes' values, staged in one pinned copy; on the CPU the
    plain version (``moved_fields``) in one staged copy."""
    if st.device.type == "cuda":
        from quadray_tpu_torch.ops import update
        return update.moved_fields(st, groups, st.local_inputs(vals))
    return _staged(st.moved_fields(groups, vals), st.device)


def numeric_pass(st: SceneStructure, time: float = 0.0,
                 cam_trm: Optional[S.Transform3D] = None) -> SceneArrays:
    """The incremental update's per-frame half: the SceneArrays of
    ``compile_scene`` at (time, cam_trm), bit for bit, on the structure's
    device. Evaluates the animators and the camera slot on the host, and
    recomputes a group of ``MOVED_GROUPS`` only where a transform it
    depends on changed since the last frame (``_moved``: on a card one
    launch of the scene update's kernel); the recomputed fields are new
    tensors, and every other field is the last frame's tensor, the same
    object. A frame that moves nothing returns the last frame's
    SceneArrays itself. Raises ValueError where the hierarchy differs from
    the one recorded."""
    st.check()
    vals = st.local_values(time, cam_trm)
    keys = st.group_keys(vals)
    groups = tuple(g for g in MOVED_GROUPS if keys[g] != st.keys[g])
    if groups:
        st.last = dataclasses.replace(st.last, **_moved(st, groups, vals))
        st.keys = keys
    return st.last
