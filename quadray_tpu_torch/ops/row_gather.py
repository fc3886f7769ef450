"""The row gathers (``csrc/replay.cu``), their plain PyTorch versions
and the ``torch.autograd.Function`` that joins them.

The counterpart of the JAX replay's one-hot row lookups
(``quadray_tpu/ops/replay.py:107-135``, ``_onehot``/``_rows``/``_irow``)
and of the JAX tracer's per-ray table lookups under ``value_and_grad``
(``quadray_tpu/ops/trace.py:388, 405-461, 514-569, 642``), whose
transpose XLA turns into a scatter-add. Once a path segment,
``replay_color`` looks up each ray's row of the transposed surface table
``stab`` (19, NS) and material table ``mtab`` (10, NM) (``row_tables``),
and its surface kind and material property bits; once a bounce,
``ops.trace.trace_rays_diff`` does the same at each ray's nearest hit.
``RowGather`` does the whole lookup of a segment: the forward is one
kernel launch that writes the 29 float rows and the integer fields in
(F, N) layout; the backward sums the gradient of the gathered rows into
the two tables with no atomics, in one fixed order (``csrc/replay.cu``'s
header) that ``row_sum_plain`` follows bit for bit, so a step's
gradients are the same bits run after run. Integer tables are gathered
as integers, never through floats.

On CUDA tensors the forward and backward launch their kernels
(``launches`` and ``backward_launches`` count the calls) or raise; on
CPU tensors they run the plain versions ``gather_plain`` (``index_select``)
and ``row_sum_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from quadray_tpu_torch.ops.cuda_kernel import _check

F32 = torch.float32
I32 = torch.int32
SURFACE_ROWS, MATERIAL_ROWS = 19, 10

# the backward's order (csrc/replay.cu): lanes of a tile, tiles of a
# warp, warps of a block
WARP, TILES, WARPS = 32, 8, 4
CHUNK = WARP * TILES * WARPS

# the material table's rows by field (row_tables)
MATERIAL_FIELDS = ("col_r", "col_g", "col_b", "dff", "spc", "pow", "rfl",
                   "trn", "rfr", "ext")

# calls of the forward kernel and of the backward's two kernels
launches = 0
backward_launches = 0

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# the C entry points' arguments, in csrc/replay.cu order (the library's
# all: the fused replay's two are launched by ops/replay.py, the light
# sums by ops/diff.py too)
ARGTYPES = {
    "row_gather_launch": [_VOIDP] * 12 + [_INT] * 3 + [_VOIDP],
    "row_gather_backward_launch": [_VOIDP] * 8 + [_INT] * 3 + [_VOIDP],
    "replay_forward_launch": [_VOIDP] * 15 + [_INT] * 6 + [_VOIDP],
    "replay_backward_launch": [_VOIDP] * 18 + [_INT] * 5 + [_VOIDP],
    "replay_light_sums_launch": [_VOIDP] * 3 + [_INT] * 2 + [_VOIDP],
}


def _lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("replay")
    if lib.row_gather_launch.argtypes is None:
        for fn, types in ARGTYPES.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def row_tables(sc):
    """The tables the gathers read rows of: the surface table, transposed
    (19, NS): pos 0-2, inv 3-11, sci 12-14, scjh 15-17, sciw 18; the
    material table (10, NM): col 0-2, dff, spc, pow, rfl, trn, rfr, ext
    (MATERIAL_FIELDS). Both contiguous, differentiable in the scene's
    fields, in the scene's float type."""
    ns = sc.s_pos.shape[0]
    stab = torch.cat([sc.s_pos, sc.s_inv.reshape(ns, 9), sc.s_sci,
                      sc.s_scjh, sc.s_sciw[:, None]], dim=1).T.contiguous()
    mtab = torch.stack([
        sc.m_col[:, 0], sc.m_col[:, 1], sc.m_col[:, 2], sc.m_dff,
        sc.m_spc, sc.m_pow, sc.m_rfl, sc.m_trn, sc.m_rfr, sc.m_ext])
    return stab, mtab


def gather_plain(stab, mtab, s_kind, s_mat, m_props, srf, sidep):
    """(srows (19, N), midx (N,), mrows (10, N), skind (N,), props (N,)):
    the rows of the ray ids ``srf`` and, through the side-picked material
    ``midx`` (``s_mat[srf, 0]`` where ``sidep``, else ``[srf, 1]``), of
    the material table; integer fields in the integer tables' dtype."""
    srows = torch.index_select(stab, 1, srf)
    midx = torch.where(sidep, s_mat[srf, 0], s_mat[srf, 1])
    mrows = torch.index_select(mtab, 1, midx)
    return srows, midx, mrows, s_kind[srf], m_props[midx]


def row_sum_plain(g, ids, nt: int) -> torch.Tensor:
    """(F, nt): column i of ``g`` (F, N) added into row ``ids[i]``, in the
    backward kernel's order (``csrc/replay.cu``): each tile of 32 rays an
    xor butterfly over its lanes (+0.0 where a lane holds another row),
    then from +0.0 and in order the tiles of a warp, the warps of a block
    and the blocks. Only the (tile, row) pairs that occur are formed; an
    absent child of a sequential sum adds +0.0, which changes no bit."""
    nf, n = g.shape
    out = g.new_zeros((nf, nt))
    if n == 0:
        return out
    i = torch.arange(n, device=g.device)
    pairs, inv = torch.unique((i // WARP) * nt + ids.long(),
                              return_inverse=True)
    x = g.new_zeros((nf, pairs.numel(), WARP))
    x[:, inv, i % WARP] = g
    h = WARP // 2
    while h:
        x = x[..., :h] + x[..., h:2 * h]
        h //= 2
    s = x[..., 0]
    child, row = pairs // nt, pairs % nt
    for per in (TILES, WARPS, -(-n // CHUNK)):
        parents, pinv = torch.unique((child // per) * nt + row,
                                     return_inverse=True)
        d = g.new_zeros((nf, parents.numel(), per))
        d[:, pinv, child % per] = s
        s = g.new_zeros((nf, parents.numel()))
        for c in range(per):
            s = s + d[..., c]
        child, row = parents // nt, parents % nt
    out[:, row] = s
    return out


def _forward(stab, mtab, s_kind, s_mat, m_props, srf, sidep):
    global launches
    dev = srf.device
    if dev.type == "cpu":
        return gather_plain(stab, mtab, s_kind, s_mat, m_props, srf, sidep)
    if dev.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {dev}")
    n, ns, nm = srf.shape[0], stab.shape[1], mtab.shape[1]
    for name, t, dtype, shape in (
            ("stab", stab, F32, (SURFACE_ROWS, ns)),
            ("mtab", mtab, F32, (MATERIAL_ROWS, nm)),
            ("s_kind", s_kind, I32, (ns,)), ("s_mat", s_mat, I32, (ns, 2)),
            ("m_props", m_props, I32, (nm,)), ("srf", srf, I32, (n,)),
            ("sidep", sidep, torch.bool, (n,))):
        _check(name, t, dtype, shape, dev)
    srows = torch.empty((SURFACE_ROWS, n), dtype=F32, device=dev)
    mrows = torch.empty((MATERIAL_ROWS, n), dtype=F32, device=dev)
    midx, skind, props = (torch.empty((n,), dtype=I32, device=dev)
                          for _ in range(3))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.row_gather_launch(
            stab.data_ptr(), mtab.data_ptr(), s_kind.data_ptr(),
            s_mat.data_ptr(), m_props.data_ptr(), srf.data_ptr(),
            sidep.data_ptr(), srows.data_ptr(), mrows.data_ptr(),
            midx.data_ptr(), skind.data_ptr(), props.data_ptr(), n, ns, nm,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row gather kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return srows, midx, mrows, skind, props


def _backward(g_s, g_m, srf, midx, ns: int, nm: int):
    """The two tables' gradients (None where g is None), from the
    gathered rows' gradients g_s (19, N) and g_m (10, N)."""
    global backward_launches
    dev = srf.device
    if dev.type == "cpu":
        return (None if g_s is None else row_sum_plain(g_s, srf, ns),
                None if g_m is None else row_sum_plain(g_m, midx, nm))
    if dev.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {dev}")
    n = srf.shape[0]
    blocks = -(-n // CHUNK)
    bufs = {}   # table -> (gradient, partials, table gradient)
    for key, g, f, nt in (("s", g_s, SURFACE_ROWS, ns),
                          ("m", g_m, MATERIAL_ROWS, nm)):
        if g is not None:
            g = g.contiguous()
            _check(f"g_{key}rows", g, F32, (f, n), dev)
            bufs[key] = (g, torch.empty((blocks, f, nt), dtype=F32,
                                        device=dev),
                         torch.empty((f, nt), dtype=F32, device=dev))
    ptr = lambda key, j: bufs[key][j].data_ptr() if key in bufs else 0
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.row_gather_backward_launch(
            ptr("s", 0), ptr("m", 0), srf.data_ptr(), midx.data_ptr(),
            ptr("s", 1), ptr("m", 1), ptr("s", 2), ptr("m", 2), n,
            ns if "s" in bufs else 0, nm if "m" in bufs else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row gather backward launch failed: CUDA error "
                           f"{err}")
    backward_launches += 1
    return tuple(bufs[key][2] if key in bufs else None for key in "sm")


class RowGather(torch.autograd.Function):
    """One segment's lookups: (srows (19, N), midx, mrows (10, N), skind,
    props) from the tables and the segment's ray ids ``srf`` (N,) i32 and
    sides ``sidep`` (N,) bool. Differentiable in ``stab`` and ``mtab``
    only; the integer outputs are not differentiable."""

    @staticmethod
    def forward(ctx, stab, mtab, s_kind, s_mat, m_props, srf, sidep):
        out = _forward(stab, mtab, s_kind, s_mat, m_props, srf, sidep)
        ctx.save_for_backward(srf, out[1])
        ctx.heights = (stab.shape[1], mtab.shape[1])
        ctx.mark_non_differentiable(out[1], out[3], out[4])
        return out

    @staticmethod
    def backward(ctx, g_srows, _g_midx, g_mrows, _g_skind, _g_props):
        srf, midx = ctx.saved_tensors
        want_s, want_m = ctx.needs_input_grad[:2]
        g_stab, g_mtab = _backward(g_srows if want_s else None,
                                   g_mrows if want_m else None, srf, midx,
                                   *ctx.heights)
        return g_stab, g_mtab, None, None, None, None, None
