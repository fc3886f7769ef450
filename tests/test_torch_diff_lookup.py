"""The all-surface step's table reads through the row gather: each bounce
of ``ops/trace.py`` ``trace_rays_diff`` reads the trained float tables at
its rays' hits with one ``ops/row_gather.py`` ``RowGather`` call
(``Gathered``: ``csrc/replay.cu`` on the card), in place of a lookup at
each site, whose backward PyTorch runs as ``index_put_`` with
accumulate. On the CPU: the route's colors bitwise ``trace_rays``'s on
test17, test18 and test13; each bounce's table gradients bitwise
``row_sum_plain`` of its gathered rows' gradients, and the material
fields' gradients those row sums' rows; no ``aten.index`` or
``index_put_`` on a trained float table across one all-surface step
(and the lookups the route replaced counted, as a control); the float64
element type refused off the CPU. On the card: ``RowGather`` at the
route's shapes (384,000 rays, test17's 8 surfaces and 5 materials,
test13's 128 and 10) bitwise its plain versions.

No test here imports JAX, so the card's tests run on a GPU machine
without it:
    python -m pytest tests/test_torch_diff_lookup.py --noconftest -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import row_gather as rg
from quadray_tpu_torch.ops import trace
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import TraceConfig, trace_rays, \
    trace_rays_diff
from quadray_tpu_torch.parallel import train as ttrain
from quadray_tpu_torch.parallel.mesh import ray_mesh
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

W, H = 24, 16
CFG = TraceConfig(max_segments=8, stack=4)
CPU = torch.device("cpu")
BITS = lambda t: t.contiguous().view(torch.int32)
# the trained material fields and their rows of the material table
MAT_ROWS = {"m_dff": 3, "m_spc": 4, "m_rfl": 6, "m_trn": 7, "m_rfr": 8}


def _compiled(name, device=CPU):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _rays(sc):
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, W, H, 1)
    return org, dirs, sc.cam_pov.expand(dirs.shape[0])


def _trained(sc):
    """(sc with every differentiable field a leaf that requires grad, the
    leaves)."""
    leaves = {k: getattr(sc, k).clone().requires_grad_(True)
              for k in ttrain.DIFFERENTIABLE_FIELDS}
    return dataclasses.replace(sc, **leaves), leaves


class _Recorder:
    """Stands in for ``RowGather`` and records each call: the row ids and,
    after the backward, the gradients of the gathered rows and of the
    tables that call read (each call reads copies of the tables, so that
    their gradient is this call's alone)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = rg.RowGather.apply
        rec = self

        class Stand:
            @staticmethod
            def apply(stab, mtab, s_kind, s_mat, m_props, srf, sidep):
                c = {"srf": srf, "ns": stab.shape[1], "nm": mtab.shape[1]}
                stab, mtab = stab.clone(), mtab.clone()
                out = real(stab, mtab, s_kind, s_mat, m_props, srf, sidep)
                c["midx"] = out[1]
                for key, t in (("stab", stab), ("mtab", mtab),
                               ("srows", out[0]), ("mrows", out[2])):
                    if t.requires_grad:
                        t.register_hook(
                            lambda g, _k=key: c.__setitem__(_k, g))
                rec.calls.append(c)
                return out

        monkeypatch.setattr(rg, "RowGather", Stand)


@pytest.mark.parametrize("name", ["test17", "test18", "test13"])
def test_diff_route_colors_bitwise_trace_rays(name, monkeypatch):
    """The differentiable route (every differentiable field a leaf) and
    the plain tracer give the same color bits (a gather is exact: the
    forward reads the same words), test13 with its 128 surfaces, two clip
    slots and textures; the route made one gather a bounce."""
    sc = _compiled(name)
    rays = _rays(sc)
    want = trace_rays(sc, *rays, CFG)
    rec = _Recorder(monkeypatch)
    got = trace_rays_diff(_trained(sc)[0], *rays, CFG)
    assert len(rec.calls) == CFG.max_segments
    assert got.requires_grad
    assert torch.equal(BITS(got.detach()), BITS(want))


@pytest.mark.parametrize("name", ["test17", "test13"])
def test_table_gradients_are_the_row_sums(name, monkeypatch):
    """Hooks on each bounce's gathered rows and on the tables it read:
    each bounce's table gradients are row_sum_plain of its rows'
    gradients bit for bit, the gather kernel's order; with one bounce,
    each trained material field's gradient is its rows of those sums
    (equal values; a signed zero may change sign in autograd's sum of
    the table's slices)."""
    sc = _compiled(name)
    rays = _rays(sc)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (W * H, 3)).astype(np.float32))
    rec = _Recorder(monkeypatch)
    for cfg in (CFG, CFG._replace(max_segments=1)):
        rec.calls = []
        s2, leaves = _trained(sc)
        cols = trace_rays_diff(s2, *rays, cfg)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            (cols * w).sum(), [leaves[k] for k in names])))
        assert len(rec.calls) == cfg.max_segments
        for c in rec.calls:
            for tab, rows, ids, nt in (("stab", "srows", c["srf"], c["ns"]),
                                       ("mtab", "mrows", c["midx"], c["nm"])):
                want = rg.row_sum_plain(c[rows], ids, nt)
                assert torch.equal(BITS(c[tab]), BITS(want)), (tab, cfg)
        if cfg.max_segments == 1:
            (c,) = rec.calls
            g_m = rg.row_sum_plain(c["mrows"], c["midx"], c["nm"])
            for k, r in MAT_ROWS.items():
                assert torch.equal(grads[k], g_m[r]), k
            assert torch.equal(grads["m_col"], g_m[0:3].T)
            assert bool(g_m[3].abs().sum() > 0)


class _TableIndexing(TorchDispatchMode):
    """Counts the aten indexing ops with an index of one entry a ray on a
    trained table: ``index.Tensor`` on a float tensor that requires grad,
    of a trained table's shape (a lookup; the untrained texture fields of
    the same height do not count), and ``index_put`` or
    ``_index_put_impl_`` into a float tensor of such a shape (its
    backward)."""
    OPS = ("aten.index.Tensor", "aten.index_put", "aten._index_put_impl_")

    def __init__(self, shapes, rays: int):
        super().__init__()
        self.shapes, self.rays, self.hits = shapes, rays, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.OPS):
            self_t, index = args[0], args[1]
            if (self_t.is_floating_point()
                    and tuple(self_t.shape) in self.shapes
                    and (self_t.requires_grad or "put" in name)
                    and any(i is not None and i.numel() == self.rays
                            for i in index)):
                self.hits.append((name, tuple(self_t.shape)))
        return func(*args, **(kwargs or {}))


def _old_route(sc, org, dirs, t_min, cfg):
    """The route before the gather: the same bounces with a lookup at
    each site (the plain tracer's reads), under autograd."""
    if org.dim() == 1:
        org = org[None, :].expand(dirs.shape[0], 3)
    return trace._trace_chunk(sc, org, dirs, t_min, cfg, 0, fixed=True)[0]


@pytest.mark.parametrize("name", ["test17", "test13"])
def test_step_runs_no_index_on_trained_tables(name, monkeypatch):
    """One all-surface step (make_train_step's body: forward, backward,
    Adam) runs no aten.index and no index_put_ on a trained float table
    with an index a ray: on its own route (ops/diff.py) and with
    trace_rays_diff, the autograd route, in its place; the old route's
    lookups, in the same step, are counted (a slide back to indexing
    fails here)."""
    sc = _compiled(name)
    target = torch.zeros((W * H, 3))
    shapes = {tuple(getattr(sc, k).shape)
              for k in ttrain.DIFFERENTIABLE_FIELDS}
    counts = {}
    for route in ("fused", "gather", "old"):
        if route != "fused":
            fn = trace_rays_diff if route == "gather" else _old_route
            monkeypatch.setattr(ttrain, "trace_rays_fused", fn)
        step_fn, _ = ttrain.make_train_step(W, H, cfg=CFG,
                                            mesh=ray_mesh([CPU]))
        params = ttrain.extract_params(sc)
        with _TableIndexing(shapes, W * H) as mode:
            step_fn(params, ttrain.adam_init(params), sc, target)
        counts[route] = mode.hits
    assert counts["fused"] == []
    assert counts["gather"] == []
    ops = {op for op, _ in counts["old"]}
    assert "aten.index.Tensor" in ops and len(ops) > 1, counts["old"]
    assert len(counts["old"]) >= 2 * 7 * CFG.max_segments


def test_f64_off_the_cpu_raises():
    """The gather's kernels take float32: the float64 element type on a
    tensor off the CPU raises before any work, naming the element type."""
    sc = _compiled("test01")
    org, dirs, t_min = (t.to("meta") for t in _rays(sc))
    trace.set_element(torch.float64)
    try:
        with pytest.raises(ValueError, match="float64"):
            trace_rays_diff(sc, org, dirs, t_min, CFG)
    finally:
        trace.set_element(torch.float32)


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the gather kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test17", "test13"])
def test_gather_at_route_shapes_bitwise_on_card(name):
    """RowGather's kernels at the route's shapes (800x480 = 384,000 rays;
    test17's 8 surfaces and 5 materials, test13's 128 and 10), seeded
    row ids and gradients: the forward bitwise gather_plain and the
    backward bitwise row_sum_plain, twice."""
    dev = _card()
    sc = _compiled(name, dev)
    with torch.no_grad():
        stab, mtab = rg.row_tables(sc)
    ns, nm, n = stab.shape[1], mtab.shape[1], 800 * 480
    rs = np.random.default_rng(23)
    srf = torch.from_numpy(rs.integers(0, ns, n).astype(np.int32)).to(dev)
    sidep = torch.from_numpy(rs.random(n) < 0.7).to(dev)
    gs, gm = (torch.from_numpy(rs.standard_normal((f, n)).astype(
        np.float32)).to(dev) for f in (rg.SURFACE_ROWS, rg.MATERIAL_ROWS))
    args = (sc.s_kind, sc.s_mat, sc.m_props, srf, sidep)
    want = rg.gather_plain(stab, mtab, *args)
    want_g = (rg.row_sum_plain(gs, srf, ns), rg.row_sum_plain(gm, want[1],
                                                              nm))
    for _ in range(2):
        got = rg._forward(stab, mtab, *args)
        got_g = rg._backward(gs, gm, srf, got[1], ns, nm)
        torch.cuda.synchronize()
        for x, y in zip(got + got_g, want + want_g):
            assert torch.equal(BITS(x), BITS(y))


@pytest.mark.cuda
def test_diff_route_launches_the_gather_on_card():
    """trace_rays_diff on the card, test17 at 96x64: one gather forward a
    bounce and, after the backward, one row-sum call a bounce; the colors
    bitwise the plain tracer's on the card."""
    dev = _card()
    sc = _compiled("test17", dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, 96, 64, 1)
    t_min = sc.cam_pov.expand(dirs.shape[0])
    s2, leaves = _trained(sc)
    f0, b0 = rg.launches, rg.backward_launches
    cols = trace_rays_diff(s2, org, dirs, t_min, CFG)
    assert rg.launches - f0 == CFG.max_segments
    cols.sum().backward()
    torch.cuda.synchronize()
    assert rg.backward_launches - b0 == CFG.max_segments
    want = trace_rays(sc, org, dirs, t_min, CFG)
    assert torch.equal(BITS(cols.detach()), BITS(want))
