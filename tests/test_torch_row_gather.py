"""Replay's row gathers (``ops/row_gather.py`` ``RowGather``, the kernels
of ``csrc/replay.cu``): the forward against ``index_select``, the
backward's fixed-order sum against float64 and against a literal loop of
the kernel's own order, ``gradcheck``, determinism, and ``replay_color``
through it against the JAX replay. On the card: the kernels bitwise
their plain versions at every table height and on the path records of
test01, test13 and demo03 at 800x480.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_row_gather.py --noconftest -q -m cuda
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from quadray_tpu_torch.ops import row_gather as rg

torch.set_num_threads(1)

# table heights: one row, test01's, the JAX replay's one-hot limit and one
# past it, and every row a 12-bit record id can name
HEIGHTS = (1, 4, 64, 65, 4096)
# ray counts: under one tile, a block and one ray more, a ragged count
COUNTS = (33, 1025, 3001)
BITS = lambda t: t.contiguous().view(torch.int32)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc", "replay.cu")


def _ids(rs, n, nt, how):
    """Row ids: "random" over the even rows only (so odd rows are never
    hit), "one" every ray on the last row, "runs" runs of 1-300 rays
    (as a frame's surfaces give)."""
    if how == "one":
        return np.full(n, nt - 1, np.int32)
    if how == "random":
        return (rs.randint(0, (nt + 1) // 2, n) * 2).astype(np.int32)
    out, at = np.empty(n, np.int32), 0
    while at < n:
        k = rs.randint(1, 301)
        out[at:at + k] = rs.randint(0, nt)
        at += k
    return out


def _grad(rs, f, n, dtype=np.float32):
    """A gradient with a sprinkling of +0.0 and -0.0 entries."""
    g = rs.standard_normal((f, n)).astype(dtype)
    g[:, ::7] = 0.0
    g[:, 3::11] = -0.0
    return torch.from_numpy(g)


def _inputs(rs, ns, nm, n, how="random", dtype=np.float32, dev="cpu"):
    stab = torch.from_numpy(rs.standard_normal((19, ns)).astype(dtype))
    mtab = torch.from_numpy(rs.standard_normal((10, nm)).astype(dtype))
    ints = dict(
        s_kind=rs.randint(0, 4, ns).astype(np.int32),
        s_mat=rs.randint(0, nm, (ns, 2)).astype(np.int32),
        m_props=rs.randint(0, 1 << 10, nm).astype(np.int32),
        srf=_ids(rs, n, ns, how))
    t = {k: torch.from_numpy(v).to(dev) for k, v in ints.items()}
    t["sidep"] = torch.from_numpy(rs.rand(n) < 0.5).to(dev)
    return stab.to(dev), mtab.to(dev), t


def _apply(stab, mtab, t):
    return rg.RowGather.apply(stab, mtab, t["s_kind"], t["s_mat"],
                              t["m_props"], t["srf"], t["sidep"])


def _depth(n):
    """Depth of the backward's sum for n rays: the butterfly's 5 levels,
    then the sequential sums over a warp's tiles, a block's warps and
    the blocks."""
    return 5 + rg.TILES + rg.WARPS + -(-n // rg.CHUNK)


def _kernel_loop(g, ids, nt):
    """The backward kernels of csrc/replay.cu as literal float32 loops:
    per block and band, each warp's tiles, a ballot loop over the distinct
    rows of a tile, the xor butterfly per lane, the warp accumulators in
    warp order, then the blocks in block order."""
    g, ids = g.numpy(), ids.numpy()
    nf, n = g.shape
    f32 = np.float32
    blocks = -(-n // rg.CHUNK)
    part = np.zeros((blocks, nf, nt), f32)
    for b in range(blocks):
        for r0 in range(0, nt, 64):
            acc = np.zeros((rg.WARPS, nf, 64), f32)
            for w in range(rg.WARPS):
                for t in range(rg.TILES):
                    base = b * rg.CHUNK + w * rg.TILES * 32 + t * 32
                    key = [ids[i] - r0 if i < n and 0 <= ids[i] - r0 < 64
                           else -1 for i in range(base, base + 32)]
                    for r in sorted({k for k in key if k >= 0},
                                    key=key.index):
                        for f in range(nf):
                            x = [g[f, base + p] if key[p] == r else f32(0)
                                 for p in range(32)]
                            for h in (16, 8, 4, 2, 1):
                                x = [f32(x[p] + x[p ^ h]) for p in range(32)]
                            acc[w, f, r] = f32(acc[w, f, r] + x[0])
            for r in range(min(64, nt - r0)):
                for f in range(nf):
                    s = f32(0)
                    for w in range(rg.WARPS):
                        s = f32(s + acc[w, f, r])
                    part[b, f, r0 + r] = s
    out = np.zeros((nf, nt), f32)
    for b in range(blocks):
        out = (out + part[b]).astype(f32)
    return torch.from_numpy(out)


# ---- on the CPU: the plain versions ------------------------------------------

@pytest.mark.parametrize("ns", HEIGHTS)
def test_forward_is_index_select(ns):
    """Every output bitwise the index_select / integer indexing that
    replay_color did before; integers stay int32."""
    rs = np.random.RandomState(ns)
    nm = max(1, ns // 2)
    stab, mtab, t = _inputs(rs, ns, nm, 3001)
    srows, midx, mrows, skind, props = _apply(stab, mtab, t)
    srf = t["srf"].long()
    want_m = torch.where(t["sidep"], t["s_mat"][srf, 0],
                         t["s_mat"][srf, 1]).long()
    assert torch.equal(BITS(srows), BITS(torch.index_select(stab, 1, srf)))
    assert torch.equal(BITS(mrows), BITS(torch.index_select(mtab, 1,
                                                            want_m)))
    assert torch.equal(midx.long(), want_m)
    assert torch.equal(skind, t["s_kind"][srf])
    assert torch.equal(props, t["m_props"][want_m])
    assert {midx.dtype, skind.dtype, props.dtype} == {torch.int32}


@pytest.mark.parametrize("nt", HEIGHTS)
def test_backward_against_float64(nt):
    """The plain backward against an f64 index_add_, on rows no ray hits
    (exactly +0.0), every ray on one row, and ray counts that are no
    multiple of a tile or a block. Tolerance: the textbook bound on a
    float32 sum, gamma_d * sum |g| with d the depth of the sum's tree
    (Higham, Accuracy and Stability of Numerical Algorithms, section 4.2),
    per table row."""
    rs = np.random.RandomState(1000 + nt)
    for n in COUNTS:
        for how in ("random", "one", "runs"):
            ids = torch.from_numpy(_ids(rs, n, nt, how))
            g = _grad(rs, 19, n)
            got = rg.row_sum_plain(g, ids, nt)
            want = torch.zeros((19, nt), dtype=torch.float64).index_add_(
                1, ids.long(), g.double())
            mag = torch.zeros((19, nt), dtype=torch.float64).index_add_(
                1, ids.long(), g.double().abs())
            u = 2.0 ** -24 * _depth(n)
            assert ((got.double() - want).abs() <= u / (1 - u) * mag).all()
            unhit = torch.bincount(ids.long(), minlength=nt) == 0
            assert (BITS(got[:, unhit]) == 0).all()


@pytest.mark.parametrize("nt", (1, 4, 65))
def test_plain_order_is_the_kernels_loop(nt):
    """row_sum_plain, which forms only the (tile, row) pairs that occur,
    bitwise a literal float32 loop of the kernels' order."""
    rs = np.random.RandomState(2000 + nt)
    for n, how in ((33, "random"), (3001, "runs"), (1025, "one")):
        ids = torch.from_numpy(_ids(rs, n, nt, how))
        g = _grad(rs, 3, n)
        assert torch.equal(BITS(rg.row_sum_plain(g, ids, nt)),
                           BITS(_kernel_loop(g, ids, nt)))


def test_gradcheck_float64():
    """The plain version's backward against finite differences, in
    gradcheck's fast mode (a random projection of the Jacobian: one
    backward call over 1,100 rays and a surface table of two bands)."""
    rs = np.random.RandomState(7)
    stab, mtab, t = _inputs(rs, 70, 5, 1100, dtype=np.float64)
    stab.requires_grad_(True)
    mtab.requires_grad_(True)

    def floats(a, b):
        out = _apply(a, b, t)
        return out[0], out[2]

    assert torch.autograd.gradcheck(floats, (stab, mtab), fast_mode=True)


def test_backward_is_deterministic_and_only_floats_differentiate():
    rs = np.random.RandomState(8)
    stab, mtab, t = _inputs(rs, 104, 9, 3001, "runs")
    g = (_grad(rs, 19, 3001), _grad(rs, 10, 3001))
    grads = []
    for _ in range(2):
        a, b = stab.clone().requires_grad_(True), mtab.clone() \
            .requires_grad_(True)
        srows, midx, mrows, skind, props = _apply(a, b, t)
        assert not any(x.requires_grad for x in (midx, skind, props))
        torch.autograd.backward((srows, mrows), g)
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        assert torch.equal(BITS(x), BITS(y))
    # a table whose gradient no one asks for is not summed
    a = stab.clone().requires_grad_(True)
    torch.autograd.backward(_apply(a, mtab, t)[0], g[0])
    assert torch.equal(BITS(a.grad), BITS(grads[0][0]))


def test_argtypes_match_the_c_entry_points():
    """ARGTYPES against the extern "C" signatures of csrc/replay.cu:
    a pointer for each pointer parameter and the stream, an int for each
    int."""
    with open(SRC) as fh:
        src = fh.read()
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {name for name, _ in found} == set(rg.ARGTYPES)
    for name, params in found:
        kinds = ["p" if "*" in p else "i" for p in params.split(",")]
        want = ["p" if t is rg._VOIDP else "i" for t in rg.ARGTYPES[name]]
        assert kinds == want, name


def test_other_devices_raise():
    rs = np.random.RandomState(9)
    stab, mtab, t = _inputs(rs, 4, 2, 40)
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError):
        _apply(stab.to("meta"), mtab.to("meta"), meta)


@pytest.mark.parametrize("name,jit", [("test01", True), ("test13", False)])
def test_replay_through_row_gather_matches_jax(name, jit, monkeypatch):
    """replay_color on records of the port's plain trace_paths (bitwise
    the JAX kernel's, tests/test_torch_paths.py), 48x32, K=4: colors and
    the gradients of every DIFFERENTIABLE_FIELDS entry against the JAX
    replay_color under tests/test_torch_replay.py's tolerances, every
    segment's backward through row_sum_plain. test13 has 104 surfaces,
    over the JAX replay's one-hot limit of 64; its JAX replay runs op by
    op (jax.disable_jit): jitted, XLA's CPU contraction moves its
    gradients by up to 1.0e-4 (well-conditioned lanes) and 1.5e-3 (all)
    of the largest, whether the port sums the table rows in this order,
    in ray order or in float64 (those three agree within 1.4e-7).
    The loss clips with minimum/maximum, whose gradient at a tie is
    jnp.clip's one half on both sides (torch.clamp passes all of it:
    ROADMAP section 3). Colors are held on the lanes whose color moves by
    less than PRIMAL_ATOL when the ray moves by one ulp (over 99%)."""
    import contextlib
    import jax
    import jax.numpy as jnp
    from test_torch_replay import (GRAD_RTOL, GRAD_RTOL_ALL, PRIMAL_ATOL,
                                   _grads_close, _torch_scene,
                                   _ulp_sensitivity)
    from quadray_tpu.models.scenes.loader import load_scene
    from quadray_tpu.ops.rays import camera_rays as jrays
    from quadray_tpu.ops.replay import replay_color as jreplay
    from quadray_tpu.ops.trace import TraceConfig as JConfig
    from quadray_tpu.scene import schema as S
    from quadray_tpu.scene.compile import compile_scene
    from quadray_tpu_torch.ops.replay import replay_color
    from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths
    from quadray_tpu_torch.parallel.train import DIFFERENTIABLE_FIELDS

    w, h, k = 48, 32, 4
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    org1, dirs = jrays(j.cam_pos, j.cam_hor, j.cam_ver, j.cam_nrm,
                       j.cam_pov, w, h, 1)
    n = dirs.shape[0]
    jr = (jnp.broadcast_to(org1[None, :], (n, 3)), dirs,
          jnp.full((n,), j.cam_pov, jnp.float32))
    tr = tuple(torch.from_numpy(np.array(a)) for a in jr)
    sc, _ = _torch_scene(j, ())
    _, tpaths = trace_paths(sc, *tr, TraceConfig(), k)
    paths = jnp.asarray(tpaths.numpy())
    with torch.no_grad():
        s = _ulp_sensitivity(lambda d: replay_color(
            sc, tr[0], d, tr[2], tpaths), tr[1])
    well = s <= PRIMAL_ATOL
    assert well.mean() > 0.99

    def jgrads(params, wmask):
        def jloss(params):
            cols = jreplay(j.replace(**params), *jr, paths, JConfig())
            clipped = jnp.minimum(jnp.maximum(cols, 0.0), 1.0)
            return jnp.sum(clipped * wmask[:, None]), cols
        return jax.value_and_grad(jloss, has_aux=True)(params)

    calls = []
    plain = rg.row_sum_plain
    monkeypatch.setattr(rg, "row_sum_plain",
                        lambda *a: calls.append(1) or plain(*a))
    zero, one = torch.tensor(0.0), torch.tensor(1.0)
    for wmask, rtol in ((well, GRAD_RTOL), (np.ones_like(well),
                                            GRAD_RTOL_ALL)):
        wmask = wmask.astype(np.float32)
        with contextlib.nullcontext() if jit else jax.disable_jit():
            (_, want), jg = (jax.jit(jgrads) if jit else jgrads)(
                {f: getattr(j, f) for f in DIFFERENTIABLE_FIELDS}, wmask)
        tsc, leaves = _torch_scene(j, DIFFERENTIABLE_FIELDS)
        got = replay_color(tsc, *tr, tpaths)
        (torch.minimum(torch.maximum(got, zero), one)
         * torch.from_numpy(wmask)[:, None]).sum().backward()
        d = np.abs(got.detach().numpy() - np.asarray(want)).max(axis=1)
        assert d[well].max() <= PRIMAL_ATOL
        _grads_close(leaves, jg, DIFFERENTIABLE_FIELDS, rtol)
    # both tables' backward, every segment, both runs
    assert len(calls) == 2 * 2 * k
    if name == "test13":
        assert sc.s_pos.shape[0] > 64


# ---- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _both_on_card(stab, mtab, t, g):
    """(kernel outputs, kernel grads) twice and the plain versions', all
    on the card; asserts the launch counts."""
    runs = []
    for _ in range(2):
        a, b = stab.clone().requires_grad_(True), mtab.clone() \
            .requires_grad_(True)
        f0, b0 = rg.launches, rg.backward_launches
        out = _apply(a, b, t)
        torch.autograd.backward((out[0], out[2]), g)
        assert (rg.launches, rg.backward_launches) == (f0 + 1, b0 + 1)
        runs.append((out, (a.grad, b.grad)))
    srf = t["srf"]
    plain = rg.gather_plain(stab, mtab, t["s_kind"], t["s_mat"],
                            t["m_props"], srf, t["sidep"])
    grads = (rg.row_sum_plain(g[0], srf, stab.shape[1]),
             rg.row_sum_plain(g[1], plain[1], mtab.shape[1]))
    torch.cuda.synchronize()
    for out, got in runs:
        for x, y in zip(out, plain):
            assert torch.equal(BITS(x), BITS(y))
        for x, y in zip(got, grads):
            assert torch.equal(BITS(x), BITS(y))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", HEIGHTS)
def test_kernels_bitwise_plain_on_card(ns):
    """Random tables of every height, 800x480 rays and one more, in runs
    and random: forward and backward bitwise the plain versions, two
    launches bitwise each other."""
    dev = _card()
    rs = np.random.RandomState(ns)
    n = 800 * 480 + 1
    for how in ("runs", "random", "one"):
        stab, mtab, t = _inputs(rs, ns, max(1, ns // 3), n, how, dev=dev)
        g = (_grad(rs, 19, n).to(dev), _grad(rs, 10, n).to(dev))
        _both_on_card(stab.to(dev), mtab.to(dev), t, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test01", "test13", "demo03"])
def test_kernels_bitwise_plain_on_records(name):
    """Every segment of the path records of the training configuration
    (800x480, K=8) of test01, test13 and demo03, the scene's own tables
    and a seeded gradient."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.replay import record_ids, row_tables
    from quadray_tpu_torch.ops.trace import TraceConfig
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    dev = _card()
    sd = load_scene(name)
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, 800, 480, 1)
    _, paths = ck.trace_paths(sc, org, dirs, sc.cam_pov.expand(
        dirs.shape[0]), TraceConfig(max_segments=8, stack=4), 8)
    stab, mtab = row_tables(sc)
    rs = np.random.RandomState(3)
    n = dirs.shape[0]
    for rec in paths:
        srf, sidep = record_ids(rec)
        t = dict(s_kind=sc.s_kind, s_mat=sc.s_mat, m_props=sc.m_props,
                 srf=srf, sidep=sidep)
        g = (_grad(rs, 19, n).to(dev), _grad(rs, 10, n).to(dev))
        _both_on_card(stab, mtab, t, g)


@pytest.mark.cuda
def test_cuda_inputs_never_take_the_plain_versions(monkeypatch):
    """replay_color forward and backward on the card with the plain
    versions made to raise: one forward and one backward launch a
    segment."""
    from quadray_tpu_torch.models.scenes.loader import load_scene
    from quadray_tpu_torch.ops import cuda_kernel as ck
    from quadray_tpu_torch.ops.rays import camera_rays
    from quadray_tpu_torch.ops.replay import replay_color
    from quadray_tpu_torch.scene import schema as S
    from quadray_tpu_torch.scene.compile import compile_scene
    dev = _card()

    def refuse(*a):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(rg, "gather_plain", refuse)
    monkeypatch.setattr(rg, "row_sum_plain", refuse)
    sd = load_scene("test01")
    sc = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                       device=dev)
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, 64, 40, 1)
    tmin = sc.cam_pov.expand(dirs.shape[0])
    _, paths = ck.trace_paths(sc, org, dirs, tmin, k_paths=4)
    pos = sc.s_pos.clone().requires_grad_(True)
    col = sc.m_col.clone().requires_grad_(True)
    f0, b0 = rg.launches, rg.backward_launches
    sc2 = dataclasses.replace(sc, s_pos=pos, m_col=col)
    replay_color(sc2, org, dirs, tmin, paths).sum().backward()
    torch.cuda.synchronize()
    assert (rg.launches - f0, rg.backward_launches - b0) == (4, 4)
    assert bool(torch.isfinite(pos.grad).all() & torch.isfinite(col.grad)
                .all())
