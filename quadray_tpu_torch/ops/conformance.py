"""The kernel-op conformance tier: the cases of ``tests/test_conformance.py``
as CUDA kernels (``csrc/conformance.cu``), their plain PyTorch versions and
their inputs.

The counterpart of that test's ``_pallas_elementwise`` (one Pallas kernel
per case, held to the same function through XLA on the same device). Each
case is an elementwise function of one to three (R, 128) tiles: the ten
ops of its CASES (add, mul, div, sqrt, rsqrt, exp, log, the ``x*y+y``
pattern, max-min, abs of a negation), and the megakernel's building
blocks (the quadric roots, exact Fresnel, the specular power
``exp(p*log x)``, the lane gather, the kernel's own ``root``/``sdiv``).
The kernels are built with the megakernel's flags (no FMA contraction,
IEEE division and sqrt), so they show whether that compiler keeps the f32
rules the golden frames depend on.

``conformance(name, *args)`` runs case ``name``: on CUDA tensors it
launches the case's kernel (``launches`` counts them) or raises; on CPU
tensors it runs the plain version ``plain(name, *args)``. A kernel thread
takes four consecutive elements with 16-byte loads where every pointer is
16-byte aligned, and the elements a 16-byte group cannot take one by one
(``vector_split``). The plain
versions compute as the kernels do: sqrt and rsqrt correctly rounded
(through float64, as ``ops/trace.py``), the megakernel's blocks through
the plain tracer's own helpers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quadray_tpu_torch.ops.trace import (BIG, D_EPS, T_EPS, _root,
                                         _rsqrt, _safe_div, _sgn, _sqrt)

F32 = torch.float32
I32 = torch.int32
LANES = 128

# the cases, in the kernel's Op order (csrc/conformance.cu)
CASES = ("add", "mul", "div", "sqrt", "rsqrt", "exp", "log", "fma",
         "min_max", "abs_neg", "roots", "fresnel", "spec_pow", "gather",
         "root_sdiv")
# inputs each case takes; the gather's second input is i32 indices
NARGS = dict(add=2, mul=2, div=2, sqrt=1, rsqrt=1, exp=1, log=1, fma=2,
             min_max=2, abs_neg=1, roots=3, fresnel=2, spec_pow=2, gather=2,
             root_sdiv=2)
# input ranges of the elementwise ops (test_conformance.py:53-69)
OP_RANGES = {"add": (-1e3, 1e3), "mul": (-1e3, 1e3), "div": (0.5, 1e3),
             "sqrt": (0.0, 1e4), "rsqrt": (1e-4, 1e4), "exp": (-8.0, 8.0),
             "log": (1e-4, 1e4), "fma": (-1e2, 1e2),
             "min_max": (-1e3, 1e3), "abs_neg": (-1e3, 1e3)}

launches = 0


def _rand(shape, lo, hi, seed):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def case_inputs(name: str, rows: int = 8) -> list:
    """The inputs of case ``name`` as numpy arrays of shape (rows, 128),
    made as tests/test_conformance.py makes them (same seeds and ranges;
    at rows=8 the same values)."""
    shape = (rows, LANES)
    if name in OP_RANGES:
        lo, hi = OP_RANGES[name]
        return [_rand(shape, lo, hi, i + 1) for i in range(NARGS[name])]
    if name == "roots":
        a = _rand(shape, -2, 2, 10)
        b = _rand(shape, -3, 3, 11)
        # near-zero determinants: c = (b^2 - eps) / a
        eps = _rand(shape, -1e-12, 1e-12, 12)
        one = np.float32(1.0)
        c = (b * b - eps) / np.where(np.abs(a) < np.float32(1e-3), one, a)
        return [a, b, c.astype(np.float32)]
    if name == "fresnel":
        return [_rand(shape, 0.5, 2.0, 20), _rand(shape, -1.0, -1e-3, 21)]
    if name == "spec_pow":
        return [_rand(shape, 1e-6, 1.0, 30), _rand(shape, 1.0, 64.0, 31)]
    if name == "gather":
        rs = np.random.RandomState(40)
        return [rs.randn(*shape).astype(np.float32),
                rs.randint(0, LANES, shape).astype(np.int32)]
    if name == "root_sdiv":
        num = _rand(shape, -4, 4, 50)
        den = _rand(shape, -4, 4, 51)
        # exact zeros in both operands (the nan-root rule's domain)
        num[0, :8] = 0.0
        den[1, :8] = 0.0
        return [num, den]
    raise ValueError(f"unknown conformance case {name!r}")


def random_rays(n: int, seed: int, spread: float = 6.0):
    """n non-camera rays as tests/test_conformance.py:205-211 makes them:
    (origins (n, 3) uniform in [-spread, spread), unit directions (n, 3)),
    numpy f32. They hold the megakernel as written (clip programs, branch
    stack) to the plain tracer on rays no camera casts."""
    rs = np.random.RandomState(seed)
    org = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _quadric_roots(a, b, c):
    disc = b * b - a * c
    quad_ok = disc >= 0.0
    sq = _sqrt(torch.clamp(disc, min=0.0))
    q = -(b + _sgn(b) * sq)
    b_pos = b > 0.0
    t1, ok1 = _root(torch.where(b_pos, q, c), torch.where(b_pos, a, q))
    t2, ok2 = _root(torch.where(b_pos, c, q), torch.where(b_pos, q, a))
    dmask = quad_ok & (disc < D_EPS)
    sgn_a = _sgn(a)
    u = (t1 - t2) * sgn_a
    tdff = torch.where(u >= 0.0, -0.5 * u - torch.abs(T_EPS * t1),
                       0.0) * sgn_a
    tdff = torch.where(dmask & ok1 & ok2, tdff, 0.0)
    return (torch.where(quad_ok & ok1, t1 + tdff, BIG)
            + 1e-3 * torch.where(quad_ok & ok2, t2 - tdff, BIG))


def _fresnel(eta, dot):
    ed = eta * dot
    k = 1.0 - eta * eta + ed * ed
    sq = _sqrt(torch.clamp(k, min=0.0))
    rs = _safe_div(ed + sq, ed - sq, 1.0)
    rp = _safe_div(dot + eta * sq, dot - eta * sq, 1.0)
    F = torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0)
    return torch.where(k < 0.0, 1.0, F)


def _root_sdiv(num, den):
    r, ok = _root(num, den)
    return r + 1e3 * ok.to(F32) + 1e-3 * _safe_div(num, den)


_PLAIN = {
    "add": lambda x, y: x + y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "sqrt": _sqrt,
    "rsqrt": _rsqrt,
    "exp": torch.exp,
    "log": torch.log,
    "fma": lambda x, y: x * y + y,
    "min_max": lambda x, y: torch.maximum(x, y) - torch.minimum(x, y),
    "abs_neg": lambda x: torch.abs(-x),
    "roots": _quadric_roots,
    "fresnel": _fresnel,
    "spec_pow": lambda x, p: torch.exp(p * torch.log(x)),
    "gather": lambda tab, idx: torch.gather(tab, 1, idx.long()),
    "root_sdiv": _root_sdiv,
}


def plain(name: str, *args) -> torch.Tensor:
    """The plain PyTorch version of case ``name`` (f32 (R, 128) tiles; the
    gather's indices i32), on the inputs' device."""
    return _PLAIN[name](*args)


VEC = 4   # elements in a kernel thread's 16-byte group (one float4)


def vector_split(n: int, *tensors) -> tuple:
    """How the kernel of a case that reads 16-byte groups (all but the
    roots, Fresnel and root/sdiv blocks, csrc/conformance.cu ``elems``)
    splits n elements: (elements in 16-byte groups, elements one by
    one). The groups need every tensor's data 16-byte aligned; the last
    n % 4 elements, or all n where a tensor is not aligned, go one by
    one."""
    if any(t.data_ptr() % (4 * VEC) for t in tensors):
        return 0, n
    return n - n % VEC, n % VEC


def _lib():
    from quadray_tpu_torch.ops._build import load_library
    lib = load_library("conformance")
    if lib.conformance_launch.argtypes is None:
        lib.conformance_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
        lib.conformance_launch.restype = ctypes.c_int
        lib.conformance_cases.restype = ctypes.c_int
        if lib.conformance_cases() != len(CASES):
            raise RuntimeError("csrc/conformance.cu and CASES disagree")
    return lib


def conformance(name: str, *args) -> torch.Tensor:
    """Case ``name`` on its inputs: f32 tensors of one shape (the
    gather's: (R, 128) tiles, its second input i32 indices in 0..127), all
    on one device. CUDA tensors launch the case's kernel on the current
    stream; CPU tensors take the plain version."""
    global launches
    if name not in _PLAIN:
        raise ValueError(f"unknown conformance case {name!r}")
    if len(args) != NARGS[name]:
        raise ValueError(f"{name} takes {NARGS[name]} inputs, got "
                         f"{len(args)}")
    dev = args[0].device
    shape = tuple(args[0].shape)
    if name == "gather" and (len(shape) != 2 or shape[1] != LANES):
        raise ValueError(f"{name}: need (R, {LANES}) tiles, got {shape}")
    if dev.type == "cpu":
        return plain(name, *args)
    if dev.type != "cuda":
        raise ValueError(f"conformance: unsupported device {dev}")
    for k, a in enumerate(args):
        dtype = I32 if (name == "gather" and k == 1) else F32
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(
                f"{name} input {k}: need a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    out = torch.empty(shape, dtype=F32, device=dev)
    n = out.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} elements, the kernel takes < 2^31")
    floats = [a for a in args if a.dtype == F32] + [None] * 3
    idx = args[1] if name == "gather" else None
    ptr = lambda t: None if t is None else t.data_ptr()
    vec = vector_split(n, out, *args)[0] > 0
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conformance_launch(
            CASES.index(name), ptr(floats[0]), ptr(floats[1]),
            ptr(floats[2]), ptr(idx), out.data_ptr(), n, stream, int(vec))
    if err != 0:
        raise RuntimeError(f"conformance kernel {name} launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
