"""Fresnel/Schlick/gamma curve plotter on the port — the analog of the
reference's ``core_test -z`` mode (engine.cpp:4098-4356 plot_funcs + the
plot_fresnel* routines, tracer.cpp:5411-5764).

    python -m quadray_tpu_torch.apps.plot_fresnel [-c]

The port of ``apps/plot_fresnel.py``: the curves come from the plain
tracer's Fresnel functions (``quadray_tpu_torch.ops.trace``), evaluated
on the card, or on the CPU with ``-c``, and the same BMPs go into dump/:
  plot_fresnel.bmp            exact dielectric, eta = 1/1.5 (entering)
  plot_fresnel_tir.bmp        exact dielectric, eta = 1.5 (exiting, TIR)
  plot_schlick.bmp            Schlick approximation, eta = 1/1.5
  plot_fresnel_metal_fast.bmp conductor fast,  n = 0.27, k = 2.77 (gold)
  plot_fresnel_metal_slow.bmp conductor exact, n = 0.27, k = 2.77
  plot_gamma.bmp              x^2 / sqrt(x) approx vs pow 2.2 / 2.0

The same constants as the reference's plot mode (c_rfr = 1/1.5,
c_rcp = 0.27, ext = 2.77; engine.cpp:4148-4270).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

F32 = torch.float32


def curves(width=800, device="cuda") -> dict:
    """The five reflectance curves over the reference's incidence sweep,
    evaluated on ``device``, as (width,) f32 numpy arrays, in the JAX
    app's operation order."""
    from quadray_tpu_torch.ops.trace import (
        _safe_div, _sqrt, fresnel_metal_fast, fresnel_metal_slow,
        fresnel_schlick)

    # i_cos = -cos(s*i), s = 1.57/x_res (engine.cpp:4143-4156)
    s = 1.57 / width
    i = np.arange(width, dtype=np.float32)
    dot = torch.from_numpy(-np.cos(s * i)).to(device)   # negative cosine
    f = lambda v: torch.tensor(v, dtype=F32, device=device)

    def dielectric(eta):
        eta = f(eta)
        k = 1.0 - eta * eta + (eta * dot) ** 2
        sq = _sqrt(torch.clamp(k, min=0.0))
        rs = _safe_div(eta * dot + sq, eta * dot - sq, 1.0)
        rp = _safe_div(dot + eta * sq, dot - eta * sq, 1.0)
        return torch.clamp(torch.where(k < 0.0, 1.0,
                                       0.5 * (rs * rs + rp * rp)), 0.0, 1.0)

    def schlick(eta):
        eta = f(eta)
        k = 1.0 - eta * eta + (eta * dot) ** 2
        sq = _sqrt(torch.clamp(k, min=0.0))
        return torch.clamp(torch.where(k < 0.0, 1.0,
                                       fresnel_schlick(dot, eta, sq)),
                           0.0, 1.0)

    rcp, ext2 = f(0.27), f(2.77 * 2.77)
    out = {
        "fresnel": dielectric(1.0 / 1.5),
        "fresnel_tir": dielectric(1.5),
        "schlick": schlick(1.0 / 1.5),
        "fresnel_metal_fast": torch.clamp(
            fresnel_metal_fast(dot, rcp, ext2), 0.0, 1.0),
        "fresnel_metal_slow": torch.clamp(
            fresnel_metal_slow(dot, rcp, ext2), 0.0, 1.0),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def plot_to_frame(vals, width=800, height=480):
    """Reference-style plot: one red pixel column-wise at y =
    (1 - F) * (h - 1) on black (engine.cpp:4160-4168)."""
    frame = np.zeros((height, width, 3), np.uint8)
    ys = ((1.0 - vals) * (height - 1)).astype(int).clip(0, height - 1)
    frame[ys, np.arange(len(vals)) % width] = (255, 0, 0)
    return frame


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m quadray_tpu_torch.apps.plot_fresnel",
        description=__doc__.split("\n")[0])
    ap.add_argument("-c", action="store_true",
                    help="evaluate the curves on the CPU instead of the card")
    args = ap.parse_args(argv)
    from quadray_tpu_torch.utils.image import save_bmp
    os.makedirs("dump", exist_ok=True)
    for name, vals in curves(device="cpu" if args.c else "cuda").items():
        save_bmp(f"dump/plot_{name}.bmp", plot_to_frame(vals))
        print(f"dump/plot_{name}.bmp  F(0)={vals[0]:.4f} "
              f"F(89deg)={vals[-1]:.4f}")
    # gamma curves (engine.cpp:4340-4352): approx x^2 / sqrt vs pow 2.2
    x = np.linspace(0, 1, 800, dtype=np.float32)
    g = np.zeros((480, 800, 3), np.uint8)
    for curve, col in ((np.sqrt(x), (255, 0, 0)), (x * x, (255, 0, 0)),
                       (x ** (1 / 2.2), (0, 255, 0)),
                       (x ** 2.2, (0, 255, 0))):
        ys = ((1.0 - curve) * 479).astype(int).clip(0, 479)
        g[ys, np.arange(800)] = col
    save_bmp("dump/plot_gamma.bmp", g)
    print("dump/plot_gamma.bmp")


if __name__ == "__main__":
    main()
