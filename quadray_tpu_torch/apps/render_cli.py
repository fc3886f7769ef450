"""RooT-analog demo app on the port: offscreen frame rendering of the
reference demo scenes, animators, scripted interactive camera, fps
logging and frame dumps.

    python -m quadray_tpu_torch.apps.render_cli [options]

The port of ``apps/render_cli.py``: the same options and key tokens, the
frames rendered by ``quadray_tpu_torch.Scene`` on the card (its CUDA
kernels), or on the CPU (the plain versions) with ``-c``. The reference
app (root/RooT.h) drives an X11 window with hotkeys; here a key trace
drives the same loop (RooT's own ``-o`` benchmark mode, RooT.h:74): N
frames of a demo scene with its animators on a 30 fps millisecond clock.

Options (RooT.h:637-1010):
  -d n   demo scene number 1..3 (default 1)
  -x/-y  resolution (default 800x480)
  -f n   number of frames to render (default 10)
  -a n   antialiasing 1/2/4 (default 1)
  -q, -s n  parsed and not read, as in the JAX app (a note on stderr)
  -i     save frames as BMP to dump/
  -r ms  fps log interval (default 500)
  -hud   draw the fps counter into the frames
  -c     render on the CPU (the plain tracers) instead of the card
  -k s   scripted interactive actions: comma-separated per-frame key
         tokens mirroring RooT's hotkeys (RooT.h:434-442 + 283-451);
         '+' combines keys in one frame, '.' is an idle frame, and the
         trace loops if shorter than -f. Example:
           -k "w,w,w+left,left,.,f4,a2,s,right"
         keys: w/s/a/d moves, up/down/left/right rotations (RooT's
         inverted pitch mapping), rise/fall vertical moves, f4 save
         frame, a1/a2/a4 antialiasing, q path-tracer toggle, f1 state
         dump, d1/d2/d3 scene switch
The JAX app's ``-p`` (its jnp tracer in place of the TPU kernel) has no
counterpart: the port has one tracer on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from quadray_tpu_torch import engine as E

KEY_ACTIONS = {
    "w": E.CAMERA_MOVE_FORWARD, "s": E.CAMERA_MOVE_BACK,
    "a": E.CAMERA_MOVE_LEFT, "d": E.CAMERA_MOVE_RIGHT,
    "rise": E.CAMERA_MOVE_UP, "fall": E.CAMERA_MOVE_DOWN,
    # RooT maps UP key -> ROTATE_DOWN and vice versa (RooT.h:439-440)
    "up": E.CAMERA_ROTATE_DOWN, "down": E.CAMERA_ROTATE_UP,
    "left": E.CAMERA_ROTATE_LEFT, "right": E.CAMERA_ROTATE_RIGHT,
}


def frame_time(fi: int) -> float:
    """The animation clock of frame fi: milliseconds at 30 fps."""
    return fi * (1000.0 / 30.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m quadray_tpu_torch.apps.render_cli",
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-d", type=int, default=1, help="demo scene 1..3")
    ap.add_argument("-x", type=int, default=800)
    ap.add_argument("-y", type=int, default=480)
    ap.add_argument("-f", type=int, default=10, help="frames")
    ap.add_argument("-a", type=int, default=1, choices=(1, 2, 4))
    ap.add_argument("-q", action="store_true",
                    help="path tracer mode (not read, as in the JAX app)")
    ap.add_argument("-s", type=int, default=None,
                    help="PT samples (not read, as in the JAX app)")
    ap.add_argument("-i", action="store_true", help="save BMP frames")
    ap.add_argument("-r", type=int, default=500, help="fps log ms")
    ap.add_argument("-hud", action="store_true", help="fps counter on frame")
    ap.add_argument("-c", action="store_true",
                    help="render on the CPU (plain tracers)")
    ap.add_argument("-k", type=str, default=None,
                    help="scripted per-frame key trace (see above)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the app; returns its statistics: frames, seconds, avg_fps,
    fps_log (each logged FPS), whitted_frames and pt_frames (the frames
    rendered by each tracer) and scene (the last scene, whose camera the
    key trace moved)."""
    args = parse_args(argv)
    if args.q or args.s is not None:
        print("render_cli: -q and -s are parsed and not read (as in the "
              "JAX app); use the 'q' key token for path tracing",
              file=sys.stderr)
    from quadray_tpu_torch.engine import Platform, Scene
    from quadray_tpu_torch.models.scenes import demos
    from quadray_tpu_torch.utils.digits import draw_number

    device = "cpu" if args.c else "cuda"
    pfm = Platform(fsaa=args.a)
    scene = Scene(demos.build(f"demo{args.d:02d}"), args.x, args.y, pfm=pfm,
                  device=device)
    os.makedirs("dump", exist_ok=True)
    script = ([tok.strip() for tok in args.k.split(",")] if args.k
              else None)
    scr_id = 0

    def dispatch(keys: str, sim_ms: float):
        """Apply one frame's '+'-combined key tokens (the RooT main_step
        hotkey dispatch, RooT.h:272-633)."""
        nonlocal scene, scr_id
        for key in keys.split("+"):
            key = key.lower()
            if key in ("", "."):
                continue
            if key in KEY_ACTIONS:
                scene.update_action(sim_ms, KEY_ACTIONS[key])
            elif key == "f4":
                scene.save_frame(f"dump/scr{scr_id:03d}.bmp")
                scr_id += 1
            elif key in ("a1", "a2", "a4"):
                pfm.set_fsaa(int(key[1]))
            elif key == "q":
                scene.set_pton(not scene.pt_on)
            elif key == "f1":
                scene.print_state()
            elif key in ("d1", "d2", "d3"):
                scene = Scene(demos.build(f"demo0{key[1]}"), args.x, args.y,
                              pfm=pfm, device=device)
            else:
                print(f"unknown key token: {key}", file=sys.stderr)

    t_wall0 = time.time()
    t_log = t_wall0
    frames_in_interval = 0
    total = pt_frames = 0
    fps_log = []
    for fi in range(args.f):
        sim_ms = frame_time(fi)
        if script:
            dispatch(script[fi % len(script)], sim_ms)
        pt_frames += scene.pt_on
        frame = scene.render(sim_ms)
        total += 1
        frames_in_interval += 1
        now = time.time()
        if (now - t_log) * 1000.0 >= args.r:
            fps = frames_in_interval / (now - t_log)
            fps_log.append(fps)
            print(f"FPS = {fps:7.1f}")
            t_log = now
            frames_in_interval = 0
        if args.hud:
            fps_so_far = total / max(now - t_wall0, 1e-9)
            draw_number(frame, f"{fps_so_far:.1f}")
        if args.i:
            scene.frame = frame
            scene.save_frame(f"dump/demo{args.d:02d}_f{fi:04d}.bmp")

    dt = time.time() - t_wall0
    print(f"AVG FPS = {total / dt:7.2f}  ({args.x}x{args.y}, "
          f"{args.f} frames, {dt:.1f}s)")
    return dict(frames=total, seconds=dt, avg_fps=total / dt,
                fps_log=fps_log, whitted_frames=total - pt_frames,
                pt_frames=pt_frames, scene=scene)


if __name__ == "__main__":
    main()
