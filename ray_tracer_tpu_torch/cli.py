"""Command-line interface of the PyTorch/CUDA port.

    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 --out x.ppm
    python -m ray_tracer_tpu_torch.cli render --scene parallel --width 512 \\
        --traversal csr --det-dtype float32 --out p.ppm
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 64 \\
        --det-dtype float64 --device cpu --out s.ppm
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 \\
        --turbo --out t.ppm
    python -m ray_tracer_tpu_torch.cli render --scene parallel --width 1024 \\
        --turbo --out p.ppm          # the cross-depth Whitted wave (kernel E)
    python -m ray_tracer_tpu_torch.cli render --scene parallel --width 256 \\
        --turbo --spp 2 --aperture 0.25 --focus-distance 20 --out dof.ppm
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 \\
        --turbo --gi 4 --gi-depth 2 --out gi.ppm   # the GI wave (kernel F)
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 256 \\
        --gi 2 --gi-depth 1 --out gi_csr.ppm      # the segment integrator on kernel B
    python -m ray_tracer_tpu_torch.cli render --scene nefertiti --width 1024 \\
        --turbo --out nef.ppm

The counterpart of `ray_tracer_tpu/cli.py render` for the options this
port serves.  It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _build_cfg(args):
    """(cfg, scene): scene is None where prepare loads the meshes itself."""
    from ray_tracer_tpu_torch.models import scenes

    scene = None
    if args.scene == "serial":
        cfg = scenes.serial_scene_config(args.width, args.height)
    elif args.scene == "parallel":
        cfg = scenes.parallel_scene_config(args.width, args.height)
    else:
        scene, cfg = scenes.nefertiti_scene(args.width, args.height,
                                            with_spot=args.scene == "nefertiti_spot",
                                            device=args.device)
    rkw = {}
    if args.fast:
        rkw["faithful"] = False
    if args.traversal:
        rkw["traversal"] = args.traversal
        if args.traversal == "brute_pallas":
            rkw["faithful"] = False  # the all-pairs kernel is production-only
    if args.det_dtype:
        rkw["det_dtype"] = args.det_dtype
    if rkw:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **rkw))
    if args.turbo:
        # the tuned production pipeline, from the per-scene knob table
        # (config.TUNED_KNOBS, the JAX package's): packed rows, the
        # persistent wave, auto grid layout, SAT-exact grid insertion.
        # gi_samples is set first, so that a GI run takes its own pump
        # (gi_pump), as in the JAX package's command line.
        from ray_tracer_tpu_torch.config import apply_turbo

        if args.gi > 0:
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                      gi_samples=args.gi))
        family = {"serial": "serial", "parallel": "parallel", "nefertiti": "nefertiti",
                  "nefertiti_spot": "nefertiti"}.get(args.scene)
        cfg = apply_turbo(cfg, family)
    if args.spp > 1:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, spp=args.spp))
    if args.gi > 0:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, gi_samples=args.gi, gi_depth=args.gi_depth))
    if args.aperture:
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, aperture=args.aperture, focus_distance=args.focus_distance or 0.0))
    if cfg.camera.aperture > 0 and cfg.render.spp <= 1:
        raise SystemExit("depth of field needs render.spp > 1 (one lens point per subsample)")
    return cfg, scene


def cmd_render(args) -> None:
    import torch

    from ray_tracer_tpu_torch.io.ppm import write_ppm
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene, device=args.device)
    t0 = time.perf_counter()
    img = render(prep)
    if prep.device.type == "cuda":
        torch.cuda.synchronize(prep.device)
    dt = time.perf_counter() - t0
    write_ppm(args.out, img.cpu().numpy())
    pixels = cfg.camera.width * cfg.camera.height
    if cfg.render.gi_samples > 0:
        paths = pixels * cfg.render.gi_samples
        print(f"wrote {args.out} ({cfg.camera.width}x{cfg.camera.height}, "
              f"gi={cfg.render.gi_samples} depth={cfg.render.gi_depth}, "
              f"{'GI wave' if prep.frame().gi_wave else 'segments'}, {prep.device}) "
              f"in {dt:.3f}s = {paths / dt / 1e6:.2f} Mpaths/s (incl. first-use kernel "
              f"build)", file=sys.stderr)
        return
    spp2 = cfg.render.spp * cfg.render.spp
    rays = pixels * spp2 * 2
    print(f"wrote {args.out} ({cfg.camera.width}x{cfg.camera.height}"
          f"{f', spp={cfg.render.spp}' if spp2 > 1 else ''}, "
          f"{cfg.render.traversal}, {prep.device}) in {dt:.3f}s = "
          f"{rays / dt / 1e6:.2f} Mrays/s (primary+shadow, excl. reflection "
          f"bounces, incl. first-use kernel build)", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a scene to PPM")
    r.add_argument("--scene", default="serial",
                   choices=["serial", "parallel", "nefertiti", "nefertiti_spot"])
    r.add_argument("--width", type=int, default=256)
    r.add_argument("--height", type=int, default=0, help="0 = width")
    r.add_argument("--out", default="out.ppm")
    r.add_argument("--fast", action="store_true",
                   help="production semantics (gated hits, early-exit DDA)")
    r.add_argument("--traversal", choices=["csr", "brute_pallas", "packed"], default=None,
                   help="csr: the grid DDA kernel (default); brute_pallas: "
                        "the all-pairs kernel (implies --fast); packed: the "
                        "packed-grid march (needs --fast)")
    r.add_argument("--turbo", action="store_true",
                   help="the tuned production pipeline (config.apply_turbo): "
                        "packed grid, persistent wave, fused shadow rays")
    r.add_argument("--det-dtype", choices=["float32", "float64"], default=None,
                   help="determinant precision (float64 = the oracle's)")
    r.add_argument("--spp", type=int, default=1,
                   help="anti-aliasing: spp x spp subpixel samples per pixel")
    r.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius for depth of field (needs --spp>1)")
    r.add_argument("--focus-distance", type=float, default=0.0,
                   help="focal-plane distance (default: distance to target)")
    r.add_argument("--gi", type=int, default=0, metavar="SAMPLES",
                   help="path-traced GI with this many samples a pixel (0: Whitted)")
    r.add_argument("--gi-depth", type=int, default=2,
                   help="GI bounces after the primary vertex")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(fn=cmd_render)
    args = ap.parse_args(argv)
    if args.height == 0:
        args.height = args.width
    args.fn(args)


if __name__ == "__main__":
    main()
