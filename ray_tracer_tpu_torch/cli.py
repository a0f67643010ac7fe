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
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 \\
        --turbo --smooth-normals --texture image --texture-file tex.ppm \\
        --env-file sky.png --out app.png   # the appearance epilogues
    python -m ray_tracer_tpu_torch.cli fit --scene gradcheck --width 64 \\
        --steps 100 --out-dir ckpt   # inverse rendering (self-demo target)

The counterpart of `ray_tracer_tpu/cli.py render` and `fit` for the
options this port serves.  It runs on the card unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time


def _build_cfg(args):
    """(cfg, scene): scene is None where prepare loads the meshes itself."""
    from ray_tracer_tpu_torch.models import scenes

    if getattr(args, "config", None) or getattr(args, "extra_light", None):
        raise NotImplementedError("--config and --extra-light are not served by the "
                                  "PyTorch port yet")
    scene = None
    if args.scene == "gradcheck":
        scene, cfg = scenes.gradcheck_scene(args.width, args.height, device=args.device)
    elif args.scene == "serial":
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
    if getattr(args, "traversal", None):
        rkw["traversal"] = args.traversal
        if args.traversal == "brute_pallas":
            rkw["faithful"] = False  # the all-pairs kernel is production-only
    if getattr(args, "det_dtype", None):
        rkw["det_dtype"] = args.det_dtype
    if rkw:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **rkw))
    if getattr(args, "turbo", False):
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
    if getattr(args, "spp", 1) > 1:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, spp=args.spp))
    if getattr(args, "gi", 0) > 0:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, gi_samples=args.gi, gi_depth=args.gi_depth))
    if getattr(args, "aperture", 0.0):
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, aperture=args.aperture, focus_distance=args.focus_distance or 0.0))
    if cfg.camera.aperture > 0 and cfg.render.spp <= 1:
        raise SystemExit("depth of field needs render.spp > 1 (one lens point per subsample)")
    if args.smooth_normals:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, normal_mode="smooth", faithful=False))
    if args.texture:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, texture=args.texture,
            texture_scale=args.texture_scale or cfg.render.texture_scale))
    if args.texture_file or args.env_file:
        import numpy as np
        import torch

        from ray_tracer_tpu_torch.device import resolve_device
        from ray_tracer_tpu_torch.io.png import read_png
        from ray_tracer_tpu_torch.io.ppm import read_ppm

        images = {}
        if args.texture_file:  # a PPM sampled bilinearly in [0, 1] when --texture image
            images["texture_image"] = (read_ppm(args.texture_file).astype(np.float32)
                                       / np.float32(255.0))
        if args.env_file:  # a lat-long map in color units (u8 values pass through)
            rd = read_png if args.env_file.lower().endswith(".png") else read_ppm
            images["env_image"] = rd(args.env_file).astype(np.float32)
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                      faithful=False))
        if scene is None:
            scene = scenes.build_scene(cfg, device=args.device)
        dev = resolve_device(args.device)
        scene = scene._replace(**{k: torch.from_numpy(v).to(dev) for k, v in images.items()})
    return cfg, scene


def cmd_render(args) -> None:
    import torch

    from ray_tracer_tpu_torch.io.png import write_png
    from ray_tracer_tpu_torch.io.ppm import write_ppm
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene, device=args.device)
    t0 = time.perf_counter()
    img = render(prep)
    if prep.device.type == "cuda":
        torch.cuda.synchronize(prep.device)
    dt = time.perf_counter() - t0
    (write_png if args.out.lower().endswith(".png") else write_ppm)(args.out,
                                                                     img.cpu().numpy())
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


def cmd_fit(args) -> None:
    """Fit the scene's parameters to a target PPM, or (no --target) the
    self-demo: render the scene, perturb kd by 1.5 and base_color by 0.6,
    and recover them.  Prints {"first_loss", "last_loss"}."""
    import json

    import numpy as np
    import torch

    from ray_tracer_tpu_torch.opt.fit import fit, merge_scene, split_scene
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(name)s: %(message)s")
    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene, device=args.device)
    if args.target:
        from ray_tracer_tpu_torch.io.ppm import read_ppm

        target = torch.from_numpy(read_ppm(args.target).astype(np.float32)).to(prep.device)
    else:
        target = render(prep)
        p = split_scene(prep.scene)
        prep = prep._replace(scene=merge_scene(
            p._replace(kd=p.kd * 1.5, base_color=p.base_color * 0.6), prep.scene))
    trainable = (tuple(f.strip() for f in args.trainable.split(",") if f.strip())
                 if args.trainable else None)
    _, losses = fit(prep, target, steps=args.steps, lr=args.lr, trainable=trainable,
                    checkpoint_dir=args.out_dir, log_every=max(1, args.steps // 10))
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1]}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a scene to PPM (or PNG: --out x.png)")
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
    r.add_argument("--smooth-normals", action="store_true",
                   help="Phong-interpolated vertex normals (implies --fast)")
    r.add_argument("--texture", default=None, choices=["none", "checker", "image"],
                   help="modulate base_color from the meshes' uvs")
    r.add_argument("--texture-scale", type=float, default=None,
                   help="checker cells / image repeats per uv unit")
    r.add_argument("--texture-file", default=None,
                   help="PPM image sampled bilinearly when --texture image")
    r.add_argument("--env-file", default=None,
                   help="lat-long environment map (PNG or PPM) for misses (implies --fast)")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(fn=cmd_render)
    f = sub.add_parser("fit", help="inverse rendering: fit scene parameters to a target")
    f.add_argument("--scene", default="gradcheck", choices=["gradcheck", "serial", "parallel"])
    f.add_argument("--config", help="not served by the port yet")
    f.add_argument("--width", type=int, default=64)
    f.add_argument("--height", type=int, default=0, help="0 = width")
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("--target", help="target PPM image (default: the self-demo)")
    f.add_argument("--texture", default=None, choices=["none", "checker", "image"])
    f.add_argument("--texture-file", default=None,
                   help="PPM sampled bilinearly when --texture image (also the init for "
                        "--trainable texture_image)")
    f.add_argument("--texture-scale", type=float, default=None)
    f.add_argument("--smooth-normals", action="store_true",
                   help="Phong-interpolated vertex normals")
    f.add_argument("--env-file", default=None,
                   help="lat-long environment map (PNG or PPM; also the init for "
                        "--trainable env_image)")
    f.add_argument("--extra-light", action="append", default=None, metavar="X,Y,Z[,I]",
                   help="not served by the port yet")
    f.add_argument("--trainable", default="base_color,kd,ks,ka,light_pos",
                   help="comma-separated SceneParams fields")
    f.add_argument("--out-dir", default=None, help="checkpoint directory")
    f.add_argument("--fast", action="store_true", help="production semantics")
    f.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    f.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    if args.height == 0:
        args.height = args.width
    args.fn(args)


if __name__ == "__main__":
    main()
