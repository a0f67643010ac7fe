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
        --turbo --gi-samples 4 --gi-depth 2 --out gi.ppm   # the GI wave (kernel F)
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 256 \\
        --gi-samples 2 --gi-depth 1 --out gi_csr.ppm   # the segment integrator on kernel B
    python -m ray_tracer_tpu_torch.cli render --scene parallel --width 1024 --turbo \\
        --gi-samples 4 --gi-no-specular --light-intensity 5000 --out lambert.ppm
    python -m ray_tracer_tpu_torch.cli render --scene gradcheck --width 1024 \\
        --profile trace_dir --out g.ppm     # a torch.profiler trace of the render
    python -m ray_tracer_tpu_torch.cli render --scene nefertiti --width 1024 \\
        --turbo --out nef.ppm
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 \\
        --turbo --smooth-normals --texture image --texture-file tex.ppm \\
        --env-file sky.png --out app.png   # the appearance epilogues
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 \\
        --turbo --extra-light -5,-5,2,128 --light-radius 0.5 \\
        --shadow-samples 16 --out soft.ppm   # extra lights, an area light
    python -m ray_tracer_tpu_torch.cli fit --scene gradcheck --width 64 \\
        --steps 100 --out-dir ckpt   # inverse rendering (self-demo target)
    python -m ray_tracer_tpu_torch.cli render --config scene.json --out x.ppm
    python -m ray_tracer_tpu_torch.cli stats --scene serial --width 256 --turbo
    python -m ray_tracer_tpu_torch.cli debug --scene serial --width 256 --x 128 --y 128
    python -m ray_tracer_tpu_torch.cli aov --scene serial --width 256 --ao-samples 16 \\
        --out aovs.npz
    python -m ray_tracer_tpu_torch.cli info
    python -m ray_tracer_tpu_torch.cli bench --rows spot_1024
    python -m ray_tracer_tpu_torch.cli bench --width 1024   # bench_torch.py --size 1024
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 --turbo \
        --devices 4 --out x.ppm      # rays sharded over four cards (NCCL)
    torchrun --nproc-per-node 4 -m ray_tracer_tpu_torch.cli render --devices 4 ...
    python -m ray_tracer_tpu_torch.cli aov --scene serial --width 64 --devices 2 \
        --device cpu --out aovs.npz  # two CPU ranks (gloo)
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 --turbo \
        --devices 4 --ring --out x.ppm   # the geometry sharded by ring orbits
    python -m ray_tracer_tpu_torch.cli render --scene serial --width 1024 --turbo \
        --devices 2 --ring --out x.ppm   # on one card: two ranks share it (gloo)

The counterpart of `ray_tracer_tpu/cli.py`.  It runs on the card unless
`--device cpu` is given.  `render --devices N` and `aov --devices N`
shard the rays over N ranks, one process a device: under torchrun (its
WORLD_SIZE / RANK / MASTER_ADDR set) the command joins that group, whose
world size must be N; otherwise it starts N local ranks itself
(torch.multiprocessing, spawn, a file:// rendezvous in a temporary
directory), rank i on cuda:i mod the card count or, with --device cpu,
on the CPU.  The ranks join over NCCL when each has a card of its own,
over gloo on the CPU or when they outnumber the cards (NCCL takes one
rank a card; gloo lets ranks share one).  Rank 0 writes
the output.  `--ring` shards the geometry by ring orbits instead of the
rays: `render --devices N --ring` over a one-axis ("tris",) mesh of N
ranks (`parallel.shard.render_sharded_geometry`), `aov` and `debug
--devices N --ring` over the (1, N) ("rays", "tris") mesh (the ring AOVs
and AO, `trace_pixel(mesh=)`), as the JAX command does; `debug --devices
N` without --ring traces its pixel on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time


def _build_cfg(args):
    """(cfg, scene): scene is None where prepare loads the meshes itself.
    --config loads a scene config file (either package's JSON) in place of
    --scene and the size options."""
    from ray_tracer_tpu_torch.models import scenes

    scene = None
    if getattr(args, "config", None):
        from ray_tracer_tpu_torch.config import load_scene_config

        cfg = load_scene_config(args.config)
    elif args.scene == "gradcheck":
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
    if getattr(args, "fast", False):
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

        if args.gi_samples > 0:
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, gi_samples=args.gi_samples))
        family = {"serial": "serial", "parallel": "parallel", "nefertiti": "nefertiti",
                  "nefertiti_spot": "nefertiti"}.get(getattr(args, "scene", None))
        cfg = apply_turbo(cfg, family)
    if getattr(args, "spp", 1) > 1:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, spp=args.spp))
    if getattr(args, "gi_samples", 0) > 0:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, gi_samples=args.gi_samples, gi_depth=args.gi_depth,
            gi_specular=not args.gi_no_specular))
    li = getattr(args, "light_intensity", None)
    if li is not None:
        if cfg.render.faithful:
            print("warning: --light-intensity overrides a faithful render's reference "
                  "light; the output will not be the oracle's bytes", file=sys.stderr)
        cfg = dataclasses.replace(cfg, light=dataclasses.replace(cfg.light, intensity=li))
    for spec in getattr(args, "extra_light", None) or ():
        from ray_tracer_tpu_torch.config import LightConfig

        try:
            parts = [float(x) for x in spec.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (3, 4):
            raise SystemExit(f"--extra-light wants x,y,z[,intensity], got {spec!r}")
        light = LightConfig(position=tuple(parts[:3]),
                            intensity=parts[3] if len(parts) == 4 else 1.0)
        cfg = dataclasses.replace(cfg, extra_lights=cfg.extra_lights + (light,))
    if getattr(args, "aperture", 0.0):
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, aperture=args.aperture, focus_distance=args.focus_distance or 0.0))
    if cfg.camera.aperture > 0 and cfg.render.spp <= 1:
        raise SystemExit("depth of field needs render.spp > 1 (one lens point per subsample)")
    ss = getattr(args, "shadow_samples", 0)
    lr = getattr(args, "light_radius", 0.0)
    if ss or lr:
        # an area light: the radius is required, one sample is no
        # penumbra, and 16 samples are the default
        if ss and not lr:
            raise SystemExit("--shadow-samples requires --light-radius")
        if ss == 1:
            raise SystemExit("--shadow-samples must be > 1 for a penumbra")
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, light_radius=lr, shadow_samples=ss or 16))
    if getattr(args, "smooth_normals", False):
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, normal_mode="smooth", faithful=False))
    if getattr(args, "texture", None):
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, texture=args.texture,
            texture_scale=args.texture_scale or cfg.render.texture_scale))
    if getattr(args, "texture_file", None) or getattr(args, "env_file", None):
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


_TORCHRUN = ("WORLD_SIZE", "RANK", "MASTER_ADDR")
_RANK_TIMEOUT = 900.0  # seconds the ranks may take: their join and every collective


def _backend(args, local_ranks: int) -> str:
    """The ranks' backend: gloo on the CPU or when this host's cuda ranks
    outnumber its cards, NCCL otherwise."""
    import torch

    if args.device == "cpu" or local_ranks > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _as_rank(args) -> None:
    """Run the command as a rank of the formed group, then leave it."""
    import torch.distributed as dist

    try:
        args.fn(args)
        dist.barrier()  # no rank tears the group down under another
    finally:
        dist.destroy_process_group()


def _rank_main(index: int, n: int, init: str, args) -> None:
    """One local rank of `_on_ranks`: join the group, run the command."""
    import torch

    from ray_tracer_tpu_torch.parallel import multihost

    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    backend = _backend(args, n)
    args.device = "cpu" if cpu else f"cuda:{index % torch.cuda.device_count()}"
    multihost.initialize(init, n, index, backend=backend, timeout=_RANK_TIMEOUT)
    _as_rank(args)


def _on_ranks(args) -> bool:
    """Run args.fn over args.devices ranks when it asks for them -> True
    when this process ran as (or started) the ranks, False for one
    device.  Under torchrun the process joins the launcher's group (whose
    world size must be --devices); otherwise it starts the ranks itself
    and waits for them, at most _RANK_TIMEOUT seconds."""
    import torch
    import torch.distributed as dist

    n = getattr(args, "devices", 0)
    if not n:
        return False
    if dist.is_initialized():
        return False  # a rank of the group: the command runs here
    if n < 1:
        raise SystemExit(f"--devices must be >= 1, got {n}")
    if all(k in os.environ for k in _TORCHRUN):
        from ray_tracer_tpu_torch.parallel import multihost

        cpu = args.device == "cpu"
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        multihost.initialize(backend=_backend(args, local), timeout=_RANK_TIMEOUT)
        if dist.get_world_size() != n:
            raise SystemExit(f"--devices {n} but the launcher's group has "
                             f"{dist.get_world_size()} ranks")
        if not cpu:
            local = int(os.environ.get('LOCAL_RANK', dist.get_rank()))
            args.device = f"cuda:{local % torch.cuda.device_count()}"
        _as_rank(args)
        return True
    if args.device != "cpu":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < 1:
            raise SystemExit(f"--devices {n} asks for {n} cuda ranks, but this machine has "
                             "no card; pass --device cpu for CPU ranks")
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(n, f"file://{tmp}/rendezvous", args), nprocs=n,
                       join=False)
        deadline = time.monotonic() + _RANK_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise SystemExit(f"the {n} ranks did not finish in {_RANK_TIMEOUT} s")
    return True


def _mesh(args, axis_names=("rays",)):
    """The mesh of this rank's group over its --device (None for one
    device): with --ring every rank on "tris" (one axis, or "rays" of 1),
    else every rank on the first axis."""
    if not getattr(args, "devices", 0):
        return None
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    n = args.devices
    if getattr(args, "ring", False):
        shape = (n,) if axis_names == ("tris",) else (1, n)
    else:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return make_mesh(n, axis_names, shape=shape, devices=args.device)


def cmd_render(args) -> None:
    import torch

    from ray_tracer_tpu_torch.io.png import write_png
    from ray_tracer_tpu_torch.io.ppm import write_ppm
    from ray_tracer_tpu_torch.parallel.multihost import is_host0
    from ray_tracer_tpu_torch.render.renderer import prepare, render
    from ray_tracer_tpu_torch.utils.timing import profile_trace

    if _on_ranks(args):
        return
    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene, device=args.device)
    ring = getattr(args, "ring", False)
    mesh = _mesh(args, ("tris",) if ring else ("rays",))
    logdir = args.profile
    t0 = time.perf_counter()
    with profile_trace(logdir):  # each rank writes its own trace file
        if mesh is None:
            img = render(prep)
        else:
            from ray_tracer_tpu_torch.parallel.shard import (
                render_sharded, render_sharded_geometry,
            )

            if ring:
                # every rank on the triangle axis: each holds 1/N of the geometry
                img = render_sharded_geometry(prep, mesh=mesh, rays_axis=None)
            else:
                img = render_sharded(prep, mesh=mesh)
    if mesh is not None and not is_host0():
        return
    if prep.device.type == "cuda":
        torch.cuda.synchronize(prep.device)
    dt = time.perf_counter() - t0
    if logdir:
        print(f"profiler trace written to {logdir}", file=sys.stderr)
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
    # every light traces one shadow ray a pixel, or the area light's samples
    fan = cfg.render.shadow_samples if cfg.render.light_radius > 0 else 1
    rays = pixels * spp2 * (1 + fan * (1 + len(cfg.extra_lights)))
    print(f"wrote {args.out} ({cfg.camera.width}x{cfg.camera.height}"
          f"{f', spp={cfg.render.spp}' if spp2 > 1 else ''}, "
          f"{cfg.render.traversal}, {prep.device}) in {dt:.3f}s = "
          f"{rays / dt / 1e6:.2f} Mrays/s (primary+shadow, excl. reflection "
          f"bounces, incl. first-use kernel build)", file=sys.stderr)


def cmd_fit(args) -> None:
    """Fit the scene's parameters to a target PPM, or (no --target) the
    self-demo: render the scene, perturb kd by 1.5 and base_color by 0.6,
    and recover them.  With --resume the newest checkpoint in --out-dir
    (the port's, or the JAX package's, orbax or npz) gives the params,
    Adam's moments and the step to go on from.  Prints {"first_loss", "last_loss"} (null when
    no step was left)."""
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
                    checkpoint_dir=args.out_dir, resume=args.resume,
                    log_every=max(1, args.steps // 10))
    print(json.dumps({"first_loss": losses[0] if losses else None,
                      "last_loss": losses[-1] if losses else None}))


def cmd_bench(args) -> None:
    """Exec the port's bench (bench_torch.py at the repository root), as the
    JAX package's command execs bench.py: --width N is its --size N, one
    measurement of the spot scene at N x N."""
    import os

    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "bench_torch.py")
    extra = ["--size", str(args.width)] if args.width else []
    for flag in ("rows", "repeat", "rounds"):
        if getattr(args, flag):
            extra += [f"--{flag}", str(getattr(args, flag))]
    os.execv(sys.executable, [sys.executable, script] + extra)


def _prepared(args):
    from ray_tracer_tpu_torch.render.renderer import prepare

    cfg, scene = _build_cfg(args)
    return prepare(cfg, scene=scene, device=args.device)


def cmd_stats(args) -> None:
    """Print collect_render_metrics of the scene as JSON."""
    import json

    from ray_tracer_tpu_torch.render.metrics import collect_render_metrics

    print(json.dumps(collect_render_metrics(_prepared(args)), indent=2))


def cmd_debug(args) -> None:
    """Print trace_pixel of pixel (--x, --y) as JSON: on one device (with
    or without --devices, as the JAX command), or with --devices N --ring
    through ring orbits over N ranks (rank 0 prints)."""
    import json

    from ray_tracer_tpu_torch.parallel.multihost import is_host0
    from ray_tracer_tpu_torch.render.debug import trace_pixel

    ring = getattr(args, "ring", False) and getattr(args, "devices", 0)
    if ring and _on_ranks(args):
        return
    out = trace_pixel(_prepared(args), args.x, args.y,
                      mesh=_mesh(args, ("rays", "tris")) if ring else None)
    if not ring or is_host0():
        print(json.dumps(out, indent=2))


def cmd_aov(args) -> None:
    """Write render_aovs' buffers (and with --ao-samples an 'ao' buffer)
    to an .npz file; with --devices the traces are ray-sharded (with --ring
    ring orbits over the geometry sharded on N ranks) and rank 0 writes."""
    import numpy as np

    from ray_tracer_tpu_torch.parallel.multihost import is_host0
    from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs

    if _on_ranks(args):
        return
    prep = _prepared(args)
    mesh = _mesh(args, ("rays", "tris"))
    ring = getattr(args, "ring", False)
    aovs = {k: v.cpu().numpy() for k, v in render_aovs(prep, mesh=mesh, ring=ring).items()}
    if args.ao_samples:
        aovs["ao"] = render_ao(prep, samples=args.ao_samples, radius=args.ao_radius,
                               mesh=mesh, ring=ring).cpu().numpy()
    if not is_host0():
        return
    np.savez(args.out, **aovs)
    print(f"wrote {args.out}: " + ", ".join(f"{k}{list(v.shape)}" for k, v in aovs.items()),
          file=sys.stderr)


def cmd_info(_args) -> None:
    """Print the devices, the process count, whether the CUDA kernels are
    built, and the default device, as JSON (the JAX command's keys)."""
    import json

    import torch

    from ray_tracer_tpu_torch.kernels import _build
    from ray_tracer_tpu_torch.parallel.multihost import process_count

    cuda = torch.cuda.is_available()
    devices = ([f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())] if cuda else ["cpu"])
    built = {k: os.path.exists(_build.library_path(k)) for k in _build.KERNELS}
    print(json.dumps({
        "devices": devices,
        "process_count": process_count(),
        "native_library": all(built.values()),
        "default_backend": "cuda" if cuda else "cpu",
        "kernels_built": built,
    }, indent=2))


def _inspect_parser(sub, name, help_, width):
    """A subcommand taking a scene as render does (--scene or --config)."""
    p = sub.add_parser(name, help=help_)
    p.add_argument("--scene", default="serial",
                   choices=["serial", "parallel", "gradcheck", "nefertiti", "nefertiti_spot"])
    p.add_argument("--config", help="scene config JSON (in place of --scene and the size)")
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--height", type=int, default=0, help="0 = width")
    p.add_argument("--fast", action="store_true", help="production semantics")
    p.add_argument("--turbo", action="store_true",
                   help="the tuned production pipeline (packed grid, persistent wave)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(gi_samples=0)
    return p


def _rank_options(p, devices_help: str, ring_help: str) -> None:
    p.add_argument("--devices", type=int, default=0, help=devices_help)
    p.add_argument("--ring", action="store_true", help=ring_help)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a scene to PPM (or PNG: --out x.png)")
    r.add_argument("--scene", default="serial",
                   choices=["serial", "parallel", "gradcheck", "nefertiti", "nefertiti_spot"])
    r.add_argument("--config", help="scene config JSON (in place of --scene and the size)")
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
    r.add_argument("--gi-samples", "--gi", type=int, default=0, metavar="SAMPLES",
                   help="path-traced GI with this many samples a pixel (0: Whitted)")
    r.add_argument("--gi-depth", type=int, default=2,
                   help="GI bounces after the primary vertex")
    r.add_argument("--gi-no-specular", action="store_true",
                   help="path-traced GI: no mirror branch on reflective materials "
                        "(every material Lambertian)")
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
    r.add_argument("--extra-light", action="append", default=None, metavar="X,Y,Z[,I]",
                   help="an additional point light (repeatable; intensity 1 by default)")
    r.add_argument("--light-intensity", type=float, default=None,
                   help="the primary light's intensity (a faithful render then leaves "
                        "the oracle's bytes)")
    r.add_argument("--light-radius", type=float, default=0.0,
                   help="a spherical area light of this radius: soft shadows "
                        "(implies --fast)")
    r.add_argument("--shadow-samples", type=int, default=0,
                   help="shadow rays a light for --light-radius (default 16)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render (the CPU and the "
                        "card) into this directory")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _rank_options(r, "shard the rays over this many ranks, one a device",
                  "with --devices: shard the geometry over the ranks and ring-pass the rays")
    r.set_defaults(fn=cmd_render)
    f = sub.add_parser("fit", help="inverse rendering: fit scene parameters to a target")
    f.add_argument("--scene", default="gradcheck", choices=["gradcheck", "serial", "parallel"])
    f.add_argument("--config", help="scene config JSON (in place of --scene and the size)")
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
                   help="an additional point light (repeatable)")
    f.add_argument("--trainable", default="base_color,kd,ks,ka,light_pos",
                   help="comma-separated SceneParams fields")
    f.add_argument("--out-dir", default=None, help="checkpoint directory")
    f.add_argument("--resume", action="store_true",
                   help="go on from the newest checkpoint in --out-dir (one the JAX "
                        "package wrote too), to --steps in all")
    f.add_argument("--fast", action="store_true", help="production semantics")
    f.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    f.set_defaults(fn=cmd_fit)
    b = sub.add_parser("bench", help="run the port's benchmark (bench_torch.py)")
    b.add_argument("--width", type=int, default=0,
                   help="one measurement at this size (bench_torch.py --size)")
    b.add_argument("--rows", default=None, help="comma list of bench_torch.py rows")
    b.add_argument("--repeat", type=int, default=0, help="frames a timed chain")
    b.add_argument("--rounds", type=int, default=0, help="timed chains a row")
    b.set_defaults(fn=cmd_bench, height=1)
    _inspect_parser(sub, "stats", "per-stage render metrics (JSON)", 64).set_defaults(
        fn=cmd_stats)
    dbg = _inspect_parser(sub, "debug", "single-pixel diagnostic trace (JSON)", 64)
    dbg.add_argument("--x", type=int, required=True)
    dbg.add_argument("--y", type=int, required=True)
    _rank_options(dbg, "with --ring, the ranks the geometry is sharded over (without it "
                       "the pixel is traced on one device)",
                  "trace the pixel through ring orbits over the sharded geometry")
    dbg.set_defaults(fn=cmd_debug)
    av = _inspect_parser(sub, "aov", "export geometry buffers (depth/normal/ids) to .npz", 256)
    av.add_argument("--out", default="aovs.npz")
    av.add_argument("--ao-samples", type=int, default=0,
                    help="add an 'ao' buffer (N hemisphere rays a pixel)")
    av.add_argument("--ao-radius", type=float, default=1.0, help="ambient-occlusion ray length")
    _rank_options(av, "shard the AOV and AO rays over this many ranks, one a device",
                  "shard the geometry over the ranks instead, every trace a ring orbit")
    av.set_defaults(fn=cmd_aov)
    sub.add_parser("info", help="devices and kernel build state (JSON)").set_defaults(
        fn=cmd_info, height=1)
    args = ap.parse_args(argv)
    if args.height == 0:
        args.height = args.width
    args.fn(args)


if __name__ == "__main__":
    main()
