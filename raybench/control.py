"""The control of a cell's comparison: the reference put in the program's
place, computed one precision below the configuration's (bfloat16 for
its float32), and judged by the cell's own comparison at the cell's own
size; with --fault half_batch (the fit), the float32 reference whose
loss is the mean over half of the pixels.  Each must read above the
cell's limits.

    python3 raybench/control.py --workload NAME --seed N [--seed M ...] \
        [--fault half_batch] [--size S] [--device cuda]

Prints one JSON line a seed: the numbers and the cell's limits."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(workload: str, seed: int, device: str, size: int = None,
                    fault: str = None) -> dict:
    import torch

    from raybench.harness import cells, checks
    from raybench.harness.port import perturbation
    from raybench.reference.geometry import load_verts_faces

    cell = cells.load_cell(workload)
    traffic = cell.traffic
    size = int(size or traffic["size"])
    if traffic["mode"] == "frames":
        pixels = checks.sample_pixels(seed, size * size, int(traffic["check"]["pixels"]), device)
        low = checks.reference_frame(cell.config, traffic, size, pixels, torch.bfloat16)
        return checks.frame_numbers(cell.config, traffic, size, pixels, low)
    verts, _, _ = load_verts_faces(cell.config)
    delta = perturbation(traffic, verts.shape[0], len(cell.config["materials"]), seed, device)
    ref = checks.reference_fit_record(cell.config, traffic, size, delta, device)
    if fault == "half_batch":
        prog = checks.reference_fit_record(cell.config, traffic, size, delta, device,
                                           half_batch=True)
    else:
        prog = checks.reference_fit_record(cell.config, traffic, size, delta, device,
                                           torch.bfloat16)
    return checks.fit_numbers(prog, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--fault", choices=("half_batch",))
    ap.add_argument("--size", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from raybench.harness import cells

    limits = cells.load_cell(args.workload).limits
    for seed in args.seed:
        t0 = time.perf_counter()
        numbers = control_numbers(args.workload, seed, args.device, args.size, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "control": "bfloat16" if args.fault is None else args.fault,
                          "numbers": numbers, "seconds": time.perf_counter() - t0,
                          "limits": {k: limits.get(k, {}).get("limit") for k in numbers}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
