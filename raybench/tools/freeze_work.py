"""Count the work of a cell's kernels once and freeze it as data:

    python3 raybench/tools/freeze_work.py --workload NAME [--device cuda]

writes raybench/work/counts/NAME.json (or NAME.json in --out-dir) with one entry a kernel that the
cell's traffic file lists under "work" (work/<kernel>.py's `count`)."""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "raybench", "work", "counts"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from raybench.harness import cells

    for name in args.workload:
        cell = cells.load_cell(name)
        out = {}
        for kernel in cell.traffic["work"]:
            t0 = time.perf_counter()
            out[kernel] = importlib.import_module(f"raybench.work.{kernel}").count(
                cell.config, cell.traffic, args.device)
            print(name, kernel, json.dumps(out[kernel]), f"{time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, name + ".json")
        with open(path, "w") as fh:
            json.dump(out, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
