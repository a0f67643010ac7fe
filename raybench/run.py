"""The benchmark of `ray_tracer_tpu_torch` on one NVIDIA card.

    python3 raybench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the repository's root.  Prints one JSON line as the last line of
standard output (see raybench/README.md).  Exits 2 without a result when
no CUDA card (or fewer than the cell asks for) is present."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "raybench")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
        os.environ[var] = os.path.join(BUILD, sub)
    sys.path.insert(0, ROOT)
    import torch

    from raybench.harness import cells

    chips = next((w["chips"] for w in cells.benchmark()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    imports_s = time.perf_counter() - T_START
    from raybench.harness.main import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                    imports_s=imports_s)


if __name__ == "__main__":
    sys.exit(main())
