"""Run one benchmark cell once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines of standard error repeat the
checks. ``--control`` puts the reference, computed one precision below the
configuration's, in the program's place and prints the same numbers, to
read the control's side of each limit; it runs no window.

Every build and kernel cache of the program goes to a fixed directory under
``build/`` in the checkout. The run is one process with one CPU thread per
math library and a fixed string hash seed (the script starts itself again
with ``PYTHONHASHSEED=0`` where it is not set so), so that runs differ in
their seed and not in the host's threading or hashing.
"""

import os
import sys
import time

if os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable, *sys.argv])

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import cell  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the reference one precision lower in the program's place")
    args = p.parse_args(argv)
    spec = cell.load(ROOT, args.workload)
    return cell.run(spec, args.seed, args.seconds, args.trace, T_PROCESS, control=args.control)


if __name__ == "__main__":
    sys.exit(main())
