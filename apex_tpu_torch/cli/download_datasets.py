"""Dataset downloader CLI of the port (counterpart of
``apex_tpu/cli/download_datasets.py``, same arguments and output).

Lists the registry with each entry's cache status, downloads named datasets
(or ``--all``) into the cache (``$APEX_TPU_DATA_DIR`` or
``~/.cache/apex_tpu``, shared with the JAX package). Without network a
download fails with ``ConnectionError`` and the command exits 1.

Usage:
    python -m apex_tpu_torch.cli.download_datasets --list
    python -m apex_tpu_torch.cli.download_datasets sphere2500 intel
    python -m apex_tpu_torch.cli.download_datasets --ba ladybug-49
    python -m apex_tpu_torch.cli.download_datasets --all
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from apex_tpu_torch.io.datasets import (
        BAL_PROBLEMS,
        POSE_GRAPH_DATASETS,
        cache_dir,
        ensure_ba_dataset,
        ensure_pose_graph_dataset,
    )

    p = argparse.ArgumentParser(prog="download_datasets")
    p.add_argument("names", nargs="*", help="pose-graph dataset names")
    p.add_argument("--ba", nargs="*", default=[], help="BAL problem names")
    p.add_argument("--all", action="store_true", help="download everything")
    p.add_argument("--list", action="store_true", help="list registry and cache status")
    args = p.parse_args(argv)

    cache = cache_dir()
    if args.list or (not args.names and not args.ba and not args.all):
        print(f"cache dir: {cache}\n")
        print("pose-graph datasets:")
        for name, (manifold, _) in sorted(POSE_GRAPH_DATASETS.items()):
            cached = "cached" if (cache / f"{name}.g2o").exists() else "-"
            print(f"  {name:<16} {manifold:<4} [{cached}]")
        print("\nBAL problems:")
        for name, (cat, fname) in sorted(BAL_PROBLEMS.items()):
            cached = "cached" if (cache / fname.removesuffix(".bz2")).exists() else "-"
            print(f"  {name:<16} {cat:<10} [{cached}]")
        return 0

    names = list(args.names)
    ba = list(args.ba)
    if args.all:
        names = sorted(POSE_GRAPH_DATASETS)
        ba = sorted(BAL_PROBLEMS)

    failures = 0
    for ensure, group in ((ensure_pose_graph_dataset, names), (ensure_ba_dataset, ba)):
        for name in group:
            try:
                print(f"{name}: {ensure(name)}")
            except (KeyError, ConnectionError, OSError) as e:
                print(f"{name}: FAILED ({e})", file=sys.stderr)
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
