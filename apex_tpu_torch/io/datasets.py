"""Dataset registry and downloader (counterpart of
``apex_tpu/io/datasets.py``, the same names, URLs and cache).

Named pose-graph datasets and BAL problems resolve to URLs, are downloaded
to a local cache and decompressed. The cache is ``$APEX_TPU_DATA_DIR``, or
``~/.cache/apex_tpu``: the one the JAX package uses, so both share it. A
cached file is returned as it is; where the file is absent and there is no
network, ``ensure_*`` raises ``ConnectionError`` and the caller falls back
to the ``io.synthetic`` generators.
"""

from __future__ import annotations

import bz2
import os
import pathlib
import urllib.request

# The registry (URLs from the public g2o / BAL dataset collections).
POSE_GRAPH_DATASETS = {
    # name: (manifold, url)
    "sphere2500": ("SE3", "https://raw.githubusercontent.com/OpenSLAM-org/openslam_vertigo/master/datasets/sphere2500/originalDataset/sphere2500.g2o"),
    "parking-garage": ("SE3", "https://www.dropbox.com/s/zu23p8d522qccor/parking-garage.g2o?dl=1"),
    "torus3D": ("SE3", "https://www.dropbox.com/s/d2cyzvnqgj07rc1/torus3D.g2o?dl=1"),
    "grid3D": ("SE3", "https://www.dropbox.com/s/xmhrmy77zxkrrw2/grid3D.g2o?dl=1"),
    "cubicle": ("SE3", "https://www.dropbox.com/s/he1krvsqbjoft5l/cubicle.g2o?dl=1"),
    "rim": ("SE3", "https://www.dropbox.com/s/1ipjyw4dp2c2fo0/rim.g2o?dl=1"),
    "intel": ("SE2", "https://www.dropbox.com/s/vcz8cag7bo0zlaj/input_INTEL_g2o.g2o?dl=1"),
    "M3500": ("SE2", "https://www.dropbox.com/s/gpjjcl0cu2g65rz/input_M3500_g2o.g2o?dl=1"),
    "mit": ("SE2", "https://www.dropbox.com/s/s79jnv555zhn1d5/input_MITb_g2o.g2o?dl=1"),
    "city10000": ("SE2", "https://www.dropbox.com/s/vdlvfnqhy7vx32v/input_M10000_g2o.g2o?dl=1"),
    "ring": ("SE2", "https://www.dropbox.com/s/kts8pvicnvyyft3/ring.g2o?dl=1"),
}

BAL_URL_PREFIX = "https://grail.cs.washington.edu/projects/bal"
BAL_PROBLEMS = {
    # name: (category, file)
    "ladybug-49": ("ladybug", "problem-49-7776-pre.txt.bz2"),
    "ladybug-1723": ("ladybug", "problem-1723-156502-pre.txt.bz2"),
    "trafalgar-21": ("trafalgar", "problem-21-11315-pre.txt.bz2"),
    "trafalgar-257": ("trafalgar", "problem-257-65132-pre.txt.bz2"),
    "dubrovnik-356": ("dubrovnik", "problem-356-226730-pre.txt.bz2"),
    "venice-1778": ("venice", "problem-1778-993923-pre.txt.bz2"),
    "final-13682": ("final", "problem-13682-4456117-pre.txt.bz2"),
}


def cache_dir() -> pathlib.Path:
    d = os.environ.get("APEX_TPU_DATA_DIR",
                       os.path.join(os.path.expanduser("~"), ".cache", "apex_tpu"))
    p = pathlib.Path(d)
    p.mkdir(parents=True, exist_ok=True)
    return p


def download_file(url: str, dest: pathlib.Path, timeout: float = 60.0):
    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(tmp, "wb") as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        tmp.rename(dest)
    except Exception as e:  # noqa: BLE001 - surface any network failure uniformly
        tmp.unlink(missing_ok=True)
        raise ConnectionError(
            f"failed to download {url}: {e}. This environment may have no "
            f"network egress — use apex_tpu_torch.io.synthetic generators instead."
        ) from e


def decompress_bz2(src: pathlib.Path, dest: pathlib.Path):
    with bz2.open(src, "rb") as f, open(dest, "wb") as out:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            out.write(chunk)


def ensure_pose_graph_dataset(name: str) -> pathlib.Path:
    if name not in POSE_GRAPH_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(POSE_GRAPH_DATASETS)}")
    _, url = POSE_GRAPH_DATASETS[name]
    dest = cache_dir() / f"{name}.g2o"
    if not dest.exists():
        download_file(url, dest)
    return dest


def ensure_ba_dataset(name: str) -> pathlib.Path:
    if name not in BAL_PROBLEMS:
        raise KeyError(f"unknown BAL problem {name!r}; known: {sorted(BAL_PROBLEMS)}")
    category, fname = BAL_PROBLEMS[name]
    txt = cache_dir() / fname.removesuffix(".bz2")
    if txt.exists():
        return txt
    bz = cache_dir() / fname
    if not bz.exists():
        download_file(f"{BAL_URL_PREFIX}/data/{category}/{fname}", bz)
    decompress_bz2(bz, txt)
    return txt
