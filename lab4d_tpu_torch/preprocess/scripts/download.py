"""Dataset registry downloads: database/vid_data/<vidname>.txt lists one
video URL per line (reference: preprocess/scripts/download.py +
database/vid_data/*.txt with per-sequence links); videos land in
database/raw/<vidname>/."""

from __future__ import annotations

import os
import sys
import urllib.request


def download_seq(vidname: str, database_root: str = "database"):
    reg_path = f"{database_root}/vid_data/{vidname}.txt"
    out_dir = f"{database_root}/raw/{vidname}"
    if not os.path.exists(reg_path):
        raise FileNotFoundError(
            f"no registry entry {reg_path}; place raw videos under {out_dir}/"
        )
    os.makedirs(out_dir, exist_ok=True)
    with open(reg_path) as f:
        urls = [u.strip() for u in f if u.strip() and not u.startswith("#")]
    for i, url in enumerate(urls):
        name = os.path.basename(url.split("?")[0]) or f"{i:04d}.mp4"
        dst = os.path.join(out_dir, name)
        if os.path.exists(dst):
            continue
        print(f"downloading {url} -> {dst}")
        urllib.request.urlretrieve(url, dst)
    return out_dir


if __name__ == "__main__":
    download_seq(sys.argv[1])
