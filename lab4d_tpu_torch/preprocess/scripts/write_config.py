"""Scan processed videos of a collection and emit the training .config INI
(reference: preprocess/scripts/write_config.py: min 8 frames, focal guess
= max(H, W), principal point = image center)."""

import configparser
import glob
import os
import sys

import cv2

MIN_NFRAME = 8


def write_config(collection_name: str, database_root: str = "database"):
    imgroot = f"{database_root}/processed/JPEGImages/Full-Resolution"
    config = configparser.ConfigParser()
    config["data"] = {"init_frame": "0", "end_frame": "-1"}

    vid_dirs = sorted(glob.glob(f"{imgroot}/{collection_name}-[0-9][0-9][0-9][0-9]*"))
    total = 0
    for vid_dir in vid_dirs:
        frames = sorted(glob.glob(f"{vid_dir}/*.jpg"))
        if len(frames) < MIN_NFRAME:
            continue
        shape = cv2.imread(frames[0], 0).shape
        fl = max(shape)
        config[f"data_{total}"] = {
            "ks": f"{fl} {fl} {shape[1] // 2} {shape[0] // 2}",
            "shape": f"{shape[0]} {shape[1]}",
            "img_path": vid_dir.rstrip("/") + "/",
        }
        total += 1

    os.makedirs(f"{database_root}/configs", exist_ok=True)
    with open(f"{database_root}/configs/{collection_name}.config", "w") as f:
        config.write(f)
    print(f"wrote config for {total} videos: {collection_name}")
    return total


if __name__ == "__main__":
    write_config(sys.argv[1])
