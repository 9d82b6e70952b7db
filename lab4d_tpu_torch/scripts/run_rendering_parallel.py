"""Render every video (instance) of a run, the renders fanned out over the
cards (utils/device_map.py, one process per card, each task to the next
card that frees up): the port of scripts/run_rendering_parallel.py, which
runs `python -m lab4d_tpu_torch.render` per instance.

    python -m lab4d_tpu_torch.scripts.run_rendering_parallel <seqname> <logname> <devlist> \\
        [render flags ...]
"""

from __future__ import annotations

import configparser
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def render_command(seqname, logname, inst_id, extra_args=()) -> list:
    return [
        sys.executable, "-m", "lab4d_tpu_torch.render",
        "--seqname", seqname,
        "--logname", logname,
        "--inst_id", str(inst_id),
        "--load_suffix", "latest",
    ] + list(extra_args)


def _render_one(seqname, logname, inst_id, extra_args):
    import subprocess

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(render_command(seqname, logname, inst_id, extra_args), check=True, env=env)
    return inst_id


def _database_root(extra_args) -> str:
    """The render flags' --database_root (default "database")."""
    args = list(extra_args)
    for i, a in enumerate(args):
        if a == "--database_root" and i + 1 < len(args):
            return args[i + 1]
        if a.startswith("--database_root="):
            return a.split("=", 1)[1]
    return "database"


def run_rendering_parallel(seqname, logname, devlist, extra_args=()):
    """One render per video of <database_root>/configs/<seqname>.config;
    returns the instance ids in order."""
    from lab4d_tpu_torch.utils.device_map import device_map

    config = configparser.RawConfigParser()
    config.read(f"{_database_root(extra_args)}/configs/{seqname}.config")
    num_vids = len(config.sections()) - 1
    args = [(seqname, logname, i, tuple(extra_args)) for i in range(num_vids)]
    return device_map(_render_one, args, devices=devlist, method="dynamic")


if __name__ == "__main__":
    if len(sys.argv) < 4:
        print(f"Usage: python -m lab4d_tpu_torch.scripts.run_rendering_parallel "
              f"<seqname> <logname> <devlist> [extra flags...]")
        sys.exit(1)
    run_rendering_parallel(
        sys.argv[1],
        sys.argv[2],
        [int(x) for x in sys.argv[3].split(",")],
        sys.argv[4:],
    )
