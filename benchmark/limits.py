"""The limits of a cell's compared numbers: benchmark/limits/<cell>.json,
{number: {"limit": value, "lower": reading, "upper": reading, "from": what
the readings are}}; the readings are those the limit was set between
(benchmark/control.py)."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(cell: str, root: str = None) -> dict:
    here = HERE if root is None else os.path.join(root, "benchmark")
    with open(os.path.join(here, "limits", f"{cell}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def checks(cell: str, values: dict, root: str = None) -> dict:
    """{number: {"value", "limit"}} for every number the cell's limits name;
    a number the run could not read counts as infinitely far off."""
    return {k: {"value": float(values.get(k, float("inf"))), "limit": lim}
            for k, lim in load(cell, root).items()}
