"""
The comparison that decides `correct`: the bands that timed jobs returned
against the plain float64 reference of the same points, one reference a
reduction.

Two numbers, the most over the jobs and bands compared, each with the
limit the configuration file states:

  * nan_cells_differ: cells that hold a value on one side and NaN on the
    other; the limit is 0;
  * max_rel_err: the largest |band - reference| / |reference| over the
    cells where both hold a value (the values of these configurations are
    positive, so a cell's |reference| is its sum of |terms| over its
    weight).

A run adds `jobs_failed`, the jobs of the window that raised, limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import registry
from .grid import Grid


def references(config: dict, points, device, control=False) -> list:
    """The reference of each of the configuration's reductions, (H, W)
    tensors on `device`: float64, or with `control` a step below float32
    (the control, put in the program's place)."""
    grid = Grid.of(config)
    return [registry.glyph(r["glyph"]).reference(points, grid, r, device,
                                                 control)
            for r in config["reductions"]]


def readings(results, refs) -> dict:
    """{name: value} of `results` (one tuple of numpy (H, W) bands a job,
    in the order of the reductions) against `refs` (one tensor a band,
    float64 or the control's float32)."""
    nan_cells, rel = 0, 0.0
    for i, ref in enumerate(refs):
        ref = ref.double()
        ref_nan = torch.isnan(ref)
        mag = ref.abs().clamp_min(torch.finfo(torch.float64).tiny)
        for bands in results:
            p = torch.from_numpy(np.ascontiguousarray(bands[i]))
            p = p.to(ref.device).double()
            p_nan = torch.isnan(p)
            nan_cells = max(nan_cells, int((p_nan != ref_nan).sum()))
            both = ~(p_nan | ref_nan)
            if bool(both.any()):
                rel = max(rel, float(((p - ref).abs() / mag)[both].max()))
            del p, p_nan, both
    return {"max_rel_err": rel, "nan_cells_differ": nan_cells}


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(values[k] <= limits[k] for k in values)


def verdict(config: dict, results, failed: int, refs) -> tuple:
    """(checks, limits, correct) of the results of a run in which `failed`
    jobs raised: no results at all is not correct."""
    checks = dict(readings(results, refs), jobs_failed=failed)
    limits = dict(config["limits"], jobs_failed=0)
    return checks, limits, bool(results) and judge(checks, limits)
