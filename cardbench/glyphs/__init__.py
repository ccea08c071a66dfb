"""
One module a glyph, named by a reduction's `glyph` in a configuration's
`reductions`; `red` is that reduction's dict.

  * `spec(pcr, red)`: the port's ReductionSpec for `red`, built from the
    port's module `pcr`, which the caller hands in, so that the module
    itself imports nothing of the port. It refuses a key or a reduction
    type that its reference does not hold to: a glyph the reference
    cannot check is a module of its own, never a silent stand-in;
  * `reference(points, grid, red, device, control=False)`: the plain
    float64 raster, or with `control` the same a step below float32;
  * `work(points, grid, red, calls, device)`: the bytes and float32
    operations any accumulate of `red` must spend in a job whose `ingest`
    calls take the point ranges `calls`, beyond reading each point's cell,
    which `job_work` counts once a call for all the reductions.
"""

from __future__ import annotations

from .. import registry

CELL_BYTES = 4     # a point's cell, read once a call whatever the reductions


def refuse_unknown(glyph: str, red: dict, keys, types) -> None:
    """Raise ValueError where `red` holds a key outside `keys` or a type
    outside `types`."""
    extra = sorted(set(red) - set(keys))
    if extra:
        raise ValueError(f"{glyph} glyph: its reference holds no {extra}")
    if red["type"] not in types:
        raise ValueError(f"{glyph} glyph: its reference holds no "
                         f"{red['type']} (only {', '.join(types)})")


def job_work(points, grid, reductions, calls, device="cpu") -> dict:
    """{"bytes", "flops"} of one job: each live point's cell read once a
    call, and each reduction's own work."""
    nbytes = flops = 0
    for a, b in calls:
        _, _, valid = grid.assign(points.x[a:b], points.y[a:b])
        nbytes += int(valid.sum()) * CELL_BYTES
    for red in reductions:
        w = registry.glyph(red["glyph"]).work(points, grid, red, calls,
                                              device)
        nbytes, flops = nbytes + w["bytes"], flops + w["flops"]
    return {"bytes": nbytes, "flops": flops}
