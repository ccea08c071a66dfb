"""
Out-of-core device engine — grids whose accumulation state exceeds the
device-memory budget (`PipelineConfig.gpu_memory_budget`).

The port's counterpart of pcr_tpu/engine/out_of_core.py. Reference
semantics: the TileManager serves *device* state with H2D/D2H on
acquire/release so GPU mode handles grids bigger than VRAM
(src/engine/tile_manager.cpp:183-414). The redesign works in row *bands*:

  * the full per-reduction state lives in host RAM (float32 (H, W) numpy
    arrays);
  * ONE band-shaped ``TorchEngine`` owns the device state of the band
    being accumulated, and runs the same kernels (K1-K5) and scatters as
    the resident engine, band by band;
  * tiled grids band on tile-row multiples: glyph footprints clip to the
    point's home tile, so a band holds every footprint of the points whose
    home tile it holds, and no halo exists;
  * untiled grids band on multiples of kernels.TH (128 rows, to which the
    TorchEngine pads its rows, so a band engine's H_pad is the band and
    its padding rows never reach the next band); a glyph footprint may
    cross bands there, so each entry is copied into every band its
    footprint touches and the band's own row clip cuts each copy;
  * rows are localized by an integer offset (icy - r0), never re-routed
    through float math, so each band sees the resident engine's entries;
  * each band is staged and committed through a view of the band engine
    (TorchEngine.band_view) whose cfg carries the band's row-offset view
    (row_offset = r0, global_height = H): home tiles are clamped at the
    full grid's last row, as the resident engine clamps them (a Gaussian
    centred on the grid's lower edge keeps its footprint in a partial last
    band); K4 and K5 form a cell's distance to a centre from the integer
    row difference, which a band's local rows give exactly, so it carries
    the resident engine's bits.

`gpu_memory_budget` bounds the band's device state: pick_band_rows keeps
it within a quarter of the budget, as pcr_tpu does. A staged cloud's
layout and the staging of one band's chunk come beside it, as they do
beside the resident engine's state.

A band swap copies the dirty band's state from the card straight into the
host state's rows and applies the Gaussian flush there, as
TorchEngine.fetch_state would (residues under GAUSS_WMIN are zeroed at
every swap, as in pcr_tpu), then copies the next band's rows to the card
(TorchEngine.load_state). Both copies go through pageable memory, one
band at a time. Finalize flushes the band and finalizes on the host from
the host state.

Staging returns a list of (band, staged chunks) pairs; `commit` applies
them band by band in ascending order. The raw staging paths
(`prepare_gaussian_raw`, `prepare_line_raw`) return None, so the pipeline
routes such clouds through routing's per-point parameters, which this
engine localizes band by band; each band's chunk may still take the device
layout (`wire_cheap=True`).

On the CPU (PCR_TORCH_DEVICE=cpu) the plain versions add each cell's terms
in entry order, and a cell's entries arrive in the same order banded or
resident, so the bands are bit-identical there. On the card K1-K5 sum a
sub-chunk's terms before they meet the state, and a band's layout has
other sub-chunks, so banded and resident bits may differ by float32
rounding (both within 1e-5 of the oracle); banded reruns are identical.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.grid_config import GridConfig
from ..ops.reduction import _host_finalize, gauss_state_flush
from .kernels import TH
from .tiling import padded_width
from .torch_backend import TorchEngine

__all__ = ["OutOfCoreTorchEngine", "pick_band_rows", "take_optional",
           "take_points"]


def pick_band_rows(cfg: GridConfig, plans, budget: int) -> int:
    """Largest band height whose device working set (state fields +
    staging slack) fits the budget; 0 means the whole grid fits (no
    banding needed).

    Tiled grids band on tile-row multiples (glyph footprints clip to the
    home tile, so tile-aligned bands need no halo). Untiled grids band on
    multiples of kernels.TH, the TorchEngine's row padding; there is no
    tile clip to respect, and the engine copies each glyph entry into
    every band its footprint touches."""
    nf = sum(info.state_floats for _, info in plans)
    bytes_per_row = padded_width(cfg.width) * 4 * nf
    # staging buffers and the layout: keep the state itself within ~1/4
    # of the budget
    rows = int(budget // (4 * bytes_per_row))
    quantum = TH if cfg.total_tiles() <= 1 else cfg.tile_height
    rows = (rows // quantum) * quantum
    if rows >= cfg.height:
        return 0
    return max(rows, quantum)


def take_points(rec, sel, dy: int):
    """A routing parameter record (GaussianParams, LineParams) with every
    per-point array cut to `sel` and its row fields moved up by `dy`."""
    shift = {"icy", "iy0", "iy1"}
    return dataclasses.replace(rec, **{
        f.name: (getattr(rec, f.name)[sel] - np.int32(dy)
                 if f.name in shift else getattr(rec, f.name)[sel])
        for f in dataclasses.fields(rec)
        if isinstance(getattr(rec, f.name), np.ndarray)})


def take_optional(a, sel):
    """An optional per-point array (weights, timestamps) cut to `sel`."""
    return None if a is None else np.asarray(a)[sel]


class OutOfCoreTorchEngine:
    """Band-swapped accumulation engine (see module docstring), with the
    TorchEngine surface the Pipeline uses. `stats` counts the band swaps
    and the bytes and seconds of the copies each way. A band's chunk is
    staged whole: cutting it would pad every tile it meets to whole
    sub-chunks once more a piece."""

    def __init__(self, cfg: GridConfig, plans, band_rows: int,
                 device: torch.device):
        self.untiled = cfg.total_tiles() <= 1
        quantum = TH if self.untiled else cfg.tile_height
        if band_rows <= 0 or band_rows % quantum:
            raise ValueError(f"band_rows must be a positive multiple of "
                             f"{quantum} on this grid")
        self.cfg = cfg
        self.plans = plans
        self.H, self.W = cfg.height, cfg.width
        self.band_rows = band_rows
        self.nbands = -(-self.H // band_rows)
        band_cfg = dataclasses.replace(cfg)
        band_cfg.height = band_rows
        band_cfg.tiles_y = 1 if self.untiled else band_rows // cfg.tile_height
        # the band engine's state is allocated by the first band it loads
        self._exec = TorchEngine(band_cfg, plans, device, state=False)
        self.device = self._exec.device
        # band b's view: its rows are rows [b * band_rows, ...) of the grid
        self._views = [self._exec.band_view(b * band_rows, self.H)
                       for b in range(self.nbands)]
        # order statistics keep their raw stream in the pipeline, no state
        self._host = [None if info.scatter_kind == "collect"
                      else info.init_state((self.H, self.W))
                      for _, info in plans]
        self._cur: int | None = None
        self._dirty = False
        self._tpb = max(band_rows // cfg.tile_height, 1)  # tile rows/band
        self.stats = dict(swaps=0, bytes_in=0, bytes_out=0, seconds_in=0.0,
                          seconds_out=0.0)

    # -- band residency ---------------------------------------------------

    def _band_of(self, row_clamped: np.ndarray) -> np.ndarray:
        """Band id from the (clamped) assigned row — i.e. of the home
        tile (tiled grids) or the raw row (untiled)."""
        if self.untiled:
            return row_clamped // self.band_rows
        return (row_clamped // self.cfg.tile_height) // self._tpb

    def _rows(self, b: int):
        r0 = b * self.band_rows
        return r0, min(r0 + self.band_rows, self.H)

    def _flush_cur(self) -> None:
        if self._cur is None or not self._dirty:
            return
        self._exec.block_until_ready()   # the copy's time, not the kernels'
        t0 = time.perf_counter()
        r0, r1 = self._rows(self._cur)
        for i, (spec, info) in enumerate(self.plans):
            if self._host[i] is None:
                continue
            # one copy from the card straight into the host state's rows,
            # then the Gaussian flush there (as TorchEngine.fetch_state
            # flushes, without its device temporaries)
            band = [h[r0:r1] for h in self._host[i]]
            for h, plane in zip(band, self._exec._planes(i)):
                torch.from_numpy(h).copy_(plane[: r1 - r0])
                self.stats["bytes_out"] += h.nbytes
            for h, f in zip(band, gauss_state_flush(spec, info, band)):
                if f is not h:
                    h[...] = f
        self.stats["seconds_out"] += time.perf_counter() - t0
        self._dirty = False

    def _use_band(self, b: int) -> None:
        if b == self._cur:
            return
        self._flush_cur()
        self._cur = None
        t0 = time.perf_counter()
        r0, r1 = self._rows(b)
        for i, host in enumerate(self._host):
            if host is None:
                continue
            band = [h[r0:r1] for h in host]     # views: one copy, to the card
            self._exec.load_state(i, band)
            self.stats["bytes_in"] += sum(h.nbytes for h in band)
        self._exec.block_until_ready()
        self.stats["seconds_in"] += time.perf_counter() - t0
        self.stats["swaps"] += 1
        self._cur = b

    # -- state access (host-resident) --------------------------------------

    def _flushed(self, spec_idx: int):
        self._flush_cur()
        spec, info = self.plans[spec_idx]
        return gauss_state_flush(spec, info, self._host[spec_idx])

    def fetch_state(self, spec_idx: int):
        """Copies of the full (H, W) host state fields, Gaussian flush
        applied."""
        return [np.array(f, np.float32) for f in self._flushed(spec_idx)]

    def load_state(self, spec_idx: int, fields_hw) -> None:
        self._flush_cur()
        self._cur = None    # the band on the card is stale
        self._host[spec_idx] = [np.array(f, np.float32) for f in fields_hw]

    def finalize_to_host(self, spec_idx: int, with_state: bool = False):
        """Host (K, H, W) raw state planes (`with_state`) or the (1, H, W)
        finalized band, from the host state."""
        _, info = self.plans[spec_idx]
        planes = self._flushed(spec_idx)
        if with_state:
            return np.stack(planes)
        return _host_finalize(info, planes)[None]

    def block_until_ready(self) -> None:
        self._flush_cur()

    def warmup(self) -> None:
        self._exec.warmup()

    # -- staging: group by band, localize rows, delegate to the band engine
    # (writes nothing on the engine: Hybrid workers call these at once)

    def prepare_point(self, spec_idx: int, cells, valid, values,
                      weights=None, timestamps=None, wire_cheap=False,
                      col=None, row=None):
        valid = np.asarray(valid, bool)
        if col is None:
            cells = np.asarray(cells)
            row = cells // self.W
            col = cells - row * self.W
        col, row = np.asarray(col), np.asarray(row)
        values = np.asarray(values)
        return [(b, self._views[b].prepare_point(
                    spec_idx, None, np.ones(int(sel.sum()), bool),
                    values[sel], take_optional(weights, sel),
                    take_optional(timestamps, sel),
                    wire_cheap=wire_cheap, col=col[sel].astype(np.int32),
                    row=(row[sel] - b * self.band_rows).astype(np.int32)))
                for b, sel in self._band_selections(valid, row, row, row)]

    def _band_span(self, y_lo, y_hi, valid):
        """Per-point inclusive band range [b0, b1] of a footprint over rows
        [y_lo, y_hi] (untiled grids)."""
        b0 = np.clip(np.asarray(y_lo) // self.band_rows, 0, self.nbands - 1)
        b1 = np.clip(np.asarray(y_hi) // self.band_rows, 0, self.nbands - 1)
        bands = (range(int(b0[valid].min()), int(b1[valid].max()) + 1)
                 if valid.any() else [])
        return b0, b1, bands

    def _band_selections(self, valid, home_row, y_lo, y_hi):
        """[(band, point selection)], bands ascending: by home band on
        tiled grids; on untiled grids every band the footprint rows
        [y_lo, y_hi] touch (a Point's: its own row)."""
        if self.untiled:
            b0, b1, bands = self._band_span(y_lo, y_hi, valid)
            sels = [(b, valid & (b0 <= b) & (b <= b1)) for b in bands]
        else:
            band = self._band_of(np.clip(home_row, 0, self.H - 1))
            sels = [(b, valid & (band == b))
                    for b in np.unique(band[valid]).tolist()]
        return [(int(b), s) for b, s in sels if s.any()]

    def prepare_gaussian(self, spec_idx: int, gp, valid, values,
                         wire_cheap: bool = False):
        valid = np.asarray(valid, bool)
        values = np.asarray(values)
        return [(b, self._views[b].prepare_gaussian(
                    spec_idx, take_points(gp, sel, b * self.band_rows),
                    np.ones(int(sel.sum()), bool), values[sel],
                    wire_cheap=wire_cheap))
                for b, sel in self._band_selections(
                    valid, gp.icy, gp.icy - gp.r, gp.icy + gp.r)]

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row,
                     wire_cheap: bool = False):
        valid = np.asarray(valid, bool)
        values, col, row = (np.asarray(a) for a in (values, col, row))
        staged = []
        for b, sel in self._band_selections(
                valid, row, np.minimum(lp.iy0, lp.iy1),
                np.maximum(lp.iy0, lp.iy1)):
            off = b * self.band_rows
            llp = take_points(lp, sel, off)
            ddx = np.abs(llp.ix1.astype(np.int64) - llp.ix0)
            ddy = np.abs(llp.iy1.astype(np.int64) - llp.iy0)
            llp.max_steps = int((2 * (ddx + ddy) + 2).max())
            llp.k_cells = int(np.maximum(ddx, ddy).max()) + 1
            lrow = row[sel] - off
            if self.untiled:    # no home tile: any in-band row will do
                lrow = np.clip(lrow, 0, self.band_rows - 1)
            staged.append((b, self._views[b].prepare_line(
                spec_idx, llp, np.ones(int(sel.sum()), bool), values[sel],
                col[sel], lrow.astype(np.int32), wire_cheap=wire_cheap)))
        return staged

    def prepare_gaussian_raw(self, spec_idx, glyph, x, y, valid, values):
        """None: the band engine's raw pass would route world coordinates
        to full-grid rows, so these clouds go through
        routing.gaussian_params and prepare_gaussian."""
        return None

    def prepare_line_raw(self, spec_idx, glyph, x, y, valid, values, col,
                         row):
        """None, as prepare_gaussian_raw: through routing.line_params and
        prepare_line."""
        return None

    # -- commit -----------------------------------------------------------

    def band_engine(self, b: int) -> TorchEngine:
        """The view of the band engine that stages and commits band b's
        chunks (its kernels read band b's row-offset view)."""
        return self._views[b]

    def commit(self, spec_idx: int, staged) -> None:
        """Apply (band, chunks) pairs band by band, ascending; a band's
        chunks keep their order."""
        for b, chunks in sorted(staged, key=lambda t: t[0]):
            self._use_band(b)
            self._views[b].commit(spec_idx, chunks)
            self._dirty = True
