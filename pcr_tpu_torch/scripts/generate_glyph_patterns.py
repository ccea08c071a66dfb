"""
Visual glyph pattern suite on the port.

Renders eight known scenes through the full Pipeline (Point / Line /
Gaussian glyphs) to multi-panel PNG figures, one GeoTIFF per raster
panel (read by compare_patterns for CPU <-> device parity), and an HTML
index. The counterpart of scripts/patterns/generate_glyph_patterns.py;
its scene inventory mirrors the reference's visual validation suite:

  01 gap fill          sparse cloud: Point vs Gaussian sigma progression
  02 sigma progression a sampled analytic surface smoothed at rising sigma
  03 anisotropic       single-point elliptical footprints under rotation
  04 line directions   direction sweep + half-length sweep
  05 flow field        vortex direction field as line strokes + adaptive blobs
  06 sparse vs dense   Point vs Gaussian across three densities
  07 per-point sigma   heterogeneous footprints from a sigma channel
  08 showcase          bullseye ring cloud through all three glyphs

Usage:
    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode cpu
    python -m pcr_tpu_torch.scripts.generate_glyph_patterns --out DIR --mode gpu
    python -m pcr_tpu_torch.scripts.compare_patterns --dir DIR

The figures need matplotlib and are skipped without it; the GeoTIFFs are
always written. `size_scale` (1 by default) scales every scene's cells
per world unit, for a quick small run.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import pcr_tpu_torch as pcr

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # plots are optional; GeoTIFFs still written
    plt = None

# One perceptually-uniform sequential ramp for magnitude rasters
# (empty cells drawn as a neutral light gray, never a palette color).
CMAP = "viridis"
NAN_GRAY = "#e8e8e4"
POINT_INK = "#1c1c1a"


class Ctx:
    """Shared run context: output dir, execution mode, rng, manifest."""

    def __init__(self, out_dir, mode, size_scale=1.0):
        self.out_dir = out_dir
        self.mode_name = mode
        self.exec_mode = (pcr.ExecutionMode.CPU if mode == "cpu"
                          else pcr.ExecutionMode.GPU)
        self.size_scale = size_scale
        self.rng = np.random.default_rng(7)
        self.figures = []  # (scene_title, png_path, caption)

    def grid(self, size, cell=1.0):
        cell = cell / self.size_scale
        bbox = pcr.BBox()
        bbox.min_x, bbox.min_y = 0.0, 0.0
        bbox.max_x, bbox.max_y = float(size), float(size)
        gc = pcr.GridConfig()
        gc.bounds = bbox
        gc.cell_size_x, gc.cell_size_y = cell, -cell
        gc.crs = pcr.CRS.from_epsg(3857)
        gc.compute_dimensions()
        return gc

    def cloud(self, xs, ys, values, channels=()):
        n = len(xs)
        c = pcr.PointCloud.create(n)
        c.set_x_array(np.asarray(xs, np.float64))
        c.set_y_array(np.asarray(ys, np.float64))
        c.add_channel("value", pcr.DataType.Float32)
        c.set_channel_array_f32("value", np.asarray(values, np.float32))
        for name, arr in channels:
            c.add_channel(name, pcr.DataType.Float32)
            c.set_channel_array_f32(name, np.asarray(arr, np.float32))
        return c

    def rasterize(self, gc, cloud, spec, tif_name=None):
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [spec]
        cfg.exec_mode = self.exec_mode
        if self.mode_name == "gpu":
            # parity evidence must not silently degrade to the CPU
            # oracle (0.0-diff "parity" proves nothing): fail instead
            cfg.gpu_require_strict = True
        if tif_name:
            cfg.output_path = os.path.join(
                self.out_dir, f"{tif_name}_{self.mode_name}.tif")
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(cloud)
        pipe.finalize()
        return pipe.result().band_array(0).copy()

    def save_figure(self, fig, scene, title, caption):
        png = os.path.join(self.out_dir, f"{scene}_{self.mode_name}.png")
        fig.suptitle(title, fontsize=13)
        fig.savefig(png, dpi=110, bbox_inches="tight")
        plt.close(fig)
        self.figures.append((title, os.path.basename(png), caption))
        print(f"  wrote {png}")


def panel(ax, band, title, points=None):
    cmap = plt.get_cmap(CMAP).copy()
    cmap.set_bad(NAN_GRAY)
    ax.imshow(np.ma.masked_invalid(band), cmap=cmap, interpolation="nearest")
    if points is not None:
        ax.scatter(points[0], points[1], s=3, c=POINT_INK, alpha=0.6,
                   linewidths=0)
    cov = 100.0 * np.isfinite(band).mean()
    ax.set_title(f"{title}\ncoverage {cov:.1f}%", fontsize=8)
    ax.set_xticks([])
    ax.set_yticks([])


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def scene_01_gap_fill(ctx):
    """Sparse cloud: Point leaves holes, Gaussian closes them."""
    size, n = 200, 500
    gc = ctx.grid(size)
    xs = ctx.rng.uniform(0, size, n)
    ys = ctx.rng.uniform(0, size, n)
    vals = np.sin(xs / 23.0) * np.cos(ys / 31.0)
    cloud = ctx.cloud(xs, ys, vals)

    specs = [("Point (Average)", None, "01_gapfill_point")]
    for s in (2.0, 5.0):
        specs.append((f"Gaussian sigma={s:g}",
                      pcr.gaussian_splat_spec("value", default_sigma=s,
                                              max_radius_cells=24.0),
                      f"01_gapfill_gauss_s{s:g}"))
    bands = []
    for title, spec, tif in specs:
        if spec is None:
            spec = pcr.ReductionSpec()
            spec.value_channel = "value"
            spec.type = pcr.ReductionType.Average
        bands.append((title, ctx.rasterize(gc, cloud, spec, tif)))

    if plt is None:
        return
    fig, axes = plt.subplots(1, 3, figsize=(10.5, 4))
    # cell centers in pixel coords; row 0 is the north (max-y) edge
    px, py = xs, size - ys
    for i, (ax, (title, band)) in enumerate(zip(axes, bands)):
        panel(ax, band, title, points=(px, py) if i == 0 else None)
    ctx.save_figure(
        fig, "scene01_gap_fill", "01 - Gap fill: Point vs Gaussian",
        f"{n} sparse points on a {size}x{size} grid; dots mark the "
        "input points on the Point panel.")


def scene_02_sigma_progression(ctx):
    """Analytic surface sampled sparsely, smoothed at rising sigma."""
    size, n = 192, 2500
    gc = ctx.grid(size)
    xs = ctx.rng.uniform(0, size, n)
    ys = ctx.rng.uniform(0, size, n)
    vals = np.sin(xs / 14.0) + np.cos(ys / 19.0)
    cloud = ctx.cloud(xs, ys, vals)

    bands = []
    spec = pcr.ReductionSpec()
    spec.value_channel = "value"
    spec.type = pcr.ReductionType.Average
    bands.append(("Point baseline",
                  ctx.rasterize(gc, cloud, spec, "02_sigma_point")))
    for s in (0.5, 1.0, 2.0, 4.0, 8.0):
        g = pcr.gaussian_splat_spec("value", default_sigma=s,
                                    max_radius_cells=28.0)
        bands.append((f"sigma={s:g}",
                      ctx.rasterize(gc, cloud, g, f"02_sigma_s{s:g}")))

    if plt is None:
        return
    fig, axes = plt.subplots(2, 3, figsize=(10.5, 7.5))
    for ax, (title, band) in zip(axes.flat, bands):
        panel(ax, band, title)
    ctx.save_figure(
        fig, "scene02_sigma_progression",
        "02 - Sigma progression over a sinusoidal surface",
        "Rising sigma trades detail for coverage; the surface stays "
        "recognizable because WeightedAverage normalizes the kernel mass.")


def scene_03_anisotropic(ctx):
    """Single-point elliptical footprints under rotation."""
    size = 96
    gc = ctx.grid(size)
    angles = [0, 30, 60, 90, 120, 150]
    bands = []
    for deg in angles:
        cloud = ctx.cloud([size / 2], [size / 2], [1.0],
                          [("rot", [np.deg2rad(deg)])])
        g = pcr.gaussian_splat_spec(
            "value", default_sigma_x=10.0, default_sigma_y=2.5,
            rotation_channel="rot", max_radius_cells=40.0)
        g.type = pcr.ReductionType.Sum  # kernel weight IS the output
        bands.append((f"rotation {deg} deg",
                      ctx.rasterize(gc, cloud, g, f"03_aniso_r{deg}")))

    if plt is None:
        return
    fig, axes = plt.subplots(2, 3, figsize=(9.5, 6.8))
    for ax, (title, band) in zip(axes.flat, bands):
        panel(ax, band, title)
    ctx.save_figure(
        fig, "scene03_anisotropic",
        "03 - Anisotropic Gaussian: sigma_x=10, sigma_y=2.5, rotating",
        "One point at grid center, Sum reduction, so the raster is the "
        "raw elliptical kernel; the footprint must rotate rigidly.")


def scene_04_line_directions(ctx):
    """3x3 direction sweep + half-length sweep."""
    size = 120
    gc = ctx.grid(size)
    # 3x3 lattice of lone points, each stroked at its own angle
    cc = np.array([24, 60, 96], float)
    gx, gy = np.meshgrid(cc, cc)
    dirs = np.deg2rad(np.arange(9) * 20.0)
    cloud = ctx.cloud(gx.ravel(), gy.ravel(), np.ones(9),
                      [("dir", dirs)])
    sweep = pcr.line_splat_spec("value", direction_channel="dir",
                                default_half_length=14.0,
                                max_radius_cells=20.0)
    sweep.type = pcr.ReductionType.Sum
    bands = [("directions 0..160 deg",
              ctx.rasterize(gc, cloud, sweep, "04_line_dirsweep"))]

    for hl in (2.0, 5.0, 10.0, 18.0):
        c = ctx.cloud([size / 2], [size / 2], [1.0])
        sp = pcr.line_splat_spec("value", default_direction=np.pi / 6,
                                 default_half_length=hl,
                                 max_radius_cells=24.0)
        sp.type = pcr.ReductionType.Sum
        bands.append((f"half_length={hl:g}",
                      ctx.rasterize(gc, c, sp, f"04_line_hl{hl:g}")))

    if plt is None:
        return
    fig = plt.figure(figsize=(11, 6.4))
    gs = fig.add_gridspec(2, 4)
    ax0 = fig.add_subplot(gs[0, :])
    panel(ax0, bands[0][1], bands[0][0])
    for k, (title, band) in enumerate(bands[1:]):
        panel(fig.add_subplot(gs[1, k]), band, title)
    ctx.save_figure(
        fig, "scene04_line_directions",
        "04 - Line glyph: direction sweep and half-length sweep",
        "Bresenham strokes stay one cell wide at every angle; stroke "
        "length scales with half_length at fixed 30-degree direction.")


def scene_05_flow_field(ctx):
    """Counter-clockwise vortex rendered as strokes and adaptive blobs."""
    size = 240
    gc = ctx.grid(size)
    cc = np.arange(8, size, 10, dtype=float)
    gx, gy = np.meshgrid(cc, cc)
    xs, ys = gx.ravel(), gy.ravel()
    dx, dy = xs - size / 2, ys - size / 2
    r = np.hypot(dx, dy)
    rn = r / r.max()
    # tangent direction (CCW) with a floor on stroke length near center
    ang = np.arctan2(dy, dx) + np.pi / 2
    hl = np.maximum(2.0, 6.0 * rn)
    cloud = ctx.cloud(xs, ys, rn, [("dir", ang), ("hl", hl)])
    lines = pcr.line_splat_spec("value", direction_channel="dir",
                                half_length_channel="hl",
                                max_radius_cells=12.0)
    band_lines = ctx.rasterize(gc, cloud, lines, "05_flow_lines")

    sig = np.maximum(0.8, 4.0 * rn)
    cloud2 = ctx.cloud(xs, ys, rn, [("sig", sig)])
    blobs = pcr.gaussian_splat_spec("value", sigma_x_channel="sig",
                                    sigma_y_channel="sig",
                                    max_radius_cells=16.0)
    blobs.type = pcr.ReductionType.Sum
    band_blobs = ctx.rasterize(gc, cloud2, blobs, "05_flow_blobs")

    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(9.5, 5))
    panel(axes[0], band_lines, "tangent strokes, half_length ~ radius")
    panel(axes[1], band_blobs, "adaptive Gaussian, sigma ~ radius")
    ctx.save_figure(
        fig, "scene05_flow_field", "05 - Vortex flow field",
        "Per-point direction/half-length/sigma channels drive the "
        "glyphs; value is normalized radius.")


def scene_06_sparse_vs_dense(ctx):
    """Point vs Gaussian across three densities."""
    size = 100
    gc = ctx.grid(size)
    bands = []
    for n in (50, 500, 5000):
        xs = ctx.rng.uniform(0, size, n)
        ys = ctx.rng.uniform(0, size, n)
        vals = (xs + ys) / (2 * size)
        cloud = ctx.cloud(xs, ys, vals)
        spec = pcr.ReductionSpec()
        spec.value_channel = "value"
        spec.type = pcr.ReductionType.Average
        bands.append((f"Point, n={n}",
                      ctx.rasterize(gc, cloud, spec, f"06_point_n{n}")))
        g = pcr.gaussian_splat_spec("value", default_sigma=3.0,
                                    max_radius_cells=16.0)
        bands.append((f"Gaussian s=3, n={n}",
                      ctx.rasterize(gc, cloud, g, f"06_gauss_n{n}")))

    if plt is None:
        return
    fig, axes = plt.subplots(3, 2, figsize=(7, 10))
    for ax, (title, band) in zip(axes.flat, bands):
        panel(ax, band, title)
    ctx.save_figure(
        fig, "scene06_sparse_vs_dense",
        "06 - Density sweep: Point vs Gaussian",
        "The Gaussian panel converges to the Point panel's surface as "
        "density rises; at n=50 it is the only usable rendering.")


def scene_07_per_point_sigma(ctx):
    """Heterogeneous footprints from a per-point sigma channel."""
    size, n = 200, 350
    gc = ctx.grid(size)
    xs = ctx.rng.uniform(0, size, n)
    ys = ctx.rng.uniform(0, size, n)
    sig = np.clip(ctx.rng.lognormal(0.6, 0.7, n), 0.5, 9.0)
    cloud = ctx.cloud(xs, ys, np.ones(n), [("sig", sig)])
    g = pcr.gaussian_splat_spec("value", sigma_x_channel="sig",
                                sigma_y_channel="sig",
                                max_radius_cells=28.0)
    g.type = pcr.ReductionType.Sum  # output = sum of kernel weights
    band = ctx.rasterize(gc, cloud, g, "07_perpoint_sigma")

    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(9.5, 5))
    axes[0].scatter(xs, size - ys, s=(sig * 2.2) ** 2, c=POINT_INK,
                    alpha=0.45, linewidths=0)
    axes[0].set_xlim(0, size)
    axes[0].set_ylim(size, 0)
    axes[0].set_aspect("equal")
    axes[0].set_title("input: marker area ~ sigma", fontsize=8)
    axes[0].set_xticks([])
    axes[0].set_yticks([])
    panel(axes[1], band, "rendered footprint mass (Sum)")
    ctx.save_figure(
        fig, "scene07_per_point_sigma", "07 - Per-point sigma",
        "sigma drawn from a clipped lognormal; bucketed radii must "
        "reproduce each footprint at its own size.")


def scene_08_showcase(ctx):
    """Bullseye ring cloud through Point / Line / Gaussian."""
    size = 200
    gc = ctx.grid(size)
    xs, ys, vals, tang = [], [], [], []
    for k, radius in enumerate(range(15, 96, 16)):
        m = max(24, int(2 * np.pi * radius / 3))
        th = np.linspace(0, 2 * np.pi, m, endpoint=False)
        th += ctx.rng.uniform(0, 0.1, m)
        xs.append(size / 2 + radius * np.cos(th))
        ys.append(size / 2 + radius * np.sin(th))
        vals.append(np.full(m, (k % 2) * 0.7 + 0.3))
        tang.append(th + np.pi / 2)
    xs, ys = np.concatenate(xs), np.concatenate(ys)
    vals, tang = np.concatenate(vals), np.concatenate(tang)

    spec = pcr.ReductionSpec()
    spec.value_channel = "value"
    spec.type = pcr.ReductionType.Average
    cloud = ctx.cloud(xs, ys, vals)
    band_pt = ctx.rasterize(gc, cloud, spec, "08_showcase_point")

    cloud_l = ctx.cloud(xs, ys, vals, [("dir", tang)])
    lines = pcr.line_splat_spec("value", direction_channel="dir",
                                default_half_length=4.0,
                                max_radius_cells=8.0)
    band_ln = ctx.rasterize(gc, cloud_l, lines, "08_showcase_line")

    g = pcr.gaussian_splat_spec("value", default_sigma=2.0,
                                max_radius_cells=12.0)
    band_g = ctx.rasterize(gc, cloud, g, "08_showcase_gauss")

    if plt is None:
        return
    fig, axes = plt.subplots(1, 3, figsize=(10.5, 4))
    panel(axes[0], band_pt, "Point (Average)")
    panel(axes[1], band_ln, "Line, tangent strokes")
    panel(axes[2], band_g, "Gaussian sigma=2")
    ctx.save_figure(
        fig, "scene08_showcase",
        "08 - Showcase: bullseye rings through every glyph",
        "Concentric scan rings (alternating values) like LiDAR returns; "
        "tangent line strokes close the rings, Gaussian fills them.")


def write_index(ctx):
    rows = []
    for title, png, caption in ctx.figures:
        rows.append(
            f'<section><h2>{title}</h2><p>{caption}</p>'
            f'<img src="{png}" alt="{title}" style="max-width:100%"/>'
            f"</section>")
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>pcr_tpu_torch glyph patterns ({ctx.mode_name})</title>"
        "<style>body{font-family:sans-serif;max-width:1000px;margin:2em "
        "auto;color:#1c1c1a}h2{margin-top:1.6em}p{color:#555}</style>"
        "</head><body><h1>pcr_tpu_torch glyph pattern suite "
        f"({ctx.mode_name} mode)</h1>" + "".join(rows) + "</body></html>")
    path = os.path.join(ctx.out_dir, f"index_{ctx.mode_name}.html")
    with open(path, "w") as f:
        f.write(html)
    print(f"  wrote {path}")


SCENES = [
    scene_01_gap_fill,
    scene_02_sigma_progression,
    scene_03_anisotropic,
    scene_04_line_directions,
    scene_05_flow_field,
    scene_06_sparse_vs_dense,
    scene_07_per_point_sigma,
    scene_08_showcase,
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "pcr_patterns"))
    ap.add_argument("--mode", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--scenes", type=int, nargs="*", default=None,
                    help="1-based scene numbers to render (default: all)")
    ap.add_argument("--size-scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    ctx = Ctx(args.out, args.mode, args.size_scale)
    wanted = set(args.scenes) if args.scenes else None
    for i, scene in enumerate(SCENES, 1):
        if wanted and i not in wanted:
            continue
        print(f"[{i:02d}] {scene.__doc__.splitlines()[0]}")
        scene(ctx)
    if plt is not None:
        write_index(ctx)
    else:
        print("matplotlib unavailable: GeoTIFFs written, figures skipped")


if __name__ == "__main__":
    main()
