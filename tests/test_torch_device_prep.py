"""The host-sourced ingest slice of the PyTorch port: the device layout
(pcr_tpu_torch/engine/device_prep.py), the exact wires, the chunking and
Hybrid mode's worker pool, on torch-CPU (PCR_TORCH_DEVICE=cpu, where every
kernel takes its plain version).

  * `device_layout` holds the five properties tests/test_device_prep.py
    holds for pcr_tpu's `aligned_sorted_planes`, in the port's form (no
    sub-chunk for a tile without entries: in-place updates need none).
  * Bytes: the port's device route against the port's host route on the
    same chunk, `torch.equal` on params and bids; tolerance: none. No twin
    here compares bytes across the two packages.
  * Against pcr_tpu: the same seeded clouds through pcr_tpu in Hybrid mode
    (its lossy wire, its Pallas kernels in interpret mode) and through the
    port in Hybrid mode. Gaussian bands agree within 1e-4 of the band's
    largest value (pcr_tpu's own bar for its u16 sub-cell offsets,
    device_prep.py:43-46) and the port's within atol = rtol = 1e-5 of the
    numpy oracle; Line bands within 1e-5 with the same NaN footprint;
    Count against the oracle and pcr_tpu's walk, never its rect path.
  * The slice as a whole: Hybrid = GPU bit for bit, whatever the workers.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu_torch import native
from pcr_tpu_torch.engine import device_prep as dp
from pcr_tpu_torch.engine import routing
from pcr_tpu_torch.engine.glyph import GlyphType
from pcr_tpu_torch.engine.kernels import BLOCK
from pcr_tpu_torch.engine.torch_backend import layout_tiles_numpy
from test_torch_pipeline import assert_close, like, run

RT = ref.ReductionType
GPU, CPU, HYBRID = (ref.ExecutionMode.GPU, ref.ExecutionMode.CPU,
                    ref.ExecutionMode.Hybrid)

@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PCR_PALLAS", "interpret")
    monkeypatch.delenv("PCR_WIRE_CHEAP", raising=False)


# -- device_layout ------------------------------------------------------------

def layout(eb, nblocks, idx=None, payload=None):
    """One int32 payload plane (entry id + 1, fill 0) through
    device_layout; also held against the host's numpy layout."""
    eb = np.asarray(eb, np.int64)
    n = len(eb) if idx is None else int(np.max(idx, initial=-1)) + 1
    payload = (np.arange(n, dtype=np.int32) + 1 if payload is None
               else payload)
    params, bids = dp.device_layout(
        torch.from_numpy(eb), [torch.from_numpy(payload)], nblocks, [0],
        None if idx is None else torch.from_numpy(np.asarray(idx, np.int64)))
    buf, nsub = layout_tiles_numpy(eb, nblocks, [(payload, 0)], idx)
    assert params.shape == (nsub, 1, BLOCK) and len(bids) == nsub
    assert np.array_equal(params.numpy().reshape(-1), buf[: nsub * BLOCK])
    assert np.array_equal(bids.numpy(), buf[nsub * BLOCK:])
    return params.numpy()[:, 0], bids.numpy()


def test_every_tile_with_entries_gets_whole_subchunks():
    eb = np.concatenate([np.full(BLOCK + 5, 2), np.full(7, 5)])
    plane, bids = layout(eb, 8)
    assert bids.tolist() == [2, 2, 5]           # ascending, none for empty
    assert (plane[1, 5:] == 0).all() and (plane[2, 7:] == 0).all()


def test_entries_grouped_and_order_kept():
    rng = np.random.default_rng(0)
    nblocks = 8
    eb = rng.integers(0, nblocks, 3 * BLOCK)
    plane, bids = layout(eb, nblocks)
    for b in range(nblocks):
        got = plane[bids == b].reshape(-1)
        assert got[got > 0].tolist() == (np.flatnonzero(eb == b) + 1).tolist()


def test_fill_sits_behind_the_live_entries_of_a_run():
    rng = np.random.default_rng(1)
    eb = rng.integers(0, 3, 2 * BLOCK + 100)
    plane, bids = layout(eb, 3)
    for b in range(3):
        run = plane[bids == b].reshape(-1)
        live = np.flatnonzero(run > 0)
        assert len(live) == (eb == b).sum() and live[-1] == len(live) - 1


def test_a_chunk_without_entries_is_one_subchunk_of_fill():
    plane, bids = layout(np.zeros(0, np.int64), 3)
    assert plane.shape == (1, BLOCK) and not plane.any()
    assert bids.tolist() == [0]


def test_entries_take_their_item_through_idx():
    idx = np.array([0, 0, 2, 2, 2, 1])          # halo copies of 3 items
    plane, bids = layout([1, 0, 1, 0, 1, 1], 2, idx,
                         np.array([10, 20, 30], np.int32))
    assert plane[0, :2].tolist() == [10, 30]
    assert plane[1, :4].tolist() == [10, 30, 30, 20]


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(2)
    a = rng.integers(-32768, 32768, 200)
    b = rng.integers(-32768, 32768, 200)
    a[0], b[0] = dp.DEAD16, dp.DEAD16           # the marker survives
    hi, lo = dp.unpack16(torch.from_numpy(dp.pack16(a, b)))
    assert np.array_equal(hi.numpy(), a) and np.array_equal(lo.numpy(), b)


def test_halo_expand_is_the_hosts_halo_copies():
    from pcr_tpu_torch.engine.torch_backend import halo_copies
    rng = np.random.default_rng(3)
    n, ncb = 500, 4
    rb0 = rng.integers(0, 3, n)
    cb0 = rng.integers(0, ncb, n)
    rb1 = rb0 + rng.integers(-1, 2, n)           # -1: no copy at all
    cb1 = np.minimum(cb0 + rng.integers(0, 2, n), ncb - 1)
    idx, eb = halo_copies(rb0, rb1, cb0, cb1, ncb)
    didx, deb = dp.halo_expand(*(torch.from_numpy(a)
                                 for a in (rb0, rb1, cb0, cb1)), ncb)
    assert np.array_equal(didx.numpy(), idx)
    assert np.array_equal(deb.numpy(), eb)


# -- bytes: the device route against the host route -----------------------------

GRIDS = {
    "one_tile": dict(tile=4096),
    "tiles64": dict(tile=64),
    "tiles256": dict(tile=256),
    "cell0.3": dict(tile=64, cell=0.3),     # a cell size no power of two
}


def gspec(rtype=RT.Average, **glyph):
    s = ref.gaussian_splat_spec("v", **glyph)
    s.type = rtype
    return s


def lspec(rtype=RT.Average, **glyph):
    s = ref.line_splat_spec("v", **glyph)
    s.type = rtype
    return s


SPECS = {
    "point_avg": ref.ReductionSpec(value_channel="v", type=RT.Average),
    "point_wavg": ref.ReductionSpec(value_channel="v", weight_channel="w",
                                    type=RT.WeightedAverage),
    "point_count": ref.ReductionSpec(value_channel="v", type=RT.Count),
    "gauss_s1_cut": gspec(default_sigma=1.0),
    "gauss_s4": gspec(default_sigma=4.0),
    "gauss_s16": gspec(default_sigma=16.0),
    "gauss_s4_count": gspec(RT.Count, default_sigma=4.0),
    "gauss_per_point_sigma": gspec(RT.WeightedAverage,
                                   sigma_x_channel="sig",
                                   sigma_y_channel="sig"),
    "gauss_rot8x3": gspec(default_sigma_x=8.0, default_sigma_y=3.0,
                          default_rotation=0.6),
    "gauss_rot4x1.5": gspec(RT.WeightedAverage, default_sigma_x=4.0,
                            default_sigma_y=1.5, default_rotation=0.6),
    "line_dir0": lspec(default_half_length=6.0),
    "line_dir0.7": lspec(RT.WeightedAverage, default_direction=0.7,
                         default_half_length=9.0),
    "line_per_point": lspec(direction_channel="dir",
                            half_length_channel="hl"),
    "line_count": lspec(RT.Count, default_direction=0.7,
                        default_half_length=5.0),
}
# what the device route must really have laid out, per chunk
KIND = {"point": "point", "gauss_rot8x3": "rot", "gauss_rot4x1.5": "rotp",
        "gauss": "gauss", "line": "rect"}


def grid_of(name, w=300.0, h=200.0):
    g = GRIDS[name]
    cell = g.get("cell", 1.0)
    return make_grid_config(w=w * cell, h=h * cell, cell=cell,
                            tile=g["tile"])


def cloud(gc, n=3000, seed=1, margin=5.0, pkg=ref, positive=False):
    """n points, some off the grid; channels for every spec above. The
    per-point sigmas keep their 3-sigma window inside the product cutoff
    (K2); the lines reach up to 12 cells. Values have both signs and span
    1e-2..1e2 (the bit comparisons' adversary), or with `positive` lie in
    (0, 10): a Gaussian cell sums hundreds of terms, and the 1e-5 bar
    against the oracle is relative to the sum of their magnitudes."""
    rng = np.random.default_rng(seed)
    b = gc.bounds
    c = ref.PointCloud.create(n)
    c.set_x_array(rng.uniform(b.min_x - margin, b.max_x + margin, n))
    c.set_y_array(rng.uniform(b.min_y - margin, b.max_y + margin, n))
    cell = abs(gc.cell_size_x)
    v = rng.normal(0, 1, n) * 10.0 ** rng.integers(-2, 3, n)
    for name, arr in (("v", rng.uniform(0, 10, n) if positive else v),
                      ("w", rng.uniform(0.1, 2.0, n)),
                      ("sig", rng.uniform(3.0, 5.0, n) * cell),
                      ("dir", rng.uniform(-3.0, 3.0, n)),
                      ("hl", rng.uniform(0.5, 12.0, n) * cell)):
        c.add_channel(name, ref.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return like(pkg, c)


def staged_chunks(gc, spec, c, keep, wire, monkeypatch, calls=None):
    """The port's staged chunks of cloud `c` (a port cloud) for one spec,
    through the pipeline's own routing, by the device route (`wire`) or
    the host route (PCR_WIRE_CHEAP=0). `calls` counts device layouts."""
    monkeypatch.setenv("PCR_WIRE_CHEAP", "1" if wire else "0")
    if calls is not None:
        real = dp.device_layout

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)
        monkeypatch.setattr(dp, "device_layout", spy)
    spec = like(port, spec)
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=[spec],
        exec_mode=port.ExecutionMode.GPU))
    x, y = c.x_array(), c.y_array()
    col, row, valid = routing.assign(p.config.grid, x, y)
    valid = valid & keep
    info = p._plans[0][1]
    n = c.count()
    values = p._values_for(spec, c, n)
    weights, ts = p._aux_channels(spec, info, c, n)
    out = p._prepare_device(0, spec, GlyphType(spec.glyph.type), c,
                            slice(0, n), x, y, col, row, valid, values,
                            weights, ts)
    if calls is not None:
        monkeypatch.setattr(dp, "device_layout", real)
    return out


def assert_same_chunks(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert ((u.kind, u.th, u.wt, u.cut, u.npoints)
                == (v.kind, v.th, v.wt, v.cut, v.npoints))
        assert u.params.dtype == v.params.dtype
        assert torch.equal(u.params.view(torch.int32),
                           v.params.view(torch.int32))      # nsub too
        assert torch.equal(u.bids, v.bids)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("name", list(SPECS))
def test_device_layout_bytes_equal_the_host_layout(name, grid, monkeypatch):
    gc = grid_of(grid)
    c = cloud(gc, pkg=port)
    keep = np.random.default_rng(7).uniform(size=c.count()) > 0.05
    calls = []
    dev = staged_chunks(gc, SPECS[name], c, keep, True, monkeypatch, calls)
    host = staged_chunks(gc, SPECS[name], c, keep, False, monkeypatch)
    assert len(calls) == len(dev) == 1          # laid out by device_prep
    want = next(v for k, v in KIND.items() if name.startswith(k))
    if (name, grid) == ("gauss_rot4x1.5", "cell0.3"):
        want = "rot"        # 13.3 x 5 cells there: r = 40, past ROTP_RMAX
    assert dev[0].kind == want
    assert_same_chunks(dev, host)


@pytest.mark.parametrize("name", ["point_wavg", "point_count", "gauss_s4",
                                  "gauss_rot8x3", "gauss_rot4x1.5",
                                  "line_dir0.7"])
def test_native_and_numpy_wires_give_the_same_layout(name, monkeypatch):
    """The raw routes (one native pass from world coordinates) and the
    routes through routing's per-point parameters (numpy) ship the same
    wire: with the native library switched off the chunks do not change."""
    gc = grid_of("cell0.3")
    c = cloud(gc, pkg=port)
    keep = np.ones(c.count(), bool)
    a = staged_chunks(gc, SPECS[name], c, keep, True, monkeypatch)
    monkeypatch.setattr(native, "available", lambda: False)
    calls = []
    b = staged_chunks(gc, SPECS[name], c, keep, True, monkeypatch, calls)
    assert calls
    assert_same_chunks(a, b)


def test_gauss_wire_exact_is_the_numpy_wire(monkeypatch):
    if not native.available():
        pytest.skip("no native library to compare with")
    gc = like(port, grid_of("cell0.3"))
    c = cloud(gc, n=1001, pkg=port)
    x, y = c.x_array(), c.y_array()
    _, _, valid = routing.assign(gc, x, y)
    values = c.channel_array_f32("v")
    gp = routing.gaussian_params(like(port, SPECS["gauss_s4"]).glyph, gc, x,
                                 y, None, None, None)
    a, b = 3, 1000                               # a slice of odd length
    m = b - a
    out = np.full(native.gauss_wire_words(m), -1, np.int32)
    assert native.gauss_wire_exact(gc, x, y, valid, values, a, b, out)
    assert np.array_equal(out[:m], dp.pack16(gp.icx[a:b], gp.icy[a:b]))
    assert np.array_equal(out[m:2 * m], gp.sub_cx[a:b].view(np.int32))
    assert np.array_equal(out[2 * m:3 * m], gp.sub_cy[a:b].view(np.int32))
    assert np.array_equal(out[3 * m:4 * m], values[a:b].view(np.int32))
    flags = out[4 * m:].view(np.uint8)
    assert np.array_equal(flags[:m], valid[a:b]) and not flags[m:].any()
    x = x.copy()
    x[500] = 1e9                                 # past the int16 pair
    assert not native.gauss_wire_exact(gc, x, y, valid, values, a, b, out)


@pytest.mark.parametrize("name", ["gauss_s4", "line_dir0.7", "point_avg"])
def test_coordinates_past_the_wire_take_the_host_layout(name, monkeypatch):
    """A point (or a valid line's endpoint) past the wire's int16 pairs:
    the chunk takes the host layout, a route and not a fallback."""
    gc = grid_of("tiles64")
    c = cloud(gc, pkg=port)
    x = c.x_array().copy()
    x[17] = 5e4 if name != "line_dir0.7" else x[17]
    c.set_x_array(x)
    keep = np.ones(c.count(), bool)
    if name == "line_dir0.7":
        monkeypatch.setattr("pcr_tpu_torch.engine.torch_backend."
                            "WIRE_COORD_MAX", 100)
    calls = []
    dev = staged_chunks(gc, SPECS[name], c, keep, True, monkeypatch, calls)
    host = staged_chunks(gc, SPECS[name], c, keep, False, monkeypatch)
    assert len(calls) == (1 if name == "point_avg" else 0)
    assert_same_chunks(dev, host)


def test_lines_clipped_away_leave_no_entry(monkeypatch):
    """Lines whose every run the home-tile clip empties, and a cloud with
    no valid line at all: both routes stage the same (padding) chunk."""
    gc = grid_of("tiles64", w=128.0, h=128.0)
    c = cloud(gc, n=400, margin=0.0, pkg=port)
    spec = lspec(default_direction=1.5707964, default_half_length=9.0)
    for keep in (np.ones(400, bool), np.zeros(400, bool)):
        dev = staged_chunks(gc, spec, c, keep, True, monkeypatch)
        host = staged_chunks(gc, spec, c, keep, False, monkeypatch)
        assert_same_chunks(dev, host)
    assert dev[0].params.shape[0] == 1 and (dev[0].params[0, 0] == 1).all()


def test_entry_budget_cuts_both_routes_alike(monkeypatch):
    """Past tiling.WIRE_ENTRY_BUDGET a cloud becomes several chunks, the
    same by both routes."""
    gc = grid_of("tiles64")
    c = cloud(gc, pkg=port)
    keep = np.ones(c.count(), bool)
    monkeypatch.setattr("pcr_tpu_torch.engine.torch_backend."
                        "WIRE_ENTRY_BUDGET", 4000)
    for name in ("gauss_s4", "gauss_per_point_sigma", "line_dir0.7"):
        dev = staged_chunks(gc, SPECS[name], c, keep, True, monkeypatch)
        host = staged_chunks(gc, SPECS[name], c, keep, False, monkeypatch)
        assert len(dev) > 2 and sum(ch.npoints for ch in dev) == c.count()
        assert_same_chunks(dev, host)


# -- against pcr_tpu's Hybrid mode and the oracle --------------------------------

def small_cloud(n=2500, seed=11, positive=False):
    return cloud(make_grid_config(w=200.0, h=150.0), n=n, seed=seed,
                 margin=3.0, positive=positive)


@pytest.mark.parametrize("name", ["gauss_s4", "gauss_per_point_sigma"])
def test_gaussian_hybrid_matches_pcr_tpu_hybrid_and_the_oracle(name):
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    specs, clouds = [SPECS[name]], [small_cloud(positive=True)]
    p, got = run(port, HYBRID, specs, clouds, gc=gc)
    _, jax_band = run(ref, HYBRID, specs, clouds, gc=gc)
    _, oracle = run(ref, CPU, specs, clouds, gc=gc)
    assert_close(got[0], oracle[0])
    a, b = np.nan_to_num(got[0]), np.nan_to_num(jax_band[0])
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("name", ["line_dir0.7", "line_per_point"])
def test_line_hybrid_matches_pcr_tpu_hybrid_and_the_oracle(name):
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    specs, clouds = [SPECS[name]], [small_cloud(seed=12)]
    _, got = run(port, HYBRID, specs, clouds, gc=gc)
    _, jax_band = run(ref, HYBRID, specs, clouds, gc=gc)
    _, oracle = run(ref, CPU, specs, clouds, gc=gc)
    assert_close(got[0], oracle[0])
    assert_close(got[0], jax_band[0])


def test_line_count_hybrid_matches_the_oracle_and_pcr_tpus_walk(monkeypatch):
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    specs, clouds = [SPECS["line_count"]], [small_cloud(seed=13)]
    _, got = run(port, HYBRID, specs, clouds, gc=gc)
    _, oracle = run(ref, CPU, specs, clouds, gc=gc)
    monkeypatch.setenv("PCR_PALLAS", "0")        # pcr_tpu's scatter walk
    _, walk = run(ref, HYBRID, specs, clouds, gc=gc)
    assert_close(got[0], oracle[0])
    assert_close(got[0], walk[0])


# -- the slice as a whole ----------------------------------------------------------

ALL = [SPECS[k] for k in ("point_wavg", "gauss_s4", "gauss_rot8x3",
                          "gauss_rot4x1.5", "line_dir0.7",
                          "line_per_point")] + [
    ref.ReductionSpec(value_channel="v", type=RT.Max)]


def bits(bands):
    return [b.view(np.int32) for b in bands]


def same_bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(bits(a), bits(b)))


@pytest.mark.parametrize("name", ["point_wavg", "gauss_s4", "gauss_rot8x3",
                                  "gauss_rot4x1.5", "line_dir0.7",
                                  "multi_spec"])
def test_hybrid_is_gpu_bit_for_bit(name):
    specs = ALL if name == "multi_spec" else [SPECS[name]]
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    clouds = [small_cloud(seed=14), small_cloud(seed=15)]
    _, want = run(port, GPU, specs, clouds, gc=gc, chunk_size=600)
    p, got = run(port, HYBRID, specs, clouds, gc=gc, chunk_size=600,
                 hybrid_cpu_threads=2)
    assert same_bits(got, want)
    _, staged = run(port, HYBRID, specs, clouds, staged=True, gc=gc,
                    chunk_size=600)
    assert same_bits(staged, want)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_worker_count_never_shows_in_the_bits(workers, monkeypatch):
    """1, 2 and 4 workers, the device and the host layout, and a rerun:
    one band, bit for bit, at a given chunk_size."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    clouds = [small_cloud(seed=16)]
    _, want = run(port, GPU, ALL, clouds, gc=gc, chunk_size=500)
    for wire in ("1", "0", "1"):
        monkeypatch.setenv("PCR_WIRE_CHEAP", wire)
        _, got = run(port, HYBRID, ALL, clouds, gc=gc, chunk_size=500,
                     hybrid_cpu_threads=workers)
        assert same_bits(got, want)


def test_default_takes_a_cloud_whole_but_for_hybrid_workers(monkeypatch):
    """Without a chunk_size a cloud is one chunk in GPU mode, in `stage`
    and in Hybrid mode with one worker; more workers cut it into
    INGEST_CHUNK_POINTS and give GPU mode's bits at that chunk_size."""
    monkeypatch.setattr("pcr_tpu_torch.engine.pipeline."
                        "INGEST_CHUNK_POINTS", 700)
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    clouds = [small_cloud(seed=17, positive=True)]
    specs = [SPECS["gauss_s4"], SPECS["line_dir0.7"]]
    p, whole = run(port, GPU, specs, clouds, gc=gc)
    staged = p.stage(like(port, clouds[0]))
    assert [len(s) for s in staged.per_spec] == [1, 1]
    _, got = run(port, HYBRID, specs, clouds, gc=gc)
    assert same_bits(got, whole)
    p, cut = run(port, GPU, specs, clouds, gc=gc, chunk_size=700)
    staged = p.stage(like(port, clouds[0]))
    assert [len(s) for s in staged.per_spec] == [4, 4]      # 2500 / 700
    _, got = run(port, HYBRID, specs, clouds, gc=gc, hybrid_cpu_threads=3)
    assert same_bits(got, cut)
    _, oracle = run(ref, CPU, specs, clouds, gc=gc)
    for bands in (whole, cut):
        for g, o in zip(bands, oracle):
            assert_close(g, o)


def test_staging_from_many_threads_shares_nothing():
    """The prepare_* methods write nothing on the engine (pcr_tpu's staging
    parameters raced across its Hybrid workers until a89206e): twelve
    threads on four cores, each staging its own cloud for every spec with
    the interpreter switching often, get the chunks a lone thread gets."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    specs = like(port, ALL)
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc), reductions=specs,
        exec_mode=port.ExecutionMode.Hybrid))
    clouds = [like(port, small_cloud(n=700, seed=20 + k)) for k in range(12)]

    def stage(c):
        return [[(ch.kind, ch.params.clone(), None if ch.bids is None
                  else ch.bids.clone()) for ch in per]
                for per in p.stage(c).per_spec]

    want = [stage(c) for c in clouds]
    got, errors = [None] * len(clouds), []

    def work(k):
        try:
            for _ in range(3):
                got[k] = stage(clouds[k])
        except Exception as e:                   # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(clouds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            assert len(gs) == len(ws)
            for (gk, gp, gb), (wk, wp, wb) in zip(gs, ws):
                assert gk == wk and torch.equal(gp.view(torch.int32),
                                                wp.view(torch.int32))
                assert (gb is None and wb is None) or torch.equal(gb, wb)


def test_chunked_per_point_channels_follow_their_points():
    """chunk_size slices the glyph channels with the points they belong
    to."""
    gc = make_grid_config(w=200.0, h=150.0, tile=64)
    specs = [SPECS["gauss_per_point_sigma"], SPECS["line_per_point"]]
    clouds = [small_cloud(seed=18, positive=True)]
    _, got = run(port, GPU, specs, clouds, gc=gc, chunk_size=800)
    _, oracle = run(ref, CPU, specs, clouds, gc=gc)
    for g, o in zip(got, oracle):
        assert_close(g, o)
