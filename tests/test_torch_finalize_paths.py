"""tests/test_finalize_paths.py on the port: the port's one device
finalize (one copy of the band, or of the raw state planes and a host
finalize when state_dir is set) gives the band, the GeoTIFF and the PCRT
checkpoint of the oracle, and resumes. pcr_tpu still chooses between one
packed copy and row strips by a size its environment sets, so the twins
run the port's path against both of the reference's (ids `ref_packed` /
`ref_strips`).

The device path runs on torch-CPU (PCR_TORCH_DEVICE=cpu). Each band is
held against pcr_tpu's numpy oracle (exactly where the host finalizes the
state, else at 1e-5) and against pcr_tpu's device path in the same way.
The last case flushes the Gaussian weight sums under GAUSS_WMIN to the
empty cell's NaN, in the band and in the checkpoint.
"""

import os

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_cloud, make_grid_config
from test_torch_parity import bands, devices, make  # noqa: F401
from test_torch_pipeline import assert_bands, assert_close, like

RT = ref.ReductionType
GPU, CPU = ref.ExecutionMode.GPU, ref.ExecutionMode.CPU


def run(pkg, mode, gc, specs, clouds, **cfg):
    p = make(pkg, mode, specs, gc, **cfg)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return p


@pytest.mark.parametrize("packed", [True, False],
                         ids=["ref_packed", "ref_strips"])
@pytest.mark.parametrize("with_state", [True, False],
                         ids=["state", "nostate"])
def test_finalize_path_matches_oracle(tmp_path, monkeypatch, packed,
                                      with_state):
    """The port's finalize against pcr_tpu's packed or strip finalize."""
    if not packed:
        monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")     # pcr_tpu's strips
    gc = make_grid_config(w=150.0, h=120.0, tile=64)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average,
                               output_band_name="out")]
    # points clustered left: some tiles stay untouched (NaN semantics)
    clouds = [make_cloud(5000, seed=s, w=90.0, h=120.0) for s in (0, 1)]
    oracle = bands(ref, CPU, specs, clouds, gc)
    out = {}
    for pkg in (port, ref):
        d = tmp_path / pkg.__name__
        d.mkdir()
        sd = str(d / "st") if with_state else ""
        tif = str(d / "a.tif")
        p = run(pkg, GPU, gc, specs, like(pkg, clouds), state_dir=sd,
                output_path=tif)
        band = p.result().band_array(0)
        if with_state:      # the host finalize of the state is the oracle's
            assert np.array_equal(band, oracle[0], equal_nan=True)
        else:
            assert_close(band, oracle[0])
        assert np.array_equal(pkg.read_geotiff_band(tif, 0), band,
                              equal_nan=True)
        if with_state:
            # resume from the PCRT checkpoint alone reproduces the band
            p2 = run(pkg, GPU, gc, specs, [], state_dir=sd,
                     output_path=str(d / "b.tif"), resume=True)
            assert np.array_equal(p2.result().band_array(0), band,
                                  equal_nan=True)
        out[pkg] = band
    assert_bands([out[port]], [out[ref]], specs)


def test_streamed_state_multi_reduction(tmp_path, monkeypatch):
    """Two reductions of different state widths with a state_dir, the
    port's finalize beside pcr_tpu's strip + state path (whose strip
    heights differ per spec): the checkpoints land per spec, and the bands
    are the oracle's bit for bit (the host finalizes the same state)."""
    monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")       # pcr_tpu's strips
    gc = make_grid_config(w=100.0, h=100.0)
    specs = [ref.ReductionSpec(value_channel="v", type=RT.Average,
                               output_band_name="avg"),
             ref.ReductionSpec(value_channel="v", type=RT.Max,
                               output_band_name="mx")]
    clouds = [make_cloud(4000, seed=3, w=100.0, h=100.0)]
    oracle = bands(ref, CPU, specs, clouds, gc)
    for pkg in (port, ref):
        sd = tmp_path / pkg.__name__ / "st"
        sd.parent.mkdir()
        p = run(pkg, GPU, gc, specs, like(pkg, clouds), state_dir=str(sd),
                output_path=str(sd.parent / "o.tif"))
        for b in range(2):
            assert np.array_equal(p.result().band_array(b), oracle[b],
                                  equal_nan=True), (pkg.__name__, b)
        assert len({r for r, _, fs in os.walk(sd)
                    if any(f.endswith(".pcrt") for f in fs)}) == 2


@pytest.mark.parametrize("path", ["packed", "strips"],
                         ids=["ref_packed", "ref_strips"])
def test_gauss_corr_residue_flush(path, monkeypatch):
    """Gaussian weight sums under GAUSS_WMIN are residues and finalize to
    the empty cell's NaN; a sum at the cutoff is data and stays. The band
    and fetch_state (PCRT checkpoints) flush alike, and the band is
    pcr_tpu's by either of its finalizes."""
    if path == "strips":
        monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")   # pcr_tpu's strips
    gc = make_grid_config(w=16.0, h=16.0)
    spec = ref.gaussian_splat_spec("v", default_sigma=1.0)
    p = make(port, GPU, [spec], gc)
    f0 = np.zeros((16, 16), np.float32)
    f1 = np.zeros((16, 16), np.float32)
    f1[2, 3] = 1e-12          # a positive residue: 0.0 without the flush
    f0[2, 3] = -3e-13
    f1[5, 5] = 1e-6           # exactly the cutoff: data, kept
    f0[5, 5] = 2e-6
    f1[8, 8] = 0.5
    f0[8, 8] = 1.0
    p._engine.load_state(0, [f0, f1])
    p._touched_tiles.add((0, 0))
    p.finalize()
    band = p.result().band_array(0)
    assert np.isnan(band[2, 3])
    assert band[5, 5] == np.float32(2e-6) / np.float32(1e-6)
    assert band[8, 8] == np.float32(1.0) / np.float32(0.5)
    st = [np.asarray(f) for f in p._engine.fetch_state(0)]
    assert st[1][2, 3] == 0.0 and st[0][2, 3] == 0.0
    assert st[1][8, 8] == np.float32(0.5)
    j = make(ref, GPU, [spec], gc)
    j._engine.load_state(0, [f0, f1])
    j._touched_tiles.add((0, 0))
    j.finalize()
    assert np.array_equal(band, j.result().band_array(0), equal_nan=True)


@pytest.mark.parametrize("touched", ["all", "some"])
@pytest.mark.parametrize("geotiff", [False, True], ids=["band", "geotiff"])
def test_the_band_is_the_engines_finalize(tmp_path, monkeypatch, geotiff,
                                          touched):
    """Without a state_dir each result band is the very array the engine's
    finalize returned (on a card: the pinned block the copy landed in),
    NaN written over the untouched tiles in place: no second band, with
    or without an output file, which decodes to the bands. Values and NaN
    footprint are the oracle's (a Sum's empty cells are 0.0 in a touched
    tile, NaN in an untouched one)."""
    tif = str(tmp_path / "out.tif") if geotiff else ""
    gc = make_grid_config(w=150.0, h=120.0, tile=64)      # 3 x 2 tiles
    specs = [ref.ReductionSpec(value_channel="v", type=t,
                               output_band_name=f"b{int(t)}")
             for t in (RT.Sum, RT.Average)]
    w = 150.0 if touched == "all" else 90.0   # 90: the right column idle
    clouds = [make_cloud(5000, seed=s, w=w, h=120.0) for s in (0, 1)]
    p = make(port, GPU, specs, gc, output_path=tif)
    real, returned = p._engine.finalize_to_host, []

    def spy(*a, **kw):
        returned.append(real(*a, **kw))
        return returned[-1]
    monkeypatch.setattr(p._engine, "finalize_to_host", spy)
    for c in like(port, clouds):
        p.ingest(c)
    p.finalize()
    assert len(p._touched_tiles) == (6 if touched == "all" else 4)
    assert len(returned) == 2
    oracle = bands(ref, CPU, specs, clouds, gc)
    for i in range(2):
        band = p.result().band_array(i)
        assert np.shares_memory(band, returned[i])
        assert_close(band, oracle[i])
        if geotiff:
            assert np.array_equal(port.read_geotiff_band(tif, i), band,
                                  equal_nan=True)
    assert np.isnan(p.result().band_array(0)[:, 128:]).all() == (
        touched == "some")
