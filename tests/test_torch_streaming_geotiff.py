"""tests/test_streaming_geotiff.py on the port, and the byte twin of its
writer: the port's StreamingGeoTiffWriter must write exactly the bytes of
the port's write_geotiff and of pcr_tpu's StreamingGeoTiffWriter, for LZW,
DEFLATE and no compression, given the same bands (seeded numpy, 20% NaN)
delivered in ragged row chunks. Any change to the port's encoder is held
to these bytes.
"""

import numpy as np
import pytest

import pcr_tpu as ref
import pcr_tpu_torch as port
from conftest import make_grid_config
from pcr_tpu.io import geotiff as ref_tif
from pcr_tpu_torch.io import geotiff as port_tif
from test_streaming_geotiff import random_bands
from test_torch_parity import devices  # noqa: F401
from test_torch_pipeline import like


def write_both(tmp_path, gc, bands, options, pkg=port, tif=port_tif):
    """(write_geotiff's file, StreamingGeoTiffWriter's file) of `pkg`."""
    gc = like(pkg, gc)
    options = like(pkg, options)
    names = [f"band{i}" for i in range(len(bands))]
    whole = str(tmp_path / f"{pkg.__name__}_whole.tif")
    grid = pkg.Grid.create(gc.width, gc.height,
                           [pkg.BandDesc(name=n, dtype=pkg.DataType.Float32)
                            for n in names])
    for i, b in enumerate(bands):
        grid.set_band_array(i, b)
    assert tif.write_geotiff(whole, grid, gc, options).ok()
    streamed = str(tmp_path / f"{pkg.__name__}_streamed.tif")
    w = tif.StreamingGeoTiffWriter(streamed, gc, names, options)
    for b in bands:
        # ragged row chunks exercise the buffer
        r = 0
        for k in (100, 1, 37, 200, 10**9):
            rows = b[r:r + k]
            if rows.shape[0] == 0:
                break
            w.write_rows(rows)
            r += rows.shape[0]
        w.end_band()
    assert w.close(overview_bands=bands if options.cloud_optimized
                   else None).ok()
    return whole, streamed


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("compress", ["LZW", "DEFLATE", "NONE"])
def test_byte_identity_with_write_geotiff(tmp_path, compress):
    gc = make_grid_config(w=300.0, h=217.0)   # non-tile-aligned height
    bands = random_bands(gc, 2, seed=1)
    whole, streamed = write_both(tmp_path, gc, bands,
                                 ref_tif.GeoTiffOptions(compress=compress))
    assert read(whole) == read(streamed)


@pytest.mark.parametrize("compress", ["LZW", "DEFLATE", "NONE"])
def test_byte_identity_with_pcr_tpu(tmp_path, compress):
    """The port's streamed bytes are pcr_tpu's streamed bytes and the
    port's write_geotiff bytes."""
    gc = make_grid_config(w=520.0, h=301.0, tile=256)
    bands = random_bands(gc, 3, seed=5)
    opts = ref_tif.GeoTiffOptions(compress=compress)
    whole, streamed = write_both(tmp_path, gc, bands, opts)
    _, ref_streamed = write_both(tmp_path, gc, bands, opts, ref, ref_tif)
    assert read(streamed) == read(ref_streamed) == read(whole)


def test_roundtrip_values(tmp_path):
    gc = make_grid_config(w=520.0, h=390.0, tile=256)
    bands = random_bands(gc, 3, seed=2)
    _, streamed = write_both(tmp_path, gc, bands, ref_tif.GeoTiffOptions())
    width, height, nbands, _, _ = port_tif.read_geotiff_info(streamed)
    assert (width, height, nbands) == (gc.width, gc.height, len(bands))
    for i, b in enumerate(bands):
        got = port_tif.read_geotiff_band(streamed, i)
        assert np.array_equal(got, b, equal_nan=True)
        assert np.array_equal(ref_tif.read_geotiff_band(streamed, i), b,
                              equal_nan=True)


def test_cog_overviews_match(tmp_path):
    gc = make_grid_config(w=600.0, h=600.0)
    bands = random_bands(gc, 1, seed=3, nan_frac=0.0)
    opts = ref_tif.GeoTiffOptions(cloud_optimized=True)
    whole, streamed = write_both(tmp_path, gc, bands, opts)
    _, ref_streamed = write_both(tmp_path, gc, bands, opts, ref, ref_tif)
    assert read(whole) == read(streamed) == read(ref_streamed)


def test_row_count_mismatch_rejected(tmp_path):
    gc = like(port, make_grid_config(w=64.0, h=64.0))
    w = port_tif.StreamingGeoTiffWriter(str(tmp_path / "x.tif"), gc, ["b"],
                                        port_tif.GeoTiffOptions())
    w.write_rows(np.zeros((10, 64), np.float32))
    with pytest.raises(port.PcrError):
        w.end_band()


def test_repeated_pipeline_finalize_valid(tmp_path, monkeypatch):
    """The streamed finalize (forced by PCR_PACK_MAX_BYTES=1) rewrites its
    output on every finalize; each write must decode to the band."""
    monkeypatch.setenv("PCR_PACK_MAX_BYTES", "1")
    gc = make_grid_config(w=300.0, h=300.0, tile=128)
    rng = np.random.default_rng(4)
    n = 30000
    c = port.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, 300, n))
    c.set_y_array(rng.uniform(0, 300, n))
    c.add_channel("v", port.DataType.Float32)
    c.set_channel_array_f32("v", rng.uniform(0, 1, n).astype(np.float32))
    out = str(tmp_path / "rep.tif")
    p = port.Pipeline.create(port.PipelineConfig(
        grid=like(port, gc),
        reductions=[port.ReductionSpec(value_channel="v",
                                       type=port.ReductionType.Average)],
        exec_mode=port.ExecutionMode.GPU, output_path=out))
    staged = p.stage(c)
    for _ in range(3):
        p.ingest(staged)
        p.finalize()
        assert np.array_equal(port_tif.read_geotiff_band(out, 0),
                              p.result().band_array(0), equal_nan=True)
