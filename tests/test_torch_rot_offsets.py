"""K4's and K5's distance to a rotated Gaussian's centre, far from the
origin (the PyTorch port, on torch-CPU, where both take their plain
versions).

The kernels form a cell's distance to the centre as the numpy oracle does
(engine/cpu_backend.py: rdx = float32(dx) - sub_cx): the integer
difference w - icx, exact in float32, then one rounding with the sub-cell
offset. The TPU's layout carried -(icx + sub_cx) instead, rounded at the
cell's absolute coordinate, which drifts from the oracle as rows and
columns grow (ROADMAP Queue 3). Held here:

  * the distances bit for bit against the oracle's rdx / rdy for centres
    at cells ~0, 1e3, 8e3 and 1.6e4, on both layout routes (the host's
    and device_prep's), where the old form differs from 1e3 on;
  * K4 (rotated 8 x 3, r = 24) and K5 (4 x 1.5, r = 12) pipelines on a
    tall and a wide grid (64 x 16384 and 16384 x 64 cells), centres near
    the far end and near the origin, values of both signs, Sum: within
    1e-5 of the oracle relative to each cell's sum of |terms| (PERF.md
    section 2), with the oracle's exact NaN footprint. As max |got -
    want| / sum |terms|, far / near, the repaired kernels read 2.8e-6 /
    2.8e-6 (K4 tall), 1.3e-6 / 1.3e-6 (K4 wide), 1.9e-6 / 1.9e-6 (K5
    tall) and 2.5e-6 / 2.5e-6 (K5 wide); the tree before the repair read
    3.1e-4 / 8.1e-6, 3.2e-4 / 3.7e-6, 8.6e-4 / 3.1e-5 and 5.9e-4 /
    2.4e-5, and failed both tests.
"""

import numpy as np
import pytest
import torch

import pcr_tpu_torch as port
from pcr_tpu_torch.engine import gauss_kernels as gk
from pcr_tpu_torch.engine import routing
from pcr_tpu_torch.engine.torch_backend import TorchEngine
from pcr_tpu_torch.testing.generators import make_grid_config
from test_torch_pipeline import like  # noqa: F401  (spends the first exp)

RT = port.ReductionType
TOL = 1e-5
LONG = 16384
GLYPHS = {"rot": dict(default_sigma_x=8.0, default_sigma_y=3.0,
                      default_rotation=0.6),            # K4, r = 24
          "rotp": dict(default_sigma_x=4.0, default_sigma_y=1.5,
                       default_rotation=0.6)}           # K5, r = 12


@pytest.fixture(autouse=True)
def devices(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def spec(kind, rtype=RT.Sum):
    s = port.gaussian_splat_spec("v", **GLYPHS[kind])
    s.type = rtype
    return s


def grid(tall):
    """64 x 16384 cells (tall) or 16384 x 64 (wide), 1 m, 4096-cell
    tiles: about 1M cells, whose far rows or columns reach 1.6e4."""
    return make_grid_config(64, LONG) if tall else make_grid_config(LONG, 64)


def world(gc, along, across):
    """World (x, y) of fractional cells `along` the long axis and
    `across` the short one (rows count down from the top edge)."""
    if gc.height > gc.width:
        return across, gc.bounds.max_y - along
    return along, gc.bounds.max_y - across


def test_distances_are_the_oracles_bit_for_bit():
    """At centres ~0, 1e3, 8e3 and 1.6e4 cells along each axis, every
    live K4 / K5 entry of both layout routes gives, over its window, the
    oracle's rdx = float32(dx) - sub_cx and rdy = float32(dy) - sub_cy;
    from 1e3 on the TPU's form (w + float32(-(icx + sub_cx))) does not."""
    rng = np.random.default_rng(5)
    for tall in (True, False):
        gc = grid(tall)
        centres = np.concatenate([c + 3.0 * np.arange(8) + rng.uniform(
            0.05, 0.95, 8) for c in (30.0, 1000.0, 8000.0, 16300.0)])
        x, y = world(gc, centres, rng.uniform(20.0, 44.0, len(centres)))
        for kind in GLYPHS:
            s = spec(kind)
            gp = routing.gaussian_params(s.glyph, gc, x, y, None, None,
                                         None)
            eng = TorchEngine(gc, [(s, port.get_reduction_info(s.type))],
                              torch.device("cpu"))
            owner = {(int(a), int(b)): i
                     for i, (a, b) in enumerate(zip(gp.icx, gp.icy))}
            assert len(owner) == len(centres)
            for wire_cheap in (False, True):
                chunks = eng.prepare_gaussian(
                    0, gp, np.ones(len(x), bool),
                    rng.uniform(-2, 2, len(x)).astype(np.float32),
                    wire_cheap=wire_cheap)
                assert {c.kind for c in chunks} == {kind}
                for ch in chunks:
                    check_chunk(ch, gp, owner, tall)


def check_chunk(ch, gp, owner, tall):
    p = ch.params.permute(0, 2, 1).reshape(-1, ch.params.shape[1])
    if ch.kind == "rot":
        live = p[:, 8] >= 0
        f = torch.cat([p[:, :6], torch.zeros(len(p), 4), p[:, 6:8]], 1)
    else:
        live = p[:, 6] <= p[:, 7]
        f = p
    f = f[live]
    idx = torch.tensor([owner[(int(a), int(b))]
                        for a, b in zip(f[:, 10], f[:, 11])])
    assert len(idx)
    r = int(gp.r.max())
    d = torch.arange(-r, r + 1)
    icx, icy = f[:, 10].long(), f[:, 11].long()
    dx, dy = gk.rot_distances(f, icy[:, None] + d, icx[:, None] + d)
    want_x = np.float32(d.numpy())[None] - gp.sub_cx[idx.numpy(), None]
    want_y = np.float32(d.numpy())[None] - gp.sub_cy[idx.numpy(), None]
    assert np.array_equal(dx.numpy().view(np.int32), want_x.view(np.int32))
    assert np.array_equal(dy.numpy().view(np.int32), want_y.view(np.int32))
    # the TPU's plane along the long axis, for contrast
    ic, sub, want, far = ((icy, f[:, 1], want_y, f[:, 11]) if tall
                          else (icx, f[:, 0], want_x, f[:, 10]))
    old = (ic[:, None] + d).float() + (-(ic.float() + sub))[:, None]
    for lo in (1000, 8000, 16000):
        m = ((far >= lo) & (far < lo + 400)).numpy()
        assert not np.array_equal(old.numpy()[m], want[m])


def far_near_cloud(gc, n, seed):
    """n centres in the last 384 cells of the long axis, then the same
    centres shifted into cells [0, 384), values of both signs."""
    rng = np.random.default_rng(seed)
    along = rng.uniform(LONG - 384, LONG, n)
    across = rng.uniform(0, 64, n)
    x, y = world(gc, np.concatenate([along, along - (LONG - 384)]),
                 np.concatenate([across, across]))
    v = rng.uniform(-2, 2, n)
    c = port.PointCloud.create(2 * n)
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("v", port.DataType.Float32)
    c.set_channel_array_f32("v", np.concatenate([v, v]).astype(np.float32))
    return c


def band(gc, s, c, mode):
    p = port.Pipeline.create(port.PipelineConfig(
        grid=gc, reductions=[s], exec_mode=mode, gpu_require_strict=True))
    p.ingest(c)
    p.finalize()
    return p.result().band_array(0).copy()


def relative_errors(got, want, abs_terms, tall):
    """max |got - want| / sum |terms| over the far and the near block;
    a cell without terms must match exactly."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want) & (abs_terms > 0)
    assert np.array_equal(got[~m & ~np.isnan(want)],
                          want[~m & ~np.isnan(want)])
    err = np.zeros(got.shape)
    err[m] = np.abs(got[m] - want[m]) / abs_terms[m]
    if not tall:
        err = err.T
    return float(err[-384:].max()), float(err[:384].max())


@pytest.mark.parametrize("tall", [True, False], ids=["rows", "cols"])
@pytest.mark.parametrize("kind", ["rot", "rotp"])
def test_far_pipelines_hold_the_oracle(kind, tall):
    gc = grid(tall)
    c = far_near_cloud(gc, 300 if kind == "rot" else 1000, seed=11)
    s = spec(kind)
    got = band(gc, s, c, port.ExecutionMode.GPU)
    want = band(gc, s, c, port.ExecutionMode.CPU)
    c.set_channel_array_f32("v", np.abs(c.channel_array_f32("v")))
    abs_terms = band(gc, s, c, port.ExecutionMode.CPU)
    far, near = relative_errors(got, want, abs_terms, tall)
    assert far <= TOL and near <= TOL, (far, near)
