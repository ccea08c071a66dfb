"""
Streaming ingest with checkpoint and resume through PCRT tile-state files,
on the port: session 1 ingests a cloud and finalizes (writing its state to
`state_dir`), session 2 resumes from that state and adds a second cloud.

    python -m pcr_tpu_torch.examples.streaming_resume [--mode cpu] [--state-dir DIR]

The counterpart of examples/streaming_resume.py, at its sizes. `main`
returns the two sessions' bands. The state directory is emptied first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

import pcr_tpu_torch as pcr
from pcr_tpu_torch.examples import MODES, make_cloud, square_grid


def inputs(seed: int, n: int, extent: float):
    """(x, y, v): n uniform points over [0, extent]^2, each of value 1."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, extent, n), rng.uniform(0, extent, n),
            np.ones(n, np.float32))


def main(n: int = 100_000, size: int = 200, mode=pcr.ExecutionMode.Auto,
         state_dir: str | None = None):
    state_dir = state_dir or os.path.join(tempfile.gettempdir(),
                                          "pcr_resume_state")
    shutil.rmtree(state_dir, ignore_errors=True)

    def session(seed):
        spec = pcr.ReductionSpec()
        spec.value_channel = "v"
        spec.type = pcr.ReductionType.Sum
        cfg = pcr.PipelineConfig()
        cfg.grid = square_grid(size)
        cfg.reductions = [spec]
        cfg.exec_mode = mode
        cfg.state_dir = state_dir
        pipe = pcr.Pipeline.create(cfg)
        x, y, v = inputs(seed, n, size)
        pipe.ingest(make_cloud(x, y, v=v))
        pipe.finalize()
        return pipe.result().band_array(0)

    first = session(1)      # ingest, flush the state, "crash"
    print("session 1 total:", np.nansum(first))
    second = session(2)     # resume from the PCRT checkpoint, keep adding
    print("session 2 total:", np.nansum(second), "(both clouds)")
    return first, second


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--mode", choices=list(MODES), default="auto")
    ap.add_argument("--state-dir", default=None)
    args = ap.parse_args()
    main(mode=MODES[args.mode], state_dir=args.state_dir)
