"""
Host <-> card transfer diagnostic: H2D and D2H rates across buffer sizes,
through pageable numpy buffers and through the engine's pinned buffers
and copy stream, so ingest and finalize walls can be put down to the copy.

    python -m pcr_tpu_torch.scripts.diagnostics.transfer_sizes

The counterpart of scripts/diagnostics/transfer_sizes.py, at 1, 4, 16, 64
and 256 MB (MB = 2^20 bytes here, as in the JAX script). Pageable: a
numpy buffer through `torch.from_numpy(...).to(card)` and back into a
numpy buffer. Pinned: `torch_backend._Arena`'s buffers and its copy
stream, the path of every upload of host-sourced ingest. Each rate is the
best of 5 CUDA-event timings after a warm-up. Exit codes: 0, or 2 without
a card (there is nothing to copy to).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pcr_tpu_torch.scripts.diagnostics import NO_CARD, NO_CARD_EXIT

SIZES_MB = (1, 4, 16, 64, 256)
REPS = 5


def _timed_ms(stream, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end)


def measure(mb: int, reps: int = REPS,
            device: torch.device | None = None) -> dict:
    """MB/s of one copy of `mb` MB each way, pageable and pinned, best of
    `reps` after one warm-up."""
    from pcr_tpu_torch.engine.torch_backend import _Arena
    dev = device or torch.device("cuda", 0)
    arena = _Arena(dev)
    n = (mb << 20) // 4
    host = np.ones(n, np.int32)
    back = np.empty(n, np.int32)
    x = torch.empty(n, dtype=torch.int32, device=dev)
    cur = torch.cuda.current_stream(dev)

    def h2d_pageable():
        torch.from_numpy(host).to(dev)

    def d2h_pageable():
        torch.from_numpy(back).copy_(x)

    def h2d_pinned():
        hb = arena.checkout(n)
        hb.array[:n] = host
        return _timed_ms(arena.stream, lambda: arena.put(hb, n))

    def d2h_pinned():
        hb = arena.checkout(n)
        arena.stream.wait_stream(cur)
        with torch.cuda.stream(arena.stream):
            ms = _timed_ms(arena.stream, lambda: hb.tensor[:n].copy_(
                x, non_blocking=True))
        arena.give_back(hb)
        return ms

    best = {}
    for name, run in (("h2d_pageable", lambda: _timed_ms(cur, h2d_pageable)),
                      ("d2h_pageable", lambda: _timed_ms(cur, d2h_pageable)),
                      ("h2d_pinned", h2d_pinned),
                      ("d2h_pinned", d2h_pinned)):
        run()                                   # warm-up
        best[name] = min(run() for _ in range(reps))
    torch.cuda.synchronize(dev)
    return {k: mb / (ms / 1e3) for k, ms in best.items()}


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print(NO_CARD + "; nothing to measure")
        return NO_CARD_EXIT
    print(f"device: {torch.cuda.get_device_name(0)} (cuda:0), best of "
          f"{REPS} by CUDA events")
    for mb in SIZES_MB:
        r = measure(mb)
        print(f"{mb:3d} MB  H2D pageable {r['h2d_pageable']:8.1f} MB/s  "
              f"pinned {r['h2d_pinned']:8.1f} MB/s   D2H pageable "
              f"{r['d2h_pageable']:8.1f} MB/s  pinned "
              f"{r['d2h_pinned']:8.1f} MB/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
