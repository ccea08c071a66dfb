"""
Kernel K6 — the rot-expand micro-probe: its wrapper, its plain PyTorch
version, its launch counter and its command line.

K6 replaces `benchmarks/profile_rot_expand.py::build` (the TPU probe of
lane expansion for K5's packed variant). It computes the same `out`:

    out[0, l] = nsub * sum_q sum_g p[q, 4g + l // 32],  l < 128

for p (nq, block) float32. On Hopper the probe asks what it costs to hand
per-entry scalars to the threads that own a tile's cells; its variants
(`smem`: staged in shared memory, K5's pattern; `loop`: read straight from
device memory) and the fixed order of its sums are described in
`csrc/rot_expand_probe.cu`. It is one launch: a lane's adds of one step are
spread over `split_of(nsub, block)` CTAs of 8 groups of 128 lanes, and the
CTA that finishes last adds the partial rows. The TPU variants (`repeat`,
`jrepeat`, `bcast4`, the `wire4_*` forms) are lane layouts of the TPU's
vector unit and are not carried over.

    python -m pcr_tpu_torch.probes.rot_expand [--nsub 64] [--block 2048]
        [--nq 9] [--variants smem loop]

needs a CUDA card and exits nonzero without one. Each variant is checked
against numpy at the TPU probe's bar (np.allclose, rtol=1e-4) with
atol = 1e-4 * nsub * sqrt(nq * block / 4), the scale of |out| for N(0, 1)
entries, and timed with CUDA events beside the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ..engine import _build

__all__ = ["VARIANTS", "atol", "longest_chain", "rot_expand",
           "rot_expand_plain", "run", "split_of"]

VARIANTS = ("smem", "loop")
_MAX_SMEM = 227 * 1024          # a CTA's shared memory on Hopper
_REPS = 20                      # launches per timing, as the TPU probe
_GROUPS = 8                     # groups of 128 lanes a CTA (the kernel's)
_CHAINS = 4                     # independent sums a thread (the kernel's)
_SMS = 132                      # an H100's multiprocessors

_BOUND = None
_DONE = {}                      # (device index, stream) -> the CTAs' counter


def _lib():
    global _BOUND
    if _BOUND is None:
        lib = _build.load()
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pcr_rot_expand_probe.argtypes = [vp] + [i32] * 5 + [vp] * 4
        lib.pcr_rot_expand_probe.restype = i32
        lib.pcr_rot_expand_groups.argtypes = []
        lib.pcr_rot_expand_groups.restype = i32
        if lib.pcr_rot_expand_groups() != _GROUPS:
            raise RuntimeError("rot_expand: the kernel's groups differ from "
                               "_GROUPS")
        _BOUND = lib
    return _BOUND


def _check(p: torch.Tensor, nsub: int, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"rot_expand: variant {variant!r} not in "
                         f"{VARIANTS}")
    if (p.dtype != torch.float32 or p.dim() != 2 or p.shape[1] % 4
            or not p.is_contiguous()):
        raise ValueError("rot_expand: params must be contiguous float32 "
                         "(nq, block) with block % 4 == 0")
    if nsub < 1:
        raise ValueError("rot_expand: nsub must be >= 1")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rot_expand: no kernel for {p.device.type} "
                         f"tensors")


def _launch(p, nsub, variant, split, buf, index) -> int:
    """Launch K6 on device `index`'s current stream; the cudaError_t."""
    stream = torch.cuda.current_stream(index).cuda_stream
    # the counter of finished CTAs: 0 before every launch and 0 again
    # after it, one per stream, since launches on one stream run in turn
    done = _DONE.get((index, stream))
    if done is None:
        done = _DONE[(index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=p.device)
    ptr = buf.data_ptr()
    return _lib().pcr_rot_expand_probe(
        p.data_ptr(), p.shape[0], p.shape[1], nsub, VARIANTS.index(variant),
        split, ptr, done.data_ptr(), ptr + 512 * nsub * split, stream)


def split_of(nsub: int, block: int) -> int:
    """The CTAs one step's g's are shared among: about one CTA an SM over
    the launch, at least one g a group of lanes."""
    return max(1, min(_SMS // nsub, block // 4 // _GROUPS, 8))


def longest_chain(nsub: int, nq: int, block: int) -> int:
    """The most dependent adds one thread of the kernel makes: its share
    of a step's g's over its chains, nq adds a g."""
    share = -(-(block // 4) // split_of(nsub, block))
    return -(-(-(-share // _GROUPS)) // _CHAINS) * nq


def rot_expand(p: torch.Tensor, nsub: int, variant: str = "smem"
               ) -> torch.Tensor:
    """K6: the (1, 128) probe output for params p (nq, block)."""
    _check(p, nsub, variant)
    if p.device.type == "cpu":
        return rot_expand_plain(p, nsub)
    nq, block = p.shape
    split = split_of(nsub, block)
    if variant == "smem" and nq * -(-block // 4 // split) * 16 > _MAX_SMEM:
        raise ValueError(f"rot_expand: smem stages "
                         f"{nq * -(-block // 4 // split) * 16} B a CTA, "
                         f"over a CTA's {_MAX_SMEM}")
    if p.data_ptr() % 16:
        raise ValueError("rot_expand: the kernel copies params 16 bytes at "
                         "a time and takes them 16-byte aligned")
    # one buffer: the nsub * split partial rows, then the output row
    rows = nsub * split
    buf = torch.empty((rows + 1, 128), dtype=torch.float32, device=p.device)
    index = p.device.index
    if torch.cuda.current_device() == index:
        err = _launch(p, nsub, variant, split, buf, index)
    else:
        with torch.cuda.device(index):
            err = _launch(p, nsub, variant, split, buf, index)
    if err != 0:
        raise RuntimeError(f"rot_expand: launch failed (cudaError {err})")
    rot_expand.launches += 1
    return buf[rows:]


rot_expand.launches = 0


def rot_expand_plain(p: torch.Tensor, nsub: int) -> torch.Tensor:
    """K6's plain PyTorch version."""
    nq, block = p.shape
    return (p.view(nq, block // 4, 4).repeat_interleave(32, -1)
            .sum((0, 1)) * nsub).view(1, 128)


def atol(nsub: int, nq: int, block: int) -> float:
    """The probe's absolute tolerance: 1e-4 of |out|'s scale for N(0, 1)
    entries (the rtol alone fails a lane whose sum is near 0)."""
    return 1e-4 * nsub * float(np.sqrt(nq * block / 4))


def _time_ms(fn) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / _REPS


def run(nsub: int = 64, block: int = 2048, nq: int = 9,
        variants=VARIANTS) -> list[dict]:
    """Run each variant on the card: its result against numpy, and its
    CUDA-event time beside the plain version's. The inputs are the TPU
    probe's (standard normal from numpy's default_rng(0))."""
    if not torch.cuda.is_available():
        raise RuntimeError("rot_expand: the probe needs a CUDA card")
    params = np.random.default_rng(0).standard_normal(
        (nq, block), dtype=np.float32)
    want = np.repeat(params.reshape(nq, block // 4, 4), 32, axis=2).sum(
        axis=(0, 1)) * nsub
    p = torch.from_numpy(params).cuda()
    tol = atol(nsub, nq, block)
    plain_ms = _time_ms(lambda: rot_expand_plain(p, nsub))
    rows = []
    for v in variants:
        out = rot_expand(p, nsub, v).cpu().numpy()[0]
        again = rot_expand(p, nsub, v).cpu().numpy()[0]
        ms = _time_ms(lambda: rot_expand(p, nsub, v))
        rows.append({
            "variant": v,
            "ok": bool(np.allclose(out, want, rtol=1e-4, atol=tol)),
            "bit_identical": bool(np.array_equal(out.view(np.int32),
                                                 again.view(np.int32))),
            "max_abs_err": float(np.abs(out - want).max()),
            "ms": ms, "plain_ms": plain_ms,
            "mentries_per_s": nsub * block / ms / 1e3})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsub", type=int, default=64)
    ap.add_argument("--block", type=int, default=2048)
    ap.add_argument("--nq", type=int, default=9)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rot_expand: no CUDA device available", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}")
    rows = run(args.nsub, args.block, args.nq, args.variants)
    for r in rows:
        print(f"{r['variant']:5s} ok={r['ok']} "
              f"bit_identical={r['bit_identical']} "
              f"max_abs_err={r['max_abs_err']!r} t={r['ms']:.4f}ms "
              f"plain={r['plain_ms']:.4f}ms "
              f"{r['mentries_per_s']:.1f} Mentries/s")
    return 0 if all(r["ok"] and r["bit_identical"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
