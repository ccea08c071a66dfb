"""d2h_gbs (transfer, program counter): the bytes the port copies to the
host in its finalize (`d2h_bytes`, counted at torch_backend._to_host, the
one way there) over the device seconds of those copies (the CUDA events
of its `finalize.d2h` device span), in GB/s (1e9 B). None without CUDA
events."""

from .. import program_spans


def read(run):
    rows = program_spans.spans(run, "finalize.d2h")
    if rows is None or not rows[0]["device_s"]:
        return None
    nbytes = program_spans.snapshot(run)["counters"].get("d2h_bytes", 0)
    return nbytes / rows[0]["device_s"] / 1e9 if nbytes else None
