"""ingest_p95_ms (pipeline entry, host clock): the 95th percentile over
every `ingest(cloud)` call of the traced window of the call's wall as its
caller sees it, with no synchronisation added: what a streaming reader
waits for before it can hand over its next chunk. (Per-layer: its spread
from run to run on the card's shared host is wider than any bound may
be; the untraced runs print its median and count on stderr.)"""

from ..stats import percentile


def read(run):
    if not run.ingest_walls:
        return None
    return percentile(run.ingest_walls, 95) * 1e3
