"""setup_s (end to end, host clock): process start to the window's start:
imports, the card, the kernels' load (their build in a checkout's first
run), the points from the seed, the traffic's clouds or staging, and one
warm-up job."""


def read(run):
    return run.setup_s
