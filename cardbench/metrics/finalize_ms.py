"""finalize_ms (pipeline entry, host clock): the mean wall of
`Pipeline.finalize` a job: the device finalize, the copy to the host and
the masking."""


def read(run):
    if not run.finalize_walls:
        return None
    return sum(run.finalize_walls) / len(run.finalize_walls) * 1e3
