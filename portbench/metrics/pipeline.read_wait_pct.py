"""pipeline: the share of the tiles' wall time in which the pipeline's loop
blocked on a prefetched read (``PipelineStats.read_s / wall_s``, summed over
the window's tiles)."""


def read(run):
    stats = run.window.get("pipeline") or []
    wall = sum(s.wall_s for s in stats)
    if not wall:
        return None
    return 100.0 * sum(s.read_s for s in stats) / wall
