"""probe.blocks (blocks/query, layer probe): the PROBE_BLOCK rebuilds of
the dense probe pass that served each query (QueryStats.n_probe_blocks:
the bucket windows and the window statistics made again block by block,
counted once for each table rebuilt; 0 on the cached single-launch path),
averaged over the window's queries.  A program without the counter gives
nothing to read."""


def read(run):
    vals = [getattr(s, "n_probe_blocks", None) for s in run.stats]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
