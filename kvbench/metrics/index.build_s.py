"""index.build_s (s, layer index): the set-up's build_index_device_stats
call, ended by a synchronize."""


def read(run):
    return run.setup.get("index_build_s")
