"""setup_s (s): process start to the first timed request, less the
harness's own series generation and calibration: the imports, the series on
the card, the index build, the engine and the warm requests."""


def read(run):
    return run.setup["setup_s"]
