"""setup_s (s): process start to the first timed request: the series, the
calibration, the series on the card, the index build, the engine and the
warm requests."""


def read(run):
    return run.setup["setup_s"]
