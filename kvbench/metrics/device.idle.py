"""device.idle (%, layer device): 1 - the union of the device's activity
intervals over the traced window (frozen/idle.py), as a share."""


def read(run):
    if not run.device_events:
        return None
    busy, window = run.busy_window()
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
