"""Share of the profiled window in which no operation ran on the device:
100 less the union of the device operations' intervals over the window."""


def read(t):
    if t.device is None or t.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.device.busy_s() / t.device.window_s)
