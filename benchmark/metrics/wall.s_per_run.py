"""A run's wall on the host's clock, per layer, for a cell whose end-to-end
time is read from the device: the traced run's measured window over the
runs completed in it (its stages' synchronizes included)."""


def read(t):
    if not t.n_runs or t.window_s <= 0:
        return None
    return t.window_s / t.n_runs
