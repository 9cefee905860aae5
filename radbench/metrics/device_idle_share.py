"""Device: the share of the profiled window in which no kernel, copy or
memset ran, percent."""


def read(t):
    if not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
