"""1 - busy / traced window, in %; busy is the union of the device's
operation intervals."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.kernels else None
