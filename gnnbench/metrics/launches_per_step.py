"""Device operations (kernels, copies, memsets) per traced step."""


def read(t):
    return len(t.kernels) / t.steps if t.kernels else None
