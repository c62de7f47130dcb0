"""The step's model FLOPs (the configuration's FLOP module, forward and
backward) over the traced step time times the configuration's peak, in %."""


def read(t):
    if not t.kernels:
        return None
    flops = t.flops.step_flops(t.spec.config, t.shapes)
    return 100.0 * flops / (t.window_s / t.steps * t.spec.config["peak_flops"])
