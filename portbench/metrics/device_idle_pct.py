"""The share, in percent, of the traced stretch's wall time in which the
device ran no kernel, copy or fill: one minus the union of the device's
intervals over the stretch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device() or tr.window_us <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
