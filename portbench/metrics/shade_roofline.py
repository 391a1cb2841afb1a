"""The bounce's shading kernels' share of their roofline, in percent: the
least time for the bytes their launches in the traced stretch must move
(``rooflines/shade.py``) over the device time they took."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    shade = ctx.roofline("shade")
    launches = {k: 0 for k in shade.KERNELS}
    us = 0.0
    for name, _, dur in tr.kernels:
        k = ctx.kernel_id(name)
        if k in launches:
            launches[k] += 1
            us += dur
    if not us:
        return None
    s = ctx.scene
    least = shade.least_seconds(launches, s["lanes"], s["nls"], s["motion"],
                                s["analytic"], shade.table_bytes(ctx.config))
    return 100.0 * least / (us * 1e-6)
