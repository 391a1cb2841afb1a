"""Scene queries the integrator issued (``RenderStats.rays_traced``: the
closest-hit traces of live lanes and the shadow queries NEE asked for,
the band overlap's re-traced rows included) per pixel sample added to the
image, over the whole window: a counter of the program's own."""


def read(ctx):
    if not ctx.samples:
        return None
    return ctx.queries / ctx.samples
