"""Device milliseconds per pass inside the program's ``tiny_mesh_fold``
device spans (every launch of the tiny-mesh fold, closest and any hit), in
the span render (``spans.py``). "Per pass" as in the harness's other
metrics: per pixel sample of the render, which is half a launch where a
frame fits twice in the launch budget."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda chain: "tiny_mesh_fold" in chain)
