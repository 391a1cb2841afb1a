"""Device milliseconds per pass of the traversal's plumbing: the
operations inside the program's ``traversal_plumbing`` device spans (the
rays' packing and coherence sort, the results' unsort), in the span
render (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda chain: "traversal_plumbing" in chain)
