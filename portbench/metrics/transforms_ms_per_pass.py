"""Device milliseconds per pass of the keyed transforms: the operations
inside the program's ``transforms`` device spans (each transform chain's
evaluation and each ray taken into or out of a local space), wherever
they run, in the span render (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, lambda chain: "transforms" in chain)
