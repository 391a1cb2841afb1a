"""Device milliseconds per pass of the traversal domains: the operations
inside the program's ``domain`` device spans (each domain's local ray, its
``traverse()`` call, its winner re-test and its merge into the query's
best, on closest-hit and any-hit queries), in the span render
(``spans.py``). None on a tree whose program opens no such span."""

from portbench import spans


def read(ctx):
    spans.ensure(ctx)
    if not ctx.spans or not any(s.name == "domain" for s in ctx.spans):
        return None
    return spans.device_ms(ctx, lambda chain: "domain" in chain)
