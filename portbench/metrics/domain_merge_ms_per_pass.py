"""Device milliseconds per pass of the domains' merges: the operations
inside the program's ``domain_merge`` device spans (a domain's exact
winner re-test and its fold into the query's best: t, triangle, the
barycentrics, the meta rows and the rotation on a closest-hit query, the
or into ``occluded`` on an any-hit one), in the span render
(``spans.py``). None on a tree whose program opens no such span."""

from portbench import spans


def read(ctx):
    spans.ensure(ctx)
    if not ctx.spans or not any(s.name == "domain_merge"
                                for s in ctx.spans):
        return None
    return spans.device_ms(ctx, lambda chain: "domain_merge" in chain)
