"""Milliseconds per pass in which the device is idle while the host is
inside one of the program's host spans ``band.readback``,
``band.host_add``, ``checkpoint`` or ``progress``: what the read-back,
the numpy add into the image and the callbacks cost the device, in the
span render (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.host_stall_ms(ctx)
