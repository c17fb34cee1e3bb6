"""Share of the traced window, in %, in which the card ran nothing while
the host was inside a layer span of the program: the idle intervals of
``device.idle_pct`` intersected with the union of the spans.  At most
``device.idle_pct``."""

from perfbench import spans

SPANS = spans.ALL


def read(run):
    return spans.idle_in_program_pct(run, SPANS)
