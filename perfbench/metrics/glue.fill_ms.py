"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.fill`` and
in no span nested in it: the fill (``ops.fill.fill_depressions_info``:
its multigrid start, the floor and its transposed copy, a rotation's two
transposes and change-flag resets, the ``where``s)."""

from perfbench import spans

SPANS = ("rd.fill",)


def read(run):
    return spans.glue_ms(run, SPANS)
