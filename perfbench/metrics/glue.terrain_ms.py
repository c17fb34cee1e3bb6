"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.terrain``
and in no span nested in it: slope and TWI
(``ops.terrain.terrain_core``, ``methods.twi``: plain PyTorch over the
3x3 window)."""

from perfbench import spans

SPANS = ("rd.terrain",)


def read(run):
    return spans.glue_ms(run, SPANS)
