"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.d8`` and in
no span nested in it: D8 codes (``ops.flowdirs.d8_core``: D8's stencil
kernel, which no reader claims, and its input copies)."""

from perfbench import spans

SPANS = ("rd.d8",)


def read(run):
    return spans.glue_ms(run, SPANS)
