"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.watersheds``
and in no span nested in it: watershed labels
(``methods.watersheds_from_flowdirs``: the effective and packed codes,
their transposes, the starting labels, a rotation's two transposes and
its ``torch.equal``, the cycle check, and pointer doubling when it
finishes)."""

from perfbench import spans

SPANS = ("rd.watersheds",)


def read(run):
    return spans.glue_ms(run, SPANS)
