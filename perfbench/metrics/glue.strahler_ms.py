"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.strahler``
and in no span nested in it: Strahler order (``methods.strahler_order``:
the starting order, the codes and their transposes, a rotation's two
transposes and its ``torch.equal``)."""

from perfbench import spans

SPANS = ("rd.strahler",)


def read(run):
    return spans.glue_ms(run, SPANS)
