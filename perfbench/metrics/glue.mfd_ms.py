"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.mfd`` and in
no span nested in it: multi-flow accumulation
(``ops.mfd.mfd_accumulation``: the props-to-planes copy, the weights'
mask, the transposed planes, a rotation's two transposes and its
``torch.equal``)."""

from perfbench import spans

SPANS = ("rd.mfd",)


def read(run):
    return spans.glue_ms(run, SPANS)
