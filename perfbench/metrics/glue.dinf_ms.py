"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.dinf`` and in
no span nested in it: D∞ accumulation
(``ops.accum.dinf_accumulation_from_angles``,
``ops.dinf.dinf_accumulation``: the two-tap split and packing, the
transposed field and weights, the nodata masks, a rotation's two
transposes and its ``torch.equal``)."""

from perfbench import spans

SPANS = ("rd.dinf",)


def read(run):
    return spans.glue_ms(run, SPANS)
