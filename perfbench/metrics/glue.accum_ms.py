"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.accum`` and
in no span nested in it: D8 accumulation
(``ops.accum.d8_accumulation_info``: the permuted, transposed codes and
weights, a rotation's two transposes and its ``torch.equal``)."""

from perfbench import spans

SPANS = ("rd.accum",)


def read(run):
    return spans.glue_ms(run, SPANS)
