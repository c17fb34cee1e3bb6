"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.upslope``
and in no span nested in it: the gauges' upslope cells
(``methods.upslope_cells``: the effective and packed codes, their
transposes, the seeds, a rotation's two transposes and its
``torch.equal``, and pointer doubling when it finishes)."""

from perfbench import spans

SPANS = ("rd.upslope",)


def read(run):
    return spans.glue_ms(run, SPANS)
