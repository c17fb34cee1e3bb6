"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.dinf_dirs``
and in no span nested in it: the Tarboton angles
(``ops.flowdirs.dinf_flowdirs``: the eight facets' slopes and angles in
plain PyTorch, the steepest facet and the nodata mask)."""

from perfbench import spans

SPANS = ("rd.dinf_dirs",)


def read(run):
    return spans.glue_ms(run, SPANS)
