"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched outside every layer span of the
program, or whose launch the window lacks: the calls between entries,
such as the pipeline's ``where``s and a step's nodata mask.  With the
six span readers it sums to ``glue.device_ms``."""

from perfbench import spans

SPANS = spans.ALL


def read(run):
    return spans.glue_ms(run, SPANS, unspanned=True)
