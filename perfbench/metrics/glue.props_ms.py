"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.props`` and
in no span nested in it: flow proportions
(``ops.flowdirs.flow_proportions``: the Quinn shares in plain PyTorch)."""

from perfbench import spans

SPANS = ("rd.props",)


def read(run):
    return spans.glue_ms(run, SPANS)
