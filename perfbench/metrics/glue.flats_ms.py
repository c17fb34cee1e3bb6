"""Device time a step, in ms, of the operations that no reader claims
(those of ``glue.device_ms``) launched inside the span ``rd.flats`` and
in no span nested in it: flat resolution
(``ops.flats.resolve_flats_info``: the flats' fields and flags, their
transposes, the seeds, the three fixpoints' transposes and change flags,
the mask and the steepest descent)."""

from perfbench import spans

SPANS = ("rd.flats",)


def read(run):
    return spans.glue_ms(run, SPANS)
