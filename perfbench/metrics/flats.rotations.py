"""Rotations a step of flat resolution's three distance fixpoints
(towards, away, maxd), summed, as ``resolve_flats(...,
return_info=True)`` returns them: the mean over the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "flats.rotations")
