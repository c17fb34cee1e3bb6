"""Rotations a step of the watershed walk's resolve sweeps, as
``watersheds_from_flowdirs(..., return_info=True)`` returns them (its
cap when pointer doubling finished): the mean over the window's
steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "watersheds.rotations")
