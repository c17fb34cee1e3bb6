"""Rotations a step of the gauges' upslope walk's resolve sweeps, as
``upslope_cells(..., return_info=True)`` returns them (its cap when
pointer doubling finished): the mean over the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "upslope.rotations")
