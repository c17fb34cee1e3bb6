"""Rotations a step of Strahler order's fixpoint, as
``strahler_order(..., return_info=True)`` returns them: the mean over
the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "strahler.rotations")
