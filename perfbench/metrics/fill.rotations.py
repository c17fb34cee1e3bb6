"""Rotations a step of the fill's fixpoint (``fill_iters``), as the
program returns them: the mean over the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "fill.rotations")
