"""Rotations a step of the D8 accumulation's fixpoint
(``accum_rotations``), as the program returns them: the mean over the
window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "accum.rotations")
