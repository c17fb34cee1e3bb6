"""Rotations a step of the D∞ accumulation's fixpoint, as
``dinf_accumulation_from_angles(..., return_info=True)`` returns them: the
mean over the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "dinf.rotations")
