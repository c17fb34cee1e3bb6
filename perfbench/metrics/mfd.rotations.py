"""Rotations a step of the multi-flow accumulation's fixpoint, as
``flow_accumulation_from_props(..., return_info=True)`` returns them: the
mean over the window's steps."""

from perfbench.layers import counter_mean


def read(run):
    return counter_mean(run, "mfd.rotations")
