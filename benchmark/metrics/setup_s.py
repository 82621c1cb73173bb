"""Seconds from the start of the process to the opening of the window:
imports, kernel load (and, in a fresh checkout, build), weights, model,
inputs, warm-up."""


def read(run):
    return run.set_up_s
