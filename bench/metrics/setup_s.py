"""Seconds from the process's start to the window's: imports, weights,
kernel builds or loads, and the warm-up of every shape the window uses."""


def read(v):
    return v.setup_s
