"""Seconds from the process's start to the window's: imports, inputs,
weights, the runner, and one epoch or pass of the cell's shapes."""


def read(s: dict):
    return s["setup_s"]
