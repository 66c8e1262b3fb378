"""Seconds from the process's start to the window: imports, the card's
context, the kernels' build or load, the traffic made from the seed, and the
warm-up calls."""


def read(window):
    return window["setup_s"]
