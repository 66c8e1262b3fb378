"""Pairs registered and measured a second: every pair of the window's whole
calls over all the window's seconds."""


def read(window):
    return window["pairs"] / window["seconds"]
