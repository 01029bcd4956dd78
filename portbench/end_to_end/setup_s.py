"""Seconds from the process's start to the window's: imports, the graph,
the inputs, the program's set-up, and its first steps, which build and warm
every kernel the window runs."""


def read(w):
    return w.setup_s
