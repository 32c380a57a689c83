"""Answered queries over the whole window of a cell that applies deltas:
the stalls of the deltas are inside the window, so their length enters in
proportion."""


def read(run):
    return run.answered / run.window_s
