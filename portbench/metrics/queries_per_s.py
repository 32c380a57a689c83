"""Answered queries over the whole window (closed loop: every query the
window let the client send, answered)."""


def read(run):
    return run.answered / run.window_s
