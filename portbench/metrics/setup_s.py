"""Set-up seconds: process start (before torch's import) to the window's start."""


def read(run):
    return run.setup_s
