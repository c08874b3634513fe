"""Megapixels of source images encoded per second over the window."""


def read(run):
    return run.rate_mps()
