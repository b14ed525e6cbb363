"""device_idle.score (%): the share of the traced scoring window with no device operation running."""

from pbcore import readers


def read(tl):
    return readers.device_idle(tl, "score")
