"""device_idle.train (%): the share of the traced training window with no device operation running."""

from pbcore import readers


def read(tl):
    return readers.device_idle(tl, "train")
