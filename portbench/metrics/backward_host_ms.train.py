"""backward_host_ms.train (ms): median host time of a training step's backward, over the window's untraced part."""

from pbcore import phases


def read(tl):
    return phases.median_ms(tl, "train", ("backward",))
