"""step_host_ms.train (ms): median host time of one training step, placing the batch through the optimizer, over the window's untraced part."""

from pbcore import phases


def read(tl):
    return phases.median_ms(tl, "train")
