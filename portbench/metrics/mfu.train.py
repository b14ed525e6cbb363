"""mfu.train (%): the training step's analytic FLOPs per second over the card's dense bf16 peak."""

from pbcore import readers


def read(tl):
    return readers.mfu(tl, "train")
