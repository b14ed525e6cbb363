"""adam_roofline.train (%): Adam's byte bound over the device time of the optimizer's kernels a step."""

from pbcore import readers


def read(tl):
    return readers.adam_roofline(tl)
