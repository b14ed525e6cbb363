"""k2_roofline.train (%): K2 (flash backward, dk and dv) at its byte bound over its device time a launch."""

from pbcore import readers


def read(tl):
    return readers.kernel_roofline(tl, "train", "flash_dkdv", "dkdv")
