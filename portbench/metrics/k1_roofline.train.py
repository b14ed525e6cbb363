"""k1_roofline.train (%): K1 (flash forward, with dropout) at its byte bound over its device time a launch."""

from pbcore import readers


def read(tl):
    return readers.kernel_roofline(tl, "train", "flash_fwd", "fwd")
