"""k1_roofline.score (%): K1 (flash forward at rate 0) at its byte bound over its device time a launch."""

from pbcore import readers


def read(tl):
    return readers.kernel_roofline(tl, "score", "flash_fwd", "fwd")
