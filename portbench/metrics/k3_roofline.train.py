"""k3_roofline.train (%): K3 (flash backward, dq and delta) at its byte bound over its device time a launch."""

from pbcore import readers


def read(tl):
    return readers.kernel_roofline(tl, "train", "flash_dq", "dq")
