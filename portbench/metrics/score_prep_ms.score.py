"""score_prep_ms.score (ms): median host time of a scoring call's pad and copies to the device, over the window's untraced part."""

from pbcore import phases


def read(tl):
    return phases.median_ms(tl, "score", ("prep",))
