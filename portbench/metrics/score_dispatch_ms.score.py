"""score_dispatch_ms.score (ms): median host time of a scoring call's forward and softmax dispatch, over the window's untraced part."""

from pbcore import phases


def read(tl):
    return phases.median_ms(tl, "score", ("dispatch",))
