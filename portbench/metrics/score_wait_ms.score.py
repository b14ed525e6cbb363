"""score_wait_ms.score (ms): median host time a scoring call waits for its probabilities on the host, over the window's untraced part."""

from pbcore import phases


def read(tl):
    return phases.median_ms(tl, "score", ("wait",))
