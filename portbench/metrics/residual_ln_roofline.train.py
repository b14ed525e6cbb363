"""residual_ln_roofline.train (%): the residual add + LayerNorm forward and backward at their byte bounds over their device time a step.

A step's bound is the family's post-LN sites times one training forward
(x and r in; y, the rounded sum and each row's mean and rstd out: 8 bytes
a bf16 element) and one backward (dy and the sum in, dx out: 6), at 3.35
TB/s; its time the forward's, the backward's and the backward's column
sum's device time. None as ``residual_ln_roofline.score`` is, for each of
the three kernels.
"""

import os

from pbcore import bench

_SCORE = bench.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "residual_ln_roofline.score.py"),
                           "portbench_metric_residual_ln_roofline_score_helpers")


def read(tl):
    want = _SCORE.sites(tl, "train")
    if want is None:
        return None
    times = [_SCORE.seconds_a_step(tl, f, want) for f in (_SCORE.FWD, _SCORE.BWD, _SCORE.DPARAMS)]
    if None in times:
        return None
    rows, n, e = _SCORE.shape(tl)
    bound = want * (_SCORE.forward_bound(rows, n, e, save=True) + _SCORE.backward_bound(rows, n, e))
    return 100.0 * bound / sum(times)
