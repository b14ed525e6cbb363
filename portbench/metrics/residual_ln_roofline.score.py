"""residual_ln_roofline.score (%): the residual add + LayerNorm forward at its byte bound over its device time a launch.

The bound of one launch reads x and r and writes y once, in the cell's
activation dtype (6 bytes a bf16 element), over the cell's rows (batch x
sequence) at the model's width, and gamma and beta once, at 3.35 TB/s.
None when the window holds no launch, when the launches a call, rounded,
are not the family's post-LN sites (two a block of a DistilBERT-family
model), or when the family has no post-LN block: a path that bypasses the
kernel shows as a missing metric, never as 0. The training reader
(``residual_ln_roofline.train.py``) uses the helpers here.
"""

from pbcore import bench, roofline

#: Residual add + LayerNorm sites a layer, by family; a family absent
#: here has no post-LN block.
POST_LN_SITES = {"distilbert": 2}
#: Kernel-name fragments of the forward, the backward and its column sum.
FWD = "residual_layer_norm_fwd"
BWD = "residual_layer_norm_bwd"
DPARAMS = "residual_layer_norm_dparams"
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def sites(tl, mode: str) -> int | None:
    """The launches a step or call of each kernel, or None where the run
    is of another mode or its family has no post-LN block."""
    if tl is None or tl.extra.get("mode") != mode or not tl.extra.get("traced_steps"):
        return None
    per_layer = POST_LN_SITES.get(tl.extra.get("reference", bench.DEFAULT_FAMILY))
    return None if per_layer is None else per_layer * tl.extra["cfg"]["n_layers"]


def seconds_a_step(tl, fragment: str, want: int) -> float | None:
    """Device seconds a step of the kernel, its mean launch times ``want``
    launches, or None where its launches a step, rounded, are not
    ``want`` (a record the profiler drops now and then moves neither)."""
    seconds, launches = tl.kernel(fragment)
    if launches == 0 or seconds <= 0 or round(launches / tl.extra["traced_steps"]) != want:
        return None
    return want * seconds / launches


def shape(tl) -> tuple[int, int, int]:
    """(rows, width, bytes an element) of one launch."""
    cfg = tl.extra["cfg"]
    return tl.extra["batch"] * tl.extra["seq_len"], cfg["dim"], ELEMENT_BYTES[cfg.get("compute_dtype", "bfloat16")]


def forward_bound(rows: int, n: int, e: int, save: bool) -> float:
    """Least seconds of one forward: x and r in, y out (and with ``save``
    the rounded sum and 8 bytes a row of mean and rstd), gamma and beta."""
    nbytes = rows * n * e * (4 if save else 3) + 2 * n * 4 + (8 * rows if save else 0)
    return nbytes / roofline.HBM_BYTES_PER_S


def backward_bound(rows: int, n: int, e: int) -> float:
    """Least seconds of one backward: dy, the rounded sum and the stats
    in, dx out; gamma in, dgamma and dbeta out."""
    return (rows * n * e * 3 + 8 * rows + 3 * n * 4) / roofline.HBM_BYTES_PER_S


def read(tl):
    want = sites(tl, "score")
    if want is None:
        return None
    per_step = seconds_a_step(tl, FWD, want)
    if per_step is None:
        return None
    return 100.0 * forward_bound(*shape(tl), save=False) * want / per_step
