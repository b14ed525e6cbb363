"""Flow-record -> English-sentence rendering (the port's copy).

The same CICIDS2017 template as the JAX package's ``data/textualize.py``
(reference client1.py:68-81), byte for byte: the scoring server renders
``features`` requests through it, the training data path renders whole
frames through it, and the model's inputs depend on every byte.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

#: The 10 flow-feature columns the template renders, in order.
FLOW_TEXT_COLUMNS: tuple[str, ...] = (
    "Destination Port",
    "Flow Duration",
    "Total Fwd Packets",
    "Total Backward Packets",
    "Total Length of Fwd Packets",
    "Total Length of Bwd Packets",
    "Fwd Packet Length Max",
    "Fwd Packet Length Min",
    "Flow Bytes/s",
    "Flow Packets/s",
)

# (prefix, column, suffix) triples; the final fragment carries the trailing
# period with no trailing space, matching the reference template exactly.
CICIDS_TEMPLATE: tuple[tuple[str, str, str], ...] = (
    ("Destination port is ", "Destination Port", ". "),
    ("Flow duration is ", "Flow Duration", " microseconds. "),
    ("Total forward packets are ", "Total Fwd Packets", ". "),
    ("Total backward packets are ", "Total Backward Packets", ". "),
    ("Total length of forward packets is ", "Total Length of Fwd Packets", " bytes. "),
    ("Total length of backward packets is ", "Total Length of Bwd Packets", " bytes. "),
    ("Maximum forward packet length is ", "Fwd Packet Length Max", ". "),
    ("Minimum forward packet length is ", "Fwd Packet Length Min", ". "),
    ("Flow bytes per second is ", "Flow Bytes/s", ". "),
    ("Flow packets per second is ", "Flow Packets/s", "."),
)


def render_row(row: Mapping[str, object], template: Sequence[tuple[str, str, str]]) -> str:
    """Render one record through a ``(prefix, column, suffix)`` template."""
    return "".join(f"{prefix}{row[col]}{suffix}" for prefix, col, suffix in template)


def flow_to_text(row: Mapping[str, object]) -> str:
    """Render one flow record through the CICIDS2017 template."""
    return render_row(row, CICIDS_TEMPLATE)


def render_template(
    frame: Mapping[str, np.ndarray], template: Sequence[tuple[str, str, str]]
) -> list[str]:
    """Template rendering for a whole frame (``{column: numpy values}``),
    built column-wise. ``tolist()`` yields Python ints and floats whose
    ``str()`` is what the JAX package's pandas path writes
    (``'666666.6667'``, ``'54865'``, ``'nan'``, ``'inf'``)."""
    cols = [
        [f"{prefix}{v}{suffix}" for v in frame[col].tolist()]
        for prefix, col, suffix in template
    ]
    return ["".join(row) for row in zip(*cols)]
