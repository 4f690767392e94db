"""Tree and timing utilities of the port (port of ``repro/utils``).

The reference's ``utils/hlo.py`` parses a compiled XLA program's HLO text
for its collectives and sums their wire bytes. It has no counterpart here:
eager PyTorch compiles no whole-program HLO, so there is no text to parse,
and a parser of something else under that name would be a fake. Its ring
wire formulas are kept as a plain function of (collective, bytes, group
size), :func:`repro_torch.launch.roofline.wire_bytes`, for a multi-card
cell that knows its collectives.
"""

from repro_torch.utils.timing import Timer, bench
from repro_torch.utils.tree import (
    reference_path,
    tree_bytes,
    tree_flatten_with_paths,
    tree_map_with_path,
    tree_param_count,
)

__all__ = [
    "tree_bytes",
    "tree_param_count",
    "tree_flatten_with_paths",
    "tree_map_with_path",
    "reference_path",
    "Timer",
    "bench",
]
