"""Host-side data for the port (numpy only).

Parsing and packing are the JAX package's host layers, which import no
jax; the port reuses them rather than copying them, and re-exports the
ones its callers need so that they name only the port.
"""

from gcnbmp_tpu.data.packing import estimate_coo_capacities
from gcnbmp_tpu.data.parsers import CSVPairParser, get_class_labels

__all__ = ["CSVPairParser", "estimate_coo_capacities", "get_class_labels"]
