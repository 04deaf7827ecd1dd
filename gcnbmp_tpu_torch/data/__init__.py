"""Host-side data for the port (numpy only): pair datasets, CSV parsing,
COO packing (Python and native), the wire encoding and the batch
iterators.  These are the port's own copies of the JAX package's host
layers, under the same module names (``dataset``, ``parsers``,
``packing``, ``native_pack``), so that the port imports nothing of it.
"""

from gcnbmp_tpu_torch.data.packing import estimate_coo_capacities
from gcnbmp_tpu_torch.data.parsers import CSVPairParser, get_class_labels

__all__ = ["CSVPairParser", "estimate_coo_capacities", "get_class_labels"]
