"""Host-side data for the port: pair datasets, CSV parsing (and its
pickle cache), COO packing (Python and native), the wire encoding and the
batch iterators, all numpy only; and the prefetcher (``prefetch``, the
one module here that imports torch).  These are the port's own copies of the JAX package's host
layers, under the same module names (``dataset``, ``parsers``,
``packing``, ``native_pack``), so that the port imports nothing of it.
"""

from gcnbmp_tpu_torch.data.packing import estimate_coo_capacities
from gcnbmp_tpu_torch.data.parsers import (
    CSVPairParser, get_class_labels, parse_pair_csv)

__all__ = ["CSVPairParser", "estimate_coo_capacities", "get_class_labels",
           "parse_pair_csv"]
