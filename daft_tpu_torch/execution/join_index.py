"""The key eligibility rule of the equi-join index (port of a part of
``daft_tpu/execution/join_index.py``).

``_key_values`` decides which keys have a numpy image with a total order
(ints, uints, bools, dates/timestamps; floats are out: NaN breaks the order);
the partitioned aggregation's cheap integer bucketing reads it. Not ported
yet: the build-once / probe-many join index itself (with sort and joins).
"""

from __future__ import annotations

import numpy as np

from daft_tpu_torch.series import Series

#: numpy dtype kinds with a total order searchsorted can rely on.
_SORTABLE_KINDS = frozenset("iubM")


def _key_values(key: Series):
    """(values, null_mask|None) when the key is index-eligible, else None."""
    if key.dtype.is_python():
        return None
    vals, mask = key.to_numpy_masked()
    if not isinstance(vals, np.ndarray) or vals.dtype.kind not in _SORTABLE_KINDS:
        return None
    return vals, mask
