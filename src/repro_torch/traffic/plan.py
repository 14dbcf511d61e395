"""Message-table padding shared by the replay engines.

Each trace step's messages are padded to a power-of-two bucket so that the
replay sees a small set of table shapes.  The rest of the trace-plan
compiler (device-resident plans, segments, wave schedules) is not part of
this package yet.
"""
from __future__ import annotations

import numpy as np

BUCKET_MIN = 64        # smallest message-slot bucket (shared by all engines)


def bucket_cap(M: int, bucket_min: int = BUCKET_MIN) -> int:
    """Power-of-two capacity bucket for M messages.  M <= 1 needs exactly
    one slot: ``max(M - 1, 0)`` (NOT ``max(M - 1, 1)``, which would round
    M=0/M=1 up to a 2-slot bucket whenever ``bucket_min`` is 1)."""
    return max(bucket_min, 1 << max(M - 1, 0).bit_length())


def _pad_axis(a: np.ndarray, cap: int, axis: int, fill=0) -> np.ndarray:
    pad = cap - a.shape[axis]
    if pad <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def pad_message_table(links, dirs, nhops, t_inj, nbytes, *, axis=0,
                      bucket_min: int = BUCKET_MIN):
    """Pads every per-message array along ``axis`` to the power-of-two
    bucket of its current length and returns host numpy
    ``(links, dirs, nhops, t_inj, nbytes, valid)`` — links filled with -1,
    numerics with 0, ``valid`` marking real entries.
    """
    M = nhops.shape[axis]
    cap = bucket_cap(M, bucket_min)
    valid_shape = list(nhops.shape)
    valid_shape[axis] = cap
    valid = np.zeros(valid_shape, bool)
    np.moveaxis(valid, axis, 0)[:M] = True
    return (_pad_axis(links, cap, axis, -1), _pad_axis(dirs, cap, axis),
            _pad_axis(nhops, cap, axis),
            _pad_axis(t_inj.astype(np.float64), cap, axis),
            _pad_axis(nbytes.astype(np.float64), cap, axis), valid)
