"""Build the port's value objects from plain data.

The port shares no object with the JAX package; a caller that holds a
reference ``Policy``, ``PowerModel``, ``Megafly`` or ``Trace`` carries it
across as plain field dicts (``dataclasses.asdict``) and numpy arrays, so
both packages replay exactly the same inputs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.eee import Policy, PowerModel
from repro_torch.topology.megafly import Megafly
from repro_torch.traffic.trace import Step, Trace


def policy(fields: dict) -> Policy:
    return Policy(**fields)


def power_model(fields: dict) -> PowerModel:
    return PowerModel(**fields)


def megafly(fields: dict) -> Megafly:
    return Megafly(**fields)


def _opt(a, dtype):
    return None if a is None else np.array(a, dtype)


def trace(nodes, steps, name: str = "") -> Trace:
    """``steps``: one dict per step with the fields of ``Step``
    (``compute_nodes``, ``compute_secs``, ``msgs``, ``barrier``); arrays
    are copied."""
    return Trace(
        nodes=np.array(nodes, np.int64),
        steps=[Step(compute_nodes=_opt(s.get("compute_nodes"), np.int64),
                    compute_secs=_opt(s.get("compute_secs"), np.float64),
                    msgs=_opt(s.get("msgs"), np.int64),
                    barrier=bool(s.get("barrier", False)))
               for s in steps],
        name=name)
