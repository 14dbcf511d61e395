"""Build the port's value objects from plain data.

The port shares no object with the JAX package; a caller that holds a
reference ``Policy``, ``PowerModel``, ``Megafly`` or ``Trace`` carries it
across as plain field dicts (``dataclasses.asdict``) and numpy arrays, so
both packages replay exactly the same inputs.  Model parameters cross as
a nested dict of numpy arrays (the reference's parameter pytree).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.eee import Policy, PowerModel
from repro_torch.topology.megafly import Megafly
from repro_torch.traffic.trace import Step, Trace


def model_params(tree, *, device="cpu") -> dict:
    """The reference's ``init_params`` pytree, given as nested dicts of
    numpy arrays, as the port's parameters: the same dict with tensors
    (copies) on ``device``."""
    return {k: model_params(v, device=device) if isinstance(v, dict)
            else torch.tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def serving_params(params) -> dict:
    """bf16 copies of the floating-point parameters, the reference's
    serving convention (``launch/specs.py: serve_param_specs``)."""
    return {k: serving_params(v) if isinstance(v, dict)
            else (v.to(torch.bfloat16) if v.is_floating_point() else v)
            for k, v in params.items()}


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
