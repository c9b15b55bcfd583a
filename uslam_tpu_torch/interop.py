"""Carry state between the JAX package and the port, without importing JAX.

Containers are matched by class name and field name: a JAX ``Values``,
``GraphArrays`` (with ``Priors``, ``ImuIntervals``, ``ImuIntervalData``,
``DvlMeasurements``, ``StereoObservations``), ``Keypoints``,
``Linearization``, ``DeviceWindowState`` or ``DeviceWindowRecord`` taken to
numpy (``jax.device_get``) becomes the port's container of the same name,
and back. The port's own numpy trees (what
:func:`uslam_tpu_torch.graph.packing.pack_sequence` returns) go through the
same :func:`to_port` to reach the device.

Descriptors are uint32 in JAX and int32 bit-views in the port: torch on the
CPU refuses shifts on uint32 and has no popcount, while int32 XOR is exact.
Configs go across with :func:`config_to_port`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uslam_tpu_torch import config
from uslam_tpu_torch.factors.imu import ImuIntervalData
from uslam_tpu_torch.frontend.orb import Keypoints
from uslam_tpu_torch.graph.builder import (
    DvlMeasurements,
    GraphArrays,
    ImuIntervals,
    Priors,
    StereoObservations,
)
from uslam_tpu_torch.graph.values import Values
from uslam_tpu_torch.solvers.linearize import Linearization

_CONTAINERS = {
    cls.__name__: cls
    for cls in (
        Values, GraphArrays, Priors, ImuIntervals, ImuIntervalData,
        DvlMeasurements, StereoObservations, Keypoints, Linearization,
    )
}


def _container(name: str):
    """The port's container class called ``name``. The fixed-lag window's
    classes are looked up at first use: their module imports the pipeline,
    which imports this one."""
    if name not in _CONTAINERS:
        from uslam_tpu_torch.solvers import fixed_lag

        for cls in (fixed_lag.DeviceWindowState, fixed_lag.DeviceWindowRecord):
            _CONTAINERS[cls.__name__] = cls
    return _CONTAINERS[name]


def to_port(tree, device):
    """Numpy container tree (JAX or port class) -> the port's container of
    tensors on ``device``, each leaf keeping its dtype (uint32 becomes an
    int32 bit-view)."""
    if hasattr(tree, "_fields"):
        cls = _container(type(tree).__name__)
        return cls(*(to_port(getattr(tree, f), device) for f in cls._fields))
    a = np.asarray(tree, order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)  # copies: JAX's host arrays are read-only


def from_port(tree, like):
    """Port container tree -> the class of ``like`` (a JAX container taken to
    numpy) with numpy leaves; int32 descriptor views go back to uint32
    wherever ``like`` holds uint32."""
    if hasattr(like, "_fields"):
        return type(like)(
            *(from_port(getattr(tree, f), getattr(like, f)) for f in like._fields)
        )
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


def config_to_port(cfg):
    """A JAX package config dataclass (``UslamConfig`` or any of its
    sections) -> the port's dataclass of the same name and fields."""
    cls = getattr(config, type(cfg).__name__)
    return cls(**{
        f.name: config_to_port(v) if dataclasses.is_dataclass(v) else v
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)
    })
