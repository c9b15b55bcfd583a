"""Typed configuration of the port: the JAX package's dataclass tree, field
for field and default for default (``tests/test_torch_backend.py`` holds the
two equal); :func:`uslam_tpu_torch.interop.config_to_port` carries a JAX
package config across.

The port reads every field of the offline batch path, the banded reduced
solver and the KLT tracker included; ``SolverConfig.debug_nans`` runs
finiteness checks after each stage of every LM iteration
(:mod:`uslam_tpu_torch.solvers.lm`). A config goes to and from a plain dict,
JSON or YAML with the JAX package's schema (``to_dict``, ``from_dict``,
``from_json``, ``save_json``, ``from_yaml``, ``save_yaml``), so config files
pass between the two packages. Not read: ``FrontendConfig.use_pallas``
(the front-end kernels dispatch on the device of their tensors) and
``SolverConfig.banded_unroll`` (a ``lax.scan`` knob; the port's panel
sweeps are Python loops).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    """Stereo calibration; defaults are the ZED-mini at 1920x1080."""

    fx: float = 1827.0
    fy: float = 1827.5999755859375
    skew: float = 0.0
    cx: float = 968.9000244140625
    cy: float = 561.4000244140625
    baseline: float = 0.063  # metres
    resolution_x: int = 1920
    resolution_y: int = 1080

    @property
    def f_mean(self) -> float:
        return (self.fx + self.fy) / 2.0


@dataclass(frozen=True)
class ImuConfig:
    """IMU preintegration parameters."""

    gravity: float = 9.81
    accel_cov: float = 8.999999999999999e-08
    gyro_cov: float = 1.2184696791468346e-07
    integration_cov: float = 1e-07
    bias_acc_cov: float = 0.1
    bias_gyro_cov: float = 0.1
    default_dt: float = 0.005   # 200 Hz
    # 'fixed': every sample uses default_dt; 'stamps': dt from IMU stamps.
    dt_mode: str = "fixed"
    # IMU samples kept per keyframe interval (static pad).
    max_samples_per_keyframe: int = 64


@dataclass(frozen=True)
class NoiseConfig:
    """Factor noise sigmas."""

    prior_pose_sigmas: tuple = (0.1, 0.1, 0.1, 0.3, 0.3, 0.3)  # rot x3, trans x3
    prior_vel_sigma: float = 0.1
    dvl_sigma: float = 0.1
    stereo_sigma: float = 10.0
    prior_bias_sigma: float | None = 0.316227766016838  # None: no bias prior
    stereo_huber_delta: float | None = None  # whitened units; None: Gaussian


@dataclass(frozen=True)
class PressureConfig:
    """depth = (press_abs_mbar * 100 - atm_pressure) / (water_density * g)."""

    atm_pressure_pa: float = 98250.0
    water_density: float = 997.0
    gravity: float = 9.81


@dataclass(frozen=True)
class FrontendConfig:
    """ORB front end: 3x4 grid of <= 4 features per cell, FAST-9 at
    threshold 10, 3 pyramid levels."""

    grid_rows: int = 3
    grid_cols: int = 4
    max_features_per_cell: int = 4
    fast_threshold: float = 10.0
    fast_arc_length: int = 9
    pyramid_levels: int = 3
    pyramid_scale: float = 2.0
    patch_size: int = 15
    descriptor_bits: int = 256
    match_max_distance: int = 64
    match_ratio: float = 0.8
    stereo_max_v_diff: float = 5.0
    stereo_min_disparity: float = 0.25
    ransac_threshold_px: float = 3.0
    max_candidates: int = 1024
    use_pallas: bool | str = "auto"  # not read by the port
    temporal_tracker: str = "orb"    # 'orb' | 'klt'
    klt_gate_px: float = 2.0
    # Stereo pairs per batched front-end step in run_sequence.
    offline_chunk: int = 8

    @property
    def max_features(self) -> int:
        return self.grid_rows * self.grid_cols * self.max_features_per_cell


@dataclass(frozen=True)
class SolverConfig:
    """Levenberg-Marquardt parameters. ``debug_nans`` checks every LM stage
    for non-finite values and raises ``FloatingPointError`` naming it."""

    max_iterations: int = 100
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper_bound: float = 1e5
    lambda_lower_bound: float = 1e-7
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    linear_solver: str = "schur"      # 'schur' | 'dense'
    max_obs_per_landmark: int = 64
    reduced_solver: str = "cholesky"  # 'cholesky' | 'cg' | 'banded'
    band_width: int = 0
    banded_panel: int = 0
    banded_corr_window: int = 0
    banded_refine_iters: int = 1
    banded_unroll: int = 2
    eliminate_velocities: bool = True
    damping_mode: str = "diag"        # 'diag' (lambda * diag(H)) | 'identity'
    refine_iters: int = 4
    cholesky_jitter: float = 1e-8
    cg_max_iterations: int = 200
    cg_tol: float = 1e-8
    debug_nans: bool = False
    # Stop after this many consecutive iterations that change the error by
    # less than plateau_rtol * error.
    plateau_patience: int = 5
    plateau_rtol: float = 5e-3
    f64_polish: bool = False


@dataclass(frozen=True)
class TimeSyncConfig:
    """Approximate time join: slop 0.2 s; keyframe poses from the DVL."""

    slop: float = 0.2
    queue_size: int = 10
    pose_source: str = "dvl"  # 'dvl' | 'gt'


@dataclass(frozen=True)
class EvalConfig:
    z_datum_shift: float = 0.7433  # applied to odometry before the MSE only


@dataclass(frozen=True)
class UslamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    pressure: PressureConfig = field(default_factory=PressureConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    timesync: TimeSyncConfig = field(default_factory=TimeSyncConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "UslamConfig":
        """Any subset of sections and keys; an unknown one raises KeyError."""
        sub_types = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        built = {}
        for k, v in d.items():
            if k not in sub_types:
                raise KeyError(f"Unknown config section {k!r}")
            klass = type(sub_types[k]())
            built[k] = _build_dataclass(klass, v) if isinstance(v, dict) else v
        return cls(**built)

    @classmethod
    def from_json(cls, path: str) -> "UslamConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_yaml(cls, path: str) -> "UslamConfig":
        """The schema of :meth:`from_json` in YAML (needs PyYAML, imported
        here so the rest of the port does not)."""
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        return cls.from_dict(d or {})

    def save_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _build_dataclass(klass, d: dict):
    """``klass`` from a dict of its fields; lists become tuples."""
    fields = {f.name for f in dataclasses.fields(klass)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"Unknown config key {klass.__name__}.{k}")
        kwargs[k] = tuple(v) if isinstance(v, list) else v
    return klass(**kwargs)


DEFAULT_CONFIG = UslamConfig()
