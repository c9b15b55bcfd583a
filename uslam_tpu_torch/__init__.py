"""uslam_tpu_torch: the PyTorch and CUDA port of ``uslam_tpu``.

The offline stereo-image path (:func:`uslam_tpu_torch.pipeline.run_sequence`)
and the online fixed-lag path (:class:`OnlineSlam`, :class:`FixedLagSmoother`)
run on one NVIDIA GPU: the ORB front end on two hand-written CUDA kernels
(``frontend/kernels.py``, sources in ``csrc/``), the Levenberg-Marquardt
solves on torch. The JAX package ``uslam_tpu`` is the reference it is
tested against; this package imports neither JAX nor ``uslam_tpu``.
"""


def __getattr__(name):
    # Lazy, so that a bare `import uslam_tpu_torch` imports no torch module.
    if name == "OnlineSlam":
        from uslam_tpu_torch.online import OnlineSlam

        return OnlineSlam
    if name == "FixedLagSmoother":
        from uslam_tpu_torch.solvers.fixed_lag import FixedLagSmoother

        return FixedLagSmoother
    raise AttributeError(name)
