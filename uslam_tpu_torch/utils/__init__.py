"""Runtime utilities: logging, stage timing and device traces, checkpoints
(the JAX package's ``uslam_tpu.utils``, with the same three exports)."""

from uslam_tpu_torch.utils.logging import get_logger  # noqa: F401
from uslam_tpu_torch.utils.profiling import stage_timer, Profiler  # noqa: F401
from uslam_tpu_torch.utils.checkpoint import save_state, load_state  # noqa: F401
