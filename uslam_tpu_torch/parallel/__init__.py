"""Multi-device execution (port of :mod:`uslam_tpu.parallel`; SURVEY.md §2.2).

The problem's two parallel axes: the front end over frames, with no
communication (``frames``), and the Schur elimination over landmarks, with
one all-reduce of the reduced camera corrections and one all-gather of the
landmark delta per solve (``mesh``), over ``torch.distributed``: NCCL with
one rank per GPU, gloo on CPU ranks. ``launch.run_ranks`` starts the ranks.
"""

from uslam_tpu_torch.parallel.frames import (  # noqa: F401
    extract_orb_frames_sharded,
    process_stereo_pairs_sharded,
)
from uslam_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_landmarks,
    sharded_lm_step,
    sharded_optimize_lm,
)
