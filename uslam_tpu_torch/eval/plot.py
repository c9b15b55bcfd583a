"""3-D trajectory plots, host matplotlib (port of :mod:`uslam_tpu.eval.plot`).
matplotlib is optional: without it the plot returns None."""

from __future__ import annotations

import numpy as np


def plot_trajectory_3d(
    slam_xyz: np.ndarray,
    odom_xyz: np.ndarray | None = None,
    title: str = "Underwater Visual SLAM Trajectory",
    save_path: str | None = None,
    show: bool = False,
):
    """The reference's end-of-run figure (batch.py:347-360): odometry and
    the SLAM trajectory in one 3-D axes. Returns the figure, or None if
    matplotlib is missing."""
    try:
        import matplotlib

        if save_path and not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    if odom_xyz is not None:
        o = np.asarray(odom_xyz)
        ax.plot3D(o[:, 0], o[:, 1], o[:, 2], color="orange", linewidth=2, label="Odometry")
    s = np.asarray(slam_xyz)
    ax.plot3D(s[:, 0], s[:, 1], s[:, 2], color="blue", label="Ours (SLAM + Landmarks)")
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_zlabel("Z (m)")
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig


def plot_incremental_trajectory(ax, xyz: np.ndarray):
    """Live-updating plot hook for a streaming caller."""
    ax.plot3D(xyz[:, 0], xyz[:, 1], xyz[:, 2], color="blue")
    import matplotlib.pyplot as plt

    plt.pause(0.01)
