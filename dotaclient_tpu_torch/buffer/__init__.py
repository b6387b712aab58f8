"""The trajectory ring of the buffered learner."""

from dotaclient_tpu_torch.buffer.trajectory_buffer import TrajectoryBuffer

__all__ = ["TrajectoryBuffer"]
