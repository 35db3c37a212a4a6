"""Wire formats and serialization (traj_utils / quadrotor_msgs parity;
svsdf_tpu/io)."""

from svsdf_tpu_torch.io.polytraj import (  # noqa: F401
    MincoTraj,
    PolyTraj,
    PositionCommand,
    TrajectoryStatus,
    decode_minco_traj,
    decode_poly_traj,
    encode_minco_traj,
    encode_poly_traj,
)
