"""The lane game: rule constants and the scalar game (``lane_sim``), the
dotaservice surface over it (``env_api``), the numpy and device simulators,
and the gRPC fake dotaservice (``service``, which alone imports ``grpc``)."""
