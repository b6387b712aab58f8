"""gRPC environment service and client: the fake dotaservice.

Counterpart of ``dotaclient_tpu/envs/service.py``. The reference talks to
dotaservice over gRPC with generated stubs; here the service is registered
through grpc's generic-handler API with explicit (de)serializers, the same
wire behaviour with no generated ``*_pb2_grpc.py``. The service is
``dotatpu.DotaService`` with the unary RPCs ``reset``, ``observe`` and
``act``, one game a server as with dotaservice. A port client talks to a
JAX server and back, byte for byte.

This module imports ``grpc``; nothing on the card's paths imports it
(``envs/__init__.py``, the actors and the learner do not).
"""

from __future__ import annotations

import asyncio

import grpc
import grpc.aio

from dotaclient_tpu_torch.envs.env_api import DotaEnvCore
from dotaclient_tpu_torch.protos import dota_pb2 as pb

SERVICE_NAME = "dotatpu.DotaService"


class FakeDotaService:
    """asyncio gRPC servicer wrapping one :class:`DotaEnvCore`."""

    def __init__(self) -> None:
        self._core = DotaEnvCore()
        self._lock = asyncio.Lock()

    async def reset(self, request: pb.GameConfig, context) -> pb.InitialObservation:
        async with self._lock:
            return self._core.reset(request)

    async def observe(self, request: pb.ObserveRequest, context) -> pb.ObserveResponse:
        async with self._lock:
            return self._core.observe(request)

    async def act(self, request: pb.Actions, context) -> pb.Empty:
        async with self._lock:
            return self._core.act(request)


def _service_handlers(servicer: FakeDotaService) -> grpc.GenericRpcHandler:
    rpcs = {
        "reset": grpc.unary_unary_rpc_method_handler(
            servicer.reset,
            request_deserializer=pb.GameConfig.FromString,
            response_serializer=pb.InitialObservation.SerializeToString,
        ),
        "observe": grpc.unary_unary_rpc_method_handler(
            servicer.observe,
            request_deserializer=pb.ObserveRequest.FromString,
            response_serializer=pb.ObserveResponse.SerializeToString,
        ),
        "act": grpc.unary_unary_rpc_method_handler(
            servicer.act,
            request_deserializer=pb.Actions.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)


async def serve_env(host: str = "127.0.0.1", port: int = 0) -> tuple:
    """Start a single-env server. Returns ``(server, bound_port)``."""
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((_service_handlers(FakeDotaService()),))
    bound = server.add_insecure_port(f"{host}:{port}")
    await server.start()
    return server, bound


class DotaServiceClient:
    """Async client with the same reset/observe/act surface as
    :class:`dotaclient_tpu_torch.envs.env_api.LocalDotaEnv`."""

    def __init__(self, channel: grpc.aio.Channel):
        self._channel = channel
        prefix = f"/{SERVICE_NAME}/"
        self._reset = channel.unary_unary(
            prefix + "reset",
            request_serializer=pb.GameConfig.SerializeToString,
            response_deserializer=pb.InitialObservation.FromString,
        )
        self._observe = channel.unary_unary(
            prefix + "observe",
            request_serializer=pb.ObserveRequest.SerializeToString,
            response_deserializer=pb.ObserveResponse.FromString,
        )
        self._act = channel.unary_unary(
            prefix + "act",
            request_serializer=pb.Actions.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )

    @classmethod
    def connect(cls, address: str) -> "DotaServiceClient":
        return cls(grpc.aio.insecure_channel(address))

    async def reset(self, config: pb.GameConfig) -> pb.InitialObservation:
        return await self._reset(config)

    async def observe(self, team_id: int) -> pb.ObserveResponse:
        return await self._observe(pb.ObserveRequest(team_id=team_id))

    async def act(self, actions: pb.Actions) -> pb.Empty:
        return await self._act(actions)

    async def close(self) -> None:
        await self._channel.close()
