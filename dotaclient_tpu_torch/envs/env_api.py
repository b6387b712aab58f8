"""Environment core shared by the in-process env and the gRPC service.

Counterpart of ``dotaclient_tpu/envs/env_api.py``: the reset/observe/act
surface of dotaservice, which the reference's ``agent.py`` drives, with its
multi-team semantics. Each agent-controlled team submits ``Actions`` once an
observation interval; the game advances when every agent team has acted
(scripted teams act inside the game). A team's actions merge in the order
the teams acted, and a team may command only its own heroes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dotaclient_tpu_torch.envs import lane_sim
from dotaclient_tpu_torch.protos import dota_pb2 as pb


class DotaEnvCore:
    """One game. Not thread-safe: callers serialize access (the gRPC service
    under an asyncio lock)."""

    def __init__(self) -> None:
        self.sim: Optional[lane_sim.LaneSim] = None
        self._pending: Dict[int, pb.Actions] = {}
        self._agent_teams: List[int] = []

    @property
    def done(self) -> bool:
        return self.sim is None or self.sim.done

    def reset(self, config: pb.GameConfig) -> pb.InitialObservation:
        self.sim = lane_sim.LaneSim(config)
        self._pending.clear()
        self._agent_teams = sorted({
            pick.team_id
            for pick in (config.hero_picks or [])
            if pick.control_mode == pb.CONTROL_AGENT
        }) or [lane_sim.TEAM_RADIANT]
        return pb.InitialObservation(
            status=pb.STATUS_OK,
            world_states=[self.sim.world_state(t) for t in self._agent_teams],
        )

    def observe(self, request: pb.ObserveRequest) -> pb.ObserveResponse:
        if self.sim is None:
            return pb.ObserveResponse(status=pb.STATUS_FAILED)
        status = pb.STATUS_EPISODE_DONE if self.sim.done else pb.STATUS_OK
        return pb.ObserveResponse(
            status=status, world_state=self.sim.world_state(request.team_id)
        )

    def act(self, actions: pb.Actions) -> pb.Empty:
        """Record a team's actions; step once all agent teams have acted."""
        if self.sim is None or self.sim.done:
            return pb.Empty()
        self._pending[actions.team_id] = actions
        if all(t in self._pending for t in self._agent_teams):
            merged: Dict[int, pb.Action] = {}
            for team_actions in self._pending.values():
                for action in team_actions.actions:
                    # a team may only command its own heroes
                    if 0 <= action.player_id < len(self.sim.heroes) and (
                        self.sim.heroes[action.player_id].team_id
                        == team_actions.team_id
                    ):
                        merged[action.player_id] = action
            self._pending.clear()
            self.sim.step(merged)
        return pb.Empty()


class LocalDotaEnv:
    """In-process env with the gRPC client's call surface: the path of the
    scalar actor pool, ``evaluate_served`` and the tests."""

    def __init__(self) -> None:
        self._core = DotaEnvCore()

    def reset(self, config: pb.GameConfig) -> pb.InitialObservation:
        return self._core.reset(config)

    def observe(self, team_id: int) -> pb.ObserveResponse:
        return self._core.observe(pb.ObserveRequest(team_id=team_id))

    def act(self, actions: pb.Actions) -> pb.Empty:
        return self._core.act(actions)

    @property
    def done(self) -> bool:
        return self._core.done
