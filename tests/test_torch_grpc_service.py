"""The port's gRPC fake dotaservice against the JAX package's, over a real
localhost socket (mirrors ``tests/test_grpc_service.py``).

Each package's client drives each package's server through the same
reset/observe/act script: a 1v1 with both teams agent-controlled (the game
steps once both have acted), a game that ends and a second reset on the same
server. Every reply's bytes are the same in all four pairings, and an
observe before a reset fails cleanly.
"""

import asyncio

import pytest

from dotaclient_tpu.envs import service as jax_service
from dotaclient_tpu.protos import dota_pb2 as jpb
from dotaclient_tpu_torch.envs import lane_sim
from dotaclient_tpu_torch.envs import service as port_service
from dotaclient_tpu_torch.protos import dota_pb2 as ppb

PACKAGES = {"jax": (jax_service, jpb), "port": (port_service, ppb)}


def config(pb):
    return pb.GameConfig(ticks_per_observation=6, max_dota_time=2.0, seed=3, hero_picks=[
        pb.HeroPick(team_id=lane_sim.TEAM_RADIANT, hero_id=1, control_mode=pb.CONTROL_AGENT),
        pb.HeroPick(team_id=lane_sim.TEAM_DIRE, hero_id=2, control_mode=pb.CONTROL_AGENT),
    ])


async def script(client, pb):
    """The (call, reply bytes) of one scripted session."""
    out = [("observe", (await client.observe(lane_sim.TEAM_RADIANT)).SerializeToString())]   # before a reset
    for _ in range(2):
        out.append(("reset", (await client.reset(config(pb))).SerializeToString()))
        for t in range(14):   # the game ends at step 10; acts after it are ignored
            for team, player, move_x in ((lane_sim.TEAM_DIRE, 1, t % 9), (lane_sim.TEAM_RADIANT, 0, 8)):
                actions = pb.Actions(team_id=team, actions=[
                    pb.Action(player_id=player, type=pb.ACTION_MOVE, move_x=move_x, move_y=4),
                    pb.Action(player_id=1 - player, type=pb.ACTION_MOVE, move_x=0, move_y=0)])   # not its hero
                out.append(("act", (await client.act(actions)).SerializeToString()))
            for team in lane_sim.TEAMS:
                out.append(("observe", (await client.observe(team)).SerializeToString()))
    return out


def run_pair(server_pkg, client_pkg):
    server_mod, _ = PACKAGES[server_pkg]
    client_mod, pb = PACKAGES[client_pkg]

    async def main():
        server, port = await server_mod.serve_env()
        client = client_mod.DotaServiceClient.connect(f"127.0.0.1:{port}")
        try:
            return await script(client, pb)
        finally:
            await client.close()
            await server.stop(None)

    return asyncio.run(main())


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_replies_match_the_jax_service_bytewise(server_pkg, client_pkg):
    want = run_pair("jax", "jax")
    got = run_pair(server_pkg, client_pkg)
    assert got == want
    statuses = [ppb.ObserveResponse.FromString(b).status for call, b in got if call == "observe"]
    assert statuses[0] == ppb.STATUS_FAILED   # observe before reset
    assert statuses.count(ppb.STATUS_EPISODE_DONE) >= 2 and ppb.STATUS_OK in statuses


def test_grpc_reset_observe_act_cycle():
    async def main():
        server, port = await port_service.serve_env()
        client = port_service.DotaServiceClient.connect(f"127.0.0.1:{port}")
        try:
            init = await client.reset(ppb.GameConfig(ticks_per_observation=6, max_dota_time=120.0, seed=3,
                                                     hero_picks=[
                ppb.HeroPick(team_id=lane_sim.TEAM_RADIANT, hero_id=1, control_mode=ppb.CONTROL_AGENT),
                ppb.HeroPick(team_id=lane_sim.TEAM_DIRE, hero_id=1, control_mode=ppb.CONTROL_SCRIPTED_EASY)]))
            assert init.status == ppb.STATUS_OK and len(init.world_states) == 1
            hero = next(u for u in init.world_states[0].units
                        if u.unit_type == ppb.UNIT_HERO and u.team_id == lane_sim.TEAM_RADIANT)
            for _ in range(5):
                await client.act(ppb.Actions(team_id=lane_sim.TEAM_RADIANT, actions=[
                    ppb.Action(player_id=hero.player_id, type=ppb.ACTION_MOVE, move_x=8, move_y=4)]))
            obs = await client.observe(lane_sim.TEAM_RADIANT)
            assert obs.status == ppb.STATUS_OK
            now = next(u for u in obs.world_state.units if u.player_id == hero.player_id)
            assert now.location.x > hero.location.x, "the hero should have moved +x"
            assert (await client.reset(ppb.GameConfig(seed=1))).world_states[0].tick == 0
        finally:
            await client.close()
            await server.stop(None)

    asyncio.run(main())
