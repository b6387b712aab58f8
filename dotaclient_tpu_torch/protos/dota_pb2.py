# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dota.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\ndota.proto\x12\x07\x64otatpu\")\n\x06Vector\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"|\n\x07\x41\x62ility\x12\x0c\n\x04slot\x18\x01 \x01(\x05\x12\x12\n\nability_id\x18\x02 \x01(\x05\x12\x1a\n\x12\x63ooldown_remaining\x18\x03 \x01(\x02\x12\r\n\x05level\x18\x04 \x01(\x05\x12\x10\n\x08\x63\x61stable\x18\x05 \x01(\x08\x12\x12\n\ncast_range\x18\x06 \x01(\x02\"\xa5\x03\n\x04Unit\x12\x0e\n\x06handle\x18\x01 \x01(\x05\x12$\n\tunit_type\x18\x02 \x01(\x0e\x32\x11.dotatpu.UnitType\x12\x0f\n\x07team_id\x18\x03 \x01(\x05\x12\x11\n\tplayer_id\x18\x04 \x01(\x05\x12\x0f\n\x07hero_id\x18\x05 \x01(\x05\x12!\n\x08location\x18\x06 \x01(\x0b\x32\x0f.dotatpu.Vector\x12\x0e\n\x06\x66\x61\x63ing\x18\x07 \x01(\x02\x12\x0e\n\x06health\x18\x08 \x01(\x02\x12\x12\n\nhealth_max\x18\t \x01(\x02\x12\x0c\n\x04mana\x18\n \x01(\x02\x12\x10\n\x08mana_max\x18\x0b \x01(\x02\x12\x10\n\x08is_alive\x18\x0c \x01(\x08\x12\r\n\x05level\x18\r \x01(\x05\x12\x15\n\rattack_damage\x18\x0e \x01(\x02\x12\x14\n\x0c\x61ttack_range\x18\x0f \x01(\x02\x12\r\n\x05\x61rmor\x18\x10 \x01(\x02\x12\x16\n\x0emovement_speed\x18\x11 \x01(\x02\x12#\n\tabilities\x18\x12 \x03(\x0b\x32\x10.dotatpu.Ability\x12\x11\n\tlast_hits\x18\x13 \x01(\x05\x12\x0e\n\x06\x64\x65nies\x18\x14 \x01(\x05\"\x87\x01\n\x06Player\x12\x11\n\tplayer_id\x18\x01 \x01(\x05\x12\x0f\n\x07team_id\x18\x02 \x01(\x05\x12\x0f\n\x07hero_id\x18\x03 \x01(\x05\x12\r\n\x05kills\x18\x04 \x01(\x05\x12\x0e\n\x06\x64\x65\x61ths\x18\x05 \x01(\x05\x12\x0f\n\x07\x61ssists\x18\x06 \x01(\x05\x12\x0c\n\x04gold\x18\x07 \x01(\x02\x12\n\n\x02xp\x18\x08 \x01(\x02\"\xcf\x01\n\nWorldState\x12\x0f\n\x07team_id\x18\x01 \x01(\x05\x12\x11\n\tgame_time\x18\x02 \x01(\x02\x12\x11\n\tdota_time\x18\x03 \x01(\x02\x12\x0c\n\x04tick\x18\x04 \x01(\x05\x12&\n\ngame_state\x18\x05 \x01(\x0e\x32\x12.dotatpu.GameState\x12\x1c\n\x05units\x18\x06 \x03(\x0b\x32\r.dotatpu.Unit\x12 \n\x07players\x18\x07 \x03(\x0b\x32\x0f.dotatpu.Player\x12\x14\n\x0cwinning_team\x18\x08 \x01(\x05\"\x8b\x01\n\x06\x41\x63tion\x12\x11\n\tplayer_id\x18\x01 \x01(\x05\x12!\n\x04type\x18\x02 \x01(\x0e\x32\x13.dotatpu.ActionType\x12\x0e\n\x06move_x\x18\x03 \x01(\x05\x12\x0e\n\x06move_y\x18\x04 \x01(\x05\x12\x15\n\rtarget_handle\x18\x05 \x01(\x05\x12\x14\n\x0c\x61\x62ility_slot\x18\x06 \x01(\x05\"O\n\x07\x41\x63tions\x12\x0f\n\x07team_id\x18\x01 \x01(\x05\x12\x11\n\tdota_time\x18\x02 \x01(\x02\x12 \n\x07\x61\x63tions\x18\x03 \x03(\x0b\x32\x0f.dotatpu.Action\"X\n\x08HeroPick\x12\x0f\n\x07team_id\x18\x01 \x01(\x05\x12\x0f\n\x07hero_id\x18\x02 \x01(\x05\x12*\n\x0c\x63ontrol_mode\x18\x03 \x01(\x0e\x32\x14.dotatpu.ControlMode\"\xb0\x01\n\nGameConfig\x12\x11\n\thost_mode\x18\x01 \x01(\x05\x12\x11\n\tgame_mode\x18\x02 \x01(\x05\x12\x1d\n\x15ticks_per_observation\x18\x03 \x01(\x05\x12%\n\nhero_picks\x18\x04 \x03(\x0b\x32\x11.dotatpu.HeroPick\x12\x0c\n\x04seed\x18\x05 \x01(\r\x12\x15\n\rmax_dota_time\x18\x06 \x01(\x02\x12\x11\n\tmove_bins\x18\x07 \x01(\x05\"!\n\x0eObserveRequest\x12\x0f\n\x07team_id\x18\x01 \x01(\x05\"\\\n\x0fObserveResponse\x12\x1f\n\x06status\x18\x01 \x01(\x0e\x32\x0f.dotatpu.Status\x12(\n\x0bworld_state\x18\x02 \x01(\x0b\x32\x13.dotatpu.WorldState\"`\n\x12InitialObservation\x12\x1f\n\x06status\x18\x01 \x01(\x0e\x32\x0f.dotatpu.Status\x12)\n\x0cworld_states\x18\x02 \x03(\x0b\x32\x13.dotatpu.WorldState\"\x07\n\x05\x45mpty\"9\n\x0bTensorProto\x12\r\n\x05shape\x18\x01 \x03(\x05\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"\xdd\x01\n\x07Rollout\x12\x15\n\rmodel_version\x18\x01 \x01(\x05\x12\x0e\n\x06\x65nv_id\x18\x02 \x01(\x05\x12\x12\n\nrollout_id\x18\x03 \x01(\x04\x12\x0e\n\x06length\x18\x04 \x01(\x05\x12\x14\n\x0ctotal_reward\x18\x05 \x01(\x02\x12,\n\x06\x61rrays\x18\x06 \x03(\x0b\x32\x1c.dotatpu.Rollout.ArraysEntry\x1a\x43\n\x0b\x41rraysEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.dotatpu.TensorProto:\x02\x38\x01\"2\n\x0cRolloutBatch\x12\"\n\x08rollouts\x18\x01 \x03(\x0b\x32\x10.dotatpu.Rollout\"\x97\x01\n\x0cModelWeights\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12\x31\n\x06params\x18\x02 \x03(\x0b\x32!.dotatpu.ModelWeights.ParamsEntry\x1a\x43\n\x0bParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.dotatpu.TensorProto:\x02\x38\x01*c\n\x08UnitType\x12\x10\n\x0cUNIT_INVALID\x10\x00\x12\r\n\tUNIT_HERO\x10\x01\x12\x13\n\x0fUNIT_LANE_CREEP\x10\x02\x12\x0e\n\nUNIT_TOWER\x10\x03\x12\x11\n\rUNIT_BUILDING\x10\x04*o\n\tGameState\x12\x13\n\x0fGAME_STATE_INIT\x10\x00\x12\x17\n\x13GAME_STATE_PRE_GAME\x10\x01\x12\x1a\n\x16GAME_STATE_IN_PROGRESS\x10\x02\x12\x18\n\x14GAME_STATE_POST_GAME\x10\x03*W\n\nActionType\x12\x0f\n\x0b\x41\x43TION_NOOP\x10\x00\x12\x0f\n\x0b\x41\x43TION_MOVE\x10\x01\x12\x16\n\x12\x41\x43TION_ATTACK_UNIT\x10\x02\x12\x0f\n\x0b\x41\x43TION_CAST\x10\x03*V\n\x0b\x43ontrolMode\x12\x11\n\rCONTROL_AGENT\x10\x00\x12\x19\n\x15\x43ONTROL_SCRIPTED_EASY\x10\x01\x12\x19\n\x15\x43ONTROL_SCRIPTED_HARD\x10\x02*C\n\x06Status\x12\r\n\tSTATUS_OK\x10\x00\x12\x17\n\x13STATUS_EPISODE_DONE\x10\x01\x12\x11\n\rSTATUS_FAILED\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dota_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ROLLOUT_ARRAYSENTRY._options = None
  _ROLLOUT_ARRAYSENTRY._serialized_options = b'8\001'
  _MODELWEIGHTS_PARAMSENTRY._options = None
  _MODELWEIGHTS_PARAMSENTRY._serialized_options = b'8\001'
  _UNITTYPE._serialized_start=2181
  _UNITTYPE._serialized_end=2280
  _GAMESTATE._serialized_start=2282
  _GAMESTATE._serialized_end=2393
  _ACTIONTYPE._serialized_start=2395
  _ACTIONTYPE._serialized_end=2482
  _CONTROLMODE._serialized_start=2484
  _CONTROLMODE._serialized_end=2570
  _STATUS._serialized_start=2572
  _STATUS._serialized_end=2639
  _VECTOR._serialized_start=23
  _VECTOR._serialized_end=64
  _ABILITY._serialized_start=66
  _ABILITY._serialized_end=190
  _UNIT._serialized_start=193
  _UNIT._serialized_end=614
  _PLAYER._serialized_start=617
  _PLAYER._serialized_end=752
  _WORLDSTATE._serialized_start=755
  _WORLDSTATE._serialized_end=962
  _ACTION._serialized_start=965
  _ACTION._serialized_end=1104
  _ACTIONS._serialized_start=1106
  _ACTIONS._serialized_end=1185
  _HEROPICK._serialized_start=1187
  _HEROPICK._serialized_end=1275
  _GAMECONFIG._serialized_start=1278
  _GAMECONFIG._serialized_end=1454
  _OBSERVEREQUEST._serialized_start=1456
  _OBSERVEREQUEST._serialized_end=1489
  _OBSERVERESPONSE._serialized_start=1491
  _OBSERVERESPONSE._serialized_end=1583
  _INITIALOBSERVATION._serialized_start=1585
  _INITIALOBSERVATION._serialized_end=1681
  _EMPTY._serialized_start=1683
  _EMPTY._serialized_end=1690
  _TENSORPROTO._serialized_start=1692
  _TENSORPROTO._serialized_end=1749
  _ROLLOUT._serialized_start=1752
  _ROLLOUT._serialized_end=1973
  _ROLLOUT_ARRAYSENTRY._serialized_start=1906
  _ROLLOUT_ARRAYSENTRY._serialized_end=1973
  _ROLLOUTBATCH._serialized_start=1975
  _ROLLOUTBATCH._serialized_end=2025
  _MODELWEIGHTS._serialized_start=2028
  _MODELWEIGHTS._serialized_end=2179
  _MODELWEIGHTS_PARAMSENTRY._serialized_start=2112
  _MODELWEIGHTS_PARAMSENTRY._serialized_end=2179
# @@protoc_insertion_point(module_scope)
