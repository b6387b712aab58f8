"""Normalisation scales of the observation features: constants only.

A copy of the scales of ``dotaclient_tpu/features/featurizer.py`` that the
device featurizer (``features/torch_featurizer.py``) reads. The lane is
+-2000 units long and times are in seconds. The proto featurizer of that
module is not ported.
"""

from __future__ import annotations

_POS_SCALE = 2000.0
_TIME_SCALE = 600.0
_HP_SCALE = 2000.0
_GOLD_SCALE = 3000.0
_XP_SCALE = 2500.0
_DMG_SCALE = 150.0
_RANGE_SCALE = 700.0
_SPEED_SCALE = 400.0
_ARMOR_SCALE = 20.0
_LEVEL_SCALE = 10.0
