"""Actors: the on-device rollout."""
