"""Observations, shaped rewards and action translation over the device sim."""
