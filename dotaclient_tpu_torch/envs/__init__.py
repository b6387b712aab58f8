"""The lane game: rule constants and the batched device simulator."""
