"""Replay executors of the chip, channel and rank tiers."""
