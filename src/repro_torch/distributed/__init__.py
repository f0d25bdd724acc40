"""Replay executors of the chip, channel and rank tiers; sharding rules,
layout hints, collectives and the pipeline schedule."""
