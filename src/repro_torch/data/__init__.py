"""Data substrates (port of ``src/repro/data``): point-cloud generators
(:mod:`.pointclouds`) and the synthetic LM token pipeline
(:mod:`.tokens`)."""
from .tokens import ShardedTokenStream, reassign_shards, synthetic_tokens

__all__ = ["ShardedTokenStream", "reassign_shards", "synthetic_tokens"]
