"""Meshes, collectives and host-side policies of long runs (ports of
``src/repro/distributed``): the sharding rules, collectives over per-shard
tensors, elastic mesh planning and straggler detection."""
