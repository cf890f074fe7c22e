"""Per-host shard-local egress over a device mesh (``egress``)."""
