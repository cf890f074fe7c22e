"""The sharded fleet runtime: device meshes (``mesh``) and the dp fleet
loop (``sharded``)."""
