"""Multi-device serving and training of the port (``repro.distributed``):
the serving mesh, the sharded decode and its table placement, the
per-dispatch lane accounting (serving), and the logical axes, partition
specs and DTensor placements of the training meshes (`sharding`,
`specs`)."""
