"""Multi-GPU execution with ``torch.distributed``: process groups, rank
meshes and the collectives (dist.py), the view mesh and camera batching
(mesh.py), view-sharded training and rendering (shard.py), tile-band and
gauss x tile sharding (tile_shard.py), Gaussian-block and depth-slab
sharding (gauss_shard.py), and the multi-rank dry run (dryrun.py).

JAX counterpart: ``dge_tpu/parallel/``."""
