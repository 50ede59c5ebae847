"""Multi-device scaling: device meshes, sharded matching, distributed BA.

The reference's only parallelism is intra-process OpenMP (SURVEY.md §2.7);
this package adds the distributed dimension: jax.sharding Mesh + shard_map
with XLA collectives between devices. The two natural data axes:

  * PAIRS  — descriptor matching shards the pair list (the moral equivalent
             of the OMP pair loop, UnorderedFeatureMatchingStrategy.cpp:40)
  * POINTS/OBS — bundle adjustment shards points + observations; the small
             reduced camera system is psum-reduced across chips (the
             distributed DENSE_SCHUR replacement)
"""
