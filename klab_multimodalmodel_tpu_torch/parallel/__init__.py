"""Parameter layouts over the mesh and the sharding of the model by them
(FSDP2 over ``fsdp``, tensor parallelism over ``tensor``)."""
