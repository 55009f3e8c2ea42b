"""Expert parallelism over ``torch.distributed``: the mesh of ranks, the
sharding rules (:mod:`.sharding`) and the expert-parallel MoE regions
(:mod:`.ep_shardmap`)."""
