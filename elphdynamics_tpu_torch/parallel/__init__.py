"""Several ranks over ``torch.distributed``: the process group and its
collectives (:mod:`.multihost`, :mod:`.comm`), chain sharding
(:mod:`.chains`), site sharding of the Holstein and SSH models
(:mod:`.lattice_shard`), and both at once on site and chain groups
(:func:`.multihost.layout_groups`)."""
