"""Several ranks over ``torch.distributed``: the process group and its
collectives (:mod:`.multihost`, :mod:`.comm`), chain sharding
(:mod:`.chains`) and site sharding of the Holstein model
(:mod:`.lattice_shard`)."""
