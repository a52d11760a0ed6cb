"""The data-parallel plane (:mod:`.sharded`) and the corpus driver
(:mod:`.multihost`) over ``torch.distributed``, one process per card."""
