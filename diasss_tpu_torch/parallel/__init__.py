"""Parallelism of the port: the host-side overlap of parsing with device
work (:mod:`.prefetch`) and the multi-device layer on ``torch.distributed``
(:mod:`.collectives`, :mod:`.distributed`, :mod:`.shard`, :mod:`.alltoall`,
:mod:`.seq`, :mod:`.ring`, :mod:`.recovery`, :mod:`.multihost_check`), one
process per rank."""
