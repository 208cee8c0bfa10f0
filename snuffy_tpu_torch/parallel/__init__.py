"""Data parallelism over torch.distributed: one process per GPU (Slice 7a).

`distributed` is the bootstrap from torchrun's environment, `mesh` the
(dcn, dp) batch axes as process groups, `ssl_sharding` the SSL trainers'
row shards, start broadcast and gradient all-reduce, and `sharded_train`
the MIL packed step over ranks.
"""
