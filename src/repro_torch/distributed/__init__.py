"""Distribution (port of `repro.distributed`): the logical-axis sharding
rules and the block-int8 compressed all-reduce."""
