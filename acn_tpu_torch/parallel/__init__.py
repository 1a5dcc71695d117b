"""The (expert × data) mesh on ``torch.distributed``: ``mesh`` (process
groups, sharding, collectives), ``launch`` (n ranks as fresh processes) and
``dryrun`` (the sharded step and frames against one rank's)."""
