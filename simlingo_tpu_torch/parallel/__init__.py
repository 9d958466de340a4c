"""Multi-GPU training: process start-up (`multihost`), the dp x fsdp x tp x
sp x pp mesh with its layout rules and collectives (`mesh`), ring
attention over sp (`sequence`) and GPipe stages over pp (`pipeline`)."""
