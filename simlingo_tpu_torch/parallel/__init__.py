"""Multi-GPU training: process start-up (`multihost`) and the dp x fsdp x tp
mesh with its layout rules and collectives (`mesh`)."""
