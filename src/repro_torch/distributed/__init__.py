"""The distributed MoE layer on ``torch.distributed``: ``sharding`` (each
leaf's placement on a mesh) and ``collectives`` (``MoEDist``,
``MoEDistA2A``: the expert bank sharded over a mesh of processes, NCCL
on the card, gloo on the CPU)."""
