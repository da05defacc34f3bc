"""PS-side checkpoints of the port (``checkpoint``: npz save/restore of
trees of tensors and the periodic :class:`CheckpointManager`)."""
