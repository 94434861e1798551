"""Multi-process execution on ``torch.distributed``: process groups, the
(data, model) mesh, tensor-parallel sharding of the selection model and
context-parallel attention."""
