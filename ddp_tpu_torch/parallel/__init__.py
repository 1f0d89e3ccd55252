"""Parallel strategies of the port: data parallelism over
torch.distributed, and the one-rank ring attention."""
