"""Parallel strategies of the port: data parallelism over
torch.distributed, the ring and Ulysses, tensor parallelism, FSDP and
ZeRO, the image family's GSPMD step, and the in-graph pipeline."""
