"""The distributed runtime: process-group bring-up over torch.distributed."""
