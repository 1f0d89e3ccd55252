"""The causal LM with its slot-level decode primitives, and SimpleCNN."""
