"""The causal LM and its slot-level decode primitives."""
