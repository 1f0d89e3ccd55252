"""Training data: synthetic token streams, byte-level text, and the MNIST
family with its sampler and loader."""
