"""repro_torch.launch — command-line drivers."""
