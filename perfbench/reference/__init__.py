"""Plain references of the benchmark: plain PyTorch, no kernel, cache or
batching of the port, and nothing imported from it."""
