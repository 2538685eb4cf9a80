"""Expert and gating CNNs as ``nn.Module``s, their presets, and the weight
bridge from the JAX package's parameters."""
