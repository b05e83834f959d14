"""The plain reference the benchmark judges the port against: plain PyTorch
in fp32, importing neither the port nor JAX nor the JAX package."""
