"""The plain PyTorch reference and the operation counts read from it."""
