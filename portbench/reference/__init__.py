"""The plain float32 references, one per configuration: plain PyTorch that
imports nothing of the port."""
