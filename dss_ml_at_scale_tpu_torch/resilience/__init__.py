"""Crash-only persistence of the port: durable publishes and checkpoint
integrity manifests (ports of the JAX package's ``resilience/`` helpers
that training needs)."""
