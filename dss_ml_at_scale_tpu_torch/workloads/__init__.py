"""Workloads of the port: the LM token-serving front end."""
